"""Recommendation engine template (ALS) — training and serving on the card.

Counterpart of ``predictionio_tpu/models/recommendation.py``: the same
query/result types, the same ``ALSAlgorithmParams`` fields (so an engine
instance written by either package parses in both), ``TrainingData``,
``PreparedData``, ``ALSModel``, ``ALSAlgorithm.train`` — single-device
ALS through :func:`..ops.als.als_train_coo`, whose normal equations are
built and solved on the card by the hand-written CUDA kernels — and
``ALSAlgorithm.predict``/``batch_predict``: one device call per batch
through :func:`..ops.scoring.top_k_for_users_fused`, which on the card
streams the catalog through the hand-written CUDA top-k kernel.

A live model's factor tables move to the algorithm's device once, when
the model is attached (``prepare_serving`` at deploy, or the first
query), and stay there; each batch copies only its user indices in and
its ``[B, k]`` results out, in one copy each way. ``shard_model`` cuts
a model to one partition of its item table for sharded serving
(``ServerConfig(shard_index=..., shard_count=...)``).

``RecDataSource.read_training`` reads the rate/buy events of its app
from the registry's event store (``get_registry().get_events()``)
through :func:`..workflow.infeed.stream_ratings` — on the native event
log, one C++ pass — into :class:`TrainingData`; a caller may also hand
``run_train`` a DataSource of its own. ``RecDataSource.read_eval`` holds
every fourth rating out, and ``RecEvaluation`` × ``RecParamsGenerator``
sweep rank × λ by Precision@K over the held-out queries (``pio eval``,
:func:`..workflow.core_workflow.run_evaluation`): each candidate trains
through the build and solve kernels and answers all its queries in one
``batch_predict``, one streaming top-k. A model trained
by the JAX package crosses over as arrays: :func:`als_model_from_numpy`
builds the port's ``ALSModel`` from ``user_factors``, ``item_factors``
and the two id maps' ``to_dict()``.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..controller import (
    Algorithm,
    DataSource,
    Engine,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    FirstServing,
    OptionAverageMetric,
    Params,
    Preparator,
)
from ..ckpt import resolve_every, resolve_resume
from ..device import DeviceLike, resolve_device
from ..ops.als import ALSConfig, als_train_coo
from ..ops.als_sharded import resolve_shards
from ..ops.scoring import (
    pad_pow2,
    resolve_topk_path,
    results_to_host,
    top_k_for_users_fused,
    use_streaming_topk,
)
from ..storage import BiMap, IdsLike, get_registry
from ..workflow.infeed import stream_ratings

QUANT_NOT_PORTED = (
    "quantized_serving is not ported yet (ROADMAP.md, queue 1); deploy "
    "with quantized_serving false"
)


# -- queries / results (template's Query.scala / PredictedResult) -----------
@dataclasses.dataclass(frozen=True)
class Query:
    user: str
    num: int = 10


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: Tuple[ItemScore, ...]

    def to_json_dict(self) -> dict:
        from .wire import item_scores_json

        return item_scores_json(self.item_scores)


# -- training data ----------------------------------------------------------
@dataclasses.dataclass
class TrainingData:
    """Pre-indexed ratings: dense user/item indices plus the BiMaps that
    decode them (the JAX package's streamed form, SURVEY §7)."""

    users: np.ndarray  # int32 [nnz]
    items: np.ndarray  # int32 [nnz]
    ratings: np.ndarray  # float32 [nnz]
    user_map: BiMap
    item_map: BiMap

    def sanity_check(self):
        if len(self.users) == 0:
            raise ValueError(
                "No rating events found; check app id and event names."
            )


@dataclasses.dataclass
class PreparedData:
    user_map: BiMap
    item_map: BiMap
    users: np.ndarray  # int32 [nnz]
    items: np.ndarray  # int32 [nnz]
    ratings: np.ndarray  # float32 [nnz]


# -- DASE components --------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RecDataSourceParams(Params):
    app_id: int = 1
    event_names: Tuple[str, ...] = ("rate", "buy")
    buy_rating: float = 4.0


class RecDataSource(DataSource):
    """Reads rate/buy events through the streaming infeed (reference
    ``DataSource.scala:25-55`` via ``Storage.getPEvents().find``)."""

    params_class = RecDataSourceParams

    def __init__(self, params: RecDataSourceParams = RecDataSourceParams()):
        self.params = params

    def _value_rules(self) -> dict:
        """Per-event value rule (the template's rate/buy pattern-match):
        'rate' reads the required 'rating' property, 'buy' maps to a fixed
        implicit rating."""
        rules: dict = {}
        for name in self.params.event_names:
            if name == "rate":
                rules[name] = "rating"
            elif name == "buy":
                rules[name] = self.params.buy_rating
            else:
                raise ValueError(
                    f"Unsupported event {name!r} in recommendation "
                    "DataSource (supported: 'rate', 'buy')"
                )
        return rules

    def read_training(self, ctx) -> TrainingData:
        rules = self._value_rules()  # a bad event name fails before any I/O
        batch = stream_ratings(get_registry().get_events(), self.params.app_id, rules)
        return TrainingData(
            users=batch.users,
            items=batch.items,
            ratings=batch.ratings,
            user_map=batch.user_map,
            item_map=batch.item_map,
        )

    def read_eval(self, ctx):
        """One fold: every fourth rating (by position in the scan) is held
        out as a ``(Query(user, 10), ItemScore(item, rating))`` pair; the
        rest is the training split, re-indexed over the entities it holds
        (a user or item seen only in held-out ratings is absent from the
        model's maps, so it takes the unknown-user path instead of a
        never-solved zero row)."""
        td = self.read_training(ctx)
        n = len(td.users)
        idx = np.arange(n)
        test = idx % 4 == 0
        u_inv, i_inv = td.user_map.inverse, td.item_map.inverse
        tr_users, tr_items = td.users[~test], td.items[~test]
        uniq_u = np.unique(tr_users)
        uniq_i = np.unique(tr_items)
        u_remap = np.full(len(td.user_map), -1, dtype=np.int32)
        u_remap[uniq_u] = np.arange(len(uniq_u), dtype=np.int32)
        i_remap = np.full(len(td.item_map), -1, dtype=np.int32)
        i_remap[uniq_i] = np.arange(len(uniq_i), dtype=np.int32)
        train_td = TrainingData(
            users=u_remap[tr_users],
            items=i_remap[tr_items],
            ratings=td.ratings[~test],
            user_map=BiMap({u_inv[int(old)]: new for new, old in enumerate(uniq_u)}),
            item_map=BiMap({i_inv[int(old)]: new for new, old in enumerate(uniq_i)}),
        )
        qa = [
            (Query(user=u_inv[int(td.users[i])], num=10),
             ItemScore(item=i_inv[int(td.items[i])], score=float(td.ratings[i])))
            for i in idx[test]
        ]
        return [(train_td, None, qa)]


class RecPreparator(Preparator):
    """Hands the pre-indexed ratings to the algorithm: a re-shape, not a
    copy."""

    def prepare(self, ctx, td: TrainingData) -> PreparedData:
        return PreparedData(
            user_map=td.user_map,
            item_map=td.item_map,
            users=td.users,
            items=td.items,
            ratings=td.ratings,
        )


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    """The JAX package's fields, unchanged. Training reads the ALS fields
    (``ALSConfig.resolve_levers`` says what runs on the device) and the
    checkpoint cadence (here, else the workflow run's, else
    ``PIO_CKPT_EVERY``), and refuses ``shards > 1`` and ``distributed``
    (not ported yet), whether set here or through ``PIO_TRAIN_SHARDS``;
    serving reads ``streaming_top_k`` (on the card
    "auto"/"always" stream through the kernel and "never" is refused; see
    ``use_streaming_topk``) and refuses ``quantized_serving``."""

    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    seed: int = 3
    implicit_prefs: bool = False
    alpha: float = 1.0
    distributed: bool = False
    factor_sharding: str = "replicated"
    shards: Optional[int] = None
    checkpoint_every: Optional[int] = None
    solve_mode: str = "auto"
    gather_dtype: str = "f32"
    sort_gather_indices: Optional[bool] = None
    fused_gather: Optional[bool] = None
    streaming_top_k: str = "auto"
    quantized_serving: Optional[bool] = None
    quant_gate_min_match: float = 1.0


@dataclasses.dataclass
class ALSModel:
    """Factor tables + id maps (``ALSModel.scala:1-63``). Plain numpy
    arrays, so the blob never holds device memory; the serving copies
    live on the algorithm that attached the model."""

    rank: int
    user_factors: np.ndarray  # [U, rank] float32
    item_factors: np.ndarray  # [I, rank] float32
    user_map: BiMap
    item_map: BiMap

    def sanity_check(self):
        """``Engine.train`` calls this before the instance is stored: a
        run whose factors went non-finite fails instead of deploying."""
        if not np.isfinite(self.user_factors).all():
            raise ValueError("ALS produced non-finite user factors")
        if not np.isfinite(self.item_factors).all():
            raise ValueError("ALS produced non-finite item factors")


def als_config(p: ALSAlgorithmParams) -> ALSConfig:
    """The trainer's configuration for the template's params (what
    ``ALSAlgorithm.train`` runs)."""
    return ALSConfig(
        rank=p.rank,
        iterations=p.num_iterations,
        lambda_=p.lambda_,
        seed=p.seed,
        implicit_prefs=p.implicit_prefs,
        alpha=p.alpha,
        solve_mode=p.solve_mode,
        gather_dtype=p.gather_dtype,
        sort_gather_indices=p.sort_gather_indices,
        fused_gather=p.fused_gather,
    )


def als_model_from_numpy(
    rank: int,
    user_factors,
    item_factors,
    user_ids: IdsLike,
    item_ids: IdsLike,
) -> ALSModel:
    """The port's ``ALSModel`` from plain arrays — the weight carry from
    the JAX package: pass its model's ``user_factors``, ``item_factors``,
    ``user_map.to_dict()`` and ``item_map.to_dict()`` (a list of ids in
    row order works too). Copies into contiguous float32."""
    uf = np.ascontiguousarray(np.asarray(user_factors, dtype=np.float32))
    itf = np.ascontiguousarray(np.asarray(item_factors, dtype=np.float32))
    for name, table in (("user_factors", uf), ("item_factors", itf)):
        if table.ndim != 2 or table.shape[1] != rank:
            raise ValueError(
                f"{name} must be [n, {rank}], got {table.shape}"
            )
    return ALSModel(
        rank=rank,
        user_factors=uf,
        item_factors=itf,
        user_map=BiMap.from_ids(user_ids, uf.shape[0], "user"),
        item_map=BiMap.from_ids(item_ids, itf.shape[0], "item"),
    )


def _quantized_serving_requested(flag: Optional[bool]) -> bool:
    """The JAX package's tri-state: explicit flag, else
    ``PIO_SERVE_QUANT``, else off."""
    if flag is not None:
        return flag
    return os.environ.get("PIO_SERVE_QUANT", "0").strip() == "1"


class ALSAlgorithm(Algorithm):
    """ALS training and serving on the card (``ALSAlgorithm.scala``).

    ``device`` is where training runs and the factor tables live; None
    takes the workflow context's device (``cuda:0`` by default)."""

    params_class = ALSAlgorithmParams

    def __init__(
        self,
        params: ALSAlgorithmParams = ALSAlgorithmParams(),
        device: DeviceLike = None,
    ):
        self.params = params
        self.device: Optional[torch.device] = (
            None if device is None else resolve_device(device)
        )
        #: the top-k path the LAST batch took ("streaming" | "dense";
        #: None before the first query), read by /status.json
        self._topk_path: Optional[str] = None
        #: (weakref to the attached model, its device user/item tables)
        self._tables = None
        self._tables_lock = threading.Lock()

    @property
    def topk_path(self) -> Optional[str]:
        return self._topk_path

    def train(self, ctx, pd: PreparedData) -> ALSModel:
        """Single-device ALS on the context's device (``ALSAlgorithm.scala:
        45-70``). A serving-lever typo or a lever that is not ported fails
        the training run, not the first query after deploy. With a
        checkpoint cadence above 0 and a context that has a checkpoint
        directory (``run_train``'s), the tables are checkpointed under
        ``algo_<i>`` and a rerun resumes from them (``PIO_CKPT_RESUME=0``
        clears them first). Returns the factor tables as numpy arrays with
        the id maps."""
        p = self.params
        device = self.device or (ctx.device if ctx is not None else resolve_device(None))
        use_streaming_topk(p.streaming_top_k, device)
        if _quantized_serving_requested(p.quantized_serving):
            raise NotImplementedError(QUANT_NOT_PORTED)
        # the JAX package's resolution: params > PIO_TRAIN_SHARDS > 1, and
        # params > workflow run > PIO_CKPT_EVERY > 0 for the cadence
        if resolve_shards(p.shards) > 1 or p.distributed:
            raise NotImplementedError(
                "sharded and distributed ALS are not ported yet (ROADMAP.md, "
                "queue 1: sharded ALS on torch.distributed)"
            )
        every = resolve_every(p.checkpoint_every,
                              workflow=getattr(ctx, "checkpoint_every", None))
        checkpoint = None
        manager_factory = getattr(ctx, "checkpoint_manager", None)
        if every > 0 and manager_factory is not None:
            # one namespace per algorithm slot: a second ALS block of the
            # same engine never resumes from this one's factors
            checkpoint = manager_factory(subdir=f"algo_{getattr(ctx, 'algorithm_index', 0)}")
            if checkpoint is not None and not resolve_resume():
                # --no-resume: train fresh (the manager lists the empty
                # directory it expects)
                shutil.rmtree(checkpoint.directory, ignore_errors=True)
                os.makedirs(checkpoint.directory, exist_ok=True)
        cfg = als_config(p)
        factors = als_train_coo(
            pd.users,
            pd.items,
            pd.ratings,
            n_users=len(pd.user_map),
            n_items=len(pd.item_map),
            cfg=cfg,
            device=device,
            profile=getattr(ctx, "profile", None),
            checkpoint=checkpoint,
            checkpoint_every=every,
        )
        return ALSModel(
            rank=p.rank,
            user_factors=factors.user_factors.cpu().numpy(),
            item_factors=factors.item_factors.cpu().numpy(),
            user_map=pd.user_map,
            item_map=pd.item_map,
        )

    def prepare_serving(self, model: ALSModel, ctx) -> None:
        """Deploy-time attach: validate the serving levers and move the
        model's tables to the context's device, once."""
        if self.device is None:
            self.device = ctx.device
        self._device_tables(model)

    def _device_tables(self, model: ALSModel) -> Tuple[torch.Tensor, torch.Tensor]:
        """The model's (user, item) factor tables on this algorithm's
        device, copied there once per model object and cached."""
        with self._tables_lock:
            cached = self._tables
            if cached is not None and cached[0]() is model:
                return cached[1], cached[2]
            if _quantized_serving_requested(self.params.quantized_serving):
                raise NotImplementedError(QUANT_NOT_PORTED)
            if self.device is None:
                self.device = resolve_device(None)
            # a config typo fails at attach, not mid-serving
            use_streaming_topk(self.params.streaming_top_k, self.device)
            uf = torch.from_numpy(
                np.ascontiguousarray(model.user_factors, dtype=np.float32)
            ).to(self.device)
            itf = torch.from_numpy(
                np.ascontiguousarray(model.item_factors, dtype=np.float32)
            ).to(self.device)
            self._tables = (weakref.ref(model), uf, itf)
            return uf, itf

    def shard_model(self, model: ALSModel, shard_index: int, shard_count: int) -> ALSModel:
        """One item-table partition for sharded serving (JAX
        ``models/recommendation.py:771-795``): item row ``i`` lives on
        shard ``i % shard_count``, so popular head items spread across
        shards; the user table stays whole and the item map is rebuilt
        over the kept rows. The union of the shards' local top-ks holds
        the global top-k, which ``fleet.merge`` rebuilds exactly."""
        keep = np.arange(shard_index, model.item_factors.shape[0], shard_count)
        inv = model.item_map.inverse
        return ALSModel(
            rank=model.rank,
            user_factors=model.user_factors,
            item_factors=np.ascontiguousarray(model.item_factors[keep]),
            user_map=model.user_map,
            item_map=BiMap({inv[int(old)]: new for new, old in enumerate(keep)}),
        )

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(
        self, model: ALSModel, indexed_queries: Sequence[Tuple[int, Query]]
    ) -> List[Tuple[int, PredictedResult]]:
        """One device call for the whole batch: gather the known users'
        rows, top-k against the catalog, one copy of ``[b, k]`` results
        back to the host. Unknown users get an empty result."""
        known = [
            (i, q) for i, q in indexed_queries if model.user_map.get(q.user) is not None
        ]
        out: List[Tuple[int, PredictedResult]] = [
            (i, PredictedResult(item_scores=()))
            for i, q in indexed_queries
            if model.user_map.get(q.user) is None
        ]
        if not known:
            return out
        uf, itf = self._device_tables(model)
        n_items = itf.shape[0]
        max_k = min(max(q.num for _, q in known), n_items)
        user_idx = np.asarray([model.user_map[q.user] for _, q in known], dtype=np.int32)
        # shape bucketing: pad B and k to powers of two so the kernel sees
        # O(log^2) shapes; slice on the host
        b = len(user_idx)
        b_pad = pad_pow2(b)
        k_pad = min(pad_pow2(max_k, lo=8), n_items)
        padded = torch.from_numpy(np.pad(user_idx, (0, b_pad - b))).to(itf.device)
        mode = self.params.streaming_top_k
        self._topk_path = resolve_topk_path(mode, itf.device)
        scores, items = top_k_for_users_fused(uf, itf, padded, k=k_pad, mode=mode)
        s_rows, i_rows = results_to_host(scores, items, b, max_k)
        inv = model.item_map.inverse
        for row, (i, q) in enumerate(known):
            k = min(q.num, max_k)
            s_row, i_row = s_rows[row], i_rows[row]
            out.append(
                (
                    i,
                    PredictedResult(
                        item_scores=tuple(
                            ItemScore(item=inv[i_row[j]], score=s_row[j])
                            for j in range(k)
                        )
                    ),
                )
            )
        return out

    def query_class(self):
        return Query


def engine_factory() -> Engine:
    """The template's EngineFactory (``RecommendationEngine``)."""
    return Engine(
        {"": RecDataSource},
        {"": RecPreparator},
        {"als": ALSAlgorithm, "": ALSAlgorithm},
        {"": FirstServing},
    )


# -- evaluation (the reference's MovieLens example: Precision@K,
#    examples/experimental/scala-local-movielens-evaluation/src/main/scala/
#    Evaluation.scala:83,115) --------------------------------------------
class PrecisionAtK(OptionAverageMetric):
    """Fraction of relevant held-out interactions recovered in the top-k.

    A held-out (query, actual) row counts only when the actual rating meets
    ``rating_threshold`` (the others are skipped: the Option part); its
    point is 1.0 when the actual item is among the first ``k`` predicted."""

    def __init__(self, k: int = 10, rating_threshold: float = 4.0):
        self.k = k
        self.rating_threshold = rating_threshold

    @property
    def header(self) -> str:
        return f"Precision@{self.k} (threshold={self.rating_threshold})"

    def calculate_point(self, q, p, a) -> Optional[float]:
        if a.score < self.rating_threshold:
            return None
        top = [s.item for s in p.item_scores[: self.k]]
        return 1.0 if a.item in top else 0.0


class RecEvaluation(Evaluation):
    """``pio eval`` target for this template."""

    def __init__(self, k: int = 10, rating_threshold: float = 4.0):
        super().__init__()
        self.engine_metric = (
            engine_factory(),
            PrecisionAtK(k=k, rating_threshold=rating_threshold),
        )


class RecParamsGenerator(EngineParamsGenerator):
    """Hyperparameter grid over rank × λ (the reference example's
    EngineParamsGenerator pattern)."""

    def __init__(
        self,
        app_id: int = 1,
        ranks: Sequence[int] = (8, 16),
        lambdas: Sequence[float] = (0.01, 0.1),
    ):
        base_ds = RecDataSourceParams(app_id=app_id)
        super().__init__([
            EngineParams(
                data_source_params=("", base_ds),
                algorithm_params_list=[("als", ALSAlgorithmParams(rank=r, lambda_=lam))],
            )
            for r in ranks
            for lam in lambdas
        ])
