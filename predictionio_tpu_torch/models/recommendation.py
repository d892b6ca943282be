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

With ``quantized_serving`` on (params, else ``PIO_SERVE_QUANT``), the
attach also quantizes the item table to int8 and runs the exactness gate
(:func:`..quant.quantize_serving_table`: the f32 leg through the top-k
kernel) before any quantized answer; a refusal raises
:class:`..quant.QuantGateError`, at train time or on the first query.
Quantized batches are scored by :func:`..quant.top_k_quantized`, plain
PyTorch (``topkPath`` "quant"). ``fold_in`` and ``fold_in_partitioned``
re-solve only the rows a delta touched (:mod:`..continuous.foldin`,
kernels 3 and 2 on the card) and re-gate the folded model.

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

import concurrent.futures
import dataclasses
import logging
import os
import shutil
import threading
import time
import weakref
from typing import Callable, List, Optional, Sequence, Tuple

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
from ..ops.als import ALSConfig, ALSFactors, als_train_coo, rmse
from ..ops.als_sharded import resolve_shards
from ..ops.scoring import (
    pad_pow2,
    resolve_topk_path,
    results_to_host,
    top_k_for_users_fused,
    use_streaming_topk,
)
from ..quant import quantize_serving_table, resolve_quantized_serving, top_k_quantized
from ..storage import BiMap, IdsLike, get_registry
from ..workflow.infeed import stream_ratings

_logger = logging.getLogger(__name__)


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
    ``use_streaming_topk``), ``quantized_serving`` (params, else
    ``PIO_SERVE_QUANT``, else off) and ``quant_gate_min_match``."""

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
        #: the top-k path the LAST batch took ("streaming" | "dense" |
        #: "quant"; None before the first query), read by /status.json
        self._topk_path: Optional[str] = None
        #: (weakref to the attached model, its device user/item tables)
        self._tables = None
        self._tables_lock = threading.Lock()
        # quantized serving: the gated table of the attached model (a
        # weakref to it: a fold-in's new model gates again) and its status
        self._quant = None
        self._quant_model_ref = None
        self._quant_status: Optional[dict] = None
        self._quant_lock = threading.Lock()

    @property
    def topk_path(self) -> Optional[str]:
        return self._topk_path

    @property
    def quant_status(self) -> Optional[dict]:
        """The gate status of the attached model's quantized table
        (dtype, bytes, compression, matchRate, minMatch); None while the
        lever is off. Read by /status.json (``quantServing``)."""
        return self._quant_status

    def _attach_quant(self, model: ALSModel) -> None:
        """Resolve the ``quantized_serving`` lever against THIS model: once
        a model (weakref identity), at train and fold-in and on the first
        serve of a loaded model, always before any quantized answer, the
        item table is quantized to int8 on this algorithm's device and the
        exactness gate runs. A refusal propagates (loud and counted); it
        never falls back to f32 silently."""
        with self._quant_lock:
            if not resolve_quantized_serving(self.params.quantized_serving):
                self._quant = self._quant_model_ref = self._quant_status = None
                return
            if (self._quant is not None and self._quant_model_ref is not None
                    and self._quant_model_ref() is model):
                return
            uf, itf = self._device_tables(model)
            qtable, status = quantize_serving_table(
                itf, uf, min_match=self.params.quant_gate_min_match)
            status["minMatch"] = self.params.quant_gate_min_match
            self._quant = qtable
            self._quant_model_ref = weakref.ref(model)
            self._quant_status = status

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
        quantized = resolve_quantized_serving(p.quantized_serving)  # a bad env fails here
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
        model = ALSModel(
            rank=p.rank,
            user_factors=factors.user_factors.cpu().numpy(),
            item_factors=factors.item_factors.cpu().numpy(),
            user_map=pd.user_map,
            item_map=pd.item_map,
        )
        if quantized:
            # the gate refuses here, at train time, not on the first query
            if self.device is None:
                self.device = device
            self._attach_quant(model)
        return model

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

    @property
    def fold_in_supported(self) -> bool:
        """Fold-in solves the EXPLICIT normal equations; an implicit-prefs
        model would get wrong row updates, so it retrains fully instead."""
        return not self.params.implicit_prefs

    def _fold_device(self, ctx) -> torch.device:
        if self.device is None:
            self.device = ctx.device if ctx is not None else resolve_device(None)
        return self.device

    def _fold_base(self, model: ALSModel, pd: PreparedData,
                   new_rows: Optional[Callable] = None) -> dict:
        """The prologue of :meth:`fold_in` and :meth:`fold_in_partitioned`:
        extend the model's id maps with pd's universe (stable indices),
        translate pd's COO into the combined space, and seed rows for new
        entities (``new_rows(n_new, rank, seed, offset)``, by default
        :func:`..continuous.foldin.seeded_rows`; a parity check passes the
        JAX package's rows here). Deterministic in (model, pd): every
        partition's fold starts from this same base, so their results
        merge."""
        from ..continuous.foldin import extend_bimap_indexing, seeded_rows

        new_rows = new_rows or seeded_rows
        p = self.params
        rank = model.user_factors.shape[1]
        old_u, old_i = len(model.user_map), len(model.item_map)
        pd_u_ids = [pd.user_map.inverse[i] for i in range(len(pd.user_map))]
        pd_i_ids = [pd.item_map.inverse[i] for i in range(len(pd.item_map))]
        comb_u, new_u = extend_bimap_indexing(model.user_map.to_dict(), pd_u_ids)
        comb_i, new_i = extend_bimap_indexing(model.item_map.to_dict(), pd_i_ids)
        t_u = np.asarray([comb_u[k] for k in pd_u_ids], dtype=np.int32)
        t_i = np.asarray([comb_i[k] for k in pd_i_ids], dtype=np.int32)
        uf = np.concatenate([np.asarray(model.user_factors, dtype=np.float32),
                             np.asarray(new_rows(new_u, rank, p.seed, offset=old_u),
                                        dtype=np.float32)])
        itf = np.concatenate([np.asarray(model.item_factors, dtype=np.float32),
                              np.asarray(new_rows(new_i, rank, p.seed + 1, offset=old_i),
                                         dtype=np.float32)])
        return {"rank": rank, "old_u": old_u, "old_i": old_i, "new_u": new_u,
                "new_i": new_i, "comb_u": comb_u, "comb_i": comb_i,
                "users": t_u[pd.users], "items": t_i[pd.items], "uf": uf, "itf": itf}

    def _fold_rmse(self, uf, itf, rank, users, items, ratings, device) -> float:
        return rmse(ALSFactors(torch.from_numpy(uf).to(device),
                               torch.from_numpy(itf).to(device), rank),
                    users, items, ratings)

    def _refuse_implicit(self) -> None:
        if not self.fold_in_supported:
            raise ValueError(
                "fold_in solves explicit normal equations; "
                "implicit_prefs=True models must retrain fully"
            )

    def fold_in(
        self,
        ctx,
        model: ALSModel,
        pd: PreparedData,
        changed_user_ids: Sequence[str],
        changed_item_ids: Sequence[str],
        policy=None,
        new_rows: Optional[Callable] = None,
    ):
        """ALX-style incremental update (JAX ``models/recommendation.py``
        ``fold_in``): re-solve only the changed and new user and item rows
        against fixed counterpart factors, over the full current data
        ``pd``, on this algorithm's device (the context's, else ``cuda:0``)
        — each side's rows one bucket through the build and solve kernels
        on the card. Existing entities keep their indices (untouched rows
        stay byte-identical); new entities get appended, seeded rows
        (``new_rows``: see :meth:`_fold_base`). The folded model is gated
        again when quantized serving is on. Returns ``(ALSModel,
        FoldInStats)``."""
        from ..continuous import foldin

        self._refuse_implicit()
        device = self._fold_device(ctx)
        policy = policy or foldin.FoldInPolicy()
        base = self._fold_base(model, pd, new_rows)
        rank, users, items = base["rank"], base["users"], base["items"]
        comb_u, comb_i = base["comb_u"], base["comb_i"]
        changed_u = sorted(
            {comb_u[k] for k in changed_user_ids if k in comb_u}
            | set(range(base["old_u"], base["old_u"] + base["new_u"]))
        )
        changed_i = sorted(
            {comb_i[k] for k in changed_item_ids if k in comb_i}
            | set(range(base["old_i"], base["old_i"] + base["new_i"]))
        )
        before = self._fold_rmse(base["uf"], base["itf"], rank, users, items,
                                 pd.ratings, device)
        uf, itf, counts = foldin.fold_in_factors(
            base["uf"], base["itf"], users, items, pd.ratings,
            changed_u, changed_i, self.params.lambda_, policy=policy, device=device,
        )
        after = self._fold_rmse(uf, itf, rank, users, items, pd.ratings, device)
        folded = ALSModel(rank=model.rank, user_factors=uf, item_factors=itf,
                          user_map=BiMap(comb_u), item_map=BiMap(comb_i))
        stats = foldin.FoldInStats(
            folded_users=counts["solved_users"], folded_items=counts["solved_items"],
            new_users=base["new_u"], new_items=base["new_i"],
            rmse_before=before, rmse_after=after,
        )
        # fold-in moved item rows: the old quantized table is stale, and
        # the new one must prove itself again before it serves
        self._attach_quant(folded)
        return folded, stats

    def fold_in_partitioned(
        self,
        ctx,
        model: ALSModel,
        pd: PreparedData,
        parts,
        policy=None,
        max_workers: int = 2,
        timeout_s: float = 0.0,
        clock=None,
        new_rows: Optional[Callable] = None,
    ):
        """Fold per-partition deltas CONCURRENTLY on a bounded pool (JAX
        ``fold_in_partitioned``). ``parts`` maps partition index →
        ``(user_ids, item_ids)``. Every partition folds the SAME extended
        base tables, so results merge by row copy: changed-user row sets
        are disjoint when the write path partitions users; changed items
        may overlap and merge last-partition-wins. New entities that no
        partition named go to every partition (identical inputs, identical
        rows).

        ``timeout_s > 0`` bounds the wait: a partition whose fold has not
        finished by then (or raised) is SKIPPED — left out of the merge
        and of the returned ``completed`` list, so its delta folds again
        next cycle. ``timeout_s == 0`` waits for every partition. Returns
        ``(ALSModel, FoldInStats, completed)``, the stats measured on the
        merged model; raises ``RuntimeError`` when no partition
        completed."""
        from ..continuous import foldin

        self._refuse_implicit()
        device = self._fold_device(ctx)
        policy = policy or foldin.FoldInPolicy()
        clock = clock or time.monotonic
        base = self._fold_base(model, pd, new_rows)
        rank, users, items = base["rank"], base["users"], base["items"]
        comb_u, comb_i = base["comb_u"], base["comb_i"]
        new_u_rows = set(range(base["old_u"], base["old_u"] + base["new_u"]))
        new_i_rows = set(range(base["old_i"], base["old_i"] + base["new_i"]))
        changed: dict = {}
        claimed_u: set = set()
        claimed_i: set = set()
        for idx in sorted(parts):
            user_ids, item_ids = parts[idx]
            cu = {comb_u[k] for k in user_ids if k in comb_u}
            ci = {comb_i[k] for k in item_ids if k in comb_i}
            changed[idx] = (cu, ci)
            claimed_u |= cu
            claimed_i |= ci
        orphan_u = new_u_rows - claimed_u
        orphan_i = new_i_rows - claimed_i
        for cu, ci in changed.values():
            cu |= orphan_u
            ci |= orphan_i

        before = self._fold_rmse(base["uf"], base["itf"], rank, users, items,
                                 pd.ratings, device)
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, min(len(changed), int(max_workers))),
            thread_name_prefix="fold-part",
        )
        futures = {
            idx: pool.submit(
                foldin.fold_in_factors,
                base["uf"], base["itf"], users, items, pd.ratings,
                sorted(cu), sorted(ci), self.params.lambda_, policy=policy,
                device=device,
            )
            for idx, (cu, ci) in sorted(changed.items())
        }
        deadline = clock() + timeout_s if timeout_s > 0 else None
        concurrent.futures.wait(
            futures.values(),
            timeout=None if deadline is None else max(0.0, deadline - clock()),
        )
        # a wedged fold thread runs on past the deadline (threads cannot be
        # killed), holding only the shared read-only base; queued folds
        # are cancelled
        pool.shutdown(wait=False, cancel_futures=True)
        uf = np.array(base["uf"], dtype=np.float32, copy=True)
        itf = np.array(base["itf"], dtype=np.float32, copy=True)
        completed = []
        folded_users = folded_items = 0
        for idx in sorted(futures):
            fut = futures[idx]
            if not fut.done() or fut.cancelled():
                _logger.warning(
                    "fold_in_partitioned: partition %d missed the %.1fs "
                    "deadline; skipped (delta re-folds)", idx, timeout_s)
                continue
            if fut.exception() is not None:
                _logger.warning(
                    "fold_in_partitioned: partition %d fold failed; skipped "
                    "(delta re-folds)", idx, exc_info=fut.exception())
                continue
            uf_p, itf_p, counts = fut.result()
            cu, ci = changed[idx]
            cu_rows = np.asarray(sorted(cu), dtype=np.int64)
            ci_rows = np.asarray(sorted(ci), dtype=np.int64)
            if len(cu_rows):
                uf[cu_rows] = uf_p[cu_rows]
            if len(ci_rows):
                itf[ci_rows] = itf_p[ci_rows]
            completed.append(idx)
            folded_users += counts["solved_users"]
            folded_items += counts["solved_items"]
        if not completed:
            raise RuntimeError(
                f"no partition fold completed within {timeout_s}s "
                f"(partitions {sorted(futures)}) — nothing to commit"
            )
        after = self._fold_rmse(uf, itf, rank, users, items, pd.ratings, device)
        folded = ALSModel(rank=model.rank, user_factors=uf, item_factors=itf,
                          user_map=BiMap(comb_u), item_map=BiMap(comb_i))
        stats = foldin.FoldInStats(
            folded_users=folded_users, folded_items=folded_items,
            new_users=base["new_u"], new_items=base["new_i"],
            rmse_before=before, rmse_after=after,
        )
        self._attach_quant(folded)  # the merged table gates again
        return folded, stats, completed

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
        # gate or refuse BEFORE any answer when the lever is on and this
        # model has not been gated yet
        self._attach_quant(model)
        quant = self._quant
        if quant is not None:
            self._topk_path = "quant"
            scores, items = top_k_quantized(uf, quant, padded, k=k_pad)
        else:
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
