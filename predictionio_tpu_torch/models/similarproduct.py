"""Similar-product engine template (multi-algorithm ensemble) — training
and serving on the card.

Counterpart of ``predictionio_tpu/models/similarproduct.py`` (a rebuild
of ``examples/scala-parallel-similarproduct/multi/src/main/scala/``):

- the DataSource reads ``$set`` user/item entities (items carry
  ``categories``), ``view`` events and ``like``/``dislike`` events;
- ``SimilarALSAlgorithm`` trains implicit ALS (α = 1) over view counts
  and scores similarity as the summed cosine between the query items'
  factors and every item's; ``LikeAlgorithm`` trains on like/dislike
  (the latest event per (user, item) wins; like → 1, dislike → -1);
- ``SimilarProductServing`` z-scores each algorithm's scores (not when
  ``num == 1``) and sums them by item, on the host in float64.

Training runs :func:`..ops.als.als_train_coo` on the context's device,
whose normal equations are built and solved there by the hand-written
CUDA kernels. Serving moves the unit-normalised item table to the
algorithm's device once per model (``prepare_serving``), and answers a
micro-batch with one call of :func:`..ops.scoring.top_k_fused_vectors`:
on the card the streaming top-k kernel, for constrained and
unconstrained queries alike. A query's exclusions go in as an index list
— its own items and black list, or, under a category or white-list
filter, every item the filter drops (as many as the catalog).

A model trained by the JAX package crosses over as arrays:
:func:`similar_model_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import weakref
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..controller import (
    Algorithm,
    DataSource,
    Engine,
    IdentityPreparator,
    Params,
    Serving,
)
from ..device import DeviceLike, resolve_device
from ..ops.als import ALSConfig, als_train_coo
from ..ops.scoring import (
    exclusion_matrix,
    pad_pow2,
    resolve_topk_path,
    results_to_host,
    summed_rows,
    top_k_fused_vectors,
    unit_rows,
    use_streaming_topk,
)
from ..storage import BiMap, EventFilter, IdsLike, get_registry


@dataclasses.dataclass(frozen=True)
class Item:
    """``Item(categories)`` (template's DataSource)."""

    categories: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Query:
    """``Query(items, num, categories, whiteList, blackList)``."""

    items: Tuple[str, ...]
    num: int = 10
    categories: Optional[Tuple[str, ...]] = None
    white_list: Optional[Tuple[str, ...]] = None
    black_list: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "items", tuple(self.items))


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


@dataclasses.dataclass
class ViewEvent:
    user: str
    item: str
    t: int  # millis


@dataclasses.dataclass
class LikeEvent:
    user: str
    item: str
    t: int
    like: bool


@dataclasses.dataclass
class TrainingData:
    users: Dict[str, None]
    items: Dict[str, Item]
    view_events: List[ViewEvent]
    like_events: List[LikeEvent]

    def sanity_check(self) -> None:
        if not self.items:
            raise ValueError("similarproduct TrainingData has no items")


@dataclasses.dataclass(frozen=True)
class SimilarProductDataSourceParams(Params):
    app_id: int = 1


class SimilarProductDataSource(DataSource):
    """``$set`` entities + view + like/dislike streams of the app, from
    the registry's event store (multi ``DataSource.scala``)."""

    params_class = SimilarProductDataSourceParams

    def __init__(
        self,
        params: SimilarProductDataSourceParams = SimilarProductDataSourceParams(),
    ):
        self.params = params

    def read_training(self, ctx) -> TrainingData:
        store = get_registry().get_events()
        app_id = self.params.app_id
        users = {
            uid: None
            for uid in store.aggregate_properties(app_id, "user").keys()
        }
        items = {
            iid: Item(categories=tuple(props.get("categories") or ()))
            for iid, props in store.aggregate_properties(app_id, "item").items()
        }
        views: List[ViewEvent] = []
        likes: List[LikeEvent] = []
        for e in store.find(
            app_id,
            EventFilter(
                entity_type="user",
                event_names=["view", "like", "dislike"],
            ),
        ):
            if e.target_entity_id is None:
                continue
            t = int(e.event_time.timestamp() * 1000)
            if e.event == "view":
                views.append(ViewEvent(e.entity_id, e.target_entity_id, t))
            else:
                likes.append(
                    LikeEvent(
                        e.entity_id, e.target_entity_id, t, e.event == "like"
                    )
                )
        return TrainingData(
            users=users, items=items, view_events=views, like_events=likes
        )


@dataclasses.dataclass(frozen=True)
class SimilarALSParams(Params):
    """``ALSAlgorithmParams(rank, numIterations, lambda, seed)``, and the
    top-k path: on the card "auto"/"always" stream through the kernel and
    "never" is refused (see ``use_streaming_topk``)."""

    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    seed: int = 3
    streaming_top_k: str = "auto"


@dataclasses.dataclass
class SimilarALSModel:
    """Item-factor table + id maps (``ALSModel``,
    ``ALSAlgorithm.scala:25-53``); only ``productFeatures`` is needed for
    similarity scoring. Plain numpy: the serving copy of the unit table
    lives on the algorithm that attached the model."""

    item_factors: np.ndarray  # [I, R]
    item_map: BiMap
    items: Dict[int, Item]

    def sanity_check(self) -> None:
        if not np.isfinite(self.item_factors).all():
            raise ValueError("SimilarALSModel factors are non-finite")

    @functools.cached_property
    def category_members(self) -> Dict[str, np.ndarray]:
        """category → member index arrays (see ``build_category_members``),
        built once per model instance; not pickled."""
        return build_category_members(self.items)

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("category_members", None)
        return state


def _item(value: Any) -> Item:
    """An ``Item`` from either package's ``Item`` or a list of categories."""
    return Item(categories=tuple(getattr(value, "categories", value) or ()))


def similar_model_from_numpy(
    item_factors, item_ids: IdsLike, items: Mapping[int, Any]
) -> SimilarALSModel:
    """The port's ``SimilarALSModel`` from plain arrays — the weight carry
    from the JAX package: pass its model's ``item_factors``,
    ``item_map.to_dict()`` (or ids in row order) and ``items`` (row →
    ``Item``, or row → categories)."""
    itf = np.ascontiguousarray(np.asarray(item_factors, dtype=np.float32))
    if itf.ndim != 2:
        raise ValueError(f"item_factors must be [n, rank], got {itf.shape}")
    return SimilarALSModel(
        item_factors=itf,
        item_map=BiMap.from_ids(item_ids, itf.shape[0], "item"),
        items={int(i): _item(v) for i, v in items.items()},
    )


def build_category_members(items: Dict[int, Item]) -> Dict[str, np.ndarray]:
    """category → sorted int32 index array of member items. Shared by the
    similarproduct and ecommerce models (both cache it per instance)."""
    members: Dict[str, list] = {}
    for idx, item in items.items():
        for cat in item.categories:
            members.setdefault(cat, []).append(idx)
    return {
        c: np.asarray(sorted(ids), dtype=np.int32)
        for c, ids in members.items()
    }


def category_allowed_mask(
    members: Dict[str, np.ndarray], categories, n: int
) -> np.ndarray:
    """Bool mask of items belonging to ANY of ``categories`` (the
    ``isCandidateItem`` category rule); items absent from ``members``
    (never $set, or no categories) are not allowed."""
    allowed = np.zeros((n,), bool)
    for cat in categories:
        idx = members.get(cat)
        if idx is not None:
            allowed[idx] = True
    return allowed


def _known(item_map: BiMap, ids) -> List[int]:
    return [i for i in (item_map.get(it) for it in ids) if i is not None]


def _candidate_mask(
    model: SimilarALSModel,
    query: Query,
    query_idx: Sequence[int],
) -> np.ndarray:
    """True = excluded. Mirrors ``isCandidateItem``: drop query items
    themselves, category-mismatched, non-whitelisted, blacklisted."""
    n = model.item_factors.shape[0]
    excluded = np.zeros((n,), bool)
    excluded[list(query_idx)] = True
    if query.categories is not None:
        excluded |= ~category_allowed_mask(
            model.category_members, query.categories, n
        )
    if query.white_list is not None:
        allowed = np.zeros((n,), bool)
        allowed[_known(model.item_map, query.white_list)] = True
        excluded |= ~allowed
    if query.black_list is not None:
        excluded[_known(model.item_map, query.black_list)] = True
    return excluded


def _exclusions(model: SimilarALSModel, query: Query, query_idx: Sequence[int]):
    """The ids one query excludes: its own items and black list, or
    exactly ``_candidate_mask``'s True set under a category or white-list
    filter."""
    if query.categories is None and query.white_list is None:
        return list(query_idx) + _known(model.item_map, query.black_list or ())
    return np.flatnonzero(_candidate_mask(model, query, query_idx))


class SimilarALSAlgorithm(Algorithm):
    """Implicit ALS over view counts; cosine-sum similarity predict
    (``ALSAlgorithm.scala:76-252``). ``device`` is where training runs
    and the unit table lives; None takes the workflow context's."""

    params_class = SimilarALSParams

    def __init__(
        self,
        params: SimilarALSParams = SimilarALSParams(),
        device: DeviceLike = None,
    ):
        self.params = params
        self.device: Optional[torch.device] = (
            None if device is None else resolve_device(device)
        )
        #: the top-k path the LAST batch took ("streaming" | "dense";
        #: None before the first query), read by /status.json
        self._topk_path: Optional[str] = None
        #: (weakref to the attached model, its unit table on the device)
        self._unit = None
        self._unit_lock = threading.Lock()

    @property
    def topk_path(self) -> Optional[str]:
        return self._topk_path

    # -- train ------------------------------------------------------------
    def _ratings(self, pd: TrainingData) -> List[Tuple[str, str, float]]:
        """view count per (user, item) (``ALSAlgorithm.scala:98-119``)."""
        counts: Dict[Tuple[str, str], float] = {}
        for v in pd.view_events:
            counts[(v.user, v.item)] = counts.get((v.user, v.item), 0.0) + 1.0
        return [(u, i, c) for (u, i), c in counts.items()]

    def train(self, ctx, pd: TrainingData) -> SimilarALSModel:
        device = self.device or (ctx.device if ctx is not None else resolve_device(None))
        # a streaming_top_k typo fails the training run, not the first query
        use_streaming_topk(self.params.streaming_top_k, device)
        triplets = self._ratings(pd)
        if not triplets:
            raise ValueError(
                "similarproduct training events are empty; check DataSource"
            )
        user_map = BiMap.string_int(pd.users.keys())
        item_map = BiMap.string_int(pd.items.keys())
        valid = [
            (user_map.get(u), item_map.get(i), r)
            for u, i, r in triplets
            if user_map.get(u) is not None and item_map.get(i) is not None
        ]
        if not valid:
            # the reference trains only over entities of its users/items
            # RDDs: events whose entities were never $set would give an
            # all-zero model
            raise ValueError(
                f"No {type(self).__name__} rating events match $set "
                f"users/items: {len(triplets)} rating pairs, "
                f"{len(user_map)} users, {len(item_map)} items. Send $set "
                "events for the entities referenced by the interaction "
                "events."
            )
        users = np.array([v[0] for v in valid], np.int64)
        items = np.array([v[1] for v in valid], np.int64)
        vals = np.array([v[2] for v in valid], np.float32)
        factors = als_train_coo(
            users,
            items,
            vals,
            n_users=len(user_map),
            n_items=len(item_map),
            cfg=ALSConfig(
                rank=self.params.rank,
                iterations=self.params.num_iterations,
                lambda_=self.params.lambda_,
                implicit_prefs=True,
                alpha=1.0,
                seed=self.params.seed,
            ),
            device=device,
            profile=getattr(ctx, "profile", None),
        )
        return SimilarALSModel(
            item_factors=factors.item_factors.cpu().numpy(),
            item_map=item_map,
            items={item_map[i]: item for i, item in pd.items.items()},
        )

    # -- serving ----------------------------------------------------------
    def prepare_serving(self, model: SimilarALSModel, ctx) -> None:
        """Deploy-time attach: move the model's unit table to the
        context's device, once."""
        if self.device is None:
            self.device = ctx.device
        self._device_unit(model)

    def _device_unit(self, model: SimilarALSModel) -> torch.Tensor:
        """The model's unit-normalised item table on this algorithm's
        device, computed there once per model object and cached."""
        with self._unit_lock:
            cached = self._unit
            if cached is not None and cached[0]() is model:
                return cached[1]
            if self.device is None:
                self.device = resolve_device(None)
            use_streaming_topk(self.params.streaming_top_k, self.device)
            itf = torch.from_numpy(
                np.ascontiguousarray(model.item_factors, dtype=np.float32)
            ).to(self.device)
            unit = unit_rows(itf)
            self._unit = (weakref.ref(model), unit)
            return unit

    def predict(self, model: SimilarALSModel, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(
        self, model: SimilarALSModel, indexed_queries
    ) -> List[Tuple[int, PredictedResult]]:
        """One top-k call for the whole micro-batch (the batched analogue
        of the reference's per-request cosine scoring): each query's
        vector is the sum of its items' unit rows, gathered and summed on
        the device; its exclusions are an index list (``_exclusions``).
        Batch and k are padded to powers of two, as in the JAX package.
        Excluded and non-positive scores never surface."""
        out: List[Tuple[int, PredictedResult]] = []
        rows = []  # (pos, query, query_idx)
        for pos, query in indexed_queries:
            query_idx = _known(model.item_map, query.items)
            if not query_idx:
                out.append((pos, PredictedResult(item_scores=())))
            else:
                rows.append((pos, query, query_idx))
        if not rows:
            return out
        unit = self._device_unit(model)
        n_items = unit.shape[0]
        b = len(rows)
        b_pad = pad_pow2(b)
        max_k = min(max(q.num for _, q, _ in rows), n_items)
        k_pad = min(pad_pow2(max_k, lo=8), n_items)
        # Σ_q cos(q, i) = (Σ_q unit_q) · unit_i
        qvecs = summed_rows(unit, [qi for _, _, qi in rows], b_pad)
        excl = exclusion_matrix([_exclusions(model, q, qi) for _, q, qi in rows], b_pad)
        mode = self.params.streaming_top_k
        self._topk_path = resolve_topk_path(mode, unit.device)
        scores, idx = top_k_fused_vectors(
            qvecs, unit, k_pad, torch.from_numpy(excl).to(unit.device), mode=mode)
        s_rows, i_rows = results_to_host(scores, idx, b, max_k)
        inv = model.item_map.inverse
        for (pos, query, _qi), s_row, i_row in zip(rows, s_rows, i_rows):
            item_scores = []
            for s, i in zip(s_row[: query.num], i_row[: query.num]):
                # positive-cosine semantics: excluded (-inf) and
                # non-similar (<= 0) candidates never surface
                if s <= 0 or s != s:
                    continue
                item_scores.append(ItemScore(item=inv[int(i)], score=s))
            out.append((pos, PredictedResult(item_scores=tuple(item_scores))))
        return out

    def query_class(self):
        return Query


class LikeAlgorithm(SimilarALSAlgorithm):
    """Same model over like/dislike signals: latest event per (user, item)
    wins; like→1, dislike→−1 (``LikeAlgorithm.scala:44-90``). A negative
    rating is a confident zero preference in the implicit solve
    (confidence 1 + α|r|, preference 1[r > 0])."""

    def _ratings(self, pd: TrainingData) -> List[Tuple[str, str, float]]:
        latest: Dict[Tuple[str, str], LikeEvent] = {}
        for e in pd.like_events:
            key = (e.user, e.item)
            if key not in latest or e.t > latest[key].t:
                latest[key] = e
        return [
            (e.user, e.item, 1.0 if e.like else -1.0) for e in latest.values()
        ]


class SimilarProductServing(Serving):
    """Z-score standardize per algorithm (unless ``num == 1``), sum by item,
    top-``num`` (``Serving.scala:14-53``), on the host in float64."""

    def serve(
        self, query: Query, predictions: Sequence[PredictedResult]
    ) -> PredictedResult:
        standardized: List[Tuple[str, float]] = []
        for pr in predictions:
            scores = np.array([s.score for s in pr.item_scores], np.float64)
            if query.num == 1 or scores.size == 0:
                z = scores
            else:
                std = scores.std()
                z = (
                    np.zeros_like(scores)
                    if std == 0
                    else (scores - scores.mean()) / std
                )
            standardized.extend(
                (s.item, float(zv)) for s, zv in zip(pr.item_scores, z)
            )
        combined: Dict[str, float] = {}
        for item, score in standardized:
            combined[item] = combined.get(item, 0.0) + score
        ranked = sorted(combined.items(), key=lambda kv: -kv[1])[: query.num]
        return PredictedResult(
            item_scores=tuple(ItemScore(item=i, score=s) for i, s in ranked)
        )


def engine_factory() -> Engine:
    """``SimilarProductEngine`` (multi ``Engine.scala``: ``Map("als" -> …,
    "likealgo" -> …)``)."""
    return Engine(
        {"": SimilarProductDataSource},
        {"": IdentityPreparator},
        {"als": SimilarALSAlgorithm, "likealgo": LikeAlgorithm},
        {"": SimilarProductServing},
    )
