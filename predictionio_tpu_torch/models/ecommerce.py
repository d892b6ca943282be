"""E-commerce recommendation engine template — training and serving on
the card.

Counterpart of ``predictionio_tpu/models/ecommerce.py`` (a rebuild of
``examples/scala-parallel-ecommercerecommendation/train-with-rate-event/
src/main/scala/``): ALS whose predict applies live business filters at
query time —

- explicit ALS over rate events, keeping the LATEST rating per (user,
  item) (``ALSAlgorithm.scala:82-117``), on the context's device through
  :func:`..ops.als.als_train_coo` (the build and solve kernels);
- the seen-items filter from the user's live event stream when
  ``unseen_only`` (``ALSAlgorithm.scala:160-192``);
- the ``unavailableItems`` constraint, read from the latest ``$set`` on
  the ``constraint/unavailableItems`` entity (``ALSAlgorithm.scala:195-215``);
- a known user → the user's factor row against the item table; an
  unknown user → the summed unit rows of the 10 items they viewed last
  against the unit table (``predictNewUser``, ``ALSAlgorithm.scala:284-360``).

Each live read keeps the reference's 200 ms budget. The JAX package
scores a query in host numpy; here the model's tables move to the
algorithm's device once (``prepare_serving``) and a micro-batch is
answered by the streaming top-k kernel on the card: one call for its
known users and one for its new users, each query's black list, seen and
unavailable items, and the complements of its white list and categories
going in as one exclusion list. Non-positive scores are dropped after
the top-k, which keeps the JAX answer: it takes the top ``min(num,
#finite positive)``, and every positive score ranks above every other.

A model trained by the JAX package crosses over as arrays:
:func:`ecommerce_model_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading
import time
import weakref
from typing import Any, Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    Params,
)
from ..device import DeviceLike, resolve_device
from ..ops.als import ALSConfig, als_train_coo
from ..ops.scoring import (
    exclusion_matrix,
    pad_pow2,
    resolve_topk_path,
    results_to_host,
    summed_rows,
    top_k_for_users_fused,
    top_k_fused_vectors,
    unit_rows,
)
from ..storage import BiMap, EventFilter, IdsLike, get_registry
from .similarproduct import (
    Item,
    ItemScore,
    PredictedResult,
    _item,
    build_category_members,
    category_allowed_mask,
)

logger = logging.getLogger(__name__)

#: Live event-read budget (seconds) — the template's 200 ms Duration.
LIVE_READ_TIMEOUT_S = 0.2


@dataclasses.dataclass(frozen=True)
class Query:
    """``Query(user, num, categories, whiteList, blackList)``."""

    user: str
    num: int = 10
    categories: Optional[Tuple[str, ...]] = None
    white_list: Optional[Tuple[str, ...]] = None
    black_list: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass
class RateEvent:
    user: str
    item: str
    rating: float
    t: int


@dataclasses.dataclass
class TrainingData:
    users: Dict[str, None]
    items: Dict[str, Item]
    rate_events: List[RateEvent]

    def sanity_check(self) -> None:
        if not self.rate_events:
            raise ValueError("ecommerce TrainingData has no rate events")


@dataclasses.dataclass(frozen=True)
class ECommerceDataSourceParams(Params):
    app_id: int = 1


class ECommerceDataSource(DataSource):
    """``$set`` user/item entities + rate events (template DataSource)."""

    params_class = ECommerceDataSourceParams

    def __init__(
        self, params: ECommerceDataSourceParams = ECommerceDataSourceParams()
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
        rates: List[RateEvent] = []
        for e in store.find(
            app_id, EventFilter(entity_type="user", event_names=["rate"])
        ):
            if e.target_entity_id is None:
                continue
            rates.append(
                RateEvent(
                    user=e.entity_id,
                    item=e.target_entity_id,
                    rating=float(e.properties.get("rating")),
                    t=int(e.event_time.timestamp() * 1000),
                )
            )
        return TrainingData(users=users, items=items, rate_events=rates)


@dataclasses.dataclass(frozen=True)
class ECommerceALSParams(Params):
    """``ALSAlgorithmParams(appId, unseenOnly, seenEvents, rank,
    numIterations, lambda, seed)``."""

    app_id: int = 1
    unseen_only: bool = True
    seen_events: Tuple[str, ...] = ("buy", "view")
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    seed: int = 3


@dataclasses.dataclass
class ECommerceModel:
    """Factor tables + id maps (``ALSModel``, ``ALSAlgorithm.scala:30-51``).
    Plain numpy: the serving copies live on the algorithm that attached
    the model."""

    rank: int
    user_factors: np.ndarray  # [U, R]
    item_factors: np.ndarray  # [I, R]
    user_map: BiMap
    item_map: BiMap
    items: Dict[int, Item]

    def sanity_check(self) -> None:
        if not np.isfinite(self.user_factors).all():
            raise ValueError("ECommerceModel user factors are non-finite")

    @functools.cached_property
    def category_members(self) -> Dict[str, np.ndarray]:
        """category → member index arrays, built once per model instance;
        not pickled."""
        return build_category_members(self.items)

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("category_members", None)
        return state


def ecommerce_model_from_numpy(
    user_factors,
    item_factors,
    user_ids: IdsLike,
    item_ids: IdsLike,
    items: Mapping[int, Any],
    rank: int,
) -> ECommerceModel:
    """The port's ``ECommerceModel`` from plain arrays — the weight carry
    from the JAX package: pass its model's ``user_factors``,
    ``item_factors``, the two maps' ``to_dict()`` (or ids in row order),
    ``items`` (row → ``Item``, or row → categories) and ``rank``."""
    uf = np.ascontiguousarray(np.asarray(user_factors, dtype=np.float32))
    itf = np.ascontiguousarray(np.asarray(item_factors, dtype=np.float32))
    for name, table in (("user_factors", uf), ("item_factors", itf)):
        if table.ndim != 2 or table.shape[1] != rank:
            raise ValueError(f"{name} must be [n, {rank}], got {table.shape}")
    return ECommerceModel(
        rank=rank,
        user_factors=uf,
        item_factors=itf,
        user_map=BiMap.from_ids(user_ids, uf.shape[0], "user"),
        item_map=BiMap.from_ids(item_ids, itf.shape[0], "item"),
        items={int(i): _item(v) for i, v in items.items()},
    )


class ECommerceALSAlgorithm(Algorithm):
    """Explicit ALS + live-filtered serving (``ALSAlgorithm.scala``).
    ``device`` is where training runs and the tables live; None takes the
    workflow context's."""

    params_class = ECommerceALSParams

    def __init__(
        self,
        params: ECommerceALSParams = ECommerceALSParams(),
        device: DeviceLike = None,
    ):
        self.params = params
        self.device: Optional[torch.device] = (
            None if device is None else resolve_device(device)
        )
        #: the top-k path the LAST batch took ("streaming" | "dense";
        #: None before the first query), read by /status.json
        self._topk_path: Optional[str] = None
        #: (weakref to the attached model, its user, item and unit tables
        #: on the device)
        self._tables = None
        self._tables_lock = threading.Lock()

    @property
    def topk_path(self) -> Optional[str]:
        return self._topk_path

    # -- train (ALSAlgorithm.scala:64-146) --------------------------------
    def train(self, ctx, pd: TrainingData) -> ECommerceModel:
        device = self.device or (ctx.device if ctx is not None else resolve_device(None))
        if not pd.rate_events:
            raise ValueError("rateEvents cannot be empty")
        if not pd.users or not pd.items:
            raise ValueError("users/items cannot be empty")
        user_map = BiMap.string_int(pd.users.keys())
        item_map = BiMap.string_int(pd.items.keys())
        # latest rating per (user, item) wins
        latest: Dict[Tuple[int, int], RateEvent] = {}
        for r in pd.rate_events:
            u, i = user_map.get(r.user), item_map.get(r.item)
            if u is None or i is None:
                logger.info(
                    "Skipping rate event with unknown ids %s->%s", r.user, r.item
                )
                continue
            key = (u, i)
            if key not in latest or r.t > latest[key].t:
                latest[key] = r
        if not latest:
            raise ValueError("no valid rate events after id mapping")
        users = np.array([k[0] for k in latest], np.int64)
        items = np.array([k[1] for k in latest], np.int64)
        vals = np.array([e.rating for e in latest.values()], np.float32)
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
                implicit_prefs=False,
                seed=self.params.seed,
            ),
            device=device,
            profile=getattr(ctx, "profile", None),
        )
        return ECommerceModel(
            rank=self.params.rank,
            user_factors=factors.user_factors.cpu().numpy(),
            item_factors=factors.item_factors.cpu().numpy(),
            user_map=user_map,
            item_map=item_map,
            items={item_map[i]: item for i, item in pd.items.items()},
        )

    # -- live filters (ALSAlgorithm.scala:160-215) ------------------------
    def _seen_items(self, user: str) -> Set[str]:
        if not self.params.unseen_only:
            return set()
        try:
            store = get_registry().get_events()
            deadline = time.monotonic() + LIVE_READ_TIMEOUT_S
            seen: Set[str] = set()
            for e in store.find_single_entity(
                self.params.app_id,
                entity_type="user",
                entity_id=user,
                event_names=list(self.params.seen_events),
                target_entity_type="item",
            ):
                if e.target_entity_id is not None:
                    seen.add(e.target_entity_id)
                if time.monotonic() > deadline:
                    logger.error("Timeout reading seen events for %s", user)
                    break
            return seen
        except Exception as exc:
            logger.error("Error when read seen events: %s", exc)
            return set()

    def _unavailable_items(self) -> Set[str]:
        try:
            store = get_registry().get_events()
            events = list(
                store.find_single_entity(
                    self.params.app_id,
                    entity_type="constraint",
                    entity_id="unavailableItems",
                    event_names=["$set"],
                    limit=1,
                    latest=True,
                )
            )
            if events:
                return set(events[0].properties.get("items") or ())
            return set()
        except Exception as exc:
            logger.error("Error when read set unavailableItems event: %s", exc)
            return set()

    def _recent_view_items(self, user: str) -> List[str]:
        """Latest 10 viewed items (``predictNewUser``,
        ``ALSAlgorithm.scala:294-323``)."""
        try:
            store = get_registry().get_events()
            return [
                e.target_entity_id
                for e in store.find_single_entity(
                    self.params.app_id,
                    entity_type="user",
                    entity_id=user,
                    event_names=["view"],
                    target_entity_type="item",
                    limit=10,
                    latest=True,
                )
                if e.target_entity_id is not None
            ]
        except Exception as exc:
            logger.error("Error when read recent events: %s", exc)
            return []

    # -- serving ----------------------------------------------------------
    def prepare_serving(self, model: ECommerceModel, ctx) -> None:
        """Deploy-time attach: move the model's tables to the context's
        device, once."""
        if self.device is None:
            self.device = ctx.device
        self._device_tables(model)

    def _device_tables(self, model: ECommerceModel):
        """(user, item, unit) tables on this algorithm's device, copied
        there once per model object and cached."""
        with self._tables_lock:
            cached = self._tables
            if cached is not None and cached[0]() is model:
                return cached[1:]
            if self.device is None:
                self.device = resolve_device(None)
            uf, itf = (
                torch.from_numpy(np.ascontiguousarray(t, dtype=np.float32)).to(self.device)
                for t in (model.user_factors, model.item_factors)
            )
            self._tables = (weakref.ref(model), uf, itf, unit_rows(itf))
            return self._tables[1:]

    def _exclusions(self, model: ECommerceModel, query: Query) -> np.ndarray:
        """The ids one query excludes: the final black list (the query's,
        the user's seen items, the unavailable items), and the items its
        white list or categories leave out."""
        final_black = (set(query.black_list or ()) | self._seen_items(query.user)
                       | self._unavailable_items())
        n = model.item_factors.shape[0]
        excluded = np.zeros((n,), bool)
        excluded[[i for i in (model.item_map.get(x) for x in final_black)
                  if i is not None]] = True
        if query.white_list is not None:
            allowed = np.zeros((n,), bool)
            allowed[[i for i in (model.item_map.get(x) for x in query.white_list)
                     if i is not None]] = True
            excluded |= ~allowed
        if query.categories is not None:
            excluded |= ~category_allowed_mask(
                model.category_members, query.categories, n)
        return np.flatnonzero(excluded)

    def predict(self, model: ECommerceModel, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(
        self, model: ECommerceModel, indexed_queries: Sequence[Tuple[int, Query]]
    ) -> List[Tuple[int, PredictedResult]]:
        """Known users: one top-k of their factor rows (gathered on the
        device) against the item table. New users: one top-k of their
        recent views' summed unit rows against the unit table. A new user
        with no known recent view gets an empty result."""
        out: List[Tuple[int, PredictedResult]] = []
        known, new = [], []  # (pos, query, user row | recent item rows, exclusions)
        for pos, query in indexed_queries:
            uidx = model.user_map.get(query.user)
            if uidx is None:
                logger.info("No userFeature found for user %s", query.user)
                recent = [i for i in (model.item_map.get(x)
                                      for x in self._recent_view_items(query.user))
                          if i is not None]
                if not recent:
                    out.append((pos, PredictedResult(item_scores=())))
                    continue
                new.append((pos, query, recent, self._exclusions(model, query)))
            else:
                known.append((pos, query, uidx, self._exclusions(model, query)))
        if not known and not new:
            return out
        uf, itf, unit = self._device_tables(model)
        dev = itf.device
        n_items = itf.shape[0]
        self._topk_path = resolve_topk_path("auto", dev)
        for rows, table in ((known, itf), (new, unit)):
            if not rows:
                continue
            b = len(rows)
            b_pad = pad_pow2(b)
            max_k = min(max(max(q.num, 0) for _, q, _, _ in rows), n_items)
            k_pad = min(pad_pow2(max_k, lo=8), n_items)
            excl = torch.from_numpy(
                exclusion_matrix([e for _, _, _, e in rows], b_pad)).to(dev)
            if table is itf:
                user_idx = np.zeros(b_pad, dtype=np.int32)
                user_idx[:b] = [u for _, _, u, _ in rows]
                scores, idx = top_k_for_users_fused(
                    uf, itf, torch.from_numpy(user_idx).to(dev), k_pad, excl)
            else:
                qvecs = summed_rows(unit, [r for _, _, r, _ in rows], b_pad)
                scores, idx = top_k_fused_vectors(qvecs, unit, k_pad, excl)
            s_rows, i_rows = results_to_host(scores, idx, b, max_k)
            inv = model.item_map.inverse
            for (pos, query, _, _), s_row, i_row in zip(rows, s_rows, i_rows):
                n = max(query.num, 0)
                out.append((pos, PredictedResult(item_scores=tuple(
                    ItemScore(item=inv[i], score=s)
                    for s, i in zip(s_row[:n], i_row[:n]) if s > 0))))
        return out

    def query_class(self):
        return Query


def engine_factory() -> Engine:
    """``ECommerceRecommendationEngine`` (template ``Engine.scala``)."""
    return Engine(
        {"": ECommerceDataSource},
        {"": IdentityPreparator},
        {"als": ECommerceALSAlgorithm},
        {"": FirstServing},
    )
