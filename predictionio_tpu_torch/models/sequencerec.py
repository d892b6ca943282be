"""Sequence-recommendation template (causal transformer, next-item
prediction) — training and serving on the card.

Counterpart of ``predictionio_tpu/models/sequencerec.py``, with its
names: the same query/result types, the same params fields and defaults
(an ``engine.json`` written for either package parses in both), the
same preparator windows (left-padded with PAD = ``len(item_map)``, the
tail window anchored), the same initial weights from the same seed
(:func:`_init_params` draws from one ``np.random.Generator`` in the JAX
order, and training then draws its batches from that generator), and
the same pre-LN transformer with tied input/output embeddings.

Training is AdamW (optax's ``adamw`` constants on ``torch.optim.AdamW``)
on the algorithm's device. Every attention forward goes through
:func:`..ops.attention.attention`, which on the card runs the
hand-written CUDA flash-attention kernel for both ``flash_impl`` values;
its backward recomputes through the plain blockwise path, as the JAX
custom VJP does. Serving runs one forward per query (the default
``batch_predict`` maps ``predict``, as in JAX) on a device copy of the
weights built once, at ``prepare_serving``.

``SeqDataSource.read_training`` reads the app's view/buy events from
the registry's event store (``get_registry().get_events()``) and orders
each user's items by event time; a caller may also hand ``run_train`` a
DataSource of its own that returns :class:`TrainingData`. A model
trained by the JAX package crosses over as arrays:
:func:`seqrec_model_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    Params,
    Preparator,
)
from ..device import DeviceLike, resolve_device
from ..ops.attention import attention, check_dispatch
from ..storage import BiMap, EventFilter, IdsLike, get_registry

#: inside the rsqrt, as ``_layer_norm`` in the JAX package (not torch's 1e-5)
LN_EPS = 1e-6
#: ``optax.adamw``'s defaults, which the JAX template trains with (every
#: leaf decays: optax applies no mask)
ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4

LAYER_KEYS = ("ln1_g", "ln1_b", "qkv", "proj", "ln2_g", "ln2_b", "mlp_in", "mlp_out")

#: ``fn(q, k, v, causal=True) -> o`` in the ``[B, H, L, D]`` layout
AttentionFn = Callable[..., torch.Tensor]


# -- query / result ---------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Query:
    """Next-item query: by user history (``user``) or explicit recent items."""

    user: Optional[str] = None
    recent_items: Tuple[str, ...] = ()
    num: int = 10


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: Tuple[ItemScore, ...] = ()

    def to_json_dict(self) -> dict:
        # same camelCase wire shape as the recommender templates
        from .wire import item_scores_json

        return item_scores_json(self.item_scores)


# -- training data ----------------------------------------------------------
@dataclasses.dataclass
class TrainingData:
    """Per-user, time-ordered item-id sequences."""

    user_ids: List[str]
    sequences: List[List[str]]

    def sanity_check(self):
        if not self.sequences:
            raise ValueError("No interaction sequences found; check app id "
                             "and event names.")


@dataclasses.dataclass
class PreparedData:
    item_map: BiMap
    windows: np.ndarray  # [W, seq_len + 1] int32, PAD = len(item_map)
    user_recent: Dict[str, List[int]]  # tail of each user's history
    seq_len: int

    @property
    def pad_id(self) -> int:
        return len(self.item_map)


# -- DASE components --------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SeqDataSourceParams(Params):
    app_id: int = 1
    event_names: Tuple[str, ...] = ("view", "buy")


class SeqDataSource(DataSource):
    """Orders each user's view/buy events by event time into one sequence
    (the registry's event store, one columnar scan)."""

    params_class = SeqDataSourceParams

    def __init__(self, params: SeqDataSourceParams = SeqDataSourceParams()):
        self.params = params

    def read_training(self, ctx) -> TrainingData:
        store = get_registry().get_events()
        cols = store.scan_columnar(
            self.params.app_id,
            EventFilter(event_names=list(self.params.event_names)),
        )
        by_user: Dict[str, List[Tuple[int, str]]] = {}
        for uid, tid, tms in zip(
            cols["entity_id"], cols["target_entity_id"],
            cols["event_time_ms"].tolist(),
        ):
            if tid is None:
                continue
            by_user.setdefault(uid, []).append((tms, tid))
        users, seqs = [], []
        for uid, pairs in by_user.items():
            pairs.sort(key=lambda p: p[0])  # stable: ties keep scan order
            users.append(uid)
            seqs.append([tid for _, tid in pairs])
        return TrainingData(user_ids=users, sequences=seqs)

    def read_eval(self, ctx):
        """Leave-one-out: last item of each ≥2-length sequence is the label."""
        td = self.read_training(ctx)
        train_seqs, qa = [], []
        users = []
        for uid, seq in zip(td.user_ids, td.sequences):
            if len(seq) >= 2:
                train_seqs.append(seq[:-1])
                users.append(uid)
                qa.append(
                    (Query(recent_items=tuple(seq[:-1]), num=10),
                     ItemScore(item=seq[-1], score=1.0))
                )
            else:
                train_seqs.append(seq)
                users.append(uid)
        return [(TrainingData(user_ids=users, sequences=train_seqs), None, qa)]


@dataclasses.dataclass(frozen=True)
class SeqPreparatorParams(Params):
    seq_len: int = 64
    #: slide stride when a history is longer than seq_len + 1
    window_stride: int = 32


class SeqPreparator(Preparator):
    """Item indexing + fixed-shape training windows (ragged histories
    become left-padded ``[W, seq_len+1]`` blocks, the JAX package's
    layout, so both packages train on the same rows)."""

    params_class = SeqPreparatorParams

    def __init__(self, params: SeqPreparatorParams = SeqPreparatorParams()):
        self.params = params

    def prepare(self, ctx, td: TrainingData) -> PreparedData:
        L = self.params.seq_len
        item_map = BiMap.string_int(
            [i for seq in td.sequences for i in seq]
        )
        pad = len(item_map)
        windows: List[np.ndarray] = []
        user_recent: Dict[str, List[int]] = {}
        for uid, seq in zip(td.user_ids, td.sequences):
            idx = [item_map[i] for i in seq]
            user_recent[uid] = idx[-L:]
            if len(idx) < 2:
                continue
            span = L + 1
            starts = list(range(0, max(1, len(idx) - span + 1),
                                self.params.window_stride))
            # anchor a final window on the newest interactions — a stride
            # that doesn't divide the history must not drop the tail
            if len(idx) > span and starts[-1] != len(idx) - span:
                starts.append(len(idx) - span)
            for s in starts:
                w = idx[s : s + span]
                if len(w) < span:
                    w = [pad] * (span - len(w)) + w
                windows.append(np.asarray(w, dtype=np.int32))
        if not windows:
            raise ValueError("No training windows (all histories length < 2)")
        return PreparedData(
            item_map=item_map,
            windows=np.stack(windows),
            user_recent=user_recent,
            seq_len=L,
        )


# -- transformer ------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SeqRecAlgorithmParams(Params):
    """The JAX package's fields and defaults, unchanged. ``schedule``
    "flash" and "auto" train on one device; "ring" and "ulysses" raise
    (not ported). ``flash_impl`` "xla" and "pallas" both run the CUDA
    kernel on the card and its plain version on the CPU."""

    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    steps: int = 300
    batch_size: int = 64
    learning_rate: float = 1e-3
    seed: int = 0
    #: attention schedule: "flash" (single device), "ring", "ulysses",
    #: or "auto" (ring when the ctx mesh has a seq axis of size > 1)
    schedule: str = "flash"
    #: attention implementation on the single-device path: "xla"
    #: (default) or "pallas"; on the port both take the CUDA kernel
    flash_impl: str = "xla"


def _init_params(
    rng: np.random.Generator, vocab: int, p: SeqRecAlgorithmParams,
    max_positions: int,
):
    """The JAX package's initial weights, drawn in its order (numpy)."""
    d = p.d_model

    def w(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return (rng.normal(size=shape) * scale).astype(np.float32)

    layers = []
    for _ in range(p.n_layers):
        layers.append({
            "ln1_g": np.ones(d, np.float32), "ln1_b": np.zeros(d, np.float32),
            "qkv": w(d, 3 * d), "proj": w(d, d),
            "ln2_g": np.ones(d, np.float32), "ln2_b": np.zeros(d, np.float32),
            "mlp_in": w(d, 4 * d), "mlp_out": w(4 * d, d),
        })
    return {
        "embed": w(vocab, d, scale=0.02),
        # sized to the training context (pd.seq_len): no silent cap
        "pos": w(max_positions, d, scale=0.02),
        "layers": layers,
        "lnf_g": np.ones(d, np.float32), "lnf_b": np.zeros(d, np.float32),
    }


def _layer_norm(x, g, b):
    # biased variance, eps inside the rsqrt: the JAX _layer_norm exactly
    return F.layer_norm(x, (x.shape[-1],), g, b, eps=LN_EPS)


def forward(
    params: Mapping,
    tokens: torch.Tensor,
    n_heads: int,
    schedule: str = "flash",
    flash_impl: str = "xla",
    attention_fn: Optional[AttentionFn] = None,
) -> torch.Tensor:
    """Causal LM forward: tokens [B, L] int → logits [B, L, V].

    ``params`` holds tensors under the JAX pytree's keys. Attention goes
    through :func:`..ops.attention.attention` (the kernel on the card)
    unless ``attention_fn`` is given: the tests and ``chip_smoke.py`` pass
    the plain :func:`..ops.attention.flash_attention` there to run the
    yardstick on the card. The algorithm never sets it."""
    b, l = tokens.shape
    d = params["embed"].shape[1]
    max_pos = params["pos"].shape[0]
    if l > max_pos:
        raise ValueError(
            f"sequence length {l} exceeds the model's positional table "
            f"({max_pos} positions — trained with a shorter seq_len)"
        )
    h = params["embed"][tokens.long()] + params["pos"][:l][None]
    dh = d // n_heads

    def heads(t):
        return t.reshape(b, l, n_heads, dh).transpose(1, 2)

    for layer in params["layers"]:
        x = _layer_norm(h, layer["ln1_g"], layer["ln1_b"])
        q, k, v = (x @ layer["qkv"]).split(d, dim=-1)  # [B, L, 3D] in thirds
        if attention_fn is None:
            o = attention(
                heads(q), heads(k), heads(v), causal=True,
                schedule=schedule if schedule != "flash" else "auto",
                impl=flash_impl,
            )
        else:
            o = attention_fn(heads(q), heads(k), heads(v), causal=True)
        o = o.transpose(1, 2).reshape(b, l, d)
        h = h + o @ layer["proj"]
        x = _layer_norm(h, layer["ln2_g"], layer["ln2_b"])
        # jax.nn.gelu's default is the tanh approximation
        h = h + F.gelu(x @ layer["mlp_in"], approximate="tanh") @ layer["mlp_out"]
    h = _layer_norm(h, params["lnf_g"], params["lnf_b"])
    return h @ params["embed"].T  # tied softmax


def _leaves(tree: Mapping) -> List[Tuple[str, np.ndarray]]:
    """(name, array) of every weight, names as ``layers.0.qkv``."""
    out = [(key, tree[key]) for key in ("embed", "pos", "lnf_g", "lnf_b")]
    for i, layer in enumerate(tree["layers"]):
        out += [(f"layers.{i}.{key}", layer[key]) for key in LAYER_KEYS]
    return out


class SeqRecTransformer(nn.Module):
    """The transformer's weights as ``nn.Parameter``s under the JAX
    pytree's keys; ``forward`` is the module-level :func:`forward`."""

    def __init__(self, params: Mapping, n_heads: int):
        super().__init__()

        def param(a):
            return nn.Parameter(torch.tensor(np.asarray(a, dtype=np.float32)))

        self.n_heads = n_heads
        self.embed = param(params["embed"])
        self.pos = param(params["pos"])
        self.layers = nn.ModuleList(
            nn.ParameterDict({key: param(layer[key]) for key in LAYER_KEYS})
            for layer in params["layers"]
        )
        self.lnf_g = param(params["lnf_g"])
        self.lnf_b = param(params["lnf_b"])

    def param_tree(self) -> dict:
        """The weights as the JAX pytree's dict (tensors, not copies)."""
        return {
            "embed": self.embed, "pos": self.pos,
            "layers": [dict(layer.items()) for layer in self.layers],
            "lnf_g": self.lnf_g, "lnf_b": self.lnf_b,
        }

    def to_numpy(self) -> dict:
        """The weights as the JAX pytree's dict of float32 numpy arrays."""
        tree = self.param_tree()

        def host(t):
            return t.detach().cpu().numpy().copy()

        return {
            "embed": host(tree["embed"]), "pos": host(tree["pos"]),
            "layers": [{k: host(t) for k, t in layer.items()}
                       for layer in tree["layers"]],
            "lnf_g": host(tree["lnf_g"]), "lnf_b": host(tree["lnf_b"]),
        }

    def forward(self, tokens, schedule: str = "flash", flash_impl: str = "xla",
                attention_fn: Optional[AttentionFn] = None):
        return forward(self.param_tree(), tokens, self.n_heads, schedule,
                       flash_impl, attention_fn)


def masked_loss(logits: torch.Tensor, tgt: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Mean next-item cross entropy over the non-PAD targets (PAD
    positions still take part in attention; only the loss masks them)."""
    ll = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1).long(),
        reduction="none",
    ).reshape(tgt.shape)
    mask = (tgt != pad_id).float()
    return (ll * mask).sum() / mask.sum().clamp_min(1.0)


def adamw(model: nn.Module, learning_rate: float) -> torch.optim.Optimizer:
    """``optax.adamw(learning_rate)`` over every parameter."""
    return torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=ADAMW_BETAS,
        eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY,
    )


def train_step(
    model: SeqRecTransformer,
    opt: torch.optim.Optimizer,
    batch: torch.Tensor,  # [B, seq_len + 1] window rows
    pad_id: int,
    p: SeqRecAlgorithmParams,
    attention_fn: Optional[AttentionFn] = None,
) -> torch.Tensor:
    """One optimizer step on one batch of windows; returns the loss (on
    the device, not synchronised)."""
    inp, tgt = batch[:, :-1], batch[:, 1:]
    logits = model(inp, p.schedule, p.flash_impl, attention_fn)
    loss = masked_loss(logits, tgt, pad_id)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def train_transformer(
    pd: PreparedData,
    p: SeqRecAlgorithmParams,
    device: torch.device,
    attention_fn: Optional[AttentionFn] = None,
    profile: Optional[dict] = None,
) -> SeqRecTransformer:
    """``p.steps`` AdamW steps from the seeded initial weights, batches
    drawn with ``rng.integers(0, W, size=min(batch_size, W))`` from the
    generator that drew the weights — the JAX ``train`` draw for draw.
    The windows are staged on ``device`` once. With ``profile`` a dict,
    records ``loop_s`` (synchronised), ``steps`` and every step's loss
    (read back once, after the loop)."""
    check_dispatch(p.schedule if p.schedule != "flash" else "auto", p.flash_impl)
    rng = np.random.default_rng(p.seed)
    init = _init_params(rng, len(pd.item_map) + 1, p, max_positions=pd.seq_len)
    model = SeqRecTransformer(init, p.n_heads).to(device)
    opt = adamw(model, p.learning_rate)
    windows = torch.from_numpy(np.ascontiguousarray(pd.windows)).to(device)
    n = windows.shape[0]
    losses = []
    t0 = time.monotonic()
    for _ in range(p.steps):
        take = rng.integers(0, n, size=min(p.batch_size, n))
        batch = windows[torch.from_numpy(take).to(device)]
        loss = train_step(model, opt, batch, pd.pad_id, p, attention_fn)
        if profile is not None:
            losses.append(loss)
    if profile is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        profile["loop_s"] = time.monotonic() - t0
        profile["steps"] = p.steps
        profile["losses"] = torch.stack(losses).cpu().tolist() if losses else []
    return model


#: guards the lazy build of a model's device copy (batch threads race it)
_device_copy_lock = threading.Lock()


@dataclasses.dataclass
class SeqRecModel:
    """Trained transformer + id maps + per-user recent histories. The
    weights are a plain numpy dict under the JAX pytree's keys, so the
    blob never holds device memory; the device copy (built once per
    device, at ``prepare_serving``) is never pickled."""

    params: dict  # numpy pytree
    item_map: BiMap
    user_recent: Dict[str, List[int]]
    seq_len: int
    n_heads: int

    def sanity_check(self):
        for _, leaf in _leaves(self.params):
            if not np.isfinite(np.asarray(leaf)).all():
                raise ValueError("sequencerec produced non-finite weights")

    def device_module(self, device: torch.device) -> SeqRecTransformer:
        """The weights on ``device`` (no gradients), copied there once
        and cached on the model."""
        with _device_copy_lock:
            cached = self.__dict__.get("_device_module")
            if cached is None or cached[0] != device:
                module = SeqRecTransformer(self.params, self.n_heads).to(device)
                module.requires_grad_(False)
                cached = (device, module)
                self.__dict__["_device_module"] = cached
            return cached[1]

    def __getstate__(self):
        # never pickle the device copy (model blobs stay pure numpy)
        state = dict(self.__dict__)
        state.pop("_device_module", None)
        return state


def seqrec_model_from_numpy(
    params: Mapping,
    item_ids: IdsLike,
    user_recent: Mapping[str, Sequence[int]],
    seq_len: int,
    n_heads: int,
) -> SeqRecModel:
    """The port's ``SeqRecModel`` from plain arrays — the weight carry
    from the JAX package: pass its model's ``params`` (the pytree; jax or
    numpy arrays), ``item_map.to_dict()`` (or the item ids in row order),
    ``user_recent``, ``seq_len`` and ``n_heads``. Copies every weight into
    contiguous float32 and checks the shapes against each other."""
    def host(a):
        return np.ascontiguousarray(np.asarray(a, dtype=np.float32))

    tree = {
        "embed": host(params["embed"]), "pos": host(params["pos"]),
        "layers": [{key: host(layer[key]) for key in LAYER_KEYS}
                   for layer in params["layers"]],
        "lnf_g": host(params["lnf_g"]), "lnf_b": host(params["lnf_b"]),
    }
    embed = tree["embed"]
    if embed.ndim != 2 or embed.shape[0] < 2:
        raise ValueError(f"embed must be [items + 1, d_model], got {embed.shape}")
    n_items, d = embed.shape[0] - 1, embed.shape[1]
    if d % n_heads:
        raise ValueError(f"d_model {d} is not a multiple of n_heads {n_heads}")
    want = {"pos": (None, d), "lnf_g": (d,), "lnf_b": (d,)}
    layer_want = {"ln1_g": (d,), "ln1_b": (d,), "qkv": (d, 3 * d), "proj": (d, d),
                  "ln2_g": (d,), "ln2_b": (d,), "mlp_in": (d, 4 * d),
                  "mlp_out": (4 * d, d)}
    for i, layer in enumerate(tree["layers"]):
        want.update({f"layers.{i}.{k}": s for k, s in layer_want.items()})
    for name, leaf in _leaves(tree):
        shape = want.get(name)
        if shape is not None and (
            leaf.ndim != len(shape)
            or any(w is not None and w != got for w, got in zip(shape, leaf.shape))
        ):
            raise ValueError(f"{name} must be {shape}, got {leaf.shape}")
    if tree["pos"].shape[0] < seq_len:
        raise ValueError(
            f"pos has {tree['pos'].shape[0]} positions, fewer than seq_len {seq_len}"
        )
    recent = {}
    for user, idx in user_recent.items():
        rows = [int(i) for i in idx][-seq_len:]
        if any(not 0 <= i < n_items for i in rows):
            raise ValueError(f"user {user!r}'s recent items fall outside 0..{n_items - 1}")
        recent[user] = rows
    return SeqRecModel(
        params=tree,
        item_map=BiMap.from_ids(item_ids, n_items, "item"),
        user_recent=recent,
        seq_len=seq_len,
        n_heads=n_heads,
    )


def top_k_lower_index_first(scores: torch.Tensor, k: int):
    """The k best of the ``[V]`` scores, descending, the lower index first
    among equal scores: ``jax.lax.top_k``'s order, which the JAX package
    serves. ``torch.topk`` leaves the order of ties unspecified; a stable
    descending sort of one row of the catalog (a few thousand items)
    keeps them in index order."""
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    return top_s[:k], top_i[:k]


class SeqRecAlgorithm(Algorithm):
    """Causal-transformer next-item trainer and server.

    ``device`` is where training runs and the serving copy lives; None
    takes the workflow context's device (``cuda:0`` by default)."""

    params_class = SeqRecAlgorithmParams

    def __init__(
        self,
        params: SeqRecAlgorithmParams = SeqRecAlgorithmParams(),
        device: DeviceLike = None,
    ):
        self.params = params
        self.device: Optional[torch.device] = (
            None if device is None else resolve_device(device)
        )

    def train(self, ctx, pd: PreparedData) -> SeqRecModel:
        """AdamW training on the context's device; returns the weights as
        numpy arrays with the item map and the users' recent items."""
        p = self.params
        device = self.device or (ctx.device if ctx is not None else resolve_device(None))
        module = train_transformer(pd, p, device, profile=getattr(ctx, "profile", None))
        return SeqRecModel(
            params=module.to_numpy(),
            item_map=pd.item_map,
            user_recent=pd.user_recent,
            seq_len=pd.seq_len,
            n_heads=p.n_heads,
        )

    def prepare_serving(self, model: SeqRecModel, ctx) -> None:
        """Deploy-time attach: a config the port cannot serve fails here,
        and the weights move to the context's device, once."""
        check_dispatch(
            self.params.schedule if self.params.schedule != "flash" else "auto",
            self.params.flash_impl,
        )
        if self.device is None:
            self.device = ctx.device
        model.device_module(self.device)

    # -- serving ----------------------------------------------------------
    def _tokens_for(self, model: SeqRecModel, query: Query) -> Optional[List[int]]:
        if query.recent_items:
            idx = [
                model.item_map[i]
                for i in query.recent_items
                if model.item_map.get(i) is not None
            ]
            return idx[-model.seq_len:] or None
        if query.user is not None:
            return model.user_recent.get(query.user)
        return None

    def predict(self, model: SeqRecModel, query: Query) -> PredictedResult:
        recent = self._tokens_for(model, query)
        if not recent:
            return PredictedResult(item_scores=())
        if self.device is None:
            self.device = resolve_device(None)
        module = model.device_module(self.device)
        pad_id = len(model.item_map)
        # left-pad to the training context length: one shape for every query
        seq = [pad_id] * (model.seq_len - len(recent)) + list(recent)
        tokens = torch.tensor([seq], dtype=torch.long, device=self.device)
        k = min(query.num, len(model.item_map))
        with torch.no_grad():
            logits = module(tokens, flash_impl=self.params.flash_impl)[0, -1]
            # Next-item prediction keeps previously-seen items eligible
            # (Markov semantics: the next state may be a revisit) — only
            # PAD is masked.
            scores = torch.log_softmax(logits, dim=-1)
            scores[pad_id] = float("-inf")
            top_s, top_i = top_k_lower_index_first(scores, k)
        inv = model.item_map.inverse
        return PredictedResult(
            item_scores=tuple(
                ItemScore(item=inv[i], score=s)
                for s, i in zip(top_s.tolist(), top_i.tolist())
                if math.isfinite(s)
            )
        )

    def query_class(self):
        return Query


def engine_factory() -> Engine:
    """EngineFactory for the sequence-recommendation template."""
    return Engine(
        {"": SeqDataSource},
        {"": SeqPreparator},
        {"transformer": SeqRecAlgorithm, "": SeqRecAlgorithm},
        {"": FirstServing},
    )
