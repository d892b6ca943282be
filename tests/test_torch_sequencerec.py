"""The sequence recommender of the port against the JAX package's, on the CPU.

Seeded toy histories (a cyclic next-item rule over a small catalogue)
go through both packages' preparators, initial weights, forwards,
3-step AdamW trainings and ``predict``; then the slice as a whole:
``run_train`` → ``persist`` → ``create_query_server`` on the CPU →
``POST /queries.json``. Tolerances: forward logits rtol 1e-4 / atol
1e-5; training rtol 1e-3 / atol 1e-4 (the JAX package's own xla-vs-pallas
tolerance, ``test_sequencerec.py:240-244``); served scores rtol 1e-4 /
atol 1e-5 with items equal or tied (``torch.topk`` promises no order
among ties, ``lax.top_k`` keeps the lower index first).
"""

import dataclasses
import http.client
import json
import pickle

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from predictionio_tpu.models import sequencerec as jseq
from predictionio_tpu_torch.controller import (
    DataSource,
    Engine,
    EngineParams,
    FirstServing,
)
from predictionio_tpu_torch.models import sequencerec as tseq
from predictionio_tpu_torch.ops import attention as port_attention
from predictionio_tpu_torch.storage import STATUS_COMPLETED, Model, StorageRegistry
from predictionio_tpu_torch.workflow import (
    ForeignModelError,
    ServerConfig,
    WorkflowContext,
    create_query_server,
    load_models,
    persist_instance,
    run_train,
)

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
TRAIN_RTOL, TRAIN_ATOL = 1e-3, 1e-4
V = 11  # catalogue i0..i10
SMALL = dict(d_model=16, n_heads=2, n_layers=1, steps=3, batch_size=4, seed=5)
CPU = torch.device("cpu")


def _histories(n_users=8, seed=0):
    """Cyclic next-item histories of ragged lengths (2 to 30)."""
    rng = np.random.default_rng(seed)
    users, seqs = [], []
    for u in range(n_users):
        start, length = int(rng.integers(0, V)), int(rng.integers(2, 31))
        seqs.append([f"i{(start + t) % V}" for t in range(length)])
        users.append(f"u{u}")
    users.append("solo")  # one interaction: recents, no window
    seqs.append(["i3"])
    return users, seqs


def _prepared(seq_len=8, stride=4, histories=None):
    users, seqs = histories or _histories()
    pj = jseq.SeqPreparator(jseq.SeqPreparatorParams(seq_len=seq_len, window_stride=stride))
    pt = tseq.SeqPreparator(tseq.SeqPreparatorParams(seq_len=seq_len, window_stride=stride))
    return (pj.prepare(None, jseq.TrainingData(user_ids=users, sequences=seqs)),
            pt.prepare(None, tseq.TrainingData(user_ids=users, sequences=seqs)))


def _torch_tree(tree):
    return {
        "embed": torch.from_numpy(np.asarray(tree["embed"])),
        "pos": torch.from_numpy(np.asarray(tree["pos"])),
        "layers": [{k: torch.from_numpy(np.asarray(a)) for k, a in layer.items()}
                   for layer in tree["layers"]],
        "lnf_g": torch.from_numpy(np.asarray(tree["lnf_g"])),
        "lnf_b": torch.from_numpy(np.asarray(tree["lnf_b"])),
    }


def _jax_tree(tree):
    return {
        "embed": jnp.asarray(tree["embed"]), "pos": jnp.asarray(tree["pos"]),
        "layers": [{k: jnp.asarray(a) for k, a in layer.items()} for layer in tree["layers"]],
        "lnf_g": jnp.asarray(tree["lnf_g"]), "lnf_b": jnp.asarray(tree["lnf_b"]),
    }


def _init(vocab, seq_len, **params):
    p = tseq.SeqRecAlgorithmParams(**{**SMALL, **params})
    return tseq._init_params(np.random.default_rng(p.seed), vocab, p, seq_len)


@pytest.fixture(scope="module")
def jax_model():
    pd_j, _ = _prepared()
    return jseq.SeqRecAlgorithm(jseq.SeqRecAlgorithmParams(**SMALL)).train(None, pd_j)


@pytest.fixture(scope="module")
def carried(jax_model):
    return tseq.seqrec_model_from_numpy(
        jax_model.params, jax_model.item_map.to_dict(), jax_model.user_recent,
        jax_model.seq_len, jax_model.n_heads)


QUERIES = [
    dict(user="u0", num=5),
    dict(user="u3", num=1),
    dict(user="solo", num=4),
    dict(recent_items=("i1", "i2", "i3"), num=6),
    dict(recent_items=("i9", "ghost", "i10", "i0"), num=20),  # unknown item dropped
    dict(user="nobody"),
    dict(recent_items=("ghost", "phantom")),
    dict(),
]


def _same_or_tied(got, want):
    """Item lists equal position by position, or tied where they differ;
    scores to rtol 1e-4 / atol 1e-5."""
    assert len(got) == len(want)
    if not want:
        return
    gs = np.array([s.score for s in got], np.float32)
    ws = np.array([s.score for s in want], np.float32)
    np.testing.assert_allclose(gs, ws, rtol=FWD_RTOL, atol=FWD_ATOL)
    tied = np.isclose(gs, ws, rtol=FWD_RTOL, atol=FWD_ATOL)
    same = np.array([g.item == w.item for g, w in zip(got, want)])
    assert (same | tied).all()


# -- preparator, ids, initial weights ----------------------------------------
@pytest.mark.parametrize("case", ["ragged", "tail_window", "short"])
def test_preparator_windows_match_jax(case):
    if case == "ragged":
        pd_j, pd_t = _prepared()
    elif case == "tail_window":
        # a stride that does not divide the history: the newest items must
        # still be in a window (the anchored tail, sequencerec.py:181-184)
        hist = (["a", "b"], [[f"x{i}" for i in range(96)], [f"x{i}" for i in range(70, 3, -1)]])
        pd_j, pd_t = _prepared(seq_len=64, stride=32, histories=hist)
        assert (pd_t.windows[:, -1] == pd_t.item_map["x95"]).any()
    else:
        pd_j, pd_t = _prepared(seq_len=4, stride=2,
                               histories=(["a", "b"], [["x", "y", "z"], ["y"]]))
        assert pd_t.windows[0, 0] == pd_t.pad_id
    np.testing.assert_array_equal(pd_t.windows, pd_j.windows)
    assert pd_t.windows.dtype == np.int32
    # first-seen item order: the item indices are the vocabulary rows
    assert list(pd_t.item_map.to_dict().items()) == list(pd_j.item_map.to_dict().items())
    assert pd_t.user_recent == pd_j.user_recent
    assert pd_t.pad_id == pd_j.pad_id and pd_t.seq_len == pd_j.seq_len


def test_empty_histories_are_rejected():
    with pytest.raises(ValueError, match="No training windows"):
        tseq.SeqPreparator().prepare(None, tseq.TrainingData(["a"], [["x"]]))
    with pytest.raises(ValueError, match="No interaction sequences"):
        tseq.TrainingData([], []).sanity_check()


def test_init_params_match_jax():
    p_t = tseq.SeqRecAlgorithmParams(d_model=24, n_heads=3, n_layers=2, seed=9)
    p_j = jseq.SeqRecAlgorithmParams(d_model=24, n_heads=3, n_layers=2, seed=9)
    got = tseq._init_params(np.random.default_rng(9), 17, p_t, 12)
    want = jseq._init_params(np.random.default_rng(9), 17, p_j, 12)
    assert [n for n, _ in tseq._leaves(got)] == [n for n, _ in tseq._leaves(want)]
    for (name, a), (_, b) in zip(tseq._leaves(got), tseq._leaves(want)):
        assert a.dtype == np.float32 and np.array_equal(a, b), name


def test_algorithm_params_keep_the_jax_fields():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    for ours, theirs in (
        (tseq.SeqRecAlgorithmParams, jseq.SeqRecAlgorithmParams),
        (tseq.SeqPreparatorParams, jseq.SeqPreparatorParams),
        (tseq.SeqDataSourceParams, jseq.SeqDataSourceParams),
        (tseq.Query, jseq.Query),
    ):
        assert fields(ours) == fields(theirs)


# -- forward ------------------------------------------------------------------
@pytest.mark.parametrize("d_model,n_heads,n_layers,seq_len", [
    (16, 2, 1, 8), (32, 4, 2, 16), (32, 2, 2, 12),
])
def test_forward_logits_match_jax(d_model, n_heads, n_layers, seq_len):
    vocab = 23
    tree = _init(vocab, seq_len, d_model=d_model, n_heads=n_heads, n_layers=n_layers)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, vocab, size=(3, seq_len)).astype(np.int32)
    tokens[0, :5] = vocab - 1  # left padding, as the windows carry it
    want = np.asarray(jseq.forward(_jax_tree(tree), jnp.asarray(tokens), n_heads))
    got = tseq.forward(_torch_tree(tree), torch.from_numpy(tokens), n_heads)
    assert got.shape == (3, seq_len, vocab)  # tied output: the PAD row included
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL, atol=FWD_ATOL)
    # the plain attention as the yardstick gives the same logits
    plain = tseq.forward(_torch_tree(tree), torch.from_numpy(tokens), n_heads,
                         attention_fn=port_attention.flash_attention)
    np.testing.assert_allclose(plain.numpy(), want, rtol=FWD_RTOL, atol=FWD_ATOL)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(__import__("jax").nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4  # torch's default would differ


def test_layer_norm_keeps_eps_1e6_and_the_biased_variance():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(4, 16)) * 1e-3).astype(np.float32)  # eps-sensitive scale
    g, b = rng.normal(size=16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    want = np.asarray(jseq._layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    got = tseq._layer_norm(*(torch.from_numpy(a) for a in (x, g, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    assert tseq.LN_EPS == 1e-6


def test_pad_positions_take_part_in_attention():
    """No key-padding mask: the PAD row of the embedding moves the logits
    at the last position of a left-padded query, in both packages."""
    vocab, seq_len = 13, 8
    tree = _init(vocab, seq_len)
    tokens = np.array([[vocab - 1] * 5 + [1, 2, 3]], np.int32)
    bumped = {**tree, "embed": tree["embed"].copy()}
    bumped["embed"][vocab - 1] += np.random.default_rng(3).normal(size=16) * 0.5
    for fwd, conv, tok in (
        (tseq.forward, _torch_tree, torch.from_numpy(tokens)),
        (jseq.forward, _jax_tree, jnp.asarray(tokens)),
    ):
        # the real items' logits (the PAD logit moves through the tied output)
        base = np.asarray(fwd(conv(tree), tok, 2))[0, -1, :-1]
        moved = np.asarray(fwd(conv(bumped), tok, 2))[0, -1, :-1]
        assert np.abs(base - moved).max() > 1e-4


def test_both_flash_impls_reach_the_kernel_wrapper(monkeypatch):
    calls = []
    real = port_attention.flash_attention_fwd

    def counting(q, k, v, causal):
        calls.append(causal)
        return real(q, k, v, causal)

    monkeypatch.setattr(port_attention, "flash_attention_fwd", counting)
    tree = _torch_tree(_init(13, 8, n_layers=2))
    tokens = torch.zeros((2, 8), dtype=torch.long)
    for impl in ("xla", "pallas"):
        tseq.forward(tree, tokens, 2, flash_impl=impl)
    assert calls == [True] * 4  # one per layer, each impl
    with pytest.raises(ValueError, match="impl"):
        tseq.forward(tree, tokens, 2, flash_impl="bogus")
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        tseq.forward(tree, tokens, 2, schedule="ring")


# -- training -----------------------------------------------------------------
@pytest.mark.parametrize("flash_impl", ["xla", "pallas"])
def test_three_steps_of_training_match_jax(flash_impl):
    pd_j, pd_t = _prepared()
    params = dict(SMALL, flash_impl=flash_impl)
    want = jseq.SeqRecAlgorithm(jseq.SeqRecAlgorithmParams(**params)).train(None, pd_j)
    ctx = WorkflowContext(device="cpu")
    ctx.profile = {}
    got = tseq.SeqRecAlgorithm(tseq.SeqRecAlgorithmParams(**params)).train(ctx, pd_t)
    for key in ("embed", "pos"):
        np.testing.assert_allclose(got.params[key], np.asarray(want.params[key]),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    batch = pd_t.windows[:6, :-1]
    logits_j = np.asarray(jseq.forward(want.params, jnp.asarray(batch), 2))
    logits_t = tseq.forward(_torch_tree(got.params), torch.from_numpy(batch), 2)
    np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    assert ctx.profile["steps"] == 3 and len(ctx.profile["losses"]) == 3
    assert ctx.profile["loop_s"] >= 0


def test_training_draws_batches_from_the_init_generator(monkeypatch):
    """The same numpy stream, in the JAX order: the weights first, then
    one ``integers(0, W, size=min(batch, W))`` per step."""
    _, pd_t = _prepared()
    seen = []
    real_step = tseq.train_step
    monkeypatch.setattr(tseq, "train_step", lambda model, opt, batch, *a, **kw: (
        seen.append(batch.numpy().copy()), real_step(model, opt, batch, *a, **kw))[1])
    p = tseq.SeqRecAlgorithmParams(**SMALL)
    tseq.train_transformer(pd_t, p, CPU)
    rng = np.random.default_rng(p.seed)
    jseq._init_params(rng, len(pd_t.item_map) + 1, p, max_positions=pd_t.seq_len)
    n = pd_t.windows.shape[0]
    for batch in seen:
        np.testing.assert_array_equal(
            batch, pd_t.windows[rng.integers(0, n, size=min(p.batch_size, n))])
    assert len(seen) == p.steps


def test_adamw_is_optax_adamw_with_every_leaf_decayed():
    rng = np.random.default_rng(4)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4)]
    opt = optax.adamw(1e-2)
    wj, state = jnp.asarray(w0), None
    state = opt.init(wj)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, wj)
        wj = optax.apply_updates(wj, upd)
    module = torch.nn.Linear(3, 5, bias=False)
    module.weight.data = torch.from_numpy(w0.copy())
    topt = tseq.adamw(module, 1e-2)
    for g in grads:
        module.weight.grad = torch.from_numpy(g.copy())
        topt.step()
    np.testing.assert_allclose(module.weight.detach().numpy(), np.asarray(wj),
                               rtol=1e-6, atol=1e-7)
    assert tseq.ADAMW_WEIGHT_DECAY == 1e-4  # not torch's 1e-2


def test_embedding_gradient_sums_repeated_tokens():
    """Tokens repeat in a window (PAD above all): the embedding gradient
    is a scatter-add over them, from the lookup and the tied output."""
    vocab, seq_len = 7, 6
    tree = _init(vocab, seq_len, d_model=16)
    tokens = np.array([[6, 6, 6, 1, 1, 2]], np.int32)
    tgt = np.array([[6, 6, 1, 1, 2, 3]], np.int32)
    import jax

    def loss_j(embed):
        t = dict(_jax_tree(tree), embed=embed)
        logits = jseq.forward(t, jnp.asarray(tokens), 2)
        ll = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(tgt))
        mask = (jnp.asarray(tgt) != 6).astype(jnp.float32)
        return (ll * mask).sum() / mask.sum()

    want = np.asarray(jax.grad(loss_j)(jnp.asarray(tree["embed"])))
    t = _torch_tree(tree)
    t["embed"].requires_grad_()
    loss = tseq.masked_loss(tseq.forward(t, torch.from_numpy(tokens), 2),
                            torch.from_numpy(tgt), 6)
    loss.backward()
    np.testing.assert_allclose(t["embed"].grad.numpy(), want, rtol=TRAIN_RTOL, atol=1e-6)


def test_training_leaves_tf32_off():
    _, pd_t = _prepared()
    tseq.train_transformer(pd_t, tseq.SeqRecAlgorithmParams(**dict(SMALL, steps=1)), CPU)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_what_the_port_cannot_train_is_refused(tmp_path, monkeypatch):
    _, pd_t = _prepared()
    for bad, exc in ((dict(schedule="ring"), NotImplementedError),
                     (dict(schedule="ulysses"), NotImplementedError),
                     (dict(flash_impl="bogus"), ValueError)):
        algo = tseq.SeqRecAlgorithm(tseq.SeqRecAlgorithmParams(**dict(SMALL, **bad)),
                                    device="cpu")
        with pytest.raises(exc):
            algo.train(None, pd_t)
    # reading events is ported (tests/test_torch_infeed.py): an app with
    # no view/buy events reads as empty training data, which is refused
    from predictionio_tpu_torch.storage import StorageRegistry, registry

    monkeypatch.setattr(registry, "_default_registry",
                        StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)}))
    empty = tseq.SeqDataSource().read_training(None)
    assert empty.user_ids == [] and empty.sequences == []
    with pytest.raises(ValueError, match="No interaction sequences"):
        empty.sanity_check()


# -- serving ------------------------------------------------------------------
def test_predict_matches_jax(jax_model, carried):
    jalgo = jseq.SeqRecAlgorithm(jseq.SeqRecAlgorithmParams(**SMALL))
    talgo = tseq.SeqRecAlgorithm(tseq.SeqRecAlgorithmParams(**SMALL), device="cpu")
    for q in QUERIES:
        want = jalgo.predict(jax_model, jseq.Query(**q)).item_scores
        got = talgo.predict(carried, tseq.Query(**q)).item_scores
        _same_or_tied(got, want)
        assert all(s.item != "PAD" for s in got)
    assert talgo.predict(carried, tseq.Query(user="nobody")).item_scores == ()
    assert talgo.predict(carried, tseq.Query(recent_items=("ghost",))).item_scores == ()


def test_top_k_ties_are_compared_as_tied(jax_model):
    """Duplicate every item's embedding row: scores tie in pairs, so the
    two packages may order a pair differently; both answers agree as
    "equal or tied"."""
    params = {**jax_model.params, "embed": np.asarray(jax_model.params["embed"]).copy()}
    params["embed"][1:-1:2] = params["embed"][0:-2:2]
    model_t = tseq.seqrec_model_from_numpy(
        params, jax_model.item_map.to_dict(), jax_model.user_recent,
        jax_model.seq_len, jax_model.n_heads)
    model_j = dataclasses.replace(jax_model, params=_jax_tree(params))
    got = tseq.SeqRecAlgorithm(tseq.SeqRecAlgorithmParams(**SMALL), device="cpu").predict(
        model_t, tseq.Query(user="u0", num=8)).item_scores
    want = jseq.SeqRecAlgorithm(jseq.SeqRecAlgorithmParams(**SMALL)).predict(
        model_j, jseq.Query(user="u0", num=8)).item_scores
    _same_or_tied(got, want)
    scores = [s.score for s in got]
    assert len(set(np.round(scores, 5))) < len(scores)  # ties are really there


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 5, 17])
def test_top_k_breaks_ties_by_the_lower_index_like_jax(seed, k):
    """Scores with planted ties (values drawn from a few levels, -inf
    among them): the port's selection gives exactly ``jax.lax.top_k``'s
    ids and scores."""
    import jax

    rng = np.random.default_rng(seed)
    levels = np.array([-np.inf, -3.5, -2.0, -2.0 + 1e-6, -1.25, 0.0], np.float32)
    scores = levels[rng.integers(0, len(levels), 40)]
    scores[rng.integers(0, 40, 3)] = -np.inf
    want_s, want_i = jax.lax.top_k(jnp.asarray(scores), k)
    got_s, got_i = tseq.top_k_lower_index_first(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_served_ties_are_the_jax_ids(jax_model):
    """Every item's embedding row duplicated into its odd neighbour: the
    served scores tie in pairs, and the port serves exactly the JAX
    package's items in its order."""
    params = {**jax_model.params, "embed": np.asarray(jax_model.params["embed"]).copy()}
    params["embed"][1:-1:2] = params["embed"][0:-2:2]
    model_t = tseq.seqrec_model_from_numpy(
        params, jax_model.item_map.to_dict(), jax_model.user_recent,
        jax_model.seq_len, jax_model.n_heads)
    model_j = dataclasses.replace(jax_model, params=_jax_tree(params))
    talgo = tseq.SeqRecAlgorithm(tseq.SeqRecAlgorithmParams(**SMALL), device="cpu")
    jalgo = jseq.SeqRecAlgorithm(jseq.SeqRecAlgorithmParams(**SMALL))
    for user in ("u0", "u3", "solo"):
        got = talgo.predict(model_t, tseq.Query(user=user, num=8)).item_scores
        want = jalgo.predict(model_j, jseq.Query(user=user, num=8)).item_scores
        assert [s.item for s in got] == [s.item for s in want]
        _same_or_tied(got, want)


def test_weight_carry_round_trips_a_jax_model(jax_model, carried):
    for (name, a), (_, b) in zip(tseq._leaves(carried.params), tseq._leaves(jax_model.params)):
        assert np.array_equal(a, np.asarray(b)), name
    assert carried.item_map.to_dict() == jax_model.item_map.to_dict()
    assert carried.user_recent == jax_model.user_recent
    assert (carried.seq_len, carried.n_heads) == (jax_model.seq_len, jax_model.n_heads)
    assert tseq.seqrec_model_from_numpy(
        carried.params, list(jax_model.item_map.to_dict()), carried.user_recent,
        carried.seq_len, carried.n_heads).item_map == carried.item_map
    with pytest.raises(ValueError, match="n_heads"):
        tseq.seqrec_model_from_numpy(carried.params, jax_model.item_map.to_dict(), {}, 8, 3)
    with pytest.raises(ValueError, match="rows"):
        tseq.seqrec_model_from_numpy(carried.params, ["i0"], {}, 8, 2)
    with pytest.raises(ValueError, match="positions"):
        tseq.seqrec_model_from_numpy(carried.params, jax_model.item_map.to_dict(), {}, 64, 2)
    bad = {**carried.params, "layers": [dict(carried.params["layers"][0], qkv=np.zeros((16, 16)))]}
    with pytest.raises(ValueError, match="qkv"):
        tseq.seqrec_model_from_numpy(bad, jax_model.item_map.to_dict(), {}, 8, 2)


def test_sanity_check_and_the_blob_without_its_device_copy(carried):
    model = tseq.seqrec_model_from_numpy(
        carried.params, carried.item_map.to_dict(), carried.user_recent,
        carried.seq_len, carried.n_heads)
    model.sanity_check()
    algo = tseq.SeqRecAlgorithm(tseq.SeqRecAlgorithmParams(**SMALL))
    algo.prepare_serving(model, WorkflowContext(device="cpu"))
    assert algo.device == CPU and "_device_module" in model.__dict__
    clone = pickle.loads(pickle.dumps(model))
    assert "_device_module" not in clone.__dict__
    assert all(isinstance(a, np.ndarray) for _, a in tseq._leaves(clone.params))
    broken = dict(model.params, pos=model.params["pos"].copy())
    broken["pos"][0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        dataclasses.replace(model, params=broken).sanity_check()


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/queries.json", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_run_train_then_the_query_server_answers_like_predict(tmp_path):
    users, seqs = _histories()
    training = tseq.TrainingData(user_ids=users, sequences=seqs)

    class HistoriesSource(DataSource):
        def read_training(self, ctx):
            return training

    engine = Engine({"": HistoriesSource}, {"": tseq.SeqPreparator},
                    {"transformer": tseq.SeqRecAlgorithm}, {"": FirstServing})
    params = tseq.SeqRecAlgorithmParams(**SMALL)
    ep = EngineParams(preparator_params=("", tseq.SeqPreparatorParams(seq_len=8)),
                      algorithm_params_list=[("transformer", params)])
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    instance_id = run_train(engine, ep, registry, ctx=WorkflowContext(device="cpu"))
    assert registry.get_metadata().engine_instance_get(instance_id).status == STATUS_COMPLETED
    (model,) = load_models(registry, instance_id)
    direct = tseq.SeqRecAlgorithm(params, device="cpu")
    server = create_query_server(
        tseq.engine_factory(), ServerConfig(ip="127.0.0.1", port=0, device="cpu"),
        registry=registry, block=False)
    try:
        for q in QUERIES:
            body = {k: list(v) if isinstance(v, tuple) else v for k, v in q.items()}
            status, data = _post(server.bound_port, body)
            assert status == 200
            want = direct.predict(model, tseq.Query(**body)).to_json_dict()
            assert data == want
    finally:
        server.shutdown()
        server.server_close()
    # a blob pickled by the JAX package is refused, never unpickled
    jax_pd, _ = _prepared()
    jmodel = jseq.SeqRecAlgorithm(jseq.SeqRecAlgorithmParams(**dict(SMALL, steps=1))).train(
        None, jax_pd)
    registry.get_models().insert(Model(id="EI-jax", models=pickle.dumps([jmodel])))
    with pytest.raises(ForeignModelError, match="seqrec_model_from_numpy"):
        load_models(registry, "EI-jax")
    persisted = persist_instance(registry, ep, [model])
    assert load_models(registry, persisted)[0].item_map == model.item_map


# -- head widths that are not a multiple of 8 (d_model / n_heads = 6, 15) ---------
@pytest.mark.parametrize("d_model,n_heads", [(24, 4), (60, 4)])
def test_odd_head_widths_train_and_serve_like_jax(d_model, n_heads, tmp_path):
    """Seqrec at D = 6 and 15: three steps through ``run_train`` against
    the JAX template's training (the training tolerances), then the
    instance served over HTTP against the JAX template's ``predict`` on
    the port's trained weights (the forward tolerances)."""
    _train_and_serve_like_jax(d_model, n_heads, tmp_path)


# -- heads wider than 128 (the kernel's wide-head path on the card) -------------
@pytest.mark.parametrize("d_model,n_heads", [(256, 1), (272, 2)])
def test_wide_head_widths_train_and_serve_like_jax(d_model, n_heads, tmp_path):
    """Seqrec at D = 256 and 136, as at the odd widths: trained through
    ``run_train`` and served over HTTP against the JAX template."""
    _train_and_serve_like_jax(d_model, n_heads, tmp_path)


def _train_and_serve_like_jax(d_model, n_heads, tmp_path):
    users, seqs = _histories()
    training = tseq.TrainingData(user_ids=users, sequences=seqs)

    class HistoriesSource(DataSource):
        def read_training(self, ctx):
            return training

    small = dict(SMALL, d_model=d_model, n_heads=n_heads)
    pd_j, pd_t = _prepared()
    want = jseq.SeqRecAlgorithm(jseq.SeqRecAlgorithmParams(**small)).train(None, pd_j)
    engine = Engine({"": HistoriesSource}, {"": tseq.SeqPreparator},
                    {"transformer": tseq.SeqRecAlgorithm}, {"": FirstServing})
    params = tseq.SeqRecAlgorithmParams(**small)
    ep = EngineParams(preparator_params=("", tseq.SeqPreparatorParams(seq_len=8, window_stride=4)),
                      algorithm_params_list=[("transformer", params)])
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    instance_id = run_train(engine, ep, registry, ctx=WorkflowContext(device="cpu"))
    (got,) = load_models(registry, instance_id)
    for key in ("embed", "pos"):
        np.testing.assert_allclose(got.params[key], np.asarray(want.params[key]),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    batch = pd_t.windows[:6, :-1]
    logits_j = np.asarray(jseq.forward(want.params, jnp.asarray(batch), n_heads))
    logits_t = tseq.forward(_torch_tree(got.params), torch.from_numpy(batch), n_heads)
    np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    jax_on_ours = dataclasses.replace(want, params=_jax_tree(got.params))
    jalgo = jseq.SeqRecAlgorithm(jseq.SeqRecAlgorithmParams(**small))
    server = create_query_server(
        tseq.engine_factory(), ServerConfig(ip="127.0.0.1", port=0, device="cpu"),
        registry=registry, block=False)
    try:
        for q in QUERIES:
            body = {k: list(v) if isinstance(v, tuple) else v for k, v in q.items()}
            status, data = _post(server.bound_port, body)
            assert status == 200
            served = tseq.PredictedResult(item_scores=tuple(
                tseq.ItemScore(**x) for x in data["itemScores"]))
            jq = jseq.Query(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in body.items()})
            _same_or_tied(served.item_scores, jalgo.predict(jax_on_ours, jq).item_scores)
    finally:
        server.shutdown()
        server.server_close()
