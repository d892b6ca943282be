"""The similar-product template of the port held to the JAX package's on
the CPU (the cases of ``tests/test_templates.py::TestSimilarProductTemplate``).

The same seeded events — ``$set`` users and items with categories, views,
likes and dislikes, a pair liked and later disliked — are written into
both packages' SQLite stores, and each package's process-wide registry
points at its own. Training starts from the JAX ``init_factors`` table
(the port's ``init_factors`` is replaced by it, since a
``torch.Generator`` cannot reproduce ``jax.random``): 3 iterations of
``als`` (view counts) and ``likealgo`` (like 1, dislike -1) hold the
item factors to rtol 2e-3 / atol 2e-4. Serving starts from the JAX
model's own tables, carried across with ``similar_model_from_numpy``:
ids equal outside exact ties and |Δscore| <= 1e-5, for single and
batched queries, unknown items, the category, white-list and black-list
filters, and the streaming leg against the dense one; the ensemble's
z-score sum (and its zero-std case) is held to the JAX serving on the
same predictions; the query server serves an instance of carried tables
like the JAX engine. The new ``ops/scoring.py`` entries are held to JAX
``top_k_for_vectors``, ``top_k_similar_items_fused`` and ``standardize``.
"""

import datetime as dt
import http.client
import json

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import EngineParams as JaxEngineParams
from predictionio_tpu.models import similarproduct as jsp
from predictionio_tpu.ops import scoring as jax_scoring
from predictionio_tpu.ops.als import init_factors as jax_init_factors
from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.storage import StorageRegistry as JaxStorageRegistry
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.workflow.context import WorkflowContext as JaxWorkflowContext
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models import similarproduct as sp
from predictionio_tpu_torch.ops import als, scoring
from predictionio_tpu_torch.storage import STATUS_COMPLETED, Event, StorageRegistry
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.workflow import (
    ServerConfig,
    WorkflowContext,
    create_query_server,
    load_models,
    persist_instance,
    run_train,
)

APP = 1
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
RTOL, ATOL = 2e-3, 2e-4  # factors after 3 iterations from one table
SCORE_ATOL = 1e-5  # served scores from shared tables
ITERS = 3
PARAMS = {"als": dict(rank=8, num_iterations=ITERS, seed=1),
          "likealgo": dict(rank=8, num_iterations=ITERS, seed=2)}
QUERIES = [
    dict(items=("a0",), num=3),
    dict(items=("nope",), num=3),
    dict(items=("b0", "b1"), num=4, black_list=("b2",)),
    dict(items=("a0",), num=10, categories=("beta",)),
    dict(items=("a0", "x0"), num=10, categories=("alpha", "beta")),
    dict(items=("a1",), num=10, black_list=("a2", "a3", "nope")),
    dict(items=("a1",), num=5, white_list=("a2", "b3", "x1", "nope")),
    dict(items=("b4",), num=6, white_list=("a2", "b3", "b5"), black_list=("b3",)),
    dict(items=("x1", "a5"), num=1),
    dict(items=("a0",), num=50),
]


def _events():
    """Two item clusters (alpha a*, beta b*), ``x0`` in both, ``x1`` in
    none; users view within their cluster, like what they view, dislike
    one item of the other cluster, and u0 likes a0 then dislikes it."""
    rng = np.random.default_rng(3)
    items = {**{f"a{i}": ["alpha"] for i in range(6)},
             **{f"b{i}": ["beta"] for i in range(6)},
             "x0": ["alpha", "beta"], "x1": []}
    out = [dict(event="$set", entity_type="item", entity_id=it,
                properties={"categories": cats}, minute=0)
           for it, cats in items.items()]
    minute = 1
    for u in range(24):
        uid = f"u{u}"
        out.append(dict(event="$set", entity_type="user", entity_id=uid, minute=0))
        mine, other = ("a", "b") if u % 2 == 0 else ("b", "a")
        pool = [f"{mine}{i}" for i in range(6)] + ["x0"]
        for it in rng.choice(pool, size=5, replace=False):
            for _ in range(int(rng.integers(2, 5))):
                out.append(dict(event="view", entity_type="user", entity_id=uid,
                                target=str(it), minute=minute))
            out.append(dict(event="like", entity_type="user", entity_id=uid,
                            target=str(it), minute=minute))
            minute += 1
        out.append(dict(event="dislike", entity_type="user", entity_id=uid,
                        target=f"{other}{int(rng.integers(0, 6))}", minute=minute))
        out.append(dict(event="view", entity_type="user", entity_id=uid,
                        target="x1", minute=minute))
        minute += 1
    out.append(dict(event="like", entity_type="user", entity_id="u0", target="a0",
                    minute=minute + 1))
    out.append(dict(event="dislike", entity_type="user", entity_id="u0", target="a0",
                    minute=minute + 2))
    return out


def _write(store, cls, events):
    store.init(APP)
    store.write([cls(event=e["event"], entity_type=e["entity_type"],
                     entity_id=e["entity_id"],
                     target_entity_type="item" if "target" in e else None,
                     target_entity_id=e.get("target"),
                     properties=e.get("properties", {}),
                     event_time=T0 + dt.timedelta(minutes=e["minute"]))
                 for e in events], APP)


@pytest.fixture()
def registries(tmp_path, monkeypatch):
    """Both packages' process-wide registries over SQLite stores holding
    the same events; the port's ``init_factors`` is the JAX table."""
    events = _events()
    port = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "port")})
    jax = JaxStorageRegistry(env={"PIO_FS_BASEDIR": str(tmp_path / "jax")})
    _write(port.get_events(), Event, events)
    _write(jax.get_events(), JaxEvent, events)
    monkeypatch.setattr(port_registry, "_default_registry", port)
    monkeypatch.setattr(jax_registry, "_default_registry", jax)
    monkeypatch.setattr(als, "init_factors", lambda n, rank, seed, device: (
        torch.from_numpy(np.array(jax_init_factors(n, rank, seed))).to(device)))
    return port, jax


@pytest.fixture()
def jax_models(registries):
    engine = jsp.engine_factory()
    ep = _jax_engine_params()
    return engine, ep, engine.train(JaxWorkflowContext(mode="Test"), ep)


def _jax_engine_params():
    return JaxEngineParams(
        data_source_params=("", jsp.SimilarProductDataSourceParams(app_id=APP)),
        algorithm_params_list=[(n, jsp.SimilarALSParams(**p)) for n, p in PARAMS.items()])


def _port_engine_params():
    return EngineParams(
        data_source_params=("", sp.SimilarProductDataSourceParams(app_id=APP)),
        algorithm_params_list=[(n, sp.SimilarALSParams(**p)) for n, p in PARAMS.items()])


def _carry(jax_model):
    return sp.similar_model_from_numpy(jax_model.item_factors,
                                       jax_model.item_map.to_dict(), jax_model.items)


def assert_same_answer(got, want):
    """``got`` (port items and scores) against ``want`` (JAX): same
    length, |Δscore| <= 1e-5, ids equal where the JAX scores do not tie."""
    got_items = [s.item for s in got]
    want_items = [s.item for s in want]
    gs = np.array([s.score for s in got], np.float64)
    ws = np.array([s.score for s in want], np.float64)
    assert len(got_items) == len(want_items), (got_items, want_items)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_ATOL)
    for j, (g, w) in enumerate(zip(got_items, want_items)):
        if g != w:
            tied = np.abs(ws - ws[j]) <= SCORE_ATOL
            assert g in [want_items[t] for t in np.flatnonzero(tied)], (j, got_items, want_items)


def test_the_data_source_reads_what_the_jax_one_reads(registries):
    got = sp.SimilarProductDataSource(sp.SimilarProductDataSourceParams(app_id=APP)
                                      ).read_training(None)
    want = jsp.SimilarProductDataSource(jsp.SimilarProductDataSourceParams(app_id=APP)
                                        ).read_training(None)
    assert list(got.users) == list(want.users)
    assert {k: v.categories for k, v in got.items.items()} == {
        k: v.categories for k, v in want.items.items()}
    assert [(v.user, v.item, v.t) for v in got.view_events] == [
        (v.user, v.item, v.t) for v in want.view_events]
    assert [(v.user, v.item, v.t, v.like) for v in got.like_events] == [
        (v.user, v.item, v.t, v.like) for v in want.like_events]
    assert not all(v.like for v in got.like_events)  # dislikes are in


@pytest.mark.parametrize("name,index", [("als", 0), ("likealgo", 1)])
def test_run_train_matches_the_jax_engine(name, index, registries, jax_models):
    port, _ = registries
    _, _, want = jax_models
    instance_id = run_train(sp.engine_factory(), _port_engine_params(), port,
                            ctx=WorkflowContext(device="cpu"))
    inst = port.get_metadata().engine_instance_get(instance_id)
    assert inst.status == STATUS_COMPLETED
    models = load_models(port, instance_id)
    got, ref = models[index], want[index]
    assert isinstance(got, sp.SimilarALSModel)
    np.testing.assert_allclose(got.item_factors, ref.item_factors, rtol=RTOL, atol=ATOL)
    assert got.item_map.to_dict() == ref.item_map.to_dict()
    assert {i: v.categories for i, v in got.items.items()} == {
        i: v.categories for i, v in ref.items.items()}


def test_like_ratings_keep_the_latest_event_and_dislikes_are_negative(registries):
    td = sp.SimilarProductDataSource(sp.SimilarProductDataSourceParams(app_id=APP)
                                     ).read_training(None)
    got = dict(((u, i), r) for u, i, r in sp.LikeAlgorithm()._ratings(td))
    want = dict(((u, i), r) for u, i, r in jsp.LikeAlgorithm()._ratings(
        jsp.SimilarProductDataSource(jsp.SimilarProductDataSourceParams(app_id=APP))
        .read_training(None)))
    assert got == want and got[("u0", "a0")] == -1.0
    assert sorted(set(got.values())) == [-1.0, 1.0]


@pytest.mark.parametrize("mode", ["auto", "always"])
@pytest.mark.parametrize("index", [0, 1])
def test_batch_predict_from_carried_tables_matches_jax(mode, index, jax_models):
    engine, ep, models = jax_models
    jax_algo = engine._algorithms(ep)[index]
    algo = sp.SimilarALSAlgorithm(sp.SimilarALSParams(**PARAMS["als"], streaming_top_k=mode),
                                  device="cpu")
    model = _carry(models[index])
    queries = [(i, sp.Query(**q)) for i, q in enumerate(QUERIES)]
    jax_queries = [(i, jsp.Query(**q)) for i, q in enumerate(QUERIES)]
    got = dict(algo.batch_predict(model, queries))
    want = dict(jax_algo.batch_predict(models[index], jax_queries))
    assert algo.topk_path == ("streaming" if mode == "always" else "dense")
    for i, _ in queries:
        assert_same_answer(got[i].item_scores, want[i].item_scores)
        # one query alone answers as it does in the batch
        single = algo.predict(model, queries[i][1])
        assert_same_answer(single.item_scores, want[i].item_scores)
    assert got[1].item_scores == ()
    assert all(s.item.startswith("b") or s.item == "x0" for s in got[3].item_scores)
    assert {s.item for s in got[6].item_scores} <= {"a2", "b3", "x1"}
    assert not {"a2", "a3"} & {s.item for s in got[5].item_scores}


def test_constrained_rows_exclude_exactly_the_candidate_mask(jax_models):
    _, _, models = jax_models
    model = _carry(models[0])
    for q in QUERIES:
        query = sp.Query(**q)
        qi = [model.item_map[i] for i in query.items if i in model.item_map]
        want = np.flatnonzero(jsp._candidate_mask(models[0], jsp.Query(**q), qi))
        got = sorted(set(map(int, sp._exclusions(model, query, qi))))
        assert got == want.tolist()


def test_ensemble_serving_matches_the_jax_serving(jax_models):
    engine, ep, models = jax_models
    port_algos = [sp.SimilarALSAlgorithm(device="cpu"), sp.LikeAlgorithm(device="cpu")]
    jax_algos = engine._algorithms(ep)
    for q in QUERIES:
        preds = [a.predict(_carry(m), sp.Query(**q)) for a, m in zip(port_algos, models)]
        jax_preds = [a.predict(m, jsp.Query(**q)) for a, m in zip(jax_algos, models)]
        got = sp.SimilarProductServing().serve(sp.Query(**q), preds)
        want = jsp.SimilarProductServing().serve(jsp.Query(**q), jax_preds)
        assert_same_answer(got.item_scores, want.item_scores)
        scores = [s.score for s in got.item_scores]
        assert scores == sorted(scores, reverse=True)


def test_serving_zero_std_returns_zero():
    pr = sp.PredictedResult(item_scores=(sp.ItemScore("x", 2.0), sp.ItemScore("y", 2.0)))
    out = sp.SimilarProductServing().serve(sp.Query(items=("q",), num=2), [pr])
    want = jsp.SimilarProductServing().serve(
        jsp.Query(items=("q",), num=2),
        [jsp.PredictedResult(item_scores=(jsp.ItemScore("x", 2.0), jsp.ItemScore("y", 2.0)))])
    assert [(s.item, s.score) for s in out.item_scores] == [
        (s.item, s.score) for s in want.item_scores]
    assert all(s.score == 0.0 for s in out.item_scores)


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/queries.json", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_the_query_server_serves_carried_tables_like_the_jax_engine(registries, jax_models):
    port, _ = registries
    engine, ep, models = jax_models
    jax_algos, jax_serving = engine._algorithms(ep), engine._serving(ep)
    instance_id = persist_instance(port, _port_engine_params(), [_carry(m) for m in models])
    server = create_query_server(
        sp.engine_factory(), ServerConfig(ip="127.0.0.1", port=0, device="cpu",
                                          engine_instance_id=instance_id),
        registry=port, block=False)
    try:
        for q in QUERIES:
            status, data = _post(server.bound_port, {**q, "items": list(q["items"])})
            assert status == 200
            preds = [a.predict(m, jsp.Query(**q)) for a, m in zip(jax_algos, models)]
            want = jax_serving.serve(jsp.Query(**q), preds)
            got = [sp.ItemScore(x["item"], x["score"]) for x in data["itemScores"]]
            assert_same_answer(got, want.item_scores)
        status = json.loads(_get(server.bound_port, "/status.json"))
        assert set(status["topkPath"].values()) == {"dense"}
    finally:
        server.shutdown()
        server.server_close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        return conn.getresponse().read()
    finally:
        conn.close()


def test_train_without_set_entities_raises(tmp_path, monkeypatch):
    reg = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    monkeypatch.setattr(port_registry, "_default_registry", reg)
    reg.get_events().init(APP)
    reg.get_events().write([Event(event="view", entity_type="user", entity_id="u1",
                                  target_entity_type="item", target_entity_id="i1")], APP)
    td = sp.SimilarProductDataSource().read_training(None)
    with pytest.raises(ValueError, match="\\$set"):
        sp.SimilarALSAlgorithm(sp.SimilarALSParams(rank=4, num_iterations=2),
                               device="cpu").train(None, td)
    with pytest.raises(ValueError, match="streaming_top_k"):
        sp.SimilarALSAlgorithm(sp.SimilarALSParams(streaming_top_k="sometimes"),
                               device="cpu").train(None, td)


def test_a_model_carried_across_checks_its_ids():
    with pytest.raises(ValueError, match="exactly once"):
        sp.similar_model_from_numpy(np.zeros((3, 2)), ["a", "b"], {})
    model = sp.similar_model_from_numpy(np.ones((2, 2)), ["a", "b"], {0: ["c"], 1: ()})
    assert model.items[0].categories == ("c",) and model.item_factors.dtype == np.float32
    assert set(model.category_members) == {"c"}


# -- ops/scoring.py: the entries the templates need ------------------------------------
def _tables(seed, b=6, n=40, r=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, r)).astype(np.float32),
            rng.standard_normal((n, r)).astype(np.float32))


@pytest.mark.parametrize("with_mask", [False, True])
def test_top_k_for_vectors_matches_jax(with_mask):
    q, items = _tables(5)
    mask = None
    if with_mask:
        mask = np.random.default_rng(6).random((q.shape[0], items.shape[0])) < 0.6
        mask[2] = True  # a row that excludes the whole catalog
        mask[3] = False
    got_s, got_i = scoring.top_k_for_vectors(
        torch.from_numpy(q), torch.from_numpy(items), 7,
        None if mask is None else torch.from_numpy(mask))
    want_s, want_i = (np.asarray(x) for x in jax_scoring.top_k_for_vectors(q, items, 7, mask))
    got_s, got_i = got_s.numpy(), got_i.numpy()
    finite = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), finite)
    np.testing.assert_allclose(got_s[finite], want_s[finite], rtol=1e-6, atol=SCORE_ATOL)
    np.testing.assert_array_equal(got_i[finite], want_i[finite])
    assert (got_i[~finite] == -1).all()


def test_mask_to_exclusion_lists_pads_to_a_power_of_two():
    mask = torch.zeros((3, 40), dtype=torch.bool)
    mask[0, [3, 1, 39]] = True
    mask[2, :20] = True
    lists = scoring.mask_to_exclusion_lists(mask)
    assert lists.dtype == torch.int32 and lists.shape == (3, 32)
    assert lists[0, :4].tolist() == [1, 3, 39, -1] and (lists[1] == -1).all()
    assert lists[2, :20].tolist() == list(range(20)) and (lists[2, 20:] == -1).all()
    assert scoring.mask_to_exclusion_lists(torch.zeros((2, 5), dtype=torch.bool)).shape == (2, 16)
    excl = scoring.exclusion_matrix([[4, 2], [], list(range(17))], rows=4)
    assert excl.shape == (4, 32) and excl[0, :3].tolist() == [4, 2, -1]
    assert (excl[3] == -1).all()


@pytest.mark.parametrize("mode", ["auto", "always"])
@pytest.mark.parametrize("exclude_self", [True, False])
def test_top_k_similar_items_fused_matches_jax(mode, exclude_self):
    _, items = _tables(7)
    idx = np.array([0, 5, 5, 39], dtype=np.int32)
    got_s, got_i = scoring.top_k_similar_items_fused(
        torch.from_numpy(items), torch.from_numpy(idx), 9, exclude_self=exclude_self,
        mode=mode)
    want_s, want_i = (np.asarray(x) for x in jax_scoring.top_k_similar_items_fused(
        items, idx, 9, exclude_self=exclude_self))
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-6, atol=SCORE_ATOL)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    if exclude_self:
        assert not (got_i.numpy() == idx[:, None]).any()


def test_standardize_matches_jax():
    scores = np.random.default_rng(8).standard_normal(33).astype(np.float32)
    np.testing.assert_allclose(scoring.standardize(torch.from_numpy(scores)).numpy(),
                               np.asarray(jax_scoring.standardize(scores)), rtol=1e-5,
                               atol=1e-6)
    flat = np.full(4, 2.5, np.float32)
    np.testing.assert_array_equal(scoring.standardize(torch.from_numpy(flat)).numpy(),
                                  np.asarray(jax_scoring.standardize(flat)))
