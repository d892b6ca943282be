"""The e-commerce template of the port held to the JAX package's on the
CPU (the cases of ``tests/test_templates.py::TestECommerceTemplate``).

The same seeded events — ``$set`` users and items with categories, rate
events (one pair rated twice, the later rating the one that counts),
views and buys, an ``unavailableItems`` constraint — go into both
packages' SQLite stores, each package's process-wide registry pointing
at its own. Explicit ALS starts from the JAX ``init_factors`` table: 3
iterations hold both factor tables to rtol 2e-3 / atol 2e-4. Serving
starts from the JAX model's tables, carried across with
``ecommerce_model_from_numpy``: ids equal outside exact ties (the JAX
``argpartition``/``argsort`` has no tie order) and |Δscore| <= 1e-5,
for known users with and without ``unseen_only``, new users answered
from their recent views, unknown users with no views, the category,
white-list and black-list filters, and the live ``buy`` and
``unavailableItems`` events that change the next answer without a
retrain; the query server serves an instance of carried tables like the
JAX algorithm.
"""

import datetime as dt
import http.client
import json

import numpy as np
import pytest
import torch

from predictionio_tpu.models import ecommerce as jec
from predictionio_tpu.ops.als import init_factors as jax_init_factors
from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.storage import StorageRegistry as JaxStorageRegistry
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.workflow.context import WorkflowContext as JaxWorkflowContext
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models import ecommerce as ec
from predictionio_tpu_torch.ops import als
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
RTOL, ATOL = 2e-3, 2e-4
SCORE_ATOL = 1e-5
PARAMS = dict(app_id=APP, rank=8, num_iterations=3, seed=1)
N_ITEMS, N_USERS = 16, 20
QUERIES = [
    dict(user="u0", num=5),
    dict(user="u1", num=16),
    dict(user="u2", num=3, categories=["cat2"]),
    dict(user="u3", num=8, white_list=["i1", "i2", "i9", "i15", "nope"]),
    dict(user="u4", num=8, black_list=["i0", "i1", "nope"], categories=["cat1", "cat3"]),
    dict(user="u5", num=0),
    dict(user="ghost", num=6),
    dict(user="ghost", num=4, categories=["cat1"], black_list=["i3"]),
    dict(user="nobody", num=5),
    dict(user="u0", num=40),
]


def _events():
    """Items i0..i15 in cat1 (< 8) or cat2, i15 also in cat3; users like
    one half and rate the other low; u0 rates i0 1.0 then 5.0; u0 bought
    i2 and viewed i4; ghost (no $set, no ratings) viewed i0, i1, i1; the
    constraint makes i6 and i7 unavailable."""
    rng = np.random.default_rng(5)
    out = [dict(event="$set", entity_type="item", entity_id=f"i{i}",
                properties={"categories": ["cat1" if i < 8 else "cat2"]
                            + (["cat3"] if i == 15 else [])}, minute=0)
           for i in range(N_ITEMS)]
    minute = 1
    for u in range(N_USERS):
        out.append(dict(event="$set", entity_type="user", entity_id=f"u{u}", minute=0))
        likes_low = u % 2 == 0
        for i in rng.choice(N_ITEMS, size=10, replace=False):
            rating = (5.0 if (i < 8) == likes_low else 1.0) + float(rng.normal(0, 0.2))
            out.append(dict(event="rate", entity_type="user", entity_id=f"u{u}",
                            target=f"i{i}", properties={"rating": rating}, minute=minute))
            minute += 1
    out += [
        dict(event="rate", entity_type="user", entity_id="u0", target="i0",
             properties={"rating": 1.0}, minute=minute + 1),
        dict(event="rate", entity_type="user", entity_id="u0", target="i0",
             properties={"rating": 5.0}, minute=minute + 2),
        dict(event="buy", entity_type="user", entity_id="u0", target="i2", minute=minute + 3),
        dict(event="view", entity_type="user", entity_id="u0", target="i4", minute=minute + 4),
        dict(event="view", entity_type="user", entity_id="ghost", target="i0",
             minute=minute + 5),
        dict(event="view", entity_type="user", entity_id="ghost", target="i1",
             minute=minute + 6),
        dict(event="view", entity_type="user", entity_id="ghost", target="i1",
             minute=minute + 7),
        dict(event="$set", entity_type="constraint", entity_id="unavailableItems",
             properties={"items": ["i6", "i7"]}, minute=minute + 8),
    ]
    return out


def _to(cls, e):
    return cls(event=e["event"], entity_type=e["entity_type"], entity_id=e["entity_id"],
               target_entity_type="item" if "target" in e else None,
               target_entity_id=e.get("target"), properties=e.get("properties", {}),
               event_time=T0 + dt.timedelta(minutes=e["minute"]))


@pytest.fixture()
def registries(tmp_path, monkeypatch):
    events = _events()
    port = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "port")})
    jax = JaxStorageRegistry(env={"PIO_FS_BASEDIR": str(tmp_path / "jax")})
    for reg, cls in ((port, Event), (jax, JaxEvent)):
        reg.get_events().init(APP)
        reg.get_events().write([_to(cls, e) for e in events], APP)
    monkeypatch.setattr(port_registry, "_default_registry", port)
    monkeypatch.setattr(jax_registry, "_default_registry", jax)
    monkeypatch.setattr(als, "init_factors", lambda n, rank, seed, device: (
        torch.from_numpy(np.array(jax_init_factors(n, rank, seed))).to(device)))
    return port, jax


def _write_both(registries, event):
    for reg, cls in zip(registries, (Event, JaxEvent)):
        reg.get_events().insert(_to(cls, event), APP)


@pytest.fixture()
def jax_model(registries):
    td = jec.ECommerceDataSource(jec.ECommerceDataSourceParams(app_id=APP)).read_training(None)
    return jec.ECommerceALSAlgorithm(jec.ECommerceALSParams(**PARAMS)).train(
        JaxWorkflowContext(mode="Test"), td)


def _carry(m):
    return ec.ecommerce_model_from_numpy(m.user_factors, m.item_factors, m.user_map.to_dict(),
                                         m.item_map.to_dict(), m.items, m.rank)


def assert_same_answer(got, want):
    """Same length, |Δscore| <= 1e-5, ids equal where the JAX scores do
    not tie."""
    got_items = [s.item for s in got]
    want_items = [s.item for s in want]
    ws = np.array([s.score for s in want], np.float64)
    assert len(got_items) == len(want_items), (got_items, want_items)
    np.testing.assert_allclose([s.score for s in got], ws, rtol=0, atol=SCORE_ATOL)
    for j, (g, w) in enumerate(zip(got_items, want_items)):
        if g != w:
            tied = np.abs(ws - ws[j]) <= SCORE_ATOL
            assert g in [want_items[t] for t in np.flatnonzero(tied)], (j, got_items, want_items)


def test_the_data_source_reads_what_the_jax_one_reads(registries):
    got = ec.ECommerceDataSource(ec.ECommerceDataSourceParams(app_id=APP)).read_training(None)
    want = jec.ECommerceDataSource(jec.ECommerceDataSourceParams(app_id=APP)).read_training(None)
    assert list(got.users) == list(want.users)
    assert {k: v.categories for k, v in got.items.items()} == {
        k: v.categories for k, v in want.items.items()}
    assert [(r.user, r.item, r.rating, r.t) for r in got.rate_events] == [
        (r.user, r.item, r.rating, r.t) for r in want.rate_events]


def test_run_train_matches_the_jax_algorithm_and_the_latest_rating_wins(registries, jax_model):
    port, _ = registries
    ep = EngineParams(data_source_params=("", ec.ECommerceDataSourceParams(app_id=APP)),
                      algorithm_params_list=[("als", ec.ECommerceALSParams(**PARAMS))])
    instance_id = run_train(ec.engine_factory(), ep, port, ctx=WorkflowContext(device="cpu"))
    assert port.get_metadata().engine_instance_get(instance_id).status == STATUS_COMPLETED
    (model,) = load_models(port, instance_id)
    np.testing.assert_allclose(model.user_factors, jax_model.user_factors, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(model.item_factors, jax_model.item_factors, rtol=RTOL, atol=ATOL)
    assert model.user_map.to_dict() == jax_model.user_map.to_dict()
    assert model.item_map.to_dict() == jax_model.item_map.to_dict()
    # the first rating of (u0, i0) would give other factors: 1.0 lost to 5.0
    td = ec.ECommerceDataSource(ec.ECommerceDataSourceParams(app_id=APP)).read_training(None)
    u0_i0 = [r.rating for r in td.rate_events if (r.user, r.item) == ("u0", "i0")]
    assert u0_i0[-2:] == [1.0, 5.0]
    td.rate_events = [r for r in td.rate_events
                      if not ((r.user, r.item) == ("u0", "i0") and r.rating == 5.0)]
    other = ec.ECommerceALSAlgorithm(ec.ECommerceALSParams(**PARAMS), device="cpu").train(None, td)
    assert not np.allclose(other.user_factors[0], model.user_factors[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("unseen_only", [True, False])
def test_predict_from_carried_tables_matches_jax(unseen_only, registries, jax_model):
    params = dict(PARAMS, unseen_only=unseen_only)
    algo = ec.ECommerceALSAlgorithm(ec.ECommerceALSParams(**params), device="cpu")
    jax_algo = jec.ECommerceALSAlgorithm(jec.ECommerceALSParams(**params))
    model = _carry(jax_model)

    def check():
        got = dict(algo.batch_predict(model, [(i, ec.Query(**q)) for i, q in enumerate(QUERIES)]))
        for i, q in enumerate(QUERIES):
            want = jax_algo.predict(jax_model, jec.Query(**q))
            assert_same_answer(got[i].item_scores, want.item_scores)
            assert_same_answer(algo.predict(model, ec.Query(**q)).item_scores, want.item_scores)
        return got

    got = check()
    assert algo.topk_path == "dense"
    assert got[8].item_scores == () and got[5].item_scores == ()
    assert got[6].item_scores  # a new user answered from recent views
    served = {s.item for r in got.values() for s in r.item_scores}
    assert not {"i6", "i7"} & served
    assert ("i2" in {s.item for s in got[9].item_scores}) != unseen_only
    assert {s.item for s in got[2].item_scores} <= {f"i{i}" for i in range(8, 16)}
    assert {s.item for s in got[3].item_scores} <= {"i1", "i2", "i9", "i15"}
    assert all(s.score > 0 for r in got.values() for s in r.item_scores)
    # live events change the next answer, with no retrain
    top = got[1].item_scores[0].item
    _write_both(registries, dict(event="buy", entity_type="user", entity_id="u1", target=top,
                                 minute=10_000))
    _write_both(registries, dict(event="$set", entity_type="constraint",
                                 entity_id="unavailableItems", properties={"items": ["i0"]},
                                 minute=10_001))
    got = check()
    served = {s.item for s in got[1].item_scores}
    assert ("i0" not in served) and ((top in served) != unseen_only)
    assert {"i6", "i7"} & {s.item for r in got.values() for s in r.item_scores}


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/queries.json", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_the_query_server_serves_carried_tables_like_jax(registries, jax_model):
    port, _ = registries
    ep = EngineParams(data_source_params=("", ec.ECommerceDataSourceParams(app_id=APP)),
                      algorithm_params_list=[("als", ec.ECommerceALSParams(**PARAMS))])
    instance_id = persist_instance(port, ep, [_carry(jax_model)])
    jax_algo = jec.ECommerceALSAlgorithm(jec.ECommerceALSParams(**PARAMS))
    server = create_query_server(
        ec.engine_factory(), ServerConfig(ip="127.0.0.1", port=0, device="cpu",
                                          engine_instance_id=instance_id),
        registry=port, block=False)
    try:
        for q in QUERIES:
            status, data = _post(server.bound_port, q)
            assert status == 200
            got = [ec.ItemScore(x["item"], x["score"]) for x in data["itemScores"]]
            assert_same_answer(got, jax_algo.predict(jax_model, jec.Query(**q)).item_scores)
    finally:
        server.shutdown()
        server.server_close()


def test_a_model_carried_across_checks_its_shapes():
    with pytest.raises(ValueError, match=r"\[n, 4\]"):
        ec.ecommerce_model_from_numpy(np.zeros((2, 3)), np.zeros((2, 4)), ["a", "b"],
                                      ["x", "y"], {}, 4)
    with pytest.raises(ValueError, match="exactly once"):
        ec.ecommerce_model_from_numpy(np.zeros((2, 4)), np.zeros((2, 4)), ["a"],
                                      ["x", "y"], {}, 4)
