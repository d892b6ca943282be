"""The serving slice as a whole: JAX-trained weights served by the port.

A JAX ``ALSModel`` built from seeded numpy (rank 8, 300 users, 1,000
items) crosses over as arrays (``als_model_from_numpy``); the port's
``batch_predict`` on ``device="cpu"`` must answer what the JAX
``batch_predict`` answers, and so must the port's query server, booted on
the CPU from a temporary ``PIO_FS_BASEDIR``, over HTTP. Tolerance: scores
rtol 1e-5 / atol 1e-5; items equal or tied.
"""

import dataclasses
import http.client
import json
import pickle
import time

import numpy as np
import pytest

from predictionio_tpu.models.recommendation import (
    ALSAlgorithm as JaxALSAlgorithm,
    ALSAlgorithmParams as JaxParams,
    ALSModel as JaxALSModel,
    Query as JaxQuery,
)
from predictionio_tpu.controller.params import (
    extract_params as jax_extract_params,
    params_to_json as jax_params_to_json,
)
from predictionio_tpu.storage import BiMap as JaxBiMap
from predictionio_tpu_torch.controller import (
    EngineParams,
    extract_params,
    params_to_json,
)
from predictionio_tpu_torch.models.recommendation import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    Query,
    RecDataSource,
    RecDataSourceParams,
    als_model_from_numpy,
    engine_factory,
)
from predictionio_tpu_torch.storage import Model, StorageRegistry
from predictionio_tpu_torch.workflow import (
    ForeignModelError,
    ServerConfig,
    create_query_server,
    load_models,
    persist_instance,
)

RTOL = ATOL = 1e-5
RANK, N_USERS, N_ITEMS = 8, 300, 1000

#: (user, num): known users, an unknown user, num past the catalog
QUERIES = [("u0", 10), ("u17", 1), ("ghost", 5), ("u299", 37), ("u17", 10),
           ("u42", 1200), ("u100", 3)]


def _jax_model(seed: int) -> JaxALSModel:
    rng = np.random.default_rng(seed)
    return JaxALSModel(
        rank=RANK,
        user_factors=rng.normal(size=(N_USERS, RANK)).astype(np.float32),
        item_factors=rng.normal(size=(N_ITEMS, RANK)).astype(np.float32),
        user_map=JaxBiMap({f"u{i}": i for i in range(N_USERS)}),
        item_map=JaxBiMap({f"i{i}": i for i in range(N_ITEMS)}),
    )


def _carry(jm: JaxALSModel):
    return als_model_from_numpy(
        jm.rank, jm.user_factors, jm.item_factors,
        jm.user_map.to_dict(), jm.item_map.to_dict(),
    )


def _jax_answers(jm: JaxALSModel) -> dict:
    algo = JaxALSAlgorithm(JaxParams(rank=RANK))
    out = dict(algo.batch_predict(
        jm, [(i, JaxQuery(user=u, num=n)) for i, (u, n) in enumerate(QUERIES)]
    ))
    return {
        i: [{"item": s.item, "score": s.score} for s in r.item_scores]
        for i, r in out.items()
    }


def assert_same_answer(got, want):
    assert len(got) == len(want)
    if not want:
        return
    gs = np.array([x["score"] for x in got], dtype=np.float32)
    ws = np.array([x["score"] for x in want], dtype=np.float32)
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
    tied = np.isclose(gs, ws, rtol=RTOL, atol=ATOL)
    same = np.array([g["item"] == w["item"] for g, w in zip(got, want)])
    assert (same | tied).all()


@pytest.fixture(scope="module")
def jax_model():
    return _jax_model(seed=21)


@pytest.fixture(scope="module")
def jax_answers(jax_model):
    return _jax_answers(jax_model)


@pytest.mark.parametrize("mode", ["auto", "always", "never"])
def test_batch_predict_matches_jax(jax_model, jax_answers, mode):
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=RANK, streaming_top_k=mode),
                        device="cpu")
    got = dict(algo.batch_predict(
        _carry(jax_model),
        [(i, Query(user=u, num=n)) for i, (u, n) in enumerate(QUERIES)],
    ))
    assert sorted(got) == sorted(jax_answers)
    for i, want in jax_answers.items():
        assert_same_answer(
            [{"item": s.item, "score": s.score} for s in got[i].item_scores], want
        )
    assert len(got[5].item_scores) == N_ITEMS  # num past the catalog clamps
    assert got[2].item_scores == ()  # unknown user
    assert algo.topk_path == ("streaming" if mode == "always" else "dense")


def test_weight_carry_keeps_the_arrays_and_maps(jax_model):
    model = _carry(jax_model)
    np.testing.assert_array_equal(model.user_factors, jax_model.user_factors)
    np.testing.assert_array_equal(model.item_factors, jax_model.item_factors)
    assert model.user_map.to_dict() == jax_model.user_map.to_dict()
    in_order = als_model_from_numpy(
        RANK, jax_model.user_factors, jax_model.item_factors,
        [f"u{i}" for i in range(N_USERS)], [f"i{i}" for i in range(N_ITEMS)],
    )
    assert in_order.item_map.to_dict() == model.item_map.to_dict()
    with pytest.raises(ValueError):
        als_model_from_numpy(RANK, jax_model.user_factors,
                             jax_model.item_factors, ["only-one"], [])


def test_algorithm_params_keep_the_jax_fields():
    """Stored engine params written by either package parse in both."""
    def shape(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert shape(ALSAlgorithmParams) == shape(JaxParams)
    params = {"rank": 50, "streaming_top_k": "always", "shards": 2}
    assert params_to_json(extract_params(ALSAlgorithmParams, params)) == \
        jax_params_to_json(jax_extract_params(JaxParams, params))


def test_training_and_quantized_serving_are_refused(jax_model):
    """Training runs in the port now (tests/test_torch_train.py), from the
    event store too (tests/test_torch_infeed.py); what is still refused is
    an event name the template has no rule for, before any read, and the
    unported levers."""
    with pytest.raises(ValueError, match="Unsupported event 'like'"):
        RecDataSource(RecDataSourceParams(event_names=("like",))).read_training(None)
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=RANK, shards=2), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        algo.train(None, None)
    quant = ALSAlgorithm(
        ALSAlgorithmParams(rank=RANK, quantized_serving=True), device="cpu"
    )
    with pytest.raises(NotImplementedError, match="quantized_serving"):
        quant.predict(_carry(jax_model), Query(user="u1", num=3))


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        payload = None if body is None else json.dumps(body)
        conn.request(method, path, payload, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        ctype = resp.getheader("Content-Type", "")
        parsed = json.loads(data) if ctype.startswith("application/json") else data.decode()
        return resp.status, parsed, dict(resp.getheaders())
    finally:
        conn.close()


@pytest.fixture()
def served(tmp_path, jax_model):
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    ep = EngineParams(algorithm_params_list=[
        ("als", ALSAlgorithmParams(rank=RANK, streaming_top_k="always"))
    ])
    first = persist_instance(registry, ep, [_carry(jax_model)])
    server = create_query_server(
        engine_factory(),
        ServerConfig(ip="127.0.0.1", port=0, device="cpu", max_queue=4),
        registry=registry,
        block=False,
    )
    try:
        yield server, registry, ep, first
    finally:
        server.shutdown()
        server.server_close()


def test_query_server_answers_like_jax(served, jax_answers):
    server, _, _, first = served
    port = server.bound_port
    for i, (user, num) in enumerate(QUERIES):
        status, data, _ = _request(port, "POST", "/queries.json",
                                   {"user": user, "num": num})
        assert status == 200
        assert_same_answer(data["itemScores"], jax_answers[i])
    status, data, _ = _request(port, "GET", "/status.json")
    assert status == 200
    assert data["engineInstance"] == first
    assert data["device"] == "cpu"
    assert data["topkPath"] == {"0:ALSAlgorithm": "streaming"}
    assert data["stats"]["requests"] == len(QUERIES)
    assert data["topkKernelLaunches"] == 0  # CPU tensors: the plain version
    status, data, _ = _request(port, "POST", "/queries.json", {"num": 3})
    assert status == 400


def test_reload_swaps_to_the_latest_instance(served):
    server, registry, ep, first = served
    port = server.bound_port
    newer = _jax_model(seed=22)
    second = persist_instance(registry, ep, [_carry(newer)])
    assert _request(port, "POST", "/reload")[0] == 200
    assert _request(port, "GET", "/status.json")[1]["engineInstance"] == second
    _, data, _ = _request(port, "POST", "/queries.json", {"user": "u0", "num": 4})
    want = _jax_answers(newer)[0][:4]
    assert_same_answer(data["itemScores"], want)
    # the deprecated GET spelling reloads too
    assert _request(port, "GET", "/reload")[0] == 200


def test_admission_sheds_past_max_queue(served):
    server, _, _, _ = served
    port = server.bound_port
    held = [server.admit() for _ in range(4)]  # fill the 4 in-flight slots
    assert all(held)
    try:
        status, data, headers = _request(port, "POST", "/queries.json",
                                         {"user": "u0", "num": 2})
        assert status == 503
        assert int(headers["Retry-After"]) >= 1
    finally:
        for _ in held:
            server.release()
    assert _request(port, "POST", "/queries.json", {"user": "u0", "num": 2})[0] == 200
    _, metrics, _ = _request(port, "GET", "/metrics")
    assert 'pio_serving_events_total{kind="shed"} 1' in metrics
    assert 'pio_http_responses_total{status="503"} 1' in metrics
    assert "pio_topk_kernel_launches 0" in metrics


def test_a_failing_query_fails_alone_and_stop_shuts_down(served, jax_answers):
    server, _, _, _ = served
    port = server.bound_port
    status, data, _ = _request(port, "POST", "/queries.json",
                               {"user": "u0", "num": "ten"})
    assert status == 500 and "message" in data
    status, data, _ = _request(port, "POST", "/queries.json",
                               {"user": "u0", "num": 10})
    assert status == 200
    assert_same_answer(data["itemScores"], jax_answers[0])
    assert _request(port, "GET", "/stop")[0] == 200
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            _request(port, "GET", "/status.json")
        except OSError:
            break  # the listening socket is closed
        time.sleep(0.05)
    else:
        pytest.fail("server still answering 10 s after /stop")


def test_blob_pickled_by_the_jax_package_is_refused(tmp_path, jax_model):
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    registry.get_models().insert(Model(id="EI-jax", models=pickle.dumps([jax_model])))
    with pytest.raises(ForeignModelError, match="predictionio_tpu.models.recommendation"):
        load_models(registry, "EI-jax")
