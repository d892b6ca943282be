"""The training slice as a whole on the CPU: ``run_train`` of the port's
recommendation engine, then the query server on the instance it wrote.

A DataSource over seeded arrays (300 users, 120 items, rank 8, 3
iterations) feeds ``workflow.run_train`` into a temporary
``PIO_FS_BASEDIR``; the port's ``init_factors`` is replaced by the JAX
package's table, since a ``torch.Generator`` cannot reproduce
``jax.random``. The trained ``ALSModel`` must match the JAX
``ALSAlgorithm.train`` on the same data (factors rtol 2e-3 / atol 2e-4,
the tolerance the JAX package holds its own solve modes to), and the
port's query server on that instance must answer like the JAX
``batch_predict`` on the JAX model (scores to the same tolerance, items
equal or tied).
"""

import http.client
import json
import os

import numpy as np
import pytest
import torch

from predictionio_tpu.models.recommendation import (
    ALSAlgorithm as JaxALSAlgorithm,
    ALSAlgorithmParams as JaxParams,
    PreparedData as JaxPreparedData,
    Query as JaxQuery,
)
from predictionio_tpu.ops.als import init_factors as jax_init_factors
from predictionio_tpu.storage import BiMap as JaxBiMap
from predictionio_tpu_torch.controller import (
    DataSource,
    Engine,
    EngineParams,
    FirstServing,
    WorkflowParams,
)
from predictionio_tpu_torch.models.recommendation import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    RecDataSource,
    RecDataSourceParams,
    RecPreparator,
    TrainingData,
    engine_factory,
)
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.storage import STATUS_COMPLETED, STATUS_INIT, BiMap, StorageRegistry
from predictionio_tpu_torch.workflow import (
    ServerConfig,
    WorkflowContext,
    create_query_server,
    load_models,
    run_train,
)

RANK, N_USERS, N_ITEMS, NNZ = 8, 300, 120, 6000
RTOL, ATOL = 2e-3, 2e-4
PARAMS = dict(rank=RANK, num_iterations=3, lambda_=0.05, seed=2)
QUERIES = [("u0", 10), ("u17", 1), ("ghost", 5), ("u299", 37), ("u42", 200)]


def _ratings():
    rng = np.random.default_rng(11)
    w = 1.0 / np.arange(1, N_USERS + 1) ** 0.8
    users = rng.choice(N_USERS, size=NNZ, p=w / w.sum()).astype(np.int32)
    items = rng.integers(0, N_ITEMS, NNZ).astype(np.int32)
    ratings = rng.integers(1, 6, NNZ).astype(np.float32)
    return users, items, ratings


def _ids(prefix, n):
    return {f"{prefix}{i}": i for i in range(n)}


def _engine(training_data):
    class ArraysDataSource(DataSource):
        def read_training(self, ctx):
            return training_data

    return Engine({"": ArraysDataSource}, {"": RecPreparator},
                  {"als": ALSAlgorithm}, {"": FirstServing})


def _training_data():
    users, items, ratings = _ratings()
    return TrainingData(users=users, items=items, ratings=ratings,
                        user_map=BiMap(_ids("u", N_USERS)),
                        item_map=BiMap(_ids("i", N_ITEMS)))


@pytest.fixture(scope="module")
def jax_model():
    users, items, ratings = _ratings()
    pd = JaxPreparedData(user_map=JaxBiMap(_ids("u", N_USERS)),
                         item_map=JaxBiMap(_ids("i", N_ITEMS)),
                         users=users, items=items, ratings=ratings)
    return JaxALSAlgorithm(JaxParams(**PARAMS)).train(None, pd)


@pytest.fixture()
def trained(tmp_path, monkeypatch):
    table = np.asarray(jax_init_factors(N_ITEMS, RANK, PARAMS["seed"]))
    monkeypatch.setattr(als, "init_factors", lambda n, rank, seed, device: (
        torch.from_numpy(table.copy()).to(device)))
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    ep = EngineParams(algorithm_params_list=[("als", ALSAlgorithmParams(**PARAMS))])
    ctx = WorkflowContext(device="cpu")
    ctx.profile = {}
    instance_id = run_train(_engine(_training_data()), ep, registry, ctx=ctx)
    return registry, instance_id, ctx.profile


def test_run_train_writes_a_completed_instance_that_matches_jax(trained, jax_model):
    registry, instance_id, profile = trained
    inst = registry.get_metadata().engine_instance_get(instance_id)
    assert inst.status == STATUS_COMPLETED and inst.end_time is not None
    assert json.loads(inst.env["PIO_TRAIN_PROFILE"])["train_wall_s"] >= 0
    assert json.loads(inst.algorithms_params)[0]["params"]["rank"] == RANK
    (model,) = load_models(registry, instance_id)
    np.testing.assert_allclose(model.user_factors, jax_model.user_factors,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(model.item_factors, jax_model.item_factors,
                               rtol=RTOL, atol=ATOL)
    assert model.user_map.to_dict() == jax_model.user_map.to_dict()
    assert model.item_map.to_dict() == jax_model.item_map.to_dict()
    assert profile["levers"]["kernels"] == "plain"
    assert len(profile["iteration_s"]) == PARAMS["num_iterations"]
    assert profile["bucketize_s"] >= 0 and profile["stage_s"] >= 0


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/queries.json", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_the_query_server_serves_the_trained_instance_like_jax(trained, jax_model):
    registry, instance_id, _ = trained
    jax_algo = JaxALSAlgorithm(JaxParams(**PARAMS))
    want = dict(jax_algo.batch_predict(
        jax_model, [(i, JaxQuery(user=u, num=n)) for i, (u, n) in enumerate(QUERIES)]))
    server = create_query_server(
        engine_factory(), ServerConfig(ip="127.0.0.1", port=0, device="cpu"),
        registry=registry, block=False,
    )
    try:
        for i, (user, num) in enumerate(QUERIES):
            status, data = _post(server.bound_port, {"user": user, "num": num})
            assert status == 200
            got = data["itemScores"]
            expect = want[i].item_scores
            assert len(got) == len(expect)
            if not expect:
                continue
            gs = np.array([x["score"] for x in got], np.float32)
            ws = np.array([x.score for x in expect], np.float32)
            np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL * 10)
            tied = np.isclose(gs, ws, rtol=RTOL, atol=ATOL * 10)
            same = np.array([g["item"] == w.item for g, w in zip(got, expect)])
            assert (same | tied).all()
    finally:
        server.shutdown()
        server.server_close()


def test_what_is_not_ported_is_refused(tmp_path, monkeypatch):
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    ctx = WorkflowContext(device="cpu")
    # reading events is ported (tests/test_torch_infeed.py): the template
    # reads the registry's event store, and an app without rating events
    # is refused by the training data's sanity check, not trained
    from predictionio_tpu_torch.storage import registry as registry_mod

    monkeypatch.setattr(registry_mod, "_default_registry", registry)
    assert len(RecDataSource().read_training(ctx).users) == 0
    ep = EngineParams(data_source_params=("", RecDataSourceParams()),
                      algorithm_params_list=[("als", ALSAlgorithmParams(rank=RANK))])
    with pytest.raises(ValueError, match="No rating events found"):
        run_train(engine_factory(), ep, registry, ctx=ctx)
    for bad in (dict(shards=2), dict(distributed=True)):
        ep = EngineParams(algorithm_params_list=[
            ("als", ALSAlgorithmParams(rank=RANK, **bad))])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_train(_engine(_training_data()), ep, registry, ctx=ctx)
    # a checkpoint cadence is ported: from the params or from the workflow
    # run it trains and checkpoints into the pinned directory
    monkeypatch.setenv("PIO_CKPT_DIR", str(tmp_path / "ck"))
    for params, wp in ((dict(checkpoint_every=1), WorkflowParams()),
                       ({}, WorkflowParams(checkpoint_every=1))):
        ep = EngineParams(algorithm_params_list=[
            ("als", ALSAlgorithmParams(rank=RANK, num_iterations=3, **params))])
        run_train(_engine(_training_data()), ep, registry,
                  ctx=WorkflowContext(device="cpu"), workflow_params=wp)
        assert sorted(os.listdir(tmp_path / "ck" / "algo_0")) == ["step_1", "step_2", "step_3"]
    # failed runs leave their INIT rows behind, as the reference does
    rows = registry.get_metadata().engine_instance_get_all()
    assert sorted(r.status for r in rows) == [STATUS_COMPLETED] * 2 + [STATUS_INIT] * 3


def test_engine_train_runs_the_sanity_checks_and_stops_where_asked():
    from predictionio_tpu_torch.controller import StopAfterReadInterruption

    ctx = WorkflowContext(device="cpu")
    ep = EngineParams(algorithm_params_list=[("als", ALSAlgorithmParams(**PARAMS))])
    empty = TrainingData(users=np.zeros(0, np.int32), items=np.zeros(0, np.int32),
                         ratings=np.zeros(0, np.float32),
                         user_map=BiMap({}), item_map=BiMap({}))
    with pytest.raises(ValueError, match="No rating events"):
        _engine(empty).train(ctx, ep)
    with pytest.raises(StopAfterReadInterruption):
        _engine(_training_data()).train(ctx, ep, WorkflowParams(stop_after_read=True))


def test_an_interrupted_run_stays_init(tmp_path):
    class Interrupted(DataSource):
        def read_training(self, ctx):
            raise KeyboardInterrupt

    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    engine = Engine({"": Interrupted}, {"": RecPreparator},
                    {"als": ALSAlgorithm}, {"": FirstServing})
    ep = EngineParams(algorithm_params_list=[("als", ALSAlgorithmParams(rank=RANK))])
    with pytest.raises(KeyboardInterrupt):
        run_train(engine, ep, registry, ctx=WorkflowContext(device="cpu"))
    (row,) = registry.get_metadata().engine_instance_get_all()
    assert row.status == STATUS_INIT


def test_training_defaults_to_the_card_and_never_the_cpu(tmp_path):
    """No device given: the context resolves ``cuda:0``, which raises on a
    machine without CUDA before any instance row is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    ep = EngineParams(algorithm_params_list=[("als", ALSAlgorithmParams(rank=RANK))])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_train(_engine(_training_data()), ep, registry)
    assert registry.get_metadata().engine_instance_get_all() == []
    with pytest.raises(RuntimeError, match="CUDA"):
        als.als_train_coo(*_ratings(), N_USERS, N_ITEMS, als.ALSConfig(rank=RANK))
