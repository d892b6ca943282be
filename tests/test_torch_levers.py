"""The port's ALS training refuses what it cannot do, the JAX package's way.

- ``ALSModel.sanity_check``: non-finite factors stop ``Engine.train``
  before the instance is stored COMPLETED (the reference's check).
- The environment levers: ``PIO_TRAIN_SHARDS`` resolves the shard count
  (explicit > env > 1) and ``PIO_CKPT_EVERY`` the checkpoint cadence
  (params > workflow run > env > 0) with the JAX package's resolvers'
  results; a resolved ``shards > 1`` is refused like the explicit
  params, a resolved cadence > 0 checkpoints, and a value that is not an
  integer raises.

Everything runs on the CPU at a tiny size (40 users, 20 items, rank 4).
"""

import os
import shutil

import numpy as np
import pytest

from predictionio_tpu.ckpt.settings import resolve_every as jax_resolve_every
from predictionio_tpu.ops.als_sharded import resolve_shards as jax_resolve_shards
from predictionio_tpu_torch.ckpt import DIR_ENV, EVERY_ENV, resolve_every
from predictionio_tpu_torch.controller import (
    DataSource,
    Engine,
    EngineParams,
    FirstServing,
    WorkflowParams,
)
from predictionio_tpu_torch.models import recommendation
from predictionio_tpu_torch.models.recommendation import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    ALSModel,
    RecPreparator,
    TrainingData,
)
from predictionio_tpu_torch.ops.als_sharded import SHARDS_ENV, resolve_shards
from predictionio_tpu_torch.storage import (
    STATUS_COMPLETED,
    STATUS_INIT,
    BiMap,
    StorageRegistry,
)
from predictionio_tpu_torch.workflow import WorkflowContext, run_train

N_USERS, N_ITEMS, RANK = 40, 20, 4


def _training_data():
    rng = np.random.default_rng(7)
    users = rng.integers(0, N_USERS, 400).astype(np.int32)
    items = rng.integers(0, N_ITEMS, 400).astype(np.int32)
    ratings = rng.integers(1, 6, 400).astype(np.float32)
    return TrainingData(
        users=users, items=items, ratings=ratings,
        user_map=BiMap({f"u{i}": i for i in range(N_USERS)}),
        item_map=BiMap({f"i{i}": i for i in range(N_ITEMS)}),
    )


def _run(tmp_path, workflow_params=WorkflowParams(), **params):
    data = _training_data()

    class ArraysDataSource(DataSource):
        def read_training(self, ctx):
            return data

    engine = Engine({"": ArraysDataSource}, {"": RecPreparator},
                    {"als": ALSAlgorithm}, {"": FirstServing})
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    ep = EngineParams(algorithm_params_list=[
        ("als", ALSAlgorithmParams(rank=RANK, num_iterations=2, **params))])
    try:
        return run_train(engine, ep, registry, ctx=WorkflowContext(device="cpu"),
                         workflow_params=workflow_params)
    finally:
        _run.rows = registry.get_metadata().engine_instance_get_all()


def _model(user_bad=None, item_bad=None):
    uf = np.ones((3, RANK), np.float32)
    itf = np.ones((2, RANK), np.float32)
    if user_bad is not None:
        uf[1, 2] = user_bad
    if item_bad is not None:
        itf[0, 0] = item_bad
    return ALSModel(rank=RANK, user_factors=uf, item_factors=itf,
                    user_map=BiMap({"a": 0, "b": 1, "c": 2}),
                    item_map=BiMap({"x": 0, "y": 1}))


# -- ALSModel.sanity_check ----------------------------------------------------
def test_a_finite_model_passes_the_sanity_check():
    _model().sanity_check()


@pytest.mark.parametrize("side,value", [
    ("user", np.nan), ("user", np.inf), ("item", np.nan), ("item", -np.inf),
])
def test_a_non_finite_factor_fails_the_sanity_check(side, value):
    model = _model(**{f"{side}_bad": value})
    with pytest.raises(ValueError, match=f"non-finite {side} factors"):
        model.sanity_check()


def test_a_nan_run_is_stopped_before_it_is_stored(tmp_path, monkeypatch):
    real = recommendation.als_train_coo

    def nan_training(*args, **kwargs):
        factors = real(*args, **kwargs)
        factors.item_factors[3, 1] = float("nan")
        return factors

    monkeypatch.setattr(recommendation, "als_train_coo", nan_training)
    with pytest.raises(ValueError, match="non-finite item factors"):
        _run(tmp_path)
    (row,) = _run.rows
    assert row.status == STATUS_INIT


# -- the environment levers ----------------------------------------------------
@pytest.mark.parametrize("env,value", [(SHARDS_ENV, "4")])
def test_an_env_lever_that_is_not_ported_is_refused(tmp_path, monkeypatch, env, value):
    monkeypatch.setenv(env, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run(tmp_path)
    assert all(r.status == STATUS_INIT for r in _run.rows)


@pytest.mark.parametrize("env,value", [(EVERY_ENV, "2")])
def test_an_env_cadence_checkpoints(tmp_path, monkeypatch, env, value):
    monkeypatch.setenv(env, value)
    monkeypatch.setenv(DIR_ENV, str(tmp_path / "ck"))
    _run(tmp_path)
    (row,) = _run.rows
    assert row.status == STATUS_COMPLETED
    assert os.listdir(tmp_path / "ck" / "algo_0") == ["step_2"]


@pytest.mark.parametrize("env,value", [
    (SHARDS_ENV, "1"), (EVERY_ENV, "0"), (SHARDS_ENV, ""), (EVERY_ENV, " "),
])
def test_an_env_lever_at_its_default_trains(tmp_path, monkeypatch, env, value):
    monkeypatch.setenv(env, value)
    _run(tmp_path)
    (row,) = _run.rows
    assert row.status == STATUS_COMPLETED


@pytest.mark.parametrize("env,value", [
    (SHARDS_ENV, "two"), (SHARDS_ENV, "0"), (EVERY_ENV, "1.5"), (EVERY_ENV, "-1"),
])
def test_an_invalid_env_lever_raises_value_error(tmp_path, monkeypatch, env, value):
    monkeypatch.setenv(env, value)
    with pytest.raises(ValueError, match=env):
        _run(tmp_path)


def test_explicit_params_win_over_the_env(tmp_path, monkeypatch):
    monkeypatch.setenv(SHARDS_ENV, "4")
    monkeypatch.setenv(EVERY_ENV, "2")
    _run(tmp_path, shards=1, checkpoint_every=0)
    (row,) = _run.rows
    assert row.status == STATUS_COMPLETED


def test_the_workflow_cadence_sits_between_params_and_env(tmp_path, monkeypatch):
    monkeypatch.setenv(EVERY_ENV, "2")
    ck = tmp_path / "ck"
    monkeypatch.setenv(DIR_ENV, str(ck))
    _run(tmp_path, workflow_params=WorkflowParams(checkpoint_every=0))
    assert not ck.exists()
    _run(tmp_path, workflow_params=WorkflowParams(checkpoint_every=1))
    assert sorted(os.listdir(ck / "algo_0")) == ["step_1", "step_2"]
    shutil.rmtree(ck)
    _run(tmp_path, checkpoint_every=2, workflow_params=WorkflowParams(checkpoint_every=1))
    assert os.listdir(ck / "algo_0") == ["step_2"]
    with pytest.raises(ValueError, match="checkpoint-every"):
        _run(tmp_path, workflow_params=WorkflowParams(checkpoint_every=-1))


@pytest.mark.parametrize("explicit", [None, 1, 3])
@pytest.mark.parametrize("raw", [None, "", "1", "4", "16"])
def test_resolve_shards_matches_the_jax_resolver(explicit, raw):
    env = {} if raw is None else {SHARDS_ENV: raw}
    assert resolve_shards(explicit, env) == jax_resolve_shards(explicit, env)


@pytest.mark.parametrize("explicit,workflow", [(None, None), (0, None), (None, 0),
                                               (5, 2), (None, 3)])
@pytest.mark.parametrize("raw", [None, "", "0", "2"])
def test_resolve_every_matches_the_jax_resolver(explicit, workflow, raw):
    env = {} if raw is None else {EVERY_ENV: raw}
    assert (resolve_every(explicit, workflow, env)
            == jax_resolve_every(explicit, workflow, env))


@pytest.mark.parametrize("raw", ["x", "0", "-2"])
def test_invalid_shard_counts_raise_in_both_resolvers(raw):
    for fn in (resolve_shards, jax_resolve_shards):
        with pytest.raises(ValueError, match=SHARDS_ENV):
            fn(None, {SHARDS_ENV: raw})
