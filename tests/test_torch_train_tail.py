"""The end of ``run_train`` in the port, on the CPU: what a finished run
leaves behind and what it cleans up.

A DataSource over seeded arrays (60 users, 30 items, 1,500 ratings, ALS
rank 6) trains through ``workflow.run_train`` into a temporary
``PIO_FS_BASEDIR``:

- the instance env holds ``PIO_TRAIN_PHASES`` (``read``, ``prepare``,
  ``train[0]``; read back as the JAX package's ``phases_from_env`` reads
  it, garbage as ``{}``) and ``PIO_TRAIN_PROFILE``;
- ``PIO_PERF_LEDGER`` gets exactly one record (``train_wall_s``, schema
  1, a device of the JAX ledger's class ``cpu``, the phases); a torn line
  is skipped on load; a ledger that cannot be written does not fail the
  run;
- ``PIO_PROFILE_DIR`` gets a ``torch.profiler`` trace;
- the derived checkpoint directory is gone after a success and kept
  after a ``KeyboardInterrupt``, ``PIO_CKPT_DIR`` is kept after a
  success, and ``ctx.stop()`` runs on both paths;
- ``PIO_CKPT_RESUME=0`` trains fresh: the run equals one without a
  checkpoint directory bit for bit, though the directory held a step
  that a resume would have used.
"""

import glob
import json
import os

import numpy as np
import pytest

from predictionio_tpu.obs import perfledger as jax_perfledger
from predictionio_tpu.utils import profiling as jax_profiling
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
    RecPreparator,
    TrainingData,
)
from predictionio_tpu_torch.obs import perfledger
from predictionio_tpu_torch.storage import STATUS_COMPLETED, STATUS_INIT, BiMap, StorageRegistry
from predictionio_tpu_torch.utils.profiling import (
    TRAIN_PHASES_ENV_KEY,
    phases_from_env,
    profile_from_env,
)
from predictionio_tpu_torch.workflow import WorkflowContext, load_models, run_train
from predictionio_tpu_torch.workflow.checkpoint import CheckpointManager

N_USERS, N_ITEMS, NNZ, RANK = 60, 30, 1500, 6


def _data():
    rng = np.random.default_rng(0)
    return TrainingData(
        users=rng.integers(0, N_USERS, NNZ).astype(np.int32),
        items=rng.integers(0, N_ITEMS, NNZ).astype(np.int32),
        ratings=rng.uniform(1, 5, NNZ).astype(np.float32),
        user_map=BiMap({f"u{i}": i for i in range(N_USERS)}),
        item_map=BiMap({f"i{i}": i for i in range(N_ITEMS)}),
    )


def _engine(interrupt=False):
    data = _data()

    class ArraysDataSource(DataSource):
        def read_training(self, ctx):
            if interrupt:
                raise KeyboardInterrupt("operator pressed ^C")
            return data

    return Engine({"": ArraysDataSource}, {"": RecPreparator},
                  {"als": ALSAlgorithm}, {"": FirstServing})


class CountingContext(WorkflowContext):
    def __init__(self):
        super().__init__(device="cpu")
        self.stops = 0

    def stop(self):
        self.stops += 1
        super().stop()


@pytest.fixture()
def env(tmp_path, monkeypatch):
    """A storage base directory of the test's own; no PIO_* of the caller."""
    for key in ("PIO_PERF_LEDGER", "PIO_PROFILE_DIR", "PIO_CKPT_DIR", "PIO_CKPT_EVERY",
                "PIO_CKPT_RESUME"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    return StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "base")})


def _train(registry, ctx=None, interrupt=False, wp=WorkflowParams(), **params):
    params = {"rank": RANK, "num_iterations": 4, "lambda_": 0.05, "seed": 0, **params}
    ep = EngineParams(algorithm_params_list=[("als", ALSAlgorithmParams(**params))])
    return run_train(_engine(interrupt), ep, registry, ctx=ctx or WorkflowContext(device="cpu"),
                     workflow_params=wp)


def _env_of(registry, iid):
    return registry.get_metadata().engine_instance_get(iid).env


def test_the_instance_env_holds_the_phases(env):
    env_map = _env_of(env, _train(env))
    phases = phases_from_env(env_map)
    assert {"read", "prepare", "train[0]"} <= set(phases)
    assert all(v >= 0 for v in phases.values())
    assert phases == jax_profiling.phases_from_env(env_map)
    for garbage in ("not json", "[1, 2]", ""):
        bad = {TRAIN_PHASES_ENV_KEY: garbage}
        assert phases_from_env(bad) == {} == jax_profiling.phases_from_env(bad)
    assert phases_from_env(None) == {}


def test_the_instance_env_holds_the_profile(env):
    env_map = _env_of(env, _train(env))
    profile = profile_from_env(env_map)
    assert set(profile) == {"train_wall_s"} and profile["train_wall_s"] >= 0
    assert profile == jax_profiling.profile_from_env(env_map)
    assert profile_from_env({"PIO_TRAIN_PROFILE": "{"}) == {}


def test_the_perf_ledger_gets_one_record(env, tmp_path, monkeypatch):
    path = tmp_path / "ledger" / "perf.jsonl"
    monkeypatch.setenv("PIO_PERF_LEDGER", str(path))
    iid = _train(env)
    (record,) = perfledger.load_ledger(str(path))
    assert record["metric"] == "train_wall_s" and record["schema"] == 1
    assert record["source"] == "train" and record["unit"] == "s"
    assert record["device"] == "cpu"
    assert jax_perfledger._device_class(record["device"]) == "cpu"
    assert set(record["phases"]) == {"read", "prepare", "train[0]"}
    assert record["extra"]["instanceId"] == iid
    assert record["extra"]["profile"] == profile_from_env(_env_of(env, iid))
    assert jax_perfledger.load_ledger(str(path)) == [record]


def test_a_torn_ledger_line_is_skipped(tmp_path):
    path = str(tmp_path / "perf.jsonl")
    perfledger.append_record(path, perfledger.make_record("train", "train_wall_s", 1.0))
    with open(path, "a") as fh:
        fh.write('{"schema": 1, "value": 2.\n')  # a line torn by a crash
    perfledger.append_record(path, perfledger.make_record("train", "train_wall_s", 3.0))
    assert [r["value"] for r in perfledger.load_ledger(path)] == [1.0, 3.0]
    assert perfledger.load_ledger(str(tmp_path / "missing.jsonl")) == []


def test_a_ledger_that_cannot_be_written_does_not_fail_the_run(env, tmp_path, monkeypatch):
    blocker = tmp_path / "a-file"
    blocker.write_text("not a directory")
    monkeypatch.setenv("PIO_PERF_LEDGER", str(blocker / "perf.jsonl"))
    iid = _train(env)
    assert env.get_metadata().engine_instance_get(iid).status == STATUS_COMPLETED


def test_the_profile_dir_gets_a_trace(env, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "prof"))
    _train(env)
    (path,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    with open(path) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    assert any("aten::" in n for n in names)


def test_a_derived_checkpoint_dir_goes_after_success_and_stays_after_an_interrupt(
        env, tmp_path, monkeypatch):
    derived = tmp_path / "base" / "checkpoints" / "default" / "1" / "nightly"
    wp = WorkflowParams(batch="nightly", checkpoint_every=1)
    # a run cut after its first checkpoint leaves it behind
    real_save = CheckpointManager.save

    def save_then_interrupt(self, step, tree, metadata=None):
        real_save(self, step, tree, metadata)
        raise KeyboardInterrupt("preempted")

    monkeypatch.setattr(CheckpointManager, "save", save_then_interrupt)
    ctx = CountingContext()
    with pytest.raises(KeyboardInterrupt):
        _train(env, ctx=ctx, wp=wp)
    monkeypatch.undo()
    assert ctx.stops == 1
    assert os.listdir(derived / "algo_0") == ["step_1"]
    # an interrupt from the data source keeps it too
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    ctx = CountingContext()
    with pytest.raises(KeyboardInterrupt):
        _train(env, ctx=ctx, interrupt=True, wp=wp)
    assert ctx.stops == 1
    assert os.listdir(derived / "algo_0") == ["step_1"]
    # the rerun resumes from it, and a success deletes it
    ctx = CountingContext()
    ctx.profile = {}
    _train(env, ctx=ctx, wp=wp)
    assert ctx.stops == 1 and ctx.profile["resumed_from"] == 1
    assert not derived.exists()
    rows = env.get_metadata().engine_instance_get_all()
    assert sorted(r.status for r in rows) == [STATUS_COMPLETED] + [STATUS_INIT] * 2


def test_a_pinned_checkpoint_dir_is_kept(env, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_CKPT_DIR", str(tmp_path / "pinned"))
    ctx = CountingContext()
    _train(env, ctx=ctx, checkpoint_every=2)
    assert ctx.checkpoint_dir == str(tmp_path / "pinned") and ctx.stops == 1
    assert sorted(os.listdir(tmp_path / "pinned" / "algo_0")) == ["step_2", "step_4"]
    assert not (tmp_path / "base" / "checkpoints").exists()


def test_no_resume_trains_fresh(env, tmp_path, monkeypatch):
    (plain,) = load_models(env, _train(env))
    ck = tmp_path / "pinned"
    monkeypatch.setenv("PIO_CKPT_DIR", str(ck))
    _train(env, num_iterations=2, checkpoint_every=1)
    # a step a resume would take, doctored so that taking it shows
    manager = CheckpointManager(str(ck / "algo_0"))
    _, tree, meta = manager.restore(2, like={"x": 0, "y": 0})
    manager.save(2, {"x": tree["x"], "y": tree["y"] * 2}, meta)
    monkeypatch.setenv("PIO_CKPT_RESUME", "0")
    (fresh,) = load_models(env, _train(env, checkpoint_every=1))
    assert np.array_equal(fresh.user_factors, plain.user_factors)
    assert np.array_equal(fresh.item_factors, plain.item_factors)
    assert sorted(os.listdir(ck / "algo_0")) == ["step_2", "step_3", "step_4"]
    # with resume on, the doctored step is taken
    manager.save(2, {"x": tree["x"], "y": tree["y"] * 2}, meta)
    for step in (3, 4):
        os.remove(ck / "algo_0" / f"step_{step}" / "_COMPLETE")
    monkeypatch.setenv("PIO_CKPT_RESUME", "1")
    (resumed,) = load_models(env, _train(env, checkpoint_every=1))
    assert not np.array_equal(resumed.user_factors, plain.user_factors)
