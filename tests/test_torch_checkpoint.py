"""Step checkpoints, ALS resume and the profiling hooks of the port, on
the CPU (mirrors ``tests/test_checkpoint.py``).

- ``workflow.checkpoint.CheckpointManager``: the JAX package's six cases.
- ``utils.profiling``: the phase timer, ``device_trace`` on
  ``torch.profiler`` (a parseable ``*.pt.trace.json``; nothing without a
  directory), and ``Engine.train``'s ``read`` / ``prepare`` / ``train[0]``.
- ALS resume on ``toy_ratings()`` (60 × 30, 1,500 ratings, rank 6): a run
  interrupted after 3 iterations and resumed to 6 equals the
  uninterrupted run bit for bit (``torch.equal``); stale, corrupt and
  foreign checkpoints are passed over; two ALS blocks of one engine keep
  ``algo_0/`` and ``algo_1/``.
- Across the packages: the JAX package trains 3 iterations with a
  checkpoint every iteration, the port resumes that directory to 6, and
  its factors are within the ALS parity tolerance (rtol 2e-3 / atol
  2e-4, ``tests/test_torch_als.py``) of the JAX package's uninterrupted 6.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from predictionio_tpu.ops.als import ALSConfig as JaxALSConfig
from predictionio_tpu.ops.als import als_train_coo as jax_als_train_coo
from predictionio_tpu.workflow.checkpoint import CheckpointManager as JaxCheckpointManager
from predictionio_tpu_torch.controller import DataSource, Engine, EngineParams, FirstServing
from predictionio_tpu_torch.models.recommendation import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    RecPreparator,
    TrainingData,
)
from predictionio_tpu_torch.ops.als import ALSConfig, als_train_coo
from predictionio_tpu_torch.storage import BiMap
from predictionio_tpu_torch.utils.profiling import StepTimer, device_trace
from predictionio_tpu_torch.workflow import WorkflowContext
from predictionio_tpu_torch.workflow.checkpoint import CheckpointManager

RTOL, ATOL = 2e-3, 2e-4


def toy_ratings(seed=0):
    rng = np.random.default_rng(seed)
    n_users, n_items, nnz = 60, 30, 1500
    users = rng.integers(0, n_users, nnz)
    items = rng.integers(0, n_items, nnz)
    ratings = rng.uniform(1, 5, nnz).astype(np.float32)
    return users, items, ratings, n_users, n_items


def _cfg(iterations, **kw):
    return ALSConfig(rank=6, iterations=iterations, **{"lambda_": 0.05, "seed": 0, **kw})


def _train(cfg, **kw):
    users, items, ratings, nu, ni = toy_ratings()
    return als_train_coo(users, items, ratings, nu, ni, cfg, device="cpu", **kw)


def _equal(a, b):
    return torch.equal(a.user_factors, b.user_factors) and torch.equal(
        a.item_factors, b.item_factors)


class TestCheckpointManager:
    def test_save_restore_roundtrip(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        tree = {"a": np.arange(6).reshape(2, 3), "nest": [np.ones(4), np.zeros(2)]}
        cm.save(3, tree, {"k": "v"})
        step, got, meta = cm.restore(like={"a": 0, "nest": [0, 0]})
        assert step == 3 and meta == {"k": "v"}
        np.testing.assert_array_equal(got["a"], tree["a"])
        np.testing.assert_array_equal(got["nest"][0], tree["nest"][0])

    def test_flat_restore_without_template(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.save(1, {"x": np.ones(3)})
        _, flat, _ = cm.restore()
        assert set(flat) == {"x"}

    def test_prune_keeps_newest(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            cm.save(s, {"x": np.full(2, s)})
        assert cm.all_steps() == [3, 4]
        assert cm.latest_step() == 4

    def test_incomplete_checkpoint_ignored(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.save(1, {"x": np.ones(2)})
        # a crash mid-save: a step directory without the _COMPLETE marker
        os.makedirs(tmp_path / "step_2")
        (tmp_path / "step_2" / "arrays.npz").write_bytes(b"torn")
        assert cm.latest_step() == 1
        step, _, _ = cm.restore()
        assert step == 1

    def test_restore_empty_raises(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        with pytest.raises(FileNotFoundError):
            cm.restore()

    def test_slash_in_key_rejected(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        with pytest.raises(ValueError):
            cm.save(1, {"a/b": np.ones(1)})


class TestProfiling:
    def test_step_timer(self):
        t = StepTimer()
        with t.time("read"):
            pass
        t.record("train[0]", 1.5)
        t.record("train[0]", 0.5)
        s = t.summary()
        assert s["train[0]"]["count"] == 2
        assert s["train[0]"]["total_s"] == 2.0
        assert "read" in t.format_summary()

    def test_device_trace_writes_a_parseable_trace_on_the_cpu(self, tmp_path):
        logdir = tmp_path / "prof"
        with device_trace(str(logdir)):
            torch.ones(64).sum().item()
        (path,) = glob.glob(str(logdir / "*.pt.trace.json"))
        with open(path) as fh:
            trace = json.load(fh)
        assert trace["traceEvents"]

    def test_device_trace_without_a_directory_writes_nothing(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        for logdir in (None, ""):
            with device_trace(logdir):
                torch.ones(4).sum().item()
        assert os.listdir(tmp_path) == []

    def test_workflow_records_phases(self):
        ctx = WorkflowContext(device="cpu")
        with ctx.timer.time("read"):
            pass
        assert "read" in ctx.timer.summary()

    def test_engine_train_times_phases(self):
        ctx = WorkflowContext(device="cpu")
        _engine().train(ctx, _two_blocks()[0])
        assert {"read", "prepare", "train[0]"} <= set(ctx.timer.summary())


def _engine():
    users, items, ratings, nu, ni = toy_ratings()
    data = TrainingData(users=users.astype(np.int32), items=items.astype(np.int32),
                        ratings=ratings,
                        user_map=BiMap({f"u{i}": i for i in range(nu)}),
                        item_map=BiMap({f"i{i}": i for i in range(ni)}))

    class ArraysDataSource(DataSource):
        def read_training(self, ctx):
            return data

    return Engine({"": ArraysDataSource}, {"": RecPreparator},
                  {"als": ALSAlgorithm}, {"": FirstServing})


def _two_blocks():
    one = ("als", ALSAlgorithmParams(rank=4, num_iterations=2, lambda_=0.05,
                                     checkpoint_every=1))
    two = ("als", ALSAlgorithmParams(rank=4, num_iterations=2, lambda_=0.9, seed=7,
                                     checkpoint_every=1))
    return [EngineParams(algorithm_params_list=[one]),
            EngineParams(algorithm_params_list=[one, two])]


class TestALSResume:
    def test_resume_matches_uninterrupted(self, tmp_path):
        full = _train(_cfg(6))
        cm = CheckpointManager(str(tmp_path / "ck"))
        _train(_cfg(3), checkpoint=cm, checkpoint_every=1)
        assert cm.all_steps() == [1, 2, 3]
        profile = {}
        resumed = _train(_cfg(6), checkpoint=cm, checkpoint_every=1, profile=profile)
        assert profile["resumed_from"] == 3 and len(profile["iteration_s"]) == 3
        assert _equal(full, resumed)
        assert cm.latest_step() == 6

    def test_stale_checkpoint_shape_mismatch_ignored(self, tmp_path):
        cm = CheckpointManager(str(tmp_path / "ck"))
        cm.save(2, {"x": np.ones((5, 5)), "y": np.ones((4, 5))}, {"rank": 5, "iteration": 2})
        profile = {}
        out = _train(_cfg(2), checkpoint=cm, checkpoint_every=2, profile=profile)
        assert profile["resumed_from"] == 0
        assert tuple(out.user_factors.shape) == (60, 6)
        assert _equal(out, _train(_cfg(2)))

    def test_stale_higher_step_falls_back_to_valid_lower_step(self, tmp_path):
        """After lowering the iterations, a surviving higher step does not
        force a retrain from 0 when an in-range step exists."""
        cm = CheckpointManager(str(tmp_path / "ck"), keep=10)
        _train(_cfg(6), checkpoint=cm, checkpoint_every=1)
        assert cm.latest_step() == 6
        profile = {}
        four = _train(_cfg(4), checkpoint=cm, checkpoint_every=1, profile=profile)
        assert profile["resumed_from"] == 4 and profile["iteration_s"] == []
        _, tree, _ = cm.restore(4, like={"x": 0, "y": 0})
        assert torch.equal(four.user_factors, torch.from_numpy(tree["x"]))
        assert torch.equal(four.item_factors, torch.from_numpy(tree["y"]))

    @pytest.mark.parametrize("damage", ["garbage", "truncated", "empty", "meta"])
    def test_corrupt_checkpoint_treated_as_absent(self, tmp_path, damage):
        """An unreadable arrays.npz or meta.json under a durable marker (a
        torn write) falls back to fresh training, not a crash."""
        cm = CheckpointManager(str(tmp_path / "ck"))
        _train(_cfg(2), checkpoint=cm, checkpoint_every=1)
        for step in cm.all_steps():
            d = tmp_path / "ck" / f"step_{step}"
            if damage == "meta":
                (d / "meta.json").write_text("{")
                continue
            npz = (d / "arrays.npz").read_bytes()
            (d / "arrays.npz").write_bytes(
                {"garbage": b"not-an-npz", "truncated": npz[:200], "empty": b""}[damage])
        profile = {}
        out = _train(_cfg(2), checkpoint=cm, checkpoint_every=0, profile=profile)
        assert profile["resumed_from"] == 0
        assert _equal(out, _train(_cfg(2)))

    def test_different_hyperparams_do_not_resume(self, tmp_path):
        cm = CheckpointManager(str(tmp_path / "ck"))
        _train(_cfg(2), checkpoint=cm, checkpoint_every=1)
        fresh = _train(_cfg(2, lambda_=0.5))
        maybe_resumed = _train(_cfg(2, lambda_=0.5), checkpoint=cm, checkpoint_every=0)
        assert _equal(fresh, maybe_resumed)

    def test_multi_algo_namespacing(self, tmp_path):
        ctx = WorkflowContext(device="cpu")
        ctx.checkpoint_dir = str(tmp_path / "run-ck")
        models = _engine().train(ctx, _two_blocks()[1])
        assert sorted(os.listdir(tmp_path / "run-ck")) == ["algo_0", "algo_1"]
        assert os.listdir(tmp_path / "run-ck" / "algo_1")
        # different hyperparameters give different factors
        assert not np.allclose(models[0].user_factors, models[1].user_factors)


def test_the_port_resumes_a_run_the_jax_package_checkpointed(tmp_path):
    users, items, ratings, nu, ni = toy_ratings()
    jcfg = dict(rank=6, lambda_=0.05, seed=0)
    ck = str(tmp_path / "ck")
    jax_als_train_coo(users, items, ratings, nu, ni, JaxALSConfig(iterations=3, **jcfg),
                      checkpoint=JaxCheckpointManager(ck), checkpoint_every=1)
    jax_full = jax_als_train_coo(users, items, ratings, nu, ni,
                                 JaxALSConfig(iterations=6, **jcfg))
    profile = {}
    resumed = _train(_cfg(6), checkpoint=CheckpointManager(ck), checkpoint_every=1,
                     profile=profile)
    assert profile["resumed_from"] == 3 and len(profile["iteration_s"]) == 3
    np.testing.assert_allclose(resumed.user_factors.numpy(),
                               np.asarray(jax_full.user_factors), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(resumed.item_factors.numpy(),
                               np.asarray(jax_full.item_factors), rtol=RTOL, atol=ATOL)
    # the port's steps carry the JAX package's identity keys and values
    _, _, meta = JaxCheckpointManager(ck).restore(6)
    _, _, jmeta = JaxCheckpointManager(ck).restore(3)
    assert meta == {**jmeta, "iteration": 6}
