"""The port's checkpoint store, writer, lever resolution and ``pio ckpt``
on the CPU (mirrors ``tests/test_ckpt.py``'s ``TestCommitProtocol``,
``TestRetention``, ``TestWriter``, ``TestResolution`` and
``TestCkptCLI``).

- The commit protocol: manifest last (a crash before it leaves nothing
  loadable), a SHA-256 per file (a corrupt step is skipped loudly and
  counted), the loud refusal of another recipe's step.
- Retention: keep-last-k, keep-every-j, crash garbage pruned on request.
- The writer: a full queue drops and counts, a write error is contained.
- The levers: every resolution case gives what the JAX package's
  ``ckpt.settings`` gives on the same environment.
- ``pio ckpt ls|verify|gc`` and the console's forwarding of ``ckpt``.
- One format: a store either package wrote loads in the other.
"""

import json
import os
import threading

import numpy as np
import pytest

from predictionio_tpu.ckpt import settings as jax_settings
from predictionio_tpu.ckpt.store import CheckpointStore as JaxCheckpointStore
from predictionio_tpu_torch.ckpt import (
    EVERY_ENV,
    KEEP_EVERY_ENV,
    KEEP_LAST_ENV,
    QUEUE_ENV,
    RESUME_ENV,
    CheckpointCorrupt,
    CheckpointMismatch,
    CheckpointStore,
    CheckpointWriter,
    resolve_every,
    resolve_queue_depth,
    resolve_resume,
    resolve_retention,
)
from predictionio_tpu_torch.ckpt.cli import main as ckpt_main
from predictionio_tpu_torch.tools import console
from predictionio_tpu_torch.workflow import WorkflowContext


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(6, 4)).astype(np.float32),
        "y": rng.normal(size=(5, 4)).astype(np.float32),
    }


META = {"rank": 4, "lambda": 0.1, "seed": 2}


class TestCommitProtocol:
    def test_save_load_roundtrip(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        arrays = _arrays()
        store.save(3, arrays, {**META, "iteration": 3})
        assert store.steps() == [3]
        loaded = store.load(expect_meta=META)
        assert loaded.step == 3
        np.testing.assert_array_equal(loaded.arrays["x"], arrays["x"])
        np.testing.assert_array_equal(loaded.arrays["y"], arrays["y"])
        assert loaded.meta["iteration"] == 3

    def test_crash_before_manifest_leaves_nothing_loadable(self, tmp_path, monkeypatch):
        store = CheckpointStore(str(tmp_path))

        def boom(d, step, files, meta):
            raise KeyboardInterrupt("preempted mid-commit")

        monkeypatch.setattr(store, "_commit_manifest", boom)
        with pytest.raises(KeyboardInterrupt):
            store.save(1, _arrays(), META)
        assert store.steps() == []
        assert store.load(expect_meta=META) is None
        assert store.uncommitted() == ["step_00000001"]
        monkeypatch.undo()
        # the recovering run saves the same step over the garbage
        store.save(1, _arrays(), {**META, "iteration": 1})
        assert store.steps() == [1]
        assert store.uncommitted() == []

    def test_corrupt_checksum_is_skipped_loudly(self, tmp_path, caplog):
        store = CheckpointStore(str(tmp_path))
        store.save(1, _arrays(1), {**META, "iteration": 1})
        store.save(2, _arrays(2), {**META, "iteration": 2})
        target = os.path.join(store.step_dir(2), "x.npy")
        blob = bytearray(open(target, "rb").read())
        blob[-1] ^= 0xFF
        with open(target, "wb") as fh:
            fh.write(blob)
        with pytest.raises(CheckpointCorrupt):
            store.verify_step(2)
        with caplog.at_level("ERROR"):
            loaded = store.load(expect_meta=META)
        assert loaded.step == 1
        assert store.corrupt_skipped == 1
        assert any("corrupt" in r.message.lower() for r in caplog.records)

    def test_missing_file_is_corrupt(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        store.save(1, _arrays(), META)
        os.unlink(os.path.join(store.step_dir(1), "y.npy"))
        with pytest.raises(CheckpointCorrupt):
            store.verify_step(1)
        assert store.load(expect_meta=META) is None
        assert store.corrupt_skipped == 1

    def test_config_mismatch_refuses_loudly(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        store.save(1, _arrays(), {**META, "iteration": 1})
        with pytest.raises(CheckpointMismatch, match="lambda"):
            store.load_step(1, expect_meta={**META, "lambda": 0.05})
        with pytest.raises(CheckpointMismatch):
            store.load(expect_meta={**META, "lambda": 0.05})

    def test_verify_report(self, tmp_path):
        store = CheckpointStore(str(tmp_path))
        store.save(1, _arrays(1), META)
        store.save(2, _arrays(2), META)
        report = store.verify()
        assert [r["step"] for r in report] == [1, 2]
        assert all(r["ok"] for r in report)
        assert all(r["files"] == 2 for r in report)


@pytest.mark.parametrize("writer,reader", [(JaxCheckpointStore, CheckpointStore),
                                           (CheckpointStore, JaxCheckpointStore)])
def test_a_store_either_package_wrote_loads_in_the_other(writer, reader, tmp_path):
    writer(str(tmp_path)).save(7, _arrays(7), {**META, "iteration": 7})
    loaded = reader(str(tmp_path)).load(expect_meta=META)
    assert loaded.step == 7 and loaded.meta["iteration"] == 7
    for name, array in _arrays(7).items():
        np.testing.assert_array_equal(loaded.arrays[name], array)


def test_the_context_gives_a_store_under_its_checkpoint_dir(tmp_path, monkeypatch):
    ctx = WorkflowContext(device="cpu")
    assert ctx.checkpoint_store() is None  # no directory assigned: no store
    ctx.checkpoint_dir = str(tmp_path)
    monkeypatch.setenv(KEEP_LAST_ENV, "2")
    store = ctx.checkpoint_store(subdir="algo_0_sharded")
    assert store.root == str(tmp_path / "algo_0_sharded")
    assert (store.keep_last, store.keep_every) == (2, 0)
    store = ctx.checkpoint_store(keep_last=5, keep_every=3)
    assert (store.root, store.keep_last, store.keep_every) == (str(tmp_path), 5, 3)


class TestRetention:
    def test_keep_last_k(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep_last=3)
        for s in range(1, 8):
            store.save(s, _arrays(s), META)
        assert store.steps() == [5, 6, 7]

    def test_keep_every_j_survives_gc(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep_last=2, keep_every=4)
        for s in range(1, 11):
            store.save(s, _arrays(s), META)
        assert store.steps() == [4, 8, 9, 10]

    def test_gc_prunes_uncommitted_only_when_asked(self, tmp_path, monkeypatch):
        store = CheckpointStore(str(tmp_path), keep_last=2)
        monkeypatch.setattr(store, "_commit_manifest",
                            lambda *a, **k: (_ for _ in ()).throw(OSError("crash")))
        with pytest.raises(OSError):
            store.save(9, _arrays(), META)
        monkeypatch.undo()
        store.save(10, _arrays(), META)
        assert store.uncommitted() == ["step_00000009"]
        store.gc()  # routine GC leaves crash evidence for inspection
        assert store.uncommitted() == ["step_00000009"]
        store.gc(prune_uncommitted=True)  # the explicit `pio ckpt gc`
        assert store.uncommitted() == []
        assert store.steps() == [10]


class TestWriter:
    def test_backpressure_drops_and_counts(self, tmp_path):
        gate = threading.Event()

        class SlowStore(CheckpointStore):
            def save(self, step, arrays, meta):
                gate.wait(timeout=30)
                return super().save(step, arrays, meta)

        store = SlowStore(str(tmp_path), keep_last=10)
        w = CheckpointWriter(store, queue_depth=1)
        assert w.submit(1, _arrays(1), META)  # dequeued, blocked in save
        for _ in range(1000):  # until the worker holds step 1
            if w._queue.empty():
                break
            threading.Event().wait(0.005)
        assert w.submit(2, _arrays(2), META)  # fills the queue
        assert not w.submit(3, _arrays(3), META)  # full: dropped
        gate.set()
        stats = w.close()
        assert stats == {"written": 2, "dropped": 1, "errors": 0, "lastError": None}
        assert not w._thread.is_alive()
        assert store.steps() == [1, 2]

    def test_save_error_is_contained(self, tmp_path):
        class BrokenStore(CheckpointStore):
            def save(self, step, arrays, meta):
                raise OSError("disk gone")

        w = CheckpointWriter(BrokenStore(str(tmp_path)), queue_depth=2)
        w.flush_submit(1, _arrays(), META)
        stats = w.close()
        assert stats["errors"] == 1
        assert "disk gone" in stats["lastError"]

    def test_submit_after_close_is_refused(self, tmp_path):
        w = CheckpointWriter(CheckpointStore(str(tmp_path)))
        w.close()
        with pytest.raises(RuntimeError, match="closed"):
            w.submit(1, _arrays(), META)


ENVS = [{}, {EVERY_ENV: "7"}, {EVERY_ENV: " "}, {RESUME_ENV: "0"}, {RESUME_ENV: "off"},
        {RESUME_ENV: "1"}, {RESUME_ENV: ""}, {KEEP_LAST_ENV: "5", KEEP_EVERY_ENV: "4"},
        {QUEUE_ENV: "8"}, {EVERY_ENV: "3", RESUME_ENV: "no", KEEP_LAST_ENV: "1"}]


class TestResolution:
    @pytest.mark.parametrize("env", ENVS)
    @pytest.mark.parametrize("explicit,workflow", [(None, None), (2, 5), (0, 5), (None, 5),
                                                   (None, 0)])
    def test_cadence_as_the_jax_package(self, env, explicit, workflow):
        got = resolve_every(explicit, workflow=workflow, env=env)
        assert got == jax_settings.resolve_every(explicit, workflow=workflow, env=env)

    @pytest.mark.parametrize("env", ENVS)
    @pytest.mark.parametrize("explicit", [None, True, False])
    def test_resume_as_the_jax_package(self, env, explicit):
        assert resolve_resume(explicit, env=env) == jax_settings.resolve_resume(explicit, env=env)

    @pytest.mark.parametrize("env", ENVS)
    def test_retention_and_queue_as_the_jax_package(self, env):
        for args in ((None, None), (2, None), (None, 3)):
            assert (resolve_retention(*args, env=env)
                    == jax_settings.resolve_retention(*args, env=env))
        for explicit in (None, 4):
            assert (resolve_queue_depth(explicit, env=env)
                    == jax_settings.resolve_queue_depth(explicit, env=env))

    @pytest.mark.parametrize("explicit,env", [(-1, {}), (None, {EVERY_ENV: "three"}),
                                              (None, {EVERY_ENV: "-2"})])
    def test_invalid_cadence_fails_loudly_in_both(self, explicit, env):
        for fn in (resolve_every, jax_settings.resolve_every):
            with pytest.raises(ValueError):
                fn(explicit, env=env)


class TestCkptCLI:
    def _seeded(self, tmp_path):
        store = CheckpointStore(str(tmp_path / "s"), keep_last=10)
        for s in (1, 2, 3):
            store.save(s, _arrays(s), {**META, "iteration": s})
        return store

    def test_ls_json(self, tmp_path, capsys):
        store = self._seeded(tmp_path)
        assert ckpt_main(["ls", "--dir", store.root, "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert [s["step"] for s in doc["steps"]] == [1, 2, 3]

    def test_verify_exit_codes(self, tmp_path, capsys):
        store = self._seeded(tmp_path)
        assert ckpt_main(["verify", "--dir", store.root]) == 0
        with open(os.path.join(store.step_dir(2), "x.npy"), "ab") as fh:
            fh.write(b"junk")
        assert ckpt_main(["verify", "--dir", store.root]) == 1
        assert "corrupt" in capsys.readouterr().out.lower()
        assert ckpt_main(["verify", "--dir", store.root, "--step", "3"]) == 0

    def test_gc_applies_retention(self, tmp_path, capsys):
        store = self._seeded(tmp_path)
        assert ckpt_main(["gc", "--dir", store.root, "--keep-last", "1"]) == 0
        assert CheckpointStore(store.root).steps() == [3]
        assert ckpt_main(["gc", "--dir", store.root, "--all"]) == 0
        assert not os.path.exists(store.root)

    def test_missing_dir_is_an_error(self, tmp_path, capsys):
        assert ckpt_main(["ls", "--dir", str(tmp_path / "nope")]) != 0
        assert "does not exist" in json.loads(capsys.readouterr().err)["error"]

    def test_console_forwards_ckpt(self, tmp_path, capsys):
        """``pio ckpt`` is forwarded before the console's own parser, and
        needs no storage configuration."""
        store = self._seeded(tmp_path)
        assert console.main(["ckpt", "ls", "--dir", store.root]) == 0
        assert "files" in capsys.readouterr().out
        assert console.main(["checkpoint", "gc", "--dir", store.root, "--keep-last", "2"]) == 0
        assert CheckpointStore(store.root).steps() == [2, 3]
