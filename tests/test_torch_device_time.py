"""``chip_smoke.device_time``'s decision, on the CPU with a stubbed
profiler and stubbed launch counts.

``torch.profiler`` loses ops late in a long process; the port's own
counters (``cuda_kernels.kernel_launches``) say how many kernels a call
launched. A trace short of them is retried and, when every trace is
short, the device time is "not measured" (``ms`` None, the CUDA-event
time beside it); a launch count short of what the call must make is a
fault of the port and raises. ``main``'s phase wrapper names the phase
that failed on stderr before the run fails with it.
"""

import json

import pytest
import torch

import chip_smoke as cs
from predictionio_tpu_torch.ops import cuda_kernels


class FakeCard:
    """Launch counters and profiler traces under the test's control:
    each call of ``fn`` launches ``launches_per_call`` kernels, and the
    n-th trace sees ``ops[n]`` device ops (None: an empty trace)."""

    def __init__(self, monkeypatch, ops, launches_per_call=1, phase="-"):
        self.count = 0
        self.traces = 0
        self.ops = list(ops)
        self.launches_per_call = launches_per_call
        monkeypatch.setattr(cuda_kernels, "kernel_launches",
                            lambda: {"topk_streaming": self.count, "gramian_fused": 0,
                                     "spd_solve": 0, "flash_attention": 0})
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
        monkeypatch.setattr(cs, "time_ms", lambda torch_, fn, iters=30, warmup=3: 0.125)
        monkeypatch.setattr(cs, "device_profile", self.profile)
        monkeypatch.setattr(cs, "CURRENT_PHASE", [phase])
        monkeypatch.setattr(cs, "SHORT_TRACES", {})

    def fn(self):
        self.count += self.launches_per_call

    def profile(self, torch_, fn, top=6):
        fn()
        ops = self.ops[min(self.traces, len(self.ops) - 1)]
        self.traces += 1
        return {"result": None, "wall_ms": 1.0,
                "device_busy_ms": None if ops is None else 0.5 * max(ops, 1),
                "device_busy_share": None, "device_ops": ops or 0,
                "top_device_ops": [{"name": "k", "ms": 0.5, "count": ops or 0}]}


def test_a_whole_trace_gives_a_number(monkeypatch):
    card = FakeCard(monkeypatch, ops=[10])
    out = cs.device_time(torch, card.fn, iters=10, launches_per_call=1)
    assert out["ms"] == pytest.approx(0.5)
    assert out["ops_per_call"] == 1.0
    assert card.traces == 1


def test_a_short_trace_with_full_launches_is_not_measured(monkeypatch):
    card = FakeCard(monkeypatch, ops=[7, 9, 3], phase="templates")
    out = cs.device_time(torch, card.fn, iters=10, launches_per_call=1)
    assert out == {"ms": None, "trace_ops": [7, 9, 3], "launches": 10, "event_ms": 0.125}
    assert card.traces == cs.PROFILE_ATTEMPTS
    assert cs.measured(out["ms"]) == cs.NOT_MEASURED == "not measured"
    # counted by phase for the run's phase_seconds line
    assert cs.SHORT_TRACES == {"templates": {"short": 3, "not_measured": 1}}


def test_a_short_launch_count_raises(monkeypatch):
    card = FakeCard(monkeypatch, ops=[10], launches_per_call=0)
    with pytest.raises(AssertionError, match="fewer than the 1 a call must make"):
        cs.device_time(torch, card.fn, iters=10, launches_per_call=1)


def test_a_trace_shorter_than_the_counted_launches_is_retried(monkeypatch):
    """The counters saw two launches a call: a trace of one op a call is
    short even where the caller asked for none, and the next whole trace
    is the one measured."""
    card = FakeCard(monkeypatch, ops=[10, 20], launches_per_call=2, phase="kernel")
    out = cs.device_time(torch, card.fn, iters=10)
    assert out["ms"] == pytest.approx(1.0)
    assert card.traces == 2
    assert cs.SHORT_TRACES == {"kernel": {"short": 1, "not_measured": 0}}


def test_an_empty_trace_of_a_library_call_is_not_measured(monkeypatch):
    """A library call launches none of the port's kernels; an empty trace
    (the profiler gave none for ``cholesky_solve``) no longer fails."""
    card = FakeCard(monkeypatch, ops=[None], launches_per_call=0)
    out = cs.device_time(torch, card.fn, iters=5)
    assert out["ms"] is None and out["trace_ops"] == [0, 0, 0] and out["launches"] == 0


def test_ops_per_call_still_holds_a_trace_to_its_floor(monkeypatch):
    card = FakeCard(monkeypatch, ops=[5, 5, 5], launches_per_call=0)
    assert cs.device_time(torch, card.fn, iters=5, ops_per_call=2)["ms"] is None
    assert cs.traced_device_ms(torch, card.fn, 5, 2) is None


def test_ratio_of_an_unmeasured_time_is_not_measured():
    assert cs.ratio(1.0, 4.0) == 0.25
    assert cs.ratio(cs.NOT_MEASURED, 4.0) == cs.NOT_MEASURED
    assert cs.ratio(1.0, cs.NOT_MEASURED) == cs.NOT_MEASURED
    assert cs.ratio(1.0, 0.0) == cs.NOT_MEASURED


def test_a_failing_phase_is_named_on_stderr(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cs, "CURRENT_PHASE", ["-"])

    def broken(torch_):
        raise RuntimeError("boom")

    monkeypatch.setattr(cs, "phase_device", broken)
    with pytest.raises(RuntimeError, match="boom"):
        cs.main([])
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("{")]
    assert json.loads(lines[-1]) == {"failed_phase": "device",
                                     "error": "RuntimeError('boom')"}


def test_seq_reads_once_decodes_an_app_once(monkeypatch):
    """Inside the block a second read of one app returns the first read's
    histories; another app is read on its own; after the block every read
    decodes again."""
    from predictionio_tpu_torch.models.sequencerec import SeqDataSource, SeqDataSourceParams

    calls = []
    monkeypatch.setattr(SeqDataSource, "read_training",
                        lambda self, ctx: calls.append(self.params.app_id) or object())

    def read(app):
        return SeqDataSource(SeqDataSourceParams(app_id=app)).read_training(None)

    with cs.seq_reads_once():
        first, again, other = read(1), read(1), read(2)
    assert first is again and other is not first and calls == [1, 2]
    assert read(1) is not first and calls == [1, 2, 1]
