"""The port's resilience primitives and fault harness against the JAX package's.

One parametrised mirror of ``tests/test_resilience.py``: every scenario
is a script over ``Deadline``, ``RetryPolicy``, ``CircuitBreaker`` and
``testing/faults`` on a fake clock, a captured sleep and a seeded rng.
It runs once through the JAX package's modules and once through the
port's, and the two traces (states, delays, counts, exception types)
must be equal; each scenario also pins what the JAX test asserts.
"""

from __future__ import annotations

import http.client
import random
import types

import pytest

import predictionio_tpu.testing.clock as jax_clock
import predictionio_tpu.testing.faults as jax_faults
import predictionio_tpu.utils.resilience as jax_res
import predictionio_tpu_torch.testing.clock as port_clock
import predictionio_tpu_torch.testing.faults as port_faults
import predictionio_tpu_torch.utils.resilience as port_res


def _ns(res, clock, faults):
    return types.SimpleNamespace(res=res, FakeClock=clock.FakeClock, faults=faults)


JAX = _ns(jax_res, jax_clock, jax_faults)
PORT = _ns(port_res, port_clock, port_faults)


def _raises(fn, *args, **kwargs):
    """The exception type's name a call raised, or its value."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as exc:  # the trace records what was raised
        return ("raised", type(exc).__name__)


# -- Deadline -----------------------------------------------------------------
def deadline_counts_down(ns):
    clock = ns.FakeClock()
    d = ns.res.Deadline.after_ms(250, clock)
    out = [round(d.remaining_ms(), 6)]
    clock.advance(0.2)
    out += [round(d.remaining_ms(), 6), d.expired]
    clock.advance(0.1)
    return out + [d.expired]


def deadline_check_names_its_stage(ns):
    clock = ns.FakeClock()
    d = ns.res.Deadline.after_ms(10, clock)
    d.check("dispatch")
    clock.advance(1.0)
    try:
        d.check("dispatch")
    except ns.res.DeadlineExceeded as exc:
        return [exc.stage, str(exc)]
    return ["no raise"]


def deadline_header_is_relative(ns):
    clock = ns.FakeClock()
    d = ns.res.Deadline.after_ms(500, clock)
    clock.advance(0.2)
    d2 = ns.res.Deadline.from_header(d.header_value(), ns.FakeClock(now=77.0))
    return [d.header_value(), round(d2.remaining_ms(), 3), ns.res.DEADLINE_HEADER]


def deadline_bad_headers(ns):
    out = [ns.res.Deadline.from_header(bad) for bad in (None, "", "not-a-number", object())]
    neg = ns.res.Deadline.from_header("-50", ns.FakeClock())
    return out + [neg is not None and neg.expired]


def deadline_cap_timeout(ns):
    clock = ns.FakeClock()
    d = ns.res.Deadline.after_ms(100, clock)
    out = [round(d.cap_timeout(60.0), 9), round(d.cap_timeout(0.05), 9)]
    clock.advance(5)
    return out + [d.cap_timeout(60.0)]


def deadline_ambient_scope(ns):
    d = ns.res.Deadline.after_ms(100, ns.FakeClock())
    out = [ns.res.current_deadline() is None]
    with ns.res.deadline_scope(d):
        out.append(ns.res.current_deadline() is d)
    return out + [ns.res.current_deadline() is None]


# -- RetryPolicy --------------------------------------------------------------
def _policy(ns, sleeps, **kw):
    kw.setdefault("rng", random.Random(7))
    return ns.res.RetryPolicy(sleep=sleeps.append, **kw)


def retry_first_try(ns):
    sleeps = []
    return [_policy(ns, sleeps, attempts=3).call(lambda: 42), sleeps]


def retry_n_failures_then_ok(ns):
    sleeps, calls, retried = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("boom")
        return "ok"

    policy = _policy(ns, sleeps, attempts=3, base_delay_s=0.1, on_retry=retried.append)
    return [policy.call(flaky), len(calls), sleeps, retried]


def retry_full_jitter(ns):
    sleeps = []
    policy = _policy(ns, sleeps, attempts=6, base_delay_s=0.1, max_delay_s=0.5)

    def fail():
        raise ValueError("nope")

    out = [_raises(policy.call, fail), sleeps]
    return out + [all(0.0 <= s <= min(0.5, 0.1 * 2 ** i) for i, s in enumerate(sleeps))]


def retry_gives_up(ns):
    sleeps, calls = [], []

    def fail():
        calls.append(1)
        raise ConnectionError("down")

    return [_raises(_policy(ns, sleeps, attempts=4).call, fail), len(calls), sleeps]


def retry_predicate_gates(ns):
    sleeps, calls = [], []

    def fail():
        calls.append(1)
        raise ValueError("permanent")

    policy = _policy(ns, sleeps, attempts=5)
    out = _raises(policy.call, fail, should_retry=lambda e: "transient" in str(e))
    return [out, len(calls)]


def retry_deadline_bounds_schedule(ns):
    clock = ns.FakeClock()
    sleeps, calls = [], []

    def sleeping(s):
        sleeps.append(s)
        clock.advance(s)

    policy = ns.res.RetryPolicy(attempts=10, base_delay_s=0.2, max_delay_s=0.2,
                                rng=random.Random(3), sleep=sleeping, clock=clock)
    deadline = ns.res.Deadline.after_ms(300, clock)

    def fail():
        calls.append(1)
        clock.advance(0.05)
        raise ConnectionError("down")

    return [_raises(policy.call, fail, deadline=deadline), len(calls), sleeps]


def retry_attempts_positive(ns):
    return [_raises(ns.res.RetryPolicy, attempts=0)]


# -- CircuitBreaker -----------------------------------------------------------
def _breaker(ns, **kw):
    clock = ns.FakeClock()
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("reset_timeout_s", 30.0)
    return ns.res.CircuitBreaker("dep", clock=clock, **kw), clock


def breaker_opens_at_threshold(ns):
    b, _ = _breaker(ns)
    out = []
    for _ in range(3):
        b.record_failure()
        out.append((b.state, b.state_value, b.open_count))
    try:
        b.before_call()
    except ns.res.CircuitOpen as exc:
        out.append(round(exc.retry_after_s, 6))
    return out


def breaker_success_resets_count(ns):
    b, _ = _breaker(ns)
    for step in ("f", "f", "s", "f", "f"):
        b.record_failure() if step == "f" else b.record_success()
    return [b.state, b.snapshot()]


def breaker_half_open_probe_closes(ns):
    b, clock = _breaker(ns)
    for _ in range(3):
        b.record_failure()
    clock.advance(30.0)
    out = [b.state]
    b.before_call()
    b.record_success()
    return out + [b.state, b.open_count]


def breaker_probe_failure_reopens(ns):
    b, clock = _breaker(ns)
    for _ in range(3):
        b.record_failure()
    clock.advance(30.0)
    b.before_call()
    b.record_failure()
    out = [b.state, b.open_count]
    clock.advance(29.0)
    out.append(_raises(b.before_call))
    clock.advance(1.5)
    return out + [_raises(b.before_call), b.state]


def breaker_bounded_probes(ns):
    b, clock = _breaker(ns, half_open_probes=1)
    for _ in range(3):
        b.record_failure()
    clock.advance(31.0)
    return [_raises(b.before_call), _raises(b.before_call)]


def breaker_call_is_one_operation(ns):
    b, _ = _breaker(ns, failure_threshold=2)
    ran = []

    def boom():
        ran.append(1)
        raise RuntimeError("dead dependency")

    return [_raises(b.call, boom) for _ in range(3)] + [len(ran), b.snapshot()]


def breaker_snapshot_shape(ns):
    b, clock = _breaker(ns)
    out = [b.snapshot()]
    for _ in range(3):
        b.record_failure()
    clock.advance(12.5)
    return out + [b.snapshot()]


def breaker_from_env(ns):
    b = ns.res.CircuitBreaker.from_env(
        "x", env={"PIO_BREAKER_FAILURES": "2", "PIO_BREAKER_RESET_S": "7.5",
                  "PIO_BREAKER_HALF_OPEN_PROBES": "3"}, clock=ns.FakeClock())
    d = ns.res.CircuitBreaker.from_env("y", env={})
    return [b.name, b.failure_threshold, b.reset_timeout_s, b.half_open_probes,
            d.failure_threshold, d.reset_timeout_s, d.half_open_probes]


def breaker_guards_a_retried_delivery(ns):
    """The serving pattern: one breaker call wraps one retried delivery,
    so three attempts that end in success count as one success."""
    b, clock = _breaker(ns, failure_threshold=2)
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) % 3:
            raise ConnectionRefusedError("down")

    policy = _policy(ns, sleeps, attempts=3, base_delay_s=0.05)
    out = [_raises(b.call, policy.call, flaky), b.snapshot()]

    def dead():
        raise ConnectionRefusedError("down")

    out += [_raises(b.call, policy.call, dead) for _ in range(3)]
    return out + [b.snapshot(), sleeps]


# -- the fault harness ----------------------------------------------------------
def _fire(ns, site, **info):
    return _raises(ns.faults.fault_point, site, **info)


def faults_inactive(ns):
    ns.faults.deactivate()
    return [_fire(ns, "serving.feedback")]


def faults_kinds(ns):
    out = []
    for kind in ("refuse", "close", "reset"):
        with ns.faults.inject(ns.faults.FaultSpec("serving.feedback", kind)):
            out.append(_fire(ns, "serving.feedback"))
    out.append(issubclass(http.client.RemoteDisconnected, ConnectionResetError))
    return out


def faults_n_then_ok(ns):
    with ns.faults.inject(ns.faults.FaultSpec("serving.error_log", "refuse", times=2)) as plan:
        out = [_fire(ns, "serving.error_log") for _ in range(4)]
        return out + [plan.fired(), plan.fired("serving.error_log"), plan.hits("serving.error_log")]


def faults_site_and_when_filters(ns):
    spec = ns.faults.FaultSpec("serving.predict", "reset",
                               when=lambda info: info.get("instance") == "bad")
    with ns.faults.inject(spec) as plan:
        out = [_fire(ns, "serving.feedback"), _fire(ns, "serving.predict", instance="ok"),
               _fire(ns, "serving.predict", instance="bad")]
        return out + [plan.hits("serving.predict"), plan.fired()]


def faults_latency_sleeps(ns):
    slept = []
    with ns.faults.inject(ns.faults.FaultSpec("serving.predict", "latency", arg=50.0),
                          sleep=slept.append):
        ns.faults.fault_point("serving.predict")
    return [slept]


def faults_parse(ns):
    specs = ns.faults.parse("serving.feedback=refuse*3; serving.predict=latency:50")
    out = [(s.site, s.kind, s.arg, s.times) for s in specs]
    return out + [_raises(ns.faults.parse, "nonsense"), _raises(ns.faults.parse, "a=explode")]


SCENARIOS = {f.__name__: f for f in (
    deadline_counts_down, deadline_check_names_its_stage, deadline_header_is_relative,
    deadline_bad_headers, deadline_cap_timeout, deadline_ambient_scope,
    retry_first_try, retry_n_failures_then_ok, retry_full_jitter, retry_gives_up,
    retry_predicate_gates, retry_deadline_bounds_schedule, retry_attempts_positive,
    breaker_opens_at_threshold, breaker_success_resets_count, breaker_half_open_probe_closes,
    breaker_probe_failure_reopens, breaker_bounded_probes, breaker_call_is_one_operation,
    breaker_snapshot_shape, breaker_from_env, breaker_guards_a_retried_delivery,
    faults_inactive, faults_kinds, faults_n_then_ok, faults_site_and_when_filters,
    faults_latency_sleeps, faults_parse,
)}

#: what the JAX package's own tests pin, per scenario
EXPECTED = {
    "deadline_counts_down": [250.0, 50.0, False, True],
    "deadline_bad_headers": [None, None, None, None, True],
    "deadline_cap_timeout": [0.1, 0.05, 0.001],
    "deadline_ambient_scope": [True, True, True],
    "retry_first_try": [42, []],
    "retry_attempts_positive": [("raised", "ValueError")],
    "breaker_bounded_probes": [("ok", None), ("raised", "CircuitOpen")],
    "faults_inactive": [("ok", None)],
    "faults_latency_sleeps": [[0.05]],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_matches_the_jax_package(name):
    scenario = SCENARIOS[name]
    try:
        want = scenario(JAX)
        got = scenario(PORT)
    finally:
        JAX.faults.deactivate()
        PORT.faults.deactivate()
    assert got == want
    if name in EXPECTED:
        assert got == EXPECTED[name]


def test_the_scripts_reach_every_outcome():
    """The scripts are not vacuous: each state and failure kind shows."""
    jitter = SCENARIOS["retry_full_jitter"](PORT)
    assert jitter[0] == ("raised", "ValueError") and len(jitter[1]) == 5 and jitter[2]
    assert SCENARIOS["retry_n_failures_then_ok"](PORT)[:2] == ["ok", 3]
    assert SCENARIOS["retry_deadline_bounds_schedule"](PORT)[1] < 5
    assert SCENARIOS["retry_predicate_gates"](PORT) == [("raised", "ValueError"), 1]
    opened = SCENARIOS["breaker_opens_at_threshold"](PORT)
    assert [s for s, _, _ in opened[:3]] == ["closed", "closed", "open"]
    assert opened[2][1] == 2 and opened[3] == 30.0
    assert SCENARIOS["breaker_half_open_probe_closes"](PORT) == ["half-open", "closed", 1]
    reopened = SCENARIOS["breaker_probe_failure_reopens"](PORT)
    assert reopened[:3] == ["open", 2, ("raised", "CircuitOpen")]
    assert SCENARIOS["breaker_call_is_one_operation"](PORT)[:4] == [
        ("raised", "RuntimeError"), ("raised", "RuntimeError"), ("raised", "CircuitOpen"), 2]
    assert SCENARIOS["breaker_from_env"](PORT) == ["x", 2, 7.5, 3, 5, 30.0, 1]
    delivery = SCENARIOS["breaker_guards_a_retried_delivery"](PORT)
    assert delivery[0] == ("ok", None) and delivery[1]["consecutiveFailures"] == 0
    assert delivery[-2]["state"] == "open" and delivery[4] == ("raised", "CircuitOpen")
    assert SCENARIOS["faults_kinds"](PORT) == [
        ("raised", "ConnectionRefusedError"), ("raised", "RemoteDisconnected"),
        ("raised", "ConnectionResetError"), True]
    assert SCENARIOS["faults_n_then_ok"](PORT)[-3:] == [2, 2, 4]
    assert SCENARIOS["faults_parse"](PORT)[0] == ("serving.feedback", "refuse", 0.0, 3)
    PORT.faults.deactivate()


def test_env_activation_arms_the_ports_harness(monkeypatch):
    import importlib

    monkeypatch.setenv("PIO_FAULTS", "serving.predict=refuse*1")
    reloaded = importlib.reload(port_faults)
    try:
        assert _raises(reloaded.fault_point, "serving.predict") == (
            "raised", "ConnectionRefusedError")
        assert _raises(reloaded.fault_point, "serving.predict") == ("ok", None)
    finally:
        reloaded.deactivate()
