#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It drives
``predictionio_tpu_torch`` (never jax, never ``predictionio_tpu``) on
``cuda:0`` and prints one JSON line per phase:

1. ``device``  — the card (``nvidia-smi`` name and power limit), torch
   and CUDA versions, the TF32 state (off).
2. ``build``   — compiles every kernel under
   ``predictionio_tpu_torch/kernels/csrc`` with nvcc (set-up time).
3. ``kernel``  — the streaming top-k kernel against its plain PyTorch
   version on the card at the serving slice's shapes (B in {1, 64, 1024},
   N = 27,000, R = 50, k = 16) and at the edge cases (64 exclusions,
   k > N, rows with every item excluded, duplicated item rows, k = 1024);
   scores agree to rtol 1e-5 / atol 1e-5 and ids are equal or tied. Each
   shape prints the kernel's, the plain version's and ``torch.topk(q @
   items.T)``'s times (CUDA events) beside the bound.
4. ``slice``   — the main path: a seeded rank-50 ALS model at ML-20M width
   (138,000 users x 27,000 items) persisted as a COMPLETED engine instance
   with the default ``streaming_top_k`` ("auto"), served by
   ``create_query_server`` on the card; bursts of 64 concurrent
   ``POST /queries.json`` (two unknown users), every answer checked
   against the plain version — the last burst's requests (and nothing
   else) under ``torch.profiler``, to show how busy the device was — then
   ``/status.json`` ``topkPath`` is streaming and the HTTP bursts launched
   the kernel, and a direct 1,024-user ``batch_predict`` streams too. The
   kernel's launch count is reset just before the first burst and read
   after the last batch.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line,
and as the last line ``{"ok": true, "device": {...}}``. Any failed phase
raises and exits non-zero before the last line; without CUDA (or outside
a checkout of the repo) it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import http.client
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: H100 SXM data sheet: device memory rate and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
RTOL = ATOL = 1e-5
#: the serving slice: ML-20M width (bench.py's ALS shape) at rank 50
N_USERS, N_ITEMS, RANK = 138000, 27000, 50
HTTP_QUERIES, HTTP_ROUNDS = 64, 2
TOPK_SOURCE = "predictionio_tpu_torch/kernels/csrc/topk_streaming.cu"
TOPK_REPLACES = "predictionio_tpu/ops/pallas_kernels.py:67"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def topk_bound(b: int, n: int, r: int, k: int, e: int = 0):
    """Least time for one top-k call: each input read once, each output
    written once, over the memory rate; 2·B·N·R FLOPs over the fp32 peak.
    Returns (ms, "bytes" | "operations")."""
    moved = 4.0 * (b * r + n * r + b * e) + 8.0 * b * k
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = 2.0 * b * n * r / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(torch, fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` (CPU + CUDA activity) and say
    where its wall time went: the union of device activity intervals
    (kernels, copies, memsets) as a share of the wall, and the device ops
    that took the most time. The share is null when the profiler saw no
    device activity (then it was not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        result = fn()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + stop - start, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        "result": result,
        "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_us / 1e3 if spans else None,
        "device_busy_share": busy_us / 1e6 / wall_s if spans else None,
        "device_ops": len(spans),
        "top_device_ops": [
            {"name": name[:90], "ms": t / 1e3, "count": c}
            for name, (t, c) in top
        ],
    }


def agreement(got, want):
    """(max abs score error, ok): scores to RTOL/ATOL, ids equal or tied,
    and every -inf slot carrying -1."""
    s_k, i_k = (t.cpu().numpy() for t in got)
    s_p, i_p = (t.cpu().numpy() for t in want)
    if s_k.shape != s_p.shape or i_k.shape != i_p.shape:
        return float("inf"), False
    close = np.isclose(s_k, s_p, rtol=RTOL, atol=ATOL)
    ok = bool(
        close.all()
        and ((i_k == i_p) | close).all()
        and ((i_k == -1) == np.isneginf(s_k)).all()
        and not np.isnan(s_k).any()
    )
    both = np.isfinite(s_k) & np.isfinite(s_p)
    err = float(np.abs(s_k[both] - s_p[both]).max()) if both.any() else 0.0
    return err, ok


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({
        "phase": "device",
        "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "capability": list(torch.cuda.get_device_capability(0)),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    })
    return smi


def phase_build() -> None:
    from predictionio_tpu_torch.kernels import build

    t0 = time.monotonic()
    compiled = build.build_all()
    libs = {name: build.load_library(name)._name for name in build.kernel_names()}
    emit({
        "phase": "build",
        "compiled": compiled,
        "libraries": {k: v.split("/")[-1] for k, v in libs.items()},
        "seconds": time.monotonic() - t0,
    })


def phase_kernel(torch, dev, rng) -> dict:
    from predictionio_tpu_torch.ops.cuda_kernels import (
        TOPK_MAX_K,
        top_k_streaming,
        top_k_streaming_reference,
    )

    def tensors(b, n, r, dup=False):
        q = rng.standard_normal((b, r), dtype=np.float32)
        items = rng.standard_normal((n, r), dtype=np.float32)
        if dup:  # every odd row repeats its even neighbour: exact ties
            items[1::2] = items[0::2][: items[1::2].shape[0]]
        return (torch.from_numpy(q).to(dev), torch.from_numpy(items).to(dev))

    def check(name, q, items, k, excl=None, timed=False):
        before = top_k_streaming.launches
        got = top_k_streaming(q, items, k, excl)
        torch.cuda.synchronize()
        want = top_k_streaming_reference(q, items, k, excl)
        err, ok = agreement(got, want)
        b, r = q.shape
        n = items.shape[0]
        e = 0 if excl is None else excl.shape[1]
        out = {"case": name, "B": b, "N": n, "R": r, "k": k, "E": e,
               "max_abs_err": err, "agree": ok}
        if timed:
            out["kernel_ms"] = time_ms(
                torch, lambda: top_k_streaming(q, items, k, excl))
            out["plain_ms"] = time_ms(
                torch, lambda: top_k_streaming_reference(q, items, k, excl))
            out["library_ms"] = time_ms(
                torch, lambda: torch.topk(q @ items.T, k, dim=1))
            bound_ms, bound_by = topk_bound(b, n, r, k, e)
            out["bound_us"] = bound_ms * 1e3
            out["bound_by"] = bound_by
        out["launches"] = top_k_streaming.launches - before
        emit({"phase": "kernel", **out})
        if not ok:
            raise AssertionError(f"top-k kernel disagrees with plain: {out}")
        return out

    n, r, k = 27000, 50, 16
    q_all, items = tensors(1024, n, r)
    main = {}
    for b in (1, 64, 1024):
        main[b] = check(f"main_B{b}", q_all[:b].contiguous(), items, k, timed=True)
    excl = rng.integers(-1, n, size=(64, 64)).astype(np.int32)
    check("exclusions_E64", q_all[:64].contiguous(), items, k,
          torch.from_numpy(excl).to(dev), timed=True)
    small_q, small_items = tensors(8, 10, r)
    check("k_above_catalog", small_q, small_items, k)
    eq, eitems = tensors(8, 100, r)
    all_excl = np.tile(np.arange(100, dtype=np.int32), (8, 1))
    all_excl[1::2, 50:] = -1  # odd rows keep half the catalog
    check("all_excluded_rows", eq, eitems, k, torch.from_numpy(all_excl).to(dev))
    dq, ditems = tensors(32, 1000, r, dup=True)
    check("duplicated_rows_ties", dq, ditems, k)
    check("ragged_tile_N1000", *tensors(16, 1000, r), k)
    check("k1024", q_all[:4].contiguous(), items, 1024, timed=True)
    try:
        top_k_streaming(q_all[:1].contiguous(), items, TOPK_MAX_K + 1)
    except ValueError:
        emit({"phase": "kernel", "case": "k_above_ceiling", "raised": True})
    else:
        raise AssertionError("k above the kernel ceiling did not raise")
    return main


def _post_query(port: int, body: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        t0 = time.monotonic()
        conn.request("POST", "/queries.json", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, json.loads(data), time.monotonic() - t0
    finally:
        conn.close()


def _get_json(port: int, path: str) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def phase_slice(torch, dev, seed: int) -> dict:
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models.recommendation import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        Query,
        als_model_from_numpy,
        engine_factory,
    )
    from predictionio_tpu_torch.ops.cuda_kernels import (
        top_k_streaming,
        top_k_streaming_reference,
    )
    from predictionio_tpu_torch.storage import StorageRegistry
    from predictionio_tpu_torch.workflow import (
        ServerConfig,
        create_query_server,
        persist_instance,
    )

    rng = np.random.default_rng(seed)
    n_users, n_items, rank = N_USERS, N_ITEMS, RANK
    t0 = time.monotonic()
    model = als_model_from_numpy(
        rank,
        0.3 * rng.standard_normal((n_users, rank), dtype=np.float32),
        0.3 * rng.standard_normal((n_items, rank), dtype=np.float32),
        [f"u{i}" for i in range(n_users)],
        [f"i{i}" for i in range(n_items)],
    )
    uf = torch.from_numpy(model.user_factors).to(dev)
    itf = torch.from_numpy(model.item_factors).to(dev)

    def plain(users, k):
        idx = torch.tensor(users, device=dev, dtype=torch.long)
        s, i = top_k_streaming_reference(uf[idx].contiguous(), itf, k)
        return s.cpu().numpy(), i.cpu().numpy()

    def same_answer(items_scores, want_s, want_i, num) -> bool:
        k = min(num, n_items)
        if len(items_scores) != k:
            return False
        got_s = np.array([x["score"] for x in items_scores], dtype=np.float32)
        got_i = np.array([int(x["item"][1:]) for x in items_scores])
        close = np.isclose(got_s, want_s[:k], rtol=RTOL, atol=ATOL)
        return bool(close.all() and ((got_i == want_i[:k]) | close).all())

    with tempfile.TemporaryDirectory(prefix="pio_chip_smoke_") as base:
        registry = StorageRegistry({"PIO_FS_BASEDIR": base})
        params = ALSAlgorithmParams(rank=rank)  # streaming_top_k "auto"
        instance_id = persist_instance(
            registry,
            EngineParams(algorithm_params_list=[("als", params)]),
            [model],
        )
        setup_s = time.monotonic() - t0
        server = create_query_server(
            engine_factory(),
            ServerConfig(ip="127.0.0.1", port=0, device=dev),
            registry=registry,
            block=False,
        )
        try:
            port = server.bound_port

            def burst():
                """One burst of concurrent queries: (users, bodies,
                answers, wall seconds)."""
                users = rng.choice(n_users, size=HTTP_QUERIES - 2, replace=False)
                bodies = [{"user": f"u{u}", "num": 1 + j % 50}
                          for j, u in enumerate(users)]
                bodies += [{"user": "nobody-1", "num": 5},
                           {"user": "nobody-2", "num": 50}]
                t_burst = time.monotonic()
                with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
                    answers = list(pool.map(lambda b: _post_query(port, b), bodies))
                return users, bodies, answers, time.monotonic() - t_burst

            def checked(rnd, users, bodies, answers, wall):
                """Every answer of a burst against the plain version."""
                want_s, want_i = plain(users.tolist(), 50)
                bad = []
                for j, (body, (status, data, _)) in enumerate(zip(bodies, answers)):
                    if status != 200:
                        bad.append((body, status, data))
                    elif j >= len(users):
                        if data != {"itemScores": []}:
                            bad.append((body, data))
                    elif not same_answer(data["itemScores"], want_s[j], want_i[j],
                                         body["num"]):
                        bad.append((body, data["itemScores"][:3]))
                if bad:
                    raise AssertionError(f"served answers disagree: {bad[:3]}")
                lat = np.array([a[2] for a in answers]) * 1e3
                return {
                    "round": rnd, "queries": len(bodies), "wrong": len(bad),
                    "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99)),
                    "max_ms": float(lat.max()),
                    "burst_wall_ms": wall * 1e3,
                }

            top_k_streaming.launches = 0  # main path starts here
            rounds = [checked(rnd, *burst()) for rnd in range(HTTP_ROUNDS)]
            # one more burst, its requests alone under the profiler: where
            # the time goes; its answers are checked after the profiler
            profiled = device_profile(torch, burst)
            rounds.append(checked(HTTP_ROUNDS, *profiled.pop("result")))
            http_launches = top_k_streaming.launches
            status = _get_json(port, "/status.json")
            paths = set((status.get("topkPath") or {}).values())
            if paths != {"streaming"}:
                raise AssertionError(f"topkPath {status.get('topkPath')}")
            if http_launches < 1:
                raise AssertionError("the HTTP path launched the kernel 0 times")
        finally:
            server.shutdown()
            server.server_close()

    auto = ALSAlgorithm(ALSAlgorithmParams(rank=rank), device=dev)
    users = rng.choice(n_users, size=1024, replace=False)
    queries = [(j, Query(user=f"u{u}", num=10)) for j, u in enumerate(users)]
    before = top_k_streaming.launches
    t1 = time.monotonic()
    results = dict(auto.batch_predict(model, queries))  # attaches the model
    attach_and_batch_s = time.monotonic() - t1
    t2 = time.monotonic()
    again = dict(auto.batch_predict(model, queries))
    warm_batch_s = time.monotonic() - t2
    direct_launches = top_k_streaming.launches - before
    total_launches = top_k_streaming.launches  # main path ends here
    if auto.topk_path != "streaming" or direct_launches < 1:
        raise AssertionError(
            f"1024-user batch took {auto.topk_path!r}, "
            f"{direct_launches} launches"
        )
    want_s, want_i = plain(users.tolist(), 10)
    wrong = [
        j for j in range(len(users))
        if not same_answer(
            [{"item": x.item, "score": x.score} for x in results[j].item_scores],
            want_s[j], want_i[j], 10,
        )
    ]
    if wrong or again != results:
        raise AssertionError(f"direct batch answers disagree at rows {wrong[:5]}")
    out = {
        "phase": "slice",
        "users": n_users, "items": n_items, "rank": rank,
        "instance": instance_id,
        "setup_s": setup_s,
        "http": rounds,
        "http_profiled": profiled,
        "http_launches": http_launches,
        "status_topkPath": status.get("topkPath"),
        "status_stats": status.get("stats"),
        "batching": status.get("batching"),
        "direct_batch": {"users": len(users), "topk_path": auto.topk_path,
                         "launches": direct_launches,
                         "attach_and_batch_s": attach_and_batch_s,
                         "warm_batch_s": warm_batch_s},
        "launches": total_launches,
    }
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port "
              "runs on an NVIDIA card", file=sys.stderr)
        return 2
    # outside a checkout this import fails, and the run with it
    import predictionio_tpu_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    smi = phase_device(torch)
    phase_build()
    main_shapes = phase_kernel(torch, dev, np.random.default_rng(args.seed))
    sliced = phase_slice(torch, dev, args.seed)

    ref = main_shapes[1024]
    bound_ms, bound_by = topk_bound(ref["B"], ref["N"], ref["R"], ref["k"])
    emit({"kernels": [{
        "name": "topk_streaming",
        "route": "cuda",
        "source": TOPK_SOURCE,
        "replaces": TOPK_REPLACES,
        "launches": sliced["launches"],
        "max_abs_err": max(m["max_abs_err"] for m in main_shapes.values()),
        "ms": ref["kernel_ms"],
        "plain_ms": ref["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": ref["library_ms"],
        "shape": {k: ref[k] for k in ("B", "N", "R", "k")},
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
