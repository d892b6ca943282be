#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It drives
``predictionio_tpu_torch`` (never jax, never ``predictionio_tpu``) on
``cuda:0`` and prints one JSON line per phase:

1. ``device``  — the card (``nvidia-smi`` name and power limit), torch
   and CUDA versions, the TF32 state (off).
2. ``build``   — compiles every kernel under
   ``predictionio_tpu_torch/kernels/csrc`` with nvcc and every host
   library under ``predictionio_tpu_torch/native`` (bucketize, eventlog,
   idhash) with g++, one process per source, all at once (set-up time).
   A library that does not build fails the run.
3. ``kernel``  — the streaming top-k kernel against its plain PyTorch
   version on the card at the serving slice's shapes (B in {1, 64, 1024},
   N = 27,000, R = 50, k = 16) and at the edge cases (64 exclusions,
   k > N, rows with every item excluded, duplicated item rows, a catalog
   whose scores rise with the index, a served batch of 512 at k = 128,
   k = 1024, k = 2048; k = 4096 on 5,000 items, its lists merged in
   shared memory, and k = N = 27,000 with 64 exclusions a query, merged in
   device memory); scores agree to rtol 1e-5 / atol 1e-5 and ids are
   equal or tied. Each case prints its launch plan (tiles
   per stage-1 block, lists per query); each timed shape prints the
   kernel's, the plain version's and ``torch.topk(q @ items.T)``'s times
   per call (CUDA events) and, for the kernel and the library call, on
   the device alone (``torch.profiler``), beside the bound.
4. ``data``    — ML-20M-shaped synthetic ratings (a copy of ``bench.py``'s
   generator at scale 1 from ``--seed``, 5 % held out as the bench does),
   bucketized both ways and index-sorted by the native library (its
   thread count printed), staged on the card; then the numpy bucketize
   and sort once on the same arrays, timed, and held bit for bit against
   the native slabs, both sides, every bucket.
5. ``train_kernels`` — the gather+Gramian kernel and the batched SPD
   solve kernel against their plain versions on the card: both kernels'
   registers and spills (``cudaFuncGetAttributes``: they must match the
   launch plans' ``GRAMIAN_REGS`` and ``SPD_REGS``, with no local memory
   in any kernel), every bucket of both sides as training launches it (R
   = 50; the systems the build kernel wrote are what the solve kernel
   solves; each line with its launch plan and its event and device times
   beside the einsum build's or ``cholesky_solve``'s, the solve's with
   its bound (A's upper triangle, what it reads) and, for comparison
   with the first version's rows, the whole A's), the solve
   at B in {128, 16,384, 138,000}, and the edge cases (zero-weight rows,
   a YtY base, a bf16-rounded table, R = 13, K = 1, a 32,768-rating row;
   split rows at K = 8,193 ending inside a chunk and a tile, weights in
   the last chunk only, zero-weight slots inside the prefix, empty rows
   exactly zero, a NaN factor row kept in its row, K = 32,768 split, two
   calls bit-identical; zero systems, a singular PSD system, n = 128,
   n in {1, 8, 13, 33, 64} on the registers path and 65 on the
   shared one, B = 1, a NaN lower triangle solving as its symmetric
   twin, a NaN system kept in its system, two calls bit-identical, n =
   129 on the wide path). The build agrees to rtol/atol 1e-4 with A
   exactly symmetric, the solve to relative error 1e-4.
6. ``train``   — the main path: ``workflow.run_train`` trains the port's
   recommendation engine (ALS, rank 50, 10 iterations, λ 0.05, seed 0) on
   the card from a DataSource over the training split. The two training
   kernels' launch counts are reset just before it and read just after;
   both must launch every iteration, and its host preparation must have
   taken the native path (``host_prep_s.path``). Then: per-iteration times, train and
   holdout RMSE (holdout ≤ 0.62, the bench's gate), one more iteration
   under ``torch.profiler``, and 3 iterations through the kernels against
   3 through their plain versions from one initial table (factors rtol
   2e-3 / atol 2e-4, train RMSE within 1e-3).
7. ``slice``   — serving: the instance ``run_train`` wrote, deployed by
   ``create_query_server`` on the card with the default
   ``streaming_top_k`` ("auto"); bursts of 64 concurrent
   ``POST /queries.json`` (two unknown users), every answer checked
   against the plain version — the last burst's requests (and nothing
   else) under ``torch.profiler``, to show how busy the device was — then
   ``/status.json`` ``topkPath`` is streaming and the HTTP bursts launched
   the kernel, and a direct 1,024-user ``batch_predict`` streams too. The
   top-k kernel's launch count is reset just before the first burst and
   read after the last batch.

8. ``attention_kernel`` — the flash-attention kernel against its plain
   PyTorch version on the card (rtol 2e-4 / atol 2e-5, the JAX
   ``TestFlashPallas`` tolerance). First every instantiation's registers
   and local bytes (``flash_kernel_attributes``; any local memory fails).
   Then, each case with its launch plan (``bq``, threads, micro-tiles,
   shared bytes, blocks an SM, waves): the training shape (64, 4, 64, 16)
   and the serving shape (1, 4, 64, 16), causal; ``TestFlashPallas``'s
   four shapes causal and not; cross-attention Lq != Lk (70/300, 300/70,
   2048/1000, 1000/2048); a ragged last tile after many (L = 2049); (8,
   4, 2048, 64) causal and not (many tiles, causal skipping, heavy tiles
   first); every head width 8..128 at both query tiles; head widths that
   are not a multiple of 8 (D = 6, 12, 15, 100, zero-padded by the wrapper
   and scaled by the true D), the training shape at D = 6 and 15 timed;
   D = 136 on the wide-head path.
   Two calls are compared bit for bit at the training and long shapes.
   The timed shapes print the kernel's, the plain version's and
   ``F.scaled_dot_product_attention``'s times beside the bound, each both
   per call (CUDA events) and on the device alone (``torch.profiler``);
   SDPA is a yardstick only: the port never calls it.
9. ``seqrec_train`` — the main path of the sequence recommender:
   ``workflow.run_train`` of the port's seqrec engine at the template's
   defaults (d_model 64, 4 heads, 2 layers, seq_len 64, stride 32, batch
   64, 300 steps, lr 1e-3, seed 0) from a DataSource over synthetic
   time-ordered histories of ML-1M's published shape (6,040 users, 3,706
   items, 1,000,209 interactions, at least 20 per user, Zipf-like item
   popularity, next item ``(prev + 1) mod V`` with probability 0.5) made
   from ``--seed``. The attention launch count is reset just before
   ``run_train`` and read just after: it must be 2 × 300. Then the step
   time, the first and last losses (the last 20 steps' mean below the
   first step's), one step under ``torch.profiler``, 3 steps through the
   kernel against 3 through the plain attention from one initial table
   (``embed``, ``pos`` and a fixed batch's logits to rtol 1e-3 / atol
   1e-4) and, for information, the in-sample HR@10 of 1,000 users' last
   item beside the most-popular baseline.
10. ``seqrec_slice`` — the instance ``run_train`` wrote, deployed by
   ``create_query_server`` on the card; three bursts of 64 concurrent
   ``POST /queries.json`` (by user, by ``recent_items``, an unknown user
   and unknown items; the last burst under ``torch.profiler``), every
   answer checked against the plain attention's forward on the same card
   (the same items in the same order, scores rtol 1e-4 / atol 1e-5). The
   attention launch count, reset just before the first burst and read
   after the last, must be 2 × the forwards served.

11. ``events`` — the training infeed from events: ML-1M-shaped ``rate``
   events from ``synth_ml1m_histories(--seed)`` (6,040 users ``u<n>``,
   3,706 items ``i<n>``, 1,000,209 events, a seeded rating each, event
   times rising by one second) bulk-written into a native event log
   through the registry's ``native`` family (``PIO_STORAGE_*`` pointing
   EVENTDATA at it); 1,010 of them through ``create_event_server`` over a
   SQLite app with an access key (20 batch POSTs of 50, 10 single POSTs,
   one repeated with its ``idempotencyKey``), read back by filter and by
   id, one deleted, the 401 path and ``/stats.json``; ``stream_ratings``
   on the log (the C++ ratings scan) held exactly against the chunked
   path and the events written; ALS at rank 50 trained by ``run_train``
   through ``RecDataSource`` (build and solve launches counted), deployed
   and a burst of 64 queries by string user id held to the plain top-k
   (top-k launches counted); ``SeqDataSource.read_training`` equal to the
   generator's histories, then a seqrec ``run_train`` of 20 steps from it
   (2 × 20 attention launches). Each stage's seconds are printed.
12. ``eval`` — evaluation over the same store: ``tools.run_workflow.run``
   (``pio eval``'s entry point) sweeps the recommendation template's
   ``RecEvaluation`` × ``RecParamsGenerator`` from an engine project's
   ``evaluation.py`` (rank 8 and 16 × λ 0.01 and 0.1, 10 iterations; 1 of
   every 4 ratings held out, 250,053 queries from 1,000,209 events). The
   top-k, build and solve launch counts are reset just before the call
   and read just after. Each stage's seconds (``read_eval``, train and
   ``batch_predict`` per candidate, the top-k call, the metric, the whole
   run), Precision@10 per candidate and the best one; the evaluation
   instance is EVALCOMPLETED and ``best.json`` names the best candidate.
   Held: every served answer against ``torch.topk(uf[idx] @ itf.T)`` on
   the card (0 wrong ids outside ties, rtol/atol 1e-5), Precision@10 from
   the oracle's ids equal to the evaluator's but for queries whose actual
   item ties the 10th score, the build and the solve at ranks 8 and 16
   against their plain versions on every users' bucket (the tolerances of
   ``train_kernels``), and the top-k at the padded B = 262,144 timed
   beside its bound. Then ``Engine.eval`` of the sequence template's
   leave-one-out split (6,040 queries, 300 training steps): attention
   launches = 2 × (steps + forwards), the first 64 answers equal the
   plain forward's, ids exactly; HR@10 for information.
13. ``persist`` — the DASE persistence contract over the same store,
   with a user's ``engine.py`` loaded through ``workflow/loader.py``
   (ALS rank 50, 10 iterations, seed 0): (a) an algorithm whose
   ``make_persistent`` returns ``RETRAIN`` is stored as the sentinel
   alone and trained again when ``create_query_server`` deploys it (the
   build and solve launches reset just before the deploy and read just
   after it equal training's; the retrained factors equal the trained
   ones bit for bit); (b) a model that saves its own tables (atomically)
   is stored as a ``PersistentModelManifest`` and deploys with no build
   and no solve, its factors equal to the saved ones; each serves 64
   queries held to the plain top-k. Then implicit-preference and bf16
   ALS trained by ``run_train`` (3 iterations) against 3 iterations of
   the plain build and solve (rtol 2e-3 / atol 2e-4; bf16 within the JAX
   package's own spread, max |Δ| 8.8e-3 and relative norm 2e-3); seqrec
   at d_model 24 / 4 heads (D = 6), 20 steps, served for 64 queries
   against the plain forward; and one ``POST /queries.json`` with ``num``
   = 4096 to the slice phase's ML-20M-shaped instance, its 4,096 items
   held to the plain top-k. Each stage's seconds are printed.
14. ``kernel_large`` — the top-k at B = 262,144 and at B = 600,000 (above
   one launch's 524,280 queries: two launches into one output), N =
   3,706, R = 16, k = 16, and at B = 32,768, k = 256 over 27,000 items
   (the per-tile path, cut into launches whose scratch stays within the
   wrapper's 2 GiB budget), held against the plain version in chunks (0
   wrong ids outside ties) and timed beside the plain version (in those
   chunks), ``torch.topk(q @ items.T)`` and the bound.

15. ``wide`` — the general-width paths, over the events phase's store:
   the build at R = 129, 200, 256 at ML-20M's bucket shapes (the users'
   K = 128 bucket of 97,972 rows in the slices the systems budget cuts it
   into, the items' K = 32,768 bucket of 216 rows), each timed whole and
   held to the plain version on its first 4,096 rows (rtol/atol 1e-4, A
   exactly symmetric, two calls bit-identical), a split bucket; the solve
   at n = 129, 200, 256 (B = 4,096, relative error 1e-4, bit-identical),
   zero and singular systems, n = 400 through the device-memory scratch;
   attention at D = 136, 192, 256 at the training shape and at L = 2,048
   causal and not (rtol 2e-4 / atol 2e-5, bit-identical), each timed beside
   the plain version, the library call and the bound; every general-width
   kernel's registers and local bytes (no local memory). Then ALS at rank
   200 by ``run_train`` from the store (3 iterations, build and solve
   launches counted) held to 3 plain iterations (rtol 2e-3 / atol 2e-4),
   with the holdout RMSE of 3 iterations on 95 % of the ratings; seqrec at
   d_model 256 / 1 head (D = 256) by ``run_train`` (20 steps) and served
   for a burst held to the plain forward, attention launches counted.
16. ``console`` — the quickstart's lifecycle through ``python -m
   predictionio_tpu_torch.tools.console``, each command its own process:
   ``app new``, ``import`` of ``examples/movielens_quickstart/gen_events.py``'s
   events, ``template get recommendation``, ``build``, ``train`` (rank 50,
   10 iterations; its build and solve launches are the process's own),
   ``deploy --spawn``, 64 queries whose ids equal ``torch.topk`` over the
   stored factors (ties allowed; the top-k launches read off the server's
   ``/status.json`` before and after), ``undeploy`` and the port free
   again; beside it, at the same time, the sequence template at its
   defaults over the events phase's app, deployed and its burst held to
   the plain forward.

Then the phases' wall times, one ``{"kernels": [...]}`` line, the
``nvidia-smi`` name/power line, and as the last line ``{"ok": true,
"device": {...}}``. Any failed phase raises and exits non-zero before the
last line; without CUDA (or outside a checkout of the repo) it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import http.client
import json
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: H100 SXM data sheet: device memory rate and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
RTOL = ATOL = 1e-5
#: ML-20M width (bench.py's ALS shape) at rank 50
N_USERS, N_ITEMS, RANK = 138000, 27000, 50
HTTP_QUERIES, HTTP_ROUNDS = 64, 2
TOPK_SOURCE = "predictionio_tpu_torch/kernels/csrc/topk_streaming.cu"
TOPK_REPLACES = "predictionio_tpu/ops/pallas_kernels.py:67"
GRAMIAN_SOURCE = "predictionio_tpu_torch/kernels/csrc/gramian_fused.cu"
GRAMIAN_REPLACES = "predictionio_tpu/ops/pallas_kernels.py:370"
SPD_SOURCE = "predictionio_tpu_torch/kernels/csrc/spd_solve.cu"
SPD_REPLACES = "predictionio_tpu/ops/pallas_kernels.py:248"
#: training: bench.py's ALS configuration (bench.py:738-741)
TRAIN_ITERS, PARITY_ITERS, LAMBDA, TRAIN_SEED = 10, 3, 0.05, 0
KERNEL_TOL = 1e-4  # build rtol/atol and solve relative error, kernel vs plain
FACTOR_RTOL, FACTOR_ATOL, RMSE_TOL = 2e-3, 2e-4, 1e-3
HOLDOUT_GATE = 0.62  # bench.py:854
#: batch sizes of the solve kernel's fixed-shape checks (the largest is
#: every user system of one iteration)
SPD_BATCHES = (128, 16384, 138000)
FLASH_SOURCE = "predictionio_tpu_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "predictionio_tpu/ops/attention.py:72"
ATTN_RTOL, ATTN_ATOL = 2e-4, 2e-5  # test_attention.py TestFlashPallas
#: the sequence recommender at the template's defaults
#: (predictionio_tpu/models/sequencerec.py:150-217, tools/templates.py:88-106)
SEQ_PARAMS = dict(d_model=64, n_heads=4, n_layers=2, steps=300, batch_size=64,
                  learning_rate=1e-3, seed=0)
SEQ_LEN, SEQ_STRIDE = 64, 32
#: ML-1M's published shape: users, items, interactions, least per user
ML1M_USERS, ML1M_ITEMS, ML1M_INTERACTIONS, ML1M_MIN_PER_USER = 6040, 3706, 1000209, 20
SEQ_PARITY_STEPS = 3
SEQ_TRAIN_RTOL, SEQ_TRAIN_ATOL = 1e-3, 1e-4  # test_sequencerec.py:240-244
SEQ_SERVE_RTOL, SEQ_SERVE_ATOL = 1e-4, 1e-5
HR_USERS, SEQ_HTTP_ROUNDS = 1000, 2
#: the events phase: the app of the bulk-written native log and of the
#: Event Server's SQLite store, its HTTP traffic (batches of 50, single
#: POSTs), the seqrec steps trained from the store, queries served
EVENTS_APP, HTTP_BATCHES, HTTP_BATCH, HTTP_SINGLES = 1, 20, 50, 10
EVENTS_SEQ_STEPS, EVENTS_WRITE_CHUNK = 20, 100_000
#: the top-k batches above and near one launch's cap: the eval phase's
#: padded batch of held-out queries and one that takes two launches, at
#: ML-1M's catalog, rank 16 (and the eval's rank 8), k 16; then one whose
#: per-tile scratch (k =
#: 256 at ML-20M's catalog, 434 KB a query) is cut by the wrapper's
#: budget into several launches (B, N, R, k); the plain version and the
#: oracle run in chunks of at most this many rows (and 2^28 scores)
TOPK_LARGE = ((262144, 3706, 16, 16), (262144, 3706, 8, 16), (600000, 3706, 16, 16),
              (32768, 27000, 50, 256))
ORACLE_CHUNK = 65536
#: the eval phase: the metric's cut-off and relevance threshold (the
#: template's), the seqrec answers held to the plain forward
EVAL_K, EVAL_THRESHOLD, EVAL_SEQ_HELD = 10, 4.0, 64
#: the eval phase's engine project: the recommendation template's
#: evaluation module as ``pio template get`` lays it out, writing the best
#: variant to best.json beside it
EVALUATION_PY = '''"""Precision@10 over the template's rank x lambda grid."""

import os

from predictionio_tpu_torch.models.recommendation import RecParamsGenerator  # noqa: F401
from predictionio_tpu_torch.models.recommendation import RecEvaluation as _Template


class RecEvaluation(_Template):
    def __init__(self):
        super().__init__()
        here = os.path.dirname(os.path.abspath(__file__))
        self.evaluator.output_path = os.path.join(here, "best.json")
'''


#: the persist phase's engine project: a user's ``engine.py`` with two
#: persistence choices, loaded through ``workflow/loader.py``
PERSIST_ENGINE_PY = '''"""The recommendation template with two persistence choices of a user's.

``retrain``: the template's ALS, whose model is not stored; deploy trains
it again from the event store. ``saved``: the template's ALS, whose model
writes its factor tables and id maps under ``models/`` beside this file
(each file replaced atomically) and reads them back at deploy.
"""

import io
import json
import os

import numpy as np

from predictionio_tpu_torch.controller import RETRAIN, Engine, FirstServing, PersistentModel
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.utils.durability import atomic_write_bytes

MODEL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "models")


class RetrainALS(rec.ALSAlgorithm):
    def make_persistent(self, instance_id, model, ctx):
        return RETRAIN


def _npy(array):
    buf = io.BytesIO()
    np.save(buf, array)
    return buf.getvalue()


class SavedALSModel(rec.ALSModel, PersistentModel):
    def save(self, instance_id, params, ctx):
        where = os.path.join(MODEL_DIR, instance_id)
        os.makedirs(where, exist_ok=True)
        ids = {"users": [self.user_map.inverse[i] for i in range(len(self.user_map))],
               "items": [self.item_map.inverse[i] for i in range(len(self.item_map))]}
        atomic_write_bytes(os.path.join(where, "user_factors.npy"), _npy(self.user_factors))
        atomic_write_bytes(os.path.join(where, "item_factors.npy"), _npy(self.item_factors))
        atomic_write_bytes(os.path.join(where, "ids.json"), json.dumps(ids).encode())
        return True

    @classmethod
    def load(cls, instance_id, params, ctx):
        where = os.path.join(MODEL_DIR, instance_id)
        with open(os.path.join(where, "ids.json")) as fh:
            ids = json.load(fh)
        m = rec.als_model_from_numpy(
            params.rank, np.load(os.path.join(where, "user_factors.npy")),
            np.load(os.path.join(where, "item_factors.npy")), ids["users"], ids["items"])
        return cls(m.rank, m.user_factors, m.item_factors, m.user_map, m.item_map)


class SavingALS(rec.ALSAlgorithm):
    def train(self, ctx, pd):
        m = super().train(ctx, pd)
        return SavedALSModel(m.rank, m.user_factors, m.item_factors, m.user_map, m.item_map)


def engine_factory():
    return Engine({"": rec.RecDataSource}, {"": rec.RecPreparator},
                  {"retrain": RetrainALS, "saved": SavingALS}, {"": FirstServing})
'''
#: the persist phase: the served num of fault B's end-to-end query; the
#: seqrec head width that is not a multiple of 8 (d_model 24 / 4 heads);
#: the JAX package's own spread between its bf16 ALS paths
#: (test_torch_als.py), which the bf16 run's factors are held to after its
#: iterations (its first user solve to rtol 2e-3 / atol 2e-4)
PERSIST_NUM, PERSIST_SEQ = 4096, dict(d_model=24, n_heads=4)
BF16_MAX_ABS = 8.8e-3


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


def gramian_bound(b: int, k: int, n: int, r: int, valid: int, yty: bool):
    """Least time for one gather+Gramian build: every input read once
    (the [N, R] table, idx/w2/rhs [B, K], ridge, yty) and A [B, R, R] and
    b [B, R] written once, over the memory rate; the symmetric build's
    R(R+1) + 2R FLOP for each rating that carries weight, over the fp32
    peak. Returns (ms, "bytes" | "operations")."""
    moved = 4.0 * (n * r + 3 * b * k + b + (r * r if yty else 0) + b * r * r + b * r)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = valid * (r * (r + 1) + 2.0 * r) / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def spd_bound(b: int, n: int, whole_a: bool = False):
    """Least time for one batched SPD solve: A's upper triangle [B,
    n(n+1)/2] (what the kernel needs) and b [B, n] read once, x [B, n]
    written once; B·(n³/3 + 2n²) FLOP. ``whole_a`` counts all of A
    [B, n, n] instead, as the first version read it (the bound PR 3's
    rows were held to)."""
    a_floats = n * n if whole_a else n * (n + 1) / 2
    t_bytes = 4.0 * b * (a_floats + 2 * n) / HBM_BYTES_PER_S
    t_ops = b * (n**3 / 3.0 + 2.0 * n * n) / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_attention_bound(b: int, h: int, lq: int, lk: int, d: int, causal: bool):
    """Least time for one flash-attention forward: q, k, v read once and
    o written once, over the memory rate; QKᵀ and PV over the pairs the
    mask keeps (the causal rule q_pos >= k_pos from 0), 2·D FLOP per pair
    each, over the fp32 peak (the exponentials are not counted). Returns
    (ms, "bytes" | "operations")."""
    moved = 4.0 * b * h * d * (2 * lq + 2 * lk)
    if causal:
        per_head = (lk * (lk + 1) / 2 + (lq - lk) * lk) if lq > lk else lq * (lq + 1) / 2
    else:
        per_head = lq * lk
    flops = 4.0 * d * b * h * per_head
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def synth_ml20m(scale: float, seed: int = 0):
    """ML-20M-shaped synthetic ratings: power-law user/item degrees,
    rank-8 ground truth, sd-0.5 observation noise (a copy of
    ``bench.py:126-212``'s generator, without its cache)."""
    rng = np.random.default_rng(seed)
    n_users = max(64, int(138_000 * min(1.0, scale)))
    n_items = max(32, int(27_000 * min(1.0, scale)))
    nnz = int(20_000_000 * scale)
    u_w = 1.0 / np.arange(1, n_users + 1) ** 0.8
    i_w = 1.0 / np.arange(1, n_items + 1) ** 0.9
    users = rng.choice(n_users, size=nnz, p=u_w / u_w.sum()).astype(np.int64)
    items = rng.choice(n_items, size=nnz, p=i_w / i_w.sum()).astype(np.int64)
    gt_rank = 8
    x = rng.normal(size=(n_users, gt_rank)) / np.sqrt(gt_rank)
    y = rng.normal(size=(n_items, gt_rank)) / np.sqrt(gt_rank)
    ratings = (
        (x[users] * y[items]).sum(axis=1) + 3.5 + rng.normal(0, 0.5, nnz)
    ).astype(np.float32)
    return users, items, ratings, n_users, n_items


def holdout_mask(nnz: int) -> np.ndarray:
    """bench.py's holdout split (5 %, fixed seed; bench.py:215-220)."""
    return np.random.default_rng(1).random(nnz) < 0.05


@contextlib.contextmanager
def gc_watch():
    """Count the interpreter's garbage collections inside the block and
    the host seconds they took (``gc.callbacks``): how much of a host-side
    time is the collector's. Yields the dict it fills."""
    out = {"collections": [0, 0, 0], "seconds": 0.0}
    started = []

    def callback(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            out["seconds"] += time.perf_counter() - started.pop()
            out["collections"][info["generation"]] += 1

    gc.callbacks.append(callback)
    try:
        yield out
    finally:
        gc.callbacks.remove(callback)


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


def device_time(torch, fn, iters: int = 30, attempts: int = 3) -> dict:
    """Device time of one ``fn`` call (``ms``): the time the card was busy
    (:func:`device_profile`) over ``iters`` calls, divided by ``iters``,
    with the device ops it ran per call. Unlike :func:`time_ms` it leaves
    out the host's time to launch the work, which sets the pace of a call
    whose kernels take a few microseconds. The profiler has returned an
    empty device trace for calls that ran kernels (``cholesky_solve``), so
    an empty profile is taken again, up to ``attempts`` times, before it
    fails."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        prof = device_profile(torch, lambda: [fn() for _ in range(iters)], top=3)
        if prof["device_busy_ms"] is not None:
            return {"ms": prof["device_busy_ms"] / iters,
                    "ops_per_call": prof["device_ops"] / iters,
                    "top_device_ops": prof["top_device_ops"]}
    raise AssertionError("the profiler saw no device activity")


def device_profile(torch, fn, top: int = 6) -> dict:
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
    # user annotations (e.g. "Optimizer.step#AdamW.step") span the gaps
    # between the kernels they enclose: not device work of their own
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    )
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + stop - start, count + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "result": result,
        "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_us / 1e3 if spans else None,
        "device_busy_share": busy_us / 1e6 / wall_s if spans else None,
        "device_ops": len(spans),
        "top_device_ops": [
            {"name": name[:90], "ms": t / 1e3, "count": c}
            for name, (t, c) in ranked
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


def wrong_outside_ties(got, want) -> int:
    """Slots whose id differs from the plain version's while their scores
    do not tie (rtol/atol 1e-5)."""
    s_k, i_k = (t.cpu().numpy() for t in got)
    s_p, i_p = (t.cpu().numpy() for t in want)
    return int(((i_k != i_p) & ~np.isclose(s_k, s_p, rtol=RTOL, atol=ATOL)).sum())


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
    """nvcc for every kernel and g++ for every host library of
    ``predictionio_tpu_torch/native``, all started at once."""
    from predictionio_tpu_torch import native
    from predictionio_tpu_torch.kernels import build

    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=len(native.LIBRARIES)) as pool:
        host = {name: pool.submit(native.build_library, name) for name in native.LIBRARIES}
        compiled = build.build_all()
        host_libs = {name: f.result().split("/")[-1] for name, f in host.items()}
    libs = {name: build.load_library(name)._name for name in build.kernel_names()}
    for name in native.LIBRARIES:
        native.load_library(name)
    emit({
        "phase": "build",
        "compiled": compiled,
        "libraries": {k: v.split("/")[-1] for k, v in libs.items()},
        "host_libraries": host_libs,
        "seconds": time.monotonic() - t0,
    })


def phase_kernel(torch, dev, rng) -> dict:
    from predictionio_tpu_torch.ops.cuda_kernels import (
        top_k_streaming,
        top_k_streaming_reference,
        topk_launch_plan,
    )

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count

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
        plan = topk_launch_plan(b, n, min(k, n), sm_count, r)
        out = {"case": name, "B": b, "N": n, "R": r, "k": k, "E": e,
               "T": plan.tiles_per_block, "n_runs": plan.n_runs,
               "stage1": "running_list" if plan.stage1_smem else "tile_sort",
               "merge_in": "shared" if plan.merge_smem else "global",
               "max_abs_err": err, "agree": ok}
        if timed:
            calls = {
                "kernel": lambda: top_k_streaming(q, items, k, excl),
                "plain": lambda: top_k_streaming_reference(q, items, k, excl),
                "library": lambda: torch.topk(q @ items.T, k, dim=1),
            }
            # per call (CUDA events: below about 25 us this is the host's
            # launch time), then the card's busy time alone
            for fn_name, fn in calls.items():
                out[f"{fn_name}_ms"] = time_ms(torch, fn)
            for fn_name in ("kernel", "library"):
                on_card = device_time(torch, calls[fn_name])
                out[f"{fn_name}_device_ms"] = on_card.pop("ms")
                out[f"{fn_name}_device"] = on_card
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
    # other ranks: odd, shorter than one chunk of 16, whole chunks only
    for other_r in (33, 8, 64):
        check(f"rank_{other_r}", *tensors(16, 3000, other_r), k)
    # every later item outranks every earlier one (positive queries, rows
    # that grow with the index): each candidate of each tile passes the
    # threshold, the selection's worst case
    rising = np.broadcast_to(
        (np.arange(1, n + 1, dtype=np.float32) / 64.0)[:, None], (n, r)).copy()
    rising = torch.from_numpy(rising).to(dev)
    check("rising_scores", q_all[:16].abs().contiguous() + 0.5, rising, k)
    check("rising_scores_long_runs", q_all[:512].abs().contiguous() + 0.5, rising, k)
    # a full served batch (the server's batch_max rows) at k = 128, the
    # widest k the running-list stage takes
    check("B512_k128", q_all[:512].contiguous(), items, 128)
    check("k1024", q_all[:4].contiguous(), items, 1024, timed=True)
    check("k2048", q_all[:2].contiguous(), items, 2048)
    # k above the old ceiling of 2048, up to the catalog: a served num of
    # 4096 (20 lists of 256 merged in shared memory), then k = N with 64
    # exclusions a query (106 lists, merged in device memory)
    k_q, k_items = tensors(64, 5000, r)
    main["k4096_N5000"] = check("k4096_N5000", k_q, k_items, 4096, timed=True)
    main["k_eq_N27000_E64"] = check("k_eq_N27000_E64", q_all[:64].contiguous(), items, n,
                                    torch.from_numpy(excl).to(dev), timed=True)
    return main


def traced_device_ms(torch, fn, iters: int, ops_per_call: int = 1):
    """:func:`device_time`'s ms for a call of several milliseconds, or None
    (not measured) when the profiler's trace holds fewer device ops a call
    than the call launches: at these shapes it has dropped some of the
    top-k launches made through ``ctypes`` (0.405 ms read for a 13.4 ms
    call) and once all of them. The CUDA-event time stands beside it."""
    try:
        on_card = device_time(torch, fn, iters)
    except AssertionError:  # the trace held no device op at all
        return None
    return on_card["ms"] if on_card["ops_per_call"] >= ops_per_call else None


def topk_large_batches(torch, dev, rng) -> dict:
    """The top-k at the batches of ``TOPK_LARGE``: one call of the wrapper
    (B = 600,000 is cut into two launches of at most ``TOPK_MAX_BATCH``
    rows; k = 256 on 27,000 items into launches whose scratch stays within
    ``TOPK_MAX_SCRATCH_BYTES``), held against the plain version in chunks
    (scores rtol/atol 1e-5, ids equal or tied), then timed beside the
    plain version (in the same chunks) and ``torch.topk(q @ items.T)``."""
    from predictionio_tpu_torch.ops.cuda_kernels import (
        top_k_streaming,
        top_k_streaming_reference,
        topk_batch_slices,
        topk_launch_plan,
        topk_scratch_bytes,
    )

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for b, n, r, k in TOPK_LARGE:
        q = torch.from_numpy(rng.standard_normal((b, r), dtype=np.float32)).to(dev)
        items = torch.from_numpy(rng.standard_normal((n, r), dtype=np.float32)).to(dev)
        slices = topk_batch_slices(b, n_items=n, k_eff=min(k, n), rank=r,
                                   sm_count=sm_count)
        chunk = min(ORACLE_CHUNK, (1 << 28) // n)
        before = top_k_streaming.launches
        got = top_k_streaming(q, items, k)
        torch.cuda.synchronize()
        launches = top_k_streaming.launches - before
        err, ok, wrong = 0.0, True, 0
        for start in range(0, b, chunk):
            stop = min(start + chunk, b)
            want = top_k_streaming_reference(q[start:stop], items, k)
            part = (got[0][start:stop], got[1][start:stop])
            e, agree = agreement(part, want)
            err, ok = max(err, e), ok and agree
            wrong += wrong_outside_ties(part, want)

        def plain():
            return [top_k_streaming_reference(q[s:s + chunk], items, k)
                    for s in range(0, b, chunk)]

        kernel = lambda: top_k_streaming(q, items, k)  # noqa: E731
        library = lambda: torch.topk(q @ items.T, k, dim=1)  # noqa: E731
        bound_ms, bound_by = topk_bound(b, n, r, k)
        plan = topk_launch_plan(slices[0][1] - slices[0][0], n, min(k, n), sm_count, r)
        line = {"case": f"large_B{b}_R{r}_k{k}", "B": b, "N": n, "R": r, "k": k,
                "slices": slices, "launches": launches,
                "scratch_bytes_per_launch": topk_scratch_bytes(plan),
                "T": plan.tiles_per_block, "n_runs": plan.n_runs,
                "stage1": "running_list" if plan.stage1_smem else "tile_sort",
                "max_abs_err": err, "agree": ok, "wrong_ids_outside_ties": wrong,
                "kernel_ms": time_ms(torch, kernel, 10, 2),
                "kernel_device_ms": traced_device_ms(torch, kernel, 5, 2 * len(slices)),
                "plain_chunked_ms": time_ms(torch, plain, 2, 1),
                "library_ms": time_ms(torch, library, 5, 1),
                "library_device_ms": traced_device_ms(torch, library, 3, 2),
                "bound_us": bound_ms * 1e3, "bound_by": bound_by}
        emit({"phase": "kernel", **line})
        if not ok or launches != len(slices):
            raise AssertionError(f"top-k at B = {b} disagrees with plain: {line}")
        out[line["case"]] = line
        del q, items, got
        torch.cuda.empty_cache()
    return out


def topk_plan_variants(torch, dev, seed: int = 0, blocks_per_sm=(1, 2, 3, 4)) -> None:
    """Not a phase of the run: times the top-k kernel's five timed shapes
    under other launch plans in one process, for PERF.md. ``tile_sort``
    forces stage 1 to sort every tile on its own (the tree merge alone
    against the earlier kernel); then the running list at several caps on
    the stage-1 blocks per SM (``TOPK_BLOCKS_PER_SM``, which sets the tiles
    per block); the first variant is timed again at the end. Every variant
    is held against the plain version first. Call it from ``python3 -c``
    after :func:`phase_build`."""
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(seed)
    n, r = 27000, 50
    q_all = torch.from_numpy(rng.standard_normal((1024, r), dtype=np.float32)).to(dev)
    items = torch.from_numpy(rng.standard_normal((n, r), dtype=np.float32)).to(dev)
    excl = torch.from_numpy(rng.integers(-1, n, size=(64, 64)).astype(np.int32)).to(dev)
    shapes = {"B1": (1, 16, None), "B64": (64, 16, None), "B1024": (1024, 16, None),
              "B64_E64": (64, 16, excl), "B512_k128": (512, 128, None),
              "B4_k1024": (4, 1024, None)}
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    saved = ck.TOPK_RUN_MAX_KT, ck.TOPK_BLOCKS_PER_SM
    variants = [("tile_sort", 0, saved[1])]
    variants += [(f"running_list_{n_blocks}_per_sm", saved[0], n_blocks)
                 for n_blocks in blocks_per_sm]
    variants.append(variants[0])
    try:
        for label, run_max_kt, n_blocks in variants:
            ck.TOPK_RUN_MAX_KT, ck.TOPK_BLOCKS_PER_SM = run_max_kt, n_blocks
            ck.topk_launch_plan.cache_clear()
            for name, (b, k, ex) in shapes.items():
                q = q_all[:b].contiguous()
                err, ok = agreement(ck.top_k_streaming(q, items, k, ex),
                                    ck.top_k_streaming_reference(q, items, k, ex))
                plan = ck.topk_launch_plan(b, n, k, sm_count, r)
                fn = lambda: ck.top_k_streaming(q, items, k, ex)  # noqa: E731
                emit({"variant": label, "shape": name, "T": plan.tiles_per_block,
                      "n_runs": plan.n_runs, "agree": ok, "max_abs_err": err,
                      "kernel_ms": time_ms(torch, fn),
                      "kernel_device_ms": device_time(torch, fn)["ms"]})
                if not ok:
                    raise AssertionError(f"{label} disagrees with plain at {name}")
    finally:
        ck.TOPK_RUN_MAX_KT, ck.TOPK_BLOCKS_PER_SM = saved
        ck.topk_launch_plan.cache_clear()


def phase_data(torch, dev, seed: int, scale: float = 1.0) -> dict:
    """The training data, and the staged copy of it that the kernel checks,
    the profiled iteration and the parity runs use (run_train stages its
    own)."""
    from predictionio_tpu_torch.ops import als

    t0 = time.monotonic()
    users, items, ratings, n_users, n_items = synth_ml20m(scale, seed)
    test = holdout_mask(len(users))
    tr = ~test
    u_tr = users[tr].astype(np.int32)
    i_tr = items[tr].astype(np.int32)
    r_tr = ratings[tr]
    if als.host_prep_path() != "native":
        raise AssertionError("PIO_NO_NATIVE_BUCKETIZE=1 is set: the main path "
                             "runs the native bucketize and sort")
    t1 = time.monotonic()
    by_user = als.bucketize(u_tr, i_tr, r_tr, n_users, n_items)
    by_item = als.bucketize(i_tr, u_tr, r_tr, n_items, n_users)
    t2 = time.monotonic()
    als.sort_bucket_indices(by_user)  # in place
    als.sort_bucket_indices(by_item)
    t3 = time.monotonic()
    ub, ib = als.stage(by_user, dev), als.stage(by_item, dev)
    torch.cuda.synchronize()
    t4 = time.monotonic()
    numpy_path = host_prep_against_numpy(als, u_tr, i_tr, r_tr, n_users, n_items,
                                         by_user, by_item)
    emit({
        "phase": "data",
        "users": n_users, "items": n_items, "ratings": int(len(users)),
        "train": int(tr.sum()), "holdout": int(test.sum()),
        "generate_s": t1 - t0, "bucketize_s": t2 - t1, "sort_s": t3 - t2,
        "stage_s": t4 - t3,
        "host_prep_path": als.host_prep_path(),
        "native_threads": als.native_threads(),
        "numpy_path": numpy_path,
        "by_user_buckets": [list(b.idx.shape) for b in ub.buckets],
        "by_item_buckets": [list(b.idx.shape) for b in ib.buckets],
        "truncated_rows": {
            "by_user": int(np.sum(np.bincount(u_tr, minlength=n_users) > 32768)),
            "by_item": int(np.sum(np.bincount(i_tr, minlength=n_items) > 32768)),
        },
    })
    return {
        "users": users, "items": items, "ratings": ratings,
        "n_users": n_users, "n_items": n_items, "train": tr, "test": test,
        "ub": ub, "ib": ib, "generate_s": t1 - t0,
    }


def host_prep_against_numpy(als, u_tr, i_tr, r_tr, n_users, n_items,
                            by_user, by_item) -> dict:
    """The numpy bucketize and sort (the path ``PIO_NO_NATIVE_BUCKETIZE=1``
    selects) once on the same arrays, timed, and held bit for bit (dtype,
    shape, every byte of rows, idx, val and counts) against the native
    output, both sides, every bucket."""
    t0 = time.monotonic()
    np_user = als._bucketize_numpy(u_tr, i_tr, r_tr, n_users, n_items)
    np_item = als._bucketize_numpy(i_tr, u_tr, r_tr, n_items, n_users)
    t1 = time.monotonic()
    als._sort_bucket_indices_numpy(np_user)
    als._sort_bucket_indices_numpy(np_item)
    t2 = time.monotonic()
    buckets = 0
    for side, got, want in (("by_user", by_user, np_user), ("by_item", by_item, np_item)):
        if len(got.buckets) != len(want.buckets):
            raise AssertionError(f"{side}: {len(got.buckets)} native buckets, "
                                 f"{len(want.buckets)} numpy")
        for g, w in zip(got.buckets, want.buckets):
            for field in ("rows", "idx", "val", "counts"):
                a, b = getattr(g, field), getattr(w, field)
                if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
                    raise AssertionError(f"{side} width {g.width}: native {field} "
                                         "differs from the numpy path")
            buckets += 1
    return {"bucketize_s": t1 - t0, "sort_s": t2 - t1, "buckets_identical": buckets}


def _gramian_library(torch, y, idx, w2, rhs):
    """The library yardstick: the einsum build over the whole gather."""
    g = y.float()[idx.long()]
    return (torch.einsum("bkr,bk,bks->brs", g, w2, g),
            torch.einsum("bkr,bk->br", g, rhs))


def gramian_plan(torch, dev, b: int, k: int, r: int) -> dict:
    """The build's launch plan for one call, as a plan line prints it."""
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ck.gramian_plan(b, k, r, sm_count)
    return {"path": plan.path, "kc": plan.chunk, "S": plan.n_chunks, "blocks": plan.blocks,
            "passes": 2 if plan.n_chunks > 1 else 1, "threads": plan.threads,
            "regs": ck.GRAMIAN_REGS, "smem": plan.chunk_smem,
            "blocks_per_sm": plan.blocks_per_sm}


def check_gramian_attributes(torch, dev) -> dict:
    """The chunk kernels' registers, spills and static shared memory on the
    card; the launch plan's occupancy assumes GRAMIAN_REGS registers."""
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    attrs = ck.gramian_kernel_attributes(dev)
    emit({"phase": "train_kernels", "kernel": "gramian_fused", "attributes": attrs,
          "plan_regs": ck.GRAMIAN_REGS})
    tuned = [attrs["one_pass"], attrs["split"]]
    if (max(a["regs"] for a in tuned) != ck.GRAMIAN_REGS
            or any(a["local_bytes"] for a in attrs.values())):
        raise AssertionError(f"the build kernels take {attrs}, the launch plan "
                             f"assumes {ck.GRAMIAN_REGS} registers and no spills")
    return attrs


def spd_plan(torch, dev, b: int, n: int) -> dict:
    """The solve's launch plan for one call, as a plan line prints it."""
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ck.spd_launch_plan(b, n, sm_count)
    return {"path": plan.path, "np": plan.np_, "slots": plan.slots,
            "warps": plan.warps, "blocks": plan.blocks, "smem": plan.smem,
            "blocks_per_sm": plan.blocks_per_sm,
            "warps_per_sm": plan.warps * plan.blocks_per_sm, "waves": plan.waves}


def check_spd_attributes(torch, dev) -> dict:
    """Every solve kernel's registers, spills and static shared memory on
    the card; the launch plan's occupancy assumes SPD_REGS[np_] registers
    allocated (the count rounded up to 8) for the registers kernel at each
    padded width."""
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    attrs = ck.spd_kernel_attributes(dev)
    regs = {np_: -(-attrs[f"registers_np{np_}"]["regs"] // 8) * 8 for np_ in ck.SPD_REGS}
    emit({"phase": "train_kernels", "kernel": "spd_solve", "attributes": attrs,
          "plan_regs": ck.SPD_REGS, "plan_n50": spd_plan(torch, dev, N_USERS, RANK)})
    if regs != ck.SPD_REGS or any(a["local_bytes"] for a in attrs.values()):
        raise AssertionError(f"the solve kernels take {attrs}, the launch plan "
                             f"assumes {ck.SPD_REGS} registers and no spills")
    return attrs


def phase_train_kernels(torch, dev, data: dict, seed: int) -> dict:
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops.cuda_kernels import (
        SPD_MAX_N,
        gramian_fused,
        gramian_fused_reference,
        spd_solve,
        spd_solve_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {"gramian_fused": 0.0, "spd_solve": 0.0}
    attrs = check_gramian_attributes(torch, dev)
    spd_attrs = check_spd_attributes(torch, dev)

    def check_gramian(case, y, idx, w2, rhs, ridge, yty=None, timed=False,
                      valid=None, rows=None):
        """Kernel against plain; ``rows`` (default all) are the rows that
        must be finite and agree."""
        before = gramian_fused.launches
        a_k, b_k = gramian_fused(y, idx, w2, rhs, ridge, yty)
        torch.cuda.synchronize()
        a_p, b_p = gramian_fused_reference(y, idx, w2, rhs, ridge, yty)
        sel = slice(None) if rows is None else rows
        ak, bk, ap, bp = a_k[sel], b_k[sel], a_p[sel], b_p[sel]
        ok = bool(
            torch.isfinite(ak).all() and torch.isfinite(bk).all()
            and torch.allclose(ak, ap, rtol=KERNEL_TOL, atol=KERNEL_TOL)
            and torch.allclose(bk, bp, rtol=KERNEL_TOL, atol=KERNEL_TOL)
            and torch.equal(ak, ak.transpose(1, 2))
        )
        err = max(float((ak - ap).abs().max()), float((bk - bp).abs().max()))
        b, k = idx.shape
        n, r = y.shape
        out = {"case": case, "B": b, "K": k, "N": n, "R": r,
               "dtype": str(y.dtype).split(".")[-1], "yty": yty is not None,
               "plan": gramian_plan(torch, dev, b, k, r),
               "max_abs_err": err, "agree": ok}
        if timed:
            kernel = lambda: gramian_fused(y, idx, w2, rhs, ridge, yty)  # noqa: E731
            library = lambda: _gramian_library(torch, y, idx, w2, rhs)  # noqa: E731
            out["kernel_ms"] = time_ms(torch, kernel, 10, 2)
            out["plain_ms"] = time_ms(
                torch, lambda: gramian_fused_reference(y, idx, w2, rhs, ridge, yty), 3, 1)
            out["library_ms"] = time_ms(torch, library, 3, 1)
            out["kernel_device_ms"] = device_time(torch, kernel, 10)["ms"]
            out["library_device_ms"] = device_time(torch, library, 3)["ms"]
            bound_ms, out["bound_by"] = gramian_bound(
                b, k, n, r, valid, yty is not None)
            out["bound_us"] = bound_ms * 1e3
        out["launches"] = gramian_fused.launches - before
        emit({"phase": "train_kernels", "kernel": "gramian_fused", **out})
        if not ok:
            raise AssertionError(f"gramian_fused disagrees with plain: {out}")
        worst["gramian_fused"] = max(worst["gramian_fused"], err)
        return out, (a_k, b_k)

    def check_spd(case, a, b, timed=False, rows=None, plain_a=None):
        """Kernel against plain (on ``plain_a`` when given); ``rows``
        (default all) are the systems that must be finite and agree."""
        before = spd_solve.launches
        x_k = spd_solve(a, b)
        torch.cuda.synchronize()
        x_p = spd_solve_reference(a if plain_a is None else plain_a, b)
        sel = slice(None) if rows is None else rows
        xk, xp = x_k[sel], x_p[sel]
        rel = float(((xk - xp).norm(dim=1) / xp.norm(dim=1).clamp_min(1e-30)).max())
        ok = bool(torch.isfinite(xk).all()) and rel < KERNEL_TOL
        err = float((xk - xp).abs().max())
        bsz, n, _ = a.shape
        out = {"case": case, "B": bsz, "n": n, "plan": spd_plan(torch, dev, bsz, n),
               "max_rel_err": rel, "max_abs_err": err, "agree": ok}
        if timed:
            kernel = lambda: spd_solve(a, b)  # noqa: E731
            library = lambda: torch.cholesky_solve(  # noqa: E731
                b[:, :, None], torch.linalg.cholesky(a))
            out["kernel_ms"] = time_ms(torch, kernel, 10, 2)
            out["plain_ms"] = time_ms(torch, lambda: spd_solve_reference(a, b), 3, 1)
            out["library_ms"] = time_ms(torch, library, 3, 1)
            out["kernel_device_ms"] = device_time(torch, kernel, 10)["ms"]
            out["library_device_ms"] = device_time(torch, library, 3)["ms"]
            bound_ms, out["bound_by"] = spd_bound(bsz, n)
            out["bound_us"] = bound_ms * 1e3
            out["bound_whole_a_us"] = spd_bound(bsz, n, whole_a=True)[0] * 1e3
        out["launches"] = spd_solve.launches - before
        emit({"phase": "train_kernels", "kernel": "spd_solve", **out})
        if not ok:
            raise AssertionError(f"spd_solve disagrees with plain: {out}")
        worst["spd_solve"] = max(worst["spd_solve"], err)
        return out, x_k

    # every bucket of both sides, as one training iteration launches them
    tables = {
        "by_user": als.init_factors(data["n_items"], RANK, seed + 1, dev),
        "by_item": als.init_factors(data["n_users"], RANK, seed + 2, dev),
    }
    per_iter = {name: {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "bound_ms": 0.0, "launches": 0,
                       "by": {"bytes": 0.0, "operations": 0.0}}
                for name in ("gramian_fused", "spd_solve")}
    for name in per_iter:
        per_iter[name].update(kernel_device_ms=0.0, library_device_ms=0.0)
    per_iter["spd_solve"]["bound_whole_a_ms"] = 0.0
    chunks, widest = {}, None
    for side_name, side in (("by_user", data["ub"]), ("by_item", data["ib"])):
        y = tables[side_name]
        for bucket in side.buckets:
            w2, rhs, ridge = als._bucket_system_weights(bucket, False, LAMBDA, 1.0)
            width = bucket.idx.shape[1]
            case = f"{side_name}_K{width}"
            valid = int(bucket.counts.sum())
            g_out, (a, b) = check_gramian(case, y, bucket.idx, w2, rhs, ridge,
                                          timed=True, valid=valid)
            s_out, _ = check_spd(case, a, b, timed=True)
            if side_name == "by_item" and width == max(b.idx.shape[1] for b in side.buckets):
                widest = {k: g_out[k] for k in ("B", "K", "plan", "kernel_ms",
                                                "kernel_device_ms")}
                # no atomics: a second call gives the same bits
                a2, b2 = gramian_fused(y, bucket.idx, w2, rhs, ridge)
                if not (torch.equal(a, a2) and torch.equal(b, b2)):
                    raise AssertionError(f"{case}: two calls differ")
                del a2, b2
            for name, out in (("gramian_fused", g_out), ("spd_solve", s_out)):
                acc = per_iter[name]
                for key in ("kernel_ms", "plain_ms", "library_ms",
                            "kernel_device_ms", "library_device_ms"):
                    acc[key] += out[key]
                if name == "spd_solve":
                    acc["bound_whole_a_ms"] += out["bound_whole_a_us"] / 1e3
                acc["bound_ms"] += out["bound_us"] / 1e3
                acc["launches"] += 1
                acc["by"][out["bound_by"]] += out["bound_us"] / 1e3
            chunks[case] = (y, bucket.idx[:64], w2[:64], rhs[:64], ridge[:64])
            del a, b, w2, rhs, ridge
    torch.cuda.empty_cache()

    # build edge cases, on real bucket rows
    y, idx, w2, rhs, ridge = chunks[sorted(chunks)[0]]
    w2, rhs, ridge = w2.clone(), rhs.clone(), ridge.clone()
    w2[32:], rhs[32:], ridge[32:] = 0.0, 0.0, 0.0
    _, (a, b) = check_gramian("zero_weight_rows", y, idx, w2, rhs, ridge)
    if not (bool((a[32:] == 0).all()) and bool((b[32:] == 0).all())):
        raise AssertionError("zero-weight rows did not give an exactly-zero system")
    y, idx, w2, rhs, ridge = chunks[sorted(chunks)[-1]]
    check_gramian("yty_base", y, idx, w2, rhs, ridge, y.T @ y)
    check_gramian("bf16_table", y.to(torch.bfloat16), idx, w2, rhs, ridge)
    y13 = torch.rand((y.shape[0], 13), generator=gen, device=dev)
    check_gramian("R13", y13, idx, w2, rhs, ridge, y13.T @ y13)
    check_gramian("K1", y, idx[:, :1].contiguous(), w2[:, :1].contiguous(),
                  rhs[:, :1].contiguous(), ridge)
    k = 32768
    wide_idx = torch.randint(0, y.shape[0], (1, k), generator=gen, device=dev,
                             dtype=torch.int32)
    check_gramian("K32768_row", y, wide_idx, torch.ones((1, k), device=dev),
                  1 + 4 * torch.rand((1, k), generator=gen, device=dev),
                  torch.full((1,), LAMBDA * k, device=dev))
    gramian_split_edges(torch, dev, y, gen, check_gramian)

    # the solve at fixed batch sizes, and its edge cases
    def spd_systems(bsz, n, k=64):
        g = torch.randn((bsz, k, n), generator=gen, device=dev)
        a = torch.bmm(g.transpose(1, 2), g)
        a += LAMBDA * k * torch.eye(n, device=dev)
        return a, torch.randn((bsz, n), generator=gen, device=dev)

    for bsz in SPD_BATCHES:
        check_spd(f"B{bsz}", *spd_systems(bsz, RANK), timed=True)
    torch.cuda.empty_cache()
    a, b = spd_systems(256, RANK)
    a[128:] = 0.0
    _, x = check_spd("zero_systems", a, b)
    if not bool((x[128:] == 0).all()):
        raise AssertionError("all-zero systems did not solve to exact zeros")
    a, b = spd_systems(256, RANK)
    dead = [3, 17, 31, 49]
    a[:, dead, :] = 0.0
    a[:, :, dead] = 0.0
    _, x = check_spd("singular_psd", a, b)
    if not bool((x[:, dead] == 0).all()):
        raise AssertionError("zero pivots did not give zero components")
    check_spd(f"n{SPD_MAX_N}_ceiling", *spd_systems(1024, SPD_MAX_N, k=160))
    for n in (1, 8, 13, 33, 64, 65):  # both sides of the registers path's edge
        out, _ = check_spd(f"n{n}", *spd_systems(1024, n))
        if out["plan"]["path"] != ("registers" if n <= 64 else "shared"):
            raise AssertionError(f"n = {n} took the {out['plan']['path']} path")
    check_spd("B1", *spd_systems(1, RANK))
    # only the upper triangle is read: NaN below it solves as the twin does
    a, b = spd_systems(256, RANK)
    low = torch.tril(torch.ones(RANK, RANK, dtype=torch.bool, device=dev), -1)
    check_spd("lower_triangle_nan", a.masked_fill(low, float("nan")), b, plain_a=a)
    # one NaN system among finite ones stays in its own system
    a, b = spd_systems(256, RANK)
    a[77, 5, 9] = float("nan")
    _, x = check_spd("nan_system", a, b, rows=torch.arange(256, device=dev) != 77)
    if not bool(torch.isnan(x[77]).any()):
        raise AssertionError("the NaN system did not reach its own solution")
    a, b = spd_systems(4096, RANK)
    if not torch.equal(spd_solve(a, b), spd_solve(a, b)):
        raise AssertionError("two solve calls on the same inputs differ")
    emit({"phase": "train_kernels", "kernel": "spd_solve", "case": "two_calls",
          "bit_identical": True})
    out, _ = check_spd(f"n{SPD_MAX_N + 1}", *spd_systems(1024, SPD_MAX_N + 1, k=260))
    if out["plan"]["path"] != "wide":  # picked by n alone
        raise AssertionError(f"n = {SPD_MAX_N + 1} took the {out['plan']['path']} path")
    for acc in per_iter.values():
        # what bounds most of the iteration's bound time
        acc["bound_ms_by"] = acc.pop("by")
        acc["by"] = max(acc["bound_ms_by"], key=acc["bound_ms_by"].get)
    emit({"phase": "train_kernels", "per_iteration": per_iter})
    return {"per_iteration": per_iter, "max_abs_err": worst, "widest": widest,
            "attributes": attrs, "spd_attributes": spd_attrs}


def gramian_split_edges(torch, dev, y, gen, check_gramian) -> None:
    """The build's edge cases of a split row, on the card: rows whose
    ratings end inside a chunk and inside a tile, a row whose weights sit
    in its last chunk only, zero-weight slots inside the valid prefix
    (w2 = 0 with rhs != 0 and the reverse), empty rows (exact zeros), a
    NaN factor row read by one row only, K = 8,193 (one past the JAX
    package's split) and K = 32,768 split, and two calls bit-identical."""
    n = y.shape[0]

    def rows(b, k, counts):
        idx = torch.randint(0, n, (b, k), generator=gen, device=dev, dtype=torch.int32)
        mask = (torch.arange(k, device=dev)[None, :] < counts[:, None]).float()
        rhs = (1 + 4 * torch.rand((b, k), generator=gen, device=dev)) * mask
        return idx, mask, rhs, LAMBDA * counts.float()

    k = 8193
    counts = torch.randint(1, k, (64,), generator=gen, device=dev)
    counts[::4] = counts[::4] // 32 * 32 + 7  # inside a tile
    counts[1::8] = 0  # empty rows: exactly zero
    counts[5] = k
    idx, w2, rhs, ridge = rows(64, k, counts)
    out, (a, b) = check_gramian("K8193_ragged_ends", y, idx, w2, rhs, ridge)
    if out["plan"]["S"] < 2:
        raise AssertionError(f"K = {k} was not split: {out['plan']}")
    if not (bool((a[1::8] == 0).all()) and bool((b[1::8] == 0).all())):
        raise AssertionError("an empty row of a split launch is not exactly zero")
    a2, b2 = check_gramian("K8193_ragged_ends_again", y, idx, w2, rhs, ridge)[1]
    if not (torch.equal(a, a2) and torch.equal(b, b2)):
        raise AssertionError("two calls on the same inputs differ")
    kc = out["plan"]["kc"]
    last = torch.zeros_like(w2)
    last[:, (out["plan"]["S"] - 1) * kc:] = 1.0
    check_gramian("K8193_last_chunk_only", y, idx, last, rhs * 0 + last, ridge)
    # implicit style: w2 = alpha |r| may be 0 where rhs is not, and the reverse
    holes = torch.rand(w2.shape, generator=gen, device=dev)
    w2i = torch.where(holes < 0.1, 0.0, w2 * (1 + holes))
    rhsi = torch.where((holes > 0.9) & (w2i != 0), 0.0, rhs)
    check_gramian("K8193_zero_weight_slots", y, idx, w2i, rhsi, ridge)
    # a NaN factor row read by row 5 only: the other rows stay finite and equal
    y_nan = y.clone()
    y_nan[n - 1] = float("nan")
    idx_nan = torch.where(idx == n - 1, n - 2, idx)
    idx_nan[5, 17] = n - 1
    _, (a, b) = check_gramian("K8193_nan_row", y_nan, idx_nan, w2, rhs, ridge,
                              rows=torch.arange(64, device=dev) != 5)
    if not (bool(torch.isnan(a[5]).any()) and bool(torch.isnan(b[5]).any())):
        raise AssertionError("the NaN factor row did not reach the row that reads it")
    k = 32768
    counts = torch.tensor([k, 0, k // 2 + 3, 1], device=dev)
    out, _ = check_gramian("K32768_split", y, *rows(4, k, counts))
    if out["plan"]["S"] < 2:
        raise AssertionError(f"K = {k} was not split: {out['plan']}")


def gramian_plan_variants(torch, dev, data: dict, seed: int = 0,
                          variants=((4, 256), (1, 256), (16, 256), (16, 32)),
                          every_bucket: bool = False) -> None:
    """Not a phase of the run: times the build kernel under other launch
    plans in one process, for PERF.md: each (waves, narrowest chunk) sets
    ``GRAMIAN_WAVES`` and ``GRAMIAN_MIN_CHUNK`` and so the chunk width kc,
    at the two widest buckets of each side and the users K = 128 bucket
    (``every_bucket``: at all of them); the first variant is timed again
    at the end. Every variant is held against the plain version first.
    Call it from ``python3 -c`` after :func:`phase_build` and
    :func:`phase_data`."""
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    tables = {"by_user": als.init_factors(data["n_items"], RANK, seed + 1, dev),
              "by_item": als.init_factors(data["n_users"], RANK, seed + 2, dev)}
    cases = []
    for side_name, side in (("by_user", data["ub"]), ("by_item", data["ib"])):
        widths = sorted(b.idx.shape[1] for b in side.buckets)
        for bucket in side.buckets:
            width = bucket.idx.shape[1]
            if (every_bucket or width in widths[-2:]
                    or (side_name == "by_user" and width == 128)):
                cases.append((f"{side_name}_K{width}", tables[side_name], bucket))
    saved = ck.GRAMIAN_WAVES, ck.GRAMIAN_MIN_CHUNK
    try:
        for waves, min_chunk in (*variants, variants[0]):
            ck.GRAMIAN_WAVES, ck.GRAMIAN_MIN_CHUNK = waves, min_chunk
            ck.gramian_launch_plan.cache_clear()
            for case, y, bucket in cases:
                w2, rhs, ridge = als._bucket_system_weights(bucket, False, LAMBDA, 1.0)
                a_k, b_k = ck.gramian_fused(y, bucket.idx, w2, rhs, ridge)
                a_p, b_p = ck.gramian_fused_reference(y, bucket.idx, w2, rhs, ridge)
                ok = bool(torch.allclose(a_k, a_p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
                          and torch.allclose(b_k, b_p, rtol=KERNEL_TOL, atol=KERNEL_TOL))
                del a_k, b_k, a_p, b_p
                fn = lambda: ck.gramian_fused(y, bucket.idx, w2, rhs, ridge)  # noqa: E731
                b, k = bucket.idx.shape
                emit({"variant": f"waves{waves}_min{min_chunk}", "case": case,
                      "plan": gramian_plan(torch, dev, b, k, RANK), "agree": ok,
                      "kernel_ms": time_ms(torch, fn, 10, 2),
                      "kernel_device_ms": device_time(torch, fn, 10)["ms"]})
                if not ok:
                    raise AssertionError(f"variant {waves}/{min_chunk} disagrees at {case}")
    finally:
        ck.GRAMIAN_WAVES, ck.GRAMIAN_MIN_CHUNK = saved
        ck.gramian_launch_plan.cache_clear()


def phase_train(torch, dev, data: dict, registry) -> dict:
    from predictionio_tpu_torch.controller import (
        DataSource,
        Engine,
        EngineParams,
        FirstServing,
    )
    from predictionio_tpu_torch.models.recommendation import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        RecPreparator,
        TrainingData,
    )
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops.cuda_kernels import (
        gramian_fused,
        gramian_fused_reference,
        spd_solve,
        spd_solve_reference,
    )
    from predictionio_tpu_torch.storage import BiMap
    from predictionio_tpu_torch.workflow import WorkflowContext, load_models, run_train

    users, items, ratings = data["users"], data["items"], data["ratings"]
    tr, test = data["train"], data["test"]
    n_users, n_items = data["n_users"], data["n_items"]
    training = TrainingData(
        users=users[tr].astype(np.int32), items=items[tr].astype(np.int32),
        ratings=ratings[tr],
        user_map=BiMap({f"u{i}": i for i in range(n_users)}),
        item_map=BiMap({f"i{i}": i for i in range(n_items)}),
    )

    class SmokeDataSource(DataSource):
        def read_training(self, ctx):
            return training

    engine = Engine({"": SmokeDataSource}, {"": RecPreparator},
                    {"als": ALSAlgorithm}, {"": FirstServing})
    params = ALSAlgorithmParams(rank=RANK, num_iterations=TRAIN_ITERS,
                                lambda_=LAMBDA, seed=TRAIN_SEED)
    ctx = WorkflowContext(device=dev)
    ctx.profile = {}
    gramian_fused.launches = spd_solve.launches = 0  # main path starts here
    t0 = time.monotonic()
    instance_id = run_train(
        engine, EngineParams(algorithm_params_list=[("als", params)]), registry,
        ctx=ctx,
    )
    wall_s = time.monotonic() - t0
    launches = {"gramian_fused": gramian_fused.launches,
                "spd_solve": spd_solve.launches}  # main path ends here
    prof = ctx.profile
    if prof["host_prep_path"] != "native":
        raise AssertionError(f"run_train prepared its slabs on the "
                             f"{prof['host_prep_path']} path")
    per_iter = prof["launches"]
    if (len(per_iter) != TRAIN_ITERS
            or any(min(it.values()) < 1 for it in per_iter)
            or min(launches.values()) < 1):
        raise AssertionError(f"training did not launch both kernels every "
                             f"iteration: {launches}, {per_iter}")

    (model,) = load_models(registry, instance_id)
    factors = als.ALSFactors(torch.from_numpy(model.user_factors).to(dev),
                             torch.from_numpy(model.item_factors).to(dev), RANK)
    train_rmse = als.rmse(factors, users[tr], items[tr], ratings[tr])
    holdout_rmse = als.rmse(factors, users[test], items[test], ratings[test])
    if not (np.isfinite(model.user_factors).all() and np.isfinite(model.item_factors).all()):
        raise AssertionError("trained factors are not finite")
    if not holdout_rmse <= HOLDOUT_GATE:
        raise AssertionError(f"holdout RMSE {holdout_rmse} above {HOLDOUT_GATE}")

    ub, ib = data["ub"], data["ib"]
    one = als.ALSConfig(rank=RANK, iterations=1, lambda_=LAMBDA)
    profiled = device_profile(torch, lambda: als._train_loop(
        ub, ib, factors.item_factors, one, gramian_fused, spd_solve))
    profiled.pop("result")

    cfg = als.ALSConfig(rank=RANK, iterations=PARITY_ITERS, lambda_=LAMBDA)
    y0 = als.init_factors(n_items, RANK, TRAIN_SEED, dev)
    runs = {}
    for name, build, solve in (
        ("kernel", gramian_fused, spd_solve),
        ("plain", gramian_fused_reference, spd_solve_reference),
    ):
        t = time.monotonic()
        x, y = als._train_loop(ub, ib, y0, cfg, build, solve)
        torch.cuda.synchronize()
        f = als.ALSFactors(x, y, RANK)
        runs[name] = (f, time.monotonic() - t,
                      als.rmse(f, users[tr], items[tr], ratings[tr]))
    (fk, kernel_s, rmse_k), (fp, plain_s, rmse_p) = runs["kernel"], runs["plain"]
    parity = {"iterations": PARITY_ITERS, "kernel_s": kernel_s, "plain_s": plain_s,
              "train_rmse_kernel": rmse_k, "train_rmse_plain": rmse_p}
    ok = abs(rmse_k - rmse_p) <= RMSE_TOL
    degrees = {"user": np.bincount(users[tr], minlength=n_users),
               "item": np.bincount(items[tr], minlength=n_items)}
    for name, got, want in (("user", fk.user_factors, fp.user_factors),
                            ("item", fk.item_factors, fp.item_factors)):
        diff = (got - want).abs()
        excess = diff - (FACTOR_ATOL + FACTOR_RTOL * want.abs())
        worst_row = int(excess.max(dim=1).values.argmax())
        parity[name] = {
            "max_abs_diff": float(diff.max()),
            "rel_norm_diff": float(torch.linalg.norm(got - want) / torch.linalg.norm(want)),
            "beyond_tol": int((excess > 0).sum()),
            "entries": int(excess.numel()),
            "worst_row_ratings": int(degrees[name][worst_row]),
        }
        ok = ok and parity[name]["beyond_tol"] == 0

    out = {
        "phase": "train",
        "instance": instance_id,
        "wall_s": wall_s,
        "host_prep_s": {"path": prof["host_prep_path"],
                        "generate": data["generate_s"],
                        "bucketize": prof["bucketize_s"], "sort": prof["sort_s"],
                        "stage": prof["stage_s"]},
        "levers": prof["levers"],
        "iteration_s": prof["iteration_s"],
        "launches": launches,
        "launches_per_iteration": per_iter,
        "flops_per_iteration": prof["flops_per_iteration"],
        "hbm_bytes_per_iteration": prof["hbm_bytes_per_iteration"],
        "train_rmse": train_rmse,
        "holdout_rmse": holdout_rmse,
        "profiled_iteration": profiled,
        "parity": parity,
    }
    emit(out)
    if not ok:
        raise AssertionError(f"kernel and plain training disagree: {parity}")
    return out


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


def phase_slice(torch, dev, seed: int, registry, instance_id: str) -> dict:
    from predictionio_tpu_torch.models.recommendation import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        Query,
        engine_factory,
    )
    from predictionio_tpu_torch.ops.cuda_kernels import (
        top_k_streaming,
        top_k_streaming_reference,
    )
    from predictionio_tpu_torch.workflow import (
        ServerConfig,
        create_query_server,
        load_models,
    )

    rng = np.random.default_rng(seed)
    t0 = time.monotonic()
    (model,) = load_models(registry, instance_id)  # what run_train wrote
    rank = model.rank
    n_users, n_items = model.user_factors.shape[0], model.item_factors.shape[0]
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
        if status.get("engineInstance") != instance_id:
            raise AssertionError(
                f"deployed {status.get('engineInstance')}, trained {instance_id}")
        if http_launches < 1:
            raise AssertionError("the HTTP path launched the kernel 0 times")
    finally:
        server.shutdown()
        server.server_close()

    auto = ALSAlgorithm(ALSAlgorithmParams(rank=rank), device=dev)
    users = rng.choice(n_users, size=1024, replace=False)
    queries = [(j, Query(user=f"u{u}", num=10)) for j, u in enumerate(users)]
    before = top_k_streaming.launches
    with gc_watch() as first_gc:
        t1 = time.monotonic()
        results = dict(auto.batch_predict(model, queries))  # attaches the model
        attach_and_batch_s = time.monotonic() - t1
    with gc_watch() as warm_gc:
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
                         "warm_batch_s": warm_batch_s,
                         "gc": {"first": first_gc, "warm": warm_gc,
                                "tracked_objects": len(gc.get_objects())}},
        "launches": total_launches,
    }
    emit(out)
    return out


def flash_plan_line(plan) -> dict:
    """A flash launch plan as a case line prints it."""
    return {k: list(v) if isinstance(v, tuple) else v for k, v in plan._asdict().items()}


def check_flash_attributes(torch, dev) -> dict:
    """Every flash instantiation's registers, spills and static shared
    memory on the card (the launch plan reads the registers from there);
    fails on any local memory."""
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    attrs = ck.flash_kernel_attributes(dev)
    line = {f"D{d}_bq{bq}": [a["regs"], a["local_bytes"]] for (d, bq), a in attrs.items()}
    emit({"phase": "attention_kernel", "attributes": "[regs, local_bytes]", **line})
    spilled = {key: a for key, a in attrs.items() if a["local_bytes"]}
    if spilled:
        raise AssertionError(f"flash instantiations use local memory: {spilled}")
    return line


def phase_attention_kernel(torch, dev, seed: int) -> dict:
    """The flash-attention kernel against its plain version on the card,
    at the slice's shapes and the edge cases."""
    import torch.nn.functional as F

    from predictionio_tpu_torch.ops.cuda_kernels import (
        FLASH_BQS,
        FLASH_D_MULTIPLE,
        FLASH_MAX_D,
        FLASH_MAX_SMEM,
        flash_attention_fwd,
        flash_attention_fwd_reference,
        flash_plan_for,
        flash_smem_bytes,
    )

    attributes = check_flash_attributes(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {"max_abs_err": 0.0}

    def check(case, b, h, lq, lk, d, causal, timed=False, bq=None, repeat=False):
        q = torch.randn((b, h, lq, d), generator=gen, device=dev)
        k = torch.randn((b, h, lk, d), generator=gen, device=dev)
        v = torch.randn((b, h, lk, d), generator=gen, device=dev)
        # the plan of the width the kernel runs at: D padded to a multiple
        # of 8 (the wrapper pads an odd width); bq: an instantiation to force
        d_pad = -(-d // FLASH_D_MULTIPLE) * FLASH_D_MULTIPLE
        plan = flash_plan_for(q.new_empty((b, h, lq, d_pad)),
                              k.new_empty((b, h, lk, d_pad)), causal, bq)
        before = flash_attention_fwd.launches
        got = flash_attention_fwd(q, k, v, causal, plan=plan)
        torch.cuda.synchronize()
        want = flash_attention_fwd_reference(q, k, v, causal)
        ok = bool(torch.isfinite(got).all()
                  and torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL))
        err = float((got - want).abs().max())
        out = {"case": case, "B": b, "H": h, "Lq": lq, "Lk": lk, "D": d,
               "D_kernel": d_pad, "causal": causal, "max_abs_err": err, "agree": ok,
               "plan": flash_plan_line(plan)}
        if repeat:  # no atomics: a second call gives the same bits
            again = flash_attention_fwd(q, k, v, causal, plan=plan)
            torch.cuda.synchronize()
            out["bit_identical"] = bool(torch.equal(got, again))
            ok = ok and out["bit_identical"]
        if timed:
            calls = {
                "kernel": lambda: flash_attention_fwd(q, k, v, causal),
                "plain": lambda: flash_attention_fwd_reference(q, k, v, causal),
                "library": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
            }
            for name, fn in calls.items():
                out[f"{name}_ms"] = time_ms(torch, fn)
            for name, fn in calls.items():
                on_card = device_time(torch, fn)
                out[f"{name}_device_ms"] = on_card.pop("ms")
                out[f"{name}_device"] = on_card
            bound_ms, out["bound_by"] = flash_attention_bound(b, h, lq, lk, d, causal)
            out["bound_us"] = bound_ms * 1e3
            out["device_over_bound"] = out["kernel_device_ms"] / bound_ms
            out["device_over_library"] = out["kernel_device_ms"] / out["library_device_ms"]
        out["launches"] = flash_attention_fwd.launches - before
        emit({"phase": "attention_kernel", **out})
        if not ok:
            raise AssertionError(f"flash attention disagrees with plain: {out}")
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        return out

    main = {
        "train": check("train_B64", 64, 4, 64, 64, 16, True, timed=True, repeat=True),
        "serve": check("serve_B1", 1, 4, 64, 64, 16, True, timed=True),
        # head widths that are not a multiple of 8: seqrec at d_model 24 /
        # 4 heads (D = 6) and 60 / 4 (D = 15), the training shape
        "train_D6": check("train_B64_D6", 64, 4, 64, 64, 6, True, timed=True, repeat=True),
        "train_D15": check("train_B64_D15", 64, 4, 64, 64, 15, True, timed=True),
    }
    for causal in (True, False):
        for d in (6, 12, 15, 100):
            check(f"odd_D{d}", 2, 4, 160, 200, d, causal)
    for causal in (True, False):
        for b, h, lq, lk, d in ((2, 4, 64, 64, 16), (1, 2, 60, 60, 8),
                                (1, 1, 7, 13, 8), (2, 2, 128, 96, 32)):
            check(f"flash_pallas_{b}x{h}x{lq}x{lk}x{d}", b, h, lq, lk, d, causal)
        check("cross_Lq70_Lk300", 2, 2, 70, 300, 64, causal)
        check("cross_Lq300_Lk70", 2, 2, 300, 70, 64, causal)
        check("cross_Lq2048_Lk1000", 2, 4, 2048, 1000, 64, causal)
        check("cross_Lq1000_Lk2048", 2, 4, 1000, 2048, 64, causal)
        check("ragged_L2049", 2, 4, 2049, 2049, 64, causal)
        main[f"long_causal_{causal}"] = check(
            f"long_L2048_causal_{causal}", 8, 4, 2048, 2048, 64, causal, timed=True,
            repeat=True)
    # every instantiation: each head width at both query tiles
    for d in range(FLASH_D_MULTIPLE, FLASH_MAX_D + 1, FLASH_D_MULTIPLE):
        for bq in FLASH_BQS:
            if flash_smem_bytes(bq, d) <= FLASH_MAX_SMEM:  # not 128 rows at D = 128
                check(f"D{d}_bq{bq}", 2, 4, 160, 200, d, True, bq=bq)
    # above the tuned path: the wide-head path, picked by D alone
    wide = check(f"D{FLASH_MAX_D + 8}", 2, 4, 160, 200, FLASH_MAX_D + 8, True)
    if wide["plan"]["passes"] < 2:
        raise AssertionError(f"D = {FLASH_MAX_D + 8} did not take the wide-head path")
    return {"shapes": main, "attributes": attributes, **worst}


def flash_plan_variants(torch, dev, seed: int = 0) -> None:
    """The timed long shapes under both query tiles (device time), to
    check the plan's choice of ``bq``; not part of the main run."""
    from predictionio_tpu_torch.ops.cuda_kernels import (
        FLASH_BQS,
        flash_attention_fwd,
        flash_plan_for,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)
    for b, h, lq, d in ((8, 4, 2048, 64), (64, 4, 64, 16), (1, 4, 64, 16)):
        q, k, v = (torch.randn((b, h, lq, d), generator=gen, device=dev) for _ in range(3))
        for causal in (True, False):
            chosen = flash_plan_for(q, k, causal)
            for bq in FLASH_BQS:
                plan = flash_plan_for(q, k, causal, bq)
                fn = lambda: flash_attention_fwd(q, k, v, causal, plan=plan)  # noqa: E731
                emit({"phase": "attention_variant", "B": b, "H": h, "L": lq, "D": d,
                      "causal": causal, "bq": bq, "chosen_bq": chosen.bq,
                      "blocks_per_sm": plan.blocks_per_sm,
                      "ms": time_ms(torch, fn), "device_ms": device_time(torch, fn)["ms"]})


def synth_ml1m_histories(seed: int):
    """Time-ordered histories of ML-1M's published shape: 6,040 users,
    3,706 items, 1,000,209 interactions, at least 20 per user (the rest
    spread lognormally, as ML-1M's long tail is), item popularity
    Zipf-like (exponent 0.8 over a shuffled catalogue) and a learnable
    rule: with probability 0.5 the next item is ``(prev + 1) mod V``.
    Returns (user ids, per-user lists of item ids)."""
    rng = np.random.default_rng(seed)
    activity = rng.lognormal(0.0, 0.9, ML1M_USERS)
    extra = rng.multinomial(
        ML1M_INTERACTIONS - ML1M_MIN_PER_USER * ML1M_USERS, activity / activity.sum())
    lengths = ML1M_MIN_PER_USER + extra
    pop = 1.0 / np.arange(1, ML1M_ITEMS + 1) ** 0.8
    draws = rng.permutation(ML1M_ITEMS)[
        rng.choice(ML1M_ITEMS, size=ML1M_INTERACTIONS, p=pop / pop.sum())]
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    reset = rng.random(ML1M_INTERACTIONS) >= 0.5
    reset[starts] = True  # a history starts with a popularity draw
    pos = np.arange(ML1M_INTERACTIONS)
    anchor = np.maximum.accumulate(np.where(reset, pos, 0))
    items = (draws[anchor] + (pos - anchor)) % ML1M_ITEMS
    names = np.array([f"i{n}" for n in range(ML1M_ITEMS)], dtype=object)
    seqs = [chunk.tolist() for chunk in np.split(names[items], starts[1:])]
    return [f"u{u}" for u in range(ML1M_USERS)], seqs


def _seq_scores(torch, module, tokens, pad_id, attention_fn=None):
    """Next-item log-probabilities at the last position, PAD at -inf
    (``SeqRecAlgorithm.predict``'s scoring, for a batch of rows)."""
    with torch.no_grad():
        logits = module(tokens, attention_fn=attention_fn)[:, -1]
        scores = torch.log_softmax(logits, dim=-1)
        scores[:, pad_id] = float("-inf")
    return scores


def phase_seqrec_train(torch, dev, seed: int, registry) -> dict:
    from predictionio_tpu_torch.controller import (
        DataSource,
        Engine,
        EngineParams,
        FirstServing,
    )
    from predictionio_tpu_torch.models import sequencerec as seq
    from predictionio_tpu_torch.ops.attention import flash_attention
    from predictionio_tpu_torch.ops.cuda_kernels import flash_attention_fwd
    from predictionio_tpu_torch.workflow import WorkflowContext, load_models, run_train

    t0 = time.monotonic()
    user_ids, seqs = synth_ml1m_histories(seed)
    generate_s = time.monotonic() - t0
    training = seq.TrainingData(user_ids=user_ids, sequences=seqs)

    class SmokeSeqSource(DataSource):
        def read_training(self, ctx):
            return training

    engine = Engine({"": SmokeSeqSource}, {"": seq.SeqPreparator},
                    {"transformer": seq.SeqRecAlgorithm}, {"": FirstServing})
    params = seq.SeqRecAlgorithmParams(**SEQ_PARAMS)
    prep_params = seq.SeqPreparatorParams(seq_len=SEQ_LEN, window_stride=SEQ_STRIDE)
    ep = EngineParams(preparator_params=("", prep_params),
                      algorithm_params_list=[("transformer", params)])
    ctx = WorkflowContext(device=dev)
    ctx.profile = {}
    flash_attention_fwd.launches = 0  # main path starts here
    t1 = time.monotonic()
    instance_id = run_train(engine, ep, registry, engine_id="seqrec", ctx=ctx)
    wall_s = time.monotonic() - t1
    launches = flash_attention_fwd.launches  # main path ends here
    expected = params.n_layers * params.steps
    if launches != expected:
        raise AssertionError(f"run_train launched the attention kernel {launches} "
                             f"times, expected {expected}")
    prof = ctx.profile
    losses = prof["losses"]
    last20 = float(np.mean(losses[-20:]))
    if not (np.isfinite(losses).all() and last20 < losses[0]):
        raise AssertionError(f"training did not lower the loss: first {losses[0]}, "
                             f"last 20 {last20}")
    (model,) = load_models(registry, instance_id)
    model.sanity_check()

    t2 = time.monotonic()
    pd = seq.SeqPreparator(prep_params).prepare(None, training)
    prepare_s = time.monotonic() - t2
    windows = torch.from_numpy(pd.windows).to(dev)

    # one more step of the trained weights, alone under the profiler
    module = seq.SeqRecTransformer(model.params, params.n_heads).to(dev)
    opt = seq.adamw(module, params.learning_rate)
    batch = windows[:params.batch_size]
    seq.train_step(module, opt, batch, pd.pad_id, params)
    profiled = device_profile(
        torch, lambda: seq.train_step(module, opt, batch, pd.pad_id, params))
    profiled.pop("result")

    # kernel against plain attention, 3 steps each from the seeded table
    short = dataclasses.replace(params, steps=SEQ_PARITY_STEPS)
    fixed = windows[-params.batch_size:, :-1]
    runs = {}
    for name, fn in (("kernel", None), ("plain", flash_attention)):
        t = time.monotonic()
        trained = seq.train_transformer(pd, short, dev, attention_fn=fn)
        torch.cuda.synchronize()
        with torch.no_grad():
            logits = trained(fixed, attention_fn=fn)
        runs[name] = (dict(seq._leaves(trained.to_numpy())), logits, time.monotonic() - t)
    (wk, lk, kernel_s), (wp, lp, plain_s) = runs["kernel"], runs["plain"]
    parity = {"steps": SEQ_PARITY_STEPS, "kernel_s": kernel_s, "plain_s": plain_s,
              "max_abs_diff": {name: float(np.abs(wk[name] - wp[name]).max()) for name in wk},
              "logits_max_abs_diff": float((lk - lp).abs().max())}
    ok = bool(torch.allclose(lk, lp, rtol=SEQ_TRAIN_RTOL, atol=SEQ_TRAIN_ATOL)) and all(
        np.allclose(wk[name], wp[name], rtol=SEQ_TRAIN_RTOL, atol=SEQ_TRAIN_ATOL)
        for name in ("embed", "pos"))
    parity["agree"] = ok

    # in-sample HR@10 of each sampled user's last item, for information
    rng = np.random.default_rng(seed + 1)
    sample = rng.choice(len(user_ids), size=HR_USERS, replace=False)
    item_map = model.item_map
    ctx_rows, targets = [], []
    for u in sample:
        hist = [item_map[i] for i in seqs[u]]
        ctx_rows.append([pd.pad_id] * max(0, SEQ_LEN - len(hist) + 1) + hist[:-1][-SEQ_LEN:])
        targets.append(hist[-1])
    served = model.device_module(dev)
    tokens = torch.tensor(ctx_rows, device=dev)
    top = torch.cat([_seq_scores(torch, served, tokens[i:i + 250], pd.pad_id).topk(10).indices
                     for i in range(0, HR_USERS, 250)]).cpu().numpy()
    target = np.asarray(targets)
    counts = np.bincount([item_map[i] for s in seqs for i in s], minlength=len(item_map))
    popular = np.argsort(-counts, kind="stable")[:10]
    out = {
        "phase": "seqrec_train",
        "instance": instance_id,
        "users": len(user_ids), "items": len(item_map),
        "interactions": sum(len(s) for s in seqs),
        "windows": int(pd.windows.shape[0]),
        "params": SEQ_PARAMS, "seq_len": SEQ_LEN, "window_stride": SEQ_STRIDE,
        "generate_s": generate_s,
        "prepare_s": prepare_s,
        "wall_s": wall_s,
        "loop_s": prof["loop_s"],
        "step_ms": prof["loop_s"] / prof["steps"] * 1e3,
        "launches": launches,
        "loss_first": losses[0],
        "loss_last20_mean": last20,
        "loss_every_50": losses[::50],
        "profiled_step": profiled,
        "parity": parity,
        "hr_at_10": {"users": HR_USERS, "in_sample": True,
                     "model": float((top == target[:, None]).any(axis=1).mean()),
                     "most_popular": float(np.isin(target, popular).mean())},
    }
    emit(out)
    if not ok:
        raise AssertionError(f"kernel and plain training disagree: {parity}")
    return {"out": out, "seqs": seqs}


def phase_seqrec_slice(torch, dev, seed: int, registry, instance_id: str,
                       seqs) -> dict:
    from predictionio_tpu_torch.models import sequencerec as seq
    from predictionio_tpu_torch.ops.attention import flash_attention
    from predictionio_tpu_torch.ops.cuda_kernels import flash_attention_fwd
    from predictionio_tpu_torch.workflow import (
        ServerConfig,
        create_query_server,
        load_models,
    )

    rng = np.random.default_rng(seed + 2)
    (model,) = load_models(registry, instance_id)
    params = seq.SeqRecAlgorithmParams(**SEQ_PARAMS)
    algo = seq.SeqRecAlgorithm(params, device=dev)
    module = model.device_module(dev)
    pad_id, n_items = len(model.item_map), len(model.item_map)
    inv = model.item_map.inverse

    def bodies():
        users = rng.choice(len(seqs), size=40, replace=False)
        out = [{"user": f"u{u}", "num": 1 + j % 20} for j, u in enumerate(users)]
        for j, u in enumerate(rng.choice(len(seqs), size=22, replace=False)):
            hist = seqs[u]
            end = int(rng.integers(1, len(hist) + 1))
            start = max(0, end - int(rng.integers(1, 2 * SEQ_LEN)))
            out.append({"recent_items": hist[start:end], "num": 5 + j})
        out += [{"user": "nobody-1", "num": 5},
                {"recent_items": ["ghost-1", "ghost-2"], "num": 5}]
        return out

    def forwards(batch):
        return sum(bool(algo._tokens_for(model, seq.Query(**b))) for b in batch)

    def checked(rnd, batch, answers, wall):
        bad = []
        for body, (status, data, _) in zip(batch, answers):
            tokens = algo._tokens_for(model, seq.Query(**body))
            if status != 200:
                bad.append((body, status, data))
                continue
            if not tokens:
                if data != {"itemScores": []}:
                    bad.append((body, data))
                continue
            row = [pad_id] * (model.seq_len - len(tokens)) + list(tokens)
            scores = _seq_scores(torch, module, torch.tensor([row], device=dev), pad_id,
                                 attention_fn=flash_attention)[0]
            k = min(body["num"], n_items)
            # the served order: score descending, the lower index first on ties
            want_s, want_i = (t.cpu().numpy()
                              for t in seq.top_k_lower_index_first(scores, k))
            got = data["itemScores"]
            got_s = np.array([x["score"] for x in got], dtype=np.float32)
            close = (len(got) == k and np.isclose(
                got_s, want_s, rtol=SEQ_SERVE_RTOL, atol=SEQ_SERVE_ATOL))
            same = [x["item"] for x in got] == [inv[int(i)] for i in want_i]
            if not (len(got) == k and np.all(close) and same):
                bad.append((body, got[:3]))
        if bad:
            raise AssertionError(f"served answers disagree with plain: {bad[:3]}")
        lat = np.array([a[2] for a in answers]) * 1e3
        return {"round": rnd, "queries": len(batch), "forwards": forwards(batch),
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "max_ms": float(lat.max()), "burst_wall_ms": wall * 1e3}

    t0 = time.monotonic()
    server = create_query_server(
        seq.engine_factory(),
        ServerConfig(ip="127.0.0.1", port=0, device=dev, engine_instance_id=instance_id),
        registry=registry, block=False,
    )
    deploy_s = time.monotonic() - t0
    try:
        port = server.bound_port

        def burst():
            batch = bodies()
            t = time.monotonic()
            with ThreadPoolExecutor(max_workers=len(batch)) as pool:
                answers = list(pool.map(lambda b: _post_query(port, b), batch))
            return batch, answers, time.monotonic() - t

        flash_attention_fwd.launches = 0  # main path starts here
        sent = [burst() for _ in range(SEQ_HTTP_ROUNDS)]
        # one more burst, its requests alone under the profiler
        profiled = device_profile(torch, burst)
        sent.append(profiled.pop("result"))
        launches = flash_attention_fwd.launches  # main path ends here
        status = _get_json(port, "/status.json")
    finally:
        server.shutdown()
        server.server_close()
    rounds = [checked(rnd, *s) for rnd, s in enumerate(sent)]
    served = sum(r["forwards"] for r in rounds)
    if status.get("engineInstance") != instance_id:
        raise AssertionError(f"deployed {status.get('engineInstance')}, trained {instance_id}")
    if launches != params.n_layers * served:
        raise AssertionError(f"{launches} attention launches for {served} forwards "
                             f"of {params.n_layers} layers")
    out = {
        "phase": "seqrec_slice",
        "instance": instance_id,
        "deploy_s": deploy_s,
        "http": rounds,
        "http_profiled": profiled,
        "forwards_served": served,
        "launches": launches,
        "status_stats": status.get("stats"),
        "batching": status.get("batching"),
    }
    emit(out)
    return out


def _http(port: int, method: str, path: str, body=None):
    """One request to a local server: (status, decoded JSON body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = None if body is None else json.dumps(body)
        conn.request(method, path, data, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def synth_ml1m_events(seed: int):
    """``synth_ml1m_histories(seed)`` as ``rate`` events: string ids
    ``u<n>`` / ``i<n>``, a seeded rating in {0.5, 1.0, ..., 5.0}, and
    event times that rise by one second an event, user after user, so each
    user's history is its events in time order. Returns (events, user
    ids, histories, ratings)."""
    import datetime as dt

    from predictionio_tpu_torch.storage import Event

    user_ids, seqs = synth_ml1m_histories(seed)
    ratings = np.random.default_rng(seed + 3).integers(
        1, 11, sum(map(len, seqs))).astype(np.float64) / 2
    t0 = dt.datetime(2000, 1, 1, tzinfo=dt.timezone.utc)
    second = dt.timedelta(seconds=1)
    events, k = [], 0
    for user, items in zip(user_ids, seqs):
        for item in items:
            events.append(Event(
                event="rate", entity_type="user", entity_id=user,
                target_entity_type="item", target_entity_id=item,
                properties={"rating": float(ratings[k])},
                event_time=t0 + k * second, creation_time=t0))
            k += 1
    return events, user_ids, seqs, ratings


def events_through_the_server(base: str, events) -> dict:
    """The Event Server over a SQLite app with an access key: 20 batch
    POSTs of 50 events, single POSTs (one twice with one
    ``idempotencyKey``), then reads by filter and by id, a DELETE, the
    401 path and ``/stats.json``."""
    from predictionio_tpu_torch.api import EventServerConfig, create_event_server
    from predictionio_tpu_torch.storage import AccessKey, App, StorageRegistry

    registry = StorageRegistry({"PIO_FS_BASEDIR": f"{base}/event_server"})
    md = registry.get_metadata()
    app_id = md.app_insert(App(id=0, name="chip-smoke"))
    key = md.access_key_insert(AccessKey(key="", appid=app_id))
    server = create_event_server(EventServerConfig(ip="127.0.0.1", port=0, stats=True),
                                 registry=registry, block=False)
    sent = events[: HTTP_BATCHES * HTTP_BATCH + HTTP_SINGLES]
    wire = [e.to_json_dict() for e in sent]
    seconds = {}
    try:
        port, q = server.bound_port, f"?accessKey={key}"
        t = time.monotonic()
        for b in range(HTTP_BATCHES):
            status, results = _http(port, "POST", f"/batches/events.json{q}",
                                    wire[b * HTTP_BATCH:(b + 1) * HTTP_BATCH])
            if status != 200 or [r["status"] for r in results] != [201] * HTTP_BATCH:
                raise AssertionError(f"batch {b}: {status} {results[:2]}")
        seconds["batches"] = time.monotonic() - t
        t = time.monotonic()
        ids = []
        for j, body in enumerate(wire[HTTP_BATCHES * HTTP_BATCH:]):
            body = dict(body, idempotencyKey=f"smoke-{j}")
            status, out = _http(port, "POST", f"/events.json{q}", body)
            if status != 201:
                raise AssertionError(f"single POST {j}: {status} {out}")
            ids.append(out["eventId"])
        status, again = _http(port, "POST", f"/events.json{q}",
                              dict(wire[-HTTP_SINGLES], idempotencyKey="smoke-0"))
        if status != 201 or again["eventId"] != ids[0]:
            raise AssertionError(f"a repeated idempotencyKey gave {status} {again}")
        seconds["singles"] = time.monotonic() - t
        t = time.monotonic()
        status, stored = _http(port, "GET", f"/events.json{q}&limit=-1")
        key_of = lambda e: (e["entityId"], e["targetEntityId"], e["eventTime"],  # noqa: E731
                            e["properties"]["rating"])
        if status != 200 or sorted(map(key_of, stored)) != sorted(map(key_of, wire)):
            raise AssertionError(f"read back {len(stored)} events of {len(wire)} sent")
        status, one = _http(port, "GET", f"/events/{ids[1]}.json{q}")
        if status != 200 or key_of(one) != key_of(wire[-HTTP_SINGLES + 1]):
            raise AssertionError(f"GET by id: {status} {one}")
        deleted = _http(port, "DELETE", f"/events/{ids[1]}.json{q}")
        gone = _http(port, "GET", f"/events/{ids[1]}.json{q}")[0]
        left = len(_http(port, "GET", f"/events.json{q}&limit=-1")[1])
        unauthorized = _http(port, "POST", "/events.json?accessKey=wrong", wire[0])
        _, stats = _http(port, "GET", f"/stats.json{q}")
        seconds["reads"] = time.monotonic() - t
    finally:
        server.shutdown()
        server.server_close()
    posted = len(sent) + 1
    codes = {c["key"]: c["value"] for c in stats["longLive"]["statusCode"]}
    if (deleted != (200, {"message": "Found"}) or gone != 404 or left != len(sent) - 1
            or unauthorized != (401, {"message": "Invalid accessKey."})
            or codes != {201: posted}):
        raise AssertionError(f"delete {deleted}, then {gone}, {left} left, "
                             f"401 path {unauthorized}, stats {codes}")
    return {"sent": len(sent), "posts": posted, "stored": len(stored),
            "after_delete": left, "stats_201": codes[201], "seconds": seconds}


@contextlib.contextmanager
def events_store(base: str):
    """The process-wide registry of the events phase's store for the
    block: EVENTDATA on the native event log under ``base`` (the same
    log in every block), metadata and models on SQLite beside it. The
    ``PIO_STORAGE_*`` variables are restored, and the registry rebuilt,
    after it."""
    import os

    from predictionio_tpu_torch.storage import NativeEventStore, get_registry

    env = {
        "PIO_STORAGE_SOURCES_EVENTLOG_TYPE": "native",
        "PIO_STORAGE_SOURCES_EVENTLOG_PATH": f"{base}/event_log",
        "PIO_STORAGE_SOURCES_LOCAL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_LOCAL_PATH": f"{base}/events_phase",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EVENTLOG",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "LOCAL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "LOCAL",
    }
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        registry = get_registry(refresh=True)
        store = registry.get_events()
        if not isinstance(store, NativeEventStore):
            raise AssertionError(f"EVENTDATA resolved to {type(store).__name__}")
        yield registry
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        get_registry(refresh=True)


def als_burst(torch, dev, server, model, user_ids, rng, max_num: int = 50) -> dict:
    """``HTTP_QUERIES`` concurrent ``POST /queries.json`` to a deployed ALS
    ``model`` (known users drawn from ``user_ids``, two unknown ones),
    every answer held to the plain top-k on the model's tables (scores
    rtol/atol 1e-5, ids equal or tied; unknown users answer no items).
    The top-k launch count is reset just before the burst and read just
    after it. Fails on any wrong answer or when the kernel never ran."""
    from predictionio_tpu_torch.ops.cuda_kernels import (
        top_k_streaming,
        top_k_streaming_reference,
    )

    users = [str(u) for u in rng.choice(user_ids, size=HTTP_QUERIES - 2, replace=False)]
    bodies = [{"user": u, "num": 1 + j % max_num} for j, u in enumerate(users)]
    bodies += [{"user": "nobody-1", "num": 5}, {"user": "nobody-2", "num": max_num}]
    uf = torch.from_numpy(model.user_factors).to(dev)
    itf = torch.from_numpy(model.item_factors).to(dev)
    rows = torch.tensor([model.user_map[u] for u in users], device=dev)
    want_s, want_i = (x.cpu().numpy() for x in top_k_streaming_reference(
        uf[rows].contiguous(), itf, max_num))
    inv = model.item_map.inverse
    top_k_streaming.launches = 0  # main path starts here
    t = time.monotonic()
    with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
        answers = list(pool.map(lambda b: _post_query(server.bound_port, b), bodies))
    burst_s = time.monotonic() - t
    launches = top_k_streaming.launches  # main path ends here
    bad = []
    for j, (body, (status, data, _)) in enumerate(zip(bodies, answers)):
        if status != 200:
            bad.append((body, status))
        elif j >= len(users):
            if data != {"itemScores": []}:
                bad.append((body, data))
        else:
            k = min(body["num"], len(inv))
            got = data["itemScores"]
            got_s = np.array([x["score"] for x in got], dtype=np.float32)
            close = len(got) == k and np.isclose(got_s, want_s[j][:k],
                                                 rtol=RTOL, atol=ATOL)
            same = np.array([x["item"] == inv[int(i)] for x, i in zip(got, want_i[j])])
            if not (len(got) == k and np.all(close) and np.all(same | close)):
                bad.append((body, got[:3]))
    if bad or launches < 1:
        raise AssertionError(f"served answers disagree: {bad[:3]}; "
                             f"{launches} top-k launches")
    return {"bodies": bodies, "bad": bad, "burst_s": burst_s, "launches": launches}


def phase_events(torch, dev, seed: int, base: str) -> dict:
    """The training infeed from events: ML-1M-shaped rate events bulk
    written into the native event log through the registry's ``native``
    family, 1,000 of them through the Event Server, the ratings scan
    against the chunked path, then ALS (rank 50) and the sequence
    recommender trained by ``run_train`` through the templates' own
    DataSources and the ALS instance served over HTTP."""
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.models import sequencerec as seq
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops.cuda_kernels import (
        flash_attention_fwd,
        gramian_fused,
        spd_solve,
    )
    from predictionio_tpu_torch.workflow import (
        ServerConfig,
        WorkflowContext,
        create_query_server,
        load_models,
        run_train,
        stream_ratings,
    )
    from predictionio_tpu_torch.workflow.infeed import _stream_ratings_chunked

    seconds = {}
    t = time.monotonic()
    events, user_ids, seqs, ratings = synth_ml1m_events(seed)
    seconds["generate"] = time.monotonic() - t

    with events_store(base) as registry:
        store = registry.get_events()
        t = time.monotonic()
        for j in range(0, len(events), EVENTS_WRITE_CHUNK):
            store.write(events[j:j + EVENTS_WRITE_CHUNK], EVENTS_APP)
        seconds["bulk_write"] = time.monotonic() - t
        ingest = {"events": len(events), "seconds": seconds["bulk_write"],
                  "events_per_s": len(events) / seconds["bulk_write"]}

        t = time.monotonic()
        served_events = events_through_the_server(base, events)
        seconds["event_server"] = time.monotonic() - t

        # the infeed: the C++ ratings scan against the chunked path
        rules = {"rate": "rating"}
        t = time.monotonic()
        fast = stream_ratings(store, EVENTS_APP, rules)
        seconds["scan_native"] = time.monotonic() - t
        t = time.monotonic()
        chunked = _stream_ratings_chunked(store, EVENTS_APP, rules)
        seconds["scan_chunked"] = time.monotonic() - t
        for name in ("users", "items", "ratings"):
            a, b = getattr(fast, name), getattr(chunked, name)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"native scan {name} differs from the chunked path")
        if (fast.user_map.to_dict() != chunked.user_map.to_dict()
                or fast.item_map.to_dict() != chunked.item_map.to_dict()):
            raise AssertionError("native scan id maps differ from the chunked path")
        u_names = np.array([fast.user_map.inverse[i] for i in range(len(fast.user_map))])
        i_names = np.array([fast.item_map.inverse[i] for i in range(len(fast.item_map))])
        gen_users = np.repeat(np.array(user_ids), [len(s) for s in seqs])
        gen_items = np.array([i for s in seqs for i in s])
        if not (np.array_equal(u_names[fast.users], gen_users)
                and np.array_equal(i_names[fast.items], gen_items)
                and np.array_equal(fast.ratings, ratings.astype(np.float32))):
            raise AssertionError("the scanned ratings are not the events written")

        # ALS from the store: run_train through RecDataSource
        params = rec.ALSAlgorithmParams(rank=RANK, num_iterations=TRAIN_ITERS,
                                        lambda_=LAMBDA, seed=TRAIN_SEED)
        ep = EngineParams(
            data_source_params=("", rec.RecDataSourceParams(app_id=EVENTS_APP,
                                                            event_names=("rate",))),
            algorithm_params_list=[("als", params)])
        ctx = WorkflowContext(device=dev)
        ctx.profile = {}
        gramian_fused.launches = spd_solve.launches = 0  # main path starts here
        t = time.monotonic()
        als_instance = run_train(rec.engine_factory(), ep, registry,
                                 engine_id="events-als", ctx=ctx)
        seconds["als_run_train"] = time.monotonic() - t
        als_launches = {"gramian_fused": gramian_fused.launches,
                        "spd_solve": spd_solve.launches}  # main path ends here
        if min(als_launches.values()) < 1 or ctx.profile["host_prep_path"] != "native":
            raise AssertionError(f"ALS from events: {als_launches}, "
                                 f"{ctx.profile['host_prep_path']}")
        (model,) = load_models(registry, als_instance)
        factors = als.ALSFactors(torch.from_numpy(model.user_factors).to(dev),
                                 torch.from_numpy(model.item_factors).to(dev), RANK)
        train_rmse = als.rmse(factors, fast.users, fast.items, fast.ratings)
        if not np.isfinite(train_rmse):
            raise AssertionError(f"ALS from events: train RMSE {train_rmse}")

        # serve it: a burst of queries by string user id, held to the plain top-k
        server = create_query_server(
            rec.engine_factory(),
            ServerConfig(ip="127.0.0.1", port=0, device=dev,
                         engine_instance_id=als_instance),
            registry=registry, block=False)
        try:
            burst = als_burst(torch, dev, server, model, user_ids,
                              np.random.default_rng(seed + 4))
        finally:
            server.shutdown()
            server.server_close()
        seconds["serve_burst"] = burst["burst_s"]
        bodies, bad, topk_launches = burst["bodies"], burst["bad"], burst["launches"]

        # the sequence recommender from the store
        seq_source = seq.SeqDataSource(seq.SeqDataSourceParams(
            app_id=EVENTS_APP, event_names=("rate",)))
        t = time.monotonic()
        td = seq_source.read_training(None)
        seconds["seq_read"] = time.monotonic() - t
        if dict(zip(td.user_ids, td.sequences)) != dict(zip(user_ids, seqs)):
            raise AssertionError("SeqDataSource histories differ from the generator's")
        seq_params = seq.SeqRecAlgorithmParams(**dict(SEQ_PARAMS, steps=EVENTS_SEQ_STEPS))
        seq_ep = EngineParams(
            data_source_params=("", seq_source.params),
            preparator_params=("", seq.SeqPreparatorParams(seq_len=SEQ_LEN,
                                                           window_stride=SEQ_STRIDE)),
            algorithm_params_list=[("transformer", seq_params)])
        seq_ctx = WorkflowContext(device=dev)
        seq_ctx.profile = {}
        flash_attention_fwd.launches = 0  # main path starts here
        t = time.monotonic()
        seq_instance = run_train(seq.engine_factory(), seq_ep, registry,
                                 engine_id="events-seqrec", ctx=seq_ctx)
        seconds["seq_run_train"] = time.monotonic() - t
        flash_launches = flash_attention_fwd.launches  # main path ends here
        if flash_launches != seq_params.n_layers * EVENTS_SEQ_STEPS:
            raise AssertionError(f"seqrec from events: {flash_launches} attention launches")
        losses = seq_ctx.profile["losses"]
        (seq_model,) = load_models(registry, seq_instance)
        seq_model.sanity_check()
    out = {
        "phase": "events",
        "events": len(events), "users": len(user_ids), "items": len(fast.item_map),
        "bulk_write": ingest,
        "event_server": served_events,
        "scan": {"native_s": seconds["scan_native"], "chunked_s": seconds["scan_chunked"],
                 "ratings": int(len(fast.users)), "identical": True},
        "als": {"instance": als_instance, "wall_s": seconds["als_run_train"],
                "host_prep_s": {"path": ctx.profile["host_prep_path"],
                                "bucketize": ctx.profile["bucketize_s"],
                                "sort": ctx.profile["sort_s"],
                                "stage": ctx.profile["stage_s"]},
                "iteration_s": ctx.profile["iteration_s"], "launches": als_launches,
                "train_rmse": train_rmse},
        "serve": {"queries": len(bodies), "wrong": len(bad),
                  "burst_s": seconds["serve_burst"], "launches": topk_launches},
        "seqrec": {"instance": seq_instance, "wall_s": seconds["seq_run_train"],
                   "steps": EVENTS_SEQ_STEPS, "launches": flash_launches,
                   "loss_first": losses[0], "loss_last": losses[-1]},
        "seconds": seconds,
    }
    emit(out)
    return out


@contextlib.contextmanager
def patched(owner, name: str, wrap):
    """``owner.name`` replaced by ``wrap(original)`` for the block (an
    attribute inherited from a base class is removed again after it)."""
    own = name in vars(owner)
    original = getattr(owner, name)
    setattr(owner, name, wrap(original))
    try:
        yield
    finally:
        if own:
            setattr(owner, name, original)
        else:
            delattr(owner, name)


def eval_oracle(torch, dev, cand: dict, qa) -> dict:
    """One candidate's served answers to every held-out query against
    ``torch.topk(uf[idx] @ itf.T)`` on the card, in chunks of
    ``ORACLE_CHUNK`` rows: a served slot is wrong when its id is not the
    oracle's and its true score does not tie the oracle's at that slot
    (rtol/atol 1e-5), or when its served score is not its true score.
    Then Precision@K from the oracle's ids: a query's point may differ
    from the served one only where the actual item's score ties the k-th
    (counted as ``tie_queries``)."""
    model, answers = cand["model"], cand["answers"]
    umap, imap = model.user_map, model.item_map
    uf = torch.from_numpy(model.user_factors).to(dev)
    itf = torch.from_numpy(model.item_factors).to(dev)
    relevant = np.array([a.score >= EVAL_THRESHOLD for _, a in qa])
    known = np.array([umap.get(q.user) is not None for q, _ in qa])
    for j, (q, _) in enumerate(qa):
        n_got = len(answers[j].item_scores)
        if n_got != (min(q.num, len(imap)) if known[j] else 0):
            raise AssertionError(f"query {j} ({q.user}) answered {n_got} items")
    rows = np.array([umap[q.user] for (q, _), k in zip(qa, known) if k], dtype=np.int64)
    idx = np.flatnonzero(known)
    served = np.array([[imap[x.item] for x in answers[j].item_scores] for j in idx],
                      dtype=np.int64)
    served_s = np.array([[x.score for x in answers[j].item_scores] for j in idx],
                        dtype=np.float32)
    actual = np.array([-1 if imap.get(qa[j][1].item) is None else imap[qa[j][1].item]
                       for j in idx], dtype=np.int64)
    wrong = ties = bad_scores = duplicates = 0
    oracle_hit = np.zeros(len(idx), dtype=bool)
    boundary = np.zeros(len(idx), dtype=bool)
    for start in range(0, len(idx), ORACLE_CHUNK):
        stop = min(start + ORACLE_CHUNK, len(idx))
        scores = uf[torch.from_numpy(rows[start:stop]).to(dev)] @ itf.T
        vals, ids = torch.topk(scores, EVAL_K, dim=1)
        got = torch.from_numpy(served[start:stop]).to(dev)
        true = scores.gather(1, got)
        same = ids == got
        tied = torch.isclose(true, vals, rtol=RTOL, atol=ATOL)
        wrong += int((~(same | tied)).sum())
        ties += int((~same & tied).sum())
        bad_scores += int((~torch.isclose(torch.from_numpy(served_s[start:stop]).to(dev),
                                          true, rtol=RTOL, atol=ATOL)).sum())
        ordered = torch.sort(got, dim=1).values
        duplicates += int((ordered[:, 1:] == ordered[:, :-1]).sum())
        act = torch.from_numpy(actual[start:stop]).to(dev)
        oracle_hit[start:stop] = ((ids == act[:, None]).any(dim=1) & (act >= 0)).cpu().numpy()
        s_act = scores.gather(1, act.clamp_min(0)[:, None])[:, 0]
        boundary[start:stop] = ((act >= 0) & torch.isclose(
            s_act, vals[:, -1], rtol=RTOL, atol=ATOL)).cpu().numpy()
        del scores
    served_hit = np.array([qa[j][1].item in {x.item for x in answers[j].item_scores[:EVAL_K]}
                           for j in idx])
    rel_known = relevant[idx]
    n_relevant = int(relevant.sum())
    differ = rel_known & (served_hit != oracle_hit)
    return {
        "queries": len(qa), "known_users": int(known.sum()), "relevant": n_relevant,
        "wrong_ids_outside_ties": wrong, "tied_slots": ties, "bad_scores": bad_scores,
        "duplicate_ids": duplicates,
        "precision_served": float(served_hit[rel_known].sum()) / n_relevant,
        "precision_oracle": float(oracle_hit[rel_known].sum()) / n_relevant,
        "differing_points": int(differ.sum()),
        "tie_queries": int((differ & boundary).sum()),
        "untied_differing_points": int((differ & ~boundary).sum()),
    }


def eval_train_kernels(torch, dev, cand: dict) -> dict:
    """The build and the solve at a candidate's rank, held against their
    plain versions on the card as ``phase_train_kernels`` holds them (the
    build to rtol/atol 1e-4 with A exactly symmetric, the solve to
    relative error 1e-4): every bucket of the users' side of its training
    split, built from its trained item factors."""
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops.cuda_kernels import (
        gramian_fused,
        gramian_fused_reference,
        spd_solve,
        spd_solve_reference,
    )

    pd, model = cand["pd"], cand["model"]
    side = als.sort_bucket_indices(als.bucketize(
        pd.users, pd.items, pd.ratings, len(pd.user_map), len(pd.item_map)))
    staged = als.stage(side, dev)
    y = torch.from_numpy(model.item_factors).to(dev)
    build_err = solve_rel = 0.0
    widths = []
    for bucket in staged.buckets:
        w2, rhs, ridge = als._bucket_system_weights(bucket, False, cand["lambda"], 1.0)
        a_k, b_k = gramian_fused(y, bucket.idx, w2, rhs, ridge)
        x_k = spd_solve(a_k, b_k)
        torch.cuda.synchronize()
        a_p, b_p = gramian_fused_reference(y, bucket.idx, w2, rhs, ridge)
        x_p = spd_solve_reference(a_k, b_k)
        built = bool(torch.isfinite(a_k).all() and torch.isfinite(b_k).all()
                     and torch.allclose(a_k, a_p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
                     and torch.allclose(b_k, b_p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
                     and torch.equal(a_k, a_k.transpose(1, 2)))
        rel = float(((x_k - x_p).norm(dim=1) / x_p.norm(dim=1).clamp_min(1e-30)).max())
        if not (built and torch.isfinite(x_k).all() and rel < KERNEL_TOL):
            raise AssertionError(f"rank {cand['rank']} bucket K={bucket.idx.shape[1]}: "
                                 f"build agrees {built}, solve relative error {rel}")
        build_err = max(build_err, float((a_k - a_p).abs().max()),
                        float((b_k - b_p).abs().max()))
        solve_rel = max(solve_rel, rel)
        widths.append(list(bucket.idx.shape))
    return {"rank": cand["rank"], "buckets": widths, "build_max_abs_err": build_err,
            "solve_max_rel_err": solve_rel}


def phase_eval(torch, dev, seed: int, base: str) -> dict:
    """Evaluation over the events phase's store (1,000,209 rate events of
    6,040 users and 3,706 items): ``tools.run_workflow.run`` sweeps the
    recommendation template's ``RecEvaluation`` × ``RecParamsGenerator``
    (rank 8 and 16 × λ 0.01 and 0.1, 10 iterations) on the card, every
    served answer held to ``torch.topk`` and Precision@10 to the oracle's;
    then ``Engine.eval`` of the sequence template's leave-one-out split."""
    import os

    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.models import sequencerec as seq
    from predictionio_tpu_torch.ops.attention import flash_attention
    from predictionio_tpu_torch.ops.cuda_kernels import (
        flash_attention_fwd,
        gramian_fused,
        spd_solve,
        top_k_streaming,
        topk_launch_plan,
    )
    from predictionio_tpu_torch.ops.scoring import pad_pow2
    from predictionio_tpu_torch.storage import STATUS_EVALCOMPLETED
    from predictionio_tpu_torch.tools import run_workflow
    from predictionio_tpu_torch.workflow import WorkflowContext

    engine_dir = os.path.join(base, "eval_engine")
    os.makedirs(engine_dir, exist_ok=True)
    with open(os.path.join(engine_dir, "evaluation.py"), "w") as fh:
        fh.write(EVALUATION_PY)
    if rec.RecParamsGenerator().engine_params_list[0].data_source_params[1].app_id != EVENTS_APP:
        raise AssertionError("the generator's app is not the events phase's")
    seconds = {"read_eval": [], "train": [], "batch_predict": [], "topk_call": [],
               "metric": []}
    cands, state, lock = [], {}, threading.Lock()

    def stamp(key, fn, *a):
        t = time.monotonic()
        out = fn(*a)
        with lock:
            seconds[key].append(time.monotonic() - t)
        return out

    def read_eval(orig):
        def wrapped(self, ctx):
            folds = stamp("read_eval", orig, self, ctx)
            state.setdefault("qa", folds[0][2])
            return folds
        return wrapped

    def train(orig):
        def wrapped(self, ctx, pd):
            model = stamp("train", orig, self, ctx, pd)
            with lock:
                cands.append({"rank": self.params.rank, "lambda": self.params.lambda_,
                              "pd": pd, "model": model,
                              "thread": threading.current_thread().name})
            return model
        return wrapped

    def batch_predict(orig):
        def wrapped(self, model, indexed):
            out = stamp("batch_predict", orig, self, model, indexed)
            with lock:
                cand = next(c for c in cands if c["model"] is model)
                cand["answers"] = dict(out)
            return out
        return wrapped

    def fused_topk(orig):
        def wrapped(*a, **kw):
            return stamp("topk_call", lambda: (orig(*a, **kw), torch.cuda.synchronize())[0])
        return wrapped

    def calculate(orig):
        def wrapped(self, ctx, data):
            return stamp("metric", orig, self, ctx, data)
        return wrapped

    args = run_workflow.build_parser().parse_args([
        "--engine-dir", engine_dir,
        "--evaluation-class", "evaluation:RecEvaluation",
        "--engine-params-generator-class", "evaluation:RecParamsGenerator"])
    with events_store(base) as registry:
        with contextlib.ExitStack() as stack:
            for owner, name, wrap in (
                    (rec.RecDataSource, "read_eval", read_eval),
                    (rec.ALSAlgorithm, "train", train),
                    (rec.ALSAlgorithm, "batch_predict", batch_predict),
                    (rec, "top_k_for_users_fused", fused_topk),
                    (rec.PrecisionAtK, "calculate", calculate)):
                stack.enter_context(patched(owner, name, wrap))
            # main path starts here
            top_k_streaming.launches = gramian_fused.launches = spd_solve.launches = 0
            t = time.monotonic()
            instance_id = run_workflow.run(args, registry, device=dev)
            seconds["run"] = time.monotonic() - t
            launches = {"topk_streaming": top_k_streaming.launches,
                        "gramian_fused": gramian_fused.launches,
                        "spd_solve": spd_solve.launches}  # main path ends here
        row = registry.get_metadata().evaluation_instance_get(instance_id)
        if row is None or row.status != STATUS_EVALCOMPLETED or not row.evaluator_results_json:
            raise AssertionError(f"evaluation instance {instance_id}: {row}")
        result = json.loads(row.evaluator_results_json)
        with open(os.path.join(engine_dir, "best.json")) as fh:
            best = json.load(fh)
        if best["algorithms"] != result["bestEngineParams"]["algorithms"]:
            raise AssertionError(f"best.json {best['algorithms']} is not the best "
                                 f"candidate {result['bestEngineParams']['algorithms']}")
        if min(launches.values()) < 1 or len(cands) != 4:
            raise AssertionError(f"eval launches {launches}, {len(cands)} candidates")

        qa = state["qa"]
        by_params = {(s["engineParams"]["algorithms"][0]["params"]["rank"],
                      s["engineParams"]["algorithms"][0]["params"]["lambda_"]): s["score"]
                     for s in result["scores"]}
        sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
        candidates, held = [], {}
        for j, cand in enumerate(cands):
            check = eval_oracle(torch, dev, cand, qa)
            score = by_params[(cand["rank"], cand["lambda"])]
            check.update(rank=cand["rank"], lambda_=cand["lambda"], precision=score,
                         thread=cand["thread"],
                         train_s=seconds["train"][j],
                         batch_predict_s=seconds["batch_predict"][j],
                         topk_call_s=seconds["topk_call"][j])
            model = cand["model"]
            b = check["known_users"]
            b_pad = pad_pow2(b)
            plan = topk_launch_plan(b_pad, model.item_factors.shape[0], 16, sm_count,
                                    cand["rank"])
            q = torch.from_numpy(model.user_factors).to(dev)[
                torch.from_numpy(np.resize(np.arange(model.user_factors.shape[0]), b_pad))
                .to(dev)].contiguous()
            itf = torch.from_numpy(model.item_factors).to(dev)
            kernel = lambda: top_k_streaming(q, itf, 16)  # noqa: E731
            bound_ms, bound_by = topk_bound(b_pad, itf.shape[0], cand["rank"], 16)
            check["topk"] = {"B": b_pad, "N": itf.shape[0], "R": cand["rank"], "k": 16,
                             "T": plan.tiles_per_block, "n_runs": plan.n_runs,
                             "kernel_ms": time_ms(torch, kernel, 10, 2),
                             "kernel_device_ms": traced_device_ms(torch, kernel, 5, 2),
                             "bound_us": bound_ms * 1e3, "bound_by": bound_by}
            ok = (check["wrong_ids_outside_ties"] == 0 and check["bad_scores"] == 0
                  and check["duplicate_ids"] == 0
                  and check["untied_differing_points"] == 0
                  and check["precision_served"] == score)
            emit({"phase": "eval", "candidate": j, **check})
            if not ok:
                raise AssertionError(f"candidate {j} disagrees with the oracle: {check}")
            candidates.append(check)
            if cand["rank"] not in held:
                held[cand["rank"]] = eval_train_kernels(torch, dev, cand)
                emit({"phase": "eval", "train_kernels": held[cand["rank"]]})
            del q, itf
        del cands[:]
        torch.cuda.empty_cache()

        # the sequence recommender's leave-one-out evaluation
        seq_params = seq.SeqRecAlgorithmParams(**SEQ_PARAMS)
        seq_ep = EngineParams(
            data_source_params=("", seq.SeqDataSourceParams(app_id=EVENTS_APP,
                                                             event_names=("rate",))),
            preparator_params=("", seq.SeqPreparatorParams(seq_len=SEQ_LEN,
                                                           window_stride=SEQ_STRIDE)),
            algorithm_params_list=[("transformer", seq_params)])
        trained = {}

        def seq_train(orig):
            def wrapped(self, ctx, pd):
                trained["model"] = stamp_seq("train", orig, self, ctx, pd)
                return trained["model"]
            return wrapped

        seq_seconds = {}

        def stamp_seq(key, fn, *a):
            t = time.monotonic()
            out = fn(*a)
            seq_seconds[key] = time.monotonic() - t
            return out

        def seq_read_eval(orig):
            def wrapped(self, ctx):
                return stamp_seq("read_eval", orig, self, ctx)
            return wrapped

        with patched(seq.SeqRecAlgorithm, "train", seq_train), \
                patched(seq.SeqDataSource, "read_eval", seq_read_eval):
            flash_attention_fwd.launches = 0  # main path starts here
            t = time.monotonic()
            [(_, qpa)] = seq.engine_factory().eval(
                WorkflowContext(mode="Evaluation", device=dev), seq_ep)
            seq_seconds["eval"] = time.monotonic() - t
            flash_launches = flash_attention_fwd.launches  # main path ends here
    model = trained["model"]
    algo = seq.SeqRecAlgorithm(seq_params, device=dev)
    forwards = sum(bool(algo._tokens_for(model, q)) for q, _, _ in qpa)
    if flash_launches != seq_params.n_layers * (seq_params.steps + forwards):
        raise AssertionError(f"{flash_launches} attention launches for "
                             f"{seq_params.steps} steps and {forwards} forwards")
    module, pad_id, inv = model.device_module(dev), len(model.item_map), model.item_map.inverse
    bad = []
    for q, p, _ in qpa[:EVAL_SEQ_HELD]:
        tokens = algo._tokens_for(model, q)
        padded = [pad_id] * (model.seq_len - len(tokens)) + list(tokens)
        scores = _seq_scores(torch, module, torch.tensor([padded], device=dev), pad_id,
                             attention_fn=flash_attention)[0]
        want_s, want_i = (t.cpu().numpy() for t in seq.top_k_lower_index_first(
            scores, min(q.num, len(model.item_map))))
        got_s = np.array([x.score for x in p.item_scores], dtype=np.float32)
        if ([x.item for x in p.item_scores] != [inv[int(i)] for i in want_i]
                or not np.allclose(got_s, want_s, rtol=SEQ_SERVE_RTOL, atol=SEQ_SERVE_ATOL)):
            bad.append((q.recent_items[-3:], p.item_scores[:3]))
    if bad:
        raise AssertionError(f"seqrec eval answers disagree with the plain forward: {bad[:3]}")
    hits = sum(a.item in {x.item for x in p.item_scores} for _, p, a in qpa)
    out = {
        "phase": "eval",
        "instance": instance_id,
        "evaluator_results": row.evaluator_results,
        "best": {"idx": result["bestIdx"], "score": result["bestScore"],
                 "params": result["bestEngineParams"]["algorithms"][0]["params"]},
        "queries": len(qa),
        "launches": launches,
        "precision": {f"rank{c['rank']}_lambda{c['lambda_']}": c["precision"]
                      for c in candidates},
        "oracle": [{k: c[k] for k in ("rank", "lambda_", "thread", "wrong_ids_outside_ties",
                                       "tied_slots", "precision_oracle",
                                       "differing_points", "tie_queries")}
                   for c in candidates],
        "train_kernels_held": held,
        "seconds": {"run": seconds["run"], "read_eval": seconds["read_eval"],
                    "train": seconds["train"], "batch_predict": seconds["batch_predict"],
                    "topk_call": seconds["topk_call"], "metric": seconds["metric"]},
        "topk_at_eval_shape": [c["topk"] for c in candidates],
        "seqrec": {"queries": len(qpa), "forwards": forwards, "launches": flash_launches,
                   "held": EVAL_SEQ_HELD, "hr_at_10": hits / len(qpa),
                   "seconds": seq_seconds},
    }
    emit(out)
    return out


def als_against_plain(torch, dev, model, td, cfg) -> dict:
    """A trained ALS model's factors against ``cfg.iterations`` of the
    plain build and solve from the same initial table, on the same
    ratings (the data of ``td``), as ``phase_train`` holds its own run;
    and the first user solve (before any solved table is rounded to the
    gather's dtype) through the kernels against the plain versions."""
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops.cuda_kernels import (
        gramian_fused,
        gramian_fused_reference,
        spd_solve,
        spd_solve_reference,
    )

    n_u, n_i = len(td.user_map), len(td.item_map)
    ub = als.stage(als.sort_bucket_indices(
        als.bucketize(td.users, td.items, td.ratings, n_u, n_i)), dev)
    ib = als.stage(als.sort_bucket_indices(
        als.bucketize(td.items, td.users, td.ratings, n_i, n_u)), dev)
    y0 = als.init_factors(n_i, cfg.rank, cfg.seed, dev)
    x, y = als._train_loop(ub, ib, y0, cfg, gramian_fused_reference, spd_solve_reference)
    first = [als._solve_side(y0, ub, cfg.rank, cfg.implicit_prefs, cfg.lambda_, cfg.alpha,
                             y0.T @ y0 if cfg.implicit_prefs else None, cfg.gather_dtype,
                             build, solve)
             for build, solve in ((gramian_fused, spd_solve),
                                  (gramian_fused_reference, spd_solve_reference))]
    torch.cuda.synchronize()
    diff = (first[0] - first[1]).abs()
    out = {"first_user_solve": {
        "max_abs_diff": float(diff.max()),
        "beyond_tol": int((diff > FACTOR_ATOL + FACTOR_RTOL * first[1].abs()).sum())}}
    for name, got, want in (("user", model.user_factors, x), ("item", model.item_factors, y)):
        got = torch.from_numpy(got).to(dev)
        diff = (got - want).abs()
        out[name] = {
            "max_abs_diff": float(diff.max()),
            "rel_norm_diff": float(torch.linalg.norm(got - want) / torch.linalg.norm(want)),
            "beyond_tol": int((diff > FACTOR_ATOL + FACTOR_RTOL * want.abs()).sum()),
            "finite": bool(torch.isfinite(got).all()),
        }
    return out


def phase_persist(torch, dev, seed: int, base: str, registry, slice_instance: str) -> dict:
    """The DASE persistence contract on the card, over the events phase's
    store (1,000,209 rate events), with a user's ``engine.py`` loaded
    through ``workflow/loader.py``: (a) an ALS whose ``make_persistent``
    returns ``RETRAIN`` is stored as the sentinel alone and retrained at
    deploy (build and solve launches counted; the factors equal the
    trained ones bit for bit), then serves a burst; (b) an ALS model that
    saves its own tables is stored as a manifest and deploys with no build
    and no solve, its factors equal to the saved ones, then serves a
    burst; implicit-preference and bf16-gather ALS trained by
    ``run_train`` against their plain versions; seqrec at 4 heads of
    width 6 trained and served. Then (c): one ``POST /queries.json`` with
    ``num`` = 4096 to the slice phase's ML-20M-shaped instance, held to
    the plain top-k."""
    import os

    from predictionio_tpu_torch.controller import (
        RETRAIN,
        EngineParams,
        PersistentModelManifest,
    )
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.models import sequencerec as seq
    from predictionio_tpu_torch.ops.attention import flash_attention
    from predictionio_tpu_torch.ops.cuda_kernels import (
        flash_attention_fwd,
        gramian_fused,
        spd_solve,
        top_k_streaming,
        top_k_streaming_reference,
    )
    from predictionio_tpu_torch.workflow import (
        ServerConfig,
        WorkflowContext,
        create_query_server,
        load_models,
        run_train,
    )
    from predictionio_tpu_torch.workflow.loader import get_engine

    engine_dir = os.path.join(base, "persist_engine")
    os.makedirs(engine_dir, exist_ok=True)
    with open(os.path.join(engine_dir, "engine.py"), "w") as fh:
        fh.write(PERSIST_ENGINE_PY)
    engine = get_engine("engine:engine_factory", engine_dir)
    retrain_cls = engine.algorithm_class_map["retrain"]
    seconds, launches, checks = {}, {}, {}
    params = rec.ALSAlgorithmParams(rank=RANK, num_iterations=TRAIN_ITERS,
                                    lambda_=LAMBDA, seed=TRAIN_SEED)
    source = ("", rec.RecDataSourceParams(app_id=EVENTS_APP, event_names=("rate",)))

    def engine_params(name, p=params):
        return EngineParams(data_source_params=source, algorithm_params_list=[(name, p)])

    def build_solve():
        return {"gramian_fused": gramian_fused.launches, "spd_solve": spd_solve.launches}

    def deploy(eng, instance_id, reg):
        return create_query_server(
            eng, ServerConfig(ip="127.0.0.1", port=0, device=dev,
                              engine_instance_id=instance_id),
            registry=reg, block=False)

    trained = []

    def keep(orig):
        def wrapped(self, ctx, pd):
            model = orig(self, ctx, pd)
            trained.append(model)
            return model
        return wrapped

    rng = np.random.default_rng(seed + 11)
    with events_store(base) as ev_registry:
        # (a) deploy-time retrain
        with patched(retrain_cls, "train", keep):
            gramian_fused.launches = spd_solve.launches = 0  # main path starts here
            t = time.monotonic()
            a_instance = run_train(engine, engine_params("retrain"), ev_registry,
                                   engine_id="persist-retrain",
                                   ctx=WorkflowContext(device=dev))
            seconds["retrain_run_train"] = time.monotonic() - t
            launches["retrain_run_train"] = build_solve()  # main path ends here
            blob = ev_registry.get_models().get(a_instance).models
            if load_models(ev_registry, a_instance) != [RETRAIN] or len(blob) > 200:
                raise AssertionError(f"instance {a_instance} stored {len(blob)} bytes")
            gramian_fused.launches = spd_solve.launches = 0  # main path starts here
            t = time.monotonic()
            server = deploy(engine, a_instance, ev_registry)
            seconds["retrain_deploy"] = time.monotonic() - t
            launches["retrain_deploy"] = build_solve()  # main path ends here
        try:
            model = server.deployment.models[0]
            if len(trained) != 2 or model is not trained[1]:
                raise AssertionError(f"{len(trained)} trainings for the RETRAIN instance")
            same = (np.array_equal(model.user_factors, trained[0].user_factors)
                    and np.array_equal(model.item_factors, trained[0].item_factors))
            users = list(model.user_map.to_dict())
            burst = als_burst(torch, dev, server, model, users, rng)
        finally:
            server.shutdown()
            server.server_close()
        want = launches["retrain_run_train"]
        checks["retrain"] = {
            "instance": a_instance, "blob_bytes": len(blob),
            "deploy_launches_equal_training": launches["retrain_deploy"] == want,
            "factors_bit_identical": same, "served": len(burst["bodies"]),
            "wrong": len(burst["bad"]), "topk_launches": burst["launches"]}
        launches["retrain_serve"] = burst["launches"]
        emit({"phase": "persist", "stage": "retrain", **checks["retrain"],
              "launches": {k: launches[k] for k in ("retrain_run_train", "retrain_deploy")},
              "seconds": {k: seconds[k] for k in ("retrain_run_train", "retrain_deploy")}})
        if (not same or launches["retrain_deploy"] != want
                or min(want.values()) < TRAIN_ITERS):
            raise AssertionError(f"deploy-time retrain: {checks['retrain']}, {launches}")

        # (b) a self-persisting model deploys from its manifest
        t = time.monotonic()
        b_instance = run_train(engine, engine_params("saved"), ev_registry,
                               engine_id="persist-saved", ctx=WorkflowContext(device=dev))
        seconds["saved_run_train"] = time.monotonic() - t
        (manifest,) = load_models(ev_registry, b_instance)
        if not isinstance(manifest, PersistentModelManifest):
            raise AssertionError(f"instance {b_instance} stored {manifest!r}")
        where = os.path.join(engine_dir, "models", b_instance)
        saved = {n: np.load(os.path.join(where, f"{n}.npy"))
                 for n in ("user_factors", "item_factors")}
        gramian_fused.launches = spd_solve.launches = 0  # main path starts here
        t = time.monotonic()
        server = deploy(engine, b_instance, ev_registry)
        seconds["manifest_deploy"] = time.monotonic() - t
        launches["manifest_deploy"] = build_solve()  # main path ends here
        try:
            model = server.deployment.models[0]
            same = all(np.array_equal(getattr(model, n), a) for n, a in saved.items())
            burst = als_burst(torch, dev, server, model, users, rng)
        finally:
            server.shutdown()
            server.server_close()
        checks["manifest"] = {
            "instance": b_instance, "class_path": manifest.class_path,
            "model": type(model).__name__, "factors_bit_identical": same,
            "served": len(burst["bodies"]), "wrong": len(burst["bad"]),
            "topk_launches": burst["launches"]}
        launches["manifest_serve"] = burst["launches"]
        emit({"phase": "persist", "stage": "manifest", **checks["manifest"],
              "launches": launches["manifest_deploy"],
              "seconds": {k: seconds[k] for k in ("saved_run_train", "manifest_deploy")}})
        if not same or max(launches["manifest_deploy"].values()) != 0:
            raise AssertionError(f"manifest deploy: {checks['manifest']}, {launches}")

        # the ALS configurations not trained end to end on the card before
        td = rec.RecDataSource(source[1]).read_training(None)
        for name, extra in (("implicit", dict(implicit_prefs=True, alpha=1.0)),
                            ("bf16", dict(gather_dtype="bf16"))):
            p = dataclasses.replace(params, num_iterations=PARITY_ITERS, **extra)
            gramian_fused.launches = spd_solve.launches = 0  # main path starts here
            t = time.monotonic()
            instance = run_train(rec.engine_factory(), engine_params("als", p), ev_registry,
                                 engine_id=f"persist-{name}", ctx=WorkflowContext(device=dev))
            seconds[f"{name}_run_train"] = time.monotonic() - t
            launches[f"{name}_run_train"] = build_solve()  # main path ends here
            (model,) = load_models(ev_registry, instance)
            held = als_against_plain(torch, dev, model, td, rec.als_config(p))
            checks[name] = held
            emit({"phase": "persist", "stage": name, "instance": instance,
                  "launches": launches[f"{name}_run_train"],
                  "seconds": seconds[f"{name}_run_train"], **held})
            ok = held["first_user_solve"]["beyond_tol"] == 0
            for side in (held["user"], held["item"]):
                # bf16 rounds each solved table, so one float reassociation
                # flips whole bf16 ulps that grow over the iterations
                ok = ok and side["finite"] and (side["max_abs_diff"] <= BF16_MAX_ABS
                                                if name == "bf16" else side["beyond_tol"] == 0)
            if not ok or min(launches[f"{name}_run_train"].values()) < 1:
                raise AssertionError(f"{name} ALS disagrees with plain: {held}")

        # seqrec at a head width that is not a multiple of 8
        seq_params = seq.SeqRecAlgorithmParams(**dict(SEQ_PARAMS, **PERSIST_SEQ,
                                                      steps=EVENTS_SEQ_STEPS))
        seq_ep = EngineParams(
            data_source_params=("", seq.SeqDataSourceParams(app_id=EVENTS_APP,
                                                             event_names=("rate",))),
            preparator_params=("", seq.SeqPreparatorParams(seq_len=SEQ_LEN,
                                                           window_stride=SEQ_STRIDE)),
            algorithm_params_list=[("transformer", seq_params)])
        flash_attention_fwd.launches = 0  # main path starts here
        t = time.monotonic()
        seq_instance = run_train(seq.engine_factory(), seq_ep, ev_registry,
                                 engine_id="persist-seqrec-d6",
                                 ctx=WorkflowContext(device=dev))
        seconds["seqrec_d6_run_train"] = time.monotonic() - t
        launches["seqrec_d6_run_train"] = flash_attention_fwd.launches  # main path ends here
        (seq_model,) = load_models(ev_registry, seq_instance)
        server = deploy(seq.engine_factory(), seq_instance, ev_registry)
        try:
            burst = seq_burst(torch, dev, server.bound_port, seq_model, seq_params, rng)
        finally:
            server.shutdown()
            server.server_close()
    launches["seqrec_d6_serve"] = burst["launches"]
    bad, forwards = burst["bad"], burst["forwards"]
    checks["seqrec_d6"] = {"instance": seq_instance,
                           "head_width": PERSIST_SEQ["d_model"] // PERSIST_SEQ["n_heads"],
                           "served": burst["served"], "forwards": forwards, "wrong": len(bad)}
    n_layers = seq_params.n_layers
    emit({"phase": "persist", "stage": "seqrec_d6", **checks["seqrec_d6"],
          "launches": {k: launches[k] for k in ("seqrec_d6_run_train", "seqrec_d6_serve")},
          "seconds": seconds["seqrec_d6_run_train"]})
    if (bad or launches["seqrec_d6_run_train"] != n_layers * EVENTS_SEQ_STEPS
            or launches["seqrec_d6_serve"] != n_layers * forwards):
        raise AssertionError(f"seqrec at D = 6: {bad[:3]}, {launches}")

    # (c) fault B end to end: num = 4096 over 27,000 items, one HTTP query
    (model,) = load_models(registry, slice_instance)
    user = "u7"
    row = torch.tensor([model.user_map[user]], device=dev)
    want_s, want_i = (x.cpu().numpy()[0] for x in top_k_streaming_reference(
        torch.from_numpy(model.user_factors).to(dev)[row].contiguous(),
        torch.from_numpy(model.item_factors).to(dev), PERSIST_NUM))
    server = deploy(rec.engine_factory(), slice_instance, registry)
    try:
        top_k_streaming.launches = 0  # main path starts here
        t = time.monotonic()
        status, data, _ = _post_query(server.bound_port, {"user": user, "num": PERSIST_NUM})
        seconds["num4096_query"] = time.monotonic() - t
        launches["num4096_query"] = top_k_streaming.launches  # main path ends here
    finally:
        server.shutdown()
        server.server_close()
    got = data.get("itemScores", []) if status == 200 else []
    inv = model.item_map.inverse
    got_s = np.array([x["score"] for x in got], dtype=np.float32)
    close = len(got) == PERSIST_NUM and np.isclose(got_s, want_s, rtol=RTOL, atol=ATOL)
    same = len(got) == PERSIST_NUM and np.array(
        [x["item"] == inv[int(i)] for x, i in zip(got, want_i)])
    wrong = PERSIST_NUM if len(got) != PERSIST_NUM else int((~(same | close)).sum())
    checks["num4096"] = {"status": status, "items": len(got), "catalog": len(inv),
                         "wrong_ids_outside_ties": wrong,
                         "tied_slots": int((~same & close).sum()) if len(got) else 0,
                         "max_abs_err": float(np.abs(got_s - want_s).max()) if len(got) else None,
                         "launches": launches["num4096_query"]}
    if status != 200 or wrong or not np.all(close) or launches["num4096_query"] != 1:
        raise AssertionError(f"num = {PERSIST_NUM}: {checks['num4096']}")

    out = {"phase": "persist", "checks": checks, "launches": launches, "seconds": seconds,
           "by_kernel": {
               "topk_streaming": (launches["retrain_serve"] + launches["manifest_serve"]
                                  + launches["num4096_query"]),
               **{name: sum(v[name] for k, v in launches.items()
                            if isinstance(v, dict)) for name in ("gramian_fused", "spd_solve")},
               "flash_attention": (launches["seqrec_d6_run_train"]
                                   + launches["seqrec_d6_serve"])}}
    emit(out)
    return out


#: the wide phase: ranks above the build's and the solve's tuned paths (R, n
#: = 129, 200, 256) at ML-20M's bucket shapes (the users' K = 128 bucket of
#: 97,972 rows, cut by the wrapper's systems budget as training cuts it, over
#: the item table; the items' K = 32,768 bucket of 216 rows, over the user
#: table), held on its first WIDE_CHECK_ROWS rows; the solve's batch; head
#: widths above the tuned attention path at the training shape and at L =
#: 2,048; ALS at rank 200 and seqrec at d_model 256 / 1 head (D = 256)
#: trained from the events store
WIDE_RANKS = (129, 200, 256)
WIDE_BUCKETS = (("by_user", 97972, 128, N_ITEMS), ("by_item", 216, 32768, N_USERS))
WIDE_CHECK_ROWS, WIDE_SPD_B = 4096, 4096
WIDE_HEADS = (136, 192, 256)
WIDE_ATTN_SHAPES = ((64, 4, 64, 64, True), (8, 4, 2048, 2048, True),
                    (8, 4, 2048, 2048, False))
WIDE_ALS_RANK, WIDE_SEQ = 200, dict(d_model=256, n_heads=1)


def wide_bucket(torch, gen, dev, b: int, k: int, n: int, r: int):
    """A bucket of ``b`` rows of width ``k`` over an ``[n, r]`` table, as
    the ALS buckets lay it out: each row's ratings are a prefix of
    between k/4 and k slots (the rest padding), ratings 1..5, ridge λ·n_u."""
    y = torch.rand((n, r), generator=gen, device=dev) / r ** 0.5
    idx = torch.randint(0, n, (b, k), generator=gen, device=dev, dtype=torch.int32)
    counts = torch.randint(k // 4 + 1, k + 1, (b,), generator=gen, device=dev)
    mask = (torch.arange(k, device=dev)[None, :] < counts[:, None]).float()
    rhs = torch.randint(1, 6, (b, k), generator=gen, device=dev).float() * mask
    return y, idx, mask, rhs, LAMBDA * counts.float()


def wide_kernels(torch, dev, seed: int) -> dict:
    """The three general-width paths against their plain versions: the
    build at R = 129, 200, 256 at both ML-20M bucket shapes (the users'
    bucket in the slices training cuts it into) and a split bucket, the
    solve at n = 129, 200, 256 with its edge cases, attention at D = 136,
    192, 256 causal and not. Each kernel's registers and local bytes
    first (no local memory); each case prints its plan and its error, the
    timed ones the kernel's event and device time beside the plain
    version's, the library call's and the bound."""
    from predictionio_tpu_torch.ops import cuda_kernels as ck
    from predictionio_tpu_torch.ops.cuda_kernels import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
        gramian_fused,
        gramian_fused_reference,
        spd_solve,
        spd_solve_reference,
    )

    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    attrs = {"gramian_fused": {k: v for k, v in ck.gramian_kernel_attributes(dev).items()
                               if k.startswith("wide")},
             "spd_solve": ck.spd_kernel_attributes(dev)["wide"],
             "flash_attention": ck.flash_wide_kernel_attributes(dev)}
    flat = [*attrs["gramian_fused"].values(), attrs["spd_solve"], attrs["flash_attention"]]
    emit({"phase": "wide", "attributes": attrs})
    if any(a["local_bytes"] for a in flat) or max(a["regs"] for a in flat) > 64:
        raise AssertionError(f"the general-width kernels take {attrs}")
    worst = {"gramian_fused": 0.0, "spd_solve": 0.0, "flash_attention": 0.0}
    cases = {}

    def held(name, case, out, ok):
        emit({"phase": "wide", "kernel": name, "case": case, **out})
        if not ok:
            raise AssertionError(f"{name} {case} disagrees with plain: {out}")
        worst[name] = max(worst[name], out["max_abs_err"])
        cases[f"{name}:{case}"] = out

    # the build, at both bucket shapes, every wide rank
    for r in WIDE_RANKS:
        for side, b, k, n in WIDE_BUCKETS:
            y, idx, w2, rhs, ridge = wide_bucket(torch, gen, dev, b, k, n, r)
            slices = ck.gramian_row_slices(b, k, r, sm)

            def whole():
                for s0, s1 in slices:
                    gramian_fused(y, idx[s0:s1], w2[s0:s1], rhs[s0:s1], ridge[s0:s1])

            before = gramian_fused.launches
            whole()
            torch.cuda.synchronize()
            launches = gramian_fused.launches - before
            rows = min(b, WIDE_CHECK_ROWS)
            part = (y, idx[:rows], w2[:rows], rhs[:rows], ridge[:rows])
            a_k, b_k = gramian_fused(*part)
            a_2, b_2 = gramian_fused(*part)
            a_p, b_p = gramian_fused_reference(*part)
            ok = bool(torch.isfinite(a_k).all() and torch.isfinite(b_k).all()
                      and torch.allclose(a_k, a_p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
                      and torch.allclose(b_k, b_p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
                      and torch.equal(a_k, a_k.transpose(1, 2)))
            same = bool(torch.equal(a_k, a_2) and torch.equal(b_k, b_2))
            err = max(float((a_k - a_p).abs().max()), float((b_k - b_p).abs().max()))
            del a_k, b_k, a_2, b_2, a_p, b_p
            valid = int(w2.sum())
            plan = ck.gramian_plan(slices[0][1] - slices[0][0], k, r, sm)
            out = {"R": r, "side": side, "B": b, "K": k, "N": n, "slices": len(slices),
                   "launches": launches, "check_rows": rows,
                   "plan": {"path": plan.path, "tiles": plan.tiles, "kc": plan.chunk,
                            "S": plan.n_chunks, "blocks": plan.blocks,
                            "blocks_per_sm": plan.blocks_per_sm},
                   "max_abs_err": err, "symmetric": ok, "bit_identical": same}
            out["kernel_ms"] = time_ms(torch, whole, 2, 1)
            out["kernel_device_ms"] = traced_device_ms(
                torch, whole, 2, len(slices) * (2 if plan.n_chunks > 1 else 1))
            bound_ms, out["bound_by"] = gramian_bound(b, k, n, r, valid, False)
            out["bound_us"] = bound_ms * 1e3
            # the check rows alone: kernel, plain and library on the same inputs
            sub_valid = int(w2[:rows].sum())
            out["rows_kernel_ms"] = time_ms(torch, lambda: gramian_fused(*part), 3, 1)
            out["rows_plain_ms"] = time_ms(torch, lambda: gramian_fused_reference(*part), 2, 1)
            out["rows_library_ms"] = time_ms(
                torch, lambda: _gramian_library(torch, *part[:4]), 2, 1)
            out["rows_bound_us"] = gramian_bound(rows, k, n, r, sub_valid, False)[0] * 1e3
            held("gramian_fused", f"{side}_R{r}", out, ok and same and launches == len(slices))
            del y, idx, w2, rhs, ridge
            torch.cuda.empty_cache()
    # a bucket of a few rows is split into chunks and reduced in chunk order
    y, idx, w2, rhs, ridge = wide_bucket(torch, gen, dev, 16, 8193, 5000, 200)
    w2[3], rhs[3], ridge[3] = 0.0, 0.0, 0.0
    a_k, b_k = gramian_fused(y, idx, w2, rhs, ridge, y.T @ y)
    a_p, b_p = gramian_fused_reference(y, idx, w2, rhs, ridge, y.T @ y)
    plan = ck.gramian_plan(16, 8193, 200, sm)
    ok = bool(torch.allclose(a_k, a_p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
              and torch.allclose(b_k, b_p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
              and torch.equal(a_k, a_k.transpose(1, 2)) and plan.n_chunks > 1
              and torch.equal(b_k[3], torch.zeros_like(b_k[3])))
    held("gramian_fused", "split_R200_K8193", {
        "S": plan.n_chunks, "kc": plan.chunk,
        "max_abs_err": max(float((a_k - a_p).abs().max()), float((b_k - b_p).abs().max()))},
        ok)

    # the solve
    def spd_systems(bsz, n, k):
        g = torch.randn((bsz, k, n), generator=gen, device=dev)
        a = torch.bmm(g.transpose(1, 2), g)
        a += LAMBDA * k * torch.eye(n, device=dev)
        return a, torch.randn((bsz, n), generator=gen, device=dev)

    def rel_err(x, ref):
        return float(((x - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)).max())

    for n in WIDE_RANKS:
        a, b = spd_systems(WIDE_SPD_B, n, 2 * n)
        x_k = spd_solve(a, b)
        x_p = spd_solve_reference(a, b)
        rel = rel_err(x_k, x_p)
        plan = ck.spd_launch_plan(WIDE_SPD_B, n, sm)
        out = {"n": n, "B": WIDE_SPD_B, "max_rel_err": rel,
               "max_abs_err": float((x_k - x_p).abs().max()),
               "plan": {"path": plan.path, "threads": 32 * plan.warps, "smem": plan.smem,
                        "scratch": plan.scratch, "blocks_per_sm": plan.blocks_per_sm,
                        "waves": plan.waves},
               "bit_identical": bool(torch.equal(x_k, spd_solve(a, b)))}
        kernel = lambda: spd_solve(a, b)  # noqa: E731
        library = lambda: torch.cholesky_solve(b[:, :, None], torch.linalg.cholesky(a))  # noqa: E731
        out["kernel_ms"] = time_ms(torch, kernel, 5, 1)
        out["kernel_device_ms"] = traced_device_ms(torch, kernel, 5)
        out["plain_ms"] = time_ms(torch, lambda: spd_solve_reference(a, b), 2, 1)
        out["library_ms"] = time_ms(torch, library, 3, 1)
        bound_ms, out["bound_by"] = spd_bound(WIDE_SPD_B, n)
        out["bound_us"] = bound_ms * 1e3
        held("spd_solve", f"n{n}", out,
             rel < KERNEL_TOL and out["bit_identical"] and plan.path == "wide"
             and bool(torch.isfinite(x_k).all()))
    a, b = spd_systems(256, 200, 400)
    a[128:] = 0.0
    dead = [0, 77, 199]
    a[:64, dead, :] = 0.0
    a[:64, :, dead] = 0.0
    x_k, x_p = spd_solve(a, b), spd_solve_reference(a, b)
    ok = (bool((x_k[128:] == 0).all()) and bool((x_k[:64, dead] == 0).all())
          and bool(torch.isfinite(x_k).all()) and rel_err(x_k[:128], x_p[:128]) < KERNEL_TOL)
    held("spd_solve", "n200_zero_and_singular",
         {"max_abs_err": float((x_k - x_p).abs().max()),
          "max_rel_err": rel_err(x_k[:128], x_p[:128])}, ok)
    a, b = spd_systems(64, 400, 800)  # the packed triangle in device memory
    x_k, x_p = spd_solve(a, b), spd_solve_reference(a, b)
    held("spd_solve", "n400_scratch",
         {"scratch": ck.spd_launch_plan(64, 400, sm).scratch, "max_rel_err": rel_err(x_k, x_p),
          "max_abs_err": float((x_k - x_p).abs().max())},
         rel_err(x_k, x_p) < KERNEL_TOL)
    del a, b, x_k, x_p
    torch.cuda.empty_cache()

    # attention
    import torch.nn.functional as F

    for d in WIDE_HEADS:
        for b, h, lq, lk, causal in WIDE_ATTN_SHAPES:
            q, k, v = (torch.randn((b, h, n_, d), generator=gen, device=dev)
                       for n_ in (lq, lk, lk))
            before = flash_attention_fwd.launches
            o_k = flash_attention_fwd(q, k, v, causal)
            launched = flash_attention_fwd.launches - before
            o_p = flash_attention_fwd_reference(q, k, v, causal)
            ok = bool(torch.isfinite(o_k).all()
                      and torch.allclose(o_k, o_p, rtol=ATTN_RTOL, atol=ATTN_ATOL))
            plan = ck.flash_plan_for(q, k, causal)
            out = {"D": d, "B": b, "H": h, "Lq": lq, "Lk": lk, "causal": causal,
                   "plan": flash_plan_line(plan), "launches": launched,
                   "max_abs_err": float((o_k - o_p).abs().max()),
                   "bit_identical": bool(torch.equal(o_k, flash_attention_fwd(q, k, v, causal)))}
            kernel = lambda: flash_attention_fwd(q, k, v, causal)  # noqa: E731
            library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
            out["kernel_ms"] = time_ms(torch, kernel, 10, 2)
            out["kernel_device_ms"] = traced_device_ms(torch, kernel, 10)
            out["plain_ms"] = time_ms(
                torch, lambda: flash_attention_fwd_reference(q, k, v, causal), 3, 1)
            out["library_ms"] = time_ms(torch, library, 10, 2)
            out["library_device_ms"] = traced_device_ms(torch, library, 10)
            bound_ms, out["bound_by"] = flash_attention_bound(b, h, lq, lk, d, causal)
            out["bound_us"] = bound_ms * 1e3
            held("flash_attention", f"D{d}_{b}x{h}x{lq}_causal_{causal}", out,
                 ok and out["bit_identical"] and launched == 1 and plan.passes > 1)
            del q, k, v, o_k, o_p
    return {"cases": cases, "max_abs_err": worst, "attributes": attrs}


def seq_burst(torch, dev, port: int, seq_model, seq_params, rng, launch_count=None) -> dict:
    """A burst of ``HTTP_QUERIES`` concurrent seqrec queries (by user, and
    an unknown user and unknown items) to the server on ``port``, each
    answer held to the plain attention's forward on the card: the same
    items in the same order, scores within the serving tolerance. The
    attention launches of the burst are counted: this process's count,
    reset just before and read just after, or, for a server in another
    process, the difference of ``launch_count()`` read before and after."""
    from predictionio_tpu_torch.models import sequencerec as seq
    from predictionio_tpu_torch.ops.attention import flash_attention
    from predictionio_tpu_torch.ops.cuda_kernels import flash_attention_fwd

    seq_users = list(seq_model.user_recent)
    bodies = [{"user": str(u), "num": 1 + j % 20} for j, u in enumerate(
        rng.choice(seq_users, size=HTTP_QUERIES - 2, replace=False))]
    bodies += [{"user": "nobody-1", "num": 5},
               {"recent_items": ["ghost-1", "ghost-2"], "num": 5}]
    if launch_count is None:
        flash_attention_fwd.launches = 0
        launch_count = lambda: flash_attention_fwd.launches  # noqa: E731
    before = launch_count()  # main path starts here
    with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
        answers = list(pool.map(lambda b: _post_query(port, b), bodies))
    launches = launch_count() - before  # main path ends here
    algo = seq.SeqRecAlgorithm(seq_params, device=dev)
    module, pad_id = seq_model.device_module(dev), len(seq_model.item_map)
    inv, bad, forwards = seq_model.item_map.inverse, [], 0
    for body, (status, data, _) in zip(bodies, answers):
        tokens = algo._tokens_for(seq_model, seq.Query(**body))
        if status != 200 or (not tokens and data != {"itemScores": []}):
            bad.append((body, status, data))
            continue
        if not tokens:
            continue
        forwards += 1
        row = [pad_id] * (seq_model.seq_len - len(tokens)) + list(tokens)
        scores = _seq_scores(torch, module, torch.tensor([row], device=dev), pad_id,
                             attention_fn=flash_attention)[0]
        want_s, want_i = (x.cpu().numpy() for x in seq.top_k_lower_index_first(
            scores, min(body["num"], pad_id)))
        got = data["itemScores"]
        got_s = np.array([x["score"] for x in got], dtype=np.float32)
        if ([x["item"] for x in got] != [inv[int(i)] for i in want_i]
                or not np.allclose(got_s, want_s, rtol=SEQ_SERVE_RTOL, atol=SEQ_SERVE_ATOL)):
            bad.append((body, got[:3]))
    return {"served": len(bodies), "forwards": forwards, "wrong": len(bad), "bad": bad,
            "launches": launches}


def phase_wide(torch, dev, seed: int, base: str) -> dict:
    """The general-width paths: :func:`wide_kernels`, then over the events
    phase's store ALS at rank 200 trained by ``run_train`` (3 iterations;
    build and solve launches reset just before and read just after) held
    to 3 iterations of the plain build and solve, with its holdout RMSE
    (3 iterations through the kernels on 95 % of the ratings), and seqrec
    at d_model 256 / 1 head (D = 256) trained by ``run_train`` (20 steps)
    and served for a burst held to the plain forward (attention launches
    counted on both)."""
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.models import sequencerec as seq
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops.cuda_kernels import (
        flash_attention_fwd,
        gramian_fused,
        spd_solve,
    )
    from predictionio_tpu_torch.workflow import (
        ServerConfig,
        WorkflowContext,
        create_query_server,
        load_models,
        run_train,
    )

    t0 = time.monotonic()
    kernels = wide_kernels(torch, dev, seed)
    seconds = {"kernels": time.monotonic() - t0}
    launches = {}
    rng = np.random.default_rng(seed + 13)
    source = ("", rec.RecDataSourceParams(app_id=EVENTS_APP, event_names=("rate",)))
    with events_store(base) as registry:
        params = rec.ALSAlgorithmParams(rank=WIDE_ALS_RANK, num_iterations=PARITY_ITERS,
                                        lambda_=LAMBDA, seed=TRAIN_SEED)
        gramian_fused.launches = spd_solve.launches = 0  # main path starts here
        t = time.monotonic()
        instance = run_train(rec.engine_factory(),
                             EngineParams(data_source_params=source,
                                          algorithm_params_list=[("als", params)]),
                             registry, engine_id="wide-als", ctx=WorkflowContext(device=dev))
        seconds["als_run_train"] = time.monotonic() - t
        launches["als_run_train"] = {"gramian_fused": gramian_fused.launches,
                                     "spd_solve": spd_solve.launches}  # main path ends here
        (model,) = load_models(registry, instance)
        td = rec.RecDataSource(source[1]).read_training(None)
        cfg = rec.als_config(params)
        against = als_against_plain(torch, dev, model, td, cfg)
        keep = ~holdout_mask(len(td.users))
        n_u, n_i = len(td.user_map), len(td.item_map)
        split = als.als_train_coo(td.users[keep], td.items[keep], td.ratings[keep],
                                  n_u, n_i, cfg, device=dev)
        holdout = als.rmse(split, td.users[~keep], td.items[~keep], td.ratings[~keep])
        train_rmse = als.rmse(split, td.users[keep], td.items[keep], td.ratings[keep])
        als_out = {"instance": instance, "rank": WIDE_ALS_RANK, "iterations": PARITY_ITERS,
                   "launches": launches["als_run_train"], "holdout_rmse": holdout,
                   "train_rmse": train_rmse, **against}
        emit({"phase": "wide", "stage": "als_rank200", **als_out,
              "seconds": seconds["als_run_train"]})
        ok = (against["first_user_solve"]["beyond_tol"] == 0
              and all(against[s]["finite"] and against[s]["beyond_tol"] == 0
                      for s in ("user", "item"))
              and min(launches["als_run_train"].values()) >= 2 * PARITY_ITERS
              and np.isfinite(holdout))
        if not ok:
            raise AssertionError(f"ALS at rank {WIDE_ALS_RANK}: {als_out}")

        seq_params = seq.SeqRecAlgorithmParams(**dict(SEQ_PARAMS, **WIDE_SEQ,
                                                      steps=EVENTS_SEQ_STEPS))
        seq_ep = EngineParams(
            data_source_params=("", seq.SeqDataSourceParams(app_id=EVENTS_APP,
                                                             event_names=("rate",))),
            preparator_params=("", seq.SeqPreparatorParams(seq_len=SEQ_LEN,
                                                           window_stride=SEQ_STRIDE)),
            algorithm_params_list=[("transformer", seq_params)])
        flash_attention_fwd.launches = 0  # main path starts here
        t = time.monotonic()
        seq_instance = run_train(seq.engine_factory(), seq_ep, registry,
                                 engine_id="wide-seqrec", ctx=WorkflowContext(device=dev))
        seconds["seqrec_run_train"] = time.monotonic() - t
        launches["seqrec_run_train"] = flash_attention_fwd.launches  # main path ends here
        (seq_model,) = load_models(registry, seq_instance)
        server = create_query_server(
            seq.engine_factory(), ServerConfig(ip="127.0.0.1", port=0, device=dev,
                                               engine_instance_id=seq_instance),
            registry=registry, block=False)
        try:
            burst = seq_burst(torch, dev, server.bound_port, seq_model, seq_params, rng)
        finally:
            server.shutdown()
            server.server_close()
    launches["seqrec_serve"] = burst["launches"]
    n_layers = seq_params.n_layers
    seq_out = {"instance": seq_instance, "head_width": WIDE_SEQ["d_model"] // WIDE_SEQ["n_heads"],
               **{k: burst[k] for k in ("served", "forwards", "wrong")},
               "launches": {k: launches[k] for k in ("seqrec_run_train", "seqrec_serve")}}
    emit({"phase": "wide", "stage": "seqrec_d256", **seq_out,
          "seconds": seconds["seqrec_run_train"]})
    if (burst["bad"] or launches["seqrec_run_train"] != n_layers * EVENTS_SEQ_STEPS
            or launches["seqrec_serve"] != n_layers * burst["forwards"]):
        raise AssertionError(f"seqrec at D = 256: {burst['bad'][:3]}, {launches}")
    out = {"phase": "wide", "kernels": kernels, "als": als_out, "seqrec": seq_out,
           "seconds": seconds, "by_kernel": {
               "gramian_fused": launches["als_run_train"]["gramian_fused"],
               "spd_solve": launches["als_run_train"]["spd_solve"],
               "flash_attention": launches["seqrec_run_train"] + launches["seqrec_serve"]}}
    emit({k: v for k, v in out.items() if k != "kernels"})
    return out


#: the console phase: the quickstart's lifecycle through ``python -m
#: predictionio_tpu_torch.tools.console`` over the quickstart's generated
#: events (rank 50, 10 iterations), and beside it the sequence template
#: at its defaults over the events phase's app; the seconds a spawned server may
#: take to answer, and the seconds the port may take to come free
CONSOLE_RANK, CONSOLE_ITERS, CONSOLE_UP_S, CONSOLE_DOWN_S = 50, 10, 120, 30
QUICKSTART_EVENTS = "examples/movielens_quickstart/gen_events.py"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pio(env: dict, *args: str, timeout: float = 600) -> dict:
    """``python -m predictionio_tpu_torch.tools.console args`` as a user
    runs it, in ``env``; its JSON output, or a failure with its output."""
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.console", *args],
        env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"pio {' '.join(args)}: exit {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout)


def console_deploy(env: dict, engine_dir: str) -> tuple:
    """``pio deploy --spawn`` on a free port, waited for until its
    ``/status.json`` answers; returns (port, the deploy's output)."""
    port = _free_port()
    spawned = pio(env, "deploy", "--engine-dir", engine_dir, "--ip", "127.0.0.1",
                  "--port", str(port), "--spawn")
    deadline = time.monotonic() + CONSOLE_UP_S
    while True:
        try:
            _get_json(port, "/status.json")
            return port, spawned
        except OSError:
            if time.monotonic() > deadline:
                with open(spawned["log"]) as fh:
                    raise AssertionError(f"the spawned server did not answer: {fh.read()[-3000:]}")
            time.sleep(0.5)


def console_undeploy(env: dict, port: int) -> float:
    """``pio undeploy``; then the seconds until a server could bind the
    port again (as ``HTTPServer`` binds, with ``SO_REUSEADDR``)."""
    import socket

    pio(env, "undeploy", "--ip", "127.0.0.1", "--port", str(port))
    t = time.monotonic()
    while True:
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("127.0.0.1", port))
                return time.monotonic() - t
            except OSError:
                if time.monotonic() - t > CONSOLE_DOWN_S:
                    raise AssertionError(f"port {port} still taken after undeploy")
                time.sleep(0.2)


def _console_steps(env: dict, seconds: dict):
    """``pio`` in ``env``, each command's seconds kept under its name."""
    def step(name, *args):
        t = time.monotonic()
        out = pio(env, *args)
        seconds[name] = time.monotonic() - t
        return out
    return step


def console_recommendation(torch, dev, rng, base: str, env: dict) -> dict:
    """The quickstart's lifecycle: ``app new``, ``import`` of the
    quickstart's generated events, ``template get recommendation``,
    ``build``, ``train`` (rank 50, 10 iterations; the build and solve
    launches are the process's own), ``deploy --spawn``, a burst of
    queries whose ids equal ``torch.topk`` over the stored factors (ties
    allowed; the top-k launches read off the server's ``/status.json``
    before and after the burst, whose ``topkPath`` names the kernel),
    ``undeploy`` (the port then free)."""
    import os

    from predictionio_tpu_torch.storage import StorageRegistry
    from predictionio_tpu_torch.workflow import load_models

    here = os.path.dirname(os.path.abspath(__file__))
    seconds = {}
    step = _console_steps(env, seconds)
    app = step("app_new", "app", "new", "quickstart")
    events = os.path.join(base, "quickstart_events.jsonl")
    with open(events, "w") as fh:
        subprocess.run([sys.executable, os.path.join(here, QUICKSTART_EVENTS)],
                       stdout=fh, check=True, timeout=120)
    imported = step("import", "import", "--appid", str(app["id"]), "--input", events)
    engine_dir = os.path.join(base, "quickstart_engine")
    step("template_get", "template", "get", "recommendation", engine_dir)
    variant_path = os.path.join(engine_dir, "engine.json")
    with open(variant_path) as fh:
        variant = json.load(fh)
    variant["datasource"]["params"]["app_id"] = app["id"]
    variant["algorithms"][0]["params"].update(rank=CONSOLE_RANK,
                                              num_iterations=CONSOLE_ITERS)
    with open(variant_path, "w") as fh:
        json.dump(variant, fh)
    step("build", "build", "--engine-dir", engine_dir)
    trained = step("train", "train", "--engine-dir", engine_dir)
    train_launches = trained["kernelLaunches"]  # the process's own: its run
    if min(train_launches[k] for k in ("gramian_fused", "spd_solve")) < 2 * CONSOLE_ITERS:
        raise AssertionError(f"console train: {train_launches}")
    (model,) = load_models(StorageRegistry({"PIO_FS_BASEDIR": env["PIO_FS_BASEDIR"]}),
                           trained["engineInstanceId"])
    t = time.monotonic()
    port, _ = console_deploy(env, engine_dir)
    seconds["deploy"] = time.monotonic() - t
    try:
        users = [str(u) for u in rng.choice(list(model.user_map.to_dict()),
                                            size=HTTP_QUERIES, replace=False)]
        bodies = [{"user": u, "num": 1 + j % 20} for j, u in enumerate(users)]
        before = _get_json(port, "/status.json")["kernelLaunches"]["topk_streaming"]
        t = time.monotonic()  # main path starts here
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            answers = list(pool.map(lambda b: _post_query(port, b), bodies))
        seconds["burst"] = time.monotonic() - t
        status = _get_json(port, "/status.json")  # main path ends here
        serve_launches = status["kernelLaunches"]["topk_streaming"] - before
    finally:
        seconds["undeploy_port_free"] = console_undeploy(env, port)
    uf = torch.from_numpy(model.user_factors).to(dev)
    itf = torch.from_numpy(model.item_factors).to(dev)
    rows = torch.tensor([model.user_map[u] for u in users], device=dev)
    want_s, want_i = (x.cpu().numpy() for x in torch.topk(uf[rows] @ itf.T, 20, dim=1))
    inv, wrong, off = model.item_map.inverse, 0, 0
    for j, (body, (code, data, _)) in enumerate(zip(bodies, answers)):
        got = data.get("itemScores", []) if code == 200 else []
        k = body["num"]
        if len(got) != k:
            wrong += k
            continue
        got_s = np.array([x["score"] for x in got], dtype=np.float32)
        close = np.isclose(got_s, want_s[j][:k], rtol=RTOL, atol=ATOL)
        same = np.array([x["item"] == inv[int(i)] for x, i in zip(got, want_i[j][:k])])
        wrong += int((~(same | close)).sum())
        off += int((~close).sum())
    paths = set(status["topkPath"].values()) if isinstance(status.get("topkPath"), dict) \
        else {status.get("topkPath")}
    out = {"app": app["id"], "events": imported["events"],
           "instance": trained["engineInstanceId"], "queries": len(bodies),
           "wrong_ids_outside_ties": wrong, "scores_off": off,
           "topk_path": sorted(map(str, paths)),
           "launches": {"train": train_launches, "serve": serve_launches},
           "seconds": seconds}
    if wrong or off or serve_launches < 1 or paths != {"streaming"}:
        raise AssertionError(f"console recommendation: {out}")
    return out


def console_sequencerec(torch, dev, rng, base: str, env: dict) -> dict:
    """The sequence template's lifecycle at its defaults over the events
    phase's app: ``template get sequencerec``, ``build``, ``train`` (the
    attention launches are the process's own), ``deploy --spawn``, a burst
    held to the plain forward (launches read off ``/status.json``),
    ``undeploy``."""
    import os

    from predictionio_tpu_torch.models import sequencerec as seq
    from predictionio_tpu_torch.storage import StorageRegistry
    from predictionio_tpu_torch.workflow import load_models

    env = dict(env, PIO_STORAGE_SOURCES_EVENTLOG_TYPE="native",
               PIO_STORAGE_SOURCES_EVENTLOG_PATH=f"{base}/event_log",
               PIO_STORAGE_SOURCES_LOCAL_TYPE="sqlite",
               PIO_STORAGE_SOURCES_LOCAL_PATH=f"{base}/events_phase",
               PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE="EVENTLOG",
               PIO_STORAGE_REPOSITORIES_METADATA_SOURCE="LOCAL",
               PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE="LOCAL")
    seconds = {}
    step = _console_steps(env, seconds)
    seq_dir = os.path.join(base, "sequencerec_engine")
    step("template_get", "template", "get", "sequencerec", seq_dir)
    variant_path = os.path.join(seq_dir, "engine.json")
    with open(variant_path) as fh:
        variant = json.load(fh)
    variant["datasource"]["params"].update(app_id=EVENTS_APP, event_names=["rate"])
    with open(variant_path, "w") as fh:
        json.dump(variant, fh)
    step("build", "build", "--engine-dir", seq_dir)
    trained = step("train", "train", "--engine-dir", seq_dir)
    train_launches = trained["kernelLaunches"]["flash_attention"]
    params = seq.SeqRecAlgorithmParams(**variant["algorithms"][0]["params"])
    if train_launches != params.n_layers * params.steps:
        raise AssertionError(f"console seqrec train: {trained}")
    registry = StorageRegistry({k: v for k, v in env.items() if k.startswith("PIO_")})
    (model,) = load_models(registry, trained["engineInstanceId"])
    t = time.monotonic()
    port, _ = console_deploy(env, seq_dir)
    seconds["deploy"] = time.monotonic() - t
    try:
        t = time.monotonic()
        burst = seq_burst(torch, dev, port, model, params, rng,
                          launch_count=lambda: _get_json(port, "/status.json")[
                              "kernelLaunches"]["flash_attention"])
        seconds["burst_and_check"] = time.monotonic() - t
    finally:
        seconds["undeploy_port_free"] = console_undeploy(env, port)
    out = {"instance": trained["engineInstanceId"],
           **{k: burst[k] for k in ("served", "forwards", "wrong")},
           "launches": {"train": train_launches, "serve": burst["launches"]},
           "seconds": seconds}
    if burst["bad"] or burst["launches"] != params.n_layers * burst["forwards"]:
        raise AssertionError(f"console seqrec: {burst['bad'][:3]}, {out}")
    return out


def phase_console(torch, dev, seed: int, base: str) -> dict:
    """Both bundled templates' lifecycles through the port's console, each
    command a ``python -m predictionio_tpu_torch.tools.console`` process
    on the card: :func:`console_recommendation` and
    :func:`console_sequencerec`, run side by side as two operators would
    (each in its own processes, storage and server), so the phase takes
    the longer lifecycle's time."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    clean = {k: v for k, v in os.environ.items() if not k.startswith("PIO_")}

    def env(name):
        return dict(clean, PIO_FS_BASEDIR=os.path.join(base, name),
                    PYTHONPATH=os.pathsep.join([here, os.environ.get("PYTHONPATH", "")]))

    t = time.monotonic()
    with ThreadPoolExecutor(max_workers=2) as pool:
        rec_job = pool.submit(console_recommendation, torch, dev,
                              np.random.default_rng(seed + 17), base, env("console"))
        seq_job = pool.submit(console_sequencerec, torch, dev,
                              np.random.default_rng(seed + 19), base, env("console_seq"))
        rec_out, seq_out = rec_job.result(), seq_job.result()
    wall = time.monotonic() - t
    emit({"phase": "console", "stage": "recommendation", **rec_out})
    emit({"phase": "console", "stage": "sequencerec", **seq_out})
    out = {"phase": "console", "recommendation": rec_out, "sequencerec": seq_out,
           "seconds": wall, "by_kernel": {
               "topk_streaming": rec_out["launches"]["serve"],
               "gramian_fused": rec_out["launches"]["train"]["gramian_fused"],
               "spd_solve": rec_out["launches"]["train"]["spd_solve"],
               "flash_attention": seq_out["launches"]["train"] + seq_out["launches"]["serve"]}}
    emit({k: v for k, v in out.items() if k not in ("recommendation", "sequencerec")})
    return out


def wide_lines(wide: dict, name: str) -> dict:
    """The general-width path's timed cases of one kernel, for the
    ``kernels`` line: each case's measured times, bound and launches."""
    keys = ("kernel_ms", "kernel_device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_us", "bound_by", "launches", "slices", "rows_kernel_ms", "rows_plain_ms",
            "rows_library_ms", "rows_bound_us", "max_abs_err", "max_rel_err")
    return {case.split(":", 1)[1]: {k: out[k] for k in keys if k in out}
            for case, out in wide["kernels"]["cases"].items()
            if case.startswith(name + ":") and "kernel_ms" in out}


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
    from predictionio_tpu_torch.storage import StorageRegistry

    seconds = {}

    def timed(name, fn, *a):
        t0 = time.monotonic()
        out = fn(*a)
        seconds[name] = time.monotonic() - t0
        return out

    smi = timed("device", phase_device, torch)
    timed("build", phase_build)
    main_shapes = timed("kernel", phase_kernel, torch, dev,
                        np.random.default_rng(args.seed))
    data = timed("data", phase_data, torch, dev, args.seed)
    kernels = timed("train_kernels", phase_train_kernels, torch, dev, data, args.seed)
    with tempfile.TemporaryDirectory(prefix="pio_chip_smoke_") as base:
        registry = StorageRegistry({"PIO_FS_BASEDIR": base})
        trained = timed("train", phase_train, torch, dev, data, registry)
        sliced = timed("slice", phase_slice, torch, dev, args.seed, registry,
                       trained["instance"])
        attn = timed("attention_kernel", phase_attention_kernel, torch, dev, args.seed)
        seq_trained = timed("seqrec_train", phase_seqrec_train, torch, dev, args.seed,
                            registry)
        seq_sliced = timed("seqrec_slice", phase_seqrec_slice, torch, dev, args.seed,
                           registry, seq_trained["out"]["instance"], seq_trained["seqs"])
        events = timed("events", phase_events, torch, dev, args.seed, base)
        wide = timed("wide", phase_wide, torch, dev, args.seed, base)
        evaluated = timed("eval", phase_eval, torch, dev, args.seed, base)
        persisted = timed("persist", phase_persist, torch, dev, args.seed, base, registry,
                          trained["instance"])
        consoled = timed("console", phase_console, torch, dev, args.seed, base)
    large = timed("kernel_large", topk_large_batches, torch, dev,
                  np.random.default_rng(args.seed + 7))
    emit({"phase_seconds": seconds})

    ref = main_shapes[1024]
    bound_ms, bound_by = topk_bound(ref["B"], ref["N"], ref["R"], ref["k"])
    lines = [{
        "name": "topk_streaming",
        "route": "cuda",
        "source": TOPK_SOURCE,
        "replaces": TOPK_REPLACES,
        "launches": (sliced["launches"] + events["serve"]["launches"]
                     + evaluated["launches"]["topk_streaming"]
                     + persisted["by_kernel"]["topk_streaming"]
                     + consoled["by_kernel"]["topk_streaming"]),
        "launches_by_path": {"slice": sliced["launches"],
                             "events_serve": events["serve"]["launches"],
                             "eval": evaluated["launches"]["topk_streaming"],
                             "persist": persisted["by_kernel"]["topk_streaming"],
                             "console": consoled["by_kernel"]["topk_streaming"]},
        "max_abs_err": max(m["max_abs_err"] for m in [*main_shapes.values(),
                                                      *large.values()]),
        "ms": ref["kernel_ms"],
        "plain_ms": ref["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": ref["library_ms"],
        "device_ms": ref["kernel_device_ms"],
        "library_device_ms": ref["library_device_ms"],
        "shape": {k: ref[k] for k in ("B", "N", "R", "k", "T", "n_runs")},
        "large_batches": {b: {k: v[k] for k in (
            "slices", "launches", "kernel_ms", "kernel_device_ms", "plain_chunked_ms",
            "library_ms", "library_device_ms", "bound_us", "bound_by",
            "wrong_ids_outside_ties")} for b, v in large.items()},
        "eval_shape": evaluated["topk_at_eval_shape"],
        "k_above_2048": {name: {k: main_shapes[name][k] for k in (
            "B", "N", "k", "E", "T", "n_runs", "merge_in", "kernel_ms", "kernel_device_ms",
            "plain_ms", "library_ms", "library_device_ms", "bound_us", "bound_by",
            "max_abs_err")} for name in ("k4096_N5000", "k_eq_N27000_E64")},
    }]
    for name, source, replaces in (
        ("gramian_fused", GRAMIAN_SOURCE, GRAMIAN_REPLACES),
        ("spd_solve", SPD_SOURCE, SPD_REPLACES),
    ):
        it = kernels["per_iteration"][name]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": (trained["launches"][name] + events["als"]["launches"][name]
                         + evaluated["launches"][name] + persisted["by_kernel"][name]
                         + wide["by_kernel"][name] + consoled["by_kernel"][name]),
            "launches_by_path": {"train": trained["launches"][name],
                                 "events_als": events["als"]["launches"][name],
                                 "eval": evaluated["launches"][name],
                                 "persist": persisted["by_kernel"][name],
                                 "wide": wide["by_kernel"][name],
                                 "console": consoled["by_kernel"][name]},
            "max_abs_err": kernels["max_abs_err"][name],
            "ms": it["kernel_ms"],
            "plain_ms": it["plain_ms"],
            "bound_ms": it["bound_ms"],
            "bound_by": it["by"],
            "library_ms": it["library_ms"],
            "shape": {"per": "iteration", "launches": it["launches"],
                      "R": RANK, "users": data["n_users"], "items": data["n_items"]},
        })
        lines[-1].update(device_ms=it["kernel_device_ms"],
                         library_device_ms=it["library_device_ms"],
                         wide_path=wide_lines(wide, name))
        if name == "gramian_fused":
            lines[-1].update(widest_bucket=kernels["widest"],
                             attributes=kernels["attributes"])
        else:
            lines[-1].update(bound_whole_a_ms=it["bound_whole_a_ms"],
                             plan_n50=spd_plan(torch, dev, data["n_users"], RANK),
                             attributes=kernels["spd_attributes"])
    ref = attn["shapes"]["train"]
    lines.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": (seq_trained["out"]["launches"] + seq_sliced["launches"]
                     + events["seqrec"]["launches"] + evaluated["seqrec"]["launches"]
                     + persisted["by_kernel"]["flash_attention"]
                     + wide["by_kernel"]["flash_attention"]
                     + consoled["by_kernel"]["flash_attention"]),
        "launches_by_path": {"seqrec_train": seq_trained["out"]["launches"],
                             "seqrec_slice": seq_sliced["launches"],
                             "events_seqrec": events["seqrec"]["launches"],
                             "eval": evaluated["seqrec"]["launches"],
                             "persist": persisted["by_kernel"]["flash_attention"],
                             "wide": wide["by_kernel"]["flash_attention"],
                             "console": consoled["by_kernel"]["flash_attention"]},
        "max_abs_err": attn["max_abs_err"],
        "ms": ref["kernel_ms"],
        "plain_ms": ref["plain_ms"],
        "bound_ms": ref["bound_us"] / 1e3,
        "bound_by": ref["bound_by"],
        "library_ms": ref["library_ms"],
        "device_ms": ref["kernel_device_ms"],
        "library_device_ms": ref["library_device_ms"],
        "bound_us": ref["bound_us"],
        "shape": {k: ref[k] for k in ("B", "H", "Lq", "Lk", "D", "causal")},
        "plan": ref["plan"],
        "long_causal": {k: attn["shapes"]["long_causal_True"][k] for k in (
            "kernel_device_ms", "library_device_ms", "bound_us", "plan")},
        "long_not_causal": {k: attn["shapes"]["long_causal_False"][k] for k in (
            "kernel_device_ms", "library_device_ms", "bound_us", "plan")},
        "attributes": attn["attributes"],
        "odd_widths": {name: {k: attn["shapes"][name][k] for k in (
            "D", "D_kernel", "kernel_ms", "kernel_device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_us", "bound_by", "max_abs_err")}
            for name in ("train_D6", "train_D15")},
        "wide_path": wide_lines(wide, "flash_attention"),
    })
    emit({"kernels": lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
