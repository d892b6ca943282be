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
3. ``kernel``  — the top-k kernels' registers and local bytes
   (``cudaFuncGetAttributes``: no local memory), then the streaming top-k
   against its plain PyTorch version on the card at the serving slice's
   shapes (B in {1, 64, 1024}, N = 27,000, R = 50, k = 16) and at the edge
   cases (64 exclusions, k > N, rows with every item excluded, duplicated
   item rows, a catalog whose scores rise with the index, a served batch
   of 512 at k = 128; 128 < k <= 256 on the tiled running list: B = 64
   and 1,024 at k = 256, k = 129, k = 200 with exclusions, ties, rising
   scores, excluded rows, ranks 33 and 8; k = 1024, k = 2048; k = 4096 on
   5,000 items, its lists merged in shared memory, and k = N = 27,000 with
   64 exclusions a query, merged in device memory); scores agree to rtol
   1e-5 / atol 1e-5 and ids are equal or tied, and every case equals bit
   for bit the same call with stage 1 forced to sort every tile. Each
   case prints its launch plan (stage-1 kernel, tiles per stage-1 block,
   lists per query); each timed shape prints the kernel's, the plain
   version's and ``torch.topk(q @ items.T)``'s times per call (CUDA
   events) and, for the kernel, the per-tile sort and the library call,
   on the device alone (``torch.profiler``), beside the bound.
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
6b. ``resume`` — ``run_train``'s tail and checkpoint resume, on the train
   phase's engine and params with a store of its own: run A asks for 6
   iterations with a checkpoint every 3 under a pinned ``PIO_CKPT_DIR``,
   ``PIO_PROFILE_DIR`` and ``PIO_PERF_LEDGER`` (steps 3 and 6 committed, a
   trace that parses and holds CUDA kernel events, its build and solve
   kernel events counted, one ledger record on ``cuda:`` with ``read``,
   ``prepare`` and ``train[0]``); run B asks for 10 and resumes from step
   6: 4 iterations, exactly 4 × run A's build and solve launches an
   iteration (counts reset just before each ``run_train`` and read just
   after), steps 9 and 10 committed, its stored factors equal bit for bit
   to the train phase's. Then the train phase's own ``run_train`` split
   from its instance's ``PIO_TRAIN_PHASES``: read, prepare, ``train[0]``
   (bucketize, sort, stage, the iterations, the rest), the rest of
   ``engine.train`` and the time outside it, and beside it the pickle of
   that run's model and its insert into a model store, timed again.
7. ``slice``   — serving: the instance ``run_train`` wrote, deployed by
   ``create_query_server`` on the card with the default
   ``streaming_top_k`` ("auto"); bursts of 64 concurrent
   ``POST /queries.json`` (two unknown users), every answer checked
   against the plain version — the last burst's requests (and nothing
   else) under ``torch.profiler``, to show how busy the device was — then
   ``/status.json`` ``topkPath`` is streaming and the HTTP bursts launched
   the kernel; one more burst whose ``num`` is drawn from 129–256 (k pads
   to 256: the tiled running list) is held to the plain top-k with its
   launches counted; a direct 1,024-user ``batch_predict`` streams too. The
   top-k kernel's launch count is reset just before the first burst and
   read after the last batch.

7b. ``plane`` — the query server's request plane on the slice phase's
   instance: one server with feedback to the port's own Event Server
   (over a store of its own), the health plane and the flight recorder
   armed in ``PIO_FLIGHT_DIR`` (``flight_dumps/plane``). A burst of 64
   concurrent queries, each with ``X-PIO-Trace`` and a 60 s
   ``X-PIO-Deadline-Ms``: every answer held to the plain version, kernel
   1's launches (reset just before the burst, read just after) equal to
   the batches, each answer's ``predict`` event (its 64-character prId)
   read back exactly once, one query's trace holding the admission
   (``POST /queries.json``), batch (``batch.queue-wait``), predict
   (``batch.device``) and feedback spans with the Event Server's span
   under the same id, ``/health.json`` firing nothing. A 1 ms deadline
   sent while a burst holds the batcher: 504 with its stage, counted.
   Feedback to a closed port (``PIO_BREAKER_FAILURES`` 3): every query
   answered, the ``event-server`` breaker open, ``pio_breaker_state`` 2,
   the open on ``/blackbox.json``. Four shard servers (``shard_count`` 4)
   in this process on the card, each burst with its launches counted,
   each shard's kernel held to its plain version and timed on the device
   beside the unsharded table; the merged answers equal the unsharded
   server's (``merged_matches_reference``, or the plain version's but for
   a tie at the k-th place). The same burst with the planes on and off,
   A B B A (wall, p50, p99). Then a spawned ``run_server`` with
   ``PIO_FLIGHT_DIR``, one query and a ``/reload``, SIGTERM: its
   ``flight-<pid>.jsonl`` (reason ``signal-15``) and
   ``faulthandler-<pid>.txt`` must be there.
7c. ``rollout`` — staged deploys between two ALS models resident on the
   card behind one ``create_query_server``, in a store of its own: the
   baseline is the train phase's instance, the candidate a second
   ``run_train`` of the same data with seed 1 (its build and solve
   launches counted). Feedback goes to the port's Event Server and
   ``PIO_QUALITY_SNAPSHOTS`` is set; gate holds are 10 s, 32 samples.
   SHADOW: two bursts of 32 (the shadow pool's pending cap: nothing
   dropped), every answer ``X-PIO-Variant: baseline`` and equal to
   ``top_k_streaming_reference`` on the baseline's tables (rtol/atol
   1e-5, ids equal or tied), every duplicate run on the candidate through
   kernel 1, one ``pio_rollout_divergence`` sample each, their mean equal
   to ``prediction_divergence`` of the two plain answers on the host
   (atol 1e-4); the shadow's cost: bursts of 64 on this server and on a
   plain one with no rollout, A B B A. CANARY at 10 %: after the hold the
   next query promotes; four bursts of 64, each query's variant equal to
   ``variant_for_key(salt, key, 10)`` and its answer to the plain answer
   of the model that served it, the candidate's share inside a binomial
   4σ band; ``pio_quality_score_psi{variant}`` exported for both variants
   and read by ``pio quality --node``. LIVE: after the hold the next query
   promotes; the deployment is the candidate, the stored history SHADOW,
   CANARY, LIVE, a burst of 64 equal to the candidate's plain answers, and
   a fresh server on the store serves the candidate with no rollout
   active. A sick candidate: a new rollout of the first baseline, promoted
   to CANARY at 50 %, ``testing/faults.py`` refusing its every predict:
   ROLLED_BACK with every answer 200. Every ``predict`` event is read back
   tagged with the variant (and instance) that answered; a skewed batch of
   ingest events raises ``pio_quality_event_mix_psi``. Kernel 1's count is
   reset before each stage and must equal the baseline's batches plus the
   candidate's after it, read from both batchers. Each stage prints its
   wall, p50 and p99 and its launches, beside the card.

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
   D = 136 on the resident wide-head path.
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
13b. ``templates`` — the similar-product and e-commerce templates over
   ML-1M's users and items with 18 categories (ML-1M's genre count, 1-3
   an item), made from ``--seed``: about 250,000 ``view`` and 50,000
   ``like``/``dislike`` events, and about 250,000 ``rate`` and 50,000
   ``view``/``buy`` events (200 visitors never ``$set`` who only view),
   bulk-written into two apps of the events phase's native log. Each
   template is trained by ``run_train`` through its DataSource (``als``
   and ``likealgo``, then explicit ALS; rank 10, 10 iterations; build and
   solve launches counted; ``run_train`` split into read, prepare,
   ``train[i]`` and the model-store insert), deployed by
   ``create_query_server`` and queried over HTTP in blocks: single
   queries (1-5 items, a black list), queries on the category nearest 10 %
   of the catalog (about 3,300 excluded ids), white-list queries and a
   concurrent burst of 64; then known users (``unseen_only``), new users
   answered from their recent views, category and white-list queries and a
   burst; then a live ``buy`` and an ``unavailableItems`` ``$set``, after
   which the next answers drop those items with no retrain. The top-k
   launches are reset before each block and read after it (none may be
   0). Every answer is held to the port's plain path on CPU copies of the
   same tables (ids outside ties; scores to 1e-5, carried through the
   similar-product z-score sum), and each similar-product algorithm alone
   at 1e-5. Then one constrained batch (B = 64, the category's exclusion
   lists) timed per call and on the device beside the same batch without
   the filter and ``torch.topk`` of the masked product.
14. ``kernel_large`` — the top-k at B = 262,144 and at B = 600,000 (above
   one launch's 524,280 queries: two launches into one output), N =
   3,706, R = 16, k = 16, and at B = 32,768, k = 256 over 27,000 items
   (one launch of the tiled running list, bit for bit the per-tile path's
   answer, which is cut into launches whose scratch stays within the
   wrapper's 2 GiB budget and timed beside it), held against the plain
   version in chunks (0 wrong ids outside ties) and timed beside the
   plain version (in those chunks), ``torch.topk(q @ items.T)`` and the
   bound.

15. ``wide`` — the general-width paths, over the events phase's store:
   the build at R = 129, 200, 256 at ML-20M's bucket shapes (the users'
   K = 128 bucket of 97,972 rows in the slices the systems budget cuts it
   into, the items' K = 32,768 bucket of 216 rows), each timed whole and
   held to the plain version on its first 4,096 rows (rtol/atol 1e-4, A
   exactly symmetric, two calls bit-identical) and beside the einsum build
   over the whole bucket in 4,096-row slices, a split bucket; the solve
   at n = 129, 200, 256 (B = 4,096, relative error 1e-4, bit-identical),
   the cluster path at n = 305, 384, 512 and its ceiling 768 (B = 1,024;
   bit for bit the wide kernel on the same tensors, timed A B B A against
   ``cholesky_solve``, each plan beside ``cudaOccupancyMaxActiveClusters``,
   a doctored plan refused with an error), the wide kernel at 769 beside
   its bound, zero and singular systems on the blocked and cluster paths,
   n = 400 through the wide kernel's device-memory scratch;
   attention at D = 136, 192, 256 (the resident path), D = 320 (the
   streamed path), D = 384, 512 (the wide streamed path) and D = 576,
   768, 1,024 (the cluster path, each plan's clusters at once beside
   ``cudaOccupancyMaxActiveClusters``) at the training shape and at L =
   2,048 causal and not, and at D = 1,040 (the passes path) at the
   training shape (rtol 2e-4 / atol 2e-5, bit-identical, one launch),
   each timed beside the plain version, the library call and the bound,
   and beside the passes kernel on the same tensors (the wide streamed and
   cluster paths' A B B A); D = 280 and 302 on the streamed path, D = 330
   and 502 on the wide streamed path and D = 650 and 900 on the cluster
   path at two ragged cross shapes; plans forcing the streamed path at D
   = 256 and the wide streamed path at D = 320, ``torch.equal`` to the
   kernel each width's own plan takes, plans forcing the cluster path at
   D = 384 and 512 (held to the plain version, timed beside the wide
   streamed kernel and SDPA on the same tensors), and doctored wide
   streamed and cluster plans (shared memory, slices), refused with an
   error; every general-width kernel's
   registers and local bytes (no local memory; each attention kernel's
   registers equal to its plan constant).
   Then ALS at rank 200 (the build's rows path, the blocked solve) and at
   rank 384 (the build's tile path, the cluster solve) by ``run_train``
   from the store (3 iterations, build and solve launches counted in all
   and by path) held to 3 plain iterations (rtol 2e-3 / atol 2e-4), each
   with the holdout RMSE of 3 iterations on 95 % of the ratings; seqrec
   at d_model 256 / 1 head (D = 256, 20 steps, 64 queries), at d_model
   320 / 1 head (D = 320, 10 steps, 16 queries), at d_model 384 / 1 head
   (D = 384, 10 steps, 16 queries) and at d_model 768 / 1 head (D = 768,
   the cluster path, 10 steps, 16 queries) by ``run_train`` and served for
   a burst held to the plain forward, attention launches counted in all
   and on the head's path; and at D = 768 3 training steps through the
   kernel held to 3 through the plain attention from one seeded init
   (``embed``, ``pos`` and a fixed batch's logits at rtol 1e-3 / atol
   1e-4, the margin printed).
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
import io
import json
import os
import pickle
import re
import shutil
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


# traces taken of one call before its device time is given up on
PROFILE_ATTEMPTS = 3


def device_time(torch, fn, iters: int = 30, ops_per_call: int = 0) -> dict:
    """Device time of one ``fn`` call (``ms``): the time the card was busy
    (:func:`device_profile`) over ``iters`` calls, divided by ``iters``,
    with the device ops it ran per call. Unlike :func:`time_ms` it leaves
    out the host's time to launch the work, which sets the pace of a call
    whose kernels take a few microseconds. The profiler has returned an
    empty device trace for calls that ran kernels (``cholesky_solve``), and
    traces missing some of a call's launches (:func:`traced_device_ms`), so
    a trace with no device op, or with fewer than ``ops_per_call`` a call,
    is taken again, up to ``PROFILE_ATTEMPTS`` times, before it fails."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        prof = device_profile(torch, lambda: [fn() for _ in range(iters)], top=3)
        if prof["device_busy_ms"] is not None and prof["device_ops"] >= ops_per_call * iters:
            return {"ms": prof["device_busy_ms"] / iters,
                    "ops_per_call": prof["device_ops"] / iters,
                    "top_device_ops": prof["top_device_ops"]}
    raise AssertionError("the profiler saw fewer device ops than the call launches")


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


def check_topk_attributes(torch, dev) -> dict:
    """Registers and local bytes of every top-k kernel
    (``cudaFuncGetAttributes``), and the blocks an SM holds of each
    running-list kernel at k = 256, R = 50 against the launch plan's count.
    Fails if the tiled kernel or either kernel of the select path has
    local memory (``topk_run_kernel``'s 16 bytes of stack are its
    parent's, unchanged), or the card holds another number of blocks than
    the plan assumes."""
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    attrs = ck.topk_kernel_attributes(dev)
    resident = {}
    for stage1, per_sm in (("running_list", ck.TOPK_BLOCKS_PER_SM),
                           ("running_list_tiled", ck.TOPK_TILED_BLOCKS_PER_SM)):
        smem = ck.topk_launch_plan(64, N_ITEMS, 256, 132, RANK, stage1).stage1_smem
        planned = min(per_sm, ck.TOPK_SM_SMEM // (smem + ck.TOPK_BLOCK_SMEM_RESERVE))
        resident[stage1] = {"card": ck.topk_blocks_per_sm(stage1, smem, dev),
                            "plan": planned}
    emit({"phase": "kernel", "attributes": attrs, "blocks_per_sm_k256_R50": resident})
    if any(attrs[name]["local_bytes"] for name in (
            "running_list_tiled", "select_score", "select")) or any(
            v["card"] != v["plan"] for v in resident.values()):
        raise AssertionError(f"top-k kernel attributes: {attrs}, {resident}")
    return attrs


def phase_kernel(torch, dev, rng) -> dict:
    from predictionio_tpu_torch.ops.cuda_kernels import (
        top_k_streaming,
        top_k_streaming_reference,
        topk_launch_plan,
    )

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    check_topk_attributes(torch, dev)

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
        # the same call with stage 1 forced to sort every tile: one order
        # of keys, one FMA chain a score, so the same bits
        per_tile = top_k_streaming(q, items, k, excl, stage1="tile_sort")
        equal = bool(torch.equal(got[0], per_tile[0]) and torch.equal(got[1], per_tile[1]))
        again = top_k_streaming(q, items, k, excl)
        same = bool(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
        out = {"case": name, "B": b, "N": n, "R": r, "k": k, "E": e,
               "T": plan.tiles_per_block, "n_runs": plan.n_runs, "stage1": plan.stage1,
               "merge_in": ("select" if plan.stage1 == "select"
                            else "shared" if plan.merge_smem else "global"),
               "max_abs_err": err, "agree": ok, "equal_to_tile_sort": equal,
               "bit_identical": same}
        ok = ok and equal and same
        if timed:
            calls = {
                "kernel": lambda: top_k_streaming(q, items, k, excl),
                "plain": lambda: top_k_streaming_reference(q, items, k, excl),
                "library": lambda: torch.topk(q @ items.T, k, dim=1),
            }
            if plan.stage1 != "tile_sort":
                calls["tile_sort"] = lambda: top_k_streaming(q, items, k, excl,
                                                             stage1="tile_sort")
            # per call (CUDA events: below about 25 us this is the host's
            # launch time), then the card's busy time alone
            for fn_name, fn in calls.items():
                out[f"{fn_name}_ms"] = time_ms(torch, fn)
            for fn_name in [c for c in calls if c != "plain"]:
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
    # widest k of the one-item-a-thread running list
    check("B512_k128", q_all[:512].contiguous(), items, 128)
    # 128 < k <= 256: the tiled running list (a served num of 129-256 pads
    # to 256), each case also bit for bit the per-tile sort's answer
    for b in (64, 1024):
        main[f"k256_B{b}"] = check(f"k256_B{b}", q_all[:b].contiguous(), items, 256,
                                   timed=True)
    check("k129_B1024", q_all, items, 129)
    check("k200_E64", q_all[:64].contiguous(), items, 200, torch.from_numpy(excl).to(dev))
    check("k256_duplicated_rows_ties", dq, ditems, 256)
    check("k256_rising_scores", q_all[:64].abs().contiguous() + 0.5, rising, 256)
    check("k256_all_excluded_rows", eq, eitems, 256, torch.from_numpy(all_excl).to(dev))
    for other_r in (33, 8):
        check(f"k256_rank_{other_r}", *tensors(16, 3000, other_r), 256)
    # 256 < k <= 16,384: the threshold select (every score stored and
    # counted, the keys from the k-th key's bin up sorted), each case also
    # bit for bit the per-tile sort's answer and a second call's
    main["k1024"] = check("k1024", q_all[:4].contiguous(), items, 1024, timed=True)
    check("k2048", q_all[:2].contiguous(), items, 2048)
    main["k1024_B1024"] = check("k1024_B1024", q_all, items, 1024, timed=True)
    check("k1024_E64", q_all[:64].contiguous(), items, 1024, torch.from_numpy(excl).to(dev))
    check("k512_duplicated_rows_ties", dq, ditems, 512)
    check("k300_rising_scores", q_all[:16].abs().contiguous() + 0.5, rising, 300)
    check("k300_ragged_N1000", *tensors(16, 1000, r), 300)
    for other_r in (33, 8):
        check(f"k512_rank_{other_r}", *tensors(16, 3000, other_r), 512)
    fq, fitems = tensors(8, 600, r)
    few = np.tile(np.arange(600, dtype=np.int32), (8, 1))
    few[1::2, 100:] = -1  # odd rows keep 500 items, even rows none
    check("k300_fewer_finite_than_k", fq, fitems, 300, torch.from_numpy(few).to(dev))
    # ties at the k-th key: every score equal (all three levels of the
    # histogram, then index order), and +0.0 / -0.0 factors scoring exact
    # zeros across the boundary (10,000 keys from the zero bin up, more
    # than the 4,096 survivors at k = 2,500)
    same_q, _ = tensors(8, 1, r)
    one_row = np.tile(rng.standard_normal((1, r), dtype=np.float32), (5000, 1))
    check("k300_identical_rows", same_q, torch.from_numpy(one_row).to(dev), 300)
    pos = np.abs(rng.standard_normal((2000, r), dtype=np.float32)) + 0.05
    zeros = np.where(rng.random((8000, r)) < 0.5, np.float32(-0.0), np.float32(0.0))
    signed = np.concatenate([pos, zeros, -pos])[rng.permutation(12000)]
    check("k2500_signed_zeros", same_q.abs() + 0.1, torch.from_numpy(signed).to(dev), 2500)
    # k above the old ceiling of 2048, up to the catalog: a served num of
    # 4096 (the select path; the per-tile sort's 20 lists of 256 merged in
    # shared memory beside it), then k = N with 64 exclusions a query (above
    # the select path's ceiling: 106 lists, merged in device memory)
    k_q, k_items = tensors(64, 5000, r)
    main["k4096_N5000"] = check("k4096_N5000", k_q, k_items, 4096, timed=True)
    main["k_eq_N27000_E64"] = check("k_eq_N27000_E64", q_all[:64].contiguous(), items, n,
                                    torch.from_numpy(excl).to(dev), timed=True)
    return main


def traced_device_ms(torch, fn, iters: int, ops_per_call: int = 1):
    """:func:`device_time`'s ms for a call of several milliseconds, or None
    (not measured) when no trace held as many device ops a call as the call
    launches: at these shapes the profiler has dropped some of the top-k
    launches made through ``ctypes`` (0.405 ms read for a 13.4 ms call),
    once all of them, and late in a long run most of the attention and SDPA
    ops of a trace. The CUDA-event time stands beside it."""
    try:
        return device_time(torch, fn, iters, ops_per_call)["ms"]
    except AssertionError:
        return None


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
                "T": plan.tiles_per_block, "n_runs": plan.n_runs, "stage1": plan.stage1,
                "max_abs_err": err, "agree": ok, "wrong_ids_outside_ties": wrong}
        if plan.stage1 == "running_list_tiled":
            # one launch at 128 < k <= 256, bit for bit the per-tile sort's
            # answer, which is timed beside it
            per_tile = lambda: top_k_streaming(q, items, k, stage1="tile_sort")  # noqa: E731
            forced = per_tile()
            line["equal_to_tile_sort"] = bool(torch.equal(got[0], forced[0])
                                              and torch.equal(got[1], forced[1]))
            ok = ok and line["equal_to_tile_sort"] and len(slices) == 1
            del forced
            n_slices = len(topk_batch_slices(b, n_items=n, k_eff=k, rank=r,
                                             sm_count=sm_count, stage1="tile_sort"))
            line["tile_sort_ms"] = time_ms(torch, per_tile, 3, 1)
            line["tile_sort_device_ms"] = traced_device_ms(torch, per_tile, 2,
                                                           9 * n_slices)
        line.update({
                "kernel_ms": time_ms(torch, kernel, 10, 2),
                "kernel_device_ms": traced_device_ms(torch, kernel, 5, 2 * len(slices)),
                "plain_chunked_ms": time_ms(torch, plain, 2, 1),
                "library_ms": time_ms(torch, library, 5, 1),
                "library_device_ms": traced_device_ms(torch, library, 3, 2),
                "bound_us": bound_ms * 1e3, "bound_by": bound_by})
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
    saved = ck.TOPK_BLOCKS_PER_SM
    variants = [("tile_sort", "tile_sort", saved)]
    variants += [(f"running_list_{n_blocks}_per_sm", None, n_blocks)
                 for n_blocks in blocks_per_sm]
    variants.append(variants[0])
    try:
        for label, stage1, n_blocks in variants:
            ck.TOPK_BLOCKS_PER_SM = n_blocks
            ck.topk_launch_plan.cache_clear()
            for name, (b, k, ex) in shapes.items():
                q = q_all[:b].contiguous()
                err, ok = agreement(ck.top_k_streaming(q, items, k, ex, stage1),
                                    ck.top_k_streaming_reference(q, items, k, ex))
                plan = ck.topk_launch_plan(b, n, k, sm_count, r, stage1)
                fn = lambda: ck.top_k_streaming(q, items, k, ex, stage1)  # noqa: E731
                emit({"variant": label, "shape": name, "T": plan.tiles_per_block,
                      "n_runs": plan.n_runs, "agree": ok, "max_abs_err": err,
                      "kernel_ms": time_ms(torch, fn),
                      "kernel_device_ms": device_time(torch, fn)["ms"]})
                if not ok:
                    raise AssertionError(f"{label} disagrees with plain at {name}")
    finally:
        ck.TOPK_BLOCKS_PER_SM = saved
        ck.topk_launch_plan.cache_clear()


#: the shapes of :func:`topk_k256_variants`: (name, B, k) over ML-20M's
#: catalog at rank 50, and the k <= 128 shapes whose times must not move
TOPK_K256_SHAPES = (("B64_k256", 64, 256), ("B1024_k256", 1024, 256),
                    ("B1024_k129", 1024, 129), ("B32768_k256", 32768, 256),
                    ("B1024_k16", 1024, 16), ("B512_k128", 512, 128))
#: the stage-1 kernels it times, A B B A (the first one again at the end)
TOPK_K256_ORDER = ("tile_sort", "running_list", "running_list_tiled",
                   "running_list_tiled", "running_list", "tile_sort")


def topk_k256_variants(torch, dev, seed: int = 0) -> None:
    """Not a phase of the run: the top-k at 128 < k <= 256 under each
    stage-1 kernel, for PERF.md. Builds only the top-k library, checks its
    kernels' attributes (:func:`check_topk_attributes`), then for each of
    ``TOPK_K256_SHAPES`` (N = 27,000, R = 50) holds the plan's answer bit
    for bit to every forced kernel's (``torch.equal``) and to the plain
    version, and times the kernels in the order ``TOPK_K256_ORDER`` (event
    and device ms). At k <= 128 the plan's own kernel is the one-item
    running list; the tiled kernel is timed there too. To compare two trees
    in one call, unpack the other under ``chip_compare/`` and run this in
    each, A B B A."""
    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    build.build_all(["topk_streaming"])
    check_topk_attributes(torch, dev)
    rng = np.random.default_rng(seed)
    n, r = 27000, 50
    q_all = torch.from_numpy(rng.standard_normal((32768, r), dtype=np.float32)).to(dev)
    items = torch.from_numpy(rng.standard_normal((n, r), dtype=np.float32)).to(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, b, k in TOPK_K256_SHAPES:
        q = q_all[:b].contiguous()
        got = ck.top_k_streaming(q, items, k)
        want = ck.top_k_streaming_reference(q, items, k)
        err, ok = agreement(got, want)
        line = {"phase": "topk_variant", "tree": os.path.basename(os.getcwd()),
                "shape": name, "B": b, "k": k, "agree": ok, "max_abs_err": err,
                "wrong_ids_outside_ties": wrong_outside_ties(got, want),
                "plan": ck.topk_launch_plan(b, n, k, sm, r).stage1, "stage1": {}}
        del want
        for stage1 in TOPK_K256_ORDER[:3]:
            other = ck.top_k_streaming(q, items, k, stage1=stage1)
            plan = ck.topk_launch_plan(b, n, k, sm, r, stage1)
            line["stage1"][stage1] = {
                "T": plan.tiles_per_block, "n_runs": plan.n_runs,
                "slices": len(ck.topk_batch_slices(b, n_items=n, k_eff=k, rank=r,
                                                   sm_count=sm, stage1=stage1)),
                "equal": bool(torch.equal(got[0], other[0]) and torch.equal(got[1], other[1])),
                "ms": [], "device_ms": []}
            del other
        try:  # where the plan's call spends the card's time
            line["top_device_ops"] = device_time(
                torch, lambda: ck.top_k_streaming(q, items, k), 3)["top_device_ops"]
        except AssertionError:
            line["top_device_ops"] = None
        for stage1 in TOPK_K256_ORDER:
            fn = lambda: ck.top_k_streaming(q, items, k, stage1=stage1)  # noqa: E731
            big = b * k > (1 << 22)
            line["stage1"][stage1]["ms"].append(time_ms(torch, fn, 5 if big else 30,
                                                        1 if big else 3))
            line["stage1"][stage1]["device_ms"].append(
                traced_device_ms(torch, fn, 3 if big else 20))
        emit(line)
        if not ok or not all(v["equal"] for v in line["stage1"].values()):
            raise AssertionError(f"top-k stage-1 kernels disagree at {name}: {line}")
        del got


#: the tiled kernel's phases as the knock-outs cut them: (anchor, marker,
#: replacement) — the first ``marker`` after ``anchor`` in the .cu is
#: replaced, or with no replacement the first ``if``/``for`` statement after
#: it is removed. ``scoring`` keeps one rank of each staged chunk (the scores
#: stay random, so the selection sees the same traffic), ``load`` reads a
#: hash of the index instead of the item table.
TOPK_TILED_PHASES = {
    "scoring": ("topk_run_tiled_kernel(",
                "score_step_chunk(acc, s_items, s_qT, start, r0 - start, rc, t);",
                "score_step_chunk(acc, s_items, s_qT, start, rc - 1, rc, t);"),
    "load": ("void load_step_chunk(", "items[(size_t)gi * R + r0 + rr]",
             "__int_as_float(0x3f800000u | ((gi * 2654435761u + rr * 40503u) >> 9))"),
    "gather": ("void select_slice(", "int* nxt_i = s_li + (cur ^ 1) * kTileQueries * kt;",
               None),
    "flush": ("void select_slice(", "p_max = max(p_max, pending(pend, qi));", None),
    "dense_sort": ("void dense_slice(", "warp_sort<H>(s, i, lane);", ""),
    "dense_merge": ("void dense_slice(",
                    "place_four(cs, ci, ls, li, kt, ns, ni, kt, 0, lane);\n"
                    "  place_four(cs, ci, ls, li, kt, ns, ni, kt, 4, lane);\n"
                    "  place_four(ls, li, cs, ci, kt, ns, ni, kt, 0, lane);\n"
                    "  place_four(ls, li, cs, ci, kt, ns, ni, kt, 4, lane);", ""),
    "store": ("topk_run_tiled_kernel(", "const float* fin_s = s_ls", None),
}


def topk_k256_knockouts(torch, dev, source: str = TOPK_SOURCE) -> None:
    """Where the tiled kernel's time goes at k = 256 (N = 27,000, R = 50,
    B = 64, 1,024 and 32,768): ``source`` built as it is and once without each
    phase, all with ``nvcc -Xptxas -v`` at once, then each launched with
    the plan's own tiled plan (CUDA events). ``scoring`` keeps one rank of
    each staged chunk (the scores stay random, so the selection sees the
    same traffic), ``load`` reads a hash of the index instead of the item
    table, the rest cut or replace a statement (``TOPK_TILED_PHASES``). A knock-out's
    answer is wrong; its time less the whole kernel's is what that phase
    costs where nothing hides it. The one-item running list and the
    per-tile sort are timed beside them from the whole build."""
    import ctypes
    import re

    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    text = open(source).read()
    variants = {"whole": text}
    for name, (anchor, marker, replacement) in TOPK_TILED_PHASES.items():
        at = text.index(marker, text.index(anchor))
        if replacement is not None:
            variants[name] = text[:at] + replacement + text[at + len(marker):]
            continue
        cut = text[:at] + _without_statement(text[at:], marker)
        # a loop cut after its unroll pragma leaves the pragma on no loop
        variants[name] = re.sub(r"#pragma unroll\n(?!\s*for)", "", cut)
    tmp = tempfile.mkdtemp(prefix="topk_knockouts_")
    procs = {}
    for name, src in variants.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise AssertionError(f"knock-out {name} did not build: {log[-2000:]}")
        tiled = log[log.index("topk_run_tiled_kernel"):]
        emit({"phase": "topk_knockout", "variant": name,
              "ptxas": re.findall(r"(\d+ bytes spill stores|Used \d+ registers)", tiled)[:2]})
        lib = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so"))
        lib.pio_topk_streaming.argtypes = ck._TOPK_ARGTYPES
        libs[name] = lib
    rng = np.random.default_rng(0)
    n, r, k = 27000, 50, 256
    items = torch.from_numpy(rng.standard_normal((n, r), dtype=np.float32)).to(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in (64, 1024, 32768):
        q = torch.from_numpy(rng.standard_normal((b, r), dtype=np.float32)).to(dev)
        out_s = torch.empty((b, k), device=dev)
        out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
        times = {}
        for stage1 in ("tile_sort", "running_list", "running_list_tiled"):
            plan = ck.topk_launch_plan(b, n, k, sm, r, stage1)
            if ck.topk_scratch_bytes(plan) <= ck.TOPK_MAX_SCRATCH_BYTES:  # unsliced
                scratch = torch.empty((4, b * plan.n_runs * plan.kt), device=dev)
                for name, lib in (libs.items() if stage1 == "running_list_tiled"
                                  else [("whole", libs["whole"])]):
                    def launch(lib=lib, plan=plan, scratch=scratch, name=name):
                        step = 4 * scratch.shape[1]
                        base = scratch.data_ptr()
                        code = lib.pio_topk_streaming(
                            q.data_ptr(), items.data_ptr(), None, b, n, r, 0, k, plan.kt,
                            plan.n_tiles, plan.tiles_per_block, plan.n_runs,
                            ck.TOPK_STAGE1.index(plan.stage1), plan.stage1_smem,
                            plan.merge_smem, plan.merge_threads, base, base + step,
                            base + 2 * step, base + 3 * step, out_s.data_ptr(),
                            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
                        if code:
                            raise AssertionError(f"knock-out {name} failed to launch: {code}")
                    label = name if stage1 == "running_list_tiled" else stage1
                    times[label] = time_ms(torch, launch, 5 if b > 1024 else 20, 1)
                del scratch
        emit({"phase": "topk_knockout", "B": b, "k": k, "ms": times,
              "phase_ms": {name: times["whole"] - times[name]
                           for name in variants if name != "whole"}})
        del q, out_s, out_i
    shutil.rmtree(tmp, ignore_errors=True)


#: the k > 256 shapes of :func:`topk_large_k_grid`: (name, B, N, k) at R = 50,
#: candidate generation's k over ML-20M's catalog at served batches, and the
#: main path's k = 4,096 on 5,000 items
TOPK_GRID = tuple((f"B{b}_k{k}", b, 27000, k) for k in (512, 1024, 4096)
                  for b in (1, 64, 1024)) + (("k4096_N5000", 64, 5000, 4096),)


def topk_large_k_grid(torch, dev, seed: int = 0, shapes=TOPK_GRID) -> dict:
    """The top-k at k > 256 on ``shapes`` (R = 50): the per-tile sort
    (``stage1="tile_sort"``), the select path, ``torch.topk(q @ items.T,
    k)`` and the plain version, timed in one call A B B A (the list of
    variants, then the same list reversed), event ms and device ms for
    each reading. Before timing, every variant's answer is held to the
    plain version, the select path's to the per-tile sort's bit for bit
    (``torch.equal``) and to a second call of its own. Returns the lines
    by shape; fails if an answer disagrees."""
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(seed + 17)
    r = 50
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stage1s = ("tile_sort", "select")
    order = [*stage1s, "library", "plain"]
    order += order[::-1]
    out = {}
    items_by_n = {}
    for name, b, n, k in shapes:
        if n not in items_by_n:
            items_by_n[n] = torch.from_numpy(
                rng.standard_normal((n, r), dtype=np.float32)).to(dev)
        items = items_by_n[n]
        q = torch.from_numpy(rng.standard_normal((b, r), dtype=np.float32)).to(dev)
        calls = {s: (lambda s=s: ck.top_k_streaming(q, items, k, stage1=s)) for s in stage1s}
        calls["library"] = lambda: torch.topk(q @ items.T, k, dim=1)
        calls["plain"] = lambda: ck.top_k_streaming_reference(q, items, k)
        want = calls["plain"]()
        per_tile = calls["tile_sort"]()
        err, ok = agreement(per_tile, want)
        line = {"phase": "topk_grid", "shape": name, "B": b, "N": n, "R": r, "k": k,
                "plan": ck.topk_launch_plan(b, n, min(k, n), sm, r).stage1,
                "tile_sort_max_abs_err": err, "tile_sort_agree": ok}
        got = calls["select"]()
        again = calls["select"]()
        line["select_max_abs_err"], line["select_agree"] = agreement(got, want)
        line["select_equal_to_tile_sort"] = bool(
            torch.equal(got[0], per_tile[0]) and torch.equal(got[1], per_tile[1]))
        line["select_bit_identical"] = bool(
            torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
        ok = (ok and line["select_agree"] and line["select_equal_to_tile_sort"]
              and line["select_bit_identical"])
        del got, again, want, per_tile
        iters, device_iters = (5, 3) if b >= 1024 else (20, 10)
        line["ms"] = {v: [] for v in calls}
        line["device_ms"] = {v: [] for v in calls}
        for variant in order:
            line["ms"][variant].append(time_ms(torch, calls[variant], iters, 2))
            line["device_ms"][variant].append(
                traced_device_ms(torch, calls[variant], device_iters, 2))
        bound_ms, line["bound_by"] = topk_bound(b, n, r, k)
        line["bound_us"] = bound_ms * 1e3
        emit(line)
        if not ok:
            raise AssertionError(f"top-k at k > 256 disagrees at {name}: {line}")
        out[name] = line
        del q
    del items_by_n
    torch.cuda.empty_cache()
    return out


#: the select path's phases as its knock-outs cut them, in the form of
#: ``TOPK_TILED_PHASES``: ``scoring`` keeps one rank of each staged chunk,
#: ``hist`` drops the score kernel's per-key count, ``store`` its 16-byte score
#: stores, ``refine`` the select kernel's second and third counts (the keys
#: past the buffer are dropped), ``gather`` and ``sort`` what they name. A
#: knock-out's answer is wrong; the select kernel guards every index, so none
#: reads or writes out of bounds.
TOPK_SELECT_PHASES = {
    "scoring": ("topk_select_score_kernel(",
                "score_step_chunk(acc, s_items, s_qT, start, r0 - start, rc, t);",
                "score_step_chunk(acc, s_items, s_qT, start, rc - 1, rc, t);"),
    "hist": ("topk_select_score_kernel(",
             "if (j0 + c < N) atomicAdd(&s_hist[qi * kSelectBins + (order_key(v[c]) >> 21)], 1u);",
             ""),
    "store": ("topk_select_score_kernel(",
              "*reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);", ""),
    "refine": ("topk_select_kernel(", "if (count > static_cast<unsigned>(cap)) {  // the next",
               "if (false) {  // the next"),
    "gather": ("topk_select_kernel(", "// Gather: 16 keys a thread a pass", None),
    "sort": ("topk_select_kernel(", "block_sort(s_keys, P);", ""),
}
#: trials of the select path, each a list of (old, new) replacements in the
#: .cu; a trial must give the whole kernel's answer bit for bit
TOPK_SELECT_TRIALS = {
    # one shared atomic a run of equal bins in a warp (__match_any_sync)
    "match_any_hist": [(
        "if (j0 + c < N) atomicAdd(&s_hist[qi * kSelectBins + (order_key(v[c]) >> 21)], 1u);",
        "const unsigned bin = j0 + c < N ? order_key(v[c]) >> 21 : 0xffffffffu;\n"
        "          const unsigned peers = __match_any_sync(kFullWarp, bin);\n"
        "          if (bin != 0xffffffffu && (t & 31) == __ffs(peers) - 1) {\n"
        "            atomicAdd(&s_hist[qi * kSelectBins + bin], static_cast<unsigned>(__popc(peers)));\n"
        "          }")],
}
#: the shapes the knock-outs and trials are timed at: (name, B, N, k), R = 50
TOPK_SELECT_KNOCKOUT_SHAPES = (("B1_k4096", 1, 27000, 4096), ("k4096_N5000", 64, 5000, 4096),
                               ("B1024_k1024", 1024, 27000, 1024),
                               ("B1024_k4096", 1024, 27000, 4096))


def topk_select_knockouts(torch, dev, source: str = TOPK_SOURCE) -> None:
    """Where the select path's time goes: ``source`` built as it is, once
    without each phase (``TOPK_SELECT_PHASES``) and once with each trial
    (``TOPK_SELECT_TRIALS``), all with ``nvcc -Xptxas -v`` at once; each
    launched through ``pio_topk_select`` with the plan's own select plan
    at ``TOPK_SELECT_KNOCKOUT_SHAPES`` (event ms a call, and device ms a
    call of each of its kernels under the profiler). The whole build is
    timed first and again last; a trial is held to it bit for bit. A
    knock-out's time less the whole kernel's is what that phase costs
    where nothing hides it."""
    import ctypes
    import re

    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    text = open(source).read()
    variants = {"whole": text}
    for name, (anchor, marker, replacement) in TOPK_SELECT_PHASES.items():
        at = text.index(marker, text.index(anchor))
        if replacement is not None:
            variants[name] = text[:at] + replacement + text[at + len(marker):]
            continue
        cut = text[:at] + _without_statement(text[at:], marker)
        variants[name] = re.sub(r"#pragma unroll\n(?!\s*for)", "", cut)
    for name, swaps in TOPK_SELECT_TRIALS.items():
        src = text
        for old, new in swaps:
            if old not in src:
                raise AssertionError(f"trial {name}: {old!r} is not in the source")
            src = src.replace(old, new)
        variants[name] = src
    tmp = tempfile.mkdtemp(prefix="topk_select_knockouts_")
    procs = {}
    for name, src in variants.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise AssertionError(f"knock-out {name} did not build: {log[-2000:]}")
        regs = {}
        for kernel in ("topk_select_score_kernel", "topk_select_kernel"):
            part = log[log.index(kernel + "E"):]
            regs[kernel] = re.findall(r"(\d+ bytes spill stores|Used \d+ registers)", part)[:2]
        emit({"phase": "topk_select_knockout", "variant": name, "ptxas": regs})
        lib = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so"))
        lib.pio_topk_select.argtypes = ck._EXTRA_ENTRIES["topk_streaming"]["pio_topk_select"]
        libs[name] = lib
    rng = np.random.default_rng(0)
    r = 50
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    order = [*variants, "whole"]
    for shape, b, n, k in TOPK_SELECT_KNOCKOUT_SHAPES:
        items = torch.from_numpy(rng.standard_normal((n, r), dtype=np.float32)).to(dev)
        q = torch.from_numpy(rng.standard_normal((b, r), dtype=np.float32)).to(dev)
        plan = ck.topk_launch_plan(b, n, k, sm, r)
        ld = plan.scratch_shape[2] - ck.TOPK_SELECT_BINS
        scratch = torch.empty((b, plan.scratch_shape[2]), device=dev)
        outs = {}
        line = {"phase": "topk_select_knockout", "shape": shape, "B": b, "N": n, "k": k,
                "ms": {}, "device_ms": {}}
        for name in order:
            out_s = torch.empty((b, k), device=dev)
            out_i = torch.empty((b, k), dtype=torch.int32, device=dev)

            def launch(lib=libs[name], out_s=out_s, out_i=out_i, name=name):
                base = scratch.data_ptr()
                code = lib.pio_topk_select(
                    q.data_ptr(), items.data_ptr(), None, b, n, r, 0, k, plan.n_tiles,
                    plan.tiles_per_block, plan.n_runs, ld, plan.stage1_smem,
                    plan.merge_smem, plan.survivors, base, base + 4 * b * ld,
                    out_s.data_ptr(), out_i.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
                if code:
                    raise AssertionError(f"knock-out {name} failed to launch: {code}")
            launch()
            torch.cuda.synchronize()
            outs.setdefault(name, (out_s, out_i))
            line["ms"].setdefault(name, []).append(time_ms(torch, launch, 5 if b > 64 else 20, 1))
            try:
                ops = device_time(torch, launch, 3 if b > 64 else 10, 2)["top_device_ops"]
                per = {o["name"].split("::")[-1][:24]: o["ms"] / o["count"] for o in ops}
            except AssertionError:
                per = None
            line["device_ms"].setdefault(name, []).append(per)
        whole = outs["whole"]
        line["trials_equal"] = {name: bool(torch.equal(outs[name][0], whole[0])
                                           and torch.equal(outs[name][1], whole[1]))
                                for name in TOPK_SELECT_TRIALS}
        emit(line)
        del items, q, scratch, outs
    shutil.rmtree(tmp, ignore_errors=True)


#: the shapes of :func:`topk_path_times`: (name, B, k, exclusions) at N =
#: 27,000, R = 50, the plans k <= 256 takes
TOPK_PATH_SHAPES = (("B1_k16", 1, 16, 0), ("B64_k16", 64, 16, 0), ("B1024_k16", 1024, 16, 0),
                    ("B64_k16_E64", 64, 16, 64), ("B512_k128", 512, 128, 0),
                    ("B64_k256", 64, 256, 0), ("B1024_k256", 1024, 256, 0),
                    ("B1024_k129", 1024, 129, 0), ("B32768_k256", 32768, 256, 0))


def topk_path_times(torch, dev, seed: int = 0) -> None:
    """The top-k at k <= 256 alone at ``TOPK_PATH_SHAPES``, each through
    the plan's own kernel: the plan, the registers of every top-k kernel
    and the event and device ms. It uses only what the package has had
    since the tiled running list, so it times an older tree too: from
    that tree's root, load this file by path
    (``importlib.util.spec_from_file_location``) and call it there, A B B
    A with this tree."""
    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    build.build_all(["topk_streaming"])
    tree = os.path.basename(os.getcwd())
    emit({"phase": "topk_path_times", "tree": tree,
          "regs": {name: a["regs"] for name, a in ck.topk_kernel_attributes(dev).items()}})
    rng = np.random.default_rng(seed + 31)
    n, r = 27000, 50
    items = torch.from_numpy(rng.standard_normal((n, r), dtype=np.float32)).to(dev)
    q_all = torch.from_numpy(rng.standard_normal((32768, r), dtype=np.float32)).to(dev)
    excl = torch.from_numpy(rng.integers(-1, n, size=(64, 64)).astype(np.int32)).to(dev)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, b, k, e in TOPK_PATH_SHAPES:
        q = q_all[:b].contiguous()
        ex = excl if e else None
        plan = ck.topk_launch_plan(b, n, k, sm, r)
        kernel = lambda: ck.top_k_streaming(q, items, k, ex)  # noqa: E731
        big = b > 1024
        emit({"phase": "topk_path_times", "tree": tree, "shape": name, "stage1": plan.stage1,
              "T": plan.tiles_per_block, "n_runs": plan.n_runs,
              "ms": time_ms(torch, kernel, 5 if big else 30, 1 if big else 3),
              "device_ms": traced_device_ms(torch, kernel, 3 if big else 20)})
        del q


def library_times_alone(torch, dev, seed: int = 0) -> None:
    """Not a phase of the run: two library times that earlier full runs
    left open, each in a call of its own, A B B A beside the kernel of
    the same shape: SDPA (fp32) against the passes attention kernel at
    D = ``WIDE_PASSES_HEAD`` on the training shape, and ``torch.topk(q @
    items.T, 256)`` against the tiled running list at B = 32,768, N =
    27,000, R = 50 (event and device ms each)."""
    import torch.nn.functional as F

    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    build.build_all(["flash_attention", "topk_streaming"])
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    b, h, lq, lk, causal = WIDE_ATTN_SHAPES[0]
    d = WIDE_PASSES_HEAD
    q, k, v = (torch.randn((b, h, n_, d), generator=gen, device=dev) for n_ in (lq, lk, lk))
    calls = {"passes": lambda: ck.flash_attention_fwd(q, k, v, causal),
             "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)}
    line = {"phase": "library_alone", "case": f"attention_D{d}_{b}x{h}x{lq}_causal_{causal}",
            "path": ck.flash_plan_for(q, k, causal).path, "ms": {}, "device_ms": {}}
    for name in ("passes", "sdpa", "sdpa", "passes"):
        line["ms"].setdefault(name, []).append(time_ms(torch, calls[name], 20, 3))
        line["device_ms"].setdefault(name, []).append(traced_device_ms(torch, calls[name], 20))
    emit(line)
    del q, k, v
    rng = np.random.default_rng(seed + 29)
    b, n, r, kk = 32768, 27000, 50, 256
    q = torch.from_numpy(rng.standard_normal((b, r), dtype=np.float32)).to(dev)
    items = torch.from_numpy(rng.standard_normal((n, r), dtype=np.float32)).to(dev)
    calls = {"running_list_tiled": lambda: ck.top_k_streaming(q, items, kk),
             "library": lambda: torch.topk(q @ items.T, kk, dim=1)}
    line = {"phase": "library_alone", "case": f"topk_B{b}_N{n}_k{kk}", "ms": {},
            "device_ms": {}}
    for name in ("running_list_tiled", "library", "library", "running_list_tiled"):
        line["ms"].setdefault(name, []).append(time_ms(torch, calls[name], 5, 1))
        line["device_ms"].setdefault(name, []).append(traced_device_ms(torch, calls[name], 3))
    emit(line)


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
            out["kernel_device_ms"] = traced_device_ms(torch, kernel, 10)
            out["library_device_ms"] = traced_device_ms(torch, library, 3)
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
            out["kernel_device_ms"] = traced_device_ms(torch, kernel, 10)
            out["library_device_ms"] = traced_device_ms(torch, library, 3)
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
                for key in ("kernel_ms", "plain_ms", "library_ms"):
                    acc[key] += out[key]
                for key in ("kernel_device_ms", "library_device_ms"):  # null: a short trace
                    acc[key] = None if None in (acc[key], out[key]) else acc[key] + out[key]
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
    if out["plan"]["path"] != "blocked":  # picked by n alone
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


def als_smoke_engine(data: dict):
    """(engine, params): the recommendation engine over a DataSource of the
    training split, and the main path's ALS params (rank 50, 10
    iterations, λ 0.05, seed 0)."""
    from predictionio_tpu_torch.controller import DataSource, Engine, FirstServing
    from predictionio_tpu_torch.models.recommendation import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        RecPreparator,
        TrainingData,
    )
    from predictionio_tpu_torch.storage import BiMap

    users, items, ratings, tr = data["users"], data["items"], data["ratings"], data["train"]
    training = TrainingData(
        users=users[tr].astype(np.int32), items=items[tr].astype(np.int32),
        ratings=ratings[tr],
        user_map=BiMap({f"u{i}": i for i in range(data["n_users"])}),
        item_map=BiMap({f"i{i}": i for i in range(data["n_items"])}),
    )

    class SmokeDataSource(DataSource):
        def read_training(self, ctx):
            return training

    engine = Engine({"": SmokeDataSource}, {"": RecPreparator},
                    {"als": ALSAlgorithm}, {"": FirstServing})
    return engine, ALSAlgorithmParams(rank=RANK, num_iterations=TRAIN_ITERS,
                                      lambda_=LAMBDA, seed=TRAIN_SEED)


def phase_train(torch, dev, data: dict, registry) -> dict:
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops.cuda_kernels import (
        gramian_fused,
        gramian_fused_reference,
        spd_solve,
        spd_solve_reference,
    )
    from predictionio_tpu_torch.workflow import WorkflowContext, load_models, run_train

    users, items, ratings = data["users"], data["items"], data["ratings"]
    tr, test = data["train"], data["test"]
    n_users, n_items = data["n_users"], data["n_items"]
    engine, params = als_smoke_engine(data)
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


@contextlib.contextmanager
def env_set(values: dict):
    """``os.environ`` updated with ``values`` for the block, then restored."""
    prior = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


RESUME_EVERY, RESUME_FIRST = 3, 6  # run A: 6 iterations, a checkpoint every 3


def phase_resume(torch, dev, data: dict, registry, trained: dict) -> dict:
    """``run_train``'s tail and checkpoint resume on the card. Run A trains
    the train phase's engine for 6 iterations with a checkpoint every 3
    under a pinned ``PIO_CKPT_DIR``, ``PIO_PROFILE_DIR`` and
    ``PIO_PERF_LEDGER``; run B asks for the train phase's 10 and resumes
    from step 6. Each run's build and solve counts are reset just before
    its ``run_train`` and read just after. Then the split of the train
    phase's own ``run_train`` from its instance's ``PIO_TRAIN_PHASES``."""
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.obs import perfledger
    from predictionio_tpu_torch.ops.cuda_kernels import gramian_fused, spd_solve
    from predictionio_tpu_torch.storage import Model, StorageRegistry
    from predictionio_tpu_torch.utils.profiling import phases_from_env, profile_from_env
    from predictionio_tpu_torch.workflow import WorkflowContext, load_models, run_train
    from predictionio_tpu_torch.workflow.checkpoint import CheckpointManager

    engine, params = als_smoke_engine(data)
    out = {"phase": "resume", "runs": {}}
    (want,) = load_models(registry, trained["instance"])
    with tempfile.TemporaryDirectory(prefix="pio_resume_") as tmp:
        own = StorageRegistry({"PIO_FS_BASEDIR": os.path.join(tmp, "store")})
        ck, ledger = os.path.join(tmp, "ck"), os.path.join(tmp, "perf.jsonl")
        for name, iterations in (("A", RESUME_FIRST), ("B", TRAIN_ITERS)):
            trace_dir = os.path.join(tmp, f"trace_{name}")
            ep = EngineParams(algorithm_params_list=[("als", dataclasses.replace(
                params, num_iterations=iterations, checkpoint_every=RESUME_EVERY))])
            ctx = WorkflowContext(device=dev)
            ctx.profile = {}
            with env_set({"PIO_CKPT_DIR": ck, "PIO_PROFILE_DIR": trace_dir,
                          "PIO_PERF_LEDGER": ledger}):
                gramian_fused.launches = spd_solve.launches = 0  # main path starts here
                t0 = time.monotonic()
                instance_id = run_train(engine, ep, own, ctx=ctx)
                wall_s = time.monotonic() - t0
                launches = {"gramian_fused": gramian_fused.launches,
                            "spd_solve": spd_solve.launches}  # main path ends here
            (path,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
                       if f.endswith(".pt.trace.json")]
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            records = perfledger.load_ledger(ledger)
            run = {"instance": instance_id, "iterations": iterations, "wall_s": wall_s,
                   "resumed_from": ctx.profile["resumed_from"],
                   "iteration_s": ctx.profile["iteration_s"],
                   "launches": launches, "launches_per_iteration": ctx.profile["launches"],
                   "steps": CheckpointManager(os.path.join(ck, "algo_0")).all_steps(),
                   "trace_events": len(events), "trace_cuda_kernels": len(kernels),
                   "trace_build_solve_kernels": sum(
                       1 for e in kernels if re.search("gramian|spd", e.get("name", ""))),
                   "ledger_records": len(records), "ledger_last": records[-1] if records else None,
                   "phases": phases_from_env(own.get_metadata().engine_instance_get(
                       instance_id).env)}
            out["runs"][name] = run
            record = run["ledger_last"] or {}
            if not (kernels and len(records) == (1 if name == "A" else 2)
                    and record.get("device", "").startswith("cuda:")
                    and {"read", "prepare", "train[0]"} <= set(record.get("phases", {}))
                    and {"read", "prepare", "train[0]"} <= set(run["phases"])):
                emit(out)
                raise AssertionError(f"run {name}: no CUDA kernel in the trace, or the "
                                     f"ledger or the phases are not as expected")
        a, b = out["runs"]["A"], out["runs"]["B"]
        per_iter = a["launches_per_iteration"][0]
        (got,) = load_models(own, b["instance"])
        # what run_train does after engine.train, again on the train
        # phase's model: the pickle, and the insert into a store
        t0 = time.monotonic()
        blob = pickle.dumps([want])
        pickle_s = time.monotonic() - t0
        t0 = time.monotonic()
        own.get_models().insert(Model(id="split-probe", models=blob))
        insert_s = time.monotonic() - t0
    out["resume_equal_to_train"] = bool(
        np.array_equal(got.user_factors, want.user_factors)
        and np.array_equal(got.item_factors, want.item_factors))
    left = TRAIN_ITERS - RESUME_FIRST
    ok = (a["resumed_from"] == 0 and a["steps"] == [RESUME_EVERY, RESUME_FIRST]
          and all(it == per_iter for it in a["launches_per_iteration"])
          and b["resumed_from"] == RESUME_FIRST and len(b["iteration_s"]) == left
          and b["launches"] == {k: left * v for k, v in per_iter.items()}
          and {9, TRAIN_ITERS} <= set(b["steps"]) and out["resume_equal_to_train"])

    # the train phase's own run_train, split
    env = registry.get_metadata().engine_instance_get(trained["instance"]).env
    phases = phases_from_env(env)
    engine_train_s = profile_from_env(env)["train_wall_s"]
    host = trained["host_prep_s"]
    iterations_s = sum(trained["iteration_s"])
    train0 = phases["train[0]"]
    out["split"] = {
        "run_train_s": trained["wall_s"],
        "read_s": phases["read"],
        "prepare_s": phases["prepare"],
        "train[0]_s": train0,
        "train[0]": {"bucketize_s": host["bucketize"], "sort_s": host["sort"],
                     "stage_s": host["stage"], "iterations_s": iterations_s,
                     "rest_s": train0 - host["bucketize"] - host["sort"] - host["stage"]
                     - iterations_s},
        "engine_train_rest_s": engine_train_s - phases["read"] - phases["prepare"] - train0,
        "outside_engine_train_s": trained["wall_s"] - engine_train_s,
        "outside_engine_train_again": {"pickle_s": pickle_s, "model_insert_s": insert_s,
                                       "blob_bytes": len(blob)},
    }
    emit(out)
    if not ok:
        raise AssertionError(f"resume: A {a['steps']}, B resumed from {b['resumed_from']} "
                             f"with {b['launches']} launches ({per_iter} an iteration), "
                             f"steps {b['steps']}, equal {out['resume_equal_to_train']}")
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

        def burst(num_of=lambda j: 1 + j % 50, max_num=50):
            """One burst of concurrent queries (``num_of(j)`` items for
            the j-th known user): (users, bodies, answers, wall seconds)."""
            users = rng.choice(n_users, size=HTTP_QUERIES - 2, replace=False)
            bodies = [{"user": f"u{u}", "num": num_of(j)}
                      for j, u in enumerate(users)]
            bodies += [{"user": "nobody-1", "num": 5},
                       {"user": "nobody-2", "num": max_num}]
            t_burst = time.monotonic()
            with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
                answers = list(pool.map(lambda b: _post_query(port, b), bodies))
            return users, bodies, answers, time.monotonic() - t_burst

        def checked(rnd, users, bodies, answers, wall, max_num=50):
            """Every answer of a burst against the plain version."""
            want_s, want_i = plain(users.tolist(), max_num)
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
        # a burst whose num is drawn from 129-256: the micro-batcher pads k
        # to 256, the tiled running list's path
        nums = rng.integers(129, 257, size=HTTP_QUERIES)
        before = top_k_streaming.launches
        wide_k = checked("num_129_256", *burst(lambda j: int(nums[j]), 256), max_num=256)
        wide_k["launches"] = top_k_streaming.launches - before
        if wide_k["launches"] < 1:
            raise AssertionError("the num 129-256 burst launched the kernel 0 times")
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
        "http_num_129_256": wide_k,
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


#: the plane phase: four shard servers; a generous budget for the traced
#: burst; the deadline the held query is sent with; the dead Event
#: Server's breaker threshold; the overhead rounds, A B B A
PLANE_SHARDS, PLANE_DEADLINE_MS, PLANE_SHORT_MS, PLANE_BREAKER_FAILURES = 4, 60000, 1, 3
PLANE_ROUNDS = ("on", "off", "off", "on")
PLANE_WAIT_S = 60.0
PLANE_FLIGHT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "flight_dumps",
                                "plane")


def _plane_post(port: int, body: dict, headers=None):
    """One ``POST /queries.json`` with extra headers: (status, body,
    response headers, seconds)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        t0 = time.monotonic()
        conn.request("POST", "/queries.json", json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        return resp.status, data, dict(resp.getheaders()), time.monotonic() - t0
    finally:
        conn.close()


def _get_text(port: int, path: str) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return conn.getresponse().read().decode()
    finally:
        conn.close()


def _wait_for(predicate, what: str, timeout: float = PLANE_WAIT_S):
    """Poll ``predicate`` every 10 ms until it is truthy; fail after
    ``timeout`` seconds. Returns its value."""
    deadline = time.monotonic() + timeout
    while True:
        value = predicate()
        if value:
            return value
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.01)


def _burst(port: int, bodies, headers_of=lambda j: None):
    """The bodies as one concurrent burst: (answers, wall seconds)."""
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
        answers = list(pool.map(lambda jb: _plane_post(port, jb[1], headers_of(jb[0])),
                                enumerate(bodies)))
    return answers, time.monotonic() - t0


def _latency(answers, wall: float) -> dict:
    lat = np.array([a[3] for a in answers]) * 1e3
    return {"wall_ms": wall * 1e3, "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def _read_line(stream, timeout: float) -> str:
    """One line from a child's pipe, waited for at most ``timeout`` s."""
    box = []
    reader = threading.Thread(target=lambda: box.append(stream.readline()), daemon=True)
    reader.start()
    reader.join(timeout)
    if not box:
        raise AssertionError(f"no line from the child within {timeout} s")
    return box[0]


def plane_killed_server(torch, base: str, device: str) -> dict:
    """``python -m predictionio_tpu_torch.tools.run_server`` on the card
    with ``PIO_FLIGHT_DIR`` set, one query and a ``/reload``, then SIGTERM:
    it must leave ``flight-<pid>.jsonl`` (reason ``signal-15``, the reload
    on its timeline) and ``faulthandler-<pid>.txt``."""
    import signal

    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models.recommendation import (
        ALSAlgorithmParams,
        als_model_from_numpy,
    )
    from predictionio_tpu_torch.obs.flight import load_dump
    from predictionio_tpu_torch.storage import StorageRegistry
    from predictionio_tpu_torch.tools.register import load_engine_dir
    from predictionio_tpu_torch.tools.templates import get_template
    from predictionio_tpu_torch.workflow import persist_instance

    engine_dir = os.path.join(base, "engine")
    flight_dir = os.path.join(base, "flight")
    get_template("recommendation", engine_dir)
    manifest = load_engine_dir(engine_dir).manifest
    rng = np.random.default_rng(0)
    small = als_model_from_numpy(RANK, rng.normal(size=(1000, RANK)),
                                 rng.normal(size=(2000, RANK)),
                                 [f"u{i}" for i in range(1000)], [f"i{i}" for i in range(2000)])
    persist_instance(StorageRegistry({"PIO_FS_BASEDIR": os.path.join(base, "store")}),
                     EngineParams(algorithm_params_list=[("als", ALSAlgorithmParams(rank=RANK))]),
                     [small], engine_id=manifest.id, engine_version=manifest.version)
    env = dict(os.environ, PIO_FS_BASEDIR=os.path.join(base, "store"),
               PIO_FLIGHT_DIR=flight_dir)
    t0 = time.monotonic()
    with open(os.path.join(base, "run_server.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.run_server", "--engine-dir",
             engine_dir, "--ip", "127.0.0.1", "--port", "0", "--device", device],
            stdout=subprocess.PIPE, stderr=log, text=True, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            port = json.loads(_read_line(proc.stdout, 300))["port"]
            up_s = time.monotonic() - t0
            status, answer, _, _ = _plane_post(port, {"user": "u3", "num": 10})
            if status != 200 or len(answer["itemScores"]) != 10:
                raise AssertionError(f"the spawned server answered {status}: {answer}")
            topk = _get_json(port, "/status.json").get("topkPath")
            if _http(port, "POST", "/reload")[0] != 200:
                raise AssertionError("the spawned server's /reload failed")
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            proc.stdout.close()
    if code != -signal.SIGTERM:
        raise AssertionError(f"the SIGTERMed server exited {code}")
    dump_path = os.path.join(flight_dir, f"flight-{proc.pid}.jsonl")
    doc = load_dump(dump_path)
    faulthandler_path = os.path.join(flight_dir, f"faulthandler-{proc.pid}.txt")
    if doc is None or doc["header"].get("reason") != "signal-15":
        raise AssertionError(f"no signal-15 flight dump at {dump_path}: {doc}")
    sites = [e.get("site") for e in doc["events"]]
    if "serving.reload" not in sites or not os.path.exists(faulthandler_path):
        raise AssertionError(f"the dump's timeline {sites} or the faulthandler file is missing")
    if topk != {"0:ALSAlgorithm": "streaming" if device.startswith("cuda") else "dense"}:
        raise AssertionError(f"the spawned server served through {topk}")
    return {"exit_code": code, "dump": os.path.basename(dump_path),
            "reason": doc["header"]["reason"], "events": sites,
            "faulthandler": os.path.basename(faulthandler_path), "topkPath": topk,
            "up_s": up_s, "seconds": time.monotonic() - t0}


def phase_plane(torch, dev, seed: int, registry, instance_id: str, base: str, smi: str) -> dict:
    from predictionio_tpu_torch.api.event_server import EventServerConfig, create_event_server
    from predictionio_tpu_torch.fleet.merge import merge_predictions, merged_matches_reference
    from predictionio_tpu_torch.models.recommendation import engine_factory
    from predictionio_tpu_torch.obs.slo import HealthConfig, load_alerts
    from predictionio_tpu_torch.ops.cuda_kernels import (
        top_k_streaming,
        top_k_streaming_reference,
    )
    from predictionio_tpu_torch.storage import EventFilter, StorageRegistry
    from predictionio_tpu_torch.storage.metadata import AccessKey, App
    from predictionio_tpu_torch.workflow import ServerConfig, create_query_server, load_models

    t_phase = time.monotonic()
    seconds = {}
    rng = np.random.default_rng(seed + 25)
    plane_dir = os.path.join(base, "plane")
    (model,) = load_models(registry, instance_id)  # what run_train wrote
    n_users, n_items = model.user_factors.shape[0], model.item_factors.shape[0]
    uf = torch.from_numpy(model.user_factors).to(dev)
    itf = torch.from_numpy(model.item_factors).to(dev)

    def same_answer(items_scores, want_s, want_i, num) -> bool:
        k = min(num, n_items)
        if len(items_scores) != k:
            return False
        got_s = np.array([x["score"] for x in items_scores], dtype=np.float32)
        got_i = np.array([int(x["item"][1:]) for x in items_scores])
        close = np.isclose(got_s, want_s[:k], rtol=RTOL, atol=ATOL)
        return bool(close.all() and ((got_i == want_i[:k]) | close).all())

    def check_plain(bodies, answers, what):
        """Every answer of a burst against the plain version (status 200)."""
        users = [int(b["user"][1:]) for b in bodies]
        idx = torch.tensor(users, device=dev, dtype=torch.long)
        want_s, want_i = (t.cpu().numpy() for t in top_k_streaming_reference(
            uf[idx].contiguous(), itf, max(b["num"] for b in bodies)))
        bad = [(b, a[0], a[1] if a[0] != 200 else a[1]["itemScores"][:2])
               for j, (b, a) in enumerate(zip(bodies, answers))
               if a[0] != 200 or not same_answer(a[1]["itemScores"], want_s[j], want_i[j],
                                                  b["num"])]
        if bad:
            raise AssertionError(f"{what}: answers disagree with the plain version: {bad[:3]}")

    picked = rng.choice(n_users, size=HTTP_QUERIES + 8, replace=False)
    warm = [{"user": f"u{u}", "num": 5} for u in picked[:8]]
    bodies = [{"user": f"u{u}", "num": 1 + j % 50} for j, u in enumerate(picked[8:])]
    trace_of = {j: f"plane-{seed}-{j}" for j in range(len(bodies))}

    def traced(j):
        return {"X-PIO-Trace": trace_of[j], "X-PIO-Deadline-Ms": str(PLANE_DEADLINE_MS)}

    # the port's own Event Server over a store of its own: the feedback target
    ev_registry = StorageRegistry({"PIO_FS_BASEDIR": os.path.join(plane_dir, "events")})
    md = ev_registry.get_metadata()
    app_id = md.app_insert(App(id=0, name="plane"))
    md.access_key_insert(AccessKey(key="plane-key", appid=app_id))
    ev_registry.get_events().init(app_id)
    servers = []
    out = {"phase": "plane", "card": smi, "users": n_users, "items": n_items,
           "rank": model.rank, "instance": instance_id}
    try:
        events = create_event_server(EventServerConfig(ip="127.0.0.1", port=0),
                                     registry=ev_registry, block=False)
        servers.append(events)
        ledger = os.path.join(plane_dir, "alerts.jsonl")
        # 1. one server with every plane on: feedback, health (ticked here),
        # the flight recorder armed in PIO_FLIGHT_DIR, traces and deadlines
        t = time.monotonic()
        with env_set({"PIO_FLIGHT_DIR": PLANE_FLIGHT_DIR, "PIO_ALERT_LEDGER": ledger}):
            planes = create_query_server(engine_factory(), ServerConfig(
                ip="127.0.0.1", port=0, device=dev, feedback=True,
                event_server_ip="127.0.0.1", event_server_port=events.bound_port,
                access_key="plane-key", health=HealthConfig(
                    alert_ledger=ledger, flight_dir=PLANE_FLIGHT_DIR, tick_s=0)),
                registry=registry, block=False)
        servers.append(planes)
        armed = os.path.join(PLANE_FLIGHT_DIR, f"faulthandler-{os.getpid()}.txt")
        if not os.path.exists(armed):
            raise AssertionError(f"PIO_FLIGHT_DIR did not arm the flight recorder: no {armed}")
        port = planes.bound_port
        check_plain(warm, _burst(port, warm)[0], "warm-up")
        _wait_for(lambda: planes.stats.count("feedback_sent") == len(warm), "warm-up feedback")
        seconds["deploy_and_warm"] = time.monotonic() - t
        batches0 = planes._batcher.stats["batches"]
        top_k_streaming.launches = 0  # main path starts here
        answers, wall = _burst(port, bodies, traced)
        launches = top_k_streaming.launches  # main path ends here
        batches = planes._batcher.stats["batches"] - batches0
        check_plain(bodies, answers, "the traced burst")
        echoed = [a[2].get("X-PIO-Trace") == trace_of[j] for j, a in enumerate(answers)]
        if not all(echoed) or launches != batches or launches < 1:
            raise AssertionError(f"trace echoed {sum(echoed)}/{len(bodies)}; kernel 1 launched "
                                 f"{launches} times for {batches} batches")
        out["burst"] = {"queries": len(bodies), "launches": launches, "batches": batches,
                        **_latency(answers, wall)}
        # feedback: every answer's predict event read back once
        t = time.monotonic()
        _wait_for(lambda: planes.stats.count("feedback_sent") == len(warm) + len(bodies),
                  "the burst's feedback deliveries")
        stored = list(ev_registry.get_events().find(
            app_id, EventFilter(event_names=["predict"], limit=-1)))
        by_user = {}
        for ev in stored:
            by_user.setdefault(ev.properties.to_dict()["query"]["user"], []).append(ev)
        wrong = []
        for body, answer in zip(bodies, answers):
            evs = by_user.get(body["user"], [])
            if (len(evs) != 1 or len(evs[0].entity_id) != 64
                    or evs[0].properties.to_dict()["prediction"] != answer[1]
                    or evs[0].properties.to_dict()["variant"] != "baseline"):
                wrong.append(body["user"])
        pr_ids = {ev.entity_id for ev in stored}
        if wrong or len(stored) != len(warm) + len(bodies) or len(pr_ids) != len(stored):
            raise AssertionError(f"feedback: {len(stored)} events, {len(pr_ids)} prIds, "
                                 f"answers without exactly one event: {wrong[:5]}")
        out["feedback"] = {"events": len(stored), "distinct_prIds": len(pr_ids),
                           "burst_answers_read_back": len(bodies) - len(wrong),
                           "wait_s": time.monotonic() - t}
        # one query's trace: admission, batch and predict under one id
        tid = trace_of[7]
        _wait_for(lambda: any(s["name"] == "serving.feedback"
                              for s in planes.tracer.store.for_trace(tid)), "the feedback span")
        spans = [s for s in _get_json(port, "/traces.json")["spans"] if s["traceId"] == tid]
        ev_spans = [s for s in _get_json(events.bound_port, "/traces.json")["spans"]
                    if s["traceId"] == tid]
        names = {s["name"] for s in spans}
        need = {"POST /queries.json", "batch.queue-wait", "batch.device", "serving.feedback"}
        root = [s for s in spans if s["name"] == "POST /queries.json"]
        if (not need <= names or [s["name"] for s in ev_spans] != ["POST /events.json"]
                or any(s["parentId"] != root[0]["spanId"] for s in spans if s is not root[0])):
            raise AssertionError(f"trace {tid}: {sorted(names)}, event server {ev_spans}")
        out["trace"] = {"id": tid, "spans": {s["name"]: s["durationMs"] for s in spans},
                        "event_server_spans": [s["name"] for s in ev_spans]}
        # the health plane: no objective firing
        planes.health.tick()
        health_doc = _get_json(port, "/health.json")
        if health_doc["firing"] != 0:
            raise AssertionError(f"/health.json firing: {health_doc}")
        out["health"] = {"firing": health_doc["firing"],
                         "objectives": {o["name"]: [o["state"], o["abstaining"], o["burnFast"]]
                                        for o in health_doc["objectives"]},
                         "stalls": health_doc["stalls"], "alerts": len(load_alerts(ledger))}
        # 2. a 1 ms deadline sent while a burst holds the batcher
        t = time.monotonic()
        expired0 = planes.stats.count("deadline_expired")
        for attempt in range(3):
            with ThreadPoolExecutor(max_workers=len(bodies) + 1) as pool:
                held = [pool.submit(_plane_post, port, b) for b in bodies]
                late = pool.submit(_plane_post, port, {"user": bodies[0]["user"], "num": 10},
                                   {"X-PIO-Deadline-Ms": str(PLANE_SHORT_MS)})
                held = [f.result() for f in held]
                late = late.result()
            check_plain(bodies, held, "the held burst")
            if late[0] == 504:
                break
        metrics = _get_text(port, "/metrics")
        expired = planes.stats.count("deadline_expired") - expired0
        if (late[0] != 504 or late[1].get("stage") not in ("admission", "dispatch", "batch-wait")
                or expired != 1
                or f'pio_serving_events_total{{kind="deadline_expired"}} {expired0 + 1}'
                not in metrics):
            raise AssertionError(f"the 1 ms query: {late[:2]}, counted {expired}")
        out["deadline"] = {"status": late[0], "stage": late[1]["stage"], "attempts": attempt + 1,
                           "counted": expired, "answer_ms": late[3] * 1e3}
        seconds["feedback_trace_health_deadline"] = time.monotonic() - t

        # 3. a dead feedback target: the event-server breaker opens
        t = time.monotonic()
        with env_set({"PIO_BREAKER_FAILURES": str(PLANE_BREAKER_FAILURES)}):
            dead = create_query_server(engine_factory(), ServerConfig(
                ip="127.0.0.1", port=0, device=dev, feedback=True, event_server_ip="127.0.0.1",
                event_server_port=_free_port(), access_key="plane-key"),
                registry=registry, block=False)
        servers.append(dead)
        statuses = []
        for rnd in range(3):
            got, _ = _burst(dead.bound_port, bodies[:16])
            check_plain(bodies[:16], got, f"dead-target round {rnd}")
            statuses += [a[0] for a in got]
            _wait_for(lambda: sum(dead.stats.count(k) for k in (
                "feedback_failures", "feedback_skipped")) == len(statuses),
                "every delivery's outcome")
        metrics = _get_text(dead.bound_port, "/metrics")
        status = _get_json(dead.bound_port, "/status.json")
        if (statuses != [200] * len(statuses) or dead.feedback_breaker.state != "open"
                or 'pio_breaker_state{dep="event-server"} 2' not in metrics
                or not status["degraded"]):
            raise AssertionError(f"dead target: breaker {dead.feedback_breaker.snapshot()}, "
                                 f"degraded {status['degraded']}")
        out["breaker"] = {"queries": len(statuses), "answered_200": statuses.count(200),
                          "state": dead.feedback_breaker.state, "gauge": 2,
                          "opens": dead.feedback_breaker.open_count,
                          "failures": dead.stats.count("feedback_failures"),
                          "skipped": dead.stats.count("feedback_skipped"),
                          "retries": dead.stats.count("retries"),
                          "degraded": status["degraded"]}
        seconds["breaker"] = time.monotonic() - t
        # the process flight recorder, served on /blackbox.json, holds the open
        blackbox = _get_json(port, "/blackbox.json")
        opened = [e for e in blackbox["events"] if e["site"] == "breaker.event-server"
                  and (e.get("details") or {}).get("state") == "open"]
        if not blackbox["enabled"] or not opened:
            raise AssertionError(f"/blackbox.json lacks the breaker's open: {blackbox}")
        out["blackbox"] = {"enabled": blackbox["enabled"], "events": len(blackbox["events"]),
                           "breaker_opens": len(opened), "armed": os.path.basename(armed)}

        # 4. sharded serving: four shard servers in this process on the card
        t = time.monotonic()
        shards = []
        for i in range(PLANE_SHARDS):
            shards.append(create_query_server(engine_factory(), ServerConfig(
                ip="127.0.0.1", port=0, device=dev, shard_index=i, shard_count=PLANE_SHARDS),
                registry=registry, block=False))
            servers.append(shards[-1])
        shard_answers, shard_lines = [], []
        for i, shard in enumerate(shards):
            _burst(shard.bound_port, warm)  # its first batch
            batches0 = shard._batcher.stats["batches"]
            top_k_streaming.launches = 0  # main path starts here
            got, wall = _burst(shard.bound_port, bodies)
            launches_i = top_k_streaming.launches  # main path ends here
            batches_i = shard._batcher.stats["batches"] - batches0
            if any(a[0] != 200 for a in got) or launches_i != batches_i or launches_i < 1:
                raise AssertionError(f"shard {i}: kernel 1 launched {launches_i} times for "
                                     f"{batches_i} batches")
            shard_answers.append(got)
            dep = shard.deployment
            su, si = dep.algorithms[0]._device_tables(dep.models[0])
            info = _get_json(shard.bound_port, "/shard.json")
            topk = _get_json(shard.bound_port, "/status.json").get("topkPath")
            # the shard's kernel against its plain version at the burst's shape
            idx = torch.tensor([dep.models[0].user_map[b["user"]] for b in bodies],
                               device=dev, dtype=torch.long)
            q = su[idx].contiguous()
            k = 64
            got_k = top_k_streaming(q, si, k)
            want_k = top_k_streaming_reference(q, si, k)
            err, ok = agreement(got_k, want_k)
            if (not ok or si.device != itf.device or info["models"][0]["items"] != si.shape[0]
                    or topk != {"0:ALSAlgorithm": "streaming"}):
                raise AssertionError(f"shard {i}: agreement {ok} ({err}), table on "
                                     f"{si.device}, {info}, {topk}")
            shard_lines.append({"index": i, "items": si.shape[0], "launches": launches_i,
                                "batches": batches_i, "max_abs_err": err,
                                "wrong_ids_outside_ties": wrong_outside_ties(got_k, want_k),
                                "kernel_device_ms": device_time(
                                    torch, lambda: top_k_streaming(q, si, k), ops_per_call=1)["ms"],
                                **_latency(got, wall)})
        # merged answers: equal to the unsharded server's (merged_matches_reference),
        # or, where a tie sits at the k-th place, equal to the plain version's
        # but for that tie
        idx = torch.tensor([int(b["user"][1:]) for b in bodies], device=dev, dtype=torch.long)
        q = uf[idx].contiguous()
        want_s, want_i = (t.cpu().numpy() for t in top_k_streaming_reference(q, itf, 64))
        strict, mismatched = 0, []
        for j, body in enumerate(bodies):
            merged = merge_predictions([sa[j][1] for sa in shard_answers], k=body["num"])
            if merged_matches_reference(merged, answers[j][1]):
                strict += 1
            elif not same_answer(merged["itemScores"], want_s[j], want_i[j], body["num"]):
                mismatched.append((body, merged["itemScores"][:3]))
        if mismatched:
            raise AssertionError(f"merged shard answers differ from the unsharded server's: "
                                 f"{mismatched[:3]}")
        # the kernel, its plain version and torch.topk, per call, on shard 0's
        # table and on the whole one at the burst's shape (B = 64, k = 64)
        s0 = shards[0].deployment
        su0, si0 = s0.algorithms[0]._device_tables(s0.models[0])
        q0 = su0[idx].contiguous()
        timed_calls = {}
        for name, table, qq in (("shard", si0, q0), ("unsharded", itf, q)):
            timed_calls[name] = {
                "kernel_ms": time_ms(torch, lambda: top_k_streaming(qq, table, 64)),
                "plain_ms": time_ms(torch, lambda: top_k_streaming_reference(qq, table, 64),
                                    iters=10),
                "library_ms": time_ms(torch, lambda: torch.topk(qq @ table.T, 64, dim=1)),
                "library_device_ms": device_time(
                    torch, lambda: torch.topk(qq @ table.T, 64, dim=1))["ms"]}
        out["shards"] = {"count": PLANE_SHARDS, "merged_matches_reference": strict,
                         "timed": timed_calls,
                         "merged_equal_but_for_ties": len(bodies),
                         "per_shard": shard_lines,
                         "unsharded_kernel_device_ms": device_time(
                             torch, lambda: top_k_streaming(q, itf, 64), ops_per_call=1)["ms"],
                         "shard_bound_ms": topk_bound(len(bodies), shard_lines[0]["items"],
                                                      model.rank, 64)[0],
                         "unsharded_bound_ms": topk_bound(len(bodies), n_items, model.rank, 64)[0]}
        seconds["shards"] = time.monotonic() - t

        # 5. overhead: the same burst with the planes on and off, A B B A
        t = time.monotonic()
        plain_server = create_query_server(engine_factory(), ServerConfig(
            ip="127.0.0.1", port=0, device=dev), registry=registry, block=False)
        servers.append(plain_server)
        _burst(plain_server.bound_port, warm)
        rounds = []
        for which in PLANE_ROUNDS:
            srv, hdr = (planes, traced) if which == "on" else (plain_server, lambda j: None)
            got, wall = _burst(srv.bound_port, bodies, hdr)
            check_plain(bodies, got, f"overhead round {which}")
            rounds.append({"planes": which, **_latency(got, wall)})
        out["overhead"] = rounds
        # every answered query's feedback delivered before the Event Server closes
        _wait_for(lambda: planes.stats.count("feedback_sent") == planes.stats.request_count,
                  "the planes server's last deliveries")
        out["feedback"]["delivered_in_phase"] = planes.stats.count("feedback_sent")
        seconds["overhead"] = time.monotonic() - t
    finally:
        for server in reversed(servers):
            server.shutdown()
            server.server_close()
    # 6. a killed server leaves its flight dump
    t = time.monotonic()
    out["killed"] = plane_killed_server(torch, os.path.join(plane_dir, "killed"), str(dev))
    seconds["killed"] = time.monotonic() - t
    out["seconds"] = {**seconds, "phase": time.monotonic() - t_phase}
    out["launches"] = out["burst"]["launches"] + sum(s["launches"]
                                                    for s in out["shards"]["per_shard"])
    emit(out)
    return out


#: the rollout phase: the candidate's training seed, the gate holds (s: a
#: stage's bursts must end inside its hold; SHADOW's took 6.3 s on a busy
#: host), the canary share (%), the canary bursts of 64, the shadow-cost
#: rounds (A B B A) and the gates: min_samples a shadow check burst meets; the
#: divergence and p99 gates opened wide, since the candidate is a healthy
#: model of another seed (its answers differ by design, and its shadow
#: duplicates wait in a pool of two)
ROLLOUT_CAND_SEED, ROLLOUT_HOLD_S, ROLLOUT_PERCENT, ROLLOUT_CANARY_BURSTS = 1, 10.0, 10.0, 4
ROLLOUT_ROUNDS = ("off", "shadow", "shadow", "off")
ROLLOUT_GATES = {"window_s": 600.0, "min_samples": 32, "shadow_hold_s": ROLLOUT_HOLD_S,
                 "canary_hold_s": ROLLOUT_HOLD_S, "max_divergence": 1.0,
                 "max_p99_latency_ratio": 50.0}
ROLLOUT_SICK_GATES = dict(ROLLOUT_GATES, canary_hold_s=3600.0)
ROLLOUT_SHADOW_HALF = 32  # the shadow check's two bursts: at the pending cap, nothing dropped
ROLLOUT_DIVERGENCE_ATOL = 1e-4


def _answer_matches(items_scores, want_s, want_i, num: int, n_items: int) -> bool:
    """A served ``itemScores`` list against a plain top-k row: the same
    items but for ties, scores to RTOL/ATOL."""
    k = min(num, n_items)
    if len(items_scores) != k:
        return False
    got_s = np.array([x["score"] for x in items_scores], dtype=np.float32)
    got_i = np.array([int(x["item"][1:]) for x in items_scores])
    close = np.isclose(got_s, want_s[:k], rtol=RTOL, atol=ATOL)
    return bool(close.all() and ((got_i == want_i[:k]) | close).all())


def phase_rollout(torch, dev, seed: int, data: dict, registry, instance_id: str, base: str,
                  smi: str) -> dict:
    """Shadow, canary and gated promotion between two ALS models resident
    on the card behind one query server (see the module docstring, 7c)."""
    from predictionio_tpu_torch.api.event_server import EventServerConfig, create_event_server
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models.recommendation import engine_factory
    from predictionio_tpu_torch.obs.quality import QualityConfig, load_snapshots
    from predictionio_tpu_torch.ops.cuda_kernels import (
        gramian_fused,
        spd_solve,
        top_k_streaming,
        top_k_streaming_reference,
    )
    from predictionio_tpu_torch.rollout.plan import prediction_divergence, variant_for_key
    from predictionio_tpu_torch.storage import EventFilter, StorageRegistry
    from predictionio_tpu_torch.storage.metadata import (
        ROLLOUT_CANARY,
        ROLLOUT_LIVE,
        ROLLOUT_ROLLED_BACK,
        ROLLOUT_SHADOW,
        AccessKey,
        App,
    )
    from predictionio_tpu_torch.testing import faults
    from predictionio_tpu_torch.tools import console
    from predictionio_tpu_torch.workflow import (
        ServerConfig,
        WorkflowContext,
        create_query_server,
        load_models,
        persist_instance,
        run_train,
    )

    t_phase = time.monotonic()
    seconds = {}
    rng = np.random.default_rng(seed + 26)
    ro_dir = os.path.join(base, "rollout")
    ro_reg = StorageRegistry({"PIO_FS_BASEDIR": os.path.join(ro_dir, "store")})
    snapshots = os.path.join(ro_dir, "quality.jsonl")
    out = {"phase": "rollout", "card": smi}

    # the baseline: the train phase's instance; the candidate: run_train of
    # the same data and params with another seed, on kernels 2 and 3
    t = time.monotonic()
    engine, params = als_smoke_engine(data)
    (base_model,) = load_models(registry, instance_id)
    base_id = persist_instance(ro_reg, EngineParams(algorithm_params_list=[("als", params)]),
                               [base_model])
    cand_params = dataclasses.replace(params, seed=ROLLOUT_CAND_SEED)
    gramian_fused.launches = spd_solve.launches = 0  # the candidate's training starts here
    cand_id = run_train(engine, EngineParams(algorithm_params_list=[("als", cand_params)]),
                        ro_reg, ctx=WorkflowContext(device=dev))
    train_launches = {"gramian_fused": gramian_fused.launches,
                      "spd_solve": spd_solve.launches}  # and ends here
    if min(train_launches.values()) < TRAIN_ITERS:
        raise AssertionError(f"the candidate's run_train launched {train_launches}")
    (cand_model,) = load_models(ro_reg, cand_id)
    seconds["candidate_train"] = time.monotonic() - t
    n_users, n_items = base_model.user_factors.shape[0], base_model.item_factors.shape[0]
    tables = {name: (torch.from_numpy(m.user_factors).to(dev),
                     torch.from_numpy(m.item_factors).to(dev))
              for name, m in (("baseline", base_model), ("candidate", cand_model))}
    out.update(users=n_users, items=n_items, rank=base_model.rank,
               baseline=base_id, candidate=cand_id, candidate_train_launches=train_launches)

    def plain(bodies, model):
        uf, itf = tables[model]
        idx = torch.tensor([int(b["user"][1:]) for b in bodies], device=dev, dtype=torch.long)
        return tuple(t.cpu().numpy() for t in top_k_streaming_reference(
            uf[idx].contiguous(), itf, max(b["num"] for b in bodies)))

    def check(bodies, answers, what, served_by):
        """Every answer 200, its ``X-PIO-Variant`` one of the ``|``-separated
        variants of ``served_by(j)``, and equal to that model's plain answer."""
        want = {m: plain(bodies, m) for m in ("baseline", "candidate")}
        bad = []
        for j, (body, a) in enumerate(zip(bodies, answers)):
            variant, model = served_by(j)
            if a[0] != 200 or a[2].get("X-PIO-Variant") not in variant.split("|") or not _answer_matches(
                    a[1]["itemScores"], want[model][0][j], want[model][1][j], body["num"],
                    n_items):
                bad.append((body, a[0], a[2].get("X-PIO-Variant"), variant, model))
        if bad:
            raise AssertionError(f"{what}: {len(bad)} answers wrong: {bad[:3]}")
        return want

    users = iter(rng.permutation(n_users))

    def bodies_of(n):
        return [{"user": f"u{next(users)}", "num": 1 + int(rng.integers(0, 50))}
                for _ in range(n)]

    served = {}  # user → (variant, instance) of every rollout-server answer

    def note(bodies, answers):
        for b, a in zip(bodies, answers):
            v = a[2].get("X-PIO-Variant")
            served[b["user"]] = (v, cand_id if v == "candidate" or stage_live[0] else base_id)

    stage_live = [False]
    servers = []
    with env_set({"PIO_QUALITY_SNAPSHOTS": snapshots}):
        try:
            ev_reg = StorageRegistry({"PIO_FS_BASEDIR": os.path.join(ro_dir, "events")})
            md = ev_reg.get_metadata()
            fb_app = md.app_insert(App(id=0, name="rollout"))
            md.access_key_insert(AccessKey(key="rollout-key", appid=fb_app))
            ingest_app = md.app_insert(App(id=0, name="ingest"))
            md.access_key_insert(AccessKey(key="ingest-key", appid=ingest_app))
            for app in (fb_app, ingest_app):
                ev_reg.get_events().init(app)
            events = create_event_server(EventServerConfig(
                ip="127.0.0.1", port=0, quality_dir=os.path.join(ro_dir, "ingest")),
                registry=ev_reg, block=False)
            servers.append(events)
            t = time.monotonic()
            srv = create_query_server(engine_factory(), ServerConfig(
                ip="127.0.0.1", port=0, device=dev, engine_instance_id=base_id, feedback=True,
                event_server_ip="127.0.0.1", event_server_port=events.bound_port,
                access_key="rollout-key",
                quality=QualityConfig(pin_min_samples=200, min_psi_samples=100)),
                registry=ro_reg, block=False)
            servers.append(srv)
            plain_srv = create_query_server(engine_factory(), ServerConfig(
                ip="127.0.0.1", port=0, device=dev, engine_instance_id=base_id),
                registry=ro_reg, block=False)
            servers.append(plain_srv)
            port, rollout = srv.bound_port, srv.rollout
            for s in (srv, plain_srv):
                warm = bodies_of(8)
                got, _ = _burst(s.bound_port, warm)
                check(warm, got, "warm-up", lambda j: ("-", "baseline"))
                if s is srv:
                    note(warm, got)
            seconds["deploy"] = time.monotonic() - t

            def batches():
                return srv._batcher.stats["batches"], rollout.candidate_batches

            def stage_line(name, bodies_n, launches, before, wall_answers):
                b0, c0 = before
                b1, c1 = batches()
                line = {"queries": bodies_n, "launches": launches, "baseline_batches": b1 - b0,
                        "candidate_batches": c1 - c0}
                if launches != line["baseline_batches"] + line["candidate_batches"]:
                    raise AssertionError(f"{name}: kernel 1 launched {launches} times for "
                                         f"{line['baseline_batches']} baseline and "
                                         f"{line['candidate_batches']} candidate batches")
                if wall_answers is not None:
                    line.update(_latency(*wall_answers))
                return line

            def div_hist():
                text = _get_text(port, "/metrics")
                get = lambda name: float(re.search(rf"^{name} (\S+)$", text, re.M).group(1))  # noqa: E731
                return get("pio_rollout_divergence_count"), get("pio_rollout_divergence_sum")

            # 1. SHADOW: the candidate resident beside the baseline
            t = time.monotonic()
            started = rollout.start(candidate_instance_id=cand_id, percent=ROLLOUT_PERCENT,
                                    gates=ROLLOUT_GATES)
            t_stage = time.monotonic()
            salt = started["plan"]["salt"]
            count0, sum0 = 0.0, 0.0  # the server's first rollout: nothing observed yet
            before = batches()
            shadow_bodies, shadow_answers, wall = [], [], 0.0
            top_k_streaming.launches = 0  # the shadow stage starts here
            for _half in range(2):
                bodies = bodies_of(ROLLOUT_SHADOW_HALF)
                got, w = _burst(port, bodies)
                rollout.drain_shadow()
                shadow_bodies += bodies
                shadow_answers += got
                wall += w
            launches = top_k_streaming.launches  # and ends here
            out["shadow"] = stage_line("shadow", len(shadow_bodies), launches, before,
                                       (shadow_answers, wall))
            want = check(shadow_bodies, shadow_answers, "SHADOW", lambda j: ("baseline",
                                                                              "baseline"))
            note(shadow_bodies, shadow_answers)
            status = rollout.status()
            count1, sum1 = div_hist()
            host = [prediction_divergence(
                {"itemScores": [{"item": f"i{i}", "score": float(s)} for s, i in zip(
                    want["baseline"][0][j][:min(b["num"], n_items)],
                    want["baseline"][1][j][:min(b["num"], n_items)])]},
                {"itemScores": [{"item": f"i{i}", "score": float(s)} for s, i in zip(
                    want["candidate"][0][j][:min(b["num"], n_items)],
                    want["candidate"][1][j][:min(b["num"], n_items)])]})
                for j, b in enumerate(shadow_bodies)]
            measured = (sum1 - sum0) / max(1.0, count1 - count0)
            if (rollout.stage != ROLLOUT_SHADOW or status["shadow"]["ok"] != len(shadow_bodies)
                    or status["shadow"]["errors"] or status["shadow"]["dropped"]
                    or count1 - count0 != len(shadow_bodies)
                    or out["shadow"]["candidate_batches"] < 1
                    or abs(measured - float(np.mean(host))) > ROLLOUT_DIVERGENCE_ATOL):
                raise AssertionError(f"SHADOW: stage {rollout.stage}, shadow {status['shadow']}, "
                                     f"divergence samples {count1 - count0}, mean {measured} "
                                     f"against the host's {np.mean(host)}")
            out["shadow"].update(duplicates=status["shadow"], divergence_samples=count1 - count0,
                                 mean_divergence=measured, host_mean_divergence=float(
                                     np.mean(host)))
            # the shadow's cost: the baseline's latency with a rollout in
            # SHADOW (this server) and with none (the plain one), A B B A
            rounds = []
            for which in ROLLOUT_ROUNDS:
                s = srv if which == "shadow" else plain_srv
                bodies = bodies_of(HTTP_QUERIES)
                got, w = _burst(s.bound_port, bodies)
                check(bodies, got, f"cost round {which}",
                      lambda j, v=("baseline" if which == "shadow" else "-"): (v, "baseline"))
                if s is srv:
                    note(bodies, got)
                    rollout.drain_shadow()
                rounds.append({"rollout": which, **_latency(got, wall=w)})
            out["shadow_cost"] = rounds
            if rollout.stage != ROLLOUT_SHADOW:
                raise AssertionError(f"the shadow hold ({ROLLOUT_HOLD_S} s) ran out during the "
                                     f"stage: {rollout.stage} after "
                                     f"{time.monotonic() - t_stage:.2f} s")
            seconds["shadow"] = time.monotonic() - t

            # 2. CANARY at 10 %: the first request after the hold promotes
            t = time.monotonic()
            time.sleep(max(0.0, ROLLOUT_HOLD_S - (time.monotonic() - t_stage)) + 0.05)
            trigger = bodies_of(1)
            got, _ = _burst(port, trigger)
            check(trigger, got, "the shadow stage's last query", lambda j: ("baseline",
                                                                             "baseline"))
            note(trigger, got)
            if rollout.stage != ROLLOUT_CANARY:
                raise AssertionError(f"no promotion to CANARY: {rollout.status()}")
            t_stage = time.monotonic()
            canary_bodies, canary_answers, wall = [], [], 0.0
            before = batches()
            top_k_streaming.launches = 0  # the canary stage starts here
            for _burst_i in range(ROLLOUT_CANARY_BURSTS):
                bodies = bodies_of(HTTP_QUERIES)
                got, w = _burst(port, bodies)
                canary_bodies += bodies
                canary_answers += got
                wall += w
            launches = top_k_streaming.launches  # and ends here
            out["canary"] = stage_line("canary", len(canary_bodies), launches, before,
                                       (canary_answers, wall))
            expect = [variant_for_key(salt, f"user={b['user']}", ROLLOUT_PERCENT)
                      for b in canary_bodies]
            check(canary_bodies, canary_answers, "CANARY", lambda j: (expect[j], expect[j]))
            note(canary_bodies, canary_answers)
            n = len(canary_bodies)
            share = expect.count("candidate")
            mean, sigma = n * ROLLOUT_PERCENT / 100, (n * 0.1 * 0.9) ** 0.5
            if rollout.stage != ROLLOUT_CANARY or abs(share - mean) > 4 * sigma:
                raise AssertionError(f"CANARY: stage {rollout.stage}, the candidate served "
                                     f"{share} of {n} (band {mean} ± {4 * sigma})")
            out["canary"].update(candidate_answers=share, band=[mean - 4 * sigma,
                                                                mean + 4 * sigma])
            # quality: both variants' score PSI exported, read by `pio quality --node`
            metrics = _get_text(port, "/metrics")
            psi_lines = dict(re.findall(r'^pio_quality_score_psi\{variant="(\w+)"\} (\S+)$',
                                        metrics, re.M))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                code = console.main(["quality", "--node", f"127.0.0.1:{port}", "--json"])
            node = json.loads(buf.getvalue())
            if (code != 0 or set(psi_lines) != {"baseline", "candidate"}
                    or min(float(v) for v in psi_lines.values()) < 0
                    or set(node.get("scorePsi", {})) != {"baseline", "candidate"}):
                raise AssertionError(f"score PSI: /metrics {psi_lines}, pio quality {node}")
            out["quality"] = {"score_psi": {k: float(v) for k, v in psi_lines.items()},
                              "pio_quality_node": node}
            seconds["canary"] = time.monotonic() - t

            # 3. LIVE: after the canary hold the next request promotes
            t = time.monotonic()
            time.sleep(max(0.0, ROLLOUT_HOLD_S - (time.monotonic() - t_stage)) + 0.05)
            trigger = bodies_of(1)
            got, _ = _burst(port, trigger)
            v = variant_for_key(salt, f"user={trigger[0]['user']}", ROLLOUT_PERCENT)
            check(trigger, got, "the canary stage's last query", lambda j: (v, v))
            note(trigger, got)
            stored = ro_reg.get_metadata().rollout_plan_get_all()[0]
            history = [h["stage"] for h in stored.history]
            if (rollout.stage != ROLLOUT_LIVE or srv.deployment.instance.id != cand_id
                    or history != [ROLLOUT_SHADOW, ROLLOUT_CANARY, ROLLOUT_LIVE]):
                raise AssertionError(f"LIVE: stage {rollout.stage}, deployment "
                                     f"{srv.deployment.instance.id}, stored history {history}")
            stage_live[0] = True
            before = batches()
            top_k_streaming.launches = 0  # the live stage starts here
            bodies = bodies_of(HTTP_QUERIES)
            got, w = _burst(port, bodies)
            launches = top_k_streaming.launches  # and ends here
            out["live"] = stage_line("live", len(bodies), launches, before, (got, w))
            check(bodies, got, "LIVE", lambda j: ("-", "candidate"))
            note(bodies, got)
            if out["live"]["candidate_batches"] != 0:
                raise AssertionError("the retired candidate batcher still dispatched")
            # a fresh server on the same store serves the candidate, no rollout active
            fresh = create_query_server(engine_factory(), ServerConfig(
                ip="127.0.0.1", port=0, device=dev), registry=ro_reg, block=False)
            servers.append(fresh)
            probe = bodies_of(8)
            got, _ = _burst(fresh.bound_port, probe)
            check(probe, got, "the fresh server", lambda j: ("-", "candidate"))
            fresh_status = _get_json(fresh.bound_port, "/status.json")
            if (fresh.deployment.instance.id != cand_id or fresh.rollout.active
                    or fresh_status.get("topkPath") != {"0:ALSAlgorithm": "streaming"}):
                raise AssertionError(f"the fresh server: {fresh.deployment.instance.id}, "
                                     f"{fresh_status.get('rollout')}, {fresh_status.get('topkPath')}")
            out["live"].update(history=history, fresh_server=fresh.deployment.instance.id)
            seconds["live"] = time.monotonic() - t

            # 4. a sick candidate: its predict raises; rolled back, no client error
            t = time.monotonic()
            rollout.start(candidate_instance_id=base_id, percent=50.0, gates=ROLLOUT_SICK_GATES,
                          reason="sick candidate")
            rollout.promote("straight to canary")
            before = batches()
            sick_answers, statuses, wall = [], [], 0.0
            top_k_streaming.launches = 0  # the sick stage starts here
            with faults.inject(faults.FaultSpec(site="serving.candidate", kind="refuse")) as plan:
                for _round in range(4):
                    bodies = bodies_of(HTTP_QUERIES)
                    got, w = _burst(port, bodies)
                    # "baseline" while the plan is active (the candidate's
                    # queries served again from it), "-" once rolled back
                    check(bodies, got, "the sick canary", lambda j: ("baseline|-", "candidate"))
                    for b in bodies:  # every answer from the live model (the first candidate)
                        served[b["user"]] = ("baseline", cand_id)
                    statuses += [a[0] for a in got]
                    sick_answers += got
                    wall += w
                    if rollout.stage == ROLLOUT_ROLLED_BACK:
                        break
            launches = top_k_streaming.launches  # and ends here
            out["sick"] = stage_line("sick", len(statuses), launches, before,
                                     (sick_answers, wall))
            durable = ro_reg.get_metadata().rollout_plan_get_latest(
                stored.engine_id, stored.engine_version, stored.engine_variant)
            if (rollout.stage != ROLLOUT_ROLLED_BACK or durable.stage != ROLLOUT_ROLLED_BACK
                    or statuses != [200] * len(statuses) or plan.fired("serving.candidate") < 1
                    or "error-rate" not in durable.history[-1]["reason"]):
                raise AssertionError(f"the sick candidate: stage {rollout.stage}, stored "
                                     f"{durable.stage}, statuses {set(statuses)}")
            out["sick"].update(non_200=0, faults_fired=plan.fired("serving.candidate"),
                               reason=durable.history[-1]["reason"])
            seconds["sick"] = time.monotonic() - t

            # feedback: every predict event read back, tagged with its variant
            t = time.monotonic()
            _wait_for(lambda: srv.stats.count("feedback_sent") == srv.stats.request_count,
                      "the rollout server's feedback deliveries")
            stored_events = list(ev_reg.get_events().find(
                fb_app, EventFilter(event_names=["predict"], limit=-1)))
            wrong = []
            for ev in stored_events:
                props = ev.properties.to_dict()
                user = props["query"]["user"]
                if user in served and (props["variant"], props["engineInstanceId"]) != (
                        served[user][0].replace("-", "baseline"), served[user][1]):
                    wrong.append((user, props["variant"], served[user]))
            tagged = {}
            for ev in stored_events:
                v = ev.properties.to_dict()["variant"]
                tagged[v] = tagged.get(v, 0) + 1
            if wrong or len(stored_events) != srv.stats.request_count or not tagged.get(
                    "candidate"):
                raise AssertionError(f"feedback: {len(stored_events)} events for "
                                     f"{srv.stats.request_count} answers, mis-tagged {wrong[:3]}")
            out["feedback"] = {"events": len(stored_events), "by_variant": tagged}
            # ingest quality: a baseline mix pins, a skewed batch drifts it
            path = "/batches/events.json?accessKey=ingest-key"

            def ev_body(name, i):
                body = {"event": name, "entityType": "user", "entityId": f"u{i}"}
                if name == "rate":
                    body["properties"] = {"rating": float(1 + i % 5)}
                return body

            for i in range(0, 200, 50):
                _http(events.bound_port, "POST", path, [
                    ev_body("rate" if j % 4 else "view", j) for j in range(i, i + 50)])
            pinned = _get_text(events.bound_port, "/metrics")
            for i in range(0, 300, 50):
                _http(events.bound_port, "POST", path, [ev_body("buy", j) for j in range(i, i + 50)])
            skewed = _get_text(events.bound_port, "/metrics")
            series = re.escape(f'pio_quality_event_mix_psi{{app="{ingest_app}"}}')
            mix = [float(re.search(rf"^{series} (\S+)$", text, re.M).group(1))
                   for text in (pinned, skewed)]
            if not (0 <= mix[0] < 0.1 < 0.25 < mix[1]):
                raise AssertionError(f"pio_quality_event_mix_psi {mix}")
            snaps = [s["source"] for s in load_snapshots(snapshots)]
            if "baseline-pin" not in snaps or f"model-live:{cand_id}" not in snaps:
                raise AssertionError(f"quality snapshots: {snaps}")
            out["quality"].update(event_mix_psi={"pinned": mix[0], "skewed": mix[1]},
                                  snapshots=snaps)
            seconds["feedback_and_ingest"] = time.monotonic() - t
        finally:
            for server in reversed(servers):
                server.shutdown()
                server.server_close()
    out["launches"] = sum(out[s]["launches"] for s in ("shadow", "canary", "live", "sick"))
    out["seconds"] = {**seconds, "phase": time.monotonic() - t_phase}
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
    # above the tuned path: the resident wide-head path, picked by D alone
    wide = check(f"D{FLASH_MAX_D + 8}", 2, 4, 160, 200, FLASH_MAX_D + 8, True)
    if wide["plan"]["path"] != "resident":
        raise AssertionError(f"D = {FLASH_MAX_D + 8} did not take the resident path")
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
    gather's dtype) through the kernels against the plain versions. The
    plain iterations start from that plain first user solve, which is
    their first step (``als._train_loop``'s order), so it is made once."""
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
    plain = (gramian_fused_reference, spd_solve_reference)

    def side(table, staged, build, solve):
        return als._solve_side(table, staged, cfg.rank, cfg.implicit_prefs, cfg.lambda_,
                               cfg.alpha, table.T @ table if cfg.implicit_prefs else None,
                               cfg.gather_dtype, build, solve)

    first = [side(y0, ub, gramian_fused, spd_solve), side(y0, ub, *plain)]
    x, y = first[1], side(first[1], ib, *plain)
    if cfg.iterations > 1:
        rest = dataclasses.replace(cfg, iterations=cfg.iterations - 1)
        x, y = als._train_loop(ub, ib, y, rest, *plain)
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
        topk_launch_plan,
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
    by_stage1 = top_k_streaming.launches_by_stage1
    try:
        top_k_streaming.launches = 0  # main path starts here
        by_stage1.update(dict.fromkeys(by_stage1, 0))
        t = time.monotonic()
        status, data, _ = _post_query(server.bound_port, {"user": user, "num": PERSIST_NUM})
        seconds["num4096_query"] = time.monotonic() - t
        launches["num4096_query"] = top_k_streaming.launches  # main path ends here
        launches["num4096_select"] = by_stage1["select"]
    finally:
        server.shutdown()
        server.server_close()
    # the same query row on the card: the select path's answer, bit for bit
    # the per-tile sort's and a second call's, is the one served
    q_row = torch.from_numpy(model.user_factors).to(dev)[row].contiguous()
    table = torch.from_numpy(model.item_factors).to(dev)
    direct = top_k_streaming(q_row, table, PERSIST_NUM)
    again = top_k_streaming(q_row, table, PERSIST_NUM)
    per_tile = top_k_streaming(q_row, table, PERSIST_NUM, stage1="tile_sort")
    select_checks = {
        "stage1": topk_launch_plan(1, table.shape[0], PERSIST_NUM,
                                   torch.cuda.get_device_properties(dev).multi_processor_count,
                                   table.shape[1]).stage1,
        "select_launches": launches["num4096_select"],
        "equal_to_tile_sort": bool(torch.equal(direct[0], per_tile[0])
                                   and torch.equal(direct[1], per_tile[1])),
        "bit_identical": bool(torch.equal(direct[0], again[0]) and torch.equal(direct[1], again[1]))}
    del again, per_tile, table
    got = data.get("itemScores", []) if status == 200 else []
    inv = model.item_map.inverse
    got_s = np.array([x["score"] for x in got], dtype=np.float32)
    close = len(got) == PERSIST_NUM and np.isclose(got_s, want_s, rtol=RTOL, atol=ATOL)
    same = len(got) == PERSIST_NUM and np.array(
        [x["item"] == inv[int(i)] for x, i in zip(got, want_i)])
    wrong = PERSIST_NUM if len(got) != PERSIST_NUM else int((~(same | close)).sum())
    direct_s, direct_i = (x.cpu().numpy()[0] for x in direct)
    select_checks["served_equal_to_select"] = bool(
        len(got) == PERSIST_NUM and np.array_equal(got_s, direct_s)
        and all(x["item"] == inv[int(i)] for x, i in zip(got, direct_i)))
    checks["num4096"] = {"status": status, "items": len(got), "catalog": len(inv),
                         "wrong_ids_outside_ties": wrong,
                         "tied_slots": int((~same & close).sum()) if len(got) else 0,
                         "max_abs_err": float(np.abs(got_s - want_s).max()) if len(got) else None,
                         "launches": launches["num4096_query"], **select_checks}
    if (status != 200 or wrong or not np.all(close) or launches["num4096_query"] != 1
            or select_checks["stage1"] != "select" or launches["num4096_select"] != 1
            or not all(select_checks[c] for c in ("equal_to_tile_sort", "bit_identical",
                                                  "served_equal_to_select"))):
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


#: the templates phase: the similar-product and e-commerce templates over
#: ML-1M's users and items with 18 categories (ML-1M's genre count), each
#: item in 1-3 of them, in two apps of the events phase's native log; the
#: templates' variants (rank 10, 10 iterations; tools/templates.py)
TEMPLATE_CATEGORIES, SP_APP, EC_APP = 18, 3, 4
SP_VIEWS, SP_LIKES, EC_RATES, EC_VIEW_BUYS, EC_VISITORS = 250_000, 50_000, 250_000, 50_000, 200
TEMPLATE_RANK, TEMPLATE_ITERS = 10, 10
#: queries of a block of single, category and white-list queries, the
#: concurrent burst, the served num, the constrained batch timed
TEMPLATE_QUERIES, TEMPLATE_BURST, TEMPLATE_NUM, TEMPLATE_TIMED_B = 16, 64, 10, 64


def synth_template_events(seed: int) -> dict:
    """The two templates' stores from ``seed``: ``$set`` users ``u<n>``
    and items ``i<n>`` (categories ``g0``..``g17``, 1-3 an item), Zipf-like
    user and item activity; the similar-product app's ``view`` and
    ``like``/``dislike`` events (like with probability 0.8), the
    e-commerce app's ``rate`` events (a rank-8 latent model rounded to 1-5)
    and ``view``/``buy`` events (buy with probability 0.2), and visitors
    ``v<n>`` never ``$set`` who only view (the new users). Event times rise
    by one second an event."""
    import datetime as dt

    from predictionio_tpu_torch.storage import Event

    rng = np.random.default_rng(seed + 11)
    n_users, n_items = ML1M_USERS, ML1M_ITEMS
    n_cats = rng.integers(1, 4, n_items)
    cats = [sorted(rng.choice(TEMPLATE_CATEGORIES, size=c, replace=False).tolist())
            for c in n_cats]
    u_w = 1.0 / np.arange(1, n_users + 1) ** 0.8
    i_w = 1.0 / np.arange(1, n_items + 1) ** 0.9
    t0 = dt.datetime(2001, 1, 1, tzinfo=dt.timezone.utc)
    clock = [0]

    def at():
        clock[0] += 1
        return t0 + dt.timedelta(seconds=clock[0])

    def entities():
        return ([Event(event="$set", entity_type="user", entity_id=f"u{u}", properties={},
                       event_time=t0) for u in range(n_users)]
                + [Event(event="$set", entity_type="item", entity_id=f"i{i}",
                         properties={"categories": [f"g{c}" for c in cats[i]]},
                         event_time=t0) for i in range(n_items)])

    def pairs(n):
        return (rng.choice(n_users, size=n, p=u_w / u_w.sum()),
                rng.choice(n_items, size=n, p=i_w / i_w.sum()))

    def acts(names, users, items, props=None):
        return [Event(event=name, entity_type="user", entity_id=user,
                      target_entity_type="item", target_entity_id=f"i{i}",
                      properties={} if props is None else props[j], event_time=at())
                for j, (name, user, i) in enumerate(zip(names, users, items))]

    users, items = pairs(SP_VIEWS)
    sp_events = entities() + acts(["view"] * SP_VIEWS, [f"u{u}" for u in users], items)
    users, items = pairs(SP_LIKES)
    sp_events += acts(np.where(rng.random(SP_LIKES) < 0.8, "like", "dislike"),
                      [f"u{u}" for u in users], items)
    users, items = pairs(EC_RATES)
    x = rng.normal(size=(n_users, 8)) / np.sqrt(8)
    y = rng.normal(size=(n_items, 8)) / np.sqrt(8)
    ratings = np.clip(np.rint((x[users] * y[items]).sum(1) * 2 + 3.5
                              + rng.normal(0, 0.5, EC_RATES)), 1, 5)
    ec_events = entities() + acts(["rate"] * EC_RATES, [f"u{u}" for u in users], items,
                                  [{"rating": float(r)} for r in ratings])
    users, items = pairs(EC_VIEW_BUYS)
    ec_events += acts(np.where(rng.random(EC_VIEW_BUYS) < 0.2, "buy", "view"),
                      [f"u{u}" for u in users], items)
    visitors = [f"v{j}" for j in range(EC_VISITORS) for _ in range(int(3 + j % 10))]
    ec_events += acts(["view"] * len(visitors), visitors,
                      rng.choice(n_items, size=len(visitors), p=i_w / i_w.sum()))
    members = {f"g{c}": [i for i in range(n_items) if c in cats[i]]
               for c in range(TEMPLATE_CATEGORIES)}
    return {"sp": sp_events, "ec": ec_events, "members": members,
            "visitors": sorted(set(visitors)), "n_users": n_users, "n_items": n_items}


def answer_errors(got, want, tol: float) -> dict:
    """``got`` against ``want`` (lists of (item, score)): the largest
    score error, and the slots whose id differs while ``want``'s score
    there has no other slot within ``tol`` holding that id (a wrong id
    outside ties). A length mismatch counts every slot wrong."""
    if len(got) != len(want):
        return {"max_abs_err": float("inf"), "wrong": max(len(got), len(want)), "n": len(want)}
    ws = np.array([s for _, s in want], np.float64)
    gs = np.array([s for _, s in got], np.float64)
    wrong = 0
    for j, ((g, _), (w, _)) in enumerate(zip(got, want)):
        if g != w and g not in {want[t][0] for t in np.flatnonzero(np.abs(ws - ws[j]) <= tol)}:
            wrong += 1
    err = float(np.abs(gs - ws).max()) if len(ws) else 0.0
    return {"max_abs_err": err, "wrong": wrong + int(err > tol), "n": len(want)}


def zscore_tolerance(preds, num: int) -> float:
    """The 1e-5 score tolerance carried through the ensemble's z-score sum:
    a score moved by at most ε moves ``(s - mean) / std`` by at most
    ``ε (2 + max|z|) / std`` (std is 1-Lipschitz in the largest move), summed
    over the algorithms; ε itself where the serving sums raw scores
    (``num == 1``)."""
    if num == 1:
        return ATOL * len(preds)
    tol = 0.0
    for scores in preds:
        s = np.array(scores, np.float64)
        std = s.std() if s.size else 0.0
        if std > 0:
            tol += ATOL * (2 + np.abs(s - s.mean()).max() / std) / std
    return max(tol, ATOL)


def phase_templates(torch, dev, seed: int, base: str) -> dict:
    """The similar-product and e-commerce templates end to end on the card:
    both stores bulk-written into the events phase's
    native log, each template trained by ``run_train`` through its own
    DataSource (build and solve launches counted), deployed by
    ``create_query_server`` and queried over HTTP in blocks (top-k
    launches reset before each block and read after it; none may be 0),
    every answer held to the port's plain path on CPU copies of the same
    tables; live ``buy`` and ``unavailableItems`` events change the next
    e-commerce answer without a retrain; then one category-constrained
    batch timed beside the same batch unconstrained and beside
    ``torch.topk`` of the masked product."""
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models import ecommerce as ec
    from predictionio_tpu_torch.models import similarproduct as sp
    from predictionio_tpu_torch.ops.cuda_kernels import (
        gramian_fused,
        spd_solve,
        top_k_streaming,
        top_k_streaming_reference,
    )
    from predictionio_tpu_torch.ops.scoring import exclusion_matrix
    from predictionio_tpu_torch.storage import Event
    from predictionio_tpu_torch.utils.profiling import phases_from_env, profile_from_env
    from predictionio_tpu_torch.workflow import (
        ServerConfig,
        WorkflowContext,
        create_query_server,
        load_models,
        run_train,
    )

    t_phase = time.monotonic()
    rng = np.random.default_rng(seed + 12)
    seconds, launches, checks = {}, {}, {}
    t = time.monotonic()
    data = synth_template_events(seed)
    seconds["generate"] = time.monotonic() - t
    members = data["members"]
    n_items = data["n_items"]
    # the category nearest 10 % of the catalog: its queries exclude ~90 %
    cat = min(members, key=lambda c: abs(len(members[c]) - 0.1 * n_items))
    bad = []

    def train(registry, engine, ep, name):
        ctx = WorkflowContext(device=dev)
        ctx.profile = {}
        gramian_fused.launches = spd_solve.launches = 0  # main path starts here
        t = time.monotonic()
        instance = run_train(engine, ep, registry, engine_id=name, ctx=ctx)
        wall = time.monotonic() - t
        counts = {"gramian_fused": gramian_fused.launches,
                  "spd_solve": spd_solve.launches}  # main path ends here
        env = registry.get_metadata().engine_instance_get(instance).env
        engine_s = profile_from_env(env)["train_wall_s"]
        launches[f"{name}_train"] = counts
        seconds[f"{name}_run_train"] = wall
        if min(counts.values()) < 1:
            bad.append((name, counts))
        return instance, {"run_train_s": wall, **phases_from_env(env),
                          "engine_train_s": engine_s,
                          "model_store_insert_and_rows_s": wall - engine_s,
                          "host_prep_path": ctx.profile.get("host_prep_path")}

    def deploy(engine, registry, instance):
        return create_query_server(engine, ServerConfig(
            ip="127.0.0.1", port=0, device=dev, engine_instance_id=instance),
            registry=registry, block=False)

    def block(name, server, bodies, plain, concurrent=False):
        """POST ``bodies``; launches counted over the block alone; each
        answer against ``plain(body)`` -> (items and scores, tolerance)."""
        top_k_streaming.launches = 0  # main path starts here
        t = time.monotonic()
        if concurrent:
            with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
                answers = list(pool.map(lambda b: _post_query(server.bound_port, b), bodies))
        else:
            answers = [_post_query(server.bound_port, b) for b in bodies]
        wall = time.monotonic() - t
        launches[name] = top_k_streaming.launches  # main path ends here
        errs, empty, tols = [], 0, []
        for body, (status, out, _) in zip(bodies, answers):
            if status != 200:
                bad.append((name, body, status, out))
                continue
            got = [(x["item"], x["score"]) for x in out["itemScores"]]
            want, tol = plain(body)
            tols.append(tol)
            e = answer_errors(got, want, tol)
            errs.append(e)
            empty += not got
            if e["wrong"]:
                bad.append((name, body, got[:4], want[:4], e))
        checks[name] = {"queries": len(bodies), "seconds": wall, "launches": launches[name],
                        "wrong": sum(e["wrong"] for e in errs), "empty_answers": empty,
                        "max_abs_err": max((e["max_abs_err"] for e in errs), default=0.0),
                        "max_tolerance": max(tols, default=ATOL)}
        if launches[name] < 1:
            bad.append((name, "no top-k launch"))
        return answers

    with events_store(base) as registry:
        store = registry.get_events()
        t = time.monotonic()
        for app, key in ((SP_APP, "sp"), (EC_APP, "ec")):
            store.init(app)
            for j in range(0, len(data[key]), EVENTS_WRITE_CHUNK):
                store.write(data[key][j:j + EVENTS_WRITE_CHUNK], app)
        seconds["bulk_write"] = time.monotonic() - t

        # -- similar product: als (views) and likealgo (like/dislike) -------
        params = dict(rank=TEMPLATE_RANK, num_iterations=TEMPLATE_ITERS)
        sp_ep = EngineParams(
            data_source_params=("", sp.SimilarProductDataSourceParams(app_id=SP_APP)),
            algorithm_params_list=[("als", sp.SimilarALSParams(**params)),
                                   ("likealgo", sp.SimilarALSParams(**params))])
        sp_instance, sp_split = train(registry, sp.engine_factory(), sp_ep, "similarproduct")
        sp_models = load_models(registry, sp_instance)
        plain_algos = [sp.SimilarALSAlgorithm(sp.SimilarALSParams(**params), device="cpu"),
                       sp.LikeAlgorithm(sp.SimilarALSParams(**params), device="cpu")]
        serving = sp.SimilarProductServing()

        def sp_plain(body):
            q = sp.Query(**body)
            preds = [a.predict(m, q) for a, m in zip(plain_algos, sp_models)]
            want = serving.serve(q, preds)
            tol = zscore_tolerance([[s.score for s in p.item_scores] for p in preds], q.num)
            return [(s.item, s.score) for s in want.item_scores], tol

        def sp_body(n_query=None, **kw):
            n_query = n_query or int(rng.integers(1, 6))
            items = [f"i{i}" for i in rng.choice(n_items, size=n_query, replace=False)]
            return {"items": items, "num": TEMPLATE_NUM, **kw}

        def black():
            return [f"i{i}" for i in rng.choice(n_items, size=int(rng.integers(1, 20)),
                                                 replace=False)]

        def white():
            return [f"i{i}" for i in rng.choice(n_items, size=int(rng.integers(20, 200)),
                                                 replace=False)]

        server = deploy(sp.engine_factory(), registry, sp_instance)
        try:
            t = time.monotonic()
            singles = [sp_body(black_list=black()) for _ in range(TEMPLATE_QUERIES)]
            category = [sp_body(categories=[cat]) for _ in range(TEMPLATE_QUERIES)]
            whites = [sp_body(white_list=white(), black_list=black())
                      for _ in range(TEMPLATE_QUERIES)]
            burst = [sp_body(**([{"categories": [cat]}, {"black_list": black()},
                                 {"white_list": white()}][j % 3]))
                     for j in range(TEMPLATE_BURST)]
            block("sp_single", server, singles, sp_plain)
            block("sp_category", server, category, sp_plain)
            block("sp_white_list", server, whites, sp_plain)
            block("sp_burst", server, burst, sp_plain, concurrent=True)
            seconds["sp_serve"] = time.monotonic() - t
            # each algorithm on the card alone, against its plain version
            # at the score tolerance (the served answers are z-score sums)
            prof = device_profile(torch, lambda: block("sp_burst_profiled", server, burst,
                                                       sp_plain, concurrent=True), top=3)
            checks["sp_burst_profiled"].update(
                device_busy_share=prof["device_busy_share"], wall_ms=prof["wall_ms"],
                top_device_ops=prof["top_device_ops"])
            dep = server.deployment
            queries = [(j, sp.Query(**b)) for j, b in enumerate(
                singles + category + whites + burst)]
            per_algo = {}
            for name, algo, model, plain_algo, cpu_model in zip(
                    ("als", "likealgo"), dep.algorithms, dep.models, plain_algos, sp_models):
                got = dict(algo.batch_predict(model, queries))
                want = dict(plain_algo.batch_predict(cpu_model, queries))
                errs = [answer_errors([(s.item, s.score) for s in got[j].item_scores],
                                      [(s.item, s.score) for s in want[j].item_scores], ATOL)
                        for j, _ in queries]
                per_algo[name] = {"queries": len(queries),
                                  "wrong": sum(e["wrong"] for e in errs),
                                  "max_abs_err": max(e["max_abs_err"] for e in errs),
                                  "topk_path": algo.topk_path}
                if per_algo[name]["wrong"] or algo.topk_path != "streaming":
                    bad.append(("sp_per_algorithm", name, per_algo[name]))
            checks["sp_per_algorithm"] = per_algo
            status = _get_json(server.bound_port, "/status.json")
            checks["sp_topk_path"] = status.get("topkPath")

            # -- the constrained batch, timed: kernel 1 with the category's
            # exclusion lists, without them, and torch.topk of the masked product
            unit = dep.algorithms[0]._device_unit(dep.models[0])
            model = dep.models[0]
            q_rows = rng.choice(n_items, size=TEMPLATE_TIMED_B, replace=False)
            qvecs = unit[torch.from_numpy(q_rows).to(dev)].contiguous()
            excl_c = torch.from_numpy(exclusion_matrix([sp._exclusions(
                model, sp.Query(items=(f"i{i}",), categories=(cat,)), [int(i)])
                for i in q_rows])).to(dev)
            excl_u = torch.from_numpy(exclusion_matrix([[int(i)] for i in q_rows])).to(dev)
            mask = torch.zeros((TEMPLATE_TIMED_B, n_items), dtype=torch.bool, device=dev)
            rows = torch.arange(TEMPLATE_TIMED_B, device=dev)[:, None].expand_as(excl_c)
            hit = excl_c >= 0
            mask[rows[hit], excl_c[hit].long()] = True
            k = 16
            calls = {
                "constrained": lambda: top_k_streaming(qvecs, unit, k, excl_c),
                "unconstrained": lambda: top_k_streaming(qvecs, unit, k, excl_u),
                "library": lambda: torch.topk(
                    (qvecs @ unit.T).masked_fill_(mask, float("-inf")), k),
            }
            err, ok = agreement(calls["constrained"](),
                                top_k_streaming_reference(qvecs, unit, k, excl_c))
            lib_s, lib_i = calls["library"]()
            lib_err, lib_ok = agreement(calls["constrained"](), (lib_s, lib_i.int()))
            runs = {name: [] for name in calls}
            for name in ("constrained", "unconstrained", "library", "library",
                         "unconstrained", "constrained"):
                runs[name].append(time_ms(torch, calls[name], iters=200, warmup=10))
            device_ms = {name: device_time(torch, fn, iters=50, ops_per_call=1)["ms"]
                         for name, fn in calls.items()}
            plain_ms = time_ms(torch, lambda: top_k_streaming_reference(qvecs, unit, k, excl_c),
                               iters=20)
            widths = (excl_c >= 0).sum(1).float()
            bound_ms, bound_by = topk_bound(TEMPLATE_TIMED_B, n_items, TEMPLATE_RANK, k,
                                            int(excl_c.shape[1]))
            checks["constrained_batch"] = {
                "B": TEMPLATE_TIMED_B, "N": n_items, "R": TEMPLATE_RANK, "k": k,
                "category": cat, "category_items": len(members[cat]),
                "E_padded": int(excl_c.shape[1]), "E_mean": float(widths.mean()),
                "E_max": int(widths.max()), "max_abs_err": err, "agrees_with_plain": ok,
                "library_max_abs_err": lib_err, "agrees_with_library": lib_ok,
                "order": "constrained, unconstrained, library, library, unconstrained, "
                         "constrained",
                "runs_ms": runs, "ms": {n: sum(v) / len(v) for n, v in runs.items()},
                "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}
            if not (ok and lib_ok):
                bad.append(("constrained_batch", err, lib_err))
        finally:
            server.shutdown()
            server.server_close()

        # -- e-commerce: explicit ALS on rate events, live filters ----------
        ec_params = ec.ECommerceALSParams(app_id=EC_APP, **params)
        ec_ep = EngineParams(
            data_source_params=("", ec.ECommerceDataSourceParams(app_id=EC_APP)),
            algorithm_params_list=[("als", ec_params)])
        ec_instance, ec_split = train(registry, ec.engine_factory(), ec_ep, "ecommerce")
        (ec_model,) = load_models(registry, ec_instance)
        ec_plain_algo = ec.ECommerceALSAlgorithm(ec_params, device="cpu")

        def ec_plain(body):
            want = ec_plain_algo.predict(ec_model, ec.Query(**body))
            return [(s.item, s.score) for s in want.item_scores], ATOL

        def users(n):
            return [f"u{u}" for u in rng.choice(data["n_users"], size=n, replace=False)]

        server = deploy(ec.engine_factory(), registry, ec_instance)
        try:
            t = time.monotonic()
            known = [{"user": u, "num": TEMPLATE_NUM} for u in users(TEMPLATE_QUERIES)]
            new = [{"user": v, "num": TEMPLATE_NUM}
                   for v in rng.choice(data["visitors"], size=TEMPLATE_QUERIES, replace=False)]
            filtered = [{"user": u, "num": TEMPLATE_NUM,
                         **([{"categories": [cat]}, {"white_list": white()}][j % 2])}
                        for j, u in enumerate(users(TEMPLATE_QUERIES // 2)
                                              + [str(v) for v in rng.choice(
                                                  data["visitors"], TEMPLATE_QUERIES // 2)])]
            burst = [{"user": u, "num": TEMPLATE_NUM, **({"black_list": black()} if j % 2
                                                          else {})}
                     for j, u in enumerate(users(TEMPLATE_BURST - 8)
                                           + [str(v) for v in data["visitors"][:8]])]
            answers = block("ec_known", server, known, ec_plain)
            block("ec_new_users", server, new, ec_plain)
            block("ec_filtered", server, filtered, ec_plain)
            block("ec_burst", server, burst, ec_plain, concurrent=True)
            seconds["ec_serve"] = time.monotonic() - t
            prof = device_profile(torch, lambda: block("ec_burst_profiled", server, burst,
                                                       ec_plain, concurrent=True), top=3)
            checks["ec_burst_profiled"].update(
                device_busy_share=prof["device_busy_share"], wall_ms=prof["wall_ms"],
                top_device_ops=prof["top_device_ops"])
            # a query's live reads on the host, each timed alone (ms a read)
            algo = server.deployment.algorithms[0]
            sample = [b["user"] for b in known[:8]]
            live = {}
            for name, read, who in (
                    ("seen_items", algo._seen_items, sample),
                    ("unavailable_items", lambda _u: algo._unavailable_items(), sample),
                    ("recent_views", algo._recent_view_items, [b["user"] for b in new[:8]])):
                t0 = time.monotonic()
                for u in who:
                    read(u)
                live[f"{name}_ms"] = (time.monotonic() - t0) / len(who) * 1e3
            checks["ec_live_read_ms"] = live
            # live events: a buy of a user's top item and the second user's
            # top item made unavailable drop them from the next answers
            (u1, a1), (u2, a2) = [(b["user"], out["itemScores"]) for b, (_, out, _)
                                  in zip(known, answers) if out["itemScores"]][:2]
            bought, gone = a1[0]["item"], a2[0]["item"]
            store.insert(Event(event="buy", entity_type="user", entity_id=u1,
                               target_entity_type="item", target_entity_id=bought), EC_APP)
            store.insert(Event(event="$set", entity_type="constraint",
                               entity_id="unavailableItems", properties={"items": [gone]}),
                         EC_APP)
            again = block("ec_live", server, [{"user": u1, "num": TEMPLATE_NUM},
                                              {"user": u2, "num": TEMPLATE_NUM}], ec_plain)
            after = [{x["item"] for x in out["itemScores"]} for _, out, _ in again]
            checks["ec_live"].update(bought=bought, unavailable=gone,
                                     dropped=bool(bought not in after[0]
                                                  and gone not in after[1]
                                                  and gone not in after[0]))
            if not checks["ec_live"]["dropped"]:
                bad.append(("ec_live", checks["ec_live"]))
            checks["ec_topk_path"] = _get_json(server.bound_port, "/status.json").get("topkPath")
        finally:
            server.shutdown()
            server.server_close()
    for name in ("sp_topk_path", "ec_topk_path"):
        if set((checks[name] or {}).values()) != {"streaming"}:
            bad.append((name, checks[name]))
    seconds["phase"] = time.monotonic() - t_phase
    out = {"phase": "templates", "category": {"name": cat, "items": len(members[cat])},
           "events": {"similarproduct": len(data["sp"]), "ecommerce": len(data["ec"])},
           "split": {"similarproduct": sp_split, "ecommerce": ec_split},
           "launches": launches, "checks": checks, "seconds": seconds,
           "by_kernel": {
               "topk_streaming": sum(v for v in launches.values() if isinstance(v, int)),
               **{k: sum(v[k] for v in launches.values() if isinstance(v, dict))
                  for k in ("gramian_fused", "spd_solve")}}}
    emit(out)
    if bad:
        raise AssertionError(f"templates: {bad[:4]}")
    return out


#: the wide phase: ranks above the build's and the solve's tuned paths (R, n
#: = 129, 200, 256) at ML-20M's bucket shapes (the users' K = 128 bucket of
#: 97,972 rows, cut by the wrapper's systems budget as training cuts it, over
#: the item table; the items' K = 32,768 bucket of 216 rows, over the user
#: table), held on its first WIDE_CHECK_ROWS rows; the solve's batch; head
#: widths above the tuned attention path (on its resident path) at the
#: training shape and at L = 2,048; ALS at rank 200 and seqrec at d_model 256
#: / 1 head (D = 256) trained from the events store
WIDE_RANKS = (129, 200, 256)
WIDE_BUCKETS = (("by_user", 97972, 128, N_ITEMS), ("by_item", 216, 32768, N_USERS))
WIDE_CHECK_ROWS, WIDE_SPD_B = 4096, 4096
#: systems of the solve's cases on both sides of the blocked path's ceiling
#: and on the cluster path
WIDE_CEIL_B = 1024
#: the cluster path's timed widths (its ceiling, SPD_CLUSTER_MAX_N, beside
#: them), the systems of the wide kernel's case above that ceiling, and ALS
#: at a rank the cluster path solves (the build's tile path above R = 272)
WIDE_CLUSTER_NS = (305, 384, 512)
WIDE_CLUSTER_CEIL_B = 64
WIDE_CLUSTER_ALS_RANK = 384
#: the tiled solve's cases above the cluster path's ceiling, (n, B): its
#: first width and ALS's rank 1,024 at B = 64 (WIDE_CLUSTER_CEIL_B), two
#: wider systems, and rank 1,024 at a training slice's B; ALS at rank 1,024
#: from the events store solves on it, held to WIDE_TILED_ALS_ITERS
#: iterations of the plain build and solve
SPD_TILED_CASES = ((769, 64), (1024, 64), (1536, 64), (2048, 64), (1024, 1024))
#: one iteration, not PARITY_ITERS: at n = 1,024 the plain solve updates a
#: [B, 1024, 1024] block a step, about 35 s an iteration on the card, and
#: each iteration past the first took the run further past half its limit
WIDE_TILED_ALS_RANK, WIDE_TILED_ALS_ITERS = 1024, 1
WIDE_HEADS = (136, 192, 256)
WIDE_ATTN_SHAPES = ((64, 4, 64, 64, True), (8, 4, 2048, 2048, True),
                    (8, 4, 2048, 2048, False))
#: heads above the resident path's widest (FLASH_WIDE_RES_MAX_D) on the
#: streamed path: its widest, timed at WIDE_ATTN_SHAPES beside the passes
#: kernel on the same tensors, and two more held at a ragged cross shape,
#: causal and not (the last chunk 24 and 48 columns wide; 302 is copied 4
#: bytes at a time)
WIDE_STREAMED_HEAD = 320
WIDE_STREAMED_CHECKS = (280, 302)
WIDE_CHECK_SHAPES = ((3, 2, 130, 200, True), (2, 3, 200, 130, False))
#: heads above the streamed path's widest on the wide streamed path (up to
#: FLASH_WIDE_STREAMED_MAX_D), timed at WIDE_ATTN_SHAPES beside the passes
#: kernel on the same tensors, and two more held at WIDE_CHECK_SHAPES (the
#: last chunk 16 and 56 columns wide; both copied 4 bytes at a time)
WIDE_WS_HEADS = (384, 512)
WIDE_WS_CHECKS = (330, 502)
#: heads above the wide streamed path's widest on the cluster path (up to
#: FLASH_CLUSTER_MAX_D, the last), timed at WIDE_ATTN_SHAPES beside the
#: passes kernel on the same tensors, and two more held at WIDE_CHECK_SHAPES
#: (650 is copied 4 bytes at a time; rank 1's slice of 900 is 448 columns)
WIDE_CLUSTER_HEADS = (576, 768, 1024)
WIDE_CLUSTER_CHECKS = (650, 900)
#: a head above the cluster path's widest (FLASH_CLUSTER_MAX_D), so the
#: passes path is still launched and held: the training shape, timed
WIDE_PASSES_HEAD = 1040
WIDE_PASSES_SHAPES = WIDE_ATTN_SHAPES[:1]
WIDE_ALS_RANK, WIDE_SEQ = 200, dict(d_model=256, n_heads=1)
#: seqrec on the streamed path (D = 320) and on the wide streamed path (D =
#: 384) from the events store: steps trained and queries served
WIDE_SEQ_STREAMED, WIDE_SEQ_STREAMED_STEPS, WIDE_SEQ_STREAMED_QUERIES = (
    dict(d_model=320, n_heads=1), 10, 16)
WIDE_SEQ_WS = dict(d_model=384, n_heads=1)
#: seqrec on the cluster path (D = 768) from the events store, 10 steps and
#: 16 queries, and SEQ_PARITY_STEPS steps through the kernel held to as many
#: through the plain attention from the one seeded init
WIDE_SEQ_CLUSTER = dict(d_model=768, n_heads=1)


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


def wide_spd_systems(torch, gen, dev, bsz: int, n: int, k: int):
    """``bsz`` SPD systems of size ``n``: a Gramian of ``k`` random rows
    plus the ridge λ·k, and a right-hand side."""
    g = torch.randn((bsz, k, n), generator=gen, device=dev)
    a = torch.bmm(g.transpose(1, 2), g)
    a += LAMBDA * k * torch.eye(n, device=dev)
    return a, torch.randn((bsz, n), generator=gen, device=dev)


def spd_abba(torch, out: dict, kernel, lib, k_iters: int, l_iters: int) -> None:
    """Event and device times of a solve ``kernel`` and the library call
    ``lib`` into ``out``, A B B A after a warm-up, and their means."""
    kernel(), lib()
    ev = [time_ms(torch, kernel, k_iters, 1), time_ms(torch, lib, l_iters, 1),
          time_ms(torch, lib, l_iters, 1), time_ms(torch, kernel, k_iters, 1)]
    dv = [traced_device_ms(torch, kernel, k_iters), traced_device_ms(torch, lib, l_iters),
          traced_device_ms(torch, lib, l_iters), traced_device_ms(torch, kernel, k_iters)]
    out["abba_ms"], out["abba_device_ms"] = ev, dv
    out["kernel_ms"], out["library_ms"] = (ev[0] + ev[3]) / 2, (ev[1] + ev[2]) / 2
    pairs = ((dv[0], dv[3]), (dv[1], dv[2]))
    out["kernel_device_ms"], out["library_device_ms"] = (
        None if None in pair else (pair[0] + pair[1]) / 2 for pair in pairs)


def spd_over_bound(out: dict, bsz: int, n: int) -> None:
    """The solve's bound at ``bsz`` systems of ``n`` into ``out``, and the
    kernel's device time over it, over the library call's and over the
    earlier kernel's where ``out`` has them."""
    bound_ms, out["bound_by"] = spd_bound(bsz, n)
    out["bound_us"] = bound_ms * 1e3
    if out.get("kernel_device_ms") is not None:
        out["device_over_bound"] = out["kernel_device_ms"] / bound_ms
        for key in ("library", "earlier_kernel"):
            if out.get(f"{key}_device_ms"):
                out[f"device_over_{key}"] = out["kernel_device_ms"] / out[f"{key}_device_ms"]


def spd_cluster_waves(ck, plan, dev, sm: int) -> dict:
    """A cluster plan's clusters at once and waves, as the plan estimates
    them (SMs · blocks an SM // cluster) and as the card places them
    (``cudaOccupancyMaxActiveClusters``)."""
    occupancy = ck.spd_cluster_occupancy(plan, dev)
    systems = plan.blocks // plan.cluster
    return {"plan_clusters": sm * plan.blocks_per_sm // plan.cluster, "plan_waves": plan.waves,
            "occupancy_clusters": occupancy,
            "occupancy_waves": -(-systems // occupancy) if occupancy else None}


def flash_cluster_waves(ck, plan, dev, sm: int) -> dict:
    """The attention cluster plan's clusters at once and waves, as the plan
    estimates them (SMs · blocks an SM // cluster) and as the card places
    them (``cudaOccupancyMaxActiveClusters``)."""
    occupancy = ck.flash_cluster_occupancy(plan, dev)
    clusters = plan.blocks // plan.cluster
    return {"plan_clusters": sm * plan.blocks_per_sm // plan.cluster, "plan_waves": plan.waves,
            "occupancy_clusters": occupancy,
            "occupancy_waves": -(-clusters // occupancy) if occupancy else None}


def forced_cluster_plan(ck, b: int, n: int, sm: int, c: int):
    """The cluster kernel's plan at ``n`` on a forced cluster of ``c``
    blocks (the kernel takes any n above SPD_MAX_N whose blocks fit), to
    compare the sizes: the plan of the narrowest n that takes ``c``, with
    n's width, tiles and shared memory. None where the blocks do not fit."""
    if ck.spd_cluster_smem(n, c) > ck.SPD_MAX_SMEM:
        return None
    nb, t = ck.SPD_BLOCKED_NB, -(-n // ck.SPD_BLOCKED_NB)
    first = next(m for m in range(ck.SPD_BLOCKED_MAX_N + 1, ck.SPD_CLUSTER_MAX_N + 1)
                 if ck.spd_cluster_size(m) == c)
    return ck.spd_launch_plan(b, first, sm)._replace(
        np_=t * nb, slots=-(-t * nb // ck.SPD_CLUSTER_THREADS), blocks=b * c,
        smem=ck.spd_cluster_smem(n, c), tiles=max(ck.spd_cluster_tiles(t, c, r) for r in range(c)),
        cluster=c)


def gramian_wide_case(torch, dev, gen, sm: int, b: int, k: int, n: int, r: int):
    """One bucket of the build above rank 128 (``b`` rows of width ``k``
    over an ``[n, r]`` table) as training launches it, in the row slices the
    systems budget cuts: on its first WIDE_CHECK_ROWS rows held to the plain
    version, to a second call, and (on the rows path) ``torch.equal`` to PR
    12's tile kernel at the rows plan's chunks; the whole bucket timed
    (events and device) on its plan's path and, on the same tensors, on the
    tile kernel's own plan (rows, tile, tile, rows) beside the bound; the
    check rows alone beside the plain version and the library call, and the
    library call over the whole bucket in slices of the check rows, their
    times summed. Returns (the case's line, whether it held)."""
    from predictionio_tpu_torch.ops import cuda_kernels as ck
    from predictionio_tpu_torch.ops.cuda_kernels import gramian_fused, gramian_fused_reference

    y, idx, w2, rhs, ridge = wide_bucket(torch, gen, dev, b, k, n, r)
    slices = ck.gramian_row_slices(b, k, r, sm)

    def whole(tile=False):
        for s0, s1 in slices:
            plan = ck.gramian_wide_launch_plan(s1 - s0, k, r, sm) if tile else None
            gramian_fused(y, idx[s0:s1], w2[s0:s1], rhs[s0:s1], ridge[s0:s1], plan=plan)

    before = gramian_fused.launches
    whole()
    torch.cuda.synchronize()
    launches = gramian_fused.launches - before
    rows = min(b, WIDE_CHECK_ROWS)
    part = (y, idx[:rows], w2[:rows], rhs[:rows], ridge[:rows])
    plan = ck.gramian_plan(rows, k, r, sm)
    a_k, b_k = gramian_fused(*part)
    a_2, b_2 = gramian_fused(*part)
    a_p, b_p = gramian_fused_reference(*part)
    ok = bool(torch.isfinite(a_k).all() and torch.isfinite(b_k).all()
              and torch.allclose(a_k, a_p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
              and torch.allclose(b_k, b_p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
              and torch.equal(a_k, a_k.transpose(1, 2)))
    same = bool(torch.equal(a_k, a_2) and torch.equal(b_k, b_2))
    err = max(float((a_k - a_p).abs().max()), float((b_k - b_p).abs().max()))
    del a_2, b_2, a_p, b_p
    tile_bits = None
    if plan.path == "rows":  # PR 12's tile kernel at the same chunks
        at_kc = ck.gramian_wide_launch_plan(rows, k, r, sm, chunk=plan.chunk)
        a_t, b_t = gramian_fused(*part, plan=at_kc)
        tile_bits = bool(torch.equal(a_k, a_t) and torch.equal(b_k, b_t))
        del a_t, b_t
    del a_k, b_k
    valid = int(w2.sum())
    first = ck.gramian_plan(slices[0][1] - slices[0][0], k, r, sm)
    tile = ck.gramian_wide_launch_plan(slices[0][1] - slices[0][0], k, r, sm)
    out = {"B": b, "K": k, "N": n, "slices": len(slices),
           "launches": launches, "check_rows": rows,
           "plan": {"path": first.path, "tiles": first.tiles, "threads": first.threads,
                    "kc": first.chunk, "S": first.n_chunks, "blocks": first.blocks,
                    "smem": first.chunk_smem, "blocks_per_sm": first.blocks_per_sm},
           "earlier_plan": ({"tiles": tile.tiles, "kc": tile.chunk, "S": tile.n_chunks,
                             "blocks": tile.blocks} if first.path == "rows" else None),
           "max_abs_err": err, "symmetric": ok, "bit_identical": same,
           "equal_to_tile_kernel_at_kc": tile_bits}
    ops = len(slices) * (2 if first.n_chunks > 1 else 1)
    tile_ops = len(slices) * (2 if tile.n_chunks > 1 else 1)
    kernel, earlier = whole, lambda: whole(tile=True)
    if first.path == "rows":
        abba = [time_ms(torch, kernel, 2, 1), time_ms(torch, earlier, 2, 1),
                time_ms(torch, earlier, 2, 1), time_ms(torch, kernel, 2, 1)]
        out["abba_ms"] = abba
        out["kernel_ms"], out["earlier_kernel_ms"] = (abba[0] + abba[3]) / 2, (abba[1] + abba[2]) / 2
        dev_abba = [traced_device_ms(torch, kernel, 2, ops),
                    traced_device_ms(torch, earlier, 2, tile_ops),
                    traced_device_ms(torch, earlier, 2, tile_ops),
                    traced_device_ms(torch, kernel, 2, ops)]
        out["abba_device_ms"] = dev_abba
        pairs = ((dev_abba[0], dev_abba[3]), (dev_abba[1], dev_abba[2]))
        out["kernel_device_ms"], out["earlier_kernel_device_ms"] = (
            None if None in pair else (pair[0] + pair[1]) / 2 for pair in pairs)
    else:
        out["kernel_ms"] = time_ms(torch, kernel, 2, 1)
        out["kernel_device_ms"] = traced_device_ms(torch, kernel, 2, ops)
    bound_ms, out["bound_by"] = gramian_bound(b, k, n, r, valid, False)
    out["bound_us"] = bound_ms * 1e3
    for key in ("kernel", "earlier_kernel"):
        if out.get(f"{key}_device_ms"):
            out[f"{key}_device_over_bound"] = out[f"{key}_device_ms"] / bound_ms
    if out.get("kernel_device_ms") and out.get("earlier_kernel_device_ms"):
        out["device_over_earlier_kernel"] = out["kernel_device_ms"] / out["earlier_kernel_device_ms"]
    # the check rows alone: kernel, plain and library on the same inputs
    sub_valid = int(w2[:rows].sum())
    out["rows_kernel_ms"] = time_ms(torch, lambda: gramian_fused(*part), 3, 1)
    out["rows_plain_ms"] = time_ms(torch, lambda: gramian_fused_reference(*part), 2, 1)
    out["rows_library_ms"] = time_ms(
        torch, lambda: _gramian_library(torch, *part[:4]), 2, 1)
    rows_bound_ms, out["rows_bound_by"] = gramian_bound(rows, k, n, r, sub_valid, False)
    out["rows_bound_us"] = rows_bound_ms * 1e3
    # the library over the whole bucket: its time in slices of the check rows, summed
    out["library_ms"] = sum(time_ms(torch, lambda s0=s0: _gramian_library(
        torch, y, idx[s0:s0 + rows], w2[s0:s0 + rows], rhs[s0:s0 + rows]), 2, 1)
        for s0 in range(0, b, rows))
    del y, idx, w2, rhs, ridge
    torch.cuda.empty_cache()
    held = ok and same and launches == len(slices) and tile_bits is not False
    return out, held


def gramian_wide_variants(torch, dev, seed: int = 0, cases=None) -> None:
    """The build above rank 128 alone at ``wide_kernels``' buckets (side,
    rank; default all six): the kernels' attributes, then each case, the
    same tensors from the same seed as ``wide_kernels``, a fresh process's
    traces. Builds only the build's library. To compare two trees in one
    call, unpack the other under ``chip_compare/`` (gitignored) and run
    this in each."""
    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    build.build_all(["gramian_fused"])
    emit({"phase": "gramian_wide_variant", "tree": os.path.basename(os.getcwd()),
          "attributes": ck.gramian_kernel_attributes(dev)})
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    for r in WIDE_RANKS:
        for side, b, k, n in WIDE_BUCKETS:
            if cases is not None and (side, r) not in cases:  # the same draws as wide_kernels'
                wide_bucket(torch, gen, dev, b, k, n, r)
                continue
            out, ok = gramian_wide_case(torch, dev, gen, sm, b, k, n, r)
            emit({"phase": "gramian_wide_variant", "case": f"{side}_R{r}", "held": ok, **out})


#: the einsum build's gather a slice, floats (2 GiB), where a bucket's is larger
LIBRARY_GATHER_FLOATS = 1 << 29


def gramian_tile_at_rank(torch, dev, r: int = WIDE_TILED_ALS_RANK, seed: int = 0) -> None:
    """The build's tile path at rank ``r`` (default the tiled solve's ALS
    rank) on the leading rows of each of WIDE_BUCKETS that one call of the
    systems budget allows (the first of ``gramian_row_slices``' slices, at
    most WIDE_CHECK_ROWS): its plan, its answer against the plain version
    (and a second call, bit for bit), the event and device ms of the kernel
    A B B A with the einsum build, the plain version's event ms and the
    bound. The einsum runs over row slices whose gather stays within
    LIBRARY_GATHER_FLOATS, its times summed. Builds only the build's
    library."""
    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck
    from predictionio_tpu_torch.ops.cuda_kernels import gramian_fused, gramian_fused_reference

    build.build_all(["gramian_fused"])
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    emit({"phase": "gramian_tile_rank", "R": r, "attributes": {
        key: a for key, a in ck.gramian_kernel_attributes(dev).items() if key.startswith("wide")}})
    for side, b, k, n in WIDE_BUCKETS:
        rows = min(WIDE_CHECK_ROWS, ck.gramian_row_slices(b, k, r, sm)[0][1])
        y, idx, w2, rhs, ridge = wide_bucket(torch, gen, dev, rows, k, n, r)
        plan = ck.gramian_plan(rows, k, r, sm)
        a_k, b_k = gramian_fused(y, idx, w2, rhs, ridge)
        a_2, b_2 = gramian_fused(y, idx, w2, rhs, ridge)
        a_p, b_p = gramian_fused_reference(y, idx, w2, rhs, ridge)
        line = {"phase": "gramian_tile_rank", "side": side, "R": r, "B": rows, "K": k, "N": n,
                "plan": {"path": plan.path, "tiles": plan.tiles, "kc": plan.chunk,
                         "S": plan.n_chunks, "blocks": plan.blocks,
                         "blocks_per_sm": plan.blocks_per_sm},
                "max_abs_err": max(float((a_k - a_p).abs().max()),
                                   float((b_k - b_p).abs().max())),
                "held": bool(torch.allclose(a_k, a_p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
                             and torch.allclose(b_k, b_p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
                             and torch.equal(a_k, a_k.transpose(1, 2))),
                "bit_identical": bool(torch.equal(a_k, a_2) and torch.equal(b_k, b_2))}
        del a_k, b_k, a_2, b_2, a_p, b_p
        step = max(1, LIBRARY_GATHER_FLOATS // (k * r))
        kernel = lambda: gramian_fused(y, idx, w2, rhs, ridge)  # noqa: E731

        def library():
            for s0 in range(0, rows, step):
                _gramian_library(torch, y, idx[s0:s0 + step], w2[s0:s0 + step],
                                 rhs[s0:s0 + step])

        ops = 2 if plan.n_chunks > 1 else 1
        for name, fn, n_ops in (("kernel", kernel, ops), ("library", library, 0),
                                ("library", library, 0), ("kernel", kernel, ops)):
            line.setdefault(f"{name}_ms", []).append(time_ms(torch, fn, 3, 1))
            line.setdefault(f"{name}_device_ms", []).append(
                traced_device_ms(torch, fn, 3, n_ops))
        line["plain_ms"] = time_ms(
            torch, lambda: gramian_fused_reference(y, idx, w2, rhs, ridge), 2, 1)
        bound_ms, line["bound_by"] = gramian_bound(rows, k, n, r, int(w2.sum()), False)
        line["bound_ms"] = bound_ms
        emit(line)
        del y, idx, w2, rhs, ridge
        torch.cuda.empty_cache()


#: where the rows path's time goes: each entry cuts one phase of
#: gramian_rows_kernel by replacing text of the .cu (every occurrence; the
#: strings are markers a refactor must keep): the row copies, the FMAs of the
#: tiles of A with their shared loads, and the writes of A and b (the sums
#: stay live behind a test no input passes)
GRAMIAN_ROWS_PHASES = {
    "gather": [("    const int m = s_m[p];\n    const int* js", "    const int m = 0;\n    const int* js")],
    "fmas": [("for (int kk = 0; kk < m; ++kk, yi += RP, yj += RP) {",
              "for (int kk = 0; kk < 0; ++kk, yi += RP, yj += RP) {")],
    "stores": [("rows_store_tile(v, bi, bj, R, rdg, yty, a_row, vec);",
                "if (v[0][0] == 1234.5f) rows_store_tile(v, bi, bj, R, rdg, yty, a_row, vec);"),
               ("rows_put(b_out + row * R + ib * kRTile, v, R - ib * kRTile, vec);",
                "if (v[0] == 1234.5f) rows_put(b_out + row * R + ib * kRTile, v, R - ib * kRTile, vec);")],
}
#: variants tried against the rows kernel in the same call, each held bit for
#: bit: the two-step kernel copying the next step's rows only after this
#: step's (no copy ahead), the 4 x 4 register tiles of stage 1, and the kk
#: loop unrolled by 2. Each runs in the plan's shape; the whole kernel also
#: runs in the other shape (two steps of rows at the fewest rounds, or one
#: step at twice the rounds), as "other_shape"
GRAMIAN_ROWS_TRIALS = {
    "no_copy_ahead": [("rows_wait<1>();", "rows_wait<0>();")],
    "tile4": [("constexpr int kRTile = 8;", "constexpr int kRTile = 4;"),
              ("constexpr int kRMaxRounds = 4;", "constexpr int kRMaxRounds = 5;")],
    "unroll2": [("#pragma unroll 1\n        for (int kk = 0; kk < m; ++kk, yi",
                 "#pragma unroll 2\n        for (int kk = 0; kk < m; ++kk, yi")],
}
#: (case, rows, width, table rows, rank) of the knock-outs: part of the
#: users' K = 128 bucket at each wide rank, and the items' split bucket
GRAMIAN_ROWS_KNOCKOUT_SHAPES = tuple(
    (f"users_R{r}", 16384, 128, N_ITEMS, r) for r in WIDE_RANKS) + (
    ("items_R200", 216, 32768, N_USERS, 200),)


def _ptxas_kernels(log: str) -> dict:
    """``nvcc -Xptxas -v``'s registers and spill stores by entry function."""
    import re

    out = {}
    for part in log.split("Compiling entry function")[1:]:
        name = re.match(r"\s*'(\S+)'", part).group(1)
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out[name] = {"regs": int(regs.group(1)) if regs else None,
                     "spill_stores": int(spill.group(1)) if spill else None}
    return out


def gramian_rows_knockouts(torch, dev, source: str = GRAMIAN_SOURCE,
                           variants: dict = None, shapes=GRAMIAN_ROWS_KNOCKOUT_SHAPES) -> None:
    """Where the rows path's time goes: ``source`` built as it is and once
    for each of ``variants`` (default GRAMIAN_ROWS_PHASES and
    GRAMIAN_ROWS_TRIALS), all with ``nvcc -Xptxas -v`` at once (each build's
    registers and spills printed), then each launched through its own
    ``pio_gramian_rows`` at ``shapes`` with the whole kernel's chunks (CUDA
    events, and whether its answer equals the whole kernel's bit for bit).
    A knock-out's time less the whole kernel's is what that phase costs
    where nothing hides it; a trial's is what it would gain."""
    import ctypes
    import re

    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    variants = variants or {**GRAMIAN_ROWS_PHASES, **GRAMIAN_ROWS_TRIALS}
    text = open(source).read()
    sources = {"whole": text}
    for name, pairs in variants.items():
        src = text
        for old, new in pairs:
            if old not in src:
                raise AssertionError(f"variant {name}: {old!r} is not in {source}")
            src = src.replace(old, new)
        sources[name] = src
    tmp = tempfile.mkdtemp(prefix="gramian_knockouts_")
    procs = {}
    for name, src in sources.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, shapes_of = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise AssertionError(f"variant {name} did not build: {log[-2000:]}")
        emit({"phase": "gramian_rows_knockout", "variant": name, "ptxas": {
            k: v for k, v in _ptxas_kernels(log).items() if "gramian_rows" in k}})
        lib = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so"))
        lib.pio_gramian_rows.argtypes = ck._EXTRA_ENTRIES["gramian_fused"]["pio_gramian_rows"]
        libs[name] = lib
        shapes_of[name] = tuple(int(re.search(rf"constexpr int {c} = (\d+);", sources[name]).group(1))
                                for c in ("kRTile", "kRMaxRounds"))
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(21)
    for case, b, k, n, r in shapes:
        y, idx, w2, rhs, ridge = wide_bucket(torch, gen, dev, b, k, n, r)
        plan = ck.gramian_rows_launch_plan(b, k, r, sm)
        a = torch.empty((b, r, r), dtype=torch.float32, device=dev)
        bv = torch.empty((b, r), dtype=torch.float32, device=dev)
        stages = plan.chunk_smem == ck.gramian_rows_smem(r, stages=1) and 1 or 2
        times, same, ref = {}, {}, None
        # each variant in the plan's shape; the whole kernel also in the other
        runs = [(name, lib, stages) for name, lib in libs.items()] + [
            ("other_shape", libs["whole"], 3 - stages)]
        for name, lib, st in runs:
            tile, max_rounds = shapes_of[name if name in shapes_of else "whole"]
            rounds = -(-ck.gramian_rows_tiles(r, tile)[1] // ck.GRAMIAN_ROWS_MAX_THREADS)
            part = (torch.empty((b, plan.n_chunks, ck.gramian_rows_partial(r, tile)),
                                dtype=torch.float32, device=dev) if plan.n_chunks > 1 else None)
            threads = ck.gramian_rows_threads(r, tile, min(rounds * (3 - st), max_rounds),
                                              max_rounds)
            smem = ck.gramian_rows_smem(r, tile, st)

            def launch(lib=lib, part=part, name=name, threads=threads, smem=smem):
                code = lib.pio_gramian_rows(
                    y.data_ptr(), idx.data_ptr(), w2.data_ptr(), rhs.data_ptr(),
                    ridge.data_ptr(), None, b, k, n, r, plan.chunk, plan.n_chunks,
                    threads, smem, None if part is None else part.data_ptr(), a.data_ptr(),
                    bv.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
                if code:
                    raise AssertionError(f"variant {name} failed to launch: {code}")
            times[name] = time_ms(torch, launch, 3, 1)
            if ref is None:
                ref = (a.clone(), bv.clone())
            else:
                same[name] = bool(torch.equal(a, ref[0]) and torch.equal(bv, ref[1]))
            del part
        emit({"phase": "gramian_rows_knockout", "case": case, "B": b, "K": k, "R": r,
              "kc": plan.chunk, "S": plan.n_chunks, "stages": stages, "threads": plan.threads,
              "ms": times,
              "phase_ms": {v: times["whole"] - t for v, t in times.items() if v != "whole"},
              "equal_to_whole": same})
        del y, idx, w2, rhs, ridge, a, bv, ref
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)


def spd_blocked_variants(torch, dev, seed: int = 0) -> None:
    """The blocked solve alone at n = WIDE_RANKS (B = WIDE_SPD_B): its
    registers, the plan, its bits against the wide kernel, and event
    and device ms. Builds only the solve's library. To compare two kernel
    versions in one call, unpack the other tree under ``chip_compare/``
    (gitignored) and run this in each, A B B A: the inputs come from the
    seed, so both see the same tensors."""
    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    build.build_all(["spd_solve"])
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    attrs = ck.spd_kernel_attributes(dev)["blocked"]
    for n in WIDE_RANKS:
        a, b = wide_spd_systems(torch, gen, dev, WIDE_SPD_B, n, 2 * n)
        plan = ck.spd_launch_plan(WIDE_SPD_B, n, sm)
        x = ck.spd_solve(a, b)
        wide = ck.spd_solve(a, b, plan=ck.spd_wide_launch_plan(WIDE_SPD_B, n, sm))
        kernel = lambda: ck.spd_solve(a, b)  # noqa: E731
        emit({"phase": "spd_variant", "tree": os.path.basename(os.getcwd()), "n": n,
              "attributes": attrs, "plan": {"nb": plan.nb, "threads": 32 * plan.warps,
                                            "smem": plan.smem,
                                            "blocks_per_sm": plan.blocks_per_sm},
              "equal_to_wide_kernel": bool(torch.equal(x, wide)),
              "kernel_ms": time_ms(torch, kernel, 10, 2),
              "kernel_device_ms": traced_device_ms(torch, kernel, 10)})
        del a, b, x, wide


#: the blocked solve's phases as the knock-outs cut them: the comment or
#: line that marks each in ``spd_solve.cu``; the statement after a marker
#: (an ``if`` or ``for`` and its braces) is removed, the load's copy
#: replaced by a store
SPD_BLOCKED_PHASES = {"diagonal_warp": "float d2 = __shfl_sync(kFull, col[0], 0);",
                      "strip": "// the strip: ",
                      "trailing": "const int count = (ntiles - qd - 1) * G * G;",
                      "back_substitution": "float* s_x = s_l;"}


def _without_statement(src: str, marker: str) -> str:
    """``src`` with the first ``if``/``for`` statement after ``marker`` cut."""
    at = src.index(marker)
    start = min(i for i in (src.find("  if (", at), src.find("  for (", at)) if i >= 0)
    depth, i = 0, src.index("{", start)
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[:start] + src[i + 1:]
        i += 1


def spd_blocked_knockouts(torch, dev, source: str = SPD_SOURCE) -> None:
    """Where the blocked solve's time goes: ``source`` built as it is and
    once without each phase (SPD_BLOCKED_PHASES, and the copy of A), all
    with ``nvcc -Xptxas -v`` at once, then each timed at n = WIDE_RANKS (B
    = WIDE_SPD_B, CUDA events). A knock-out's answer is wrong; its time
    less the whole kernel's is what that phase costs where nothing hides
    it. Prints each build's registers and spills."""
    import ctypes
    import re

    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    text = open(source).read()
    variants = {"whole": text,
                "load": text.replace("copy4(dst, a_g + static_cast<size_t>(r) * n + c);",
                                     "*dst = 1.f;"),
                **{name: _without_statement(text, marker)
                   for name, marker in SPD_BLOCKED_PHASES.items()}}
    tmp = tempfile.mkdtemp(prefix="spd_knockouts_")
    procs = {}
    for name, src in variants.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise AssertionError(f"knock-out {name} did not build: {log[-2000:]}")
        blocked = log[log.index("spd_blocked_kernel"):]
        emit({"phase": "spd_knockout", "variant": name,
              "ptxas": re.findall(r"(\d+ bytes spill stores|Used \d+ registers)", blocked)[:2]})
        lib = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so"))
        lib.pio_spd_solve_blocked.argtypes = (
            ck._EXTRA_ENTRIES["spd_solve"]["pio_spd_solve_blocked"])
        libs[name] = lib
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(21)
    for n in WIDE_RANKS:
        a, b = wide_spd_systems(torch, gen, dev, WIDE_SPD_B, n, 2 * n)
        x = torch.empty_like(b)
        plan = ck.spd_launch_plan(WIDE_SPD_B, n, sm)
        times = {}
        for name, lib in libs.items():
            def launch(lib=lib):
                code = lib.pio_spd_solve_blocked(
                    a.data_ptr(), b.data_ptr(), x.data_ptr(), WIDE_SPD_B, n, plan.nb,
                    32 * plan.warps, plan.tiles, plan.blocks, plan.smem,
                    torch.cuda.current_stream(dev).cuda_stream)
                if code:
                    raise AssertionError(f"knock-out {name} failed to launch: {code}")
            times[name] = time_ms(torch, launch, 10, 2)
        emit({"phase": "spd_knockout", "n": n, "ms": times,
              "phase_ms": {k: times["whole"] - v for k, v in times.items() if k != "whole"}})
        del a, b, x
    shutil.rmtree(tmp, ignore_errors=True)


#: the cluster solve's widths alone, its ceiling (SPD_CLUSTER_MAX_N) last:
#: held and timed by spd_cluster_variants and spd_cluster_knockouts (B =
#: WIDE_CEIL_B)
SPD_CLUSTER_SHAPES = (*WIDE_CLUSTER_NS, 768)


def spd_cluster_variants(torch, dev, seed: int = 0, shapes=SPD_CLUSTER_SHAPES,
                         sizes=(None,)) -> None:
    """The cluster solve alone at ``shapes`` (B = WIDE_CEIL_B): its
    registers, then at each n and cluster size (``None`` the plan's own)
    the plan beside ``cudaOccupancyMaxActiveClusters``, its bits against the
    wide kernel and a second call, its error against the plain version, and
    event and device ms A B B A against ``cholesky_solve``. Builds only the
    solve's library. The inputs come from the seed, so two trees unpacked
    under ``chip_compare/`` (gitignored) see the same tensors."""
    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    build.build_all(["spd_solve"])
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    emit({"phase": "spd_cluster_variant", "tree": os.path.basename(os.getcwd()),
          "attributes": ck.spd_cluster_kernel_attributes(dev)})

    def library(a, b):
        return torch.cholesky_solve(b[:, :, None], torch.linalg.cholesky(a))

    for n in shapes:
        a, b = wide_spd_systems(torch, gen, dev, WIDE_CEIL_B, n, 2 * n)
        x_w = ck.spd_solve(a, b, plan=ck.spd_wide_launch_plan(WIDE_CEIL_B, n, sm))
        x_p = ck.spd_solve_reference(a, b) if n <= 512 else None
        for c in sizes:
            plan = (ck.spd_launch_plan(WIDE_CEIL_B, n, sm) if c is None
                    else forced_cluster_plan(ck, WIDE_CEIL_B, n, sm, c))
            if plan is None:
                continue
            x = ck.spd_solve(a, b, plan=plan)
            kernel = lambda: ck.spd_solve(a, b, plan=plan)  # noqa: E731
            rel = (None if x_p is None else
                   float(((x - x_p).norm(dim=1) / x_p.norm(dim=1).clamp_min(1e-30)).max()))
            out = {"phase": "spd_cluster_variant", "tree": os.path.basename(os.getcwd()), "n": n,
                   "B": WIDE_CEIL_B, "cluster": plan.cluster, "smem": plan.smem,
                   "tiles": plan.tiles, "blocks_per_sm": plan.blocks_per_sm,
                   **spd_cluster_waves(ck, plan, dev, sm),
                   "equal_to_wide_kernel": bool(torch.equal(x, x_w)),
                   "bit_identical": bool(torch.equal(x, kernel())), "max_rel_err": rel}
            spd_abba(torch, out, kernel, lambda: library(a, b), 5, 3)
            emit(out)
            del x
        del a, b, x_w, x_p
        torch.cuda.empty_cache()


def spd_tiled_by_kernel(torch, kernel, iters: int = 3) -> dict:
    """Where a tiled solve's device time goes: each of its kernels' device
    ms a call (summed over the call's launches, from one profiler trace of
    ``iters`` calls) and the launches a call; each phase of the path is a
    kernel of its own, so this is the phase's time where a fused kernel
    needs knock-outs."""
    prof = device_profile(torch, lambda: [kernel() for _ in range(iters)], top=8)
    out = {}
    for op in prof["top_device_ops"]:
        name = op["name"].split("spd_tiled_", 1)[-1].split("_kernel", 1)[0]
        out[name] = {"ms": op["ms"] / iters, "launches": op["count"] / iters}
    return out


def spd_tiled_variants(torch, dev, seed: int = 0, shapes=SPD_TILED_CASES[:2]) -> None:
    """The tiled solve alone at ``shapes`` ((n, B) pairs): its kernels'
    registers and local bytes, then at each shape its bits against the wide
    kernel and a second call, its
    error against the plain version (n <= 1,024), event and device ms A B B
    A against ``cholesky_solve``, and the wide kernel's one timed call.
    Builds only the solve's library. The inputs come from the seed, so two
    trees unpacked under ``chip_compare/`` (gitignored) see the same
    tensors."""
    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    build.build_all(["spd_solve"])
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    emit({"phase": "spd_tiled_variant", "tree": os.path.basename(os.getcwd()),
          "attributes": ck.spd_tiled_kernel_attributes(dev)})

    def library(a, b):
        return torch.cholesky_solve(b[:, :, None], torch.linalg.cholesky(a))

    for n, bsz in shapes:
        a, b = wide_spd_systems(torch, gen, dev, bsz, n, 2 * n)
        wide = lambda: ck.spd_solve(a, b, plan=ck.spd_wide_launch_plan(bsz, n, sm))  # noqa: E731
        x_w = wide()
        x_p = ck.spd_solve_reference(a, b) if bsz * n * n <= 64 * 1024 * 1024 else None
        plan = ck.spd_tiled_launch_plan(bsz, n, sm)
        x = ck.spd_solve(a, b, plan=plan)
        kernel = lambda: ck.spd_solve(a, b, plan=plan)  # noqa: E731
        rel = (None if x_p is None else
               float(((x - x_p).norm(dim=1) / x_p.norm(dim=1).clamp_min(1e-30)).max()))
        out = {"phase": "spd_tiled_variant", "tree": os.path.basename(os.getcwd()), "n": n,
               "B": bsz, "nb": plan.nb, "launches_a_call": len(plan.launch_blocks),
               "calls": -(-bsz // plan.systems),
               "equal_to_wide_kernel": bool(torch.equal(x, x_w)),
               "bit_identical": bool(torch.equal(x, kernel())), "max_rel_err": rel,
               "finite": bool(torch.isfinite(x).all())}
        spd_abba(torch, out, kernel, lambda: library(a, b), 5, 3)
        spd_over_bound(out, bsz, n)
        out["by_kernel"] = spd_tiled_by_kernel(torch, kernel)
        emit(out)
        del x
        emit({"phase": "spd_tiled_variant", "n": n, "B": bsz,
              "wide_kernel_ms": time_ms(torch, wide, 1, 0),
              "wide_kernel_device_ms": traced_device_ms(torch, wide, 1)})
        del a, b, x_w, x_p
        torch.cuda.empty_cache()


def spd_tiled_compare(torch, dev, variants: dict, shapes=SPD_TILED_CASES[:2],
                      seed: int = 0) -> None:
    """Other versions of the solve's source against the tree's own, on the
    same tensors: ``variants`` maps a name to (path of a ``.cu``, threads a
    block of each tiled kernel where they differ from the plan's, as a
    dict by kernel name, or None[, a function of (t, nb) giving the blocks
    a system of each launch where they differ]). A variant whose answer is
    wrong on purpose (a knock-out: its time less the whole's is what the
    part it cuts costs where nothing hides it) shows as not equal to
    "whole". Every source is built with ``nvcc
    -Xptxas -v`` at once (the tree's own as "whole"); then at each (n, B) of
    ``shapes`` each is checked bit for bit against "whole" and timed by CUDA
    events in one order and then the reverse (the two means averaged), with
    its device ms by kernel from one trace. Prints each build's registers
    and spills."""
    import ctypes
    import re

    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    sources = {"whole": (SPD_SOURCE, None), **variants}
    tmp = tempfile.mkdtemp(prefix="spd_tiled_compare_")
    procs = {}
    for name, (path, *_) in sources.items():
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise AssertionError(f"variant {name} did not build: {log[-3000:]}")
        tiled = log[log.find("spd_tiled"):]
        emit({"phase": "spd_tiled_compare", "variant": name,
              "ptxas": re.findall(
                  r"(spd_tiled_\w+_kernel|\d+ bytes spill stores|Used \d+ registers)", tiled)[:40]})
        lib = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so"))
        lib.pio_spd_solve_tiled.argtypes = ck._EXTRA_ENTRIES["spd_solve"]["pio_spd_solve_tiled"]
        libs[name] = lib
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    for n, bsz in shapes:
        a, b = wide_spd_systems(torch, gen, dev, bsz, n, 2 * n)
        base = ck.spd_tiled_launch_plan(bsz, n, sm)
        work = torch.empty((base.systems, base.scratch), dtype=torch.float32, device=dev)
        xs = {}

        def launch(name):
            threads = dict(zip(ck.SPD_TILED_KERNELS, base.threads))
            threads.update(sources[name][1] or {})
            th = (ctypes.c_int * 5)(*(threads[k] for k in ck.SPD_TILED_KERNELS))
            per_sys = (sources[name][2](base.panels, base.nb) if len(sources[name]) > 2
                       else base.launch_blocks)
            blocks = (ctypes.c_int * len(per_sys))(*per_sys)
            x = xs.setdefault(name, torch.empty_like(b))
            stream = torch.cuda.current_stream(dev).cuda_stream
            for s0 in range(0, bsz, base.systems):
                s1 = min(bsz, s0 + base.systems)
                code = libs[name].pio_spd_solve_tiled(
                    a[s0:s1].data_ptr(), b[s0:s1].data_ptr(), x[s0:s1].data_ptr(),
                    work.data_ptr(), s1 - s0, n, base.nb, base.tiles, base.panels, base.scratch,
                    th, 5, blocks, len(per_sys), stream)
                if code:
                    raise AssertionError(f"variant {name} failed to launch: {code}")

        times = dict.fromkeys(libs, 0.0)
        for name in [*libs, *reversed(libs)]:
            times[name] += time_ms(torch, lambda name=name: launch(name), 5, 1) / 2
        bits = {name: bool(torch.equal(xs[name], xs["whole"])) for name in libs}
        by_kernel = {name: spd_tiled_by_kernel(torch, lambda name=name: launch(name))
                     for name in libs}
        emit({"phase": "spd_tiled_compare", "n": n, "B": bsz, "nb": base.nb, "ms": times,
              "equal_to_whole": bits, "by_kernel": by_kernel})
        del a, b, work
        xs.clear()
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)


#: the tiled solve's phases as the knock-outs cut them, each a list of (a
#: text of ``spd_solve.cu``, its replacement): a kernel's launches left out
#: (its device time and the launch gaps it costs), or inside the trailing
#: update its FMAs (all but the first step's), its tile's loads and stores
#: (the sums kept live by stores that never run) or its copies of L's rows
#: (shared memory filled instead)
SPD_TILED_PHASES = {
    "copy": [("case kTlCopy: spd_tiled_copy_kernel<NB><<<blocks, threads, 0, st>>>(a, b, w, n, t);",
              "case kTlCopy:")],
    "diag": [("case kTlDiag: spd_tiled_diag_kernel<NB><<<blocks, threads, 0, st>>>(w, t, p);",
              "case kTlDiag:")],
    "strip": [("spd_tiled_strip_kernel<NB><<<blocks, threads, 0, st>>>(w, t, p, per_sys);", "")],
    "update": [("spd_tiled_update_kernel<NB><<<blocks, threads, 0, st>>>(w, t, p, per_sys);", "")],
    "back": [("default: spd_tiled_back_kernel<NB><<<blocks, threads, 0, st>>>(w, x, n, t);",
              "default:")],
    "update_fmas": [("acc[r][c] = __fmaf_rn(-rv[r], cv[c], acc[r][c]);",
                     "acc[r][c] = k == 0 ? __fmaf_rn(-rv[r], cv[c], acc[r][c]) : acc[r][c];")],
    "update_tile_traffic": [
        ("for (int r = 0; r < 4; ++r) load4(tu + r * NB, 0, acc[r]);",
         "for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;"),
        ("  if (i == j && rg == cg) {\n#pragma unroll\n    for (int r = 0; r < 4; ++r) {",
         "  if (acc[0][0] == 12345.f) {\n#pragma unroll\n    for (int r = 0; r < 4; ++r) {"),
        ("  } else {\n#pragma unroll\n    for (int r = 0; r < 4; ++r) {\n"
         "      *reinterpret_cast<float4*>(tu + r * NB)",
         "  } else if (acc[1][1] == 12345.f) {\n#pragma unroll\n    for (int r = 0; r < 4; ++r) {\n"
         "      *reinterpret_cast<float4*>(tu + r * NB)")],
    "update_l_copies": [
        ("    copy16(s_li + k * NB + 4 * g, s.l + k * np + i * NB + 4 * g);\n"
         "    if (i != j) copy16(s_lj + k * NB + 4 * g, s.l + k * np + j * NB + 4 * g);",
         "    s_li[k * NB + 4 * g] = 0.5f;\n    s_lj[k * NB + 4 * g] = 0.5f;")],
}


def spd_tiled_knockouts(torch, dev, source: str = SPD_SOURCE, shapes=SPD_TILED_CASES) -> None:
    """Where the tiled solve's time goes: ``source`` built once without each
    phase of SPD_TILED_PHASES and timed against itself by
    :func:`spd_tiled_compare` at ``shapes`` (forward then reverse, device ms
    by kernel). A knock-out's answer is wrong; its time less the whole's is
    what the phase costs where nothing hides it."""
    text = open(source).read()
    tmp = tempfile.mkdtemp(prefix="spd_tiled_knockouts_")
    variants = {}
    for name, edits in SPD_TILED_PHASES.items():
        variant = text
        for cut, keep in edits:
            if variant.count(cut) != 1:
                raise AssertionError(f"knock-out {name}: its text is not in {source} once")
            variant = variant.replace(cut, keep)
        path = os.path.join(tmp, f"no_{name}.cu")
        with open(path, "w") as f:
            f.write(variant)
        variants[f"no_{name}"] = (path, None)
    spd_tiled_compare(torch, dev, variants, shapes)
    shutil.rmtree(tmp, ignore_errors=True)


#: the cluster solve's phases as the knock-outs cut them: each a text of
#: ``spd_cluster_kernel`` removed (a call), or the first ``if``/``for``
#: statement after it cut (the strip, the trailing update, back
#: substitution); "load" replaces the copy of A by a store, "barriers" every
#: cluster barrier after the copy's by a block barrier (one cluster barrier
#: kept at the end, so that no block leaves while another may write to it)
SPD_CLUSTER_PHASES = {
    "panel": ("blk_panel<NB>(s_u + static_cast<size_t>(qd) * TF, s_y + e, s_ld, s_inv, s_z, "
              "lane);", None),
    "strip_exchange": ("cl_push_column<NB, C>(cluster, rank, s_l + c, np);", None),
    "panel_exchange": ("cl_push_panel<NB, C>(cluster, rank, s_ld, lane);", None),
    "strip": (None, "const int q0 = cl_row_start(p, m, C, rank) + f - cl_first(p, C, rank);"),
    "trailing": (None, "const int count = (own - first) * G * G;"),
    "back_substitution": (None, "float* s_x = s_l;"),
}
SPD_CLUSTER_FIRST_SYNC = "cluster.sync();  // every block has started and holds its tiles"


def spd_cluster_variants_source(text: str) -> dict:
    """The knock-out sources of :func:`spd_cluster_knockouts`, by name,
    from the solve's source ``text`` ("whole" is ``text``)."""
    section = text.index("// ---- the cluster path")
    kernel_at = text.index("spd_cluster_kernel(const float*")
    kernel_end = text.index("// The launch of a cluster", kernel_at)
    variants = {"whole": text}
    for name, (call, marker) in SPD_CLUSTER_PHASES.items():
        if call is not None:
            at = text.index(call, section)
            variants[name] = text[:at] + text[at + len(call):]
        else:
            at = text.index(marker, section)
            variants[name] = text[:at] + _without_statement(text[at:], marker)
    body = text[kernel_at:kernel_end]
    first = body.index(SPD_CLUSTER_FIRST_SYNC) + len(SPD_CLUSTER_FIRST_SYNC)
    body = body[:first] + body[first:].replace("cluster.sync();", "__syncthreads();")
    close = body.rindex("}")
    variants["barriers"] = (text[:kernel_at] + body[:close] + "  cluster.sync();\n"
                            + body[close:] + text[kernel_end:])
    variants["load"] = text[:kernel_at] + text[kernel_at:].replace(
        "copy4(dst, a_g + static_cast<size_t>(r) * n + c);", "*dst = 1.f;", 1)
    return variants


def spd_cluster_knockouts(torch, dev, source: str = SPD_SOURCE,
                          shapes=SPD_CLUSTER_SHAPES[:3], compare=()) -> None:
    """Where the cluster solve's time goes: ``source`` built as it is and
    once without each phase (:func:`spd_cluster_variants_source`), and each
    path of ``compare`` (another version of the source) built whole, all
    with ``nvcc -Xptxas -v`` at once; then each timed at ``shapes`` (B =
    WIDE_CEIL_B, the plan's own cluster size, CUDA events), in one order and
    then the reverse, the two means averaged. A knock-out's answer is
    wrong; its time less the whole kernel's is what that phase costs where
    nothing hides it. Prints each build's registers and spills."""
    import ctypes
    import re

    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    variants = spd_cluster_variants_source(open(source).read())
    variants.update({f"compare_{os.path.basename(path)}": open(path).read() for path in compare})
    tmp = tempfile.mkdtemp(prefix="spd_cluster_knockouts_")
    procs = {}
    for name, src in variants.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise AssertionError(f"knock-out {name} did not build: {log[-2000:]}")
        cluster = log[log.index("spd_cluster_kernel"):]
        emit({"phase": "spd_cluster_knockout", "variant": name,
              "ptxas": re.findall(r"(\d+ bytes spill stores|Used \d+ registers)", cluster)[:6]})
        lib = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so"))
        lib.pio_spd_solve_cluster.argtypes = (
            ck._EXTRA_ENTRIES["spd_solve"]["pio_spd_solve_cluster"])
        libs[name] = lib
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(21)
    for n in shapes:
        a, b = wide_spd_systems(torch, gen, dev, WIDE_CEIL_B, n, 2 * n)
        x = torch.empty_like(b)
        plan = ck.spd_launch_plan(WIDE_CEIL_B, n, sm)
        times = dict.fromkeys(libs, 0.0)
        for name in [*libs, *reversed(libs)]:
            def launch(lib=libs[name], name=name):
                code = lib.pio_spd_solve_cluster(
                    a.data_ptr(), b.data_ptr(), x.data_ptr(), WIDE_CEIL_B, n, plan.nb,
                    32 * plan.warps, plan.cluster, plan.tiles, plan.blocks, plan.smem,
                    torch.cuda.current_stream(dev).cuda_stream)
                if code:
                    raise AssertionError(f"knock-out {name} failed to launch: {code}")
            times[name] += time_ms(torch, launch, 5, 1) / 2
        emit({"phase": "spd_cluster_knockout", "n": n, "cluster": plan.cluster, "ms": times,
              "phase_ms": {k: times["whole"] - v for k, v in times.items() if k != "whole"}})
        del a, b, x
    shutil.rmtree(tmp, ignore_errors=True)


def wide_spd_cases(torch, dev, gen, sm: int, held) -> None:
    """The solve above n = 128, each case handed to ``held(name, case, out,
    ok)``: at n = 129, 200, 256 (B = 4,096) the plan, the blocked kernel
    bit for bit against the wide kernel on the same tensors (launched
    through ``plan=``) and within KERNEL_TOL of the plain version, then
    event and device times of the blocked kernel and ``cholesky_solve`` in
    the order A B B A after a warm-up, the wide kernel's and the plain
    version's beside them; the blocked path's widest system; the cluster
    path at WIDE_CLUSTER_NS and its ceiling (B = WIDE_CEIL_B) held the same
    way, each plan beside ``cudaOccupancyMaxActiveClusters`` and the wide
    kernel timed once on the same tensors; above that ceiling the tiled path
    at SPD_TILED_CASES held the same way, its device time by kernel beside
    it; a doctored cluster plan and a doctored tiled plan, which must raise;
    the zero-and-singular cases on the blocked, cluster and tiled paths; n
    = 400 on the wide kernel's scratch; and the users' K = 128 bucket at
    rank 200, built
    by ``gramian_fused`` in ``gramian_row_slices``' slices as ALS builds it,
    solved slice by slice by each of the three."""
    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck
    from predictionio_tpu_torch.ops.cuda_kernels import (
        gramian_fused,
        spd_solve,
        spd_solve_reference,
    )

    def spd_systems(bsz, n, k):
        return wide_spd_systems(torch, gen, dev, bsz, n, k)

    def rel_err(x, ref):
        return float(((x - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)).max())

    def library(a, b):
        return torch.cholesky_solve(b[:, :, None], torch.linalg.cholesky(a))

    def plan_line(plan):
        line = {"path": plan.path, "nb": plan.nb, "tiles": plan.tiles, "np": plan.np_,
                "threads": 32 * plan.warps, "smem": plan.smem, "scratch": plan.scratch,
                "cluster": plan.cluster, "blocks": plan.blocks,
                "blocks_per_sm": plan.blocks_per_sm, "waves": plan.waves}
        if plan.path == "tiled":
            line.update(panels=plan.panels, kernel_threads=plan.threads,
                        launches_a_call=len(plan.launch_blocks), systems_a_call=plan.systems)
        return line

    def against_wide(a, b, n):
        """The plan, the solve, the wide kernel's solve on the same tensors
        and the plain version's, with the checks every case holds."""
        bsz = a.shape[0]
        plan, wide = ck.spd_launch_plan(bsz, n, sm), ck.spd_wide_launch_plan(bsz, n, sm)
        before = spd_solve.launches
        x_k = spd_solve(a, b)
        launches = spd_solve.launches - before
        x_w, x_p = spd_solve(a, b, plan=wide), spd_solve_reference(a, b)
        out = {"n": n, "B": bsz, "plan": plan_line(plan), "launches": launches,
               "max_rel_err": rel_err(x_k, x_p), "max_abs_err": float((x_k - x_p).abs().max()),
               "equal_to_wide_kernel": bool(torch.equal(x_k, x_w)),
               "bit_identical": bool(torch.equal(x_k, spd_solve(a, b)))}
        # the tiled path calls its C entry once a slice of its working copies' budget
        calls = len(ck.spd_tiled_slices(bsz, n)) if plan.path == "tiled" else 1
        ok = (out["max_rel_err"] < KERNEL_TOL and out["bit_identical"] and launches == calls
              and bool(torch.isfinite(x_k).all()))
        return out, ok, plan, wide

    for n in WIDE_RANKS:
        a, b = spd_systems(WIDE_SPD_B, n, 2 * n)
        out, ok, plan, wide = against_wide(a, b, n)
        spd_abba(torch, out, lambda: spd_solve(a, b), lambda: library(a, b), 5, 3)
        earlier = lambda: spd_solve(a, b, plan=wide)  # noqa: E731
        out["earlier_kernel_ms"] = time_ms(torch, earlier, 2, 1)
        out["earlier_kernel_device_ms"] = traced_device_ms(torch, earlier, 2)
        out["plain_ms"] = time_ms(torch, lambda: spd_solve_reference(a, b), 2, 1)
        spd_over_bound(out, WIDE_SPD_B, n)
        held("spd_solve", f"n{n}", out,
             ok and out["equal_to_wide_kernel"] and plan.path == "blocked")
        del a, b

    # the blocked path's widest system
    n = ck.SPD_BLOCKED_MAX_N
    a, b = spd_systems(WIDE_CEIL_B, n, 2 * n)
    out, ok, plan, _ = against_wide(a, b, n)
    held("spd_solve", f"n{n}_blocked", out,
         ok and plan.path == "blocked" and out["equal_to_wide_kernel"])
    # the cluster path at its timed widths and its ceiling: bit for bit the
    # wide kernel, A B B A against cholesky_solve, the wide kernel (and below
    # the ceiling the plain version) timed beside it
    for n in (*WIDE_CLUSTER_NS, ck.SPD_CLUSTER_MAX_N):
        a, b = spd_systems(WIDE_CEIL_B, n, 2 * n)
        out, ok, plan, wide = against_wide(a, b, n)
        out.update(spd_cluster_waves(ck, plan, dev, sm))
        spd_abba(torch, out, lambda: spd_solve(a, b), lambda: library(a, b), 5, 3)
        earlier = lambda: spd_solve(a, b, plan=wide)  # noqa: E731
        out["earlier_kernel_ms"] = time_ms(torch, earlier, 1, 0)
        out["earlier_kernel_device_ms"] = traced_device_ms(torch, earlier, 1)
        if n < ck.SPD_CLUSTER_MAX_N:
            out["plain_ms"] = time_ms(torch, lambda: spd_solve_reference(a, b), 1, 0)
        spd_over_bound(out, WIDE_CEIL_B, n)
        held("spd_solve", f"n{n}_cluster", out,
             ok and plan.path == "cluster" and out["equal_to_wide_kernel"])
        del a, b
        torch.cuda.empty_cache()
    # above the cluster path's ceiling the tiled path: bit for bit the wide
    # kernel, A B B A against cholesky_solve, the wide kernel timed by one
    # call on the same tensors (and traced, which takes two more, and the
    # plain version timed, at B = 64 up to n = 1,024), and the device time
    # by kernel
    for n, bsz in SPD_TILED_CASES:
        a, b = spd_systems(bsz, n, 2 * n)
        out, ok, plan, wide = against_wide(a, b, n)
        kernel = lambda: spd_solve(a, b)  # noqa: E731
        spd_abba(torch, out, kernel, lambda: library(a, b), 5, 3)
        earlier = lambda: spd_solve(a, b, plan=wide)  # noqa: E731
        out["earlier_kernel_ms"] = time_ms(torch, earlier, 1, 0)
        if bsz * n <= 64 * 1024:
            out["earlier_kernel_device_ms"] = traced_device_ms(torch, earlier, 1)
            out["plain_ms"] = time_ms(torch, lambda: spd_solve_reference(a, b), 1, 0)
        out["by_kernel"] = spd_tiled_by_kernel(torch, kernel)
        spd_over_bound(out, bsz, n)
        held("spd_solve", f"n{n}_B{bsz}_tiled", out,
             ok and plan.path == "tiled" and out["equal_to_wide_kernel"])
        del a, b
        torch.cuda.empty_cache()
    # a plan the C entry does not take is an error, never a fallback
    a, b = spd_systems(8, 400, 800)
    doctored = ck.spd_launch_plan(8, 400, sm)._replace(smem=ck.spd_launch_plan(8, 400, sm).smem + 16)
    try:
        spd_solve(a, b, plan=doctored)
        refused = False
    except build.KernelLaunchError:
        refused = True
    held("spd_solve", "n400_cluster_doctored_plan", {"max_abs_err": 0.0, "refused": refused},
         refused)
    a, b = spd_systems(8, 800, 1600)
    tiled = ck.spd_launch_plan(8, 800, sm)
    try:
        spd_solve(a, b, plan=tiled._replace(scratch=tiled.scratch + 4))
        refused = False
    except build.KernelLaunchError:
        refused = True
    held("spd_solve", "n800_tiled_doctored_plan", {"max_abs_err": 0.0, "refused": refused},
         refused and tiled.path == "tiled")
    # zero systems and dead pivots on the blocked, the cluster and the tiled path
    for n, path, dead in ((200, "blocked", [0, 77, 199]), (320, "cluster", [0, 160, 319]),
                          (800, "tiled", [0, 400, 799])):
        a, b = spd_systems(256, n, 2 * n)
        a[128:] = 0.0
        a[:64, dead, :] = 0.0
        a[:64, :, dead] = 0.0
        x_k, x_p = spd_solve(a, b), spd_solve_reference(a, b)
        ok = (bool((x_k[128:] == 0).all()) and bool((x_k[:64, dead] == 0).all())
              and bool(torch.isfinite(x_k).all()) and rel_err(x_k[:128], x_p[:128]) < KERNEL_TOL
              and ck.spd_launch_plan(256, n, sm).path == path)
        same = bool(torch.equal(x_k, spd_solve(a, b, plan=ck.spd_wide_launch_plan(256, n, sm))))
        held("spd_solve", f"n{n}_zero_and_singular",
             {"path": path, "max_abs_err": float((x_k - x_p).abs().max()),
              "max_rel_err": rel_err(x_k[:128], x_p[:128]), "equal_to_wide_kernel": same},
             ok and same)
    a, b = spd_systems(64, 400, 800)  # the wide kernel's packed triangle in device memory
    scratch = ck.spd_wide_launch_plan(64, 400, sm)
    x_k, x_p = spd_solve(a, b, plan=scratch), spd_solve_reference(a, b)
    held("spd_solve", "n400_scratch",
         {"scratch": scratch.scratch, "max_rel_err": rel_err(x_k, x_p),
          "max_abs_err": float((x_k - x_p).abs().max())},
         rel_err(x_k, x_p) < KERNEL_TOL)
    del a, b, x_k, x_p
    torch.cuda.empty_cache()

    # the users' bucket at rank 200, as ALS builds and solves it
    _, rows, k, n_tab = WIDE_BUCKETS[0]
    r = WIDE_ALS_RANK
    y, idx, w2, rhs, ridge = wide_bucket(torch, gen, dev, rows, k, n_tab, r)
    slices = ck.gramian_row_slices(rows, k, r, sm)
    keys = ("kernel", "earlier_kernel", "library")
    event = dict.fromkeys(keys, 0.0)
    device = dict.fromkeys(keys, 0.0)
    same, worst, worst_abs = True, 0.0, 0.0
    for s0, s1 in slices:
        a, b = gramian_fused(y, idx[s0:s1], w2[s0:s1], rhs[s0:s1], ridge[s0:s1])
        wide = ck.spd_wide_launch_plan(s1 - s0, r, sm)
        x_k = spd_solve(a, b)
        same = same and bool(torch.equal(x_k, spd_solve(a, b, plan=wide)))
        x_l = library(a, b)[:, :, 0]
        worst = max(worst, rel_err(x_k, x_l))
        worst_abs = max(worst_abs, float((x_k - x_l).abs().max()))
        del x_k, x_l
        for key, fn, iters in zip(keys, (lambda: spd_solve(a, b),
                                         lambda: spd_solve(a, b, plan=wide),
                                         lambda: library(a, b)), (3, 1, 2)):
            event[key] += time_ms(torch, fn, iters, 1)
            ms = traced_device_ms(torch, fn, iters)
            device[key] = None if ms is None or device[key] is None else device[key] + ms
        del a, b
        torch.cuda.empty_cache()
    # the solve of the whole bucket, its slices one after another; device
    # times null where a trace was short
    out = {"R": r, "B": rows, "K": k, "slices": len(slices),
           "plan": plan_line(ck.spd_launch_plan(slices[0][1] - slices[0][0], r, sm)),
           "equal_to_wide_kernel": same, "max_rel_err_vs_library": worst,
           "max_abs_err": worst_abs,
           **{f"{key}_ms": v for key, v in event.items()},
           **{f"{key}_device_ms": v for key, v in device.items()}}
    bound_ms, out["bound_by"] = spd_bound(rows, r)
    out["bound_us"] = bound_ms * 1e3
    held("spd_solve", "users_bucket_R200", out, same and worst < 1e-3)
    del y, idx, w2, rhs, ridge
    torch.cuda.empty_cache()


def wide_kernels(torch, dev, seed: int) -> dict:
    """The general-width paths against their plain versions: the build at
    R = 129, 200, 256 at both ML-20M bucket shapes (the users' bucket in
    the slices training cuts it into) and a split bucket, the solve at n =
    129, 200, 256 and on the cluster path (``wide_spd_cases``) with its
    edge cases, attention at D = 136, 192, 256
    causal and not on the resident path, at D = 320 causal and not and at
    D = 280 and 302 on the streamed path, a plan forcing the streamed path
    at D = 256 (``torch.equal`` to the resident kernel), at D = 384 and 512
    causal and not and at D = 330 and 502 on the wide streamed path, a plan
    forcing it at D = 320 (``torch.equal`` to the streamed kernel) and a
    doctored plan of it (refused with an error), at D = 576, 768 and 1,024
    causal and not and at D = 650 and 900 on the cluster path, plans
    forcing it at D = 384 and 512 (held to the plain version, beside the
    wide streamed kernel) and doctored plans of it (refused), and at
    WIDE_PASSES_HEAD on the passes path. Each kernel's registers and local
    bytes first (no local memory; the attention kernels' and the blocked
    solve's registers equal to their plan constants, the build's and the
    wide and cluster solves' within their launch bounds); each case prints
    its plan and its error, the timed ones the kernel's event and device
    time beside the plain version's, the library call's and the bound, and
    the resident and streamed cases the passes kernel's time on the same
    tensors (the wide streamed path's A B B A)."""
    from predictionio_tpu_torch.ops import cuda_kernels as ck
    from predictionio_tpu_torch.ops.cuda_kernels import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
        gramian_fused,
        gramian_fused_reference,
    )

    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    spd_attrs = ck.spd_kernel_attributes(dev)
    attrs = {"gramian_fused": {k: v for k, v in ck.gramian_kernel_attributes(dev).items()
                               if k.startswith(("wide", "rows"))},
             "spd_solve": {k: spd_attrs[k] for k in ("blocked", "wide")},
             "spd_solve_cluster": ck.spd_cluster_kernel_attributes(dev),
             "spd_solve_tiled": ck.spd_tiled_kernel_attributes(dev),
             "flash_attention": ck.flash_wide_kernel_attributes(dev),
             "flash_attention_resident": ck.flash_resident_kernel_attributes(dev),
             "flash_attention_streamed": ck.flash_streamed_kernel_attributes(dev),
             "flash_attention_wide_streamed": ck.flash_wide_streamed_kernel_attributes(dev),
             "flash_attention_cluster": ck.flash_cluster_kernel_attributes(dev)}
    flat = [*attrs["gramian_fused"].values(), *attrs["spd_solve"].values(),
            *attrs["spd_solve_cluster"].values(), *attrs["spd_solve_tiled"].values(),
            attrs["flash_attention"], *attrs["flash_attention_resident"].values(),
            attrs["flash_attention_streamed"], attrs["flash_attention_wide_streamed"],
            attrs["flash_attention_cluster"]]
    emit({"phase": "wide", "attributes": attrs})
    regs_ok = (all(attrs["gramian_fused"][k]["regs"] <= ck.GRAMIAN_WIDE_REGS
                   for k in ("wide_one_pass", "wide_split"))
               and all(attrs["gramian_fused"][k]["regs"] == regs
                       for k, regs in ck.GRAMIAN_ROWS_REGS.items())
               and attrs["spd_solve"]["wide"]["regs"] <= ck.SPD_WIDE_REGS
               and attrs["spd_solve"]["blocked"]["regs"] == ck.SPD_BLOCKED_REGS
               and all(-(-attrs["spd_solve_cluster"][f"cluster_c{c}"]["regs"] // 8) * 8 == regs
                       for c, regs in ck.SPD_CLUSTER_REGS.items())
               and all(-(-attrs["spd_solve_tiled"][k]["regs"] // 8) * 8 == regs
                       for k, regs in ck.SPD_TILED_REGS.items())
               and attrs["flash_attention"]["regs"] == ck.FLASH_WIDE_REGS
               and all(a["regs"] == ck.FLASH_WIDE_RES_REGS[g]
                       for g, a in attrs["flash_attention_resident"].items())
               and attrs["flash_attention_streamed"]["regs"] == ck.FLASH_STREAMED_REGS
               and attrs["flash_attention_wide_streamed"]["regs"]
               == ck.FLASH_WIDE_STREAMED_REGS
               and attrs["flash_attention_cluster"]["regs"] == ck.FLASH_CLUSTER_REGS)
    if any(a["local_bytes"] for a in flat) or not regs_ok:
        raise AssertionError(f"the general-width kernels take {attrs}")
    worst = {"gramian_fused": 0.0, "spd_solve": 0.0, "flash_attention": 0.0}
    cases = {}

    def held(name, case, out, ok):
        emit({"phase": "wide", "kernel": name, "case": case, **out})
        if not ok:
            raise AssertionError(f"{name} {case} disagrees with plain: {out}")
        worst[name] = max(worst[name], out["max_abs_err"])
        cases[f"{name}:{case}"] = out

    # the build, at both bucket shapes, every wide rank and the cluster
    # solve's ALS rank (the tile path)
    for r in (*WIDE_RANKS, WIDE_CLUSTER_ALS_RANK):
        for side, b, k, n in WIDE_BUCKETS:
            out, ok = gramian_wide_case(torch, dev, gen, sm, b, k, n, r)
            held("gramian_fused", f"{side}_R{r}", {"R": r, "side": side, **out}, ok)
    # a bucket of a few rows is split into chunks and reduced in chunk order
    y, idx, w2, rhs, ridge = wide_bucket(torch, gen, dev, 16, 8193, 5000, 200)
    w2[3], rhs[3], ridge[3] = 0.0, 0.0, 0.0
    yty = y.T @ y
    a_k, b_k = gramian_fused(y, idx, w2, rhs, ridge, yty)
    a_2, b_2 = gramian_fused(y, idx, w2, rhs, ridge, yty)
    a_p, b_p = gramian_fused_reference(y, idx, w2, rhs, ridge, yty)
    plan = ck.gramian_plan(16, 8193, 200, sm)
    a_t, b_t = gramian_fused(y, idx, w2, rhs, ridge, yty, plan=ck.gramian_wide_launch_plan(
        16, 8193, 200, sm, chunk=plan.chunk))
    tile_bits = bool(torch.equal(a_k, a_t) and torch.equal(b_k, b_t))
    ok = bool(torch.allclose(a_k, a_p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
              and torch.allclose(b_k, b_p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
              and torch.equal(a_k, a_k.transpose(1, 2)) and plan.n_chunks > 1
              and torch.equal(b_k[3], torch.zeros_like(b_k[3])) and plan.path == "rows"
              and torch.equal(a_k, a_2) and torch.equal(b_k, b_2) and tile_bits)
    held("gramian_fused", "split_R200_K8193", {
        "path": plan.path, "S": plan.n_chunks, "kc": plan.chunk,
        "equal_to_tile_kernel_at_kc": tile_bits,
        "max_abs_err": max(float((a_k - a_p).abs().max()), float((b_k - b_p).abs().max()))},
        ok)
    del y, idx, w2, rhs, ridge, yty, a_k, b_k, a_2, b_2, a_p, b_p, a_t, b_t

    wide_spd_cases(torch, dev, gen, sm, held)

    # attention
    import torch.nn.functional as F

    path_of = flash_path_of

    def attention_case(d, b, h, lq, lk, causal, timed=True):
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
        if plan.path == "cluster":
            out.update(flash_cluster_waves(ck, plan, dev, sm))
        if timed:
            kernel = lambda: flash_attention_fwd(q, k, v, causal)  # noqa: E731
            library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
            runs = [("kernel", kernel)]
            if plan.path != "passes":  # the passes kernel on the same tensors
                passes = ck.flash_wide_launch_plan(b, h, lq, lk, d, sm)
                earlier = lambda: flash_attention_fwd(q, k, v, causal, plan=passes)  # noqa: E731
                o_e = earlier()
                ok = ok and bool(torch.allclose(o_e, o_p, rtol=ATTN_RTOL, atol=ATTN_ATOL))
                out["earlier_max_abs_err"] = float((o_e - o_p).abs().max())
                del o_e
                runs.append(("earlier_kernel", earlier))
            runs.append(("library", library))
            if plan.path in ("wide_streamed", "cluster"):  # A B B A: the runs, then reversed
                runs += runs[::-1]
            for name, fn in runs:
                out.setdefault(f"{name}_runs_ms", []).append(time_ms(torch, fn, 10, 2))
                out.setdefault(f"{name}_runs_device_ms", []).append(
                    traced_device_ms(torch, fn, 10))
            for name, _ in runs:
                event, device = out[f"{name}_runs_ms"], out[f"{name}_runs_device_ms"]
                out[f"{name}_ms"] = sum(event) / len(event)
                out[f"{name}_device_ms"] = None if None in device else sum(device) / len(device)
            out["plain_ms"] = time_ms(
                torch, lambda: flash_attention_fwd_reference(q, k, v, causal), 3, 1)
            bound_ms, out["bound_by"] = flash_attention_bound(b, h, lq, lk, d, causal)
            out["bound_us"] = bound_ms * 1e3
            on_card = out["kernel_device_ms"]
            if on_card is not None:
                out["device_over_bound"] = on_card / bound_ms
                for key in ("library", "earlier_kernel"):
                    if out.get(f"{key}_device_ms"):
                        out[f"device_over_{key}"] = on_card / out[f"{key}_device_ms"]
        shape = f"{b}x{h}x{lq}" if timed else f"{b}x{h}x{lq}x{lk}"
        held("flash_attention", f"D{d}_{shape}_causal_{causal}", out,
             ok and out["bit_identical"] and launched == 1 and plan.path == path_of(d))

    def forced_below(path, d, b, h, lq, lk, causal, bits=True):
        """A plan forcing a streamed ``path`` at a width below it: the bits
        of the kernel the width's own plan takes (held equal unless ``bits``
        is false: the cluster path sums a score in two halves), and both
        kernels' and SDPA's times on the same tensors."""
        q, k, v = (torch.randn((b, h, n_, d), generator=gen, device=dev)
                   for n_ in (lq, lk, lk))
        forced = getattr(ck, f"flash_{path}_launch_plan")(
            b, h, lq, lk, d, sm, attrs[f"flash_attention_{path}"]["regs"])
        o_r = flash_attention_fwd(q, k, v, causal)
        o_s = flash_attention_fwd(q, k, v, causal, plan=forced)
        o_p = flash_attention_fwd_reference(q, k, v, causal)
        forced_fn = lambda: flash_attention_fwd(q, k, v, causal, plan=forced)  # noqa: E731
        own = lambda: flash_attention_fwd(q, k, v, causal)  # noqa: E731
        out = {"D": d, "B": b, "H": h, "Lq": lq, "Lk": lk, "causal": causal,
               "plan": flash_plan_line(forced), "own_path": path_of(d),
               "max_abs_err": float((o_s - o_p).abs().max()),
               "equal_to_own_kernel": bool(torch.equal(o_s, o_r)),
               "forced_ms": time_ms(torch, forced_fn, 10, 2),
               "forced_device_ms": traced_device_ms(torch, forced_fn, 10),
               "own_ms": time_ms(torch, own, 10, 2),
               "own_device_ms": traced_device_ms(torch, own, 10)}
        library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
        out.update(library_ms=time_ms(torch, library, 10, 2),
                   library_device_ms=traced_device_ms(torch, library, 10))
        held("flash_attention", f"D{d}_forced_{path}_{b}x{h}x{lq}_causal_{causal}", out,
             (out["equal_to_own_kernel"] or not bits)
             and bool(torch.allclose(o_s, o_p, rtol=ATTN_RTOL, atol=ATTN_ATOL)))

    for d in WIDE_HEADS:
        for shape in WIDE_ATTN_SHAPES:
            attention_case(d, *shape)
    for shape in WIDE_ATTN_SHAPES:
        attention_case(WIDE_STREAMED_HEAD, *shape)
    for d in (*WIDE_STREAMED_CHECKS, *WIDE_WS_CHECKS):
        for shape in WIDE_CHECK_SHAPES:
            attention_case(d, *shape, timed=False)
    for shape in WIDE_ATTN_SHAPES[:2]:
        forced_below("streamed", 256, *shape)
    for d in WIDE_WS_HEADS:
        for shape in WIDE_ATTN_SHAPES:
            attention_case(d, *shape)
    for shape in WIDE_ATTN_SHAPES[:2]:
        forced_below("wide_streamed", WIDE_STREAMED_HEAD, *shape)
    for d in WIDE_CLUSTER_HEADS:
        for shape in WIDE_ATTN_SHAPES:
            attention_case(d, *shape)
    for d in WIDE_CLUSTER_CHECKS:
        for shape in WIDE_CHECK_SHAPES:
            attention_case(d, *shape, timed=False)
    for d in WIDE_WS_HEADS:  # for information: the wide streamed kernel beside it
        for shape in WIDE_ATTN_SHAPES[:2]:
            forced_below("cluster", d, *shape, bits=False)
    # a plan off the C entry's arithmetic must raise: the wide streamed
    # path's shared memory, the cluster path's shared memory and its slices
    from predictionio_tpu_torch.kernels import build

    for d, field in ((WIDE_WS_HEADS[0], "smem"), (WIDE_CLUSTER_HEADS[0], "smem"),
                     (WIDE_CLUSTER_HEADS[0], "slices")):
        q = torch.randn((1, 1, 64, d), generator=gen, device=dev)
        plan = ck.flash_plan_for(q, q, True)
        doctored = (plan._replace(smem=plan.smem + 16) if field == "smem" else
                    plan._replace(slices=(plan.slices[0] + 8, plan.slices[1] - 8)))
        try:
            flash_attention_fwd(q, q, q, True, plan=doctored)
            refused = False
        except build.KernelLaunchError:
            refused = True
        held("flash_attention", f"D{d}_doctored_{field}",
             {"max_abs_err": 0.0, "refused": refused, "plan": flash_plan_line(doctored)},
             refused and plan.path == path_of(d))
    for shape in WIDE_PASSES_SHAPES:
        attention_case(WIDE_PASSES_HEAD, *shape)
    return {"cases": cases, "max_abs_err": worst, "attributes": attrs}


def flash_path_of(d: int) -> str:
    """The attention path a head of width ``d`` > FLASH_MAX_D takes."""
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    return ("resident" if d <= ck.FLASH_WIDE_RES_MAX_D else
            "streamed" if d <= ck.FLASH_STREAMED_MAX_D else
            "wide_streamed" if d <= ck.FLASH_WIDE_STREAMED_MAX_D else
            "cluster" if d <= ck.FLASH_CLUSTER_MAX_D else "passes")


def flash_path_times(torch, dev, seed: int = 0) -> None:
    """The tuned and resident attention paths alone at their timed shapes
    (D = 16 and 64, and WIDE_HEADS, at WIDE_ATTN_SHAPES), each through the
    plan ``flash_plan_for`` picks: the plan, the registers of the kernels
    the plans read, and the event and device ms. It uses only what the
    package has had since it gained the resident path, so it times an
    older tree too: from that tree's root, load this file by path
    (``importlib.util.spec_from_file_location``) and call it there, A B B A
    with this tree."""
    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    build.build_all(["flash_attention"])
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    tree = os.path.basename(os.getcwd())
    emit({"phase": "flash_path_times", "tree": tree, "regs": {
        "tuned": {f"D{d}_bq{bq}": a["regs"] for (d, bq), a in ck.flash_kernel_attributes(dev).items()
                  if d in (16, 64)},
        "resident": {g: a["regs"] for g, a in ck.flash_resident_kernel_attributes(dev).items()}}})
    for d in (16, 64, *WIDE_HEADS):
        for b, h, lq, lk, causal in WIDE_ATTN_SHAPES:
            q, k, v = (torch.randn((b, h, n_, d), generator=gen, device=dev)
                       for n_ in (lq, lk, lk))
            plan = ck.flash_plan_for(q, k, causal)
            kernel = lambda: ck.flash_attention_fwd(q, k, v, causal)  # noqa: E731
            emit({"phase": "flash_path_times", "tree": tree, "D": d, "B": b, "L": lq,
                  "causal": causal, "path": getattr(plan, "path", "tuned"), "bq": plan.bq,
                  "smem": plan.smem, "blocks_per_sm": plan.blocks_per_sm,
                  "ms": time_ms(torch, kernel, 10, 2),
                  "device_ms": traced_device_ms(torch, kernel, 10)})
            del q, k, v


#: the streamed paths' cases alone (``flash_streamed_variants``): (D, shapes)
#: on the path, the last a width below it, where the path is held bit for bit
#: to the kernel the width's own plan takes
FLASH_VARIANT_CASES = {
    "streamed": ((WIDE_STREAMED_HEAD, WIDE_ATTN_SHAPES), (256, WIDE_ATTN_SHAPES[:2])),
    "wide_streamed": (*((d, WIDE_ATTN_SHAPES) for d in WIDE_WS_HEADS),
                      (WIDE_STREAMED_HEAD, WIDE_ATTN_SHAPES[:2])),
    "cluster": (*((d, WIDE_ATTN_SHAPES) for d in WIDE_CLUSTER_HEADS),
                *((d, WIDE_CHECK_SHAPES) for d in WIDE_CLUSTER_CHECKS),
                *((d, WIDE_ATTN_SHAPES[:2]) for d in WIDE_WS_HEADS)),
}


def flash_streamed_variants(torch, dev, seed: int = 0, path: str = "streamed",
                            cases=None) -> None:
    """A streamed path (``path``: "streamed", 272 < D <= 320,
    "wide_streamed", 320 < D <= FLASH_WIDE_STREAMED_MAX_D, or "cluster",
    FLASH_WIDE_STREAMED_MAX_D < D <= FLASH_CLUSTER_MAX_D) alone at its
    FLASH_VARIANT_CASES (or ``cases``): the kernel's attributes (and, for the
    cluster path, the plan's clusters at once beside the card's), then at each shape its
    answer against the plain version and against the other kernel (the one
    the width's own plan takes, else the passes kernel), the event and
    device ms of both and of SDPA on the same tensors (SDPA, other, path,
    path, other, SDPA), the plain version's event ms and the bound; the
    last width, below the path's, is held bit for bit to its own kernel.
    Builds only the attention library. To compare two kernel versions in
    one call, unpack the other tree under ``chip_compare/`` (gitignored) and
    run this in each: the inputs come from the seed, so both see the same
    tensors."""
    import torch.nn.functional as F

    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck
    from predictionio_tpu_torch.ops.cuda_kernels import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    build.build_all(["flash_attention"])
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    attrs = getattr(ck, f"flash_{path}_kernel_attributes")(dev)
    launch_plan = getattr(ck, f"flash_{path}_launch_plan")
    tree = os.path.basename(os.getcwd())
    phase = f"flash_{path}_variant"
    emit({"phase": phase, "tree": tree, "attributes": attrs})
    for d, shapes in cases or FLASH_VARIANT_CASES[path]:
        for b, h, lq, lk, causal in shapes:
            q, k, v = (torch.randn((b, h, n_, d), generator=gen, device=dev)
                       for n_ in (lq, lk, lk))
            plan = launch_plan(b, h, lq, lk, d, sm, attrs["regs"])
            if path == "cluster":
                emit({"phase": phase, "tree": tree, "D": d, "B": b, "L": lq,
                      **flash_cluster_waves(ck, plan, dev, sm)})
            other = ck.flash_plan_for(q, k, causal)
            if other.path == path:
                other = ck.flash_wide_launch_plan(b, h, lq, lk, d, sm)
            o_s = flash_attention_fwd(q, k, v, causal, plan=plan)
            o_o = flash_attention_fwd(q, k, v, causal, plan=other)
            o_p = flash_attention_fwd_reference(q, k, v, causal)
            kernel = lambda: flash_attention_fwd(q, k, v, causal, plan=plan)  # noqa: E731
            earlier = lambda: flash_attention_fwd(q, k, v, causal, plan=other)  # noqa: E731
            library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
            bound_ms, bound_by = flash_attention_bound(b, h, lq, lk, d, causal)
            line = {"phase": phase, "tree": tree, "D": d, "B": b, "H": h,
                    "L": lq, "causal": causal, "other": other.path,
                    "max_abs_err": float((o_s - o_p).abs().max()),
                    "held": bool(torch.allclose(o_s, o_p, rtol=ATTN_RTOL, atol=ATTN_ATOL)),
                    "bit_identical": bool(torch.equal(o_s, kernel())),
                    "equal_to_other": bool(torch.equal(o_s, o_o)),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "plain_ms": time_ms(
                        torch, lambda: flash_attention_fwd_reference(q, k, v, causal), 3, 1)}
            order = (("library", library), ("other", earlier), (path, kernel),
                     (path, kernel), ("other", earlier), ("library", library))
            for name, fn in order:
                line.setdefault(f"{name}_ms", []).append(time_ms(torch, fn, 10, 2))
                line.setdefault(f"{name}_device_ms", []).append(traced_device_ms(torch, fn, 10))
            emit(line)
            del q, k, v, o_s, o_o, o_p


#: the streamed kernel's phases as the knock-outs cut them: pairs of text
#: of its body and what replaces it (a knock-out's answer is wrong; only its
#: time counts)
FLASH_STREAMED_PHASES = {
    "chunk_copies": [("const int j = n / steps, r = n - j * steps;",
                      "return;\n      const int j = n / steps, r = n - j * steps;")],
    "qk_fmas": [("= fmaf(qv[i].", "= (qv[i].")],
    "softmax_exps": [("expf(", "(")],
    "pv_fmas": [("= fmaf(pv[i][u]", "= (pv[i][u]")],
    "barriers": [("__syncthreads();\n    issue(", "issue(")],
}
#: variants of the streamed kernel tried against it in one call, the same
#: way (text outside its body, such as kSStages, is replaced in the file):
#: the chunks copied two ahead, and the QK^T and PV loops unrolled by 4
FLASH_STREAMED_TRIALS = {
    "stages3": [("constexpr int kSStages = 2;", "constexpr int kSStages = 3;")],
    "unroll4": [("#pragma unroll 2", "#pragma unroll 4")],
    "stages3_unroll4": [("constexpr int kSStages = 2;", "constexpr int kSStages = 3;"),
                        ("#pragma unroll 2", "#pragma unroll 4")],
}
#: variants of the wide streamed kernel tried against it the same way: V's
#: chunks 64 columns wide (each probability loaded once a column group),
#: K's 128 (half the barriers of K), and the QK^T and PV loops not unrolled
FLASH_WIDE_STREAMED_TRIALS = {
    "v64": [("constexpr int kWSVChunk = 128;", "constexpr int kWSVChunk = 64;")],
    "k128": [("constexpr int kWSKChunk = 64;", "constexpr int kWSKChunk = 128;")],
    "s_unroll1": [("#pragma unroll 2\n      for (int x = 0;",
                   "#pragma unroll 1\n      for (int x = 0;")],
    "pv_unroll1": [("#pragma unroll 2\n      for (int kk = 0;",
                    "#pragma unroll 1\n      for (int kk = 0;")],
}
#: the cluster kernel's phases as the knock-outs cut them: the stores of
#: the partials into the partner's memory, the barrier phase that publishes
#: them, every cluster barrier of the tile loop (a full cluster barrier is
#: kept at the start and the end, so neither block stores into a partner
#: that has not started or has left), and the arithmetic as for the
#: streamed kernels
FLASH_CLUSTER_PHASES = {
    "exchange_stores": [('asm volatile("st.shared::cluster.f32', 'if (0) asm volatile("st.shared::cluster.f32')],
    "publish_barrier": [("cluster_arrive();\n    cluster_wait();", "")],
    "cluster_barriers": [
        ("cluster_arrive();\n    cluster_wait();", ""),
        ("cluster_wait();\n    // the places the partner's", "// the places the partner's"),
        ("cluster_arrive();  // this thread is done with s_p for this tile", ""),
        ("cluster_arrive();  // this block has started",
         "cluster_arrive();\n  cluster_wait();  // this block has started"),
        ("cluster_wait();  // neither block leaves",
         "cluster_arrive();\n  cluster_wait();  // neither block leaves")],
    "qk_fmas": FLASH_STREAMED_PHASES["qk_fmas"],
    "pv_fmas": FLASH_STREAMED_PHASES["pv_fmas"],
    "block_barriers": FLASH_STREAMED_PHASES["barriers"],
}
#: variants of the cluster kernel tried against it the same way: the
#: partials exchanged through a buffer of their own (64 x 68 floats more a
#: block, so the reuse phase's arrive comes right after the read; it fits
#: to D = 992), and V's chunks 64 columns wide
FLASH_CLUSTER_TRIALS = {
    "own_buffer": [
        ("return ws_smem_floats(cl_slice0(d));",
         "return ws_smem_floats(cl_slice0(d)) + kWSRows * kRPStride;"),
        ("float* s_l = s_corr + kWSRows;                     // [kWSRows]: l after the last tile",
         "float* s_l = s_corr + kWSRows;\n  float* s_x = s_l + kWSRows;"),
        ("cluster_map(s_p + s_row0", "cluster_map(s_x + s_row0"),
        ("s[i][t] = __fadd_rn(s[i][t], s_p[", "s[i][t] = __fadd_rn(s[i][t], s_x["),
        ("    // the masks, the row's max and sum over its 16 threads (a thread's keys",
         "    cluster_arrive();\n    // the masks, the row's max and sum over its 16 threads"),
        ("cluster_arrive();  // this thread is done with s_p for this tile", ""),
        ("cl_smem_floats(kCMaxD) * 4 <= kMaxSmem", "cl_smem_floats(992) * 4 <= kMaxSmem")],
    "v64": FLASH_WIDE_STREAMED_TRIALS["v64"],
}
#: what the knock-outs need of each streamed path: its kernel's first line
#: and the line that follows its body, and the heads they time
FLASH_KNOCKOUT_PATHS = {
    "streamed": ("flash_attention_streamed_kernel(const", "\nstatic_assert(kSRows",
                 (WIDE_STREAMED_HEAD,)),
    "wide_streamed": ("flash_attention_wide_streamed_kernel(const", "\nstatic_assert(kWSRows",
                      WIDE_WS_HEADS),
    "cluster": ("flash_attention_cluster_kernel(const", "\nstatic_assert(kCBlocks",
                WIDE_CLUSTER_HEADS[:2]),
}


def _knockout_smem(src: str, path: str, d: int) -> int:
    """A streamed path's shared memory at head width ``d`` as the build of
    ``src`` (a variant of the .cu) computes it, from that source's own
    stages and chunk widths."""
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    w = -(-d // 8) * 8
    if path == "cluster":  # the wider slice, and a buffer of the partials' own if it has one
        w = -(-(w // 2) // 8) * 8
    rows_floats = 64 * (w + 4) + 64 * 68 + 2 * 64  # Q, P and the row vectors
    if path == "streamed":
        return 4 * (rows_floats + const("kSStages") * 64 * (const("kSChunk") + 4))
    if path == "cluster" and "ws_smem_floats(cl_slice0(d)) + kWSRows * kRPStride;" in src:
        rows_floats += 64 * 68
    chunk = max(const("kWSKChunk"), const("kWSVChunk")) + 4
    return 4 * (rows_floats + const("kWSStages") * 64 * chunk)


def flash_streamed_knockouts(torch, dev, source: str = FLASH_SOURCE,
                             variants: dict = FLASH_STREAMED_PHASES,
                             path: str = "streamed", heads=None, shapes=None,
                             abba: bool = False) -> None:
    """Where a streamed path's kernel's time goes (``path``: "streamed",
    "wide_streamed" or "cluster"; ``heads`` and ``shapes`` override the
    path's heads and WIDE_ATTN_SHAPES; ``abba`` times the builds in order
    and then in reverse): ``source`` built as it is and once for each of
    ``variants`` (FLASH_STREAMED_PHASES cuts a phase; text found in the
    kernel's body is replaced there only), all with ``nvcc -Xptxas -v`` at
    once, then each launched through its own ``pio_flash_attention_<path>``
    at the path's heads (FLASH_KNOCKOUT_PATHS) and the shapes of
    WIDE_ATTN_SHAPES (CUDA events, and whether its answer equals the whole
    kernel's bit for bit). A knock-out's time less the whole kernel's is
    what that phase costs where nothing hides it. Prints each build's
    registers and spills."""
    import ctypes

    from predictionio_tpu_torch.kernels import build
    from predictionio_tpu_torch.ops import cuda_kernels as ck

    first, after, heads = FLASH_KNOCKOUT_PATHS[path] if heads is None else (
        *FLASH_KNOCKOUT_PATHS[path][:2], heads)
    entry = f"pio_flash_attention_{path}"
    text = open(source).read()
    start = text.index(first)
    end = text.index(after, start)
    sources = {"whole": text}
    for name, pairs in variants.items():
        src = text
        for old, new in pairs:
            body = src[start:end]
            if old in body:
                src = src[:start] + body.replace(old, new) + src[end:]
            elif old in src:
                src = src.replace(old, new)
            else:
                raise AssertionError(f"variant {name}: {old!r} is not in {source}")
            end = src.index(after, start)
        sources[name] = src
        end = text.index(after, start)
    tmp = tempfile.mkdtemp(prefix="flash_knockouts_")
    procs = {}
    for name, src in sources.items():
        path_cu = os.path.join(tmp, f"{name}.cu")
        with open(path_cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, f"lib{name}.so"), path_cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise AssertionError(f"variant {name} did not build: {log[-2000:]}")
        kernel_log = log[log.index(first.split("(")[0]):]
        emit({"phase": "flash_streamed_knockout", "path": path, "variant": name,
              "ptxas": re.findall(r"(\d+ bytes spill stores|Used \d+ registers)",
                                  kernel_log)[:2]})
        lib = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so"))
        getattr(lib, entry).argtypes = ck._EXTRA_ENTRIES["flash_attention"][entry]
        libs[name] = lib
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(21)
    launch_plan = getattr(ck, f"flash_{path}_launch_plan")
    for d in heads:
        for b, h, lq, lk, causal in shapes or WIDE_ATTN_SHAPES:
            q, k, v = (torch.randn((b, h, n_, d), generator=gen, device=dev)
                       for n_ in (lq, lk, lk))
            plan = launch_plan(b, h, lq, lk, d, sm, getattr(ck, f"FLASH_{path.upper()}_REGS"))
            launches, outs = {}, {}
            for name, lib in libs.items():
                o = torch.empty_like(q)
                smem = _knockout_smem(sources[name], path, d)
                # the cluster entry also takes the cluster size and the slices
                shape_args = ((plan.threads, plan.cluster, *plan.slices, smem)
                              if path == "cluster" else (plan.threads, smem))

                def launch(lib=lib, o=o, shape_args=shape_args, name=name):
                    code = getattr(lib, entry)(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, lq,
                        lk, d, int(causal), *shape_args, plan.blocks,
                        torch.cuda.current_stream(dev).cuda_stream)
                    if code:
                        raise AssertionError(f"variant {name} failed to launch: {code}")
                launches[name], outs[name] = launch, o
            runs = {}
            for name in [*libs, *reversed(libs)] if abba else libs:
                runs.setdefault(name, []).append(time_ms(torch, launches[name], 10, 2))
            times = {name: sum(t) / len(t) for name, t in runs.items()}
            emit({"phase": "flash_streamed_knockout", "path": path, "D": d, "B": b, "L": lq,
                  "causal": causal, "ms": times, **({"runs_ms": runs} if abba else {}),
                  "phase_ms": {k_: times["whole"] - t for k_, t in times.items()
                               if k_ != "whole"},
                  "equal_to_whole": {k_: bool(torch.equal(o_, outs["whole"]))
                                     for k_, o_ in outs.items() if k_ != "whole"}})
            del q, k, v, outs
    shutil.rmtree(tmp, ignore_errors=True)


def seq_burst(torch, dev, port: int, seq_model, seq_params, rng, launch_count=None,
              n_queries: int = HTTP_QUERIES) -> dict:
    """A burst of ``n_queries`` concurrent seqrec queries (by user, and
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
        rng.choice(seq_users, size=n_queries - 2, replace=False))]
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


def als_wide(torch, dev, registry, source, rank: int, iterations: int = PARITY_ITERS) -> dict:
    """ALS at ``rank`` over the events phase's store, trained by
    ``run_train`` (``iterations``; build and solve launches, in all and by
    path, reset just before and read just after) and held to as many
    iterations of the plain build and solve, with its holdout RMSE (the
    same iterations through the kernels on 95 % of the ratings). Every build
    must take the build's path at this rank and every solve the solve's."""
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import cuda_kernels as ck
    from predictionio_tpu_torch.ops.cuda_kernels import gramian_fused, spd_solve
    from predictionio_tpu_torch.workflow import WorkflowContext, load_models, run_train

    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    build_path = ck.gramian_plan(1, 128, rank, sm).path
    solve_path = ck.spd_launch_plan(1, rank, sm).path
    params = rec.ALSAlgorithmParams(rank=rank, num_iterations=iterations,
                                    lambda_=LAMBDA, seed=TRAIN_SEED)
    gramian_fused.launches = spd_solve.launches = 0  # main path starts here
    for by_path in (gramian_fused.launches_by_path, spd_solve.launches_by_path):
        by_path.update(dict.fromkeys(by_path, 0))
    t = time.monotonic()
    instance = run_train(rec.engine_factory(),
                         EngineParams(data_source_params=source,
                                      algorithm_params_list=[("als", params)]),
                         registry, engine_id=f"wide-als-{rank}", ctx=WorkflowContext(device=dev))
    seconds = time.monotonic() - t
    launches = {"gramian_fused": gramian_fused.launches,
                f"gramian_{build_path}": gramian_fused.launches_by_path[build_path],
                "spd_solve": spd_solve.launches,
                f"spd_{solve_path}": spd_solve.launches_by_path[solve_path]}  # main path ends here
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
    out = {"instance": instance, "rank": rank, "iterations": iterations,
           "build_path": build_path, "solve_path": solve_path, "launches": launches,
           "holdout_rmse": holdout, "train_rmse": train_rmse, **against}
    emit({"phase": "wide", "stage": f"als_rank{rank}", **out, "seconds": seconds})
    ok = (against["first_user_solve"]["beyond_tol"] == 0
          and all(against[s]["finite"] and against[s]["beyond_tol"] == 0
                  for s in ("user", "item"))
          and min(launches.values()) >= 2 * iterations
          and launches[f"gramian_{build_path}"] == launches["gramian_fused"]
          and launches[f"spd_{solve_path}"] == launches["spd_solve"]
          and np.isfinite(holdout))
    if not ok:
        raise AssertionError(f"ALS at rank {rank}: {out}")
    return {**out, "seconds": seconds}


def phase_wide(torch, dev, seed: int, base: str) -> dict:
    """The general-width paths: :func:`wide_kernels`, then over the events
    phase's store :func:`als_wide` at rank 200 (the build's rows path, the
    blocked solve), at rank 384 (the build's tile path, the cluster solve)
    and at rank 1,024 (the tile path, the tiled solve; WIDE_TILED_ALS_ITERS
    iterations), and seqrec by :func:`seqrec_wide` at d_model 256 / 1 head (D =
    256, the resident path; 20 steps, 64 queries), at d_model 320 / 1 head
    (D = 320, the streamed path; 10 steps, 16 queries), at d_model 384 / 1
    head (D = 384, the wide streamed path; 10 steps, 16 queries) and at
    d_model 768 / 1 head (D = 768, the cluster path; 10 steps, 16 queries,
    then :func:`seqrec_parity`'s 3 steps against the plain attention)."""
    from predictionio_tpu_torch.models import recommendation as rec

    t0 = time.monotonic()
    kernels = wide_kernels(torch, dev, seed)
    seconds = {"kernels": time.monotonic() - t0}
    rng = np.random.default_rng(seed + 13)
    source = ("", rec.RecDataSourceParams(app_id=EVENTS_APP, event_names=("rate",)))
    with events_store(base) as registry:
        t0 = time.monotonic()
        als_out = als_wide(torch, dev, registry, source, WIDE_ALS_RANK)
        t1 = time.monotonic()
        als_cluster = als_wide(torch, dev, registry, source, WIDE_CLUSTER_ALS_RANK)
        t2 = time.monotonic()
        als_tiled = als_wide(torch, dev, registry, source, WIDE_TILED_ALS_RANK,
                             WIDE_TILED_ALS_ITERS)
        seconds.update(als=t1 - t0, als_rank384=t2 - t1, als_rank1024=time.monotonic() - t2)
        seq_out = seqrec_wide(torch, dev, registry, rng, WIDE_SEQ, EVENTS_SEQ_STEPS,
                              HTTP_QUERIES, "wide-seqrec")
        seq_streamed = seqrec_wide(torch, dev, registry, rng, WIDE_SEQ_STREAMED,
                                   WIDE_SEQ_STREAMED_STEPS, WIDE_SEQ_STREAMED_QUERIES,
                                   "wide-seqrec-d320")
        seq_ws = seqrec_wide(torch, dev, registry, rng, WIDE_SEQ_WS, WIDE_SEQ_STREAMED_STEPS,
                             WIDE_SEQ_STREAMED_QUERIES, "wide-seqrec-d384")
        seq_cluster = seqrec_wide(torch, dev, registry, rng, WIDE_SEQ_CLUSTER,
                                  WIDE_SEQ_STREAMED_STEPS, WIDE_SEQ_STREAMED_QUERIES,
                                  "wide-seqrec-d768")
        t0 = time.monotonic()
        parity = seqrec_parity(torch, dev, WIDE_SEQ_CLUSTER)
        seconds["seqrec_d768_parity"] = time.monotonic() - t0
    seconds.update(als_run_train=als_out["seconds"],
                   als_rank384_run_train=als_cluster["seconds"],
                   als_rank1024_run_train=als_tiled["seconds"],
                   seqrec_run_train=seq_out["train_s"],
                   seqrec_d320_run_train=seq_streamed["train_s"],
                   seqrec_d320_serve=seq_streamed["serve_s"],
                   seqrec_d384_run_train=seq_ws["train_s"],
                   seqrec_d384_serve=seq_ws["serve_s"],
                   seqrec_d768_run_train=seq_cluster["train_s"],
                   seqrec_d768_serve=seq_cluster["serve_s"])
    runs = (als_out["launches"], als_cluster["launches"], als_tiled["launches"])
    out = {"phase": "wide", "kernels": kernels, "als": als_out, "als_rank384": als_cluster,
           "als_rank1024": als_tiled,
           "seqrec": seq_out, "seqrec_d320": seq_streamed, "seqrec_d384": seq_ws,
           "seqrec_d768": seq_cluster, "seqrec_d768_parity": parity,
           "seconds": seconds, "by_kernel": {
               "gramian_fused": sum(x["gramian_fused"] for x in runs),
               "gramian_rows": als_out["launches"]["gramian_rows"],
               "spd_solve": sum(x["spd_solve"] for x in runs),
               "spd_cluster": als_cluster["launches"]["spd_cluster"],
               "spd_tiled": als_tiled["launches"]["spd_tiled"],
               "gramian_wide": (als_cluster["launches"]["gramian_wide"]
                                + als_tiled["launches"]["gramian_wide"]),
               "flash_attention": sum(sum(x["launches"].values())
                                      for x in (seq_out, seq_streamed, seq_ws, seq_cluster)),
               "flash_attention_streamed": sum(seq_streamed["path_launches"].values()),
               "flash_attention_wide_streamed": sum(seq_ws["path_launches"].values()),
               "flash_attention_cluster": sum(seq_cluster["path_launches"].values())}}
    emit({k: v for k, v in out.items() if k != "kernels"})
    return out


def seqrec_parity(torch, dev, shape: dict, steps: int = SEQ_PARITY_STEPS) -> dict:
    """``steps`` training steps of seqrec at ``shape`` over the events
    phase's store (the process-wide registry), through the attention kernel
    and through the plain attention, each from the one seeded init: the
    ``embed`` and ``pos`` weights and the logits of a fixed batch held at
    seqrec's tolerance (rtol SEQ_TRAIN_RTOL, atol SEQ_TRAIN_ATOL). The
    margin is the largest |kernel - plain| over its allowance (atol + rtol
    · |plain|): below 1 it holds. Every kernel launch must be on the path
    the head width takes."""
    from predictionio_tpu_torch.models import sequencerec as seq
    from predictionio_tpu_torch.ops.attention import flash_attention
    from predictionio_tpu_torch.ops.cuda_kernels import flash_attention_fwd

    head = shape["d_model"] // shape["n_heads"]
    path = flash_path_of(head)
    td = seq.SeqDataSource(seq.SeqDataSourceParams(app_id=EVENTS_APP,
                                                    event_names=("rate",))).read_training(None)
    pd = seq.SeqPreparator(seq.SeqPreparatorParams(seq_len=SEQ_LEN,
                                                   window_stride=SEQ_STRIDE)).prepare(None, td)
    params = seq.SeqRecAlgorithmParams(**dict(SEQ_PARAMS, **shape, steps=steps))
    fixed = torch.from_numpy(np.ascontiguousarray(pd.windows[-params.batch_size:, :-1])).to(dev)
    runs, launches = {}, {}
    for name, fn in (("kernel", None), ("plain", flash_attention)):
        by_path = flash_attention_fwd.launches_by_path
        flash_attention_fwd.launches = by_path[path] = 0
        t = time.monotonic()
        trained = seq.train_transformer(pd, params, dev, attention_fn=fn)
        with torch.no_grad():
            logits = trained(fixed, attention_fn=fn)
        torch.cuda.synchronize()
        launches[name] = (flash_attention_fwd.launches, by_path[path])
        runs[name] = (dict(seq._leaves(trained.to_numpy())), logits.cpu().numpy(),
                      time.monotonic() - t)
    (wk, lk, kernel_s), (wp, lp, plain_s) = runs["kernel"], runs["plain"]

    def margin(got, want):
        return float(np.max(np.abs(got - want) / (SEQ_TRAIN_ATOL + SEQ_TRAIN_RTOL * np.abs(want))))

    margins = {"logits": margin(lk, lp), **{n: margin(wk[n], wp[n]) for n in ("embed", "pos")}}
    want = params.n_layers * (steps + 1)  # a forward a step, and the fixed batch's
    out = {"head_width": head, "path": path, "steps": steps, "windows": int(pd.windows.shape[0]),
           "margin": max(margins.values()), "margins": margins,
           "max_abs_diff": {"logits": float(np.abs(lk - lp).max()),
                            **{n: float(np.abs(wk[n] - wp[n]).max()) for n in wk}},
           "launches": {"kernel": launches["kernel"], "plain": launches["plain"]},
           "kernel_s": kernel_s, "plain_s": plain_s}
    out["agree"] = out["margin"] < 1.0 and launches["kernel"] == (want, want) \
        and launches["plain"] == (0, 0)
    emit({"phase": "wide", "stage": f"seqrec_d{head}_parity", **out})
    if not out["agree"]:
        raise AssertionError(f"seqrec at D = {head}: kernel and plain training disagree: {out}")
    return out


def seqrec_wide(torch, dev, registry, rng, shape: dict, steps: int, queries: int,
                engine_id: str) -> dict:
    """Seqrec at a wide head over the events phase's store: trained by
    ``run_train`` for ``steps`` steps and served for a burst of ``queries``
    held to the plain forward (the same items in the same order). The
    attention launches of each, reset just before and read just after, in
    all and on the path the head width takes, must be ``n_layers`` a step
    and a forward."""
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models import sequencerec as seq
    from predictionio_tpu_torch.ops.cuda_kernels import flash_attention_fwd
    from predictionio_tpu_torch.workflow import (
        ServerConfig,
        WorkflowContext,
        create_query_server,
        load_models,
        run_train,
    )

    head = shape["d_model"] // shape["n_heads"]
    path = flash_path_of(head)
    seq_params = seq.SeqRecAlgorithmParams(**dict(SEQ_PARAMS, **shape, steps=steps))
    seq_ep = EngineParams(
        data_source_params=("", seq.SeqDataSourceParams(app_id=EVENTS_APP,
                                                         event_names=("rate",))),
        preparator_params=("", seq.SeqPreparatorParams(seq_len=SEQ_LEN,
                                                       window_stride=SEQ_STRIDE)),
        algorithm_params_list=[("transformer", seq_params)])
    by_path = flash_attention_fwd.launches_by_path
    flash_attention_fwd.launches = by_path[path] = 0  # main path starts here
    t = time.monotonic()
    instance = run_train(seq.engine_factory(), seq_ep, registry, engine_id=engine_id,
                         ctx=WorkflowContext(device=dev))
    train_s = time.monotonic() - t
    launches = {"run_train": flash_attention_fwd.launches}  # main path ends here
    path_launches = {"run_train": by_path[path]}
    (model,) = load_models(registry, instance)
    server = create_query_server(
        seq.engine_factory(), ServerConfig(ip="127.0.0.1", port=0, device=dev,
                                           engine_instance_id=instance),
        registry=registry, block=False)
    try:
        by_path[path] = 0  # the burst's main path starts here (seq_burst resets the total)
        t = time.monotonic()
        burst = seq_burst(torch, dev, server.bound_port, model, seq_params, rng,
                          n_queries=queries)
        serve_s = time.monotonic() - t
        path_launches["serve"] = by_path[path]  # and ends here
    finally:
        server.shutdown()
        server.server_close()
    launches["serve"] = burst["launches"]
    n_layers = seq_params.n_layers
    out = {"instance": instance, "head_width": head, "path": path, "steps": steps,
           **{k: burst[k] for k in ("served", "forwards", "wrong")},
           "launches": launches, "path_launches": path_launches,
           "train_s": train_s, "serve_s": serve_s}
    emit({"phase": "wide", "stage": f"seqrec_d{head}", **out})
    want = {"run_train": n_layers * steps, "serve": n_layers * burst["forwards"]}
    if burst["bad"] or launches != want or path_launches != want:
        raise AssertionError(f"seqrec at D = {head}: {burst['bad'][:3]}, {launches}, "
                             f"{path_launches} on the {path} path")
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
            "rows_library_ms", "rows_bound_us", "max_abs_err", "max_rel_err", "abba_ms",
            "equal_to_wide_kernel", "abba_device_ms", "equal_to_tile_kernel_at_kc",
            "earlier_kernel_ms", "earlier_kernel_device_ms", "device_over_bound",
            "device_over_library", "device_over_earlier_kernel", "kernel_runs_ms",
            "kernel_runs_device_ms", "earlier_kernel_runs_ms", "earlier_kernel_runs_device_ms",
            "library_runs_ms", "library_runs_device_ms", "own_path", "equal_to_own_kernel",
            "forced_ms", "forced_device_ms", "own_ms", "own_device_ms", "plan_clusters",
            "occupancy_clusters")
    return {case.split(":", 1)[1]: {k: out[k] for k in keys if k in out}
            for case, out in wide["kernels"]["cases"].items()
            if case.startswith(name + ":") and ("kernel_ms" in out or "forced_ms" in out)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_run = time.monotonic()

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
        resumed = timed("resume", phase_resume, torch, dev, data, registry, trained)
        sliced = timed("slice", phase_slice, torch, dev, args.seed, registry,
                       trained["instance"])
        planed = timed("plane", phase_plane, torch, dev, args.seed, registry,
                       trained["instance"], base, smi)
        rolled = timed("rollout", phase_rollout, torch, dev, args.seed, data, registry,
                       trained["instance"], base, smi)
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
        templated = timed("templates", phase_templates, torch, dev, args.seed, base)
        consoled = timed("console", phase_console, torch, dev, args.seed, base)
    large = timed("kernel_large", topk_large_batches, torch, dev,
                  np.random.default_rng(args.seed + 7))
    emit({"phase_seconds": seconds, "wall_s": time.monotonic() - t_run})

    from predictionio_tpu_torch.ops.cuda_kernels import topk_kernel_attributes

    ref = main_shapes[1024]
    bound_ms, bound_by = topk_bound(ref["B"], ref["N"], ref["R"], ref["k"])
    lines = [{
        "name": "topk_streaming",
        "route": "cuda",
        "source": TOPK_SOURCE,
        "replaces": TOPK_REPLACES,
        "launches": (sliced["launches"] + planed["launches"] + rolled["launches"]
                     + events["serve"]["launches"]
                     + evaluated["launches"]["topk_streaming"]
                     + persisted["by_kernel"]["topk_streaming"]
                     + templated["by_kernel"]["topk_streaming"]
                     + consoled["by_kernel"]["topk_streaming"]),
        "launches_by_path": {"slice": sliced["launches"],
                             "plane_burst": planed["burst"]["launches"],
                             "plane_shards": [s["launches"] for s in planed["shards"]["per_shard"]],
                             "rollout": {st: rolled[st]["launches"]
                                         for st in ("shadow", "canary", "live", "sick")},
                             "events_serve": events["serve"]["launches"],
                             "eval": evaluated["launches"]["topk_streaming"],
                             "persist": persisted["by_kernel"]["topk_streaming"],
                             "templates": templated["by_kernel"]["topk_streaming"],
                             "console": consoled["by_kernel"]["topk_streaming"]},
        "max_abs_err": max(m["max_abs_err"] for m in [*main_shapes.values(), *large.values(),
                                                      *planed["shards"]["per_shard"]]),
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
        "constrained_batch": templated["checks"]["constrained_batch"],
        # one shard's table (N = 6,750) against the whole catalog at the
        # plane phase's burst (B = 64, k = 64), device ms
        "shard": {k: planed["shards"][k] for k in (
            "unsharded_kernel_device_ms", "shard_bound_ms", "unsharded_bound_ms", "timed")}
        | {"kernel_device_ms": [s["kernel_device_ms"] for s in planed["shards"]["per_shard"]],
           "max_abs_err": max(s["max_abs_err"] for s in planed["shards"]["per_shard"])},
        "k_above_2048": {name: {k: main_shapes[name][k] for k in (
            "B", "N", "k", "E", "T", "n_runs", "merge_in", "kernel_ms", "kernel_device_ms",
            "plain_ms", "library_ms", "library_device_ms", "bound_us", "bound_by",
            "max_abs_err")} for name in ("k4096_N5000", "k_eq_N27000_E64")},
        # 128 < k <= 256 on the tiled running list, the per-tile sort of
        # the same call beside it
        "k256": {**{name: {k: main_shapes[name][k] for k in (
            "B", "N", "k", "T", "n_runs", "stage1", "kernel_ms", "kernel_device_ms",
            "tile_sort_ms", "tile_sort_device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_us", "bound_by", "max_abs_err",
            "equal_to_tile_sort")} for name in ("k256_B64", "k256_B1024")},
            "large_B32768": {k: v for k, v in large["large_B32768_R50_k256"].items()
                             if k not in ("case", "agree", "slices")},
            "served_num_129_256": sliced["http_num_129_256"]},
        "attributes": topk_kernel_attributes(dev),
    }]
    # the select path (256 < k <= 16,384) on its own line: launched by the
    # served num = 4,096 query, timed at k = 4,096 on 5,000 items (B = 64)
    ref = main_shapes["k4096_N5000"]
    bound_ms, bound_by = topk_bound(ref["B"], ref["N"], ref["R"], ref["k"])
    select_keys = ("B", "N", "k", "T", "n_runs", "kernel_ms", "kernel_device_ms",
                   "tile_sort_ms", "tile_sort_device_ms", "plain_ms", "library_ms",
                   "library_device_ms", "bound_us", "bound_by", "max_abs_err",
                   "equal_to_tile_sort", "bit_identical")
    lines.append({
        "name": "topk_select",
        "route": "cuda",
        "source": TOPK_SOURCE,
        "replaces": TOPK_REPLACES,
        "launches": persisted["launches"]["num4096_select"],
        "launches_by_path": {"persist_num4096": persisted["launches"]["num4096_select"]},
        "max_abs_err": max(main_shapes[name]["max_abs_err"]
                           for name in ("k1024", "k1024_B1024", "k4096_N5000")),
        "ms": ref["kernel_ms"],
        "plain_ms": ref["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": ref["library_ms"],
        "device_ms": ref["kernel_device_ms"],
        "library_device_ms": ref["library_device_ms"],
        "tile_sort_ms": ref["tile_sort_ms"],
        "tile_sort_device_ms": ref["tile_sort_device_ms"],
        "shape": {k: ref[k] for k in ("B", "N", "R", "k", "T", "n_runs")},
        "timed": {name: {k: main_shapes[name][k] for k in select_keys}
                  for name in ("k1024", "k1024_B1024")},
        "served_num4096": persisted["checks"]["num4096"],
        "attributes": {name: lines[0]["attributes"][name] for name in ("select_score", "select")},
    })
    resume_launches = {k: sum(r["launches"][k] for r in resumed["runs"].values())
                       for k in ("gramian_fused", "spd_solve")}
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
            "launches": (trained["launches"][name] + resume_launches[name]
                         + rolled["candidate_train_launches"][name]
                         + events["als"]["launches"][name]
                         + evaluated["launches"][name] + persisted["by_kernel"][name]
                         + templated["by_kernel"][name]
                         + wide["by_kernel"][name] + consoled["by_kernel"][name]),
            "launches_by_path": {"train": trained["launches"][name],
                                 "resume": resume_launches[name],
                                 "rollout_candidate_train": rolled["candidate_train_launches"][name],
                                 "events_als": events["als"]["launches"][name],
                                 "eval": evaluated["launches"][name],
                                 "persist": persisted["by_kernel"][name],
                                 "templates": templated["by_kernel"][name],
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
                             attributes=kernels["attributes"],
                             tile_path_launches=wide["by_kernel"]["gramian_wide"])
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
        "wide_attributes": {
            "resident": wide["kernels"]["attributes"]["flash_attention_resident"],
            "streamed": wide["kernels"]["attributes"]["flash_attention_streamed"],
            "wide_streamed": wide["kernels"]["attributes"]["flash_attention_wide_streamed"],
            "cluster": wide["kernels"]["attributes"]["flash_attention_cluster"],
            "passes": wide["kernels"]["attributes"]["flash_attention"]},
    })
    # the build's rows path (128 < R <= GRAMIAN_ROWS_MAX_RANK) on its own line:
    # launched by ALS at rank 200 in the wide phase; timed on the users'
    # bucket's first WIDE_CHECK_ROWS rows at R = 200 beside the plain version
    # and the library call, the whole bucket beside PR 12's tile kernel
    cases = wide["kernels"]["cases"]
    ref = cases[f"gramian_fused:by_user_R{WIDE_ALS_RANK}"]
    rows_cases = {name.split(":", 1)[1]: out for name, out in cases.items()
                  if name.startswith("gramian_fused:") and out.get("plan", {}).get("path") == "rows"}
    lines.append({
        "name": "gramian_rows",
        "route": "cuda",
        "source": GRAMIAN_SOURCE,
        "replaces": GRAMIAN_REPLACES,
        "launches": wide["by_kernel"]["gramian_rows"],
        "launches_by_path": {"wide_als_run_train": wide["by_kernel"]["gramian_rows"]},
        "max_abs_err": max(out["max_abs_err"] for out in rows_cases.values()),
        "ms": ref["rows_kernel_ms"],
        "plain_ms": ref["rows_plain_ms"],
        "bound_ms": ref["rows_bound_us"] / 1e3,
        "bound_by": ref["rows_bound_by"],
        "library_ms": ref["rows_library_ms"],
        "shape": {"B": ref["check_rows"], "K": ref["K"], "N": ref["N"], "R": WIDE_ALS_RANK},
        "bucket": {case: {k: out.get(k) for k in (
            "B", "slices", "plan", "kernel_ms", "kernel_device_ms", "earlier_kernel_ms",
            "earlier_kernel_device_ms", "bound_us", "bound_by", "library_ms",
            "equal_to_tile_kernel_at_kc")} for case, out in rows_cases.items()},
        "attributes": {k: v for k, v in wide["kernels"]["attributes"]["gramian_fused"].items()
                       if k.startswith("rows")},
    })
    # the streamed path (272 < D <= 320) on its own line: launched by seqrec at
    # D = 320 in the wide phase, timed at D = 320, L = 2,048 causal
    ref = cases[f"flash_attention:D{WIDE_STREAMED_HEAD}_8x4x2048_causal_True"]
    streamed = {name: out for name, out in cases.items()
                if name.startswith("flash_attention:") and out["plan"]["path"] == "streamed"}
    lines.append({
        "name": "flash_attention_streamed",
        "route": "cuda",
        "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": wide["by_kernel"]["flash_attention_streamed"],
        "launches_by_path": wide["seqrec_d320"]["path_launches"],
        "max_abs_err": max(out["max_abs_err"] for out in streamed.values()),
        "ms": ref["kernel_ms"],
        "plain_ms": ref["plain_ms"],
        "bound_ms": ref["bound_us"] / 1e3,
        "bound_by": ref["bound_by"],
        "library_ms": ref["library_ms"],
        "device_ms": ref["kernel_device_ms"],
        "library_device_ms": ref["library_device_ms"],
        "passes_ms": ref["earlier_kernel_ms"],
        "passes_device_ms": ref["earlier_kernel_device_ms"],
        "shape": {k: ref[k] for k in ("B", "H", "Lq", "Lk", "D", "causal")},
        "plan": ref["plan"],
        "cases": sorted(name.split(":", 1)[1] for name in streamed),
        "attributes": wide["kernels"]["attributes"]["flash_attention_streamed"],
    })
    # the wide streamed path (320 < D <= FLASH_WIDE_STREAMED_MAX_D) on its own
    # line: launched by seqrec at D = 384 in the wide phase, timed A B B A with
    # the passes kernel and SDPA at D = 384 on the training shape
    ref = cases[f"flash_attention:D{WIDE_WS_HEADS[0]}_64x4x64_causal_True"]
    ws = {name.split(":", 1)[1]: out for name, out in cases.items()
          if name.startswith("flash_attention:") and out["plan"]["path"] == "wide_streamed"}
    lines.append({
        "name": "flash_attention_wide_streamed",
        "route": "cuda",
        "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": wide["by_kernel"]["flash_attention_wide_streamed"],
        "launches_by_path": wide["seqrec_d384"]["path_launches"],
        "max_abs_err": max(out["max_abs_err"] for out in ws.values()),
        "ms": ref["kernel_ms"],
        "plain_ms": ref["plain_ms"],
        "bound_ms": ref["bound_us"] / 1e3,
        "bound_by": ref["bound_by"],
        "library_ms": ref["library_ms"],
        "device_ms": ref["kernel_device_ms"],
        "library_device_ms": ref["library_device_ms"],
        "passes_ms": ref["earlier_kernel_ms"],
        "passes_device_ms": ref["earlier_kernel_device_ms"],
        "shape": {k: ref[k] for k in ("B", "H", "Lq", "Lk", "D", "causal")},
        "plan": ref["plan"],
        "timed": {case: {k: out.get(k) for k in (
            "kernel_runs_ms", "kernel_runs_device_ms", "earlier_kernel_runs_ms",
            "earlier_kernel_runs_device_ms", "library_runs_ms", "library_runs_device_ms",
            "plain_ms", "bound_us", "bound_by", "max_abs_err", "equal_to_own_kernel",
            "forced_ms", "forced_device_ms", "own_ms", "own_device_ms")}
            for case, out in ws.items()},
        "attributes": wide["kernels"]["attributes"]["flash_attention_wide_streamed"],
    })
    # the cluster path (FLASH_WIDE_STREAMED_MAX_D < D <= FLASH_CLUSTER_MAX_D)
    # on its own line: launched by seqrec at D = 768 in the wide phase, timed
    # A B B A with the passes kernel and SDPA at D = 576 on the training shape
    ref = cases[f"flash_attention:D{WIDE_CLUSTER_HEADS[0]}_64x4x64_causal_True"]
    cl = {name.split(":", 1)[1]: out for name, out in cases.items()
          if name.startswith("flash_attention:") and out["plan"]["path"] == "cluster"}
    lines.append({
        "name": "flash_attention_cluster",
        "route": "cuda",
        "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": wide["by_kernel"]["flash_attention_cluster"],
        "launches_by_path": wide["seqrec_d768"]["path_launches"],
        "max_abs_err": max(out["max_abs_err"] for out in cl.values()),
        "ms": ref["kernel_ms"],
        "plain_ms": ref["plain_ms"],
        "bound_ms": ref["bound_us"] / 1e3,
        "bound_by": ref["bound_by"],
        "library_ms": ref["library_ms"],
        "device_ms": ref["kernel_device_ms"],
        "library_device_ms": ref["library_device_ms"],
        "passes_ms": ref["earlier_kernel_ms"],
        "passes_device_ms": ref["earlier_kernel_device_ms"],
        "shape": {k: ref[k] for k in ("B", "H", "Lq", "Lk", "D", "causal")},
        "plan": ref["plan"],
        "timed": {case: {k: out.get(k) for k in (
            "kernel_runs_ms", "kernel_runs_device_ms", "earlier_kernel_runs_ms",
            "earlier_kernel_runs_device_ms", "library_runs_ms", "library_runs_device_ms",
            "plain_ms", "bound_us", "bound_by", "max_abs_err", "equal_to_own_kernel",
            "forced_ms", "forced_device_ms", "own_ms", "own_device_ms", "library_ms",
            "library_device_ms", "plan_clusters", "occupancy_clusters", "plan_waves",
            "occupancy_waves")}
            for case, out in cl.items()},
        "seqrec_d768_parity": {k: wide["seqrec_d768_parity"][k] for k in (
            "steps", "margin", "margins", "max_abs_diff", "launches")},
        "attributes": wide["kernels"]["attributes"]["flash_attention_cluster"],
    })
    # the solve's cluster path (304 < n <= 768) on its own line: launched by
    # ALS at rank 384 in the wide phase, timed at n = 384 (B = 1,024) beside
    # cholesky_solve and the wide kernel on the same tensors
    ref = cases["spd_solve:n384_cluster"]
    timed = {name.split(":", 1)[1]: out for name, out in cases.items()
             if name.startswith("spd_solve:") and out.get("plan", {}).get("path") == "cluster"}
    lines.append({
        "name": "spd_cluster_kernel",
        "route": "cuda",
        "source": SPD_SOURCE,
        "replaces": SPD_REPLACES,
        "launches": wide["by_kernel"]["spd_cluster"],
        "launches_by_path": {"wide_als_rank384": wide["by_kernel"]["spd_cluster"]},
        "max_abs_err": max(out["max_abs_err"] for out in timed.values()),
        "ms": ref["kernel_ms"],
        "plain_ms": ref["plain_ms"],
        "bound_ms": ref["bound_us"] / 1e3,
        "bound_by": ref["bound_by"],
        "library_ms": ref["library_ms"],
        "device_ms": ref["kernel_device_ms"],
        "library_device_ms": ref["library_device_ms"],
        "wide_kernel_ms": ref["earlier_kernel_ms"],
        "wide_kernel_device_ms": ref["earlier_kernel_device_ms"],
        "shape": {"B": ref["B"], "n": ref["n"]},
        "plan": ref["plan"],
        "timed": {case: {k: out.get(k) for k in (
            "B", "plan", "occupancy_clusters", "plan_clusters", "occupancy_waves", "plan_waves",
            "abba_ms", "abba_device_ms",
            "kernel_ms", "kernel_device_ms", "library_ms", "library_device_ms",
            "earlier_kernel_ms", "earlier_kernel_device_ms", "plain_ms", "bound_us", "bound_by",
            "max_rel_err", "equal_to_wide_kernel")} for case, out in timed.items()},
        "attributes": wide["kernels"]["attributes"]["spd_solve_cluster"],
    })
    # the solve's tiled path (n > 768) on its own line: launched by ALS at
    # rank 1,024 in the wide phase, timed at n = 1,024 (B = 64) beside
    # cholesky_solve and the wide kernel on the same tensors
    ref = cases["spd_solve:n1024_B64_tiled"]
    timed = {name.split(":", 1)[1]: out for name, out in cases.items()
             if name.startswith("spd_solve:") and out.get("plan", {}).get("path") == "tiled"}
    lines.append({
        "name": "spd_tiled",
        "route": "cuda",
        "source": SPD_SOURCE,
        "replaces": SPD_REPLACES,
        "launches": wide["by_kernel"]["spd_tiled"],
        "launches_by_path": {"wide_als_rank1024": wide["by_kernel"]["spd_tiled"]},
        "max_abs_err": max(out["max_abs_err"] for out in timed.values()),
        "ms": ref["kernel_ms"],
        "plain_ms": ref["plain_ms"],
        "bound_ms": ref["bound_us"] / 1e3,
        "bound_by": ref["bound_by"],
        "library_ms": ref["library_ms"],
        "device_ms": ref["kernel_device_ms"],
        "library_device_ms": ref["library_device_ms"],
        "wide_kernel_ms": ref["earlier_kernel_ms"],
        "wide_kernel_device_ms": ref["earlier_kernel_device_ms"],
        "shape": {"B": ref["B"], "n": ref["n"]},
        "plan": ref["plan"],
        "timed": {case: {k: out.get(k) for k in (
            "B", "plan", "launches", "abba_ms", "abba_device_ms", "kernel_ms", "kernel_device_ms",
            "library_ms", "library_device_ms", "earlier_kernel_ms", "earlier_kernel_device_ms",
            "plain_ms", "bound_us", "bound_by", "max_rel_err", "equal_to_wide_kernel",
            "by_kernel")} for case, out in timed.items()},
        "als_rank1024": {k: wide["als_rank1024"][k] for k in (
            "iterations", "launches", "holdout_rmse", "first_user_solve", "user", "item",
            "seconds")},
        "attributes": wide["kernels"]["attributes"]["spd_solve_tiled"],
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
