"""predictionio_tpu_torch — the PyTorch/CUDA port of ``predictionio_tpu``.

The JAX package stays the reference; this package mirrors its module
paths and public names so a reader finds each counterpart, and runs on
an NVIDIA H100 (``sm_90a``). Every Pallas kernel on a ported path
becomes a hand-written CUDA kernel under :mod:`.kernels` with a plain
PyTorch version beside its wrapper.

Rules the package keeps:

- it imports ``torch`` and never ``jax``, and nothing of
  ``predictionio_tpu`` (it keeps its own trimmed copies instead);
- entry points run on ``cuda`` unless the caller passes
  ``device="cpu"`` (:func:`.device.resolve_device`), and never drop
  quietly to the CPU;
- no module turns TF32 on.

Ported so far: the recommendation query-serving path
(:func:`.workflow.serving.create_query_server` → ``ALSAlgorithm`` →
:func:`.ops.scoring.top_k_for_users_fused` → the CUDA streaming top-k),
ALS and sequence-recommender training (:func:`.workflow.run_train`), the
Event Server, event stores and training infeed, and evaluation with the
train/eval entry point (:func:`.workflow.run_evaluation`,
``python -m predictionio_tpu_torch.tools.run_workflow``), and the query
server's request plane: traces (:mod:`.obs.trace`), deadlines, retries
and breakers (:mod:`.utils.resilience`), feedback events and the error
log, the flight recorder and SLO health (:mod:`.obs.flight`,
:mod:`.obs.slo`), and sharded serving (:mod:`.fleet.merge`).
"""

__version__ = "0.1.0"
