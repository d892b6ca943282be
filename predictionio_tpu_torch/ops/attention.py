"""Attention on one device: blockwise (flash) attention with an online
softmax.

Counterpart of the single-device half of
``predictionio_tpu/ops/attention.py``, with its names and its
``[B, H, L, D]`` layout at every public function:

- :func:`flash_attention` — the plain blockwise path (a loop over KV
  blocks, finite -1e30 mask, padded keys masked, ``o / max(l, 1e-30)``).
  It is the math the kernel is held to, and the backward of
  :func:`flash_attention_pallas` differentiates it.
- :func:`flash_attention_pallas` — the fused kernel, keeping the JAX
  name so a reader finds its counterpart: on a CUDA device the
  hand-written CUDA kernel (``kernels/csrc/flash_attention.cu`` through
  :func:`.cuda_kernels.flash_attention_fwd`), on the CPU that wrapper's
  plain version. A ``torch.autograd.Function`` saves only q, k and v and
  recomputes through :func:`flash_attention` in the backward, as the JAX
  custom VJP does (``_flash_pallas_bwd``).
- :func:`attention` — the dispatch. Both ``impl`` values take
  :func:`flash_attention_pallas`: the port has one implementation per
  device, so the template's default (``"xla"``) reaches the kernel.

Any head width D is taken: up to 128 the kernel's wrapper pads D to a
multiple of 8 on the card and scales by the true D, and wider heads take
the kernel's wide-head path, unpadded. Ring and Ulysses attention (sequence parallelism over a mesh) wait for
``torch.distributed`` (ROADMAP.md, queue 1 item 11); asking for them
raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .cuda_kernels import FLASH_NEG_BIG, flash_attention_fwd

_NEG_BIG = FLASH_NEG_BIG  # additive mask value (finite: keeps fully-masked rows NaN-free)

#: the attention implementations a template may name (``flash_impl``)
IMPLS = ("xla", "pallas")
#: schedules on one device; "flash" is the template's name for it
SINGLE_DEVICE_SCHEDULES = ("auto", "flash")

SEQUENCE_PARALLEL_NOT_PORTED = (
    "ring and Ulysses attention are not ported yet (ROADMAP.md, queue 1 "
    "item 11: sequence parallelism on torch.distributed); use the "
    "single-device schedule (\"flash\" or \"auto\" without a mesh)"
)


def check_dispatch(schedule: str, impl: str, mesh=None) -> None:
    """Raise unless :func:`attention` can run ``schedule``/``impl``:
    ``ValueError`` for an unknown name (as the JAX dispatch does),
    ``NotImplementedError`` for ring, Ulysses or a mesh."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    if schedule in ("ring", "ulysses") or mesh is not None:
        raise NotImplementedError(SEQUENCE_PARALLEL_NOT_PORTED)
    if schedule not in SINGLE_DEVICE_SCHEDULES:
        raise ValueError(f"unknown attention schedule {schedule!r}")


def _attend_block(q, k, v, m, l, o, mask, scale):
    """One online-softmax accumulation step.

    q [..., Lq, D], k/v [..., Lk, D]; running (m, l, o) with m/l [..., Lq]
    and o [..., Lq, D]; ``mask`` is an optional [Lq, Lk] bool (True = keep).
    """
    scores = torch.einsum("...qd,...kd->...qk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_BIG)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * correction + p.sum(dim=-1)
    o_new = o * correction[..., None] + torch.einsum(
        "...qk,...kd->...qd", p, v.float()
    )
    return m_new, l_new, o_new


def flash_attention(
    q: torch.Tensor,  # [B, H, L, D]
    k: torch.Tensor,  # [B, H, L, D]
    v: torch.Tensor,  # [B, H, L, D]
    causal: bool = True,
    block_k: int = 512,
    prescale_q: bool = False,
) -> torch.Tensor:
    """Blockwise attention with online softmax (single device).

    ``prescale_q`` multiplies q by 1/sqrt(D) before the dot, as the TPU
    and CUDA kernels do, where the JAX plain path scales the scores after
    it: equal to the tolerance, not bit for bit."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    blk = min(block_k, lk)
    n_blocks = (lk + blk - 1) // blk
    pad = n_blocks * blk - lk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))

    q_pos = torch.arange(lq, device=q.device)
    qf = q.float()
    if prescale_q:
        qf, scale = qf * scale, 1.0
    m = torch.full((b, h, lq), _NEG_BIG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    for j in range(n_blocks):
        kj = k[:, :, j * blk:(j + 1) * blk]
        vj = v[:, :, j * blk:(j + 1) * blk]
        k_pos = j * blk + torch.arange(blk, device=q.device)
        valid = k_pos < lk  # padded keys masked out
        if causal:
            mask = (q_pos[:, None] >= k_pos[None, :]) & valid[None, :]
        else:
            mask = valid[None, :].expand(lq, blk)
        m, l, o = _attend_block(qf, kj.float(), vj, m, l, o, mask, scale)
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


class _FlashAttention(torch.autograd.Function):
    """Kernel forward, flash-style backward: only q, k and v are saved
    (never the score matrix), and the backward recomputes attention
    through :func:`flash_attention` and differentiates that."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return flash_attention_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), causal
        )

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = flash_attention(*leaves, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(o, leaves, g)
        return dq, dk, dv, None


def flash_attention_pallas(
    q: torch.Tensor,  # [B, H, Lq, D] f32
    k: torch.Tensor,  # [B, H, Lk, D] f32
    v: torch.Tensor,  # [B, H, Lk, D] f32
    causal: bool = True,
) -> torch.Tensor:
    """Fused flash attention: the hand-written CUDA kernel on a CUDA
    device, its plain version on the CPU; differentiable (the backward
    recomputes through :func:`flash_attention`).

    The kernel's tiles are fixed at 64 rows and 64 keys
    (:data:`.cuda_kernels.FLASH_TILE`), so the JAX version's
    ``block_q``/``block_k`` have no counterpart. Takes any head width."""
    return _FlashAttention.apply(q, k, v, causal)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh=None,
    causal: bool = True,
    schedule: str = "auto",
    impl: str = "xla",
) -> torch.Tensor:
    """Dispatch (the JAX signature less ``axis``, which only a mesh
    reads): single-device flash attention
    through the kernel for ``schedule`` "auto" or "flash" and either
    ``impl``; ring, Ulysses and a mesh raise ``NotImplementedError``, an
    unknown ``impl`` or ``schedule`` raises ``ValueError``."""
    check_dispatch(schedule, impl, mesh)
    return flash_attention_pallas(q, k, v, causal=causal)
