"""The port's flash attention against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX ``flash_attention_pallas``
(interpret mode, as ``TestFlashPallas`` runs it) and through the port's
plain ``flash_attention`` and its ``flash_attention_pallas`` (on CPU
tensors: the CUDA wrapper's plain version, which repeats the kernel's
arithmetic), to the JAX test's tolerance (rtol 2e-4 / atol 2e-5).
Gradients of ``(o**2).sum()`` are held to ``jax.grad`` of the JAX
version (rtol 2e-3 / atol 2e-4, ``test_flash_pallas_gradients_match_xla``).
The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.attention import (
    flash_attention as jax_flash_attention,
    flash_attention_pallas as jax_flash_attention_pallas,
)
from predictionio_tpu_torch.ops import attention as port_attention
from predictionio_tpu_torch.ops import cuda_kernels
from predictionio_tpu_torch.ops.attention import (
    attention,
    flash_attention,
    flash_attention_pallas,
)
from predictionio_tpu_torch.ops.cuda_kernels import (
    flash_attention_fwd,
    flash_attention_fwd_reference,
)

RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
#: TestFlashPallas's shapes (test_attention.py:104-111): b, h, lq, lk, d, bq, bk
SHAPES = [
    (2, 4, 64, 64, 16, 32, 32),
    (1, 2, 60, 60, 8, 32, 16),
    (1, 1, 7, 13, 8, 8, 8),
    (2, 2, 128, 96, 32, 64, 32),
]


def _qkv(b, h, lq, lk, d, seed=7):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    return q, k, v


@functools.lru_cache(maxsize=None)
def _jax_out(shape, causal):
    b, h, lq, lk, d, bq, bk = shape
    q, k, v = _qkv(b, h, lq, lk, d)
    return np.asarray(jax_flash_attention_pallas(
        q, k, v, causal=causal, block_q=bq, block_k=bk))


@pytest.mark.parametrize("port_fn", ["flash_attention", "flash_attention_pallas"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:5])))
def test_matches_the_jax_pallas_kernel(shape, causal, port_fn):
    b, h, lq, lk, d, _, _ = shape
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, h, lq, lk, d))
    fn = {"flash_attention": flash_attention,
          "flash_attention_pallas": flash_attention_pallas}[port_fn]
    got = fn(q, k, v, causal=causal).numpy()
    np.testing.assert_allclose(got, _jax_out(shape, causal), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal):
    q, k, v = _qkv(1, 2, 32, 32, 8, seed=9)

    def loss_p(q, k, v):
        return (jax_flash_attention_pallas(q, k, v, causal=causal) ** 2).sum()

    want = jax.grad(loss_p, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (flash_attention_pallas(*leaves, causal=causal) ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_backward_recomputes_through_the_plain_path(monkeypatch):
    """Only q, k and v are saved; the backward differentiates the plain
    ``flash_attention`` (the JAX ``_flash_pallas_bwd``). On the CPU the
    forward is the kernel's plain version, ``flash_attention`` with q
    pre-scaled; the backward's recompute is the JAX plain path's."""
    calls = []
    plain = port_attention.flash_attention

    def counting(*a, **kw):
        calls.append((kw.get("causal"), kw.get("prescale_q", False)))
        return plain(*a, **kw)

    monkeypatch.setattr(port_attention, "flash_attention", counting)
    leaves = [torch.from_numpy(a).requires_grad_() for a in _qkv(1, 1, 16, 16, 8)]
    out = flash_attention_pallas(*leaves, causal=False)
    assert calls == [(False, True)]
    out.sum().backward()
    assert calls == [(False, True), (False, False)]
    assert all(leaf.grad is not None for leaf in leaves)


def test_q_is_prescaled_as_the_tpu_kernel_does():
    """The kernel (and its plain version) scale q before the dot, the
    plain blockwise path scales the scores after it: equal to the
    tolerance, not bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 64, 64, 16, seed=3))
    pre = flash_attention_fwd_reference(q, k, v, causal=True)
    post = flash_attention(q, k, v, causal=True, block_k=cuda_kernels.FLASH_TILE)
    np.testing.assert_allclose(pre.numpy(), post.numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(pre, flash_attention(
        q, k, v, causal=True, block_k=cuda_kernels.FLASH_TILE, prescale_q=True))


@pytest.mark.parametrize("lk", [64, 130, 200])
def test_ascending_tiles_keep_the_finite_mask_exact(lk):
    """The -1e30 mask is safe only while the first key tile holds a key
    every row keeps (key 0): then a fully masked later tile adds exactly
    0. Several tiles, the last one ragged, causal with Lq > Lk: the plain
    kernel version equals a dense softmax and is finite everywhere."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, lk + 7, lk, 8, seed=5))
    got = flash_attention_fwd_reference(q, k, v, causal=True)
    d = q.shape[-1]
    s = (q @ k.transpose(-1, -2)) / np.sqrt(d)
    keep = torch.arange(q.shape[2])[:, None] >= torch.arange(lk)[None, :]
    want = torch.softmax(s.masked_fill(~keep, -1e30), dim=-1) @ v
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    # the tiles above the diagonal change nothing, as the kernel skips them
    first = flash_attention_fwd_reference(
        q[:, :, :64].contiguous(), k[:, :, :64].contiguous(),
        v[:, :, :64].contiguous(), causal=True)
    assert torch.equal(first, got[:, :, :64])


def test_dispatch_takes_the_kernel_for_both_impls_and_refuses_the_rest():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 64, 64, 16, seed=0))
    want = flash_attention_pallas(q, k, v, causal=True)
    for impl in ("xla", "pallas"):
        for schedule in ("auto", "flash"):
            assert torch.equal(attention(q, k, v, impl=impl, schedule=schedule), want)
    with pytest.raises(ValueError, match="impl"):
        attention(q, k, v, impl="bogus")
    with pytest.raises(ValueError, match="schedule"):
        attention(q, k, v, schedule="bogus")


@pytest.mark.parametrize("schedule", ["ring", "ulysses"])
def test_sequence_parallel_schedules_are_not_ported(schedule):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 16, 16, 8))
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        attention(q, k, v, schedule=schedule)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        attention(q, k, v, mesh=object())


@pytest.mark.parametrize("case", [
    "k_float64", "D0", "float64", "rank3", "non_contiguous", "k_shape", "no_keys",
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    q, k, v = t(1, 2, 8, 16), t(1, 2, 8, 16), t(1, 2, 8, 16)
    if case == "k_float64":
        k = t(1, 2, 8, 16, dtype=torch.float64)
    elif case == "D0":
        q, k, v = t(1, 1, 4, 0), t(1, 1, 4, 0), t(1, 1, 4, 0)
    elif case == "float64":
        q = t(1, 2, 8, 16, dtype=torch.float64)
    elif case == "rank3":
        q = t(2, 8, 16)
    elif case == "non_contiguous":
        q = t(1, 8, 2, 16).transpose(1, 2)
    elif case == "k_shape":
        k = t(1, 3, 8, 16)
    elif case == "no_keys":
        k, v = t(1, 2, 0, 16), t(1, 2, 0, 16)
    with pytest.raises((ValueError, TypeError)):
        flash_attention_fwd(q, k, v, causal=True)
    with pytest.raises((ValueError, TypeError)):
        flash_attention_fwd_reference(q, k, v, causal=True)


def test_a_cpu_call_counts_no_launch():
    before = flash_attention_fwd.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 16, 16, 8))
    flash_attention_fwd(q, k, v, causal=True)
    attention(q, k, v, impl="pallas")
    flash_attention_pallas(q, k, v).sum()
    assert flash_attention_fwd.launches == before


def test_the_plain_path_matches_the_jax_plain_path_at_every_block():
    q, k, v = _qkv(2, 4, 64, 64, 16, seed=0)
    for block_k in (16, 48, 64):
        want = np.asarray(jax_flash_attention(q, k, v, causal=True, block_k=block_k))
        got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, block_k=block_k).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- head widths that are not a multiple of 8 (the kernel pads them) -------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [1, 6, 12, 15, 100])
def test_odd_head_widths_are_answered_like_jax(d, causal):
    """``attention`` answers at any head width up to 128, as the JAX
    template does (the Pallas kernel takes the whole D as one block)."""
    q, k, v = _qkv(2, 2, 5 if d < 100 else 70, 5 if d < 100 else 70, d, seed=d)
    want = np.asarray(jax_flash_attention_pallas(q, k, v, causal=causal, block_q=8,
                                                 block_k=8))
    got = attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_odd_head_width_gradients_match_jax():
    q, k, v = _qkv(1, 2, 16, 16, 6, seed=5)

    def loss(q, k, v):
        return (jax_flash_attention(q, k, v, causal=True) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (flash_attention_pallas(*leaves, causal=True) ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [129, 136, 256])
def test_a_head_wider_than_128_is_answered_like_jax(d, causal):
    """Above 128 the kernel's wide-head path answers (unpadded); on the
    CPU the wrapper's plain version runs at the true D, as the JAX
    template's default ``flash_impl="xla"`` does."""
    q, k, v = _qkv(1, 2, 40, 40, d, seed=d)
    want = np.asarray(jax_flash_attention_pallas(q, k, v, causal=causal, block_q=8,
                                                 block_k=8))
    got = attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_a_wide_head_gradient_matches_jax():
    q, k, v = _qkv(1, 1, 12, 12, 256, seed=3)

    def loss(q, k, v):
        return (jax_flash_attention(q, k, v, causal=True) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (flash_attention_pallas(*leaves, causal=True) ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
