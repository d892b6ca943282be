"""Serving-side scoring: the port's ``ops/scoring.py`` and
``quant/ragged.py`` against the JAX package's.

Same numpy inputs from a seed go through both. On the CPU the port's
fused entries run the kernel's plain version under every mode, while the
JAX entries take their own paths (the Pallas kernel in interpret mode
under "always", XLA otherwise). Tolerance: scores rtol 1e-5 / atol 1e-5,
ids equal or tied; the gather is bit-identical.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import scoring as jax_scoring
from predictionio_tpu.quant.ragged import ragged_gather as jax_ragged_gather
from predictionio_tpu_torch.ops import scoring
from predictionio_tpu_torch.quant.ragged import ragged_gather

RTOL = ATOL = 1e-5
CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # a device name only: nothing runs on it here


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_agree(port, ref):
    ps, pi = (x.numpy() for x in port)
    rs, ri = (np.asarray(x) for x in ref)
    assert ps.shape == rs.shape and pi.shape == ri.shape
    np.testing.assert_allclose(ps, rs, rtol=RTOL, atol=ATOL)
    assert ((pi == ri) | np.isclose(ps, rs, rtol=RTOL, atol=ATOL)).all()
    assert ((pi == -1) == np.isneginf(ps)).all()


class TestRaggedGather:
    table = np.random.default_rng(0).normal(size=(50, 6)).astype(np.float32)

    @pytest.mark.parametrize(
        "ids",
        [
            np.array([3, 3, 7, 0, 3, 49, 7], dtype=np.int32),
            np.array([[1, 2, 1], [2, 2, 9]], dtype=np.int64),
            np.arange(50, dtype=np.int32)[::-1],
        ],
        ids=["duplicates", "2-D", "all-rows"],
    )
    def test_bit_identical_to_dense_gather(self, ids):
        table = _t(self.table)
        got = ragged_gather(table, _t(ids))
        want = table[_t(ids).long()]
        assert got.shape == want.shape == tuple(ids.shape) + (6,)
        assert torch.equal(got, want)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_ragged_gather(self.table, ids))
        )

    @pytest.mark.parametrize("shape", [(0,), (3, 0)])
    def test_empty_ids(self, shape):
        got = ragged_gather(_t(self.table), torch.zeros(shape, dtype=torch.int32))
        assert got.shape == shape + (6,)
        assert got.dtype == torch.float32


def test_a_batch_above_one_launch_is_answered_like_jax(monkeypatch):
    """B = 524,281 queries, one more than a launch of the kernel takes
    (``TOPK_MAX_BATCH``): the port's streaming entry cuts the batch into
    two slices (counted here) and answers like the JAX package's fused
    top-k, which has no cap. N = 8, R = 2, k = 4."""
    from predictionio_tpu_torch.ops import cuda_kernels

    b = cuda_kernels.TOPK_MAX_BATCH + 1
    rng = np.random.default_rng(29)
    uf = rng.normal(size=(1000, 2)).astype(np.float32)
    itf = rng.normal(size=(8, 2)).astype(np.float32)
    uidx = rng.integers(0, 1000, b).astype(np.int32)
    split, sliced = cuda_kernels.topk_batch_slices, []
    monkeypatch.setattr(cuda_kernels, "topk_batch_slices",
                        lambda n: sliced.append(split(n)) or sliced[-1])
    port = scoring.top_k_for_users_fused(_t(uf), _t(itf), _t(uidx), k=4, mode="always")
    ref = jax_scoring.top_k_for_users_fused(uf, itf, uidx, k=4)
    assert sliced == [[(0, b - 1), (b - 1, b)]]
    assert port[0].shape == (b, 4)
    assert_agree(port, ref)


class TestFusedTopK:
    rng = np.random.default_rng(11)
    uf = rng.normal(size=(40, 10)).astype(np.float32)
    itf = rng.normal(size=(300, 10)).astype(np.float32)
    uidx = np.array([5, 0, 5, 39, 12, 5, 7, 7], dtype=np.int32)

    @pytest.mark.parametrize("mode", ["always", "never", "auto"])
    def test_users_fused_matches_jax(self, mode):
        port = scoring.top_k_for_users_fused(
            _t(self.uf), _t(self.itf), _t(self.uidx), k=16, mode=mode
        )
        ref = jax_scoring.top_k_for_users_fused(
            self.uf, self.itf, self.uidx, k=16, mode=mode
        )
        assert_agree(port, ref)

    @pytest.mark.parametrize("mode", ["always", "never"])
    def test_users_fused_with_exclusions_matches_jax(self, mode):
        excl = np.full((len(self.uidx), 5), -1, dtype=np.int32)
        excl[:, :3] = np.arange(3 * len(self.uidx)).reshape(-1, 3) % 300
        port = scoring.top_k_for_users_fused(
            _t(self.uf), _t(self.itf), _t(self.uidx), k=8,
            exclude_idx=_t(excl), mode=mode,
        )
        ref = jax_scoring.top_k_for_users_fused(
            self.uf, self.itf, self.uidx, k=8, exclude_idx=excl, mode=mode
        )
        assert_agree(port, ref)

    def test_vectors_fused_matches_jax(self):
        q = self.uf[:6]
        assert_agree(
            scoring.top_k_fused_vectors(_t(q), _t(self.itf), 9, mode="always"),
            jax_scoring.top_k_fused_vectors(q, self.itf, 9, mode="always"),
        )

    def test_dense_leg_matches_xla_leg(self):
        """Exclusions plus k past the catalog: both dense legs keep the
        -inf/-1 sentinels."""
        q, items = self.uf[:4], self.itf[:12]
        excl = np.array([[0, 1, -1], [-1, -1, -1], [11, 3, 3], [5, -1, 7]],
                        dtype=np.int32)
        assert_agree(
            scoring.dense_topk_with_sentinels(_t(q), _t(items), 15, _t(excl)),
            jax_scoring.xla_topk_with_sentinels(q, items, 15, excl),
        )


class TestStreamingSelection:
    def test_cpu_device_never_streams_on_auto(self):
        assert not scoring.use_streaming_topk("auto", CPU)
        assert scoring.use_streaming_topk("always", CPU)
        assert not scoring.use_streaming_topk("never", CPU)
        assert scoring.resolve_topk_path("auto", CPU) == "dense"

    @pytest.mark.parametrize(
        "b_pad,n_items,past_jax_bar",
        [
            (1024, 27000, True),  # 110.6 MB of would-be scores
            (64, 27000, False),  # 6.9 MB
            (512, 32768, False),  # exactly 64 MB: not past the bar
            (512, 32769, True),
        ],
    )
    def test_the_64mb_bar_on_a_cuda_device(self, b_pad, n_items, past_jax_bar):
        """The JAX package's 64 MB bar was set on a TPU against XLA; on a
        CUDA device the port streams on both sides of it, so an HTTP
        micro-batch of any size goes through the kernel."""
        jax_bar = jax_scoring.STREAMING_TOPK_BYTES
        assert (b_pad * n_items * 4 > jax_bar) is past_jax_bar
        assert not hasattr(scoring, "STREAMING_TOPK_BYTES")
        for mode in ("auto", "always"):
            assert scoring.use_streaming_topk(mode, CUDA) is True
            assert scoring.resolve_topk_path(mode, CUDA) == "streaming"

    def test_never_is_refused_on_a_cuda_device(self):
        with pytest.raises(ValueError, match="only on the CPU"):
            scoring.use_streaming_topk("never", CUDA)
        with pytest.raises(ValueError, match="only on the CPU"):
            scoring.resolve_topk_path("never", CUDA)

    def test_unknown_mode_raises(self):
        with pytest.raises(ValueError, match="streaming_top_k"):
            scoring.use_streaming_topk("sometimes", CPU)
        with pytest.raises(ValueError, match="streaming_top_k"):
            scoring.use_streaming_topk("sometimes", CUDA)

    def test_pad_pow2_and_byte_model_match_jax(self):
        for n in range(0, 70):
            for lo in (1, 8):
                assert scoring.pad_pow2(n, lo) == jax_scoring.pad_pow2(n, lo)
        for streaming in (True, False):
            assert scoring.estimate_topk_hbm_bytes(
                64, 27000, 50, 16, streaming
            ) == jax_scoring.estimate_topk_hbm_bytes(64, 27000, 50, 16, streaming)
