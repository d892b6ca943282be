"""The port's native host library: bucketize and the per-row index sort.

``native/bucketize.cc`` (built by ``predictionio_tpu_torch/native``'s own
loader with ``g++``) is held bit for bit — dtype, shape and every byte of
``rows``, ``idx``, ``val`` and ``counts`` — against the port's numpy path
(``PIO_NO_NATIVE_BUCKETIZE=1``) and against the JAX package's numpy
``_bucketize_numpy`` + ``sort_bucket_indices``, on seeded data: widths
with truncated rows, uint16 and int32 column ids, ``pad_to_blocks``,
empty and one-rating rows, duplicate (row, col) pairs, ties in a row.
Tolerance: none (exact equality).
"""

import ctypes
import os

import numpy as np
import pytest

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch import native
from predictionio_tpu_torch.ops import als

WIDTHS = (8, 32, 128)


def _data(seed, nnz, n_rows, n_cols, skew=0.8):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_rows + 1) ** skew
    rows = rng.choice(n_rows, size=nnz, p=w / w.sum()).astype(np.int32)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return rows, cols, vals


def _identical(got, want):
    assert (got.n_rows, got.n_cols, got.nnz) == (want.n_rows, want.n_cols, want.nnz)
    assert len(got.buckets) == len(want.buckets)
    for g, w in zip(got.buckets, want.buckets):
        for field in ("rows", "idx", "val", "counts"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert a.tobytes() == b.tobytes(), field


def _numpy_side(monkeypatch, fn, *args):
    with monkeypatch.context() as m:
        m.setenv("PIO_NO_NATIVE_BUCKETIZE", "1")
        return fn(*args)


CASES = {
    # name: (rows, cols, vals, n_rows, n_cols)
    "skewed_uint16": _data(0, 20_000, 700, 300) + (700, 300),
    "skewed_int32_cols": _data(1, 20_000, 700, 70_000) + (700, 70_000),
    # rows past the widest width: truncated to their first ratings
    "truncated": (
        np.concatenate([np.zeros(500, np.int32), np.full(300, 2, np.int32),
                        np.arange(40, dtype=np.int32) % 5]),
        np.concatenate([np.arange(500, dtype=np.int32)[::-1] % 97,
                        np.arange(300, dtype=np.int32) % 13,
                        np.arange(40, dtype=np.int32)]),
        np.arange(840, dtype=np.float32),
        6, 500,
    ),
    # every pair twice and rows of one rating: ties and empties
    "duplicates_and_singletons": (
        np.array([0, 0, 0, 0, 3, 5, 5, 5, 5, 9], np.int32),
        np.array([4, 4, 1, 1, 7, 2, 2, 2, 0, 0], np.int32),
        np.arange(10, dtype=np.float32),
        12, 8,
    ),
}


@pytest.mark.parametrize("pad_to_blocks", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_bucketize_and_sort_match_both_numpy_paths(case, pad_to_blocks, monkeypatch):
    rows, cols, vals, nr, nc = CASES[case]
    got = als.bucketize(rows, cols, vals, nr, nc, WIDTHS, pad_to_blocks)
    port_np = _numpy_side(monkeypatch, als.bucketize, rows, cols, vals, nr, nc,
                          WIDTHS, pad_to_blocks)
    jax_np = jax_als._bucketize_numpy(rows, cols, vals, nr, nc, WIDTHS, pad_to_blocks)
    _identical(got, port_np)
    _identical(got, jax_np)
    sorted_native = als.sort_bucket_indices(got)
    _identical(sorted_native, _numpy_side(monkeypatch, als.sort_bucket_indices, port_np))
    _identical(sorted_native, jax_als.sort_bucket_indices(jax_np))


@pytest.mark.parametrize("n_cols,dtype", [(300, np.uint16), (70_000, np.int32)])
def test_idx_dtype_follows_the_column_space(n_cols, dtype):
    rows, cols, vals = _data(2, 3000, 100, n_cols)
    side = als.sort_bucket_indices(als.bucketize(rows, cols, vals, 100, n_cols, WIDTHS))
    assert {b.idx.dtype for b in side.buckets} == {np.dtype(dtype)}


def test_truncation_keeps_the_first_ratings_in_input_order_then_sorts():
    """A row of 40,000 ratings in the default widths keeps its first
    32,768 in input order, which the sort then orders by column."""
    n = 40_000
    rng = np.random.default_rng(5)
    cols = rng.integers(0, 1000, n).astype(np.int32)
    vals = np.arange(n, dtype=np.float32)
    rows = np.zeros(n, np.int32)
    side = als.sort_bucket_indices(als.bucketize(rows, cols, vals, 1, 1000))
    (b,) = side.buckets
    assert b.width == 32768 and int(b.counts[0]) == 32768
    keep = np.argsort(cols[:32768], kind="stable")
    np.testing.assert_array_equal(b.idx[0], cols[:32768][keep])
    np.testing.assert_array_equal(b.val[0], vals[:32768][keep])


def test_padding_and_sentinel_rows_are_untouched():
    rows, cols, vals = _data(3, 5000, 300, 200)
    side = als.bucketize(rows, cols, vals, 300, 200, WIDTHS, pad_to_blocks=True)
    for b in side.buckets:  # mark every padding slot, sentinel rows too
        pos = np.arange(b.width)[None, :]
        pad = pos >= b.counts[:, None]
        b.idx[pad] = 7
        b.val[pad] = -1.5
    before = [als.Bucket(rows=b.rows, idx=b.idx.copy(), val=b.val.copy(), counts=b.counts)
              for b in side.buckets]
    out = als.sort_bucket_indices(side)
    sentinels = 0
    for b, o in zip(before, out.buckets):
        pad = np.arange(b.width)[None, :] >= b.counts[:, None]
        np.testing.assert_array_equal(o.idx[pad], b.idx[pad])
        np.testing.assert_array_equal(o.val[pad], b.val[pad])
        sentinel = b.rows == side.n_rows
        sentinels += int(sentinel.sum())
        np.testing.assert_array_equal(o.idx[sentinel], b.idx[sentinel])
        np.testing.assert_array_equal(o.val[sentinel], b.val[sentinel])
    assert sentinels > 0


def test_sort_is_stable_on_equal_indices():
    b = als.Bucket(
        rows=np.array([0], np.int32),
        idx=np.array([[3, 1, 3, 1, 3, 0, 0, 0]], np.uint16),
        val=np.array([[0, 1, 2, 3, 4, 9, 9, 9]], np.float32),
        counts=np.array([5], np.int32),
    )
    side = als.BucketedMatrix(n_rows=1, n_cols=4, nnz=5, buckets=[b])
    (o,) = als.sort_bucket_indices(side).buckets
    np.testing.assert_array_equal(o.idx[0], [1, 1, 3, 3, 3, 0, 0, 0])
    np.testing.assert_array_equal(o.val[0], [1, 3, 0, 2, 4, 9, 9, 9])


@pytest.mark.parametrize("flag", ["0", "1"])
def test_sort_is_in_place_and_keeps_each_rows_pairs(flag, monkeypatch):
    """Both paths reorder the slabs they are given (no second set of
    slabs) and each row keeps its own (idx, val) pairs."""
    monkeypatch.setenv("PIO_NO_NATIVE_BUCKETIZE", flag)
    rows, cols, vals = _data(4, 3000, 80, 500)
    side = als.bucketize(rows, cols, vals, 80, 500, WIDTHS)
    before = [(b.idx, b.val, b.idx.copy(), b.val.copy()) for b in side.buckets]
    assert als.sort_bucket_indices(side) is side
    for b, (idx, val, idx0, val0) in zip(side.buckets, before):
        assert b.idx is idx and b.val is val
        for r, n in enumerate(b.counts):
            assert np.all(np.diff(b.idx[r, :n].astype(np.int64)) >= 0)
            assert (sorted(zip(b.idx[r, :n].tolist(), b.val[r, :n].tolist()))
                    == sorted(zip(idx0[r, :n].tolist(), val0[r, :n].tolist())))


def test_sort_refuses_counts_past_the_width():
    b = als.Bucket(rows=np.array([0], np.int32), idx=np.zeros((1, 8), np.int32),
                   val=np.zeros((1, 8), np.float32), counts=np.array([9], np.int32))
    with pytest.raises(ValueError, match="counts"):
        als.sort_bucket_indices(als.BucketedMatrix(1, 1, 9, [b]))


def test_empty_input_gives_no_buckets():
    e = np.zeros(0, np.int32)
    side = als.bucketize(e, e, np.zeros(0, np.float32), 5, 5)
    assert side.buckets == [] and side.nnz == 0
    assert als.sort_bucket_indices(side).buckets == []


def test_out_of_range_ids_are_refused_before_the_native_fill():
    with pytest.raises(ValueError, match="row ids"):
        als.bucketize(np.array([0, 5], np.int32), np.array([0, 0], np.int32),
                      np.ones(2, np.float32), 5, 3)
    with pytest.raises(ValueError, match="column ids"):
        als.bucketize(np.array([0, 1], np.int32), np.array([0, 3], np.int32),
                      np.ones(2, np.float32), 5, 3)


def test_the_switch_selects_the_path_and_the_profile_names_it(monkeypatch):
    calls = []
    real = als._bucketize_native
    monkeypatch.setattr(als, "_bucketize_native",
                        lambda *a: calls.append(1) or real(*a))
    rows, cols, vals = _data(6, 500, 30, 20)
    for flag, path, n_calls in (("0", "native", 2), ("1", "numpy", 2)):
        monkeypatch.setenv("PIO_NO_NATIVE_BUCKETIZE", flag)
        assert als.host_prep_path() == path
        profile = {}
        als.als_train_coo(rows, cols, vals, 30, 20,
                          als.ALSConfig(rank=4, iterations=1), device="cpu",
                          profile=profile)
        assert profile["host_prep_path"] == path
        assert len(calls) == n_calls


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_CACHE", {})
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    monkeypatch.delenv("PIO_NO_NATIVE_BUCKETIZE", raising=False)
    rows, cols, vals = _data(7, 100, 10, 10)
    with pytest.raises(native.NativeBuildError, match="building bucketize failed"):
        als.bucketize(rows, cols, vals, 10, 10)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.NativeBuildError, match="cannot run"):
        native.load_library("idhash")


def test_the_loader_builds_only_sources_of_the_port(tmp_path, monkeypatch):
    here = os.path.dirname(native.__file__)
    for name in native.LIBRARIES:
        for src in native.source_paths(name):
            assert os.path.dirname(src) == here and os.path.exists(src)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_CACHE", {})
    path = native.build_library("bucketize")
    assert os.path.dirname(path) == str(tmp_path / "_build")
    stamp = (tmp_path / "_build" / "libbucketize.stamp").read_text()
    assert native.build_library("bucketize") == path  # current: no rebuild
    assert (tmp_path / "_build" / "libbucketize.stamp").read_text() == stamp
    lib = native.load_library("bucketize")
    assert isinstance(lib, ctypes.CDLL) and native.load_library("bucketize") is lib


def test_native_thread_count_is_positive():
    assert 1 <= als.native_threads() <= 16


def test_training_through_native_prep_matches_numpy_prep(monkeypatch):
    """The same factors, bit for bit, whichever path prepared the slabs."""
    rows, cols, vals = _data(8, 4000, 120, 90)
    cfg = als.ALSConfig(rank=6, iterations=2, lambda_=0.05)
    got = als.als_train_coo(rows, cols, vals, 120, 90, cfg, device="cpu")
    monkeypatch.setenv("PIO_NO_NATIVE_BUCKETIZE", "1")
    want = als.als_train_coo(rows, cols, vals, 120, 90, cfg, device="cpu")
    assert np.array_equal(got.user_factors.numpy(), want.user_factors.numpy())
    assert np.array_equal(got.item_factors.numpy(), want.item_factors.numpy())
