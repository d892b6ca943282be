"""The batched SPD solve's blocked path (128 < n <= SPD_BLOCKED_MAX_N), on
the CPU.

``spd_blocked_kernel`` in ``csrc/spd_solve.cu`` runs only on the card, so
what can be checked here is checked in Python: its launch plan (pure
arithmetic, checked again by the C entry point ``pio_spd_solve_blocked``,
whose check is transcribed here with the source's own constants), the tile
table and index arithmetic, and a numpy emulation of the kernel's order:
the upper triangle in nb × nb tiles padded with identity columns, per
panel of nb columns one warp's nb right-looking steps on the diagonal tile
(L's rows kept in a buffer of their own), the strip right of the panel
stepped against them, the trailing tiles updated with k ascending, and a
blocked back substitution. Every element takes the same FMAs in the same
order as in the wide kernel, so the emulation is held bit for bit
(``np.array_equal``) to ``test_torch_spd.emulate_spd_wide``.
"""

import re

import numpy as np
import pytest

from predictionio_tpu_torch.ops import cuda_kernels
from predictionio_tpu_torch.ops.cuda_kernels import (
    SPD_BLOCKED_MAX_N,
    SPD_BLOCKED_NB,
    SPD_MAX_N,
    spd_blocked_launch_plan,
    spd_blocked_smem,
    spd_launch_plan,
)
from test_torch_spd import SRC, _const, _fma, _plain, _rel_err, _systems, emulate_spd_wide

REL_TOL = 1e-4


# -- the plan ------------------------------------------------------------------
def _blocked_c_entry_accepts(plan, b, n):
    """``pio_spd_solve_blocked``'s check of a plan, transcribed, with the
    source's own constants and ``blk_smem_bytes``."""
    nb = _const("kBlkNb")
    if not (b >= 1 and _const("kMaxN") < n <= _const("kWideMaxN")
            and plan.nb == nb and 32 * plan.warps == _const("kBlkThreads")):
        return False
    t = (n + nb - 1) // nb
    tiles = t * (t + 1) // 2
    want = 4 * (tiles * nb * nb + nb * t * nb + t * nb + nb * nb + 2 * nb + tiles)
    return (want <= _const("kMaxSmem") and plan.tiles == tiles and plan.blocks == b
            and plan.smem == want)


def test_constants_are_the_kernels():
    assert _const("kBlkNb") == SPD_BLOCKED_NB
    assert _const("kBlkThreads") == cuda_kernels.SPD_BLOCKED_THREADS
    # the launch bound allows the registers the plan assumes
    assert 65536 // (_const("kBlkThreads") * _const("kBlkMinBlocks")) >= cuda_kernels.SPD_BLOCKED_REGS
    params = re.search(r'extern "C" int pio_spd_solve_blocked\(([^)]*)\)', SRC).group(1)
    assert len(params.split(",")) == len(
        cuda_kernels._EXTRA_ENTRIES["spd_solve"]["pio_spd_solve_blocked"])
    attrs = re.search(r"pio_spd_solve_attrs\(int\* out\) \{(.*?)\n\}", SRC, re.S).group(1)
    order = re.findall(r"(spd_shared_kernel|spd_blocked_kernel<kBlkNb>|spd_wide_kernel)", attrs)
    assert order == ["spd_shared_kernel", "spd_blocked_kernel<kBlkNb>", "spd_wide_kernel"]
    assert cuda_kernels.SPD_KERNELS[-3:] == ("shared", "blocked", "wide")
    # the smem formula is the source's blk_smem_bytes
    body = re.search(r"blk_smem_bytes\(int t, int nb\) \{(.*?)\n\}", SRC, re.S).group(1)
    assert ("blk_tiles(t) * nb * nb + static_cast<long long>(nb) * t * nb + t * nb + nb * nb + "
            "2LL * nb + blk_tiles(t)") in " ".join(body.split())


def test_the_ceiling_is_the_widest_n_that_fits():
    nb = SPD_BLOCKED_NB
    assert SPD_BLOCKED_MAX_N % nb == 0
    assert spd_blocked_smem(SPD_BLOCKED_MAX_N) <= cuda_kernels.SPD_MAX_SMEM
    assert spd_blocked_smem(SPD_BLOCKED_MAX_N + 1) > cuda_kernels.SPD_MAX_SMEM
    assert SPD_BLOCKED_MAX_N == 304  # nb = 16: 190 tiles, 217,144 bytes
    assert spd_blocked_smem(304) == 217144


@pytest.mark.parametrize("sm_count", [132, 114])
def test_the_path_by_n_alone_and_the_c_entry_check_at_every_size(sm_count):
    for n in range(SPD_MAX_N + 1, SPD_BLOCKED_MAX_N + 2):
        for b in (1, 3, 4096, 97972):
            plan = spd_launch_plan(b, n, sm_count)
            if n > SPD_BLOCKED_MAX_N:  # the cluster path above the ceiling
                assert plan.path == "cluster" and plan.np_ == -(-n // SPD_BLOCKED_NB) * SPD_BLOCKED_NB
                continue
            t = -(-n // SPD_BLOCKED_NB)
            assert plan.path == "blocked" and plan.nb == SPD_BLOCKED_NB
            assert plan.np_ == t * SPD_BLOCKED_NB and plan.tiles == t * (t + 1) // 2
            assert plan.smem <= 232448 and plan.scratch == 0
            assert plan.blocks == b and 1 <= plan.blocks_per_sm
            assert plan.waves == -(-b // (sm_count * plan.blocks_per_sm))
            assert _blocked_c_entry_accepts(plan, b, n), (b, n, plan)
            assert spd_blocked_launch_plan.__wrapped__(b, n, sm_count) == plan  # pure


def test_blocks_an_sm_follow_shared_memory_registers_and_the_card(monkeypatch):
    """n = 129: 4 blocks an SM (shared memory and 64 registers both allow
    4); n = 200: 2 (shared memory); n = 256: 1. The SM count is the
    card's, passed in: at 114 SMs the same batch takes more waves."""
    per_sm = {n: spd_launch_plan(4096, n, 132).blocks_per_sm for n in (129, 200, 256)}
    assert per_sm == {129: 4, 200: 2, 256: 1}
    assert spd_launch_plan(4096, 256, 132).waves == 32
    assert spd_launch_plan(4096, 256, 114).waves == 36
    monkeypatch.setattr(cuda_kernels, "SPD_BLOCKED_REGS", 128)
    heavy = spd_blocked_launch_plan.__wrapped__(4096, 129, 132)
    assert heavy.blocks_per_sm == 2 and heavy.waves == 16


def test_plan_refuses_bad_inputs():
    for args in ((0, 200, 132), (4, 128, 132), (4, SPD_BLOCKED_MAX_N + 1, 132), (4, 200, 0)):
        with pytest.raises(ValueError, match="no spd blocked plan"):
            spd_blocked_launch_plan(*args)


# -- the tile table and indices ------------------------------------------------
def _blk_tile(i, j, t):
    return i * t - i * (i - 1) // 2 + (j - i)


def _table(t):
    """The kernel's tile table: q -> (I, J), by its loop."""
    out = []
    for q in range(t * (t + 1) // 2):
        i, r = 0, q
        while r >= t - i:
            r -= t - i
            i += 1
        out.append((i, i + r))
    return out


@pytest.mark.parametrize("t", [1, 2, 9, 13, 16, 19])
def test_the_tile_table_inverts_the_tile_index(t):
    table = _table(t)
    assert table == [(i, j) for i in range(t) for j in range(i, t)]
    for q, (i, j) in enumerate(table):
        assert _blk_tile(i, j, t) == q
    for p in range(t - 1):  # the trailing tiles of panel p are a suffix
        q0 = _blk_tile(p + 1, p + 1, t)
        assert [ij for ij in table[q0:]] == [(i, j) for i, j in table if i > p]


# -- the kernel's order, emulated ----------------------------------------------
def emulate_spd_blocked(a, b, nb):
    """The blocked kernel's solve of ``a [B, n, n]``, ``b [B, n]`` at tile
    width ``nb``, in its order (all systems at once along axis 0). Reads the
    upper triangle of ``a`` only; U is padded to t·nb with identity
    columns and b = 0. Per panel p (columns s..e-1):

    - the diagonal warp's steps j: inv_d = rsqrt(d2) or 0, z_j = y_j·inv_d,
      l_c = U[j][c]·inv_d for c >= j in the panel (L's row j of the panel,
      kept in a buffer of its own), U[r][c] = fma(-m_r, l_c, U[r][c]) for j
      <= r <= c < e with m = l - e_j, y_c = fma(-m_c, z_j, y_c);
    - the strip (rows s..e-1, columns >= e), a column a thread: steps j
      ascending, l_c = U[j][c]·inv_d into the buffer, the same updates of
      rows j..e-1, y_c = fma(-l_c, z_j, y_c);
    - the trailing tiles (rows and columns >= e, upper): U[r][c] =
      fma(-l_r(k), l_c(k), U[r][c]) for k ascending;

    then back substitution by panels from the last: rows r < e take panel
    p + 1's x (j descending), then the panel's own x_j = y_j·(d > 0 ? 1/d
    : 0), j descending, each taken off the panel's rows above it. (The
    kernel steps panel p + 1's diagonal tile during panel p's trailing
    update, once that tile's own trailing update is done: no element's
    order changes.)"""
    a = np.asarray(a, np.float32)
    bsz, n = np.asarray(b).shape
    t = -(-n // nb)
    np_ = t * nb
    u = np.zeros((bsz, np_, np_), np.float32)
    upper = np.triu(np.ones((n, n), bool))
    u[:, :n, :n] = np.where(upper, a, np.float32(0))
    for c in range(n, np_):
        u[:, c, c] = 1.0  # identity padding
    y = np.zeros((bsz, np_), np.float32)
    y[:, :n] = b
    lbuf = np.zeros((bsz, nb, np_), np.float32)  # row k: l_c of the panel's step k
    lanes = np.arange(nb)
    one = np.float32(1)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for p in range(t):
            s, e = p * nb, p * nb + nb
            inv = np.zeros((bsz, nb), np.float32)
            z = np.zeros((bsz, nb), np.float32)
            tri = np.triu(np.ones((nb, nb), bool))
            for j in range(nb):  # the diagonal warp
                jj = s + j
                d2 = u[:, jj, jj].copy()
                inv_d = np.where(d2 > 0, 1.0 / np.sqrt(d2.astype(np.float64)), 0.0
                                 ).astype(np.float32)
                zj = y[:, jj] * inv_d
                l = np.where(lanes >= j, u[:, jj, s:e] * inv_d[:, None], np.float32(0))
                lbuf[:, j, s:e] = l
                mj = lbuf[:, j, jj] - one
                m = lbuf[:, j, s:e].copy()
                m[:, j] = mj
                blk = _fma(-m[:, j:, None], l[:, None, j:], u[:, jj:e, jj:e])
                u[:, jj:e, jj:e] = np.where(tri[j:, j:], blk, u[:, jj:e, jj:e])
                y[:, jj:e] = _fma(-m[:, j:], zj[:, None], y[:, jj:e])
                inv[:, j], z[:, j] = inv_d, zj
            for j in range(nb):  # the strip, every column at once
                jj = s + j
                lc = u[:, jj, e:] * inv[:, j, None]
                lbuf[:, j, e:] = lc
                m = lbuf[:, j, s:e].copy()
                m[:, j] = lbuf[:, j, jj] - one
                u[:, jj:e, e:] = _fma(-m[:, j:, None], lc[:, None, :], u[:, jj:e, e:])
                y[:, e:] = _fma(-lc, z[:, j, None], y[:, e:])
            if e < np_:  # the trailing tiles, k ascending
                keep = np.triu(np.ones((np_ - e, np_ - e), bool))
                for k in range(nb):
                    lk = lbuf[:, k, e:]
                    blk = _fma(-lk[:, :, None], lk[:, None, :], u[:, e:, e:])
                    u[:, e:, e:] = np.where(keep, blk, u[:, e:, e:])
        x = np.zeros((bsz, np_), np.float32)
        for p in range(t - 1, -1, -1):
            s, e = p * nb, p * nb + nb
            if e < np_:  # rows above panel p + 1 take its x
                for j in range(nb - 1, -1, -1):
                    y[:, :e] = _fma(-u[:, :e, e + j], x[:, e + j, None], y[:, :e])
            for j in range(nb - 1, -1, -1):  # the panel's warp
                jj = s + j
                d = u[:, jj, jj]
                xj = (y[:, jj] * np.where(d > 0, one / d, np.float32(0))).astype(np.float32)
                x[:, jj] = xj
                y[:, s:jj] = _fma(-u[:, s:jj, jj], xj[:, None], y[:, s:jj])
    return x[:, :n]


@pytest.mark.parametrize("n", [129, 136, 200, 256, SPD_BLOCKED_MAX_N])
def test_the_blocked_order_is_the_wide_kernels_bit_for_bit(n):
    a, b = _systems(4, n, k=2 * n, seed=n)
    x = emulate_spd_blocked(a, b, SPD_BLOCKED_NB)
    np.testing.assert_array_equal(x, emulate_spd_wide(a, b))
    assert _rel_err(x, _plain(a, b)) < REL_TOL


def test_the_blocked_order_matches_numpy():
    a, b = _systems(6, 150, k=300, seed=11)
    ref = np.linalg.solve(a.astype(np.float64), b[..., None].astype(np.float64))[..., 0]
    assert _rel_err(emulate_spd_blocked(a, b, SPD_BLOCKED_NB), ref) < REL_TOL


def test_blocked_zero_dead_pivot_lower_triangle_and_nan_cases():
    n, nb = 140, SPD_BLOCKED_NB
    a, b = _systems(6, n, k=200, seed=5)
    a[5] = 0.0  # a zero system solves to exact zeros
    dead = [0, 70, 139]
    a[4, dead, :] = 0.0
    a[4, :, dead] = 0.0
    x = emulate_spd_blocked(a, b, nb)
    assert np.all(np.isfinite(x))
    np.testing.assert_array_equal(x[5], 0.0)
    np.testing.assert_array_equal(x[4, dead], 0.0)
    np.testing.assert_array_equal(x, emulate_spd_wide(a, b))
    garbage = a.copy()
    low = np.tril_indices(n, -1)
    garbage[:, low[0], low[1]] = np.nan
    np.testing.assert_array_equal(emulate_spd_blocked(garbage, b, nb), x)
    a_nan = a.copy()
    a_nan[2, 5, 9] = np.nan
    x_nan = emulate_spd_blocked(a_nan, b, nb)
    assert np.isnan(x_nan[2]).any()
    others = [0, 1, 3, 4, 5]
    np.testing.assert_array_equal(x_nan[others], x[others])
