"""The batched SPD solve's launch plan and arithmetic order, on the CPU.

``csrc/spd_solve.cu`` runs only on the card, so what can be checked here
is checked in Python: :func:`spd_launch_plan` (pure arithmetic, checked
again by the C entry point) at every bucket size of the ALS training
slice, and a numpy emulation of the registers kernel's order: lane c owns
column c (and c + 32 in slot 1), a slot keeps the rows down to its last
column, the system is padded to ``np_`` with identity columns and b = 0,
each step publishes m = l - e_j once and updates ``col[r] = fma(-m_r, l_c,
col[r])`` for r >= j, keeping the published row as row j of U, and back
substitution runs column by column: the owner of j forms ``x_j = y_j /
d`` (d the pivot after its own update) and every lane c takes ``U[c][j]
x_j`` off its y. The emulation
is held against the plain version, the JAX kernel (interpret mode, as
``tests/test_torch_als_kernels.py`` runs it) and ``np.linalg.solve`` at
relative error < 1e-4.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.pallas_kernels import spd_solve_t as jax_spd_solve_t
from predictionio_tpu_torch.ops import cuda_kernels
from predictionio_tpu_torch.ops.cuda_kernels import (
    SPD_MAX_N,
    SPD_REG_MAX_N,
    spd_launch_plan,
    spd_solve,
    spd_solve_reference,
)

REL_TOL = 1e-4

#: systems of every bucket of both sides of the ALS training slice (ML-20M
#: shape, seed 0, 5 % held out), B = 128, and every user system at once
BUCKET_SIZES = [17475, 97972, 18571, 3277, 583, 122, 5023, 17257, 3707, 797,
                216, 128, 138000]
SIZES = [1, 8, 13, 50, 64, 65, 128]

SRC = (pathlib.Path(cuda_kernels.__file__).parent.parent / "kernels" / "csrc"
       / "spd_solve.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


# -- the launch plan -----------------------------------------------------------
def _c_entry_accepts(plan, b, n):
    """``pio_spd_solve``'s check of a plan, transcribed, with the source's
    own constants."""
    regs = n <= _const("kRegMaxN")
    ok = (plan.path == ("registers" if regs else "shared")
          and plan.np_ == (n + 7) // 8 * 8
          and plan.blocks == -(-b // plan.warps) and plan.warps >= 1)
    if regs:
        np_ = plan.np_
        pitch = np_ * (32 * -(-np_ // 32) + _const("kHistPad"))
        return ok and plan.warps == 1 and plan.smem == 4 * pitch
    per_warp = 4 * (n * n + 2 * n)
    want = min(_const("kMaxWarps"), max(1, 48 * 1024 // per_warp))
    return ok and plan.warps == want and plan.smem == per_warp * want


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("n", SIZES)
def test_plan_is_valid_at_every_bucket_size(n, sm_count):
    for b in BUCKET_SIZES:
        plan = spd_launch_plan(b, n, sm_count)
        assert plan.path == ("registers" if n <= 64 else "shared")
        assert plan.np_ % 8 == 0 and n <= plan.np_ < n + 8
        assert plan.slots == -(-plan.np_ // 32)
        assert plan.blocks == -(-b // plan.warps)
        assert plan.blocks_per_sm >= 1
        assert plan.waves == -(-plan.blocks // (sm_count * plan.blocks_per_sm))
        if plan.path == "registers":
            assert plan.warps == 1 and plan.blocks == b
        assert _c_entry_accepts(plan, b, n), (b, n, plan)
        assert spd_launch_plan.__wrapped__(b, n, sm_count) == plan  # pure


def test_plan_passes_the_c_entry_points_check_at_every_size():
    for n in range(1, SPD_MAX_N + 1):
        for b in (1, 3, 33, 128, 5000):
            assert _c_entry_accepts(spd_launch_plan(b, n, 132), b, n), (b, n)


@pytest.mark.parametrize("args", [(0, 50, 132), (4, 0, 132),
                                  (4, cuda_kernels.SPD_WIDE_MAX_N + 1, 132), (4, 50, 0)])
def test_plan_refuses_bad_inputs(args):
    with pytest.raises(ValueError, match="no spd launch plan"):
        spd_launch_plan(*args)


def test_plan_follows_the_card_and_the_registers(monkeypatch):
    """The SM count comes from the card and the blocks an SM holds from
    the kernel's registers at the system's own padded width."""
    wide, narrow = spd_launch_plan(138000, 50, 132), spd_launch_plan(138000, 50, 66)
    assert (wide.blocks, wide.blocks_per_sm) == (narrow.blocks, narrow.blocks_per_sm)
    assert narrow.waves == -(-138000 // (66 * narrow.blocks_per_sm)) > wide.waves
    # registers as allocated, in granules of 8: 152 at np_ = 56 (13
    # warps an SM), 160 at 64 (12)
    assert all(r % 8 == 0 for r in cuda_kernels.SPD_REGS.values())
    assert spd_launch_plan(1000, 50, 132).blocks_per_sm == 13
    assert spd_launch_plan(1000, 64, 132).blocks_per_sm == 12
    monkeypatch.setattr(cuda_kernels, "SPD_REGS",
                        {**cuda_kernels.SPD_REGS, 56: 2 * cuda_kernels.SPD_REGS[56]})
    heavy = spd_launch_plan.__wrapped__(138000, 50, 132)
    assert heavy.blocks_per_sm < wide.blocks_per_sm and heavy.waves > wide.waves
    assert spd_launch_plan.__wrapped__(1000, 40, 132) == spd_launch_plan(1000, 40, 132)


def test_wrapper_passes_as_many_arguments_as_the_c_entry_takes():
    params = re.search(r'extern "C" int pio_spd_solve\(([^)]*)\)', SRC).group(1)
    assert len(params.split(",")) == len(cuda_kernels._SPD_ARGTYPES)
    attrs = re.search(r"pio_spd_solve_attrs\(int\* out\) \{(.*?)\n\}", SRC, re.S).group(1)
    assert attrs.count("reinterpret_cast<const void*>") == len(cuda_kernels.SPD_KERNELS)
    widths = [int(w) for w in re.findall(r"spd_reg_kernel<(\d+)>", attrs)]
    assert widths == sorted(cuda_kernels.SPD_REGS) == list(range(8, SPD_REG_MAX_N + 1, 8))
    assert SPD_REG_MAX_N == _const("kRegMaxN")
    assert cuda_kernels.SPD_HIST_PAD == _const("kHistPad")


# -- the registers kernel's arithmetic, emulated -------------------------------
def _fma(a, b, c):
    """float32 fma(a, b, c) through float64 (the product is exact there)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_spd(a, b, np_):
    """The registers kernel's solve of ``a [B, n, n]``, ``b [B, n]`` at
    padded width ``np_``, in its order, one system a warp (all systems
    at once along axis 0). Reads the upper triangle of ``a`` only. The
    card's 1/d is a 2-ulp reciprocal; here it is exact."""
    a = np.asarray(a, np.float32)
    bsz, n = np.asarray(b).shape
    slots = -(-np_ // 32)
    cols = 32 * slots
    rows = [min(np_, 32 * (s + 1)) for s in range(slots)]
    col = np.zeros((bsz, cols, np_), np.float32)  # [system, lane column, row]
    for c in range(n):
        col[:, c, :c + 1] = a[:, :c + 1, c]  # rows r <= c: the upper triangle
    for c in range(n, np_):
        col[:, c, c] = 1.0  # identity padding
    y = np.zeros((bsz, cols), np.float32)
    y[:, :n] = b
    hist = np.zeros((bsz, np_, cols), np.float32)  # row j: the m step j published
    dinv = np.zeros((bsz, np_), np.float32)
    lanes = np.arange(cols)
    one = np.float32(1)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for j in range(np_):
            d2 = col[:, j, j].copy()
            inv_d = np.where(d2 > 0, (1.0 / np.sqrt(d2.astype(np.float64))), 0.0
                             ).astype(np.float32)
            zj = y[:, j] * inv_d
            lj = d2 * inv_d
            dj = _fma(-(lj - one), lj, d2)  # the pivot after its own update
            dinv[:, j] = np.where(dj > 0, one / dj, np.float32(0))
            l = np.where(lanes >= j, col[:, :, j] * inv_d[:, None], np.float32(0))
            m = np.where(lanes == j, l - one, l).astype(np.float32)
            hist[:, j] = m
            for s in range(slots):
                if j >= rows[s]:
                    continue  # every column of the slot is left of j
                cs = slice(32 * s, 32 * s + 32)
                col[:, cs, j:rows[s]] = _fma(-m[:, None, j:rows[s]], l[:, cs, None],
                                            col[:, cs, j:rows[s]])
                y[:, cs] = _fma(-m[:, cs], zj[:, None], y[:, cs])
        # back substitution, column by column: x_j = y_j / d on its owner,
        # then every lane c takes U[c][j] x_j (row c of U) off its y
        xs = np.zeros((bsz, cols), np.float32)
        u = hist[:, np.minimum(lanes, np_ - 1), :]  # [system, lane, column]
        for j in range(np_ - 1, -1, -1):
            xj = y[:, j] * dinv[:, j]
            xs[:, j] = xj
            for s in range(slots):
                if 32 * s < j:
                    cs = slice(32 * s, 32 * s + 32)
                    y[:, cs] = _fma(-u[:, cs, j], xj[:, None], y[:, cs])
    return xs[:, :n]


def _systems(bsz, n, k=64, seed=0, lam=0.05):
    """ALS-like SPD systems: a Gramian plus a ridge λ·k."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((bsz, k, n)).astype(np.float32)
    a = (np.einsum("bkr,bks->brs", g, g) + lam * k * np.eye(n, dtype=np.float32))
    return a.astype(np.float32), rng.standard_normal((bsz, n)).astype(np.float32)


def _rel_err(x, ref):
    return float(np.max(np.linalg.norm(x - ref, axis=-1)
                        / np.maximum(np.linalg.norm(ref, axis=-1), 1e-30)))


def _plain(a, b):
    return spd_solve_reference(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _jax(a, b):
    """The JAX kernel in interpret mode, padded to its n % 8 and B % 128."""
    bsz, n = b.shape
    n8, b128 = -(-n // 8) * 8, -(-bsz // 128) * 128
    a_t = np.zeros((n8, n8, b128), np.float32)
    a_t[:n, :n, :bsz] = np.transpose(a, (1, 2, 0))
    b_t = np.zeros((n8, b128), np.float32)
    b_t[:n, :bsz] = b.T
    return np.asarray(jax_spd_solve_t(jnp.asarray(a_t), jnp.asarray(b_t)))[:n, :bsz].T


@pytest.mark.parametrize("n", [1, 8, 13, 33, 50, 64])
def test_emulation_matches_plain_and_numpy(n):
    a, b = _systems(24, n, seed=n)
    x = emulate_spd(a, b, -(-n // 8) * 8)
    ref = np.linalg.solve(a.astype(np.float64), b[..., None].astype(np.float64))[..., 0]
    assert _rel_err(x, ref) < REL_TOL
    assert _rel_err(x, _plain(a, b)) < REL_TOL


@pytest.mark.parametrize("n", [13, 50])
def test_emulation_matches_the_jax_kernel(n):
    a, b = _systems(128, n, seed=7 + n)
    x = emulate_spd(a, b, -(-n // 8) * 8)
    assert _rel_err(x, _jax(a, b)) < REL_TOL


@pytest.mark.parametrize("n,np_", [(1, 8), (13, 16), (13, 24), (33, 40), (33, 64),
                                   (50, 56), (50, 64), (57, 64)])
def test_padding_changes_no_bit(n, np_):
    """Identity columns with b = 0 add exact zeros: the first n
    components at np_ > n equal those at np_ = n."""
    a, b = _systems(16, n, seed=np_)
    np.testing.assert_array_equal(emulate_spd(a, b, np_), emulate_spd(a, b, n))


def test_zero_systems_solve_to_exact_zeros():
    a, b = _systems(8, 50, seed=1)
    a[4:] = 0.0
    x = emulate_spd(a, b, 56)
    assert np.all(np.isfinite(x))
    np.testing.assert_array_equal(x[4:], 0.0)
    assert _rel_err(x[:4], _plain(a[:4], b[:4])) < REL_TOL


def test_dead_pivots_give_zero_components():
    a, b = _systems(8, 50, seed=2)
    dead = [3, 17, 31, 32, 49]
    a[:, dead, :] = 0.0
    a[:, :, dead] = 0.0
    x = emulate_spd(a, b, 56)
    assert np.all(np.isfinite(x))
    np.testing.assert_array_equal(x[:, dead], 0.0)
    assert _rel_err(x, _plain(a, b)) < REL_TOL


def test_lower_triangle_is_never_read():
    a, b = _systems(6, 50, seed=3)
    garbage = a.copy()
    low = np.tril_indices(50, -1)
    garbage[:, low[0], low[1]] = np.nan
    np.testing.assert_array_equal(emulate_spd(garbage, b, 56), emulate_spd(a, b, 56))


def test_a_nan_system_stays_in_its_own_system():
    a, b = _systems(6, 50, seed=4)
    a_nan = a.copy()
    a_nan[2, 5, 9] = np.nan
    x = emulate_spd(a_nan, b, 56)
    assert np.isnan(x[2]).any()
    others = [0, 1, 3, 4, 5]
    np.testing.assert_array_equal(x[others], emulate_spd(a[others], b[others], 56))


def test_cpu_wrapper_runs_the_plain_version_on_both_paths():
    for n in (50, 65):
        a, b = _systems(4, n, seed=n)
        x = spd_solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_array_equal(x, _plain(a, b))
    assert spd_launch_plan(4, 65, 132).path == "shared"


# -- the wide path (n > 128) -----------------------------------------------------
def _wide_c_entry_accepts(plan, b, n):
    """``pio_spd_solve_wide``'s check of a plan, transcribed, with the
    source's own constants."""
    if not _const("kMaxN") < n <= _const("kWideMaxN"):
        return False
    tri = n * (n + 1) // 2
    in_smem = 4 * (tri + 2 * n)
    fits = in_smem <= _const("kMaxSmem")
    threads = min((n + 31) // 32 * 32, _const("kWideThreads"))
    return (32 * plan.warps == threads and plan.blocks == b
            and plan.smem == (in_smem if fits else 8 * n)
            and plan.scratch == (0 if fits else tri))


@pytest.mark.parametrize("sm_count", [132, 114])
def test_wide_plan_passes_the_c_entry_points_check(sm_count):
    for n in list(range(129, 513)) + [1000, 4096]:
        for b in (1, 3, 4096, 97972):
            plan = spd_launch_plan(b, n, sm_count)
            assert plan.path == "wide" and plan.np_ == n
            assert plan.blocks_per_sm >= 1
            assert plan.waves == -(-b // (sm_count * plan.blocks_per_sm))
            assert _wide_c_entry_accepts(plan, b, n), (b, n, plan)
    # the packed triangle sits in shared memory up to n = 338, in scratch above
    assert spd_launch_plan(8, 338, 132).scratch == 0
    assert spd_launch_plan(8, 339, 132).scratch == 339 * 340 // 2


def test_wide_constants_are_the_kernels():
    assert _const("kWideThreads") == cuda_kernels.SPD_WIDE_THREADS
    assert _const("kWideMaxN") == cuda_kernels.SPD_WIDE_MAX_N
    assert _const("kMaxSmem") == cuda_kernels.SPD_MAX_SMEM
    assert 65536 // (_const("kWideThreads") * _const("kWideMinBlocks")) \
        == cuda_kernels.SPD_WIDE_REGS
    params = re.search(r'extern "C" int pio_spd_solve_wide\(([^)]*)\)', SRC).group(1)
    assert len(params.split(",")) == len(cuda_kernels._WIDE_ARGTYPES["spd_solve"])
    assert cuda_kernels.SPD_KERNELS[-1] == "wide"


@pytest.mark.parametrize("n", [1, 50, 64, 65, 128, 129, 200, 256, 512])
def test_the_path_is_picked_by_the_system_size_alone(n):
    want = "registers" if n <= 64 else ("shared" if n <= SPD_MAX_N else "wide")
    for b in BUCKET_SIZES + [1, 3]:
        assert spd_launch_plan(b, n, 132).path == want


def emulate_spd_wide(a, b):
    """The wide kernel's solve of ``a [B, n, n]``, ``b [B, n]`` in its
    order (all systems at once along axis 0): the upper triangle only;
    step j forms l_c = U[j][c] * inv_d (c >= j), then U[r][c] =
    fma(-m_r, l_c, U[r][c]) for j <= r <= c with m = l - e_j, and y_c =
    fma(-m_c, z_j, y_c); back substitution column by column, x_j = y_j *
    (d > 0 ? 1/d : 0), then y_r = fma(-U[r][j], x_j, y_r) for r < j."""
    a = np.asarray(a, np.float32)
    bsz, n = np.asarray(b).shape
    u = np.where(np.triu(np.ones((n, n), bool)), a, np.float32(0)).astype(np.float32)
    y = np.asarray(b, np.float32).copy()
    cols = np.arange(n)
    upper = np.triu(np.ones((n, n), bool))
    one = np.float32(1)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for j in range(n):
            d2 = u[:, j, j].copy()
            inv_d = np.where(d2 > 0, 1.0 / np.sqrt(d2.astype(np.float64)), 0.0
                             ).astype(np.float32)
            zj = y[:, j] * inv_d
            l = np.where(cols >= j, u[:, j, :] * inv_d[:, None], np.float32(0))
            m = np.where(cols == j, l - one, l).astype(np.float32)
            blk = _fma(-m[:, j:, None], l[:, None, j:], u[:, j:, j:])
            u[:, j:, j:] = np.where(upper[j:, j:], blk, u[:, j:, j:])
            y[:, j:] = _fma(-m[:, j:], zj[:, None], y[:, j:])
        x = np.zeros((bsz, n), np.float32)
        for j in range(n - 1, -1, -1):
            d = u[:, j, j]
            xj = (y[:, j] * np.where(d > 0, one / d, np.float32(0))).astype(np.float32)
            x[:, j] = xj
            y[:, :j] = _fma(-u[:, :j, j], xj[:, None], y[:, :j])
    return x


@pytest.mark.parametrize("n", [129, 136, 200])
def test_wide_emulation_matches_plain_numpy_and_jax(n):
    a, b = _systems(8, n, k=2 * n, seed=n)
    x = emulate_spd_wide(a, b)
    ref = np.linalg.solve(a.astype(np.float64), b[..., None].astype(np.float64))[..., 0]
    assert _rel_err(x, ref) < REL_TOL
    assert _rel_err(x, _plain(a, b)) < REL_TOL
    if n % 8 == 0:
        assert _rel_err(x, _jax(a, b)) < REL_TOL


def test_wide_zero_dead_pivot_lower_triangle_and_nan_cases():
    n = 140
    a, b = _systems(6, n, k=200, seed=5)
    a[5] = 0.0  # a zero system solves to exact zeros
    dead = [0, 70, 139]
    a[4, dead, :] = 0.0
    a[4, :, dead] = 0.0
    x = emulate_spd_wide(a, b)
    assert np.all(np.isfinite(x))
    np.testing.assert_array_equal(x[5], 0.0)
    np.testing.assert_array_equal(x[4, dead], 0.0)
    assert _rel_err(x[:5], _plain(a[:5], b[:5])) < REL_TOL
    garbage = a.copy()
    low = np.tril_indices(n, -1)
    garbage[:, low[0], low[1]] = np.nan
    np.testing.assert_array_equal(emulate_spd_wide(garbage, b), x)
    a_nan = a.copy()
    a_nan[2, 5, 9] = np.nan
    x_nan = emulate_spd_wide(a_nan, b)
    assert np.isnan(x_nan[2]).any()
    others = [0, 1, 3, 4, 5]
    np.testing.assert_array_equal(x_nan[others], x[others])
