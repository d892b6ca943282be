"""The batched SPD solve's tiled path (n > SPD_CLUSTER_MAX_N), on the CPU.

The tiled kernels in ``csrc/spd_solve.cu`` run only on the card, so what
can be checked here is checked in Python: the launch plan (pure
arithmetic, checked again by the C entry point ``pio_spd_solve_tiled``,
whose check is transcribed here with the source's own constants), the
working copies' budget and its cut, and a numpy emulation of the kernels'
order on the flat working copy of each system, addressed as the kernels
address it: the copy into nb × nb tiles padded with identity columns, per
panel the diagonal tile's nb right-looking steps, the strip right of it
(L's rows of the panel into their buffer) and the trailing update of every
tile right of and below it with k ascending, then back substitution by
sub-panels of 32 rows. The working copy starts as NaN, so a read before a
write shows in the answer. Every element takes the wide kernel's FMAs in
its order, so the emulation is held bit for bit (``np.array_equal``) to
``test_torch_spd.emulate_spd_wide``. Each launch's blocks are checked for
races: no element written by one block is read or written by another.
"""

import re

import numpy as np
import pytest

from predictionio_tpu_torch.ops import cuda_kernels
from predictionio_tpu_torch.ops.cuda_kernels import (
    SPD_CLUSTER_MAX_N,
    SPD_MAX_N,
    SPD_TILED_KERNELS,
    SPD_TILED_MAX_SCRATCH_BYTES,
    SPD_TILED_NB,
    SPD_WIDE_MAX_N,
    spd_launch_plan,
    spd_tiled_launch_plan,
    spd_tiled_schedule,
    spd_tiled_slices,
    spd_tiled_system_floats,
    spd_tiled_systems,
)
from test_torch_spd import SRC, _const, _fma, _jax, _plain, _rel_err, _systems, emulate_spd_wide

REL_TOL = 1e-4
INT_MAX = 2 ** 31 - 1


# -- the plan ------------------------------------------------------------------
def _c_schedule(t, nb):
    """``tl_for_each_launch``'s blocks a system, transcribed."""
    np_, threads = t * nb, _const("kTlStripThreads")
    out = [t * (t + 1) // 2]
    for p in range(t):
        out.append(1)
        if p + 1 < t:
            m = t - p - 1
            out += [(np_ - (p + 1) * nb + threads - 1) // threads, m * (m + 1) // 2]
    return out + [1]


def _tiled_c_entry_accepts(plan, b, n):
    """``pio_spd_solve_tiled``'s check of a plan for a call of ``b``
    systems, transcribed, with the source's own constants."""
    nb = plan.nb
    if not (b >= 1 and _const("kMaxN") < n <= _const("kWideMaxN") and nb == _const("kTlNb")):
        return False
    t = (n + nb - 1) // nb
    tiles = t * (t + 1) // 2
    threads = _const("kTlThreads")
    want_threads = (threads, _const("kWarp"), _const("kTlStripThreads"), (nb // 4) * (nb // 4),
                    threads)
    work = tiles * nb * nb + t * nb * (1 + nb) + nb * nb + 2 * nb
    blocks = _c_schedule(t, nb)
    return (plan.tiles == tiles and plan.panels == t and plan.scratch == work <= INT_MAX
            and tuple(plan.threads) == want_threads
            and tuple(plan.launch_blocks) == tuple(blocks)
            and all(b * x <= INT_MAX for x in blocks))


def test_constants_are_the_kernels():
    assert _const("kTlNb") == SPD_TILED_NB
    assert _const("kTlThreads") == cuda_kernels.SPD_TILED_THREADS
    assert _const("kTlStripThreads") == cuda_kernels.SPD_TILED_STRIP_THREADS
    assert re.search(r"constexpr int kTlSub = kWarp;", SRC) and cuda_kernels.SPD_TILED_SUB == 32
    enum = re.search(r"enum TlKernel \{([^}]*)\}", SRC).group(1)
    assert [k.strip() for k in enum.split(",")] == [
        "kTl" + k.capitalize() for k in SPD_TILED_KERNELS] + ["kTlKernels"]
    body = re.search(r"tl_system_floats\(int t, int nb\) \{(.*?)\n\}", SRC, re.S).group(1)
    assert ("blk_tiles(t) * nb * nb + static_cast<long long>(t) * nb * (1 + nb) + nb * nb + "
            "2LL * nb") in " ".join(body.split())
    params = re.search(r'extern "C" int pio_spd_solve_tiled\(([^)]*)\)', SRC).group(1)
    assert len(params.split(",")) == len(
        cuda_kernels._EXTRA_ENTRIES["spd_solve"]["pio_spd_solve_tiled"])
    attrs = re.search(r"pio_spd_solve_tiled_attrs\(int\* out\) \{(.*?)\n\}", SRC, re.S).group(1)
    order = re.findall(r"spd_tiled_(\w+)_kernel<kTlNb>", attrs)
    assert order == list(SPD_TILED_KERNELS)
    assert set(cuda_kernels.SPD_TILED_REGS) == set(SPD_TILED_KERNELS)


@pytest.mark.parametrize("sm_count", [132, 114])
def test_the_plan_at_every_size_and_the_c_entry_check(sm_count):
    """Every n from 769 to 2,048 and every 997th above to the ceiling: the
    tiled path, t = ceil(n / 64), 3t launches, the C entry's check."""
    sizes = list(range(SPD_CLUSTER_MAX_N + 1, 2049)) + list(range(2049, SPD_WIDE_MAX_N, 997))
    for n in sizes + [SPD_WIDE_MAX_N]:
        for b in (1, 64, 2000):
            plan = spd_launch_plan(b, n, sm_count)
            t = -(-n // SPD_TILED_NB)
            assert plan.path == "tiled" and plan.nb == SPD_TILED_NB and plan.np_ == t * plan.nb
            assert plan.panels == t and len(plan.launch_blocks) == 3 * t
            assert plan.scratch == spd_tiled_system_floats(n, plan.nb)
            assert plan.systems == min(b, spd_tiled_systems(n)) >= 1
            assert plan.blocks == b * sum(plan.launch_blocks) and plan.smem == 0
            assert plan.blocks_per_sm >= 1
            assert _tiled_c_entry_accepts(plan, plan.systems, n), (b, n, plan)


@pytest.mark.parametrize("n", [129, 200, 304, 305, 768])
def test_a_forced_tiled_plan_passes_the_c_entry_below_its_widths(n):
    """At any n > 128 a plan from spd_tiled_launch_plan forces the tiled
    path, to compare it with the blocked and cluster paths."""
    plan = spd_tiled_launch_plan(64, n, 132)
    assert plan.path == "tiled" and plan.nb == SPD_TILED_NB
    assert spd_launch_plan(64, n, 132).path != "tiled"
    assert _tiled_c_entry_accepts(plan, 64, n)


def test_a_doctored_plan_is_refused_by_the_c_entry():
    plan = spd_tiled_launch_plan(8, 1024, 132)
    assert _tiled_c_entry_accepts(plan, 8, 1024)
    blocks = list(plan.launch_blocks)
    blocks[4] += 1
    for bad in (plan._replace(scratch=plan.scratch + 4), plan._replace(tiles=plan.tiles + 1),
                plan._replace(panels=plan.panels - 1), plan._replace(nb=32),
                plan._replace(threads=plan.threads[:4] + (128,)),
                plan._replace(launch_blocks=tuple(blocks)),
                plan._replace(launch_blocks=plan.launch_blocks[:-1])):
        assert not _tiled_c_entry_accepts(bad, 8, 1024)
    assert not _tiled_c_entry_accepts(plan, 8, 128)


def test_the_schedule_is_the_sources():
    for t in (1, 2, 5, 13, 16, 32):
        for nb in (16, 32, SPD_TILED_NB):
            sched = spd_tiled_schedule(t, nb)
            assert [blocks for _, _, blocks in sched] == _c_schedule(t, nb)
            assert len(sched) == 3 * t
            assert [k for k, _, _ in sched[:2]] == ["copy", "diag"] and sched[-1][0] == "back"
            # each panel's trailing update covers the tiles right of and below it
            for p in range(t - 1):
                (blocks,) = [b for k, q, b in sched if k == "update" and q == p]
                assert blocks == len([(i, j) for i in range(p + 1, t) for j in range(i, t)])


def test_plan_refuses_bad_inputs():
    for args in ((0, 1024, 132), (4, 128, 132), (4, SPD_WIDE_MAX_N + 1, 132), (4, 1024, 0)):
        with pytest.raises(ValueError, match="no spd tiled plan"):
            spd_tiled_launch_plan(*args)


# -- the working copies' budget --------------------------------------------------
def test_the_budget_cuts_a_call_into_slices():
    """About 60 % of A's bytes a system (the tiles of the upper triangle and
    a panel's rows of L); 2 GiB of them a call, never below one."""
    n = 1024
    per_system = 4 * spd_tiled_system_floats(n, SPD_TILED_NB)
    assert per_system < 0.65 * 4 * n * n
    rows = spd_tiled_systems(n)
    assert rows == SPD_TILED_MAX_SCRATCH_BYTES // per_system == 855
    slices = spd_tiled_slices(2000, n)
    assert slices == [(0, 855), (855, 1710), (1710, 2000)]
    assert spd_tiled_slices(64, n) == [(0, 64)] and spd_tiled_slices(0, n) == []
    # the widest system alone overruns the budget: one system a call
    assert spd_tiled_systems(SPD_WIDE_MAX_N) == 1
    assert spd_tiled_slices(3, SPD_WIDE_MAX_N) == [(0, 1), (1, 2), (2, 3)]
    for b in (1, 854, 855, 856, 5000):
        cover = [i for s, e in spd_tiled_slices(b, n) for i in range(s, e)]
        assert cover == list(range(b))
        assert all(e - s <= rows for s, e in spd_tiled_slices(b, n))
    # ALS's systems slice at rank 1,024 (8 GiB of A) is three calls
    assert len(spd_tiled_slices((8 << 30) // (4 * n * (n + 1)), n)) == 3


# -- the kernels' order, emulated ------------------------------------------------
class _Untracked:
    """A footprint that keeps nothing (no race check asked)."""

    def __ior__(self, other):
        return self

    def __iter__(self):
        return iter(())


class _Layout:
    """One system's working copy, as ``tl_system`` lays it out."""

    def __init__(self, n, nb):
        self.n, self.nb = n, nb
        self.t = t = -(-n // nb)
        self.np_ = t * nb
        self.tiles = t * (t + 1) // 2
        self.y = self.tiles * nb * nb
        self.l = self.y + self.np_  # L's rows of a panel; x at the end
        self.ld = self.l + nb * self.np_
        self.inv = self.ld + nb * nb
        self.z = self.inv + nb
        self.floats = self.z + nb
        assert self.floats == spd_tiled_system_floats(n, nb)

    def tile(self, i, j):
        """The first float of tile (i, j) (``blk_tile``)."""
        return (i * self.t - i * (i - 1) // 2 + (j - i)) * self.nb * self.nb

    def at(self, rows, cols):
        """Offsets of U[r][c] for arrays of rows and columns."""
        rows, cols = np.broadcast_arrays(np.asarray(rows), np.asarray(cols))
        nb = self.nb
        i, j = rows // nb, cols // nb
        base = (i * self.t - i * (i - 1) // 2 + (j - i)) * nb * nb
        return base + (rows % nb) * nb + cols % nb

    def lrow(self, k, cols):
        """Offsets of L's row k of the current panel at ``cols``."""
        return self.l + k * self.np_ + np.asarray(cols)


def _diag(w, lay, p, reads, writes):
    """``tl_diag`` on panel p's diagonal tile, every system at once."""
    nb = lay.nb
    r, c = np.arange(nb)[:, None], np.arange(nb)[None, :]
    offs = lay.tile(p, p) + r * nb + c
    upper = r <= c
    u = np.where(upper, w[:, offs], np.float32(0))
    yo = lay.y + p * nb + np.arange(nb)
    y = w[:, yo]
    reads |= set(offs[upper].ravel()) | set(yo)
    lanes = np.arange(nb)
    ld = np.zeros((w.shape[0], nb, nb), np.float32)
    inv = np.zeros((w.shape[0], nb), np.float32)
    z = np.zeros((w.shape[0], nb), np.float32)
    one = np.float32(1)
    for j in range(nb):
        d2 = u[:, j, j]
        inv_d = np.where(d2 > 0, 1.0 / np.sqrt(d2.astype(np.float64)), 0.0).astype(np.float32)
        zj = y[:, j] * inv_d
        l = np.where(lanes >= j, u[:, j, :] * inv_d[:, None], np.float32(0))
        ld[:, j] = l
        m = l.copy()
        m[:, j] = l[:, j] - one
        u[:, j:, :] = _fma(-m[:, j:, None], l[:, None, :], u[:, j:, :])
        y[:, j:] = _fma(-m[:, j:], zj[:, None], y[:, j:])
        inv[:, j], z[:, j] = inv_d, zj
    w[:, offs[upper]] = u[:, upper]
    w[:, yo] = y
    w[:, lay.ld:lay.ld + nb * nb] = ld.reshape(len(w), -1)
    w[:, lay.inv:lay.inv + nb] = inv
    w[:, lay.z:lay.z + nb] = z
    writes |= set(offs[upper].ravel()) | set(yo) | set(range(lay.ld, lay.floats))


def _strip(w, lay, p, cols, reads, writes):
    """``tl_strip`` on the strip columns ``cols`` of panel p."""
    nb = lay.nb
    offs = lay.at(p * nb + np.arange(nb)[:, None], cols[None, :])
    s = w[:, offs]
    ld = w[:, lay.ld:lay.ld + nb * nb].reshape(len(w), nb, nb)
    inv, z = w[:, lay.inv:lay.inv + nb], w[:, lay.z:lay.z + nb]
    y = w[:, lay.y + cols]
    one = np.float32(1)
    for j in range(nb):
        lc = s[:, j, :] * inv[:, j, None]
        w[:, lay.lrow(j, cols)] = lc
        m = ld[:, j, :].copy()
        m[:, j] = ld[:, j, j] - one
        s[:, j:, :] = _fma(-m[:, j:, None], lc[:, None, :], s[:, j:, :])
        y = _fma(-lc, z[:, j, None], y)
    w[:, offs] = s
    w[:, lay.y + cols] = y
    reads |= set(offs.ravel()) | set(lay.y + cols) | set(range(lay.ld, lay.floats))
    writes |= (set(offs.ravel()) | set(lay.y + cols)
               | {int(o) for k in range(nb) for o in lay.lrow(k, cols)})


def _update(w, lay, i, j, reads, writes):
    """One block of the trailing update: tile (i, j) with L's rows of the
    panel at its rows and columns, k ascending; the upper part of a
    diagonal tile."""
    nb = lay.nb
    r, c = np.arange(nb)[:, None], np.arange(nb)[None, :]
    offs = lay.tile(i, j) + r * nb + c
    keep = (r <= c) if i == j else np.ones((nb, nb), bool)
    u = w[:, offs]
    for k in range(nb):
        ri, rj = lay.lrow(k, i * nb + np.arange(nb)), lay.lrow(k, j * nb + np.arange(nb))
        u = np.where(keep, _fma(-w[:, ri][:, :, None], w[:, rj][:, None, :], u), u)
        reads |= set(ri) | set(rj)
    w[:, offs[keep]] = u[:, keep]
    reads |= set(offs.ravel())
    writes |= set(offs[keep].ravel())


def _back(w, lay, x, sub):
    """``spd_tiled_back_kernel``: sub-panels of ``sub`` rows from the
    last; x in L's buffer."""
    np_ = lay.np_
    one = np.float32(1)
    for q in range(np_ // sub - 1, -1, -1):
        s0, e = q * sub, q * sub + sub
        rows = np.arange(s0, e)
        yv = w[:, lay.y + rows]
        d = w[:, lay.at(rows, rows)]
        dinv = np.where(d > 0, one / d, np.float32(0)).astype(np.float32)
        if e < np_:
            for jj in range(e + sub - 1, e - 1, -1):
                yv = _fma(-w[:, lay.at(rows, jj)], w[:, lay.l + jj, None], yv)
        xs = np.zeros_like(yv)
        for j in range(sub - 1, -1, -1):
            xj = (yv[:, j] * dinv[:, j]).astype(np.float32)
            xs[:, j] = xj
            yv[:, :j] = _fma(-w[:, lay.at(rows[:j], s0 + j)], xj[:, None], yv[:, :j])
        above = np.arange(s0)
        if e < np_ and s0:
            ya = w[:, lay.y + above]
            for jj in range(e + sub - 1, e - 1, -1):
                ya = _fma(-w[:, lay.at(above, jj)], w[:, lay.l + jj, None], ya)
            w[:, lay.y + above] = ya
        w[:, lay.y + rows] = yv  # (the kernel keeps warp 0's y in registers)
        w[:, lay.l + rows] = xs
        x[:, rows] = xs


def _collide(blocks):
    """Whether an element one block of a launch writes is read or written by
    another: ``blocks`` holds each block's (reads, writes)."""
    owner = {}
    for k, (_, wk) in enumerate(blocks):
        if any(owner.setdefault(e, k) != k for e in wk):
            return True
    return any(owner.get(e, k) != k for k, (rk, _) in enumerate(blocks) for e in rk)


def emulate_spd_tiled(a, b, nb, sub=32, races=None):
    """The tiled kernels' solve of ``a [B, n, n]``, ``b [B, n]`` at tile
    width ``nb`` (back substitution's sub-panel ``min(sub, nb)`` rows), in
    their launch order (:func:`spd_tiled_schedule`), every system at once
    on a NaN-filled working copy addressed as the kernels address it.
    ``races``, a list, collects each launch whose blocks collide."""
    a = np.asarray(a, np.float32)
    bsz, n = np.asarray(b).shape
    lay = _Layout(n, nb)
    t, np_ = lay.t, lay.np_
    w = np.full((bsz, lay.floats), np.nan, np.float32)
    x = np.zeros((bsz, np_), np.float32)

    def footprint():
        return (set(), set()) if races is not None else (_Untracked(), _Untracked())

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for kernel, p, per_sys in spd_tiled_schedule(t, nb):
            blocks = []
            if kernel == "copy":
                for i in range(t):
                    for j in range(i, t):
                        r = i * nb + np.arange(nb)[:, None]
                        c = j * nb + np.arange(nb)[None, :]
                        inside = (c >= r) & (c < n)
                        vals = np.where(inside, a[:, np.minimum(r, n - 1), np.minimum(c, n - 1)],
                                        np.where(r == c, np.float32(1), np.float32(0)))
                        offs = lay.tile(i, j) + np.arange(nb * nb)
                        w[:, offs] = vals.reshape(bsz, -1)
                        wr = footprint()[1]
                        wr |= set(offs)
                        if i == j:
                            seg = i * nb + np.arange(nb)
                            w[:, lay.y + seg] = np.where(seg < n, np.pad(b, ((0, 0), (0, np_ - n)))
                                                         [:, seg], np.float32(0))
                            wr |= set(lay.y + seg)
                        blocks.append((footprint()[0], wr))
            elif kernel == "diag":
                rd, wr = footprint()
                _diag(w, lay, p, rd, wr)
                blocks.append((rd, wr))
            elif kernel == "strip":
                e = (p + 1) * nb
                threads = cuda_kernels.SPD_TILED_STRIP_THREADS
                for sb in range(per_sys):
                    cols = np.arange(e + sb * threads, min(np_, e + (sb + 1) * threads))
                    rd, wr = footprint()
                    _strip(w, lay, p, cols, rd, wr)
                    blocks.append((rd, wr))
            elif kernel == "update":
                for i in range(p + 1, t):
                    for j in range(i, t):
                        rd, wr = footprint()
                        _update(w, lay, i, j, rd, wr)
                        blocks.append((rd, wr))
                assert len(blocks) == per_sys
            else:
                _back(w, lay, x, min(sub, nb))
            if races is not None and _collide(blocks):
                races.append((kernel, p))
    return x[:, :n]


@pytest.mark.parametrize("n,nb", [(40, 32), (77, 32), (129, 32), (200, 64), (129, 64),
                                  (300, 64), (40, 8), (77, 16), (150, 16), (200, 8)])
def test_the_tiled_order_is_the_wide_kernels_bit_for_bit(n, nb):
    a, b = _systems(3, n, k=2 * n, seed=n + nb)
    x = emulate_spd_tiled(a, b, nb)
    np.testing.assert_array_equal(x, emulate_spd_wide(a, b))
    assert np.all(np.isfinite(x))
    assert _rel_err(x, _plain(a, b)) < REL_TOL


@pytest.mark.parametrize("n,nb", [(330, 64), (560, 32)])
def test_no_two_blocks_of_a_launch_collide(n, nb):
    """The strip spreads over 3 blocks a system at (330, 64) and 5 at
    (560, 32); the trailing update over every tile."""
    a, b = _systems(1, n, k=n + 8, seed=3)
    races = []
    emulate_spd_tiled(a, b, nb, races=races)
    assert races == []
    assert max(blocks for k, _, blocks in spd_tiled_schedule(-(-n // nb), nb) if k == "strip") > 1


def test_a_strip_block_that_overruns_its_columns_is_a_race():
    """Two strip blocks of 128 columns collide only if one steps a column
    of the other's: the check sees one more column."""
    lay = _Layout(600, 32)
    w = np.zeros((1, lay.floats), np.float32)

    def strip_blocks(width):
        blocks = []
        for sb in range(2):
            rd, wr = set(), set()
            _strip(w, lay, 0, 32 + 128 * sb + np.arange(width), rd, wr)
            blocks.append((rd, wr))
        return blocks

    assert not _collide(strip_blocks(128))
    assert _collide(strip_blocks(129))


def test_the_tiled_order_matches_numpy_and_the_jax_kernel():
    a, b = _systems(6, 136, k=272, seed=11)
    x = emulate_spd_tiled(a, b, 32)
    ref = np.linalg.solve(a.astype(np.float64), b[..., None].astype(np.float64))[..., 0]
    assert _rel_err(x, ref) < REL_TOL
    assert _rel_err(x, _jax(a, b)) < REL_TOL


def test_tiled_zero_dead_pivot_lower_triangle_and_nan_cases():
    n, nb = 140, 32
    a, b = _systems(6, n, k=200, seed=5)
    a[5] = 0.0  # a zero system solves to exact zeros
    dead = [0, 70, 139]
    a[4, dead, :] = 0.0
    a[4, :, dead] = 0.0
    x = emulate_spd_tiled(a, b, nb)
    assert np.all(np.isfinite(x))
    np.testing.assert_array_equal(x[5], 0.0)
    np.testing.assert_array_equal(x[4, dead], 0.0)
    np.testing.assert_array_equal(x, emulate_spd_wide(a, b))
    garbage = a.copy()
    low = np.tril_indices(n, -1)
    garbage[:, low[0], low[1]] = np.nan
    np.testing.assert_array_equal(emulate_spd_tiled(garbage, b, nb), x)
    a_nan = a.copy()
    a_nan[2, 5, 9] = np.nan
    x_nan = emulate_spd_tiled(a_nan, b, nb)
    assert np.isnan(x_nan[2]).any()
    others = [0, 1, 3, 4, 5]
    np.testing.assert_array_equal(x_nan[others], x[others])


def test_the_cpu_wrapper_runs_the_plain_version_above_the_cluster_path():
    import torch

    a, b = _systems(2, 770, k=800, seed=2)
    got = cuda_kernels.spd_solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, _plain(a, b))
    assert spd_launch_plan(2, 770, 132).path == "tiled" and SPD_MAX_N < 770
