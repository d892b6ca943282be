"""The batched SPD solve's cluster path (SPD_BLOCKED_MAX_N < n <=
SPD_CLUSTER_MAX_N), on the CPU.

``spd_cluster_kernel`` in ``csrc/spd_solve.cu`` runs only on the card, so
what can be checked here is checked in Python: its launch plan (pure
arithmetic, checked again by the C entry point ``pio_spd_solve_cluster``,
whose check is transcribed here with the source's own constants), the
tile ownership and its index arithmetic, and a numpy emulation of the
kernel's order on C blocks: each block holds its tile columns (J mod C)
and y's segments in memory of its own, reads its own memory and, where the
kernel reads or writes another block's shared memory, that block's; the
cluster barriers divide the phases, and within a phase no two blocks may
touch one element when either writes it (the emulation raises). Every
element takes the blocked path's FMAs in its order, so the emulation is
held bit for bit (``np.array_equal``) to ``test_torch_spd.emulate_spd_wide``.
"""

import re

import numpy as np
import pytest

from predictionio_tpu_torch.ops import cuda_kernels
from predictionio_tpu_torch.ops.cuda_kernels import (
    SPD_BLOCKED_MAX_N,
    SPD_BLOCKED_NB,
    SPD_CLUSTER_MAX_N,
    SPD_CLUSTER_SIZES,
    spd_cluster_columns,
    spd_cluster_launch_plan,
    spd_cluster_size,
    spd_cluster_smem,
    spd_cluster_table,
    spd_cluster_tiles,
    spd_launch_plan,
)
from test_torch_spd import SRC, _const, _fma, _jax, _plain, _rel_err, _systems, emulate_spd_wide

REL_TOL = 1e-4
#: the widest system of a cluster of 2
C2_MAX_N = 432


# -- the plan ------------------------------------------------------------------
def _cl_max_tiles(t, c):
    """``cl_max_tiles``: the largest block's tiles, by the source's sum."""
    return max(sum(j + 1 for j in range(r, t, c)) for r in range(c))


def _cluster_c_entry_accepts(plan, b, n):
    """``pio_spd_solve_cluster``'s check of a plan, transcribed, with the
    source's own constants and ``cl_smem_bytes``."""
    nb = _const("kBlkNb")
    sizes = [int(v) for v in re.search(r"constexpr int kClSizes\[\] = \{([^}]*)\}", SRC)
             .group(1).split(",")]
    if not (b >= 1 and _const("kMaxN") < n <= _const("kWideMaxN") and plan.nb == nb
            and 32 * plan.warps == _const("kClThreads") and plan.cluster in sizes):
        return False
    t = (n + nb - 1) // nb
    tiles = _cl_max_tiles(t, plan.cluster)
    want = 4 * (tiles * nb * nb + nb * t * nb + t * nb + nb * nb + 2 * nb + tiles)
    return (want <= _const("kMaxSmem") and plan.tiles == tiles
            and plan.blocks == b * plan.cluster and plan.smem == want)


def test_constants_are_the_kernels():
    assert _const("kClThreads") == cuda_kernels.SPD_CLUSTER_THREADS
    # the launch bound allows the registers the plan assumes, as allocated
    regs = cuda_kernels.SPD_CLUSTER_REGS
    assert sorted(regs) == list(SPD_CLUSTER_SIZES) and all(r % 8 == 0 for r in regs.values())
    assert min(255, 65536 // (_const("kClThreads") * _const("kClMinBlocks"))) >= max(regs.values())
    sizes = re.search(r"constexpr int kClSizes\[\] = \{([^}]*)\}", SRC).group(1)
    assert tuple(int(v) for v in sizes.split(",")) == SPD_CLUSTER_SIZES
    params = re.search(r'extern "C" int pio_spd_solve_cluster\(([^)]*)\)', SRC).group(1)
    assert len(params.split(",")) == len(
        cuda_kernels._EXTRA_ENTRIES["spd_solve"]["pio_spd_solve_cluster"])
    params = re.search(r'extern "C" int pio_spd_solve_cluster_occupancy\(([^)]*)\)', SRC).group(1)
    assert len(params.split(",")) == len(
        cuda_kernels._EXTRA_ENTRIES["spd_solve"]["pio_spd_solve_cluster_occupancy"])
    attrs = re.search(r"pio_spd_solve_cluster_attrs\(int\* out\) \{(.*?)\n\}", SRC, re.S).group(1)
    sizes = [int(c) for c in re.findall(r"spd_cluster_kernel<kBlkNb, (\d+)>", attrs)]
    assert tuple(f"cluster_c{c}" for c in sizes) == cuda_kernels.SPD_CLUSTER_KERNELS
    # the smem formula is the source's cl_smem_bytes
    body = re.search(r"cl_smem_bytes\(int t, int c, int nb\) \{(.*?)\n\}", SRC, re.S).group(1)
    assert ("cl_max_tiles(t, c) * nb * nb + static_cast<long long>(nb) * t * nb + t * nb + "
            "nb * nb + 2LL * nb + cl_max_tiles(t, c)") in " ".join(body.split())


def test_the_ceiling_is_the_widest_n_that_fits():
    """The cluster sizes' ceilings: 432, 576 and 768 (the largest block's
    share against SPD_MAX_SMEM), each the widest n that fits."""
    smem = cuda_kernels.SPD_MAX_SMEM
    ceilings = {}
    for c in SPD_CLUSTER_SIZES:
        n = SPD_BLOCKED_NB
        while spd_cluster_smem(n + SPD_BLOCKED_NB, c) <= smem:
            n += SPD_BLOCKED_NB
        assert spd_cluster_smem(n, c) <= smem < spd_cluster_smem(n + 1, c)
        ceilings[c] = n
    assert ceilings == {2: C2_MAX_N, 4: 576, 8: 768}
    assert SPD_CLUSTER_MAX_N == ceilings[max(SPD_CLUSTER_SIZES)] == 768
    assert spd_cluster_size(SPD_CLUSTER_MAX_N + 1) == 0
    # the largest block's share at n = 305 / 384 / 512 (bytes)
    assert [spd_cluster_smem(n, 2) for n in (305, 384)] == [135992, 187632]
    assert [spd_cluster_smem(n, 4) for n in (305, 384, 512)] == [84592, 113616, 184000]


@pytest.mark.parametrize("sm_count", [132, 114])
def test_the_plan_at_every_size_and_the_c_entry_check(sm_count):
    for n in range(SPD_BLOCKED_MAX_N + 1, SPD_CLUSTER_MAX_N + 2):
        for b in (1, 3, 1024, 97972):
            plan = spd_launch_plan(b, n, sm_count)
            if n > SPD_CLUSTER_MAX_N:  # the tiled path above the ceiling
                assert plan.path == "tiled" and plan.np_ == -(-n // plan.nb) * plan.nb
                continue
            t = -(-n // SPD_BLOCKED_NB)
            c = 2 if n <= C2_MAX_N else 4 if n <= 576 else 8
            assert plan.path == "cluster" and plan.cluster == c == spd_cluster_size(n)
            assert plan.nb == SPD_BLOCKED_NB and plan.np_ == t * SPD_BLOCKED_NB
            assert plan.tiles == max(spd_cluster_tiles(t, c, r) for r in range(c))
            assert plan.smem <= 232448 and plan.scratch == 0 and plan.blocks == b * c
            assert plan.blocks_per_sm >= 1
            assert plan.waves == -(-b // max(1, sm_count * plan.blocks_per_sm // c))
            assert _cluster_c_entry_accepts(plan, b, n), (b, n, plan)
            assert spd_cluster_launch_plan.__wrapped__(b, n, sm_count) == plan  # pure


def _forced_plan(b, n, c):
    """A plan of the cluster kernel at ``n`` on a forced cluster of ``c``
    blocks (the kernel takes any n above SPD_MAX_N whose blocks fit), built
    as chip_smoke builds one to compare the sizes: the plan of the
    narrowest n that takes ``c`` with n's width, tiles and shared memory."""
    t = -(-n // SPD_BLOCKED_NB)
    first = next(m for m in range(SPD_BLOCKED_MAX_N + 1, SPD_CLUSTER_MAX_N + 1)
                 if spd_cluster_size(m) == c)
    return spd_launch_plan(b, first, 132)._replace(
        np_=t * SPD_BLOCKED_NB, slots=-(-t * SPD_BLOCKED_NB // cuda_kernels.SPD_CLUSTER_THREADS),
        blocks=b * c, smem=spd_cluster_smem(n, c),
        tiles=max(spd_cluster_tiles(t, c, r) for r in range(c)), cluster=c)


@pytest.mark.parametrize("c", SPD_CLUSTER_SIZES)
def test_a_forced_cluster_size_passes_the_c_entry_where_it_fits(c):
    for n in (129, 200, 304, 305, 384, 432, 433, 576, 577, 768):
        plan = _forced_plan(64, n, c)
        fits = spd_cluster_smem(n, c) <= cuda_kernels.SPD_MAX_SMEM
        assert _cluster_c_entry_accepts(plan, 64, n) == fits, (c, n)
        if SPD_BLOCKED_MAX_N < n <= SPD_CLUSTER_MAX_N and c == spd_cluster_size(n):
            assert plan == spd_launch_plan(64, n, 132)


def test_blocks_an_sm_and_waves_follow_the_card():
    """One block an SM at n = 305 (136 KB); clusters at once from the SMs:
    66 clusters of 2 on 132 SMs, 57 on 114."""
    plan = spd_launch_plan(1024, 305, 132)
    assert plan.blocks_per_sm == 1 and plan.waves == -(-1024 // 66)
    assert spd_launch_plan(1024, 305, 114).waves == -(-1024 // 57)
    assert spd_launch_plan(1024, 512, 132).waves == -(-1024 // 33)
    # registers, not shared memory, hold a forced cluster of 4 at n = 200
    # (57 KB a block) to one block an SM
    forced = _forced_plan(1024, 200, 4)
    assert forced.smem < 116 * 1024
    regs = cuda_kernels.SPD_CLUSTER_REGS[4]
    assert cuda_kernels._spd_blocks_per_sm(forced.warps, forced.smem, None) >= 2
    assert cuda_kernels._spd_blocks_per_sm(forced.warps, forced.smem, regs) == 1


def test_plan_refuses_bad_inputs():
    for args in ((0, 400, 132), (4, 128, 132), (4, 304, 132), (4, 400, 0)):
        with pytest.raises(ValueError, match="no spd cluster plan"):
            spd_cluster_launch_plan(*args)
    with pytest.raises(ValueError, match="no spd cluster plan"):
        spd_cluster_launch_plan(4, SPD_CLUSTER_MAX_N + 1, 132)
    # a cluster size the kernel has no instance of is refused by the C entry
    plan = spd_launch_plan(4, 400, 132)
    for c in (1, 3, 16):
        assert not _cluster_c_entry_accepts(plan._replace(cluster=c, blocks=4 * c), 4, 400)


@pytest.mark.parametrize("n", [1, 64, 65, 128, 129, 304, 305, 432, 433, 768, 769, 1000])
def test_the_path_is_picked_by_n_alone(n):
    want = ("registers" if n <= 64 else "shared" if n <= 128 else "blocked" if n <= 304
            else "cluster" if n <= 768 else "tiled")
    for b in (1, 3, 128, 1024, 97972):
        assert spd_launch_plan(b, n, 132).path == want


# -- tile ownership and indices ------------------------------------------------
def _cl_first(i, c, rank):
    return 0 if i <= rank else (i - rank + c - 1) // c


def _cl_row_start(i, m, c, rank):
    """``cl_row_start``, transcribed: rows 0..i-1's tiles of the block."""
    u = i - 1 - rank
    if u <= 0:
        return i * m
    q, r = divmod(u, c)
    return i * m - (c * q * (q + 1) // 2 + r * (q + 1))


def _cl_tile(i, j, m, c, rank):
    return _cl_row_start(i, m, c, rank) + (j - rank) // c - _cl_first(i, c, rank)


@pytest.mark.parametrize("t", [1, 2, 9, 13, 20, 24, 27, 32, 36, 48])
@pytest.mark.parametrize("c", SPD_CLUSTER_SIZES)
def test_the_tile_ownership_inverts(t, c):
    """Every tile of the upper triangle has one block, that of its column;
    each block's index arithmetic inverts its tile table; its trailing
    tiles of panel p are a suffix of the table."""
    seen = []
    for rank in range(c):
        m = spd_cluster_columns(t, c, rank)
        table = spd_cluster_table(t, c, rank)
        assert len(table) == spd_cluster_tiles(t, c, rank)
        assert all(j % c == rank and i <= j for i, j in table)
        for q, (i, j) in enumerate(table):
            assert _cl_tile(i, j, m, c, rank) == q
        for i in range(t + 1):
            assert _cl_row_start(i, m, c, rank) == sum(1 for ti, _ in table if ti < i)
        for p in range(t - 1):
            q0 = _cl_row_start(p + 1, m, c, rank)
            assert table[q0:] == [(i, j) for i, j in table if i > p]
        seen += table
    assert sorted(seen) == [(i, j) for i in range(t) for j in range(i, t)]


# -- the kernel's order on a cluster, emulated ---------------------------------
class ClusterRace(AssertionError):
    """Two blocks touched one element in one phase, and one of them wrote it."""


class _Cluster:
    """C blocks' shared memory (every array with the systems on axis 0) and
    the accesses of the current phase: ``get``/``put`` name the acting
    block, the block whose memory it is and the element; ``barrier`` ends
    the phase and raises :class:`ClusterRace` where two blocks touched one
    element and one of them wrote it."""

    def __init__(self, c, shapes, bsz):
        self.c = c
        self.mem = [{k: np.zeros((bsz,) + s, np.float32) for k, s in shapes.items()}
                    for _ in range(c)]
        self.log = {}
        self.phases = 0

    def _mark(self, actor, holder, buf, idx, write):
        key = (holder, buf, actor)
        if key not in self.log:
            shape = self.mem[holder][buf].shape[1:]
            self.log[key] = (np.zeros(shape, bool), np.zeros(shape, bool))
        self.log[key][1 if write else 0][idx] = True

    def get(self, actor, holder, buf, idx):
        self._mark(actor, holder, buf, idx, False)
        return self.mem[holder][buf][(slice(None),) + idx].copy()

    def put(self, actor, holder, buf, idx, value):
        self._mark(actor, holder, buf, idx, True)
        self.mem[holder][buf][(slice(None),) + idx] = value

    def barrier(self):
        for (holder, buf, actor), (read, wrote) in self.log.items():
            for (h2, b2, other), (read2, wrote2) in self.log.items():
                if (h2, b2) == (holder, buf) and other != actor and (wrote & (read2 | wrote2)).any():
                    raise ClusterRace(f"blocks {actor} and {other} on block {holder}'s {buf} "
                                      f"in phase {self.phases}")
        self.log = {}
        self.phases += 1


def emulate_spd_cluster(a, b, c, nb=SPD_BLOCKED_NB, skip_barriers=()):
    """The cluster kernel's solve of ``a [B, n, n]``, ``b [B, n]`` on ``c``
    blocks a system, in its order (all systems at once along axis 0).
    Reads the upper triangle of ``a`` only, padded to t·nb with identity
    columns and b = 0. Block ``rank`` holds the tiles (I, J) of its columns
    J = rank mod c (row-major: ``spd_cluster_table``), y (its segments used),
    L's strip rows ``l [nb, np]`` (row 0 x in back substitution) and the
    panel's diagonal L rows, inv_d and z_j. Phases, a cluster barrier after
    each (``skip_barriers`` names barriers to leave out, so that a test sees
    the race that follows):

    - ``copy``: each block its tiles and y;
    - panel p, ``strip``: each block steps its columns right of the panel
      against its copy of the diagonal rows and pushes each column's L rows
      into every block's ``l``;
    - panel p, ``trailing``: each block updates its tiles below the panel
      from its own ``l``, k ascending; the owner of panel p + 1 steps that
      diagonal tile (its update first) and pushes its L rows, inv_d and z_j
      into every block;
    - back substitution, panel p descending: the owner of panel p takes
      panel p + 1's x (pushed into its memory) off the panel's rows, with
      tile (p, p + 1) read from the owner of p + 1 a panel ahead, solves the
      panel and pushes its x into the owner of panel p - 1; meanwhile the
      owner of p + 1 takes its x off every row above panel p, in the block
      that holds each y_r."""
    a = np.asarray(a, np.float32)
    bsz, n = np.asarray(b).shape
    t = -(-n // nb)
    np_ = t * nb
    tmax = max(spd_cluster_tiles(t, c, r) for r in range(c))
    cl = _Cluster(c, {"u": (tmax, nb, nb), "l": (nb, np_), "y": (np_,), "ld": (nb, nb),
                      "inv": (nb,), "z": (nb,)}, bsz)
    tables = [spd_cluster_table(t, c, r) for r in range(c)]
    index = [{ij: q for q, ij in enumerate(tab)} for tab in tables]
    u = np.zeros((bsz, np_, np_), np.float32)
    u[:, :n, :n] = np.where(np.triu(np.ones((n, n), bool)), a, np.float32(0))
    for col in range(n, np_):
        u[:, col, col] = 1.0  # identity padding
    y0 = np.zeros((bsz, np_), np.float32)
    y0[:, :n] = b
    lanes = np.arange(nb)
    tri = np.triu(np.ones((nb, nb), bool))
    one = np.float32(1)

    def barrier(name):
        if name not in skip_barriers:
            cl.barrier()

    def tile(i, j):
        return u[:, i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]

    for r in range(c):  # copy
        for q, (i, j) in enumerate(tables[r]):
            blk = tile(i, j)
            cl.put(r, r, "u", (q,), np.where(tri, blk, np.float32(0)) if i == j else blk)
        cl.put(r, r, "y", (slice(None),), y0)
    barrier("copy")

    def panel(r, p):
        """Warp 0 of block r (the owner of panel p) steps the diagonal tile."""
        q = index[r][(p, p)]
        d = cl.get(r, r, "u", (q,))
        yp = cl.get(r, r, "y", (slice(p * nb, p * nb + nb),))
        ld = np.zeros((bsz, nb, nb), np.float32)
        inv = np.zeros((bsz, nb), np.float32)
        z = np.zeros((bsz, nb), np.float32)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            for j in range(nb):
                d2 = d[:, j, j].copy()
                inv_d = np.where(d2 > 0, 1.0 / np.sqrt(d2.astype(np.float64)), 0.0
                                 ).astype(np.float32)
                zj = yp[:, j] * inv_d
                l = np.where(lanes >= j, d[:, j, :] * inv_d[:, None], np.float32(0))
                ld[:, j] = l
                m = l.copy()
                m[:, j] = l[:, j] - one
                blk = _fma(-m[:, j:, None], l[:, None, j:], d[:, j:, j:])
                d[:, j:, j:] = np.where(tri[j:, j:], blk, d[:, j:, j:])
                yp[:, j:] = _fma(-m[:, j:], zj[:, None], yp[:, j:])
                inv[:, j], z[:, j] = inv_d, zj
        cl.put(r, r, "u", (q,), d)
        cl.put(r, r, "y", (slice(p * nb, p * nb + nb),), yp)
        for dst in range(c):  # its own copy, then DSMEM stores into the others
            for k, v in (("ld", ld), ("inv", inv), ("z", z)):
                cl.put(r, dst, k, (slice(None),), v)

    def trailing(p):
        """Each block's tiles below panel p (the next diagonal tile among
        them), k ascending, from its own copy of the L rows they use."""
        for r in range(c):
            qs = [q for q, (i, _) in enumerate(tables[r]) if i > p]
            if not qs:
                continue
            ij = [tables[r][q] for q in qs]
            lrow = {i: cl.get(r, r, "l", (slice(None), slice(i * nb, i * nb + nb)))
                    for i in {i for i, _ in ij} | {j for _, j in ij}}
            rows = np.stack([lrow[i] for i, _ in ij], 1)
            cols = np.stack([lrow[j] for _, j in ij], 1)
            tiles = np.stack([cl.get(r, r, "u", (q,)) for q in qs], 1)
            keep = np.stack([tri if i == j else np.ones((nb, nb), bool) for i, j in ij])
            for k in range(nb):
                blk = _fma(-rows[:, :, k, :, None], cols[:, :, k, None, :], tiles)
                tiles = np.where(keep, blk, tiles)
            for k, q in enumerate(qs):
                cl.put(r, r, "u", (q,), tiles[:, k])

    panel(0, 0)
    barrier("trailing")
    for p in range(t):
        e = (p + 1) * nb
        for r in range(c):  # strip: the block's columns right of the panel
            qs = [index[r][(p, j)] for j in range(r, t, c) if j > p]
            if not qs:
                continue
            cols = np.concatenate([np.arange(j * nb, j * nb + nb) for j in range(r, t, c) if j > p])
            s = np.concatenate([cl.get(r, r, "u", (q,)) for q in qs], axis=2)
            ld, inv, z = (cl.get(r, r, k, (slice(None),)) for k in ("ld", "inv", "z"))
            yc = cl.get(r, r, "y", (cols,))
            lrows = np.zeros((bsz, nb, len(cols)), np.float32)
            for j in range(nb):
                lc = s[:, j, :] * inv[:, j, None]
                lrows[:, j] = lc
                m = ld[:, j].copy()
                m[:, j] = ld[:, j, j] - one
                s[:, j:, :] = _fma(-m[:, j:, None], lc[:, None, :], s[:, j:, :])
                yc = _fma(-lc, z[:, j, None], yc)
            for k, q in enumerate(qs):
                cl.put(r, r, "u", (q,), s[:, :, k * nb:(k + 1) * nb])
            cl.put(r, r, "y", (cols,), yc)
            for dst in range(c):
                cl.put(r, dst, "l", (slice(None), cols), lrows)
        barrier("strip")
        if e < np_:
            trailing(p)
            panel((p + 1) % c, p + 1)
        barrier("trailing")

    x = np.zeros((bsz, np_), np.float32)
    x = np.zeros((bsz, np_), np.float32)
    ahead = None  # the owner of the next panel's row of its tile, read a panel ahead
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for p in range(t - 1, -1, -1):
            s, e = p * nb, p * nb + nb
            own, nxt = p % c, (p + 1) % c
            diag = cl.get(own, own, "u", (index[own][(p, p)],))
            yv = cl.get(own, own, "y", (slice(s, e),))
            if p + 1 < t:  # tile (p, p + 1) read ahead; panel p + 1's x pushed here
                xr = cl.get(own, own, "l", (0, slice(e, e + nb)))
                for j in range(nb - 1, -1, -1):
                    yv = _fma(-ahead[:, :, j], xr[:, j, None], yv)
            dd = diag[:, lanes, lanes]
            dinv = np.where(dd > 0, one / dd, np.float32(0)).astype(np.float32)
            xs = np.zeros((bsz, nb), np.float32)
            for j in range(nb - 1, -1, -1):  # warp 0 solves the panel
                xj = (yv[:, j] * dinv[:, j]).astype(np.float32)
                xs[:, j] = xj
                yv[:, :j] = _fma(-diag[:, :j, j], xj[:, None], yv[:, :j])
            cl.put(own, own, "l", (0, slice(s, e)), xs)
            if p > 0:  # and into the owner of panel p - 1
                cl.put(own, (p - 1) % c, "l", (0, slice(s, e)), xs)
            x[:, s:e] = xs
            if p + 1 < t:  # meanwhile the rows above panel p take panel p + 1's x
                xp = cl.get(nxt, nxt, "l", (0, slice(e, e + nb)))
                for i in range(p):
                    rows = slice(i * nb, i * nb + nb)
                    tl = cl.get(nxt, nxt, "u", (index[nxt][(i, p + 1)],))
                    yr = cl.get(nxt, i % c, "y", (rows,))
                    for j in range(nb - 1, -1, -1):
                        yr = _fma(-tl[:, :, j], xp[:, j, None], yr)
                    cl.put(nxt, i % c, "y", (rows,), yr)
            if p > 0:
                ahead = cl.get((p - 1) % c, p % c, "u", (index[p % c][(p - 1, p)],))
            barrier("back")
    cl.barrier()  # the kernel's exit: every phase's accesses checked
    return x[:, :n]


@pytest.mark.parametrize("n", [305, 320, 384, C2_MAX_N])
def test_the_cluster_order_is_the_wide_kernels_bit_for_bit(n):
    a, b = _systems(3, n, k=2 * n, seed=n)
    c = spd_cluster_size(n)
    assert c == 2
    x = emulate_spd_cluster(a, b, c)
    np.testing.assert_array_equal(x, emulate_spd_wide(a, b))
    assert _rel_err(x, _plain(a, b)) < REL_TOL


@pytest.mark.parametrize("n,c", [(129, 4), (200, 4), (129, 8), (200, 8), (150, 2)])
def test_forced_cluster_sizes_give_the_same_bits(n, c):
    """A cluster of 4 or 8 at a smaller n: the same ownership arithmetic
    at every rank, with blocks that own a column or two."""
    a, b = _systems(4, n, k=2 * n, seed=n + c)
    np.testing.assert_array_equal(emulate_spd_cluster(a, b, c), emulate_spd_wide(a, b))


def test_a_missing_barrier_is_a_race():
    """Without the barrier after the strip, a block's trailing update
    would read L rows another block is still pushing; without the one
    after the trailing update, a block's strip would read diagonal rows
    still being pushed; without the one after a back substitution panel,
    the next panel's owner would read the y rows and x still being written."""
    a, b = _systems(2, 150, k=300, seed=1)
    for name in ("strip", "trailing", "back"):
        with pytest.raises(ClusterRace):
            emulate_spd_cluster(a, b, 2, skip_barriers=(name,))


def test_cluster_matches_numpy_and_the_jax_kernel():
    n = 320
    a, b = _systems(4, n, k=2 * n, seed=3)
    x = emulate_spd_cluster(a, b, spd_cluster_size(n))
    ref = np.linalg.solve(a.astype(np.float64), b[..., None].astype(np.float64))[..., 0]
    assert _rel_err(x, ref) < REL_TOL
    assert _rel_err(x, _jax(a, b)) < REL_TOL


def test_cluster_zero_dead_pivot_lower_triangle_and_nan_cases():
    n = 330
    a, b = _systems(6, n, k=400, seed=5)
    a[5] = 0.0  # a zero system solves to exact zeros
    dead = [0, 170, 329]
    a[4, dead, :] = 0.0
    a[4, :, dead] = 0.0
    x = emulate_spd_cluster(a, b, 2)
    assert np.all(np.isfinite(x))
    np.testing.assert_array_equal(x[5], 0.0)
    np.testing.assert_array_equal(x[4, dead], 0.0)
    np.testing.assert_array_equal(x, emulate_spd_wide(a, b))
    garbage = a.copy()
    low = np.tril_indices(n, -1)
    garbage[:, low[0], low[1]] = np.nan
    np.testing.assert_array_equal(emulate_spd_cluster(garbage, b, 2), x)
    a_nan = a.copy()
    a_nan[2, 5, 9] = np.nan
    x_nan = emulate_spd_cluster(a_nan, b, 2)
    assert np.isnan(x_nan[2]).any()
    others = [0, 1, 3, 4, 5]
    np.testing.assert_array_equal(x_nan[others], x[others])
