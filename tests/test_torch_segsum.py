"""The ordered segment sum of the PyTorch port (ops/cuda_segsum.py) on the
CPU, and the call sites that moved to it.  ~10 s on two CPU threads.

``segment_sum_plain`` is a left fold in row order, the order the CUDA
kernel (csrc/segsum.cu) adds in, so it is held to a float32 ``np.add.at``
bit for bit, and so is the custom op on CPU tensors and under
``torch.vmap``.  The refinement's blocks, summed over rows stably sorted by
landmark, are held bit for bit to the ``index_add`` over the unsorted rows
that computed them before (``_blocks_by_index_add``).  The JAX twins of the
call sites are tests/test_torch_voxel.py, the merge twins of
tests/test_torch_mapping.py and tests/test_torch_refine.py; the kernel
itself runs in tests/test_torch_cuda.py.  Which block of the kernel writes
each slot and reads each row is modelled here in numpy, with the wrapper's
geometry.
"""

import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.models import refine as tr
from light_loam_tpu_torch.ops import cuda_segsum as cs
from light_loam_tpu_torch.ops.cuda_segsum import (
    SEGSUM,
    segment_sum,
    segment_sum_plain,
)
from light_loam_tpu_torch.solver.gauss_newton import _huber_rho
from test_torch_refine import _ba, _t, _tlm

torch.set_num_threads(2)


def add_at(values: np.ndarray, seg: np.ndarray, S: int) -> np.ndarray:
    """Float32 left fold of each slot's rows in row order (``np.add.at``
    adds unbuffered, in index order), the dump slot S cut off."""
    out = np.zeros((S + 1, values.shape[1]), values.dtype)
    np.add.at(out, seg, values)
    return out[:S]


def segments(rng, S: int, C: int, case: str, dtype=np.float32):
    """(values (N, C), seg (N,) int64 sorted in [0, S]) for one case:
    "sparse" (most slots empty, a few rows each), "dump" (a third of the
    rows dead, in the dump slot S), "overflow" (more distinct keys than S:
    the rows past S clipped to S, as ``ops/voxel.py`` clips them), "long"
    (one slot holding most rows)."""
    if case == "sparse":
        slots = rng.choice(S, size=S // 3, replace=False)
        seg = np.sort(np.repeat(slots, rng.integers(1, 4, slots.size)))
    elif case == "dump":
        live = np.sort(rng.integers(0, S, 2 * S))
        seg = np.concatenate([live, np.full(S, S)])
    elif case == "overflow":
        seg = np.minimum(np.sort(rng.integers(0, 2 * S, 3 * S)), S)
    else:
        seg = np.sort(np.concatenate([np.full(5 * S, S // 2),
                                      rng.integers(0, S + 1, S)]))
    values = rng.standard_normal((seg.size, C)) * rng.uniform(0.1, 100, C)
    return values.astype(dtype), seg.astype(np.int64)


CASES = ("sparse", "dump", "overflow", "long")
# widths of the call sites: the store reduce 4, the voxel sums 5, the
# refinement's landmark blocks 12 (a 3×3 block and a gradient) and its
# pose-landmark blocks 18 (6×3); and 1
WIDTHS = (1, 4, 5, 12, 18)


@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_plain_is_a_left_fold_in_row_order(case, C):
    rng = np.random.default_rng(C * 7 + len(case))
    S = 97
    values, seg = segments(rng, S, C, case)
    got = segment_sum_plain(torch.from_numpy(values), torch.from_numpy(seg),
                            S)
    want = add_at(values, seg, S)
    assert got.shape == (S, C)
    np.testing.assert_array_equal(got.numpy(), want)
    empty = np.setdiff1d(np.arange(S), seg)
    assert not got.numpy()[empty].any()


@pytest.mark.parametrize("case", CASES)
def test_custom_op_on_cpu_tensors_runs_the_plain_version(case):
    rng = np.random.default_rng(len(case))
    S = 211
    SEGSUM.launches = 0
    for dtype in (np.float32, np.float64):
        values, seg = segments(rng, S, 5, case, dtype)
        v, s = torch.from_numpy(values), torch.from_numpy(seg)
        got = segment_sum(v, s, S)
        assert got.dtype == v.dtype
        assert torch.equal(got, segment_sum_plain(v, s, S))
        np.testing.assert_array_equal(got.numpy(), add_at(values, seg, S))
    assert torch.equal(
        torch.ops.light_loam_tpu_torch.segment_sum(v, s, S), got)
    # a CPU tensor never reaches the kernel
    assert SEGSUM.launches == 0


@pytest.mark.parametrize("shared_seg", [False, True])
def test_vmap_over_lanes_equals_single_calls(shared_seg):
    """Three lanes under ``torch.vmap``: each lane's sums are its single
    call's, bit for bit, and the op's own vmap rule runs (the fallback to a
    per-lane loop warns "batching rule", made an error here)."""
    rng = np.random.default_rng(3)
    S, C = 64, 5
    lanes = [segments(rng, S, C, case) for case in ("sparse", "dump", "long")]
    N = min(v.shape[0] for v, _ in lanes)
    values = torch.from_numpy(np.stack([v[:N] for v, _ in lanes]))
    if shared_seg:
        seg = torch.from_numpy(lanes[1][1][:N])
        in_dims = (0, None, None)
    else:
        seg = torch.from_numpy(np.stack([s[:N] for _, s in lanes]))
        in_dims = (0, 0, None)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        got = torch.vmap(segment_sum, in_dims=in_dims)(values, seg, S)
    assert got.shape == (3, S, C)
    for b in range(3):
        s = seg if shared_seg else seg[b]
        assert torch.equal(got[b], segment_sum(values[b], s, S))
        np.testing.assert_array_equal(
            got[b].numpy(), add_at(values[b].numpy(), s.numpy(), S))


def _blocks_by_index_add(q, t, stack_xyz, stack_mask, lm, lm_n, lm_d,
                         huber_delta, assoc_radius, resid_gate):
    """Hpl, Hll and g_l as ``normal_equations`` summed them before the
    ordered sums: ``index_add`` of every point's rows, in point order, by
    its unsorted landmark index, invalid points (zero rows) included."""
    Kl, M = q.shape[0], lm_n.shape[0]
    b1, b2 = tr._normal_basis(lm_n)
    R = quat.quat_to_matrix(q)
    p_w = torch.einsum("kij,kpj->kpi", R, stack_xyz) + t[:, None, :]
    d2 = ((p_w * p_w).sum(dim=-1)[:, :, None]
          + (lm.anchor * lm.anchor).sum(dim=-1)[None, None, :]
          - 2.0 * torch.einsum("kpi,mi->kpm", p_w, lm.anchor))
    d2 = torch.where(lm.mask[None, None, :], d2, torch.full((), 1e30))
    m_idx = torch.argmin(d2, dim=-1)
    m_d2 = torch.gather(d2, -1, m_idx[..., None])[..., 0]
    n_m = lm_n[m_idx]
    r = (n_m * p_w).sum(dim=-1) + lm_d[m_idx]
    valid = stack_mask & (m_d2 < assoc_radius ** 2) & (r.abs() < resid_gate)
    _, w_h = _huber_rho(r * r, huber_delta)
    w = w_h * valid
    cp = stack_xyz
    zero = torch.zeros_like(cp[..., 0])
    cx = torch.stack([
        torch.stack([zero, -cp[..., 2], cp[..., 1]], dim=-1),
        torch.stack([cp[..., 2], zero, -cp[..., 0]], dim=-1),
        torch.stack([-cp[..., 1], cp[..., 0], zero], dim=-1)], dim=-2)
    Jrot = -torch.einsum("kpi,kij,kpjl->kpl", n_m, R, cx)
    Jp = torch.cat([Jrot, n_m], dim=-1)
    Jl = torch.stack([(b1[m_idx] * p_w).sum(dim=-1),
                      (b2[m_idx] * p_w).sum(dim=-1), torch.ones_like(r)],
                     dim=-1)
    flat_lm = m_idx.reshape(-1)
    Jl_w = Jl * w[..., None]
    Hll = Jl.new_zeros((M, 3, 3)).index_add(
        0, flat_lm,
        torch.einsum("xa,xb->xab", Jl_w.reshape(-1, 3), Jl.reshape(-1, 3)))
    g_l = Jl.new_zeros((M, 3)).index_add(
        0, flat_lm, (Jl_w * r[..., None]).reshape(-1, 3))
    flat_m = (torch.arange(Kl)[:, None] * M + m_idx).reshape(-1)
    Hpl = Jl.new_zeros((Kl * M, 6, 3)).index_add(
        0, flat_m,
        torch.einsum("xa,xb->xab", (Jp * w[..., None]).reshape(-1, 6),
                     Jl.reshape(-1, 3))).reshape(Kl, M, 6, 3)
    return Hpl, Hll, g_l, int(valid.sum()), int((~valid).sum())


@pytest.mark.parametrize("case", ["full", "masked"])
def test_refinement_blocks_equal_the_index_add(case):
    """``normal_equations``' Hll, g_l and Hpl through the stable-argsort
    route bit for bit the ``index_add`` over the unsorted rows, on
    tests/test_refine.py's window (K 4, M 24, P 256) at its noisy initial
    poses; "masked" drops a quarter of the points and two landmarks, so
    that invalid points (zero rows, routed to the dump slot) are many."""
    rng = np.random.default_rng(5)
    _, (q0, t0), stacks, lm = _ba(7)
    K, P = stacks.shape[:2]
    mask = np.ones((K, P), bool)
    lm = _tlm(lm)
    if case == "masked":
        mask = rng.random((K, P)) > 0.25
        lm = lm._replace(mask=lm.mask.clone().index_fill_(
            0, torch.tensor([2, 9]), False))
    args = (_t(q0), _t(t0), _t(stacks), torch.from_numpy(mask), lm, lm.n,
            lm.d, 0.1, 2.0, 1.0)
    (_, _, Hpl, Hll, g_l), _ = tr.normal_equations(*args)
    Hpl_ref, Hll_ref, g_l_ref, n_valid, n_invalid = _blocks_by_index_add(
        *args)
    assert n_valid > 0 and n_invalid > 0
    for got, want in ((Hpl, Hpl_ref), (Hll, Hll_ref), (g_l, g_l_ref)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_geometry_follows_the_kernel_source():
    """The wrapper's copies of segsum.cu's constants match the source, and
    its geometry at the main path's shapes: 512 rows staged at a time up to
    12-wide float32 rows, fewer for wider ones; tiles of 64 rows where the
    grid then fits one wave (132 SMs x MIN_BLOCKS), larger where not (the
    rings, the re-sorts, the anchors, the surf and keyframe stacks); blocks
    for every row and for the slots; the fewest probes that give the fewest
    search rounds (two at every main-path shape)."""
    src = (Path(cs.__file__).resolve().parent.parent / "csrc"
           / "segsum.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert cs.THREADS == constant("THREADS")
    assert "constexpr int TILE_ROWS = THREADS * ROWS_PER_THREAD;" in src
    assert cs.TILE_ROWS == cs.THREADS * constant("ROWS_PER_THREAD")
    assert cs.TILE_BYTES == constant("TILE_BYTES")
    assert cs.PROBES_MAX == constant("PROBES_MAX")
    assert cs.MIN_BLOCKS == constant("MIN_BLOCKS")
    assert "__launch_bounds__(THREADS, MIN_BLOCKS)" in src
    # the shapes of chip_smoke.py phase 3c: (N, S, C, itemsize) -> geometry
    want = {(147456, 147456, 5, 4): (256, 512, 576, 3),
            (270336, 262144, 5, 4): (512, 512, 528, 5),
            (133120, 131072, 5, 4): (256, 512, 520, 3),
            (65536, 8192, 5, 4): (128, 512, 512, 1),
            (7680, 2048, 5, 4): (64, 512, 120, 1),
            (2048, 2048, 4, 4): (64, 512, 32, 1),
            (262144, 512, 5, 4): (512, 512, 512, 4),
            (24576, 512, 12, 4): (64, 512, 384, 1),
            (24576, 6144, 18, 8): (64, 128, 384, 1),
            (3000, 700, 600, 8): (4, 4, 750, 1),
            (0, 300, 5, 4): (64, 512, 5, 1)}
    for shape, geometry in want.items():
        assert cs.segsum_geometry(*shape) == geometry, shape
        rows, buf, blocks, probes = geometry
        assert rows <= buf and (buf + 1) * shape[2] * shape[3] <= cs.TILE_BYTES
        assert blocks * rows >= max(shape[0], shape[1])
        assert blocks <= cs.WAVE or rows == buf
        assert cs.search_rounds(shape[0], probes) <= 2
    with pytest.raises(ValueError, match="limit"):
        cs.segsum_geometry(100, 10, cs.TILE_BYTES // 8, 8)


def ownership(seg: np.ndarray, S: int, C: int, itemsize: int):
    """A numpy model of who writes and reads what in one lane of segsum.cu,
    block by block, with the wrapper's geometry: returns (writes per slot,
    reads per row).  Block x holds rows [x T, x T + T).  When the row
    before its tile is in the dump slot, it searches for the lane's live
    count L (the kernel's rounds: THREADS probes, then probes x THREADS)
    and u = seg[L - 1] + 1; else its heads write their slots and the empty
    slots since the previous row's, its last segment, if it runs past the
    tile, is read on to its end, and L = x T + its live rows if the tile
    has a dump row or is the last.  The blocks from x_b = min(L // T, X -
    1) on zero [u, S) in X - x_b runs of equal length."""
    N = len(seg)
    T, B_rows, X, probes = cs.segsum_geometry(N, S, C, itemsize)
    writes, reads = np.zeros(S, np.int64), np.zeros(N, np.int64)
    L_true = int((seg < S).sum())

    def search():
        lo, hi, top, P = 0, N, -1, cs.THREADS
        while lo < hi:
            step = -(-(hi - lo) // P)
            q = lo + np.arange(P) * step
            q = q[q < hi]
            live = seg[q] < S
            c = int(live.sum())
            assert live[:c].all()  # the live probes are a prefix
            if c:
                top = max(top, int(seg[q[live]].max()))
                lo, hi = lo + (c - 1) * step + 1, min(lo + c * step, hi)
            else:
                hi = lo
            P = probes * cs.THREADS
        return lo, top + 1 if lo else 0

    def share(u, xb, x):
        xb = min(xb, X - 1)
        Z = -(-(S - u) // (X - xb))
        z0 = min(u + (x - xb) * Z, S)
        writes[z0:min(z0 + Z, S)] += 1

    for x in range(X):
        t0 = x * T
        before = -1 if t0 == 0 else seg[t0 - 1] if t0 <= N else S
        if before >= S:
            L, u = search()
            assert L == L_true and u == (seg[L - 1] + 1 if L else 0)
            share(u, L // T, x)
            continue
        tile = seg[t0:t0 + T]
        prev = np.r_[before, tile[:-1]]
        heads = np.flatnonzero((tile < S) & (tile != prev))
        live_rows = int((tile < S).sum())
        for h, r in enumerate(heads):
            s = tile[r]
            writes[prev[r] + 1:s] += 1
            writes[s] += 1
            end = heads[h + 1] if h + 1 < len(heads) else live_rows
            if h + 1 == len(heads) and end == len(tile):
                while t0 + end < N and seg[t0 + end] == s:
                    end += 1  # read on past the tile
            reads[t0 + r:t0 + end] += 1
        if live_rows < T or x == X - 1:
            assert t0 + live_rows == L_true
            u = (tile[live_rows - 1] if live_rows else before) + 1
            share(u, x, x)
    return writes, reads


def edge_patterns():
    """(name, seg, S, C, itemsize): the card tests' edges of the tiles
    (tests/test_torch_cuda.py segsum_edge_case) and the shapes of the
    main path, with long runs of one slot and of empty slots."""
    rng = np.random.default_rng(11)
    S6 = 262144
    live6 = np.sort(rng.choice(S6, S6 * 6 // 100, replace=False))
    yield "no rows", np.zeros(0, np.int64), 300, 5, 4
    yield "dump rows only", np.full(900, 77), 77, 5, 4
    yield "one slot", np.r_[np.zeros(500, np.int64), np.ones(200)], 1, 4, 4
    yield ("segment over three tiles",
           np.r_[np.arange(100), np.full(600, 100), np.arange(101, 300),
                 np.full(50, 400)], 400, 5, 4)
    yield ("last live row at a tile end",
           np.r_[np.sort(rng.integers(0, 200, 512)), np.full(300, 400)],
           400, 5, 4)
    yield ("262144 slots 6% live",
           np.r_[np.repeat(live6, rng.integers(1, 3, live6.size)),
                 np.full(8192, S6)], S6, 5, 4)
    yield ("first slot past the first tile, no dump rows",
           np.r_[np.full(10, 5000), np.full(20, 9000)], 12000, 5, 4)
    yield ("float64 600 wide",
           np.minimum(np.sort(rng.integers(0, 800, 3000)), 700), 700, 600, 8)
    for N, C, S in ((147456, 5, 147456), (270336, 5, 262144),
                    (24576, 12, 512), (24576, 18, 6144)):
        live = (2 * N) // 3
        lengths = rng.integers(1, 9, live // 5)
        lengths[len(lengths) // 2] = 2000
        slots = np.minimum(np.sort(rng.integers(0, S + S // 4 + 1,
                                                len(lengths))), S)
        seg = np.repeat(slots, lengths)[:live]
        yield (f"{N}x{C}->{S}", np.r_[seg, np.full(N - len(seg), S)], S, C,
               8 if C == 18 else 4)


@pytest.mark.parametrize("pattern", list(edge_patterns()),
                         ids=lambda p: p[0].replace(" ", "-"))
def test_every_slot_written_once_every_live_row_read_once(pattern):
    """segsum.cu's ownership, modelled in numpy with the wrapper's tile
    constants (``ownership``): each of the S slots is written exactly once
    (no memset needed, no write raced), each live row's values are read
    exactly once and no dump row's at all."""
    _, seg, S, C, itemsize = pattern
    seg = seg.astype(np.int64)
    assert (np.diff(seg) >= 0).all() and (seg.size == 0 or seg.max() <= S)
    writes, reads = ownership(seg, S, C, itemsize)
    np.testing.assert_array_equal(writes, np.ones(S, np.int64))
    np.testing.assert_array_equal(reads, (seg < S).astype(np.int64))
