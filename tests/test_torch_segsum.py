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
itself runs in tests/test_torch_cuda.py.
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
    """The wrapper's copies of segsum.cu's block size and wide column group
    match the source, and the wide group is taken where the slots alone
    fill the card: the rings and the store re-sorts at the flagship shapes,
    not the stacks, the store reduce or one refinement call."""
    src = (Path(cs.__file__).resolve().parent.parent / "csrc"
           / "segsum.cu").read_text()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", src).group(1))
    assert cs.FILL_THREADS == 132 * threads
    assert f"case {cs.WIDE_GROUP}:" in src and "case 1:" in src
    wide = {(1, 147456, 5), (1, 131072, 5), (1, 262144, 5), (4, 6144, 18),
            (4, 147456, 5)}
    narrow = {(1, 2048, 5), (1, 8192, 5), (1, 8192, 4), (1, 512, 12),
              (1, 6144, 18), (4, 8192, 4)}
    for shape in wide:
        assert cs.segsum_geometry(*shape) == cs.WIDE_GROUP, shape
    for shape in narrow:
        assert cs.segsum_geometry(*shape) == 1, shape
