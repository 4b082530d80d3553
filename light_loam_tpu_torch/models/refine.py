"""Windowed multi-keyframe refinement with Schur-complement reduction.

Counterpart of ``light_loam_tpu/models/refine.py``.  A capability the
reference does not have (its back end refines one frame at a time against
the map): jointly re-estimate the last K keyframe poses AND M shared plane
landmarks from the keyframes' surf stacks, a small bundle adjustment over
the block-structured system that solver/schur.py solves.

Landmarks are planes (n̂, d) with a 3-dof tangent (2 in the normal's
tangent basis + 1 offset), fitted to the map around well-spaced anchors.

With keyframes split across processes, landmark blocks are summed over
all of them and the pose blocks gathered before the same reduced 6K×6K
solve runs everywhere; ``refine_window`` takes those two collectives and
the process's first keyframe index as arguments, identity and 0 on one
device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.models.mapping import _solve3x3
from light_loam_tpu_torch.ops.cuda_segsum import segment_sum
from light_loam_tpu_torch.ops.knn import knn_tiled
from light_loam_tpu_torch.ops.voxel import voxel_downsample
from light_loam_tpu_torch.solver.gauss_newton import _huber_rho, _identity
from light_loam_tpu_torch.solver.schur import schur_solve


class PlaneLandmarks(NamedTuple):
    n: torch.Tensor       # (M, 3) unit normals
    d: torch.Tensor       # (M,) offsets: plane is n·x + d = 0
    anchor: torch.Tensor  # (M, 3) representative point (association key)
    mask: torch.Tensor    # (M,)


def extract_landmarks(
    map_xyz: torch.Tensor,
    map_mask: torch.Tensor,
    n_landmarks: int,
    sample_leaf: float = 4.0,
    knn_k: int = 5,
    knn_tile: int = 4096,
    fit_gate: float = 0.2,
) -> PlaneLandmarks:
    """Sample well-spaced anchors from the surf map (coarse voxel grid)
    and fit a plane to each anchor's k-NN neighbourhood."""
    anchors, _, amask, _ = voxel_downsample(
        map_xyz, map_xyz.new_zeros(map_xyz.shape[0]), map_mask, sample_leaf,
        n_landmarks,
    )
    d2, idx = knn_tiled(anchors, map_xyz, map_mask, k=knn_k, tile=knn_tile)
    near = map_xyz[idx.to(torch.int64)]
    AtA = torch.einsum("qni,qnj->qij", near, near)
    Atb = -near.sum(dim=1)
    nvec, ok = _solve3x3(AtA, Atb)
    norm = torch.sqrt(torch.clamp((nvec * nvec).sum(dim=-1), min=1e-20))
    d = 1.0 / norm
    n_hat = nvec / norm[:, None]
    resid = (torch.einsum("qni,qi->qn", near, n_hat) + d[:, None]).abs()
    good = (amask & ok & (d2[:, -1] < 1.0)
            & (resid <= fit_gate).all(dim=1))
    return PlaneLandmarks(n=n_hat, d=d, anchor=anchors, mask=good)


def _normal_basis(n: torch.Tensor):
    """Per-landmark orthonormal tangent basis (b1, b2) ⊥ n."""
    # the axis least aligned with n
    ref = torch.where(
        (n[:, 0].abs() < 0.9)[:, None],
        n.new_tensor([1.0, 0.0, 0.0]),
        n.new_tensor([0.0, 1.0, 0.0]),
    )
    b1 = torch.linalg.cross(n, ref, dim=-1)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1, dim=-1, keepdim=True),
                          min=1e-12)
    b2 = torch.linalg.cross(n, b1, dim=-1)
    return b1, b2


def normal_equations(q, t, stack_xyz, stack_mask, lm: PlaneLandmarks,
                     lm_n, lm_d, huber_delta: float, assoc_radius: float,
                     resid_gate: float):
    """One iteration's blocks (Hpp (K, 6, 6), g_p (K, 6), Hpl (K, M, 6, 3),
    Hll (M, 3, 3), g_l (M, 3)) over this process's K keyframes, and the
    landmarks' tangent bases (b1, b2)."""
    Kl = q.shape[0]
    M = lm_n.shape[0]
    b1, b2 = _normal_basis(lm_n)

    # world-frame stack points
    R = quat.quat_to_matrix(q)  # (Kl, 3, 3)
    p_w = torch.einsum("kij,kpj->kpi", R, stack_xyz) + t[:, None, :]

    # associate each point with the nearest landmark anchor; argmin keeps
    # the first of equal distances, as jnp.argmin does
    d2 = ((p_w * p_w).sum(dim=-1)[:, :, None]
          + (lm.anchor * lm.anchor).sum(dim=-1)[None, None, :]
          - 2.0 * torch.einsum("kpi,mi->kpm", p_w, lm.anchor))
    d2 = torch.where(lm.mask[None, None, :], d2,
                     torch.full((), 1e30, device=d2.device))
    m_idx = torch.argmin(d2, dim=-1)  # (Kl, P)
    m_d2 = torch.gather(d2, -1, m_idx[..., None])[..., 0]

    n_m = lm_n[m_idx]      # (Kl, P, 3)
    d_m = lm_d[m_idx]      # (Kl, P)
    r = (n_m * p_w).sum(dim=-1) + d_m  # (Kl, P)

    valid = stack_mask & (m_d2 < assoc_radius ** 2) & (r.abs() < resid_gate)
    _, w_h = _huber_rho(r * r, huber_delta)
    w = w_h * valid

    # pose Jacobian rows: [-nᵀ R [p]× , nᵀ]
    cp = stack_xyz
    zero = torch.zeros_like(cp[..., 0])
    cx = torch.stack(
        [
            torch.stack([zero, -cp[..., 2], cp[..., 1]], dim=-1),
            torch.stack([cp[..., 2], zero, -cp[..., 0]], dim=-1),
            torch.stack([-cp[..., 1], cp[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )  # (Kl, P, 3, 3)
    Jrot = -torch.einsum("kpi,kij,kpjl->kpl", n_m, R, cx)  # (Kl, P, 3)
    Jp = torch.cat([Jrot, n_m], dim=-1)  # (Kl, P, 6)

    # landmark Jacobian rows: [b1·p_w, b2·p_w, 1]
    Jl = torch.stack(
        [(b1[m_idx] * p_w).sum(dim=-1), (b2[m_idx] * p_w).sum(dim=-1),
         torch.ones_like(r)],
        dim=-1,
    )  # (Kl, P, 3)

    # accumulate normal equations
    Hpp = torch.einsum("kpa,kpb,kp->kab", Jp, Jp, w)
    g_p = torch.einsum("kpa,kp,kp->ka", Jp, r, w)
    # landmark blocks summed by m_idx (over keyframes too): each point's
    # 3×3 block and gradient as 12 columns of one sum.  A point that is
    # not valid has w = 0, so its rows are zeros, which leave a sum started
    # at +0 bitwise unchanged: it goes to the dump slot instead, which
    # keeps every landmark's segment to its own associated points
    Jl_w = Jl * w[..., None]
    lm_sums = _sum_by_slot(torch.cat([
        torch.einsum("xa,xb->xab", Jl_w.reshape(-1, 3),
                     Jl.reshape(-1, 3)).reshape(-1, 9),
        (Jl_w * r[..., None]).reshape(-1, 3)], 1),
        torch.where(valid, m_idx, M).reshape(-1), M)
    Hll, g_l = lm_sums[:, :9].reshape(M, 3, 3), lm_sums[:, 9:]
    # pose-landmark coupling: (Kl, M, 6, 3)
    flat_m = torch.arange(Kl, device=q.device)[:, None] * M + m_idx
    Hpl = _sum_by_slot(
        torch.einsum("xa,xb->xab", (Jp * w[..., None]).reshape(-1, 6),
                     Jl.reshape(-1, 3)).reshape(-1, 18),
        torch.where(valid, flat_m, Kl * M).reshape(-1),
        Kl * M).reshape(Kl, M, 6, 3)
    return (Hpp, g_p, Hpl, Hll, g_l), (b1, b2)


def _sum_by_slot(rows: torch.Tensor, slot: torch.Tensor, S: int):
    """(S, C) sums of ``rows`` by ``slot``: the rows stably sorted by slot,
    so each slot's rows keep their order and add as the CPU's
    ``index_add`` adds them, then one ordered segment sum.  The slots come
    from each iteration's own association, so the sort is taken anew."""
    order = torch.argsort(slot, stable=True)
    return segment_sum(rows[order], slot[order], S)


def refine_window(
    q: torch.Tensor,           # (K, 4) keyframe rotations (world)
    t: torch.Tensor,           # (K, 3)
    stack_xyz: torch.Tensor,   # (K, P, 3) surf points in each keyframe's frame
    stack_mask: torch.Tensor,  # (K, P)
    landmarks: PlaneLandmarks,
    n_iterations: int = 4,
    huber_delta: float = 0.1,
    assoc_radius: float = 2.0,
    resid_gate: float = 1.0,
    damping: float = 1e-4,
    psum: Callable[[torch.Tensor], torch.Tensor] = _identity,
    gather_poses: Callable[[torch.Tensor], torch.Tensor] = _identity,
    offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, PlaneLandmarks]:
    """Jointly refine K poses and M plane landmarks.

    With keyframes split across processes, ``psum`` sums a landmark block
    over all of them, ``gather_poses`` concatenates a pose block along the
    keyframe axis in process order, and ``offset`` is the global index of
    this process's first keyframe; every process then solves the same
    reduced system and applies its own keyframes' updates.  Keyframe 0
    (globally) is gauge-fixed.  The iterations read nothing to the host.
    """
    Kl = q.shape[0]
    lm = landmarks
    lm_n, lm_d = lm.n, lm.d
    for _ in range(n_iterations):
        (Hpp, g_p, Hpl, Hll, g_l), (b1, b2) = normal_equations(
            q, t, stack_xyz, stack_mask, lm, lm_n, lm_d, huber_delta,
            assoc_radius, resid_gate)
        # collectives: landmarks global, poses gathered for the reduced solve
        dp, dl = schur_solve(gather_poses(Hpp), gather_poses(g_p),
                             gather_poses(Hpl), psum(Hll), psum(g_l),
                             damping=damping)

        dp_local = dp[offset:offset + Kl]
        q = quat.quat_normalize(
            quat.quat_multiply(q, quat.quat_exp(dp_local[:, :3])))
        t = t + dp_local[:, 3:]

        n_new = lm_n + dl[:, 0:1] * b1 + dl[:, 1:2] * b2
        lm_n = n_new / torch.clamp(
            torch.linalg.vector_norm(n_new, dim=-1, keepdim=True), min=1e-12)
        lm_d = lm_d + dl[:, 2]
    return q, t, lm._replace(n=lm_n, d=lm_d)
