"""Levenberg-Marquardt on SE(3) with Huber IRLS.

Counterpart of ``light_loam_tpu/solver/gauss_newton.py`` (single device):
replaces the reference's per-frame Ceres solves (HuberLoss(0.1) +
EigenQuaternionManifold, max_num_iterations=4;
src/laserOdometry.cpp:475-482,819-826, src/laserMapping.cpp:1864-1872,
2080-2087).  The 6-dof normal equations are accumulated over all factors;
each residual block is scaled by sqrt(ρ'(‖r‖²)), ρ the Huber loss, and the
cost is 0.5 Σ ρ(‖r‖²).  The damped 6×6 system is solved by Cholesky
(``cholesky_ex``, which reports failure in a tensor instead of raising, so
the loop never waits on the device) and two triangular solves.

With the factors split across processes (parallel/sharded.py), ``lm_solve``
takes the sum over all of them as ``allreduce``, the counterpart of the
JAX package's ``axis_name``: every process then solves the identical 6×6
system.

The odometry's live solve (one process, the edge and plane families) is a
custom operator, ``torch.ops.light_loam_tpu_torch.lm_solve_edge_plane``:
its CUDA kernel launches ``csrc/lm.cu``, which runs every iteration of one
call in one thread block, and its CPU kernel is the plain loop below
(``_lm_loop``); it never falls back from one to the other.  ``lm_solve``
takes it where ``uses_lm_kernel`` holds, decided from what the call can
observe: CUDA float32 tensors, no ``allreduce``, exactly those two
families.  Every other solve (mapping's plane-norm factors, the corner
vote's scalar edges, the sharded step, CPU tensors) runs the plain loop.
Under ``torch.vmap`` its vmap rule runs B lanes as B blocks of one launch.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.ops.cuda_build import CudaKernel
from light_loam_tpu_torch.ops.cuda_knn import lanes_first
from light_loam_tpu_torch.solver import residuals as res

LM = CudaKernel(
    "lm.cu", "lm_solve_launch",
    [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4
    + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)

# lm.cu's EDGE_FLOATS and PLANE_FLOATS: the floats a factor takes staged
EDGE_FLOATS, PLANE_FLOATS = 13, 12
# a lane's factors are staged in shared memory up to this many bytes (the
# H100's 227 KB a block, less room for the kernel's static arrays), else in
# a scratch buffer in device memory
MAX_STAGED_BYTES = 227 * 1024 - 4096


class FactorSet(NamedTuple):
    """The factor families of one solve; any entry may be None.

    edge/plane/plane_norm are the live-path families; edge_scalar,
    plane_component and distance are the reference's latent factor types
    (see solver.residuals)."""

    edge: Optional[res.EdgeFactors] = None
    plane: Optional[res.PlaneFactors] = None
    plane_norm: Optional[res.PlaneNormFactors] = None
    edge_scalar: Optional[res.EdgeScalarFactors] = None
    plane_component: Optional[res.PlaneComponentFactors] = None
    distance: Optional[res.DistanceFactors] = None


# (field name, residual fn) registry driving the accumulation loops
_FAMILIES = (
    ("edge", res.edge_residuals),
    ("plane", res.plane_residuals),
    ("plane_norm", res.plane_norm_residuals),
    ("edge_scalar", res.edge_scalar_residuals),
    ("plane_component", res.plane_component_residuals),
    ("distance", res.distance_residuals),
)


def _huber_rho(s2: torch.Tensor, delta: float):
    """Ceres HuberLoss: ρ(s) = s for s ≤ δ², else 2δ√s − δ²; returns
    (ρ(s), ρ'(s))."""
    d2 = delta * delta
    small = s2 <= d2
    sqrt_s = torch.sqrt(torch.clamp(s2, min=1e-24))
    rho = torch.where(small, s2, 2.0 * delta * sqrt_s - d2)
    drho = torch.where(small, torch.ones_like(s2), delta / sqrt_s)
    return rho, drho


def _accumulate(r, J, mask, delta):
    """Robustified contributions of one factor family.

    r: (N, D), J: (N, D, 6), mask: (N,) → (H (6,6), g (6,), cost)."""
    m = mask.to(r.dtype)
    rho, w = _huber_rho(torch.sum(r * r, dim=-1), delta)
    Jw = J * (w * m)[:, None, None]
    H = torch.einsum("nid,nie->de", Jw, J)
    g = torch.einsum("nid,ni->d", Jw, r)
    return H, g, 0.5 * torch.sum(rho * m)


def _residuals_all(q, t, factors: FactorSet, delta):
    H = q.new_zeros((6, 6))
    g = q.new_zeros((6,))
    cost = q.new_zeros(())
    for name, res_fn in _FAMILIES:
        fac = getattr(factors, name)
        if fac is not None:
            r, J = res_fn(q, t, fac)
            h, gg, c = _accumulate(r, J, fac.mask, delta)
            H, g, cost = H + h, g + gg, cost + c
    return H, g, cost


def _cost_only(q, t, factors: FactorSet, delta):
    cost = q.new_zeros(())
    for name, res_fn in _FAMILIES:
        fac = getattr(factors, name)
        if fac is not None:
            r, _ = res_fn(q, t, fac)
            rho, _d = _huber_rho(torch.sum(r * r, dim=-1), delta)
            cost = cost + 0.5 * torch.sum(rho * fac.mask)
    return cost


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _reduce(allreduce, *xs: torch.Tensor):
    """``allreduce`` of each of ``xs``, packed into one call; nothing on
    one process."""
    if allreduce is _identity:
        return xs
    flat = allreduce(torch.cat([x.reshape(-1) for x in xs]))
    parts = flat.split([x.numel() for x in xs])
    return tuple(p.reshape(x.shape) for p, x in zip(parts, xs))


_KERNEL_FAMILIES = ("edge", "plane")


def uses_lm_kernel(device: torch.device, dtype: torch.dtype,
                   factors: FactorSet, allreduce) -> bool:
    """Whether ``lm_solve`` takes the CUDA kernel: a CUDA float32 pose, one
    process (``allreduce`` the identity) and exactly the edge and plane
    families, the odometry's live path."""
    return (device.type == "cuda" and dtype == torch.float32
            and allreduce is _identity
            and all((getattr(factors, name) is not None)
                    == (name in _KERNEL_FAMILIES)
                    for name in FactorSet._fields))


def lm_solve(
    q0: torch.Tensor,
    t0: torch.Tensor,
    factors: FactorSet,
    n_iterations: int = 4,
    huber_delta: float = 0.1,
    lambda_init: float = 1e-4,
    min_factors: int = 1,
    allreduce: Callable[[torch.Tensor], torch.Tensor] = _identity,
):
    """Run ``n_iterations`` LM steps from (q0, t0); returns (q, t, cost).

    Damped normal equations (H + λ·diag(H)) δ = −g; a step is accepted only
    if the robust cost decreases (λ ×1/3 on accept, ×4 on reject).  A
    failed or non-finite solve takes a zero step.  With fewer than
    ``min_factors`` active factors the pose is returned unchanged.
    ``allreduce`` sums a tensor over the processes that hold the other
    factors (the factor count, H, g and both costs).  Where
    ``uses_lm_kernel`` holds, one launch of ``csrc/lm.cu`` runs the whole
    loop; else the plain loop runs op by op."""
    if uses_lm_kernel(q0.device, q0.dtype, factors, allreduce):
        return lm_solve_edge_plane(q0, t0, *factors.edge, *factors.plane,
                                   n_iterations, huber_delta, lambda_init,
                                   min_factors)
    return _lm_loop(q0, t0, factors, n_iterations, huber_delta, lambda_init,
                    min_factors, allreduce)


@torch.library.custom_op("light_loam_tpu_torch::lm_solve_edge_plane",
                         mutates_args=(), device_types="cpu")
def lm_solve_edge_plane(
    q0: torch.Tensor, t0: torch.Tensor,
    e_cp: torch.Tensor, e_a: torch.Tensor, e_b: torch.Tensor,
    e_s: torch.Tensor, e_weight: torch.Tensor, e_mask: torch.Tensor,
    p_cp: torch.Tensor, p_j: torch.Tensor, p_n: torch.Tensor,
    p_s: torch.Tensor, p_weight: torch.Tensor, p_mask: torch.Tensor,
    n_iterations: int, huber_delta: float, lambda_init: float,
    min_factors: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``lm_solve`` of ``FactorSet(edge=EdgeFactors(e_*),
    plane=PlaneFactors(p_*))`` on one process.  CUDA tensors launch
    ``csrc/lm.cu``; CPU tensors run the plain loop."""
    fs = FactorSet(
        edge=res.EdgeFactors(e_cp, e_a, e_b, e_s, e_weight, e_mask),
        plane=res.PlaneFactors(p_cp, p_j, p_n, p_s, p_weight, p_mask))
    q, t, cost = _lm_loop(q0, t0, fs, n_iterations, huber_delta, lambda_init,
                          min_factors)
    # a custom op's outputs may not alias its inputs (q0, t0 when no step
    # is accepted)
    return q.clone(), t.clone(), cost.clone()


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"lm_solve_edge_plane: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"lm_solve_edge_plane: {name} has dtype {x.dtype}, "
                         f"expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"lm_solve_edge_plane: {name} has shape "
                         f"{tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"lm_solve_edge_plane: {name} must be contiguous")


def staged_bytes(n_edge: int, n_plane: int) -> int:
    """Dynamic shared memory a block of ``csrc/lm.cu`` takes to stage one
    lane's factors, or 0 where they do not fit and go to a scratch
    buffer."""
    need = 4 * (EDGE_FLOATS * n_edge + PLANE_FLOATS * n_plane)
    return need if need <= MAX_STAGED_BYTES else 0


_EDGE_NAMES = ("e_cp", "e_a", "e_b", "e_s", "e_weight", "e_mask")
_PLANE_NAMES = ("p_cp", "p_j", "p_n", "p_s", "p_weight", "p_mask")


def _launch(q0, t0, edge, plane, n_iterations, huber_delta, lambda_init,
            min_factors):
    """One launch of ``csrc/lm.cu`` over B lanes: q0 (B, 4), t0 (B, 3);
    edge and plane the six tensors of each family with the lane axis in
    front -> q (B, 4), t (B, 3), cost (B,)."""
    B, Ne, Np = q0.shape[0], edge[0].shape[1], plane[0].shape[1]
    dev = q0.device
    f32 = torch.float32
    _check("q0", q0, f32, (B, 4), dev)
    _check("t0", t0, f32, (B, 3), dev)
    for names, tensors, n in ((_EDGE_NAMES, edge, Ne),
                              (_PLANE_NAMES, plane, Np)):
        for name, x in zip(names, tensors):
            if name.endswith("mask"):
                _check(name, x, torch.bool, (B, n), dev)
            elif name.endswith(("_s", "weight")):
                _check(name, x, f32, (B, n), dev)
            else:
                _check(name, x, f32, (B, n, 3), dev)
    smem = staged_bytes(Ne, Np)
    scratch = torch.empty(
        0 if smem else B * (EDGE_FLOATS * Ne + PLANE_FLOATS * Np),
        dtype=f32, device=dev)
    q = torch.empty((B, 4), dtype=f32, device=dev)
    t = torch.empty((B, 3), dtype=f32, device=dev)
    cost = torch.empty((B,), dtype=f32, device=dev)
    delta = float(huber_delta)
    LM.launch(
        q0.data_ptr(), t0.data_ptr(), *(x.data_ptr() for x in edge),
        *(x.data_ptr() for x in plane), B, Ne, Np, int(n_iterations),
        int(min_factors), delta, delta * delta, 2.0 * delta,
        float(lambda_init), q.data_ptr(), t.data_ptr(), cost.data_ptr(),
        scratch.data_ptr() if scratch.numel() else None, smem, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return q, t, cost


@lm_solve_edge_plane.register_kernel("cuda")
def _lm_solve_cuda(q0, t0, e_cp, e_a, e_b, e_s, e_weight, e_mask, p_cp, p_j,
                   p_n, p_s, p_weight, p_mask, n_iterations, huber_delta,
                   lambda_init, min_factors):
    edge = [x.contiguous()[None]
            for x in (e_cp, e_a, e_b, e_s, e_weight, e_mask)]
    plane = [x.contiguous()[None]
             for x in (p_cp, p_j, p_n, p_s, p_weight, p_mask)]
    q, t, cost = _launch(q0.contiguous()[None], t0.contiguous()[None], edge,
                         plane, n_iterations, huber_delta, lambda_init,
                         min_factors)
    return q[0], t[0], cost[0]


@lm_solve_edge_plane.register_vmap
def _lm_solve_lanes(info, in_dims, *args):
    tensors = [lanes_first(x, d, info.batch_size)
               for x, d in zip(args[:14], in_dims[:14])]
    scalars = args[14:]
    if tensors[0].is_cuda:
        return _launch(tensors[0], tensors[1], tensors[2:8], tensors[8:14],
                       *scalars), (0, 0, 0)
    outs = [lm_solve_edge_plane(*lane, *scalars) for lane in zip(*tensors)]
    return tuple(torch.stack(o) for o in zip(*outs)), (0, 0, 0)


def _lm_loop(
    q0: torch.Tensor,
    t0: torch.Tensor,
    factors: FactorSet,
    n_iterations: int = 4,
    huber_delta: float = 0.1,
    lambda_init: float = 1e-4,
    min_factors: int = 1,
    allreduce: Callable[[torch.Tensor], torch.Tensor] = _identity,
):
    """``lm_solve``'s plain loop, op by op.

    Damped normal equations (H + λ·diag(H)) δ = −g; a step is accepted only
    if the robust cost decreases (λ ×1/3 on accept, ×4 on reject).  A
    failed or non-finite solve takes a zero step.  With fewer than
    ``min_factors`` active factors the pose is returned unchanged.
    ``allreduce`` sums a tensor over the processes that hold the other
    factors (the factor count, H, g and both costs)."""
    n_active = q0.new_zeros(())
    for f in factors:
        if f is not None:
            n_active = n_active + torch.sum(f.mask.to(torch.float32))
    eye = torch.eye(6, dtype=q0.dtype, device=q0.device)

    q, t = q0, t0
    lam = torch.full((), lambda_init, dtype=q0.dtype, device=q0.device)
    cost = _cost_only(q0, t0, factors, huber_delta)
    n_active, cost = _reduce(allreduce, n_active, cost)
    solvable = n_active >= min_factors
    for _ in range(n_iterations):
        H, g, _ = _residuals_all(q, t, factors, huber_delta)
        H, g = _reduce(allreduce, H, g)
        damped = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye
        L, info = torch.linalg.cholesky_ex(damped)
        # two triangular solves, not cholesky_solve: under vmap (batched
        # lanes) the card's cholesky_solve goes to MAGMA, which cannot be
        # captured in a CUDA graph; cuBLAS's batched trsm can (on the CPU
        # the two give the same floats)
        y = torch.linalg.solve_triangular(L, -g[:, None], upper=False)
        delta = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
        ok = (info == 0) & torch.isfinite(delta).all()
        delta = torch.where(ok, delta, torch.zeros_like(delta))
        q_new = quat.quat_normalize(quat.quat_multiply(q, quat.quat_exp(delta[:3])))
        t_new = t + delta[3:]
        (new_cost,) = _reduce(allreduce,
                              _cost_only(q_new, t_new, factors, huber_delta))
        accept = (new_cost < cost) & solvable
        q = torch.where(accept, q_new, q)
        t = torch.where(accept, t_new, t)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * (1.0 / 3.0), lam * 4.0)
    return q, t, cost
