"""Block-sparse Gauss-Newton via Schur complement.

Counterpart of ``light_loam_tpu/solver/schur.py``.  The bundle-adjustment
system of the windowed multi-keyframe refinement (models/refine.py):

    [ Hpp  Hpl ] [δp]   [-g_p]
    [ Hplᵀ Hll ] [δl] = [-g_l]

with K 6-dof keyframe poses and M 3-dof plane landmarks.  Hpp and Hll are
block-diagonal (6×6 per pose, 3×3 per landmark), so the landmarks are
eliminated:

    S = Hpp − Hpl Hll⁻¹ Hplᵀ          (dense 6K×6K)
    S δp = −g_p + Hpl Hll⁻¹ g_l
    δl = −Hll⁻¹ (g_l + Hplᵀ δp)

The reductions are batched einsums at full float32 (TF32 is off package
wide: the 1e8 gauge prior on keyframe 0 leaves S badly scaled); the dense
solve is an LU with partial pivoting, as the JAX package's.  Nothing here
reads the device to the host: a singular or non-finite solve comes back as
zeros, decided on the device.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched 3×3 inverse via the adjugate; blocks with |det| <= 1e-12 come
    back as zeros (their landmarks contribute nothing).  Not
    ``torch.linalg.inv``, which raises on a singular block."""
    a = A
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    adjT = torch.stack(
        [
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ],
        dim=-2,
    )
    ok = det.abs() > 1e-12
    safe = torch.where(ok, det, torch.ones_like(det))
    inv = adjT / safe[..., None, None]
    return torch.where(ok[..., None, None], inv, torch.zeros_like(inv))


def schur_solve(
    Hpp: torch.Tensor,  # (K, 6, 6) per-pose diagonal blocks
    g_p: torch.Tensor,  # (K, 6)
    Hpl: torch.Tensor,  # (K, M, 6, 3) pose-landmark coupling
    Hll: torch.Tensor,  # (M, 3, 3) per-landmark diagonal blocks
    g_l: torch.Tensor,  # (M, 3)
    damping: float = 1e-6,
    fix_first_pose: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (δp (K, 6), δl (M, 3)).

    ``fix_first_pose`` pins keyframe 0 (gauge freedom) by adding a large
    prior to its block.
    """
    K = Hpp.shape[0]
    dev, dt = Hpp.device, Hpp.dtype

    eye3 = torch.eye(3, dtype=Hll.dtype, device=dev)
    Hll_d = (Hll + damping * eye3[None]
             + damping * torch.einsum("mii->m", Hll)[:, None, None] * eye3[None])
    Hll_inv = _inv3x3(Hll_d)

    eye6 = torch.eye(6, dtype=dt, device=dev)
    prior = torch.zeros(K, dtype=dt, device=dev)
    if fix_first_pose:
        prior[0] = 1e8
    Hpp_d = (
        Hpp
        + damping * eye6[None]
        + damping * torch.einsum("kii->k", Hpp)[:, None, None] * eye6[None]
        + prior[:, None, None] * eye6[None]
    )

    # W[k,m] = Hpl[k,m] @ Hll_inv[m]
    W = torch.einsum("kmab,mbc->kmac", Hpl, Hll_inv)
    # S = blockdiag(Hpp) − Σ_m W[k,m] Hpl[k',m]ᵀ  (dense K×K of 6×6); the
    # diagonal blocks are added by a select, not a scatter
    S = -torch.einsum("kmac,jmbc->kjab", W, Hpl)
    diag = torch.eye(K, dtype=torch.bool, device=dev)[:, :, None, None]
    S = S + torch.where(diag, Hpp_d[:, None], torch.zeros((), dtype=dt,
                                                           device=dev))
    rhs = -g_p + torch.einsum("kmac,mc->ka", W, g_l)

    S_flat = S.transpose(1, 2).reshape(K * 6, K * 6)
    sol, info = torch.linalg.solve_ex(
        S_flat + 1e-9 * torch.eye(K * 6, dtype=dt, device=dev),
        rhs.reshape(K * 6))
    dp = sol.reshape(K, 6)

    # back-substitute landmarks
    dl = -torch.einsum("mbc,mc->mb", Hll_inv,
                       g_l + torch.einsum("kmab,ka->mb", Hpl, dp))
    # a zero pivot (info > 0) is where the JAX package's LU returns inf or
    # nan, which then reaches dl as well
    dp_ok = (info == 0) & torch.isfinite(dp).all()
    dl_ok = dp_ok & torch.isfinite(dl).all()
    return (torch.where(dp_ok, dp, torch.zeros_like(dp)),
            torch.where(dl_ok, dl, torch.zeros_like(dl)))
