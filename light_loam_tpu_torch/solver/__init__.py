from light_loam_tpu_torch.solver.gauss_newton import FactorSet, lm_solve
from light_loam_tpu_torch.solver.residuals import (
    EdgeFactors,
    PlaneFactors,
    PlaneNormFactors,
    edge_residuals,
    make_plane_factors,
    plane_norm_residuals,
    plane_residuals,
)

__all__ = [
    "EdgeFactors",
    "PlaneFactors",
    "PlaneNormFactors",
    "edge_residuals",
    "make_plane_factors",
    "plane_norm_residuals",
    "plane_residuals",
    "lm_solve",
    "FactorSet",
]
