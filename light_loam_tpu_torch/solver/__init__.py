from light_loam_tpu_torch.solver.gauss_newton import FactorSet, lm_solve
from light_loam_tpu_torch.solver.residuals import (
    DistanceFactors,
    EdgeFactors,
    EdgeScalarFactors,
    PlaneComponentFactors,
    PlaneFactors,
    PlaneNormFactors,
    distance_residuals,
    edge_residuals,
    edge_scalar_residuals,
    make_plane_factors,
    plane_component_residuals,
    plane_norm_residuals,
    plane_residuals,
)

__all__ = [
    "DistanceFactors",
    "EdgeFactors",
    "EdgeScalarFactors",
    "PlaneComponentFactors",
    "PlaneFactors",
    "PlaneNormFactors",
    "distance_residuals",
    "edge_residuals",
    "edge_scalar_residuals",
    "make_plane_factors",
    "plane_component_residuals",
    "plane_norm_residuals",
    "plane_residuals",
    "lm_solve",
    "FactorSet",
]
