"""The JAX package's mapping steps with tests/oracle.py's plane fit, for the
twins that hold whole mapping steps of the port to the package's.

laserMapping.cpp solves each surf point's 5-neighbour plane A n = -1 by a
QR in double, as ``oracle.plane_lstsq`` does with ``np.linalg.lstsq``.
The JAX package solves the normal equations AᵀA n = -Aᵀ1 of raw
coordinates in float32 by the adjugate, which tens of metres from the
map's origin decides the 0.2 m residual gate by rounding, so that a whole
step moves by mm to cm.  Inside ``oracle_planes()`` the package's
``plane_fit_factors`` fits each live set by ``oracle.plane_lstsq`` on the
host (``jax.pure_callback``, so jitted, vmapped and sharded steps reach
it); the port's float32 fit is then held to the C++'s double plane.
Everything else of the package's step is its own.

    python tests/oracle_planes.py WORKER ARGS...

runs the script ``WORKER`` with its arguments inside ``oracle_planes()``
(tests/test_torch_multihost.py runs tests/multihost_worker.py so).
"""

from __future__ import annotations

import contextlib
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from light_loam_tpu.models import mapping as jm  # noqa: E402
from light_loam_tpu.parallel import sharded as jsharded  # noqa: E402
from oracle import plane_lstsq  # noqa: E402


def _fit(near, live, gate):
    """(unit normals, 1 / |n|, gate passed) of the live sets, in float64;
    zeros where a set is not live or |n| is 0."""
    near = np.asarray(near, np.float64)
    n_hat = np.zeros(near.shape[:1] + (3,), np.float32)
    neg_d = np.zeros(near.shape[:1], np.float32)
    ok = np.zeros(near.shape[:1], bool)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in np.flatnonzero(np.asarray(live)):
            n, d, passed = plane_lstsq(near[i], gate)
            if np.isfinite(d):
                n_hat[i], neg_d[i], ok[i] = n, d, passed
    return n_hat, neg_d, ok


def plane_fit_factors(stack_xyz, stack_mask, d, near, cfg):
    """``light_loam_tpu.models.mapping.plane_fit_factors`` with each live
    set fit by ``oracle.plane_lstsq``."""
    q = stack_xyz.shape[0]
    live = stack_mask & (d[:, cfg.knn_k - 1] < cfg.knn_sq_gate)
    n_hat, neg_d, ok = jax.pure_callback(
        lambda a, b: _fit(a, b, cfg.plane_fit_gate),
        (jax.ShapeDtypeStruct((q, 3), jnp.float32),
         jax.ShapeDtypeStruct((q,), jnp.float32),
         jax.ShapeDtypeStruct((q,), jnp.bool_)),
        near, live, vmap_method="sequential")
    return jm.PlaneNormFactors(
        cp=stack_xyz, n=n_hat, d=neg_d,
        weight=jnp.ones(q, jnp.float32), mask=live & ok)


@contextlib.contextmanager
def oracle_planes():
    """The JAX package's mapping steps (single-device, batched, sharded)
    fit their planes by ``plane_fit_factors`` inside the block.  Compiled
    programs are dropped on the way in and out, so that none traced with
    the other fit is reused."""
    saved = jm.plane_fit_factors, jsharded.plane_fit_factors
    jax.clear_caches()
    jm.plane_fit_factors = jsharded.plane_fit_factors = plane_fit_factors
    try:
        yield
    finally:
        jm.plane_fit_factors, jsharded.plane_fit_factors = saved
        jax.clear_caches()


if __name__ == "__main__":
    sys.argv = sys.argv[1:]
    with oracle_planes():
        runpy.run_path(sys.argv[0], run_name="__main__")
