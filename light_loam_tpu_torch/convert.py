"""Carry pipeline state between the JAX package and this port.

This system has no learned weights: its state (the last feature clouds,
poses and frame counters of odometry; the map stores of mapping) plays
that role.  These functions take a state's leaves as numpy arrays — e.g.
``jax.tree_util.tree_map(np.asarray, state)._asdict()`` of the JAX
package's ``OdometryState`` / ``MappingState`` — and build the port's
state on ``device``, and back.  Nested containers may be NamedTuples or
dicts.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from light_loam_tpu_torch.core.frame import PointCloud
from light_loam_tpu_torch.models.mapping import MappingState, MapStore
from light_loam_tpu_torch.models.odometry import OdometryState

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def _fields(x: Any) -> Mapping[str, Any]:
    return x._asdict() if hasattr(x, "_asdict") else x


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: device arrays read back read-only
    return torch.from_numpy(a).to(device=device, dtype=_DTYPES[a.dtype])


def _cloud(d, device) -> PointCloud:
    d = _fields(d)
    return PointCloud(xyz=_tensor(d["xyz"], device),
                      rel=_tensor(d["rel"], device),
                      mask=_tensor(d["mask"], device))


def _store(d, device) -> MapStore:
    d = _fields(d)
    return MapStore(xyz=_tensor(d["xyz"], device),
                    cell=_tensor(d["cell"], device),
                    mask=_tensor(d["mask"], device))


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return {k: _numpy(v) for k, v in _fields(x).items()}


def odometry_state_from_numpy(d, device="cpu") -> OdometryState:
    d = _fields(d)
    return OdometryState(
        corner_last=_cloud(d["corner_last"], device),
        surf_last=_cloud(d["surf_last"], device),
        **{k: _tensor(d[k], device)
           for k in ("q_w", "t_w", "q_lc", "t_lc", "frame")},
    )


def mapping_state_from_numpy(d, device="cpu") -> MappingState:
    d = _fields(d)
    return MappingState(
        corner=_store(d["corner"], device),
        surf=_store(d["surf"], device),
        **{k: _tensor(d[k], device) for k in ("cen", "q_wm", "t_wm", "frame")},
    )


def odometry_state_to_numpy(state: OdometryState) -> dict:
    """Nested dict of numpy arrays with the JAX package's field names."""
    return _numpy(state)


def mapping_state_to_numpy(state: MappingState) -> dict:
    """Nested dict of numpy arrays with the JAX package's field names."""
    return _numpy(state)
