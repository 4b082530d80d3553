"""Sweeps driven one after another through features and odometry.

``initial_state`` is Light-LOAM's odometry state before the first sweep
(no previous clouds, identity poses); ``odometry_run`` drives sweeps in
order from a state.  The mapping step is ``reference.mapping.step``.  The
reference imports nothing of the program: states come in as dicts of
tensors.
"""

from __future__ import annotations

import torch

from reference import features, odometry
from reference.numerics import Numerics


def initial_state(device, dtype=torch.float64) -> dict:
    """The odometry state before the first sweep."""
    empty = (torch.zeros((0, 3), dtype=dtype, device=device),
             torch.zeros(0, dtype=torch.int64, device=device),
             torch.zeros(0, dtype=torch.bool, device=device))
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)
    zero = torch.zeros(3, dtype=dtype, device=device)
    return {"corner": empty, "surf": empty, "q_w": ident, "t_w": zero,
            "q_lc": ident, "t_lc": zero, "frame": 0}


def odometry_run(nm: Numerics, odo: dict, sweeps, params: dict) -> list:
    """Odometry poses (q_w, t_w) of each sweep, driving the sweeps in order
    from ``odo``."""
    out = []
    for pts in sweeps:
        f = features.extract(pts, params["scan"], nm)
        odo = odometry.step(nm, odo, f, params["odometry"])
        out.append((odo["q_w"], odo["t_w"]))
    return out
