"""Scan-to-map refinement and map update of one sweep, plain PyTorch
(laserMapping.cpp).

The map is Light-LOAM's grid of 21 x 21 x 11 cubes of 50 m, kept as two
stores (corner, surf) of voxel centroids, each point tagged with its cube.
Per sweep: the odometry pose is carried into the map frame by the last
odom-to-map correction; the grid shifts to keep a 3-cube margin round the
pose cube (dropping what rolls out); the points of the 5 x 5 x 3 cubes
round the pose form the local map (in cube order, cut at the local
capacity); the sweep's less-sharp and less-flat clouds are downsampled on
0.4 / 0.8 m voxel grids (cut at the stack capacity).  If the local map has
more than 10 corner and 50 surf points, ``outer_iterations`` passes each
find every stack point's 5 nearest map points (a match needs the fifth
under 1 m^2): a corner whose neighbours have one eigenvalue of their
scatter over 3 times the next is an edge factor on the line through their
mean (points 0.1 m either side along the main axis); a surf point whose
neighbours fit n . x = -1 with every residual of the unit plane within
0.2 m is a plane factor; ``inner_iterations`` steps of the robust solve
follow.  Then the correction is refreshed and the stacks, moved by the
mapped pose, are merged into the stores: each store's points and the new
ones are averaged per voxel (of the cube and the 0.4 / 0.8 m grid) and
kept in voxel order up to the store's capacity.
"""

from __future__ import annotations

import torch

from reference import solve
from reference.numerics import (
    Numerics,
    quat_inv,
    quat_mul,
    quat_normalize,
    rot,
    transform,
    voxel_centroids,
)

CHUNK = 1024


def _split(cell, dims):
    w, h, _ = dims
    return torch.stack([cell % w, (cell // w) % h, cell // (w * h)], -1)


def _linear(ijk, dims):
    w, h, _ = dims
    return ijk[:, 0] + w * ijk[:, 1] + w * h * ijk[:, 2]


def _inside(ijk, dims):
    return ((ijk >= 0) & (ijk < torch.tensor(dims, device=ijk.device))).all(-1)


def _cube(xyz, cen, size):
    return torch.floor((xyz + size / 2.0) / size).to(torch.int64) + cen


def knn5(nm: Numerics, query, ref):
    """(sq distances (q, 5) ascending, indices (q, 5)); 1e30 where a slot
    has no point."""
    k = 5
    d_out = query.new_full((query.shape[0], k), 1e30)
    i_out = torch.zeros((query.shape[0], k), dtype=torch.int64,
                        device=query.device)
    m = min(k, ref.shape[0])
    if m == 0:
        return d_out, i_out
    for s in range(0, query.shape[0], CHUNK):
        d = nm.sqdist(query[s:s + CHUNK], ref)
        dv, iv = torch.topk(d, m, dim=1, largest=False, sorted=True)
        d_out[s:s + CHUNK, :m] = dv
        i_out[s:s + CHUNK, :m] = iv
    return d_out, i_out


def plane_fit(nm: Numerics, near: torch.Tensor, gate: float):
    """(unit normal, offset, ok) of the plane n . x = -1 through each set of
    5 neighbours: the least-squares solution of A n = -1 (A the neighbours'
    coordinates) by Householder QR, as laserMapping.cpp solves it
    (``colPivHouseholderQr`` in double), ok where R is of full rank and
    every neighbour lies within ``gate`` of the plane.  QR works on A
    itself, not on the normal equations, whose conditioning is the square
    of A's: tens of metres from the map's origin they leave float32 nothing
    to solve with (PERF.md)."""
    a = near.to(nm.dtype)
    Q, R = torch.linalg.qr(a)
    rhs = nm.mm(Q.transpose(1, 2), -torch.ones_like(a[:, :, :1]))
    diag = torch.diagonal(R, dim1=-2, dim2=-1).abs()
    full = (diag > diag.amax(-1, keepdim=True).clamp(min=1e-30) * 1e-7).all(-1)
    safe = torch.where(full[:, None, None], R,
                       torch.eye(3, dtype=R.dtype, device=R.device))
    nvec = torch.linalg.solve_triangular(safe, rhs, upper=True)[..., 0]
    norm = torch.linalg.norm(nvec, dim=-1).clamp(min=1e-30)
    n_hat = nvec / norm[:, None]
    resid = (nm.mm(a, n_hat[:, :, None])[..., 0] + (1.0 / norm)[:, None]).abs()
    ok = full & torch.isfinite(nvec).all(-1) & (resid <= gate).all(-1)
    return n_hat, 1.0 / norm, ok


def initial_state(p: dict, device, dtype=torch.float64) -> dict:
    """The mapping state before the first sweep: empty stores, the grid's
    centre cube in the middle of the grid (laserMapping.cpp), no
    odom-to-map correction."""
    empty = (torch.zeros((0, 3), dtype=dtype, device=device),
             torch.zeros(0, dtype=torch.int64, device=device))
    return {"corner": empty, "surf": empty,
            "cen": torch.tensor([p["cube_width"] // 2, p["cube_height"] // 2,
                                 p["cube_depth"] // 2], device=device),
            "q_wm": torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype,
                                 device=device),
            "t_wm": torch.zeros(3, dtype=dtype, device=device), "frame": 0}


def step(nm: Numerics, state: dict, corner_last, surf_last, q_odom, t_odom,
         p: dict, sizes: list | None = None) -> dict:
    """One sweep: the new mapping state (with the mapped pose).  Appends
    to ``sizes``, where given, the sweep's (corner stack, corner local map,
    surf stack, surf local map) point counts: the live sizes of the 5-NN
    searches."""
    dims = (p["cube_width"], p["cube_height"], p["cube_depth"])
    size = p["cube_size"]
    q_odom, t_odom = q_odom.to(nm.dtype), t_odom.to(nm.dtype)
    q_wm, t_wm = state["q_wm"].to(nm.dtype), state["t_wm"].to(nm.dtype)
    q = quat_normalize(quat_mul(q_wm, q_odom))
    t = nm.mm(rot(q_wm), t_odom[:, None])[:, 0] + t_wm

    # keep a margin of cubes round the pose cube
    cen = state["cen"]
    center = _cube(t[None], cen, size)[0]
    m = p["recenter_margin"]
    dims_t = torch.tensor(dims, device=cen.device)
    over = torch.clamp(center - (dims_t - m - 1), min=0)
    shift = torch.clamp(m - center, min=0) - over
    center, cen = center + shift, cen + shift
    stores = {}
    for kind in ("corner", "surf"):
        xyz, cell = state[kind]
        ijk = _split(cell, dims) + shift
        ok = _inside(ijk, dims)
        stores[kind] = (xyz[ok].to(nm.dtype), _linear(ijk[ok], dims))

    half = torch.tensor([p["local_half_i"], p["local_half_j"],
                         p["local_half_k"]], device=cen.device)
    local = {}
    for kind, cap in (("corner", p["local_corner_capacity"]),
                      ("surf", p["local_surf_capacity"])):
        xyz, cell = stores[kind]
        near = ((_split(cell, dims) - center).abs() <= half).all(-1)
        local[kind] = xyz[near][:cap]

    def stack(cloud, leaf, cap):
        xyz, _, mask = cloud
        return voxel_centroids(xyz[mask].to(nm.dtype), leaf)[0][:cap]

    st_c = stack(corner_last, p["line_resolution"], p["stack_corner_capacity"])
    st_s = stack(surf_last, p["plane_resolution"], p["stack_surf_capacity"])
    if sizes is not None:
        sizes.append((st_c.shape[0], local["corner"].shape[0],
                      st_s.shape[0], local["surf"].shape[0]))
    big_enough = (local["corner"].shape[0] > p["min_corner_map_points"]
                  and local["surf"].shape[0] > p["min_surf_map_points"])
    gate = p["knn_sq_gate"]
    for _ in range(p["outer_iterations"] if big_enough else 0):
        d, i = knn5(nm, transform(nm, q, t, st_c), local["corner"])
        near = local["corner"][i]
        mean = near.mean(1)
        diff = near - mean[:, None]
        vals, vecs = torch.linalg.eigh(nm.mm(diff.transpose(1, 2), diff))
        ok = (d[:, 4] < gate) & (vals[:, 2] > p["line_eig_ratio"] * vals[:, 1])
        axis = vecs[:, :, 2]
        off = p["line_point_offset"]
        edges = (st_c[ok], solve.edge_factor(mean[ok] + off * axis[ok],
                                             mean[ok] - off * axis[ok]))

        d, i = knn5(nm, transform(nm, q, t, st_s), local["surf"])
        n_hat, neg_d, fit_ok = plane_fit(nm, local["surf"][i], p["plane_fit_gate"])
        ok = (d[:, 4] < gate) & fit_ok
        planes = (st_s[ok], solve.plane_norm_factor(n_hat[ok], neg_d[ok]))
        q, t = solve.lm(nm, q, t, [edges, planes], p["inner_iterations"],
                        p["huber_delta"])

    q_wm = quat_normalize(quat_mul(q, quat_inv(q_odom)))
    t_wm = t - nm.mm(rot(q_wm), t_odom[:, None])[:, 0]

    new = {}
    for kind, st, leaf, cap in (
            ("corner", st_c, p["line_resolution"], p["map_corner_capacity"]),
            ("surf", st_s, p["plane_resolution"], p["map_surf_capacity"])):
        reg = transform(nm, q, t, st)
        ijk = _cube(reg, cen, size)
        ok = _inside(ijk, dims)
        xyz, cell = stores[kind]
        all_xyz = torch.cat([xyz, reg[ok]])
        all_cell = torch.cat([cell, _linear(ijk[ok], dims)])
        cent, cells = voxel_centroids(all_xyz, leaf, major=all_cell)
        new[kind] = (cent[:cap], cells[:cap])
    return {"corner": new["corner"], "surf": new["surf"], "cen": cen,
            "q_wm": q_wm, "t_wm": t_wm, "q_w": q, "t_w": t,
            "frame": state["frame"] + 1}
