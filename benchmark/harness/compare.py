"""The comparison that decides ``correct``.

The timed path hands back, for every sweep, an odometry pose and a mapped
pose, and leaves a map behind.  After the window the plain reference
(``benchmark/reference``) recomputes a sample of them: a few runs of
consecutive sweeps, the first from sweep 0 and the others starting at
times drawn from the seed across the whole window (``window.Plan``), so
that later laps, where the map is revisited, are judged too.  The
program's states before each run and its map after it are copied into
buffers the harness owns.

From the empty state (sweep 0) or from the program's odometry and mapping
states before the run's first sweep, the reference extracts each sweep's
features, registers it and maps it with its own answers, sweep after
sweep: its features, odometry and mapping, chained as the program chains
them.  Nothing of the program's work inside a run reaches it.  Besides,
each sweep's mapping step is recomputed from the program's own map before
it and the program's odometry clouds and pose of it: the mapping stage by
itself, where a chained run's mapped pose hangs on the sweeps before.

A pose gap is the largest distance, in mm, between where the two poses put
the corners of a 20 m cube round the sensor: a rotation and a translation
gap in one number.  The numbers: the largest odometry gap of the chained
runs (``odom_gap_mm``) and of their first registrations alone, one step
from a state both sides share (``odom_step_gap_mm``); the largest mapped
gap of the chained runs (``map_gap_mm``) and of the single mapping steps
(``map_step_gap_mm``); the share of voxels of the map that the program's
map does not hold within 5 mm of the reference's, after each chained run
(``store_mismatch_pct``) and after each single step
(``store_step_mismatch_pct``).  A cell compares the numbers its
``cells/<workload>.json`` gives limits for.
"""

from __future__ import annotations

import math

import torch

from reference import features, mapping, odometry, slam
from reference.numerics import Numerics, rot

# a voxel of the map update counts as differing where only one map holds it
# or the two centroids lie further apart than this: above what the sound
# program's sub-mm to few-mm mapped-pose gaps move a centroid (PERF.md)
STORE_TOL_MM = 5.0
CUBE = torch.tensor([[x, y, z] for x in (-10.0, 10.0) for y in (-10.0, 10.0)
                     for z in (-10.0, 10.0)], dtype=torch.float64)


def pose_gap_mm(q1, t1, q2, t2) -> float:
    """The pose gap of (q1, t1) from (q2, t2), NumPy arrays or tensors."""
    q1, t1, q2, t2 = (torch.as_tensor(x).detach().cpu().to(torch.float64)
                      for x in (q1, t1, q2, t2))
    if not all(bool(torch.isfinite(x).all()) for x in (q1, t1)):
        return math.inf
    p1 = CUBE @ rot(q1 / torch.linalg.norm(q1)).T + t1
    p2 = CUBE @ rot(q2 / torch.linalg.norm(q2)).T + t2
    return float(torch.linalg.norm(p1 - p2, dim=-1).max()) * 1000.0


def odometry_dict(s, device) -> dict:
    """A program OdometryState (one lane) as the reference's state."""
    def cloud(pc):
        return (pc.xyz.to(device, torch.float64),
                torch.floor(pc.rel).to(device, torch.int64),
                pc.mask.to(device))
    f64 = dict(device=device, dtype=torch.float64)
    return {"corner": cloud(s.corner_last), "surf": cloud(s.surf_last),
            "q_w": s.q_w.to(**f64), "t_w": s.t_w.to(**f64),
            "q_lc": s.q_lc.to(**f64), "t_lc": s.t_lc.to(**f64),
            "frame": int(s.frame)}


def mapping_dict(s, device) -> dict:
    """A program MappingState (one lane) as the reference's state: the
    live rows of each store, in store order."""
    def store(st):
        m = st.mask
        return (st.xyz[m].to(device, torch.float64),
                st.cell[m].to(device, torch.int64))
    f64 = dict(device=device, dtype=torch.float64)
    return {"corner": store(s.corner), "surf": store(s.surf),
            "cen": s.cen.to(device, torch.int64),
            "q_wm": s.q_wm.to(**f64), "t_wm": s.t_wm.to(**f64),
            "frame": int(s.frame)}


def lane(tree, b: int):
    """Lane ``b`` of a state whose leaves have a leading lane axis."""
    if isinstance(tree, torch.Tensor):
        return tree[b]
    parts = [lane(x, b) for x in tree]
    return tuple(parts) if type(tree) is tuple else type(tree)(*parts)


def to_host(tree):
    """A state's tensors copied to the host (nested NamedTuples kept)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    parts = [to_host(x) for x in tree]
    return tuple(parts) if type(tree) is tuple else type(tree)(*parts)


def store_mismatch(ref: tuple, prog: tuple, leaf: float) -> float:
    """Of one map store, the share in % of the reference's voxels that the
    program's store does not hold within STORE_TOL_MM: voxels that only one
    store holds, and voxels whose centroids lie further apart.  Both stores
    are (xyz, cell) of live rows."""
    dev = ref[0].device
    p_xyz = prog[0].to(dev, torch.float64)
    p_cell = prog[1].to(dev, torch.int64)

    def keys(xyz, cell):
        ijk = torch.floor(xyz / leaf).to(torch.int64) + (1 << 15)
        return (cell << 48) | (ijk[:, 2] << 32) | (ijk[:, 0] << 16) | ijk[:, 1]
    kr, kp = keys(*ref), keys(p_xyz, p_cell)
    n = max(len(kr), 1)
    if len(kp) == 0:
        return 100.0 * len(kr) / n
    order = torch.argsort(kp)
    kp, p_xyz = kp[order], p_xyz[order]
    at = torch.searchsorted(kp, kr).clamp(max=len(kp) - 1)
    hit = kp[at] == kr
    gap = torch.linalg.norm(ref[0] - p_xyz[at], dim=-1) * 1000.0
    only_one = len(kr) + len(kp) - 2 * int(hit.sum())
    return 100.0 * (only_one + int((hit & (gap > STORE_TOL_MM)).sum())) / n


def _judged(nm: Numerics, runs: list, params: dict, device,
            sizes: list | None = None) -> list:
    """What ``nm`` computes for each run: (per sweep (odometry pose, mapped
    pose), the map after the run {kind: (xyz, cell)}).  The sizes of the 5-NN
    searches of the runs marked ``profiled`` go to ``sizes``."""
    out = []
    for run in runs:
        odo = (slam.initial_state(device) if run["odo"] is None
               else odometry_dict(run["odo"], device))
        maps = run["map_after"] is not None
        mp = (mapping.initial_state(params["mapping"], device)
              if run["map"] is None else mapping_dict(run["map"], device))
        per = []
        for pts in run["sweeps"]:
            f = features.extract(torch.as_tensor(pts).to(device),
                                 params["scan"], nm)
            odo = odometry.step(nm, odo, f, params["odometry"])
            if maps:
                mp = mapping.step(nm, mp, odo["corner"], odo["surf"],
                                  odo["q_w"], odo["t_w"], params["mapping"],
                                  sizes if run.get("profiled") else None)
            per.append(((odo["q_w"], odo["t_w"]),
                        (mp["q_w"], mp["t_w"]) if maps else None))
        out.append((per, {k: mp[k] for k in ("corner", "surf")} if maps
                    else None))
    return out


def _stepped(nm: Numerics, runs: list, params: dict, device) -> list:
    """What ``nm`` computes for each sweep of each run's mapping step from
    the program's own state: the program's map before the sweep, its
    odometry clouds and pose of the sweep.  Per run, per sweep: (mapped
    pose, merged map {kind: (xyz, cell)}); None for a run that holds no
    states inside it."""
    out = []
    for run in runs:
        if run["steps"] is None:
            out.append(None)
            continue
        per = []
        for before, odo_after, _ in run["steps"]:
            mp = (mapping.initial_state(params["mapping"], device)
                  if before is None else mapping_dict(before, device))
            o = odometry_dict(odo_after, device)
            new = mapping.step(nm, mp, o["corner"], o["surf"], o["q_w"],
                               o["t_w"], params["mapping"])
            per.append(((new["q_w"], new["t_w"]),
                        {k: new[k] for k in ("corner", "surf")}))
        out.append(per)
    return out


def _stores(state) -> dict:
    return {k: (getattr(state, k).xyz[getattr(state, k).mask],
                getattr(state, k).cell[getattr(state, k).mask])
            for k in ("corner", "surf")}


def _program(runs: list) -> tuple:
    """The program's answers in the forms ``_judged`` and ``_stepped``
    return."""
    chained, stepped = [], []
    for run in runs:
        maps = run["map_after"] is not None
        chained.append(([((q, t), (mq, mt) if maps else None)
                         for q, t, mq, mt in run["poses"]],
                        _stores(run["map_after"]) if maps else None))
        stepped.append(None if run["steps"] is None else
                       [((mq, mt), _stores(after))
                        for (_, _, after), (_, _, mq, mt)
                        in zip(run["steps"], run["poses"])])
    return chained, stepped


def compare_runs(runs: list, params: dict, device, control: bool = False,
                 sizes: list | None = None, judged_nm: Numerics | None = None
                 ) -> dict:
    """Each run is a dict: ``odo`` and ``map``, the program's states before
    its first sweep (None for the empty state); ``sweeps``; ``poses``, the
    program's (odom q, t, map q, t) of each sweep; ``map_after``, the
    program's mapping state after the last (``map``, ``map_after`` and the
    mapped poses None where the program runs no mapping); ``steps``, per sweep the
    program's (map before, odometry state after, map after), or None.
    Returns the largest reading of each number over all the runs: of the
    program, or with ``control`` of the reference computed in TF32 in the
    program's place (the TF32 tensor cores allowed while it runs), or of
    the reference computed with ``judged_nm``."""
    ref = _judged(Numerics(), runs, params, device, sizes)
    ref_step = _stepped(Numerics(), runs, params, device)
    if control or judged_nm is not None:
        nm = judged_nm or Numerics(tf32=True)
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = nm.tf32
        try:
            judged = _judged(nm, runs, params, device)
            judged_step = _stepped(nm, runs, params, device)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
    else:
        judged, judged_step = _program(runs)
    mp = params["mapping"]
    leaves = (("corner", mp["line_resolution"]), ("surf", mp["plane_resolution"]))
    out = {"odom_gap_mm": 0.0, "odom_step_gap_mm": 0.0, "map_gap_mm": 0.0,
           "store_mismatch_pct": 0.0, "map_step_gap_mm": 0.0,
           "store_step_mismatch_pct": 0.0}
    for run, (ref_per, ref_map), (per, store), r_steps, steps in zip(
            runs, ref, judged, ref_step, judged_step):
        # the run's first registration: its first sweep from a held state,
        # its second from the empty one (the first sweep only stores clouds)
        step = 0 if run["odo"] is not None else 1
        for j, ((r_odo, r_map), (odo, mapped)) in enumerate(zip(ref_per, per)):
            gap = pose_gap_mm(*odo, *r_odo)
            out["odom_gap_mm"] = max(out["odom_gap_mm"], gap)
            if j <= step:
                out["odom_step_gap_mm"] = max(out["odom_step_gap_mm"], gap)
            if mapped is not None:
                out["map_gap_mm"] = max(out["map_gap_mm"],
                                        pose_gap_mm(*mapped, *r_map))
        for kind, leaf in leaves if store is not None else ():
            out["store_mismatch_pct"] = max(
                out["store_mismatch_pct"],
                store_mismatch(ref_map[kind], store[kind], leaf))
        for (r_pose, r_store), (pose, st) in zip(r_steps or [], steps or []):
            out["map_step_gap_mm"] = max(out["map_step_gap_mm"],
                                         pose_gap_mm(*pose, *r_pose))
            for kind, leaf in leaves:
                out["store_step_mismatch_pct"] = max(
                    out["store_step_mismatch_pct"],
                    store_mismatch(r_store[kind], st[kind], leaf))
    return out


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, compared): each reading beside its limit."""
    compared = {k: {"value": readings[k], "limit": limits[k]}
                for k in sorted(limits)}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in compared.values())
    return ok, compared
