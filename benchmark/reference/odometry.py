"""Scan-to-scan odometry of one sweep, plain PyTorch (laserOdometry.cpp).

From the previous sweep's less-sharp and less-flat clouds and the last
increment: ``outer_iterations`` passes, each moving the sharp and flat
points by the current increment and matching them against the previous
clouds (a corner: its nearest point and the nearest point of another ring
within 2.5 rings; a flat point: its nearest point, the nearest other point
of that ring and the nearest point of another ring within 2.5 rings; every
distance under 25 m^2), then ``inner_iterations`` steps of the robust
solve.  Every matched corner is an edge factor.  Once the frame counter
passes ``vote_start_frame`` the plane matches go through the simple graph
vote: the valid matches, in flat-cloud order, are cut into 10 contiguous
regions; two matches of a region disagree when exp(-gap^2) < 0.96 for the
gap between their source and their target distances; a match with at most
0.9 k disagreements in a region of k is kept, at weight 5 with at most 50
and 1 above.  The increment is then added to the world pose, and the
sweep's less-sharp and less-flat clouds become the next sweep's.
"""

from __future__ import annotations

import torch

from reference import solve
from reference.numerics import Numerics, quat_mul, quat_normalize, rot, transform

BIG = float("inf")
CHUNK = 512


def _matches(nm: Numerics, query, ref_xyz, ref_ring, ref_mask, surf: bool,
             nearby: float):
    """Per query: (a, b, c, d_a, d_b, d_c).  Corners leave c at zero."""
    n = query.shape[0]
    out = [torch.zeros(n, dtype=torch.int64, device=query.device)
           for _ in range(3)] + [query.new_full((n,), BIG) for _ in range(3)]
    if n == 0 or ref_xyz.shape[0] == 0:
        return out
    idx_all = torch.arange(ref_xyz.shape[0], device=query.device)
    for s in range(0, n, CHUNK):
        d = nm.sqdist(query[s:s + CHUNK], ref_xyz)
        d = torch.where(ref_mask[None, :], d, BIG)
        a = d.argmin(1)
        rows = torch.arange(d.shape[0], device=d.device)
        ring_a = ref_ring[a]
        diff = ref_ring[None, :] - ring_a[:, None]
        other = (diff != 0) & (diff.abs() <= nearby)
        d_other = torch.where(other, d, BIG)
        c_other = d_other.argmin(1)
        out[0][s:s + CHUNK] = a
        out[3][s:s + CHUNK] = d[rows, a]
        if surf:
            same = (diff == 0) & (idx_all[None, :] != a[:, None])
            d_same = torch.where(same, d, BIG)
            b = d_same.argmin(1)
            out[1][s:s + CHUNK] = b
            out[4][s:s + CHUNK] = d_same[rows, b]
            out[2][s:s + CHUNK] = c_other
            out[5][s:s + CHUNK] = d_other[rows, c_other]
        else:
            out[1][s:s + CHUNK] = c_other
            out[4][s:s + CHUNK] = d_other[rows, c_other]
    return out


def simple_vote(nm: Numerics, src, tgt, p: dict):
    """(selected (n,), weight (n,)) of the n valid matches in order."""
    n = src.shape[0]
    regions = p["plane_vote_regions"]
    sel = torch.zeros(n, dtype=torch.bool, device=src.device)
    w = src.new_zeros(n)
    base = n // regions
    for c in range(regions):
        lo = base * c
        hi = n if c == regions - 1 else base * (c + 1)
        k = hi - lo
        if k <= 0:
            continue
        s, t = src[lo:hi], tgt[lo:hi]
        s1 = torch.sqrt(torch.clamp(nm.sqdist(s, s), min=0.0))
        s2 = torch.sqrt(torch.clamp(nm.sqdist(t, t), min=0.0))
        gap = (s1 - s2).abs()
        score = torch.exp(-(gap * gap) / p["vote_resolution"] ** 2)
        off = ~torch.eye(k, dtype=torch.bool, device=src.device)
        votes = ((score < p["vote_score_threshold"]) & off).sum(1)
        keep = votes.to(src.dtype) <= p["vote_selected_ratio"] * k
        sel[lo:hi] = keep
        w[lo:hi] = torch.where(votes <= p["vote_low_vote_count"],
                               p["vote_low_vote_weight"],
                               p["vote_high_vote_weight"]).to(src.dtype)
    return sel, w


def step(nm: Numerics, state: dict, feats: dict, p: dict) -> dict:
    """One sweep: the new odometry state (with its world pose)."""
    q, t = state["q_lc"].to(nm.dtype), state["t_lc"].to(nm.dtype)
    c_xyz, c_ring, c_mask = state["corner"]
    s_xyz, s_ring, s_mask = state["surf"]
    c_xyz, s_xyz = c_xyz.to(nm.dtype), s_xyz.to(nm.dtype)
    sharp = feats["sharp"][0]
    flat = feats["flat"][0]
    use_vote = state["frame"] > p["vote_start_frame"]
    gate, nearby = p["distance_sq_threshold"], p["nearby_scan"]
    for _ in range(p["outer_iterations"]):
        ca, cb, _, cd1, cd2, _ = _matches(
            nm, transform(nm, q, t, sharp), c_xyz, c_ring, c_mask, False,
            nearby)
        cv = (cd1 < gate) & (cd2 < gate)
        sa, sb, sc, sd1, sd2, sd3 = _matches(
            nm, transform(nm, q, t, flat), s_xyz, s_ring, s_mask, True,
            nearby)
        sv = (sd1 < gate) & (sd2 < gate) & (sd3 < gate)
        pj, pl, pm = s_xyz[sa[sv]], s_xyz[sb[sv]], s_xyz[sc[sv]]
        src = flat[sv]
        if use_vote:
            keep, w = simple_vote(nm, src, pj, p)
            src, pj, pl, pm, w = src[keep], pj[keep], pl[keep], pm[keep], w[keep]
        else:
            w = src.new_ones(src.shape[0])
        n = torch.cross(pj - pl, pj - pm, dim=-1)
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
        factors = [
            (sharp[cv], solve.edge_factor(c_xyz[ca[cv]], c_xyz[cb[cv]])),
            (src, solve.plane_factor(pj, n, w)),
        ]
        q, t = solve.lm(nm, q, t, factors, p["inner_iterations"],
                        p["huber_delta"])
    q_w0, t_w0 = state["q_w"].to(nm.dtype), state["t_w"].to(nm.dtype)
    t_w = t_w0 + nm.mm(rot(q_w0), t[:, None])[:, 0]
    q_w = quat_normalize(quat_mul(q_w0, q))
    return {"corner": feats["less_sharp"],
            "surf": feats["less_flat"],
            "q_w": q_w, "t_w": t_w, "q_lc": q, "t_lc": t,
            "frame": state["frame"] + 1}
