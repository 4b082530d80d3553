"""NumPy oracles implementing the reference semantics.

* scan-registration oracle: a direct, readable re-expression of
  src/scanRegistration.cpp:87-368 used as the ground truth for
  pick-for-pick validation of the vectorized TPU kernel.  Works on
  compacted clouds like the C++ (no padding), sequential greedy selection
  included.

* whole-frame odometry oracle: an independent float64 port of the full
  scan-to-scan step (src/laserOdometry.cpp:439-831) — correspondence
  search, graph vote, robust solve, pose integration — used to gate the
  *integrated* semantics of models.odometry.odometry_step (interaction of
  compaction order × vote chunk boundaries × re-association), not just the
  already-unit-tested kernels.  Jacobians come from finite differences so
  the oracle shares no code with solver/residuals.py.
"""

from __future__ import annotations

import numpy as np


def oracle_ring_ids(pts, n_scans, lower=-24.9, upper=2.0):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    angle = np.degrees(np.arctan(z / np.sqrt(x * x + y * y)))
    if n_scans == 16:
        ring = np.trunc((angle + 15.0) / 2.0 + 0.5).astype(int)
    elif n_scans == 32:
        ring = np.trunc((angle + 92.0 / 3.0) * 3.0 / 4.0).astype(int)
    else:
        factor = (n_scans - 1) / (upper - lower)
        ring = np.trunc((angle - lower) * factor + 0.5).astype(int)
    ok = (ring >= 0) & (ring < n_scans)
    return ring, ok


def oracle_rel_time(pts, ring_ok):
    n = len(pts)
    start_ori = -np.arctan2(pts[0, 1], pts[0, 0])
    end_ori = -np.arctan2(pts[-1, 1], pts[-1, 0]) + 2 * np.pi
    if end_ori - start_ori > 3 * np.pi:
        end_ori -= 2 * np.pi
    elif end_ori - start_ori < np.pi:
        end_ori += 2 * np.pi
    half_passed = False
    rel = np.zeros(n)
    for i in range(n):
        if not ring_ok[i]:
            continue
        ori = -np.arctan2(pts[i, 1], pts[i, 0])
        if not half_passed:
            if ori < start_ori - np.pi / 2:
                ori += 2 * np.pi
            elif ori > start_ori + np.pi * 3 / 2:
                ori -= 2 * np.pi
            if ori - start_ori > np.pi:
                half_passed = True
        else:
            ori += 2 * np.pi
            if ori < end_ori - np.pi * 3 / 2:
                ori += 2 * np.pi
            elif ori > end_ori + np.pi / 2:
                ori -= 2 * np.pi
        rel[i] = (ori - start_ori) / (end_ori - start_ori)
    return rel


def oracle_features(pts, n_scans, min_range=5.0, lower=-24.9, upper=2.0):
    """Full oracle. Returns a dict with the ring-ordered cloud, per-point
    ring/col, curvature, labels, and the four feature index lists (into the
    ring-ordered concatenated cloud) in reference push order."""
    # range filter (NaNs assumed pre-removed)
    r2 = np.sum(pts**2, axis=1)
    pts = pts[r2 >= min_range**2]

    ring, ok = oracle_ring_ids(pts, n_scans, lower, upper)
    rel = oracle_rel_time(pts, ok)

    # per-ring concatenation preserving arrival order
    scans = [[] for _ in range(n_scans)]
    scan_rel = [[] for _ in range(n_scans)]
    for i in range(len(pts)):
        if ok[i]:
            scans[ring[i]].append(pts[i])
            scan_rel[ring[i]].append(ring[i] + 0.1 * rel[i])
    cloud = []
    cloud_rel = []
    start_ind = np.zeros(n_scans, int)
    end_ind = np.zeros(n_scans, int)
    for r in range(n_scans):
        start_ind[r] = len(cloud) + 5
        cloud.extend(scans[r])
        cloud_rel.extend(scan_rel[r])
        end_ind[r] = len(cloud) - 6
    cloud = np.asarray(cloud, dtype=np.float32)
    cloud_rel = np.asarray(cloud_rel, dtype=np.float32)
    n = len(cloud)

    curv = np.zeros(n, dtype=np.float32)
    for i in range(5, n - 5):
        d = (
            np.sum(cloud[i - 5 : i + 6], axis=0, dtype=np.float32)
            - 11.0 * cloud[i]
        )
        curv[i] = float(np.dot(d, d))

    picked = np.zeros(n, bool)
    label = np.zeros(n, np.int8)
    sharp, less_sharp, flat, less_flat = [], [], [], []

    def suppress(ind, direction):
        for l in range(1, 6):
            j = ind + l * direction
            prev = j - direction
            d = cloud[j] - cloud[prev]
            if float(np.dot(d, d)) > 0.05:
                break
            picked[j] = True

    for r in range(n_scans):
        if end_ind[r] - start_ind[r] < 6:
            continue
        for j in range(6):
            sp = start_ind[r] + (end_ind[r] - start_ind[r]) * j // 6
            ep = start_ind[r] + (end_ind[r] - start_ind[r]) * (j + 1) // 6 - 1
            order = sorted(range(sp, ep + 1), key=lambda k: curv[k])

            largest = 0
            for ind in reversed(order):
                if not picked[ind] and curv[ind] > 0.1:
                    largest += 1
                    if largest <= 2:
                        label[ind] = 2
                        sharp.append(ind)
                        less_sharp.append(ind)
                    elif largest <= 20:
                        label[ind] = 1
                        less_sharp.append(ind)
                    else:
                        break
                    picked[ind] = True
                    suppress(ind, +1)
                    suppress(ind, -1)

            smallest = 0
            for ind in order:
                if not picked[ind] and curv[ind] < 0.1:
                    label[ind] = -1
                    flat.append(ind)
                    smallest += 1
                    if smallest >= 4:
                        break
                    picked[ind] = True
                    suppress(ind, +1)
                    suppress(ind, -1)

            for k in range(sp, ep + 1):
                if label[k] <= 0:
                    less_flat.append(k)

    return dict(
        cloud=cloud,
        rel=cloud_rel,
        start_ind=start_ind,
        end_ind=end_ind,
        curvature=curv,
        label=label,
        sharp=sharp,
        less_sharp=less_sharp,
        flat=flat,
        less_flat=less_flat,
    )


# ---------------------------------------------------------------------------
# Whole-frame odometry oracle (laserOdometry.cpp:439-831), float64 NumPy.
# ---------------------------------------------------------------------------

def _q_mul(a, b):
    """Hamilton product, xyzw layout."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _q_exp(v):
    """Exponential map: 3-vector tangent -> unit quaternion (xyzw)."""
    th = np.linalg.norm(v)
    if th < 1e-12:
        return np.array([v[0] / 2, v[1] / 2, v[2] / 2, 1.0]) / np.sqrt(
            1.0 + th * th / 4.0
        )
    u = v / th
    s = np.sin(th / 2.0)
    return np.array([u[0] * s, u[1] * s, u[2] * s, np.cos(th / 2.0)])


def _q_rot(q, p):
    """Rotate (N,3) points by quaternion q (xyzw)."""
    x, y, z, w = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return p @ R.T


def _oracle_corner_matches(q_sel, ref_xyz, ref_ring, dist_sq=25.0, nearby=2.5):
    """Vectorized ring-set corner search: 1-NN + nearest cross-ring point
    within NEARBY_SCAN (laserOdometry.cpp:491-554; the ring-set form is
    equivalent to the reference's array scans on a ring-sorted cloud —
    proven pointwise in test_matching.py)."""
    d = np.sum((q_sel[:, None, :] - ref_xyz[None, :, :]) ** 2, axis=-1)
    a = np.argmin(d, axis=1)
    d1 = d[np.arange(len(q_sel)), a]
    ring_a = ref_ring[a]
    diff = ref_ring[None, :] - ring_a[:, None]
    win = (diff != 0) & (np.abs(diff) <= nearby)
    dw = np.where(win, d, np.inf)
    b = np.argmin(dw, axis=1)
    d2 = dw[np.arange(len(q_sel)), b]
    valid = (d1 < dist_sq) & (d2 < dist_sq)
    return a, b, valid


def _oracle_surf_matches(q_sel, ref_xyz, ref_ring, dist_sq=25.0, nearby=2.5):
    """1-NN + same-ring 2nd + cross-ring 3rd (laserOdometry.cpp:653-737)."""
    d = np.sum((q_sel[:, None, :] - ref_xyz[None, :, :]) ** 2, axis=-1)
    a = np.argmin(d, axis=1)
    idx = np.arange(len(q_sel))
    d1 = d[idx, a]
    ring_a = ref_ring[a]
    diff = ref_ring[None, :] - ring_a[:, None]
    same = diff == 0
    same[idx, a] = False
    adj = (diff != 0) & (np.abs(diff) <= nearby)
    ds = np.where(same, d, np.inf)
    da = np.where(adj, d, np.inf)
    b = np.argmin(ds, axis=1)
    c = np.argmin(da, axis=1)
    valid = (d1 < dist_sq) & (ds[idx, b] < dist_sq) & (da[idx, c] < dist_sq)
    return a, b, c, valid


def _huber(s2, delta=0.1):
    d2 = delta * delta
    small = s2 <= d2
    sq = np.sqrt(np.maximum(s2, 1e-24))
    rho = np.where(small, s2, 2.0 * delta * sq - d2)
    drho = np.where(small, 1.0, delta / sq)
    return rho, drho


def _oracle_lm(q0, t0, resid_fn, n_iterations=4, delta=0.1,
               lambda_init=1e-4, fd_eps=1e-6):
    """LM with Huber IRLS on the right tangent, finite-difference
    Jacobians.  Mirrors the semantics of solver.gauss_newton.lm_solve
    (damped normal equations, accept/reject, lambda /3 x4) while sharing
    no code with it."""

    def blocks_at(q, t):
        return resid_fn(q, t)  # list of (N_i, D_i) arrays

    def cost_of(blocks):
        c = 0.0
        for r in blocks:
            if len(r) == 0:
                continue
            rho, _ = _huber(np.sum(r * r, axis=-1), delta)
            c += 0.5 * np.sum(rho)
        return c

    def perturb(q, t, k, h):
        v = np.zeros(6)
        v[k] = h
        return _q_mul(q, _q_exp(v[:3])), t + v[3:]

    q, t = q0.copy(), t0.copy()
    base = blocks_at(q, t)
    n_active = sum(len(r) for r in base)
    if n_active < 1:
        return q, t
    cost = cost_of(base)
    lam = lambda_init
    for _ in range(n_iterations):
        base = blocks_at(q, t)
        Js = [[] for _ in base]
        for k in range(6):
            qp, tp = perturb(q, t, k, fd_eps)
            pert = blocks_at(qp, tp)
            for bi, (r0, r1) in enumerate(zip(base, pert)):
                Js[bi].append((r1 - r0) / fd_eps)
        H = np.zeros((6, 6))
        g = np.zeros(6)
        for r0, Jcols in zip(base, Js):
            if len(r0) == 0:
                continue
            J = np.stack(Jcols, axis=-1)  # (N, D, 6)
            _, w = _huber(np.sum(r0 * r0, axis=-1), delta)
            Jw = J * w[:, None, None]
            H += np.einsum("nid,nie->de", Jw, J)
            g += np.einsum("nid,ni->d", Jw, r0)
        damped = H + lam * np.diag(np.diag(H)) + 1e-9 * np.eye(6)
        step = -np.linalg.solve(damped, g)
        q_new = _q_mul(q, _q_exp(step[:3]))
        q_new = q_new / np.linalg.norm(q_new)
        t_new = t + step[3:]
        new_cost = cost_of(blocks_at(q_new, t_new))
        if new_cost < cost:
            q, t, cost = q_new, t_new, new_cost
            lam /= 3.0
        else:
            lam *= 4.0
    return q, t


def literal_simple_vote(src, tgt, n_regions, threshold=0.96, resolution=1.0):
    """Returns (selected_index_list, weights) like the reference's
    selected_idx vector — walking votes ascending, break above 0.9k."""
    n = len(src)
    selected = {}
    for c in range(n_regions):
        lo = n // n_regions * c
        hi = n if c == n_regions - 1 else n // n_regions * (c + 1)
        k = hi - lo
        if k <= 0:
            continue
        votes = np.zeros(k)
        for i in range(k):
            for j in range(i + 1, k):
                s1 = np.linalg.norm(src[lo + i] - src[lo + j])
                s2 = np.linalg.norm(tgt[lo + i] - tgt[lo + j])
                gap = abs(s1 - s2)
                score = np.exp(-(gap * gap) / (resolution * resolution))
                if score < threshold:
                    votes[i] += 1
                    votes[j] += 1
        order = np.argsort(-votes, kind="stable")  # descending
        num_selected = 0.9 * k
        for i in range(k - 1, -1, -1):  # ascending votes
            idx = order[i]
            if votes[idx] > num_selected:
                break
            w = 5.0 if votes[idx] <= 50 else 1.0
            selected[lo + idx] = (w, votes[idx])
    return selected


def oracle_odometry_frame(
    corner_last_xyz, corner_last_ring,
    surf_last_xyz, surf_last_ring,
    sharp_xyz, flat_xyz,
    q_lc, t_lc, frame,
    outer_iterations=3, inner_iterations=4,
    vote_start_frame=5, plane_vote_regions=10,
):
    """One whole odometry frame (laserOdometry.cpp:439-831): per outer
    iteration re-associate correspondences with the current increment,
    vote-gate planes after vote_start_frame, run the robust solve; returns
    the refined (q_lc, t_lc) increment.  All clouds are compacted float64
    arrays in the padded-array order the kernels see (valid slots in array
    order), so vote chunk boundaries line up with the kernel's."""
    q = np.asarray(q_lc, np.float64).copy()
    t = np.asarray(t_lc, np.float64).copy()
    use_vote = frame > vote_start_frame

    for _ in range(outer_iterations):
        sharp_sel = _q_rot(q, sharp_xyz) + t
        flat_sel = _q_rot(q, flat_xyz) + t

        ca, cb, cv = _oracle_corner_matches(
            sharp_sel, corner_last_xyz, corner_last_ring
        )
        sa, sb, sc, sv = _oracle_surf_matches(
            flat_sel, surf_last_xyz, surf_last_ring
        )

        # edge factors: ALL valid corner matches, unweighted (ref:615-617)
        e_cp = sharp_xyz[cv]
        e_a = corner_last_xyz[ca[cv]]
        e_b = corner_last_xyz[cb[cv]]

        # plane factors: vote-gated after vote_start_frame (ref:781-810)
        p_cp = flat_xyz[sv]
        p_j = surf_last_xyz[sa[sv]]
        p_l = surf_last_xyz[sb[sv]]
        p_m = surf_last_xyz[sc[sv]]
        if use_vote:
            sel = literal_simple_vote(
                flat_xyz[sv], surf_last_xyz[sa[sv]], plane_vote_regions
            )
            keep = np.array([i in sel for i in range(sv.sum())], bool)
            w = np.array([sel[i][0] if i in sel else 0.0
                          for i in range(sv.sum())])
            p_cp, p_j, p_l, p_m = p_cp[keep], p_j[keep], p_l[keep], p_m[keep]
            p_w = w[keep]
        else:
            p_w = np.ones(len(p_cp))

        n = np.cross(p_j - p_l, p_j - p_m)
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

        def resid(qq, tt):
            pe = _q_rot(qq, e_cp) + tt
            de = e_a - e_b
            inv = 1.0 / np.maximum(
                np.linalg.norm(de, axis=-1, keepdims=True), 1e-12
            )
            r_edge = np.cross(pe - e_a, pe - e_b) * inv
            pp = _q_rot(qq, p_cp) + tt
            r_plane = (np.sum((pp - p_j) * n, axis=-1) * p_w)[:, None]
            return [r_edge, r_plane]

        q, t = _oracle_lm(q, t, resid, n_iterations=inner_iterations)

    return q, t


def literal_full_vote(src, tgt, n_regions=10, edge_threshold=0.95,
                      resolution=1.0, weight_balance=0.9,
                      bug_faithful=False):
    """Literal loop port of the reference's FULL graph-vote pipeline:
    graph_construction_partial (laserMapping.cpp:261-319) +
    graph_based_correspondence_vote_partial (laserMapping.cpp:321-834).

    Returns {index: score} for the selected correspondences (the
    selected_idx vector; selection_ratio is 1 and the score!=0 gate does
    the selecting, laserMapping.cpp:682-688).

    bug_faithful=True reproduces the reference's `pow(x, 1/3)` C++
    integer-division bug in the tight pass (every triangle weight 1.0,
    laserMapping.cpp:597); the default is the intended cube root, which
    the reference's own first-order pass uses (`1.0/3`, :457) and the
    kernel implements (PARITY deviation #3).
    """
    n = len(src)
    src = np.asarray(src, np.float64)
    tgt = np.asarray(tgt, np.float64)
    tight_exp = 0.0 if bug_faithful else (1.0 / 3.0)
    selected = {}
    for c in range(n_regions):
        lo = n // n_regions * c
        hi = n if c == n_regions - 1 else n // n_regions * (c + 1)
        k = hi - lo
        if k <= 0:
            continue
        # graph_construction_partial: symmetric f32 G, zero diagonal
        G = np.zeros((k, k), np.float32)
        for i in range(k):
            for j in range(i + 1, k):
                s1 = np.linalg.norm(src[lo + i] - src[lo + j])
                s2 = np.linalg.norm(tgt[lo + i] - tgt[lo + j])
                gap = abs(s1 - s2)
                G[i, j] = G[j, i] = np.float32(
                    np.exp(-(gap * gap) / (resolution * resolution))
                )
        if np.linalg.norm(G) == 0:  # "Graph is not connected!" -> skip
            continue
        # degree / neighbor sets (edge iff G > 0.95, :398-425)
        neighbors = [
            [j for j in range(k) if j != i and G[i, j] > edge_threshold]
            for i in range(k)
        ]
        degree = [len(nb) for nb in neighbors]
        # first-order reliability: mean triangle geometric mean (:435-489)
        fo = np.zeros(k)
        num_a = 0.0
        den_a = 0.0
        for i in range(k):
            if degree[i] > 1:
                num = 0.0
                for ai in range(degree[i]):
                    a = neighbors[i][ai]
                    for bi in range(ai + 1, degree[i]):
                        b = neighbors[i][bi]
                        if G[a, b] != 0:
                            num += float(G[i, a] * G[i, b] * G[a, b]) ** (
                                1.0 / 3.0
                            )
                den = degree[i] * (degree[i] - 1) * 0.5
                fo[i] = num / den
                num_a += num
                den_a += den
        # adaptive threshold = min(global ratio, mean score) (:490-492)
        param_a = num_a / den_a if den_a > 0 else float("nan")
        param_b = fo.sum() / k
        threshold = min(param_a, param_b) if den_a > 0 else float("nan")
        # prune neighbors by the NEIGHBOR's first-order score (:534-555)
        if threshold == threshold:  # NaN keeps nothing, like the C++ min
            pruned = [[j for j in nb if fo[j] >= threshold]
                      for nb in neighbors]
        else:
            pruned = [[] for _ in neighbors]
        deg2 = [len(p) for p in pruned]
        # final score = 0.1*loose + 0.9*tight, only when pruned degree > 2
        # (:561-624; the looser/tight vectors are only filled inside the
        # size>2 block, so smaller vertices score exactly 0)
        for i in range(k):
            loose_sum = 0.0
            tight_sum = 0.0
            if deg2[i] > 2:
                for ai in range(deg2[i]):
                    a = pruned[i][ai]
                    loose_sum += float(G[a, i])
                    for bi in range(ai + 1, deg2[i]):
                        b = pruned[i][bi]
                        if G[a, b] != 0:
                            tight_sum += float(
                                G[a, b] * G[a, i] * G[b, i]
                            ) ** tight_exp
                # C++ int division: deg*(deg-2)/2 truncates (:605)
                tight_sum /= (deg2[i] * (deg2[i] - 2)) // 2
                loose = loose_sum / deg2[i]
            else:
                loose = 0.0
            score = (1 - weight_balance) * loose + weight_balance * tight_sum
            if score != 0:
                selected[lo + i] = score
    return selected


def plane_lstsq(near, plane_gate):
    """One surf point's plane (ref:1948-2036): n from A n = -1 over its 5
    neighbours by least squares in double (the C++'s colPivHouseholderQr).
    (unit normal, 1 / |n|, every neighbour within ``plane_gate``)."""
    n, *_ = np.linalg.lstsq(near, -np.ones(len(near)), rcond=None)
    nrm = np.linalg.norm(n)
    neg_oa = 1.0 / nrm
    n_hat = n / nrm
    return n_hat, neg_oa, bool(np.all(np.abs(near @ n_hat + neg_oa)
                                      <= plane_gate))


def oracle_mapping_frame(map_corner_xyz, map_surf_xyz,
                         stack_corner_xyz, stack_surf_xyz,
                         q_w, t_w, outer_iterations=2, inner_iterations=4,
                         knn_gate_sq=1.0, eig_ratio=3.0, point_offset=0.1,
                         plane_gate=0.2):
    """One whole scan-to-map solve (laserMapping.cpp:1834-2101): per outer
    iteration, associate every stack point to the local map by brute-force
    5-NN (gate: 5th sq-dist < 1.0); corners fit a line via the 5-point
    covariance eigendecomposition (accept if lambda2 > 3*lambda1, virtual
    points center +/- 0.1*dir -> LidarEdgeFactor s=1, :1877-1940); surfs
    fit A.n = -1 by least squares (colPivHouseholderQr), reject if any
    neighbour is > 0.2 off-plane (-> LidarPlaneNormFactor, :1943-2055);
    then the Huber(0.1) robust solve (DENSE_QR max 4, :2080-2087) on the
    world pose.  float64 throughout.  Returns refined (q_w, t_w)."""
    q = np.asarray(q_w, np.float64).copy()
    t = np.asarray(t_w, np.float64).copy()
    map_c = np.asarray(map_corner_xyz, np.float64)
    map_s = np.asarray(map_surf_xyz, np.float64)
    st_c = np.asarray(stack_corner_xyz, np.float64)
    st_s = np.asarray(stack_surf_xyz, np.float64)

    def five_nn(p_sel, ref):
        d2 = np.sum((p_sel[:, None, :] - ref[None, :, :]) ** 2, axis=-1)
        idx = np.argsort(d2, axis=1)[:, :5]
        d5 = np.take_along_axis(d2, idx, axis=1)
        return idx, d5

    for _ in range(outer_iterations):
        # corner line factors
        c_sel = _q_rot(q, st_c) + t
        idx, d5 = five_nn(c_sel, map_c)
        e_cp, e_a, e_b = [], [], []
        for i in range(len(st_c)):
            if d5[i, 4] < knn_gate_sq:
                near = map_c[idx[i]]
                center = near.mean(axis=0)
                zm = near - center
                cov = zm.T @ zm  # the reference's unnormalized sum
                w, v = np.linalg.eigh(cov)  # ascending, like Eigen
                if w[2] > eig_ratio * w[1]:
                    d = v[:, 2]
                    e_cp.append(st_c[i])
                    e_a.append(center + point_offset * d)
                    e_b.append(center - point_offset * d)
        e_cp = np.asarray(e_cp).reshape(-1, 3)
        e_a = np.asarray(e_a).reshape(-1, 3)
        e_b = np.asarray(e_b).reshape(-1, 3)

        # surf plane-norm factors
        s_sel = _q_rot(q, st_s) + t
        idx, d5 = five_nn(s_sel, map_s)
        p_cp, p_n, p_d = [], [], []
        for i in range(len(st_s)):
            if d5[i, 4] < knn_gate_sq:
                n_hat, neg_oa, ok = plane_lstsq(map_s[idx[i]], plane_gate)
                if ok:
                    p_cp.append(st_s[i])
                    p_n.append(n_hat)
                    p_d.append(neg_oa)
        p_cp = np.asarray(p_cp).reshape(-1, 3)
        p_n = np.asarray(p_n).reshape(-1, 3)
        p_d = np.asarray(p_d).reshape(-1)

        def resid(qq, tt):
            pe = _q_rot(qq, e_cp) + tt
            de = e_a - e_b
            inv = 1.0 / np.maximum(
                np.linalg.norm(de, axis=-1, keepdims=True), 1e-12
            )
            r_edge = np.cross(pe - e_a, pe - e_b) * inv
            pp = _q_rot(qq, p_cp) + tt
            r_plane = (np.sum(pp * p_n, axis=-1) + p_d)[:, None]
            return [r_edge, r_plane]

        q, t = _oracle_lm(q, t, resid, n_iterations=inner_iterations)

    return q, t
