"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``light_loam_tpu_torch/csrc`` and runs,
in order (each phase prints one line of numbers; any failure is an uncaught
exception and a non-zero exit):

  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc both kernels (seconds, ptxas resource lines);
  3. knn5 vs its plain PyTorch version at the mapping stage's shapes; at
     the live counts the stage hands over, timed per call and per launch
     on the device, beside the least time the card could take (its bound);
  4. compat_votes vs its plain PyTorch version at the odometry plane,
     mapping and odometry corner vote shapes (R, K = 10, 163; 10, 829;
     5, 158), timed per call and per launch on the device, beside its
     bound;
  5. the flagship pipeline (HDL64_KITTI, full widths) over 12 synthetic
     frames on the card: kernel launch counts, finite poses, every mapped
     position within 5 cm of the JAX package's, per-stage device ms and
     frames/s;
  6. the same with the mapping-stage vote on (``vote_mode="simple"``,
     ``vote_start_frame=2``) over 10 frames: compat_votes also runs at
     K = 829, twice per mapped frame; the same checks against the JAX
     package's positions on that run;
  7. the latent Light-LOAM vote path over 10 frames: the full graph vote
     for odometry planes (R = 10, K = 163) and in mapping (K = 829), the
     simple corner vote (compat_votes at R = 5, K = 158) with scalar edge
     factors, and the tiled surf search with its live-prefix hand-off; the
     same checks, plus per-call times of the grid and the tiled surf
     search on one flagship frame (ring-slotted and compacted) and of the
     full graph vote at both shapes;
  8. the distortion hook and the occlusion filter over 8 frames, the same
     checks.

The last three lines are a JSON object with each kernel's numbers, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the ``light_loam_tpu_torch`` package
beside it, the script fails before printing any result.  It imports
nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from light_loam_tpu_torch.core.frame import PointCloud
from light_loam_tpu_torch.models.pipeline import (
    PROFILES,
    Pipeline,
    synthetic_frames,
)
from light_loam_tpu_torch.ops.cuda_knn import KNN5, knn5, knn5_plain
from light_loam_tpu_torch.ops.cuda_vote import (
    VOTE,
    compat_votes,
    compat_votes_plain,
)
from light_loam_tpu_torch.ops.features import extract_features
from light_loam_tpu_torch.ops.graphvote import full_graph_vote
from light_loam_tpu_torch.ops.knn import (
    surf_correspondences,
    surf_correspondences_grid,
)
from light_loam_tpu_torch.ops.voxel import compact_rows

# Mapped positions (m) of the JAX package's pipeline on the same run, on the
# CPU, produced by:
#   JAX_PLATFORMS=cpu python -c "from light_loam_tpu.models import pipeline
#   as pl; p, _, _ = pl.run_synthetic(n_frames=12, profile='hdl64',
#   n_azimuth=1800, speed=1.0, seed=0); print(p.mapped_positions().tolist())"
JAX_MAPPED_POSITIONS = np.array([
    [0.0, 0.0, 0.0],
    [0.9995206594467163, 0.02170042134821415, 0.0015200147172436118],
    [2.0035605430603027, 0.04235256090760231, 0.0016427640803158283],
    [3.0101819038391113, 0.06909383833408356, 0.002326934365555644],
    [4.0127787590026855, 0.08869749307632446, 0.0014958373503759503],
    [5.000086307525635, 0.11253754049539566, 0.004188378807157278],
    [6.010984420776367, 0.12855570018291473, 0.003005174919962883],
    [7.020444393157959, 0.14599084854125977, 0.003281424753367901],
    [8.007376670837402, 0.16189643740653992, 0.0028328304179012775],
    [9.001811981201172, 0.18881472945213318, 0.0037164499517530203],
    [9.996688842773438, 0.20663359761238098, 0.0037937730085104704],
    [11.004767417907715, 0.23331907391548157, 0.0038526335265487432],
])
N_FRAMES = 12
# Phase 6: the JAX package's mapped positions (m) with the mapping vote on,
# on the CPU, produced by:
#   JAX_PLATFORMS=cpu python -c "import dataclasses as d; from
#   light_loam_tpu.models import pipeline as pl; c = pl.PROFILES['hdl64'];
#   pl.PROFILES['hdl64'] = d.replace(c, mapping=d.replace(c.mapping,
#   vote_mode='simple', vote_start_frame=2)); p, _, _ = pl.run_synthetic(
#   n_frames=10, profile='hdl64', n_azimuth=1800, speed=1.0, seed=0);
#   print(p.mapped_positions().tolist())"
JAX_VOTE_MAPPED_POSITIONS = np.array([
    [0.0, 0.0, 0.0],
    [0.9995206594467163, 0.02170042134821415, 0.0015200147172436118],
    [2.0035605430603027, 0.04235256090760231, 0.0016427640803158283],
    [3.0106072425842285, 0.06923092901706696, 0.002433948451653123],
    [4.015247821807861, 0.09037447720766068, 0.0016639987006783485],
    [5.00358772277832, 0.11249828338623047, 0.0023228591307997704],
    [6.01154899597168, 0.12681980431079865, 0.0015704475808888674],
    [7.019372940063477, 0.1454065442085266, 0.002226310782134533],
    [8.00472354888916, 0.16253094375133514, 0.0024295002222061157],
    [9.003265380859375, 0.18747785687446594, 0.004220140632241964],
])
VOTE_N_FRAMES = 10
# Phase 7: the JAX package's mapped positions (m) with the latent vote path
# on (latent_vote_config), on the CPU, produced by:
#   JAX_PLATFORMS=cpu python -c "import dataclasses as d; from
#   light_loam_tpu.models import pipeline as pl; c = pl.PROFILES['hdl64'];
#   pl.PROFILES['hdl64'] = d.replace(c, odometry=d.replace(c.odometry,
#   plane_vote_mode='full', corner_vote_mode='simple', surf_knn='tiled',
#   vote_start_frame=2), mapping=d.replace(c.mapping, vote_mode='full',
#   vote_start_frame=2)); p, _, _ = pl.run_synthetic(n_frames=10,
#   profile='hdl64', n_azimuth=1800, speed=1.0, seed=0);
#   print(p.mapped_positions().tolist())"
JAX_LATENT_MAPPED_POSITIONS = np.array([
    [0.0, 0.0, 0.0],
    [0.9995206594467163, 0.02170042134821415, 0.0015200147172436118],
    [2.0035605430603027, 0.04235256090760231, 0.0016427640803158283],
    [3.0104029178619385, 0.06938423961400986, 0.00238327425904572],
    [4.012481689453125, 0.08986736834049225, 0.0009586483938619494],
    [5.002170562744141, 0.11172167211771011, 0.0028385058976709843],
    [6.014122486114502, 0.12751440703868866, 0.002082008868455887],
    [7.021209716796875, 0.14669066667556763, 0.0023592133074998856],
    [8.006645202636719, 0.1630980223417282, 0.003164654830470681],
    [8.999643325805664, 0.1894472986459732, 0.005093296989798546],
])
LATENT_N_FRAMES = 10
# Phase 8: the same with the distortion hook and the occlusion filter on
# (undistort_config), produced by:
#   JAX_PLATFORMS=cpu python -c "import dataclasses as d; from
#   light_loam_tpu.models import pipeline as pl; c = pl.PROFILES['hdl64'];
#   pl.PROFILES['hdl64'] = d.replace(c, odometry=d.replace(c.odometry,
#   distortion=True), scan=d.replace(c.scan, occlusion_filter=True));
#   p, _, _ = pl.run_synthetic(n_frames=8, profile='hdl64', n_azimuth=1800,
#   speed=1.0, seed=0); print(p.mapped_positions().tolist())"
# (the synthetic sweeps are taken at one instant, so the hook, which
# assumes motion within the sweep, moves the trajectory off the truth; the
# port must follow the JAX package there too)
JAX_UNDISTORT_MAPPED_POSITIONS = np.array([
    [0.0, 0.0, 0.0],
    [1.7618637084960938, 0.005014745984226465, -0.0023605653550475836],
    [2.292757749557495, 0.07567618787288666, 0.004451286979019642],
    [3.553385019302368, 0.03607513755559921, -0.01872362568974495],
    [4.325351715087891, 0.12659083306789398, 0.0261186882853508],
    [5.5532050132751465, 0.0858931913971901, -0.03158432990312576],
    [6.353050708770752, 0.15372329950332642, 0.05912912264466286],
    [7.524198055267334, 0.14557182788848877, -0.10106147080659866],
])
UNDISTORT_N_FRAMES = 8
POSITION_TOL_M = 0.05
# knn5 distances: the Gram form |q|^2 + |r|^2 - 2 q.r rounds at the scale of
# |q|^2 + |r|^2 (~2e4 m^2 at 100 m, where a float32 ulp is ~1e-3 m^2), not of
# d, and the kernel (FMA contraction) and the plain version (cuBLAS) round it
# differently.  So each distance must lie within rtol*d + atol +
# KNN_ULPS * eps32 * (|q|^2 + |r|^2) of the exact float64 distance.
KNN_RTOL, KNN_ATOL, KNN_ULPS = 1e-5, 1e-4, 4.0
# votes: a borderline score-vs-threshold pair may flip between roundings
VOTE_MAX_DIFF, VOTE_MAX_FRAC = 1.0, 0.01
# Bounds: published peaks of one H100 SXM (NVIDIA's data sheet, 700 W):
# float32 outside the tensor cores, and HBM.  The special-function units
# (MUFU: reciprocal square root, exp2) return 16 results per clock per SM
# against 256 FP32 FLOP (CUDA C++ Programming Guide, throughput table for
# compute capability 9.0), so 67 / 16 T results/s.  FLOP per pair: knn5's
# 3-term dot (5: a multiply and two FMAs), |q|^2 + |r|^2 (1) and -2 q.r (an
# FMA, 2), so 8.  The vote's (vote.cu's pair loop): two such Gram distances
# (2 x 8), the gap (1) and the scaled square -(gap^2) / res^2 (2), so 19,
# plus two square roots, each one MUFU operation (an IEEE sqrtf adds
# refinement FMAs, not counted: the bound stays a least time).  The few
# expf of the pairs inside the exp band are not counted either.
H100_FP32_FLOPS, H100_BYTES_PER_S = 67e12, 3.35e12
H100_MUFU_PER_S = H100_FP32_FLOPS / 16
KNN_FLOP_PER_PAIR, VOTE_FLOP_PER_PAIR, VOTE_SQRT_PER_PAIR = 8, 19, 2


def _median_ms(fn, reps: int) -> float:
    """Median device ms of ``fn`` over ``reps`` timed runs after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``: ``reps`` calls enqueued behind a spin
    kernel, so that they run back to back and the host's own time per call
    (Python, ctypes, allocation) is not in the figure.  The spin is doubled
    until it outlasts the enqueueing.  ``reps`` times the launches per call
    must stay well below the few hundred launches the card queues, or the
    host blocks behind the spin (the plain votes launch about a dozen)."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        covered = not start.query()
        end.record()
        end.synchronize()
        if covered:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise RuntimeError("device timing: the host never got ahead of the card")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] nvidia-smi: {smi} | torch {torch.__version__} | "
          f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")
    return smi


def phase_build(kernels) -> None:
    # one nvcc per source, all at once
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.build(), kernels))
    parts = []
    for k in kernels:
        secs = "cached" if k.build_seconds is None else f"{k.build_seconds:.2f}s"
        parts.append(f"{k.source.name} {secs}")
    print(f"[2 build] {' | '.join(parts)}")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {k.source.name}: {line.strip()}")


def _scan_points(dev):
    frames = list(synthetic_frames(2, PROFILES["hdl64"], seed=0))
    a = frames[0][1][frames[0][2]]
    b = frames[1][1][frames[1][2]]
    rng = np.random.default_rng(0)
    return (torch.as_tensor(a[rng.permutation(len(a))]).to(dev),
            torch.as_tensor(b[rng.permutation(len(b))]).to(dev))


def _exact_sq_dist(query, ref, idx):
    """(float64 squared distances of the picked neighbours, the Gram
    rounding scale |q|^2 + |r|^2) per (row, slot)."""
    q = query.double()[:, None, :]
    r = ref.double()[idx.long()]
    return ((r - q) ** 2).sum(-1), (q ** 2).sum(-1) + (r ** 2).sum(-1)


def _check_knn(query, ref, d_k, i_k, d_p, i_p) -> tuple:
    """Kernel vs plain on the same inputs: the same empty slots (index 0),
    each distance within the Gram-form tolerance of the exact distance of
    its own pick, and picks equal up to ties (where they differ, the exact
    distances agree within that tolerance).  Returns (max |d_kernel -
    d_plain|, number of tie swaps)."""
    live = d_p < 1e30
    if not torch.equal(live, d_k < 1e30):
        raise AssertionError("knn5: kernel and plain disagree on empty slots")
    if not torch.equal(i_k[~live], torch.zeros_like(i_k[~live])):
        raise AssertionError("knn5: empty slots must carry index 0")
    exact_k, scale = _exact_sq_dist(query, ref, i_k)
    exact_p, _ = _exact_sq_dist(query, ref, i_p)
    tol = (KNN_RTOL * exact_k + KNN_ATOL
           + KNN_ULPS * torch.finfo(torch.float32).eps * scale)
    for name, d, exact in (("kernel", d_k, exact_k), ("plain", d_p, exact_p)):
        bad = live & ((d.double() - exact).abs() > tol)
        if bad.any():
            raise AssertionError(
                f"knn5 {name}: {int(bad.sum())} distances off the exact ones "
                f"by up to {(d.double() - exact)[bad].abs().max().item():.3g}")
    swaps = live & (i_k != i_p)
    if ((exact_k - exact_p).abs() > tol)[swaps].any():
        raise AssertionError("knn5: kernel and plain picked different "
                             "neighbours that are not ties")
    err = (d_k[live] - d_p[live]).abs().max().item() if live.any() else 0.0
    return err, int(swaps.sum())


def knn_cases(dev):
    """Phase 3's knn5 inputs at the mapping stage's capacities: yields
    (name, case, query, ref, mask, counts, qc, rc)."""
    pts_a, pts_b = _scan_points(dev)
    for Q, N, name in ((2048, 32768, "corner"), (8192, 65536, "surf")):
        query = pts_b[:Q].contiguous()
        ref = pts_a[:N].contiguous()
        gen = torch.Generator(device="cpu").manual_seed(Q)
        holes = (torch.rand(N, generator=gen) < 0.1).to(dev)
        cases = {
            # live prefixes below capacity, as the mapping stage hands over
            "below": ((Q * 5) // 8, (N * 3) // 8, ~holes),
            "full": (Q, N, ~holes),
            "masked": (Q, N, torch.zeros(N, dtype=torch.bool, device=dev)),
        }
        for case, (qc, rc, mask) in cases.items():
            mask = mask & (torch.arange(N, device=dev) < rc)
            counts = torch.tensor([qc, rc], dtype=torch.int32, device=dev)
            yield name, case, query, ref, mask, counts, qc, rc


def _bound(flop: float, nbytes: float, mufu: float = 0.0) -> tuple:
    """(least ms the card could take, "operations" or "bytes"): the FP32
    FLOP and the MUFU operations run on separate units, so the operations
    take the longer of the two."""
    t_op = max(flop / H100_FP32_FLOPS, mufu / H100_MUFU_PER_S) * 1e3
    t_mem = nbytes / H100_BYTES_PER_S * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def knn_bound(Q: int, qc: int, rc: int) -> tuple:
    """knn5 visits qc x rc pairs; it reads the live queries (12 B), the
    live references and their mask (13 B) and the counts, and writes every
    output row (5 x (4 + 4) B)."""
    return _bound(KNN_FLOP_PER_PAIR * qc * rc, 12 * qc + 13 * rc + 8 + 40 * Q)


def vote_bound(R: int, K: int) -> tuple:
    """compat_votes evaluates R x K x K pairs; it reads src, tgt and valid
    (7 floats a point) and writes one float a point."""
    pairs = R * K * K
    return _bound(VOTE_FLOP_PER_PAIR * pairs, 32 * R * K,
                  VOTE_SQRT_PER_PAIR * pairs)


def phase_knn(dev) -> dict:
    out = {}
    for name, case, query, ref, mask, counts, qc, rc in knn_cases(dev):
        Q, N = query.shape[0], ref.shape[0]
        d_k, i_k = knn5(query, ref, mask, counts)
        torch.cuda.synchronize()
        d_p, i_p = knn5_plain(query, ref, mask, counts)
        torch.cuda.synchronize()
        err, mism = _check_knn(query, ref, d_k, i_k, d_p, i_p)
        v = out[(name, case)] = dict(err=err, mismatches=mism, Q=Q, N=N,
                                     qc=qc, rc=rc)
        if case == "below":
            kernel = functools.partial(knn5, query, ref, mask, counts)
            v["ms"] = _median_ms(kernel, 20)
            # the plain version launches hundreds of kernels a call: per
            # call only, never behind the spin
            v["plain_ms"] = _median_ms(
                functools.partial(knn5_plain, query, ref, mask, counts), 5)
            v["device_ms"] = _device_ms(kernel, 50)
            v["bound_ms"], v["bound_by"] = knn_bound(Q, qc, rc)
    print("[3 knn5] " + " | ".join(
        f"{n}/{c} Q={v['Q']} N={v['N']} counts=({v['qc']},{v['rc']}) "
        f"max_abs_err={v['err']:.3g} tie_swaps={v['mismatches']}"
        + (f" kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f} ms per "
           f"call, kernel {v['device_ms']:.4f} ms per launch on the device, "
           f"bound {v['bound_ms']:.4f} ms ({v['bound_by']}), "
           f"{v['bound_ms'] / v['device_ms']:.1%} of the bound"
           if "ms" in v else "")
        for (n, c), v in out.items()))
    return out


# compat_votes shapes: odometry plane vote (1536 // 10 + 10), mapping vote
# (8192 // 10 + 10), odometry corner vote (768 // 5 + 5)
VOTE_SHAPES = ((10, 163), (10, 829), (5, 158))


def phase_vote(dev) -> dict:
    out = {}
    for R, K in VOTE_SHAPES:
        rng = np.random.default_rng(K)
        src = rng.uniform(-20, 20, (R, K, 3)).astype(np.float32)
        bad = rng.random((R, K)) < 0.25
        tgt = src + 0.3 + np.where(bad[..., None],
                                   rng.uniform(2, 8, (R, K, 3)), 0.0)
        valid = (rng.random((R, K)) < 0.9).astype(np.float32)
        src_t = torch.as_tensor(src * valid[..., None]).to(dev)
        tgt_t = torch.as_tensor((tgt * valid[..., None]).astype(np.float32)).to(dev)
        val_t = torch.as_tensor(valid).to(dev)
        v_k = compat_votes(src_t, tgt_t, val_t)
        torch.cuda.synchronize()
        v_p = compat_votes_plain(src_t, tgt_t, val_t)
        torch.cuda.synchronize()
        diff = (v_k - v_p).abs()
        frac = (diff > 0).float().mean().item()
        if diff.max().item() > VOTE_MAX_DIFF or frac >= VOTE_MAX_FRAC:
            raise AssertionError(
                f"compat_votes R={R} K={K}: max diff {diff.max().item()}, "
                f"differing fraction {frac}")
        kernel = functools.partial(compat_votes, src_t, tgt_t, val_t)
        plain = functools.partial(compat_votes_plain, src_t, tgt_t, val_t)
        v = out[(R, K)] = dict(
            err=diff.max().item(), frac=frac,
            ms=_median_ms(kernel, 50), plain_ms=_median_ms(plain, 20),
            device_ms=_device_ms(kernel, 100),
            plain_device_ms=_device_ms(plain, 20),
        )
        v["bound_ms"], v["bound_by"] = vote_bound(R, K)
    print("[4 vote] " + " | ".join(
        f"R={R} K={K} max_abs_err={v['err']:.3g} differing={v['frac']:.4f} "
        f"kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f} ms per call, "
        f"kernel {v['device_ms']:.4f} ms plain {v['plain_device_ms']:.4f} ms "
        f"per launch on the device, bound {v['bound_ms']:.4f} ms "
        f"({v['bound_by']}), {v['bound_ms'] / v['device_ms']:.1%} of the bound"
        for (R, K), v in out.items()))
    return out


def mapping_vote_config():
    """The flagship profile with the mapping-stage vote on from the third
    mapped frame (the profile itself keeps it off, as the reference does)."""
    base = PROFILES["hdl64"]
    return dataclasses.replace(base, mapping=dataclasses.replace(
        base.mapping, vote_mode="simple", vote_start_frame=2))


def latent_vote_config(base=None):
    """``base`` (the flagship profile by default) with the latent
    Light-LOAM vote path on, gated on after frame 2: the full graph vote
    for odometry planes and in mapping, the simple corner vote with scalar
    edge factors, and the tiled surf search with its live-prefix
    hand-off."""
    base = base or PROFILES["hdl64"]
    return dataclasses.replace(
        base,
        odometry=dataclasses.replace(
            base.odometry, plane_vote_mode="full", corner_vote_mode="simple",
            surf_knn="tiled", vote_start_frame=2),
        mapping=dataclasses.replace(base.mapping, vote_mode="full",
                                    vote_start_frame=2))


def undistort_config():
    """The flagship profile with the distortion hook and the occlusion
    filter on."""
    base = PROFILES["hdl64"]
    return dataclasses.replace(
        base, odometry=dataclasses.replace(base.odometry, distortion=True),
        scan=dataclasses.replace(base.scan, occlusion_filter=True))


def expected_launches(cfg, n_frames: int, n_mapped: int) -> dict:
    """Launches a run makes, from its config.  compat_votes: one per
    odometry outer iteration for each of the plane and corner votes in
    "simple" mode, and one per mapping outer iteration in mapping "simple"
    mode (all run before their gates open too; "full" launches none).
    knn5: a corner and a surf 5-NN per mapping outer iteration."""
    o, m = cfg.odometry, cfg.mapping
    simple = (o.plane_vote_mode == "simple") + (o.corner_vote_mode == "simple")
    votes = (simple * o.outer_iterations * n_frames
             + (m.vote_mode == "simple") * m.outer_iterations * n_mapped)
    return {"knn.cu": 2 * m.outer_iterations * n_mapped, "vote.cu": votes}


def phase_pipeline(tag, cfg, n_frames, jax_positions, kernels) -> dict:
    """Drive ``n_frames`` flagship frames under ``cfg`` and hold them to
    ``jax_positions``; returns the launch counts of this run and the mean
    stream ms per stage."""
    frames = list(synthetic_frames(n_frames, cfg, n_azimuth=1800, speed=1.0,
                                   seed=0))
    pipe = Pipeline(cfg, device="cuda")
    for k in kernels:
        k.launches = 0
    results = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (_, xyz, mask) in enumerate(frames):
        results.append(pipe.process_frame(xyz, mask))
        if i == 0:
            # steady state: later frames only (the first warms allocator
            # and kernel caches)
            torch.cuda.synchronize()
            pipe.timers.reset()
            t1 = time.perf_counter()
    positions = pipe.mapped_positions()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k.source.name: k.launches for k in kernels}

    n_mapped = sum(r.mapped for r in results)
    want = expected_launches(cfg, n_frames, n_mapped)
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}, derived from "
                             f"the config for {n_frames} frames, {n_mapped} "
                             "mapped")
    for r in results:
        if not (np.isfinite(r.odom_q).all() and np.isfinite(r.odom_t).all()):
            raise AssertionError(f"frame {r.frame}: non-finite odometry pose")
    if positions.shape != jax_positions.shape or not np.isfinite(
            positions).all():
        raise AssertionError(f"mapped positions {positions.shape} not "
                             f"finite {jax_positions.shape}")
    dev_m = np.linalg.norm(positions - jax_positions, axis=1)
    if (dev_m > POSITION_TOL_M).any():
        raise AssertionError(
            f"mapped positions deviate from the JAX package's by up to "
            f"{dev_m.max():.4f} m (> {POSITION_TOL_M} m): {dev_m.tolist()}")
    stages = {n: s.mean_ms for n, s in pipe.timers.device_report().items()}
    fps = (n_frames - 1) / (t_end - t1)
    o = cfg.odometry
    print(f"[{tag}] hdl64 {n_frames} frames, {n_mapped} mapped, votes "
          f"plane {o.plane_vote_mode} corner {o.corner_vote_mode} mapping "
          f"{cfg.mapping.vote_mode}, surf search {o.surf_knn}, distortion "
          f"{o.distortion}, occlusion filter {cfg.scan.occlusion_filter} | "
          f"launches {launches} | max "
          f"|mapped - jax| {dev_m.max():.4f} m | "
          + " ".join(f"{n} {ms:.2f}ms" for n, ms in sorted(stages.items()))
          + f" (stream, mean of frames 2-{n_frames}) | {fps:.2f} frames/s "
          f"(host wall, frames 2-{n_frames}; first frame "
          f"{(t1 - t0) * 1e3:.0f} ms)")
    return dict(launches=launches, stages=stages)


FULL_VOTE_SHAPES = ((10, 163), (10, 829))


def full_vote_floor(R: int, K: int) -> float:
    """Least ms of full_graph_vote on the card: its two batched (R, K, K)
    triangle products, 2 R K³ FLOP each, at the FP32 peak (the rest of the
    vote is elementwise work on (R, K, K) buffers, not counted)."""
    return 2 * 2 * R * K ** 3 / H100_FP32_FLOPS * 1e3


def _matched_points_differ(g, ref, t, compact) -> int:
    """Queries where the grid search on ``ref`` and the tiled search on
    ``compact`` disagree on validity or on a matched point."""
    differ = g.valid != t.valid
    for gi, ti in ((g.a_idx, t.a_idx), (g.b_idx, t.b_idx), (g.c_idx, t.c_idx)):
        differ |= g.valid & (ref.xyz[gi] != compact.xyz[ti]).any(-1)
    return int(differ.sum())


def phase_latent_calls(dev) -> dict:
    """Per-call ms of phase 7's surf searches on one flagship frame (the
    flat cloud of frame 1 against the less-flat cloud of frame 0: the grid
    search and the tiled one on the ring-slotted cloud, the tiled one with
    the live count on its compacted copy) and of full_graph_vote at the
    odometry plane and mapping shapes."""
    cfg = latent_vote_config()
    o = cfg.odometry
    feats = [extract_features(torch.as_tensor(xyz).to(dev),
                              torch.as_tensor(mask).to(dev), cfg.scan)
             for _, xyz, mask in synthetic_frames(2, cfg, seed=0)]
    ref, n_rings = feats[0].less_flat, feats[0].full.xyz.shape[0]
    km, kx, kr = compact_rows(ref.mask, ref.capacity, ref.xyz, ref.rel)
    compact = PointCloud(kx, kr, km)
    n_live = int(km.sum())
    q, qm = feats[1].flat.xyz, feats[1].flat.mask
    gate = (o.distance_sq_threshold, o.nearby_scan)
    calls = {
        "grid": functools.partial(surf_correspondences_grid, q, qm, ref,
                                  n_rings, *gate),
        "tiled": functools.partial(surf_correspondences, q, qm, ref, *gate),
        "tiled_compacted": functools.partial(
            surf_correspondences, q, qm, compact, *gate, ref_count=n_live),
    }
    differ = _matched_points_differ(calls["grid"](), ref,
                                    calls["tiled_compacted"](), compact)
    n_valid = int(calls["grid"]().valid.sum())
    if differ > 0.001 * q.shape[0] or n_valid < 0.5 * int(qm.sum()):
        raise AssertionError(f"surf searches: grid and tiled differ at {differ}"
                             f" queries ({n_valid} valid)")
    out = dict(Q=q.shape[0], capacity=ref.capacity, n_live=n_live,
               live_tiles=-(-n_live // 8192), tiles=-(-ref.capacity // 8192),
               differ=differ, surf={n: _median_ms(f, 20)
                                    for n, f in calls.items()})
    out["vote"] = {}
    for R, K in FULL_VOTE_SHAPES:
        rng = np.random.default_rng(K)
        n = (K - R) * R
        src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
        tgt = src + np.array([0.6, 0.1, -0.05], np.float32) + rng.normal(
            0, 0.05, (n, 3)).astype(np.float32)
        bad = rng.random(n) < 1 / 6
        tgt[bad] += rng.uniform(2, 6, (bad.sum(), 3)).astype(np.float32)
        args = [torch.as_tensor(a).to(dev) for a in
                (src, tgt.astype(np.float32), rng.random(n) < 0.92)]
        fn = functools.partial(full_graph_vote, *args, n_regions=R,
                               chunk_capacity=K)
        sel = fn().selected
        if not 0.5 * int(args[2].sum()) < int(sel.sum()) < int(args[2].sum()):
            raise AssertionError(f"full_graph_vote R={R} K={K}: {int(sel.sum())}"
                                 " selected")
        out["vote"][(R, K)] = dict(ms=_median_ms(fn, 10),
                                   device_ms=_device_ms(fn, 2),
                                   floor_ms=full_vote_floor(R, K))
    print("[7 latent vote] surf search per call (host included), flat Q="
          f"{out['Q']} vs less-flat capacity {out['capacity']}, {n_live} live"
          f": grid {out['surf']['grid']:.3f} ms | tiled {out['surf']['tiled']:.3f}"
          f" ms ({out['tiles']} tiles) | tiled compacted "
          f"{out['surf']['tiled_compacted']:.3f} ms ({out['live_tiles']} live "
          f"tiles, count read once) | grid vs tiled differ at {differ} queries"
          " | " + " | ".join(
              f"full_graph_vote R={R} K={K} {v['ms']:.3f} ms per call, "
              f"{v['device_ms']:.3f} ms on the device, FP32 floor "
              f"{v['floor_ms']:.4f} ms" for (R, K), v in out["vote"].items()))
    return out


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    kernels = (KNN5, VOTE)
    phase_build(kernels)
    knn = phase_knn(dev)
    vote = phase_vote(dev)
    p5 = phase_pipeline("5 pipeline", PROFILES["hdl64"], N_FRAMES,
                        JAX_MAPPED_POSITIONS, kernels)
    p6 = phase_pipeline("6 mapping vote", mapping_vote_config(),
                        VOTE_N_FRAMES, JAX_VOTE_MAPPED_POSITIONS, kernels)
    print(f"[6 mapping vote] mapping stage {p6['stages']['mapping']:.2f} ms "
          f"per frame with the vote, {p5['stages']['mapping']:.2f} ms without "
          "(phase 5)")
    p7 = phase_pipeline("7 latent vote", latent_vote_config(),
                        LATENT_N_FRAMES, JAX_LATENT_MAPPED_POSITIONS, kernels)
    print("[7 latent vote] stream ms per frame against phase 5: " + " ".join(
        f"{n} {p7['stages'][n]:.2f} ({p5['stages'][n]:.2f})"
        for n in sorted(p7["stages"])))
    phase_latent_calls(dev)
    p8 = phase_pipeline("8 undistort + occlusion", undistort_config(),
                        UNDISTORT_N_FRAMES, JAX_UNDISTORT_MAPPED_POSITIONS,
                        kernels)
    launches = {name: sum(p["launches"][name] for p in (p5, p6, p7, p8))
                for name in p5["launches"]}

    surf = knn[("surf", "below")]
    odo = vote[VOTE_SHAPES[0]]
    knn_err = max(v["err"] for v in knn.values())
    print(json.dumps({"kernels": [
        {"name": "knn5", "route": "cuda",
         "source": "light_loam_tpu_torch/csrc/knn.cu",
         "replaces": "light_loam_tpu/ops/pallas_knn.py:69",
         "launches": launches["knn.cu"], "max_abs_err": knn_err,
         "ms": surf["ms"], "plain_ms": surf["plain_ms"],
         "device_ms": surf["device_ms"], "bound_ms": surf["bound_ms"],
         "bound_by": surf["bound_by"], "library_ms": None,
         "shapes": [
             {k: v[k] for k in ("Q", "N", "qc", "rc", "ms", "plain_ms",
                                "device_ms", "bound_ms", "bound_by")}
             | {"max_abs_err": v["err"]}
             for (_, case), v in knn.items() if case == "below"]},
        {"name": "compat_votes", "route": "cuda",
         "source": "light_loam_tpu_torch/csrc/vote.cu",
         "replaces": "light_loam_tpu/ops/pallas_vote.py:33",
         "launches": launches["vote.cu"],
         "max_abs_err": max(v["err"] for v in vote.values()),
         "ms": odo["ms"], "plain_ms": odo["plain_ms"],
         "device_ms": odo["device_ms"], "bound_ms": odo["bound_ms"],
         "bound_by": odo["bound_by"], "library_ms": None,
         "shapes": [
             {"R": R, "K": K, "max_abs_err": v["err"], "ms": v["ms"],
              "plain_ms": v["plain_ms"], "device_ms": v["device_ms"],
              "plain_device_ms": v["plain_device_ms"],
              "bound_ms": v["bound_ms"], "bound_by": v["bound_by"]}
             for (R, K), v in vote.items()]},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
