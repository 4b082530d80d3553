"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``light_loam_tpu_torch/csrc`` and runs,
in order (each phase prints one line of numbers; any failure is an uncaught
exception and a non-zero exit):

  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc both kernels (seconds, ptxas resource lines);
  3. knn5 vs its plain PyTorch version at the mapping stage's shapes;
  4. compat_votes vs its plain PyTorch version at the odometry and mapping
     vote shapes;
  5. the flagship pipeline (HDL64_KITTI, full widths) over 12 synthetic
     frames on the card: kernel launch counts, finite poses, every mapped
     position within 5 cm of the JAX package's, per-stage device ms and
     frames/s.

The second-to-last line is a JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the ``light_loam_tpu_torch`` package beside it, the script fails
before printing any result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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
POSITION_TOL_M = 0.05
# knn5 distances: the Gram form |q|^2 + |r|^2 - 2 q.r rounds at the scale of
# |q|^2 + |r|^2 (~2e4 m^2 at 100 m, where a float32 ulp is ~1e-3 m^2), not of
# d, and the kernel (FMA contraction) and the plain version (cuBLAS) round it
# differently.  So each distance must lie within rtol*d + atol +
# KNN_ULPS * eps32 * (|q|^2 + |r|^2) of the exact float64 distance.
KNN_RTOL, KNN_ATOL, KNN_ULPS = 1e-5, 1e-4, 4.0
# votes: a borderline score-vs-threshold pair may flip between roundings
VOTE_MAX_DIFF, VOTE_MAX_FRAC = 1.0, 0.01


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
    for k in kernels:
        k.build()
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


def phase_knn(dev) -> dict:
    pts_a, pts_b = _scan_points(dev)
    out = {}
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
            d_k, i_k = knn5(query, ref, mask, counts)
            torch.cuda.synchronize()
            d_p, i_p = knn5_plain(query, ref, mask, counts)
            torch.cuda.synchronize()
            err, mism = _check_knn(query, ref, d_k, i_k, d_p, i_p)
            out[(name, case)] = dict(err=err, mismatches=mism, Q=Q, N=N,
                                     qc=qc, rc=rc)
            if case == "below":
                out[(name, case)]["ms"] = _median_ms(
                    lambda: knn5(query, ref, mask, counts), 20)
                out[(name, case)]["plain_ms"] = _median_ms(
                    lambda: knn5_plain(query, ref, mask, counts), 5)
    print("[3 knn5] " + " | ".join(
        f"{n}/{c} Q={v['Q']} N={v['N']} counts=({v['qc']},{v['rc']}) "
        f"max_abs_err={v['err']:.3g} tie_swaps={v['mismatches']}"
        + (f" kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f} ms"
           if "ms" in v else "")
        for (n, c), v in out.items()))
    return out


def phase_vote(dev) -> dict:
    out = {}
    for K in (163, 829):
        rng = np.random.default_rng(K)
        R = 10
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
                f"compat_votes K={K}: max diff {diff.max().item()}, "
                f"differing fraction {frac}")
        out[K] = dict(
            err=diff.max().item(), frac=frac,
            ms=_median_ms(lambda: compat_votes(src_t, tgt_t, val_t), 50),
            plain_ms=_median_ms(
                lambda: compat_votes_plain(src_t, tgt_t, val_t), 20),
        )
    print("[4 vote] " + " | ".join(
        f"R=10 K={K} max_abs_err={v['err']:.3g} differing={v['frac']:.4f} "
        f"kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f} ms"
        for K, v in out.items()))
    return out


def phase_pipeline(dev, kernels) -> dict:
    cfg = PROFILES["hdl64"]
    frames = list(synthetic_frames(N_FRAMES, cfg, n_azimuth=1800, speed=1.0,
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
    # one vote per odometry outer iteration (6 per frame); a corner and a
    # surf 5-NN per mapping outer iteration (4 per mapped frame)
    votes_per_frame = cfg.odometry.outer_iterations
    knn_per_mapped = 2 * cfg.mapping.outer_iterations
    if launches["vote.cu"] != votes_per_frame * N_FRAMES:
        raise AssertionError(f"vote launches {launches['vote.cu']} != "
                             f"{votes_per_frame} x {N_FRAMES} frames")
    if launches["knn.cu"] != knn_per_mapped * n_mapped:
        raise AssertionError(f"knn launches {launches['knn.cu']} != "
                             f"{knn_per_mapped} x {n_mapped} mapped frames")
    for r in results:
        if not (np.isfinite(r.odom_q).all() and np.isfinite(r.odom_t).all()):
            raise AssertionError(f"frame {r.frame}: non-finite odometry pose")
    if positions.shape != JAX_MAPPED_POSITIONS.shape or not np.isfinite(
            positions).all():
        raise AssertionError(f"mapped positions {positions.shape} not "
                             f"finite {JAX_MAPPED_POSITIONS.shape}")
    dev_m = np.linalg.norm(positions - JAX_MAPPED_POSITIONS, axis=1)
    if (dev_m > POSITION_TOL_M).any():
        raise AssertionError(
            f"mapped positions deviate from the JAX package's by up to "
            f"{dev_m.max():.4f} m (> {POSITION_TOL_M} m): {dev_m.tolist()}")
    stages = pipe.timers.device_report()
    fps = (N_FRAMES - 1) / (t_end - t1)
    print(f"[5 pipeline] hdl64 {N_FRAMES} frames, {n_mapped} mapped | "
          f"launches {launches} | max |mapped - jax| {dev_m.max():.4f} m | "
          + " ".join(f"{n} {s.mean_ms:.2f}ms" for n, s in sorted(stages.items()))
          + f" (device, mean of frames 2-{N_FRAMES}) | {fps:.2f} frames/s "
          f"(host wall, frames 2-{N_FRAMES}; first frame "
          f"{(t1 - t0) * 1e3:.0f} ms)")
    return launches


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    kernels = (KNN5, VOTE)
    phase_build(kernels)
    knn = phase_knn(dev)
    vote = phase_vote(dev)
    launches = phase_pipeline(dev, kernels)

    surf = knn[("surf", "below")]
    knn_err = max(v["err"] for v in knn.values())
    print(json.dumps({"kernels": [
        {"name": "knn5", "route": "cuda",
         "source": "light_loam_tpu_torch/csrc/knn.cu",
         "replaces": "light_loam_tpu/ops/pallas_knn.py:69",
         "launches": launches["knn.cu"], "max_abs_err": knn_err,
         "ms": surf["ms"], "plain_ms": surf["plain_ms"]},
        {"name": "compat_votes", "route": "cuda",
         "source": "light_loam_tpu_torch/csrc/vote.cu",
         "replaces": "light_loam_tpu/ops/pallas_vote.py:33",
         "launches": launches["vote.cu"],
         "max_abs_err": max(v["err"] for v in vote.values()),
         "ms": vote[163]["ms"], "plain_ms": vote[163]["plain_ms"]},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
