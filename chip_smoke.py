"""Smoke run of the PyTorch/CUDA port on NVIDIA GPUs: one card, and every
card of the host for phase 15's ranks (up to four).

    python3 chip_smoke.py [--only-sharded]

Builds the port's CUDA kernels from ``light_loam_tpu_torch/csrc`` and runs,
in order (each phase prints one line of numbers; any failure is an uncaught
exception and a non-zero exit):

  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc the three kernels, all at once (seconds, ptxas resource
     lines);
  3. knn5 vs its plain PyTorch version at the mapping stage's shapes; at
     the live counts the stage hands over, timed per call and per launch
     on the device, beside the least time the card could take (its bound);
     then B = 4 and 8 lanes under ``torch.vmap`` (one launch), each lane
     bit for bit its own single launch, timed beside B single launches;
  4. compat_votes vs its plain PyTorch version at the odometry plane,
     mapping and odometry corner vote shapes (R, K = 10, 163; 10, 829;
     5, 158), timed per call and per launch on the device, beside its
     bound; then 4 and 8 lanes of R = 10, K = 163 under ``torch.vmap`` (one
     launch of R = 40 and 80), equal to 4 and 8 single launches;
 3c. segment_sum (csrc/segsum.cu, the ordered voxel, store and refinement
     sums; no Pallas twin): phase 5's 12 frames staged and a refinement of
     their keyframes with every call recorded, then at each call site's
     shapes the kernel bit for bit its plain version on the CPU, timed per
     call and per launch on the device beside its bound, the plain version
     on the card (index_add_ with atomics) and three library calls
     (index_add_, with atomics and deterministic, and segment_reduce); 4
     calls of each site as lanes of one launch under ``torch.vmap``; the
     longest live segment of each site;
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
     checks;
  9. the fused frame (``fused_step=True``: the whole frame captured once as
     a CUDA graph, one replay per frame) over the 12 frames of phase 5:
     warm-up and capture seconds, the kernels one traced replay runs against
     the launches the wrappers counted at capture, mapped positions against
     the JAX package's and against phase 5's own (bitwise: the sums are
     ordered), the ``fused_step`` stream ms and frames/s; and per-call
     device ms of the two map-store merges and of the registration that
     runs both and selects;
 10. the chunked replay from a KITTI folder: the 12 frames are written as
     a KITTI-layout sequence (``.bin`` records, ``times.txt``, camera-frame
     ground truth) into a temporary directory, then ``run_kitti`` replays
     it with ``chunk_size=4`` and with ``fused=True`` (reader thread and
     pose writer on the clock): 12 rows each, row 0 the identity, the two
     files equal, the fused file within its digits of phase 9, ATE against
     the ground truth under 0.30 m;
 11. checkpoint and export, under deterministic sums: a staged run saved
     after frame 6 and loaded into a fresh Pipeline gives the uninterrupted
     run's frame 7 within 1e-5, the uninterrupted run phase 5's first 8
     frames bitwise, and ``export_map`` writes two PLY files with the
     stores' live counts;
 12. repeatability: the 12 frames staged, fused per frame and chunked under
     ``torch.use_deterministic_algorithms`` and with PyTorch's default
     settings (staged twice), every run bitwise equal to every other and
     to phases 5 and 9, with the frames/s and ``fused_step`` ms of both
     settings;
 13. the batched lanes (models/batch.py): B flagship sequences per step,
     lane b the synthetic run of ``World.urban(seed=b)`` (lane 0 is phase
     5's), one graph replay per batched frame, at B = 1, 4 and 8 over 8
     frames, then chunks of 4 frames over 4 lanes: lane 0 within 5 cm of
     the JAX package's positions, every lane within 3 cm of its own fused
     single-lane run, the chunked run bitwise the per-frame one, and
     under deterministic sums 2 lanes over 6 frames, run again in reverse
     order, within 1 mm of the first order (a lane's result must not depend
     on its place); capture seconds, stream ms per batched frame,
     aggregate frames/s, kernels per traced replay (4 knn5, 6 vote and 7
     segment_sum kernels whatever B is), the busy share of a traced replay
     and peak
     memory; under deterministic sums each batched step is also held to
     the same lane stepped alone from the same carried state (2 mm for
     translations, 1e-4 for quaternions);
 14. the windowed refinement (models/refine.py, solver/schur.py): 16
     fused frames fill the keyframe window, then
     ``refine_recent_keyframes`` at K = 4 and 16 keyframes (512 landmarks,
     4 iterations): device ms per call split into extract_landmarks,
     refine_window and schur_solve, device events and the costliest
     kernels of one call traced through ``StageTimers.profiler_trace``,
     refined poses within 1e-4 of the same call on the CPU in float64
     (in float32 rounding decides the landmark fits: reported), two calls
     bitwise equal with PyTorch's default settings and under deterministic
     ones; keyframes corrupted after the
     fact recovered by apply=True, the next staged and fused frames within
     1.5 m of the refined pose; the HTML viewer written from the card;
 15. the multi-device paths (light_loam_tpu_torch/parallel/), each rank a
     process spawned after phase 2 that loads phase 2's libraries: NCCL at
     world 1 on cuda:0, then 4 (or 2) ranks on as many cards over NCCL, or
     on one card, where NCCL refuses a second rank, 2 gloo ranks both on
     cuda:0 (said so, with the card count, the backend, n and ``nvidia-smi
     topo -m``'s links).  Each run: phase 5's 12 frames, one sharded step
     from each single-device state (recorded from a staged run) against
     that state's single-device step (2 cm, the JAX test's factor and map
     bounds, every rank's pose bitwise equal), the 12 frames from an empty
     map against the JAX package's sharded run at the same n (5 cm), the
     same per step with phase 6's map vote (compat_votes on every rank),
     4 lanes per rank of phase 13's frames through the lane-sharded batched
     step against the same lanes unsharded (3 cm), phase 14's window split
     over the ranks in float64 against the single call (1e-9), and on
     every rank one knn5, one compat_votes and one segment_sum call at the
     rank's shapes against their plain versions; ms per sharded step,
     collectives per
     step and their bytes, aggregate lane frames/s, each rank's peak
     memory and launches.  Over NCCL every sharded step is one replay of
     the rank's captured step (``ShardedStepGraph``, collectives inside):
     warm-up and capture seconds per rank, collectives, MiB and kernel
     launches counted at capture; a probe captures a bare all-gather and
     all-reduce of the step's sizes past the size-1 shortcuts and checks
     10 replays; at n = 1 the 12 steps also run through the eager body,
     both under deterministic sums, the captured step held to it (1e-5,
     bitwise expected) and timed against it; at n > 1 t1 / (n tn) of the
     captured step.  The gloo run stays eager, and says so.
     ``--only-sharded`` runs phases 1, 2 and 15 alone, phase 15 making its
     own references;
 16. the "runs" less-flat downsample (``scan.lessflat_mode="runs"``) over
     phase 5's 12 frames, staged and fused: mapped positions within 5 cm of
     the JAX package's runs-mode run, staged and fused bitwise equal, frame
     0's less-flat live count in both modes, stream ms per stage.

Launch counts: each kernel's wrapper counts its own launches, and every
staged phase checks them against the counts derived from its config.  A
graph replay goes past the wrappers: the fused phases check that the
wrappers counted nothing but the host loop's keyframe stack (one
segment_sum a frame, outside the graph), and report replays times the
launches counted at capture, which a traced replay confirms kernel by
kernel.

The last three lines are a JSON object with each kernel's numbers
(``launches`` from the wrappers over the main-path phases, ``graph_launches``
through replays, ``lane_launches`` through phase 13's, ``sharded_launches``
from phase 15's ranks' wrappers, ``sharded_graph_launches`` through their
captured steps' replays and ``sharded_lane_launches`` through their lane
replays), the card's name and power limit, and ``{"ok": true, "device":
{...}}``.
Without a CUDA device, or without the ``light_loam_tpu_torch`` package
beside it, the script fails before printing any result.  It imports
nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import statistics
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from light_loam_tpu_torch.core.frame import PointCloud
from light_loam_tpu_torch.io.evaluation import ate_rmse
from light_loam_tpu_torch.io.kitti import gt_to_lidar_frame, read_gt_poses
from light_loam_tpu_torch.models import batch, fused, mapping
from light_loam_tpu_torch.models import refine as refine_module
from light_loam_tpu_torch.models import pipeline as pipeline_module
from light_loam_tpu_torch.models.mapping import MappingState
from light_loam_tpu_torch.models.odometry import OdometryState
from light_loam_tpu_torch.models.refine import (
    PlaneLandmarks,
    extract_landmarks,
    normal_equations,
    refine_window,
)
from light_loam_tpu_torch.models.pipeline import (
    PROFILES,
    Pipeline,
    run_kitti,
    synthetic_frames,
)
from light_loam_tpu_torch.ops.cuda_knn import KNN5, knn5, knn5_plain
from light_loam_tpu_torch.ops.cuda_vote import (
    VOTE,
    compat_votes,
    compat_votes_plain,
)
from light_loam_tpu_torch.ops.cuda_segsum import (
    SEGSUM,
    segment_sum,
    segment_sum_plain,
)
from light_loam_tpu_torch.ops import graphvote, sorted_store
from light_loam_tpu_torch.ops import voxel as voxel_module
from light_loam_tpu_torch.ops.features import extract_features
from light_loam_tpu_torch.ops.graphvote import full_graph_vote
from light_loam_tpu_torch.ops.knn import (
    knn_tiled,
    surf_correspondences,
    surf_correspondences_grid,
)
from light_loam_tpu_torch.ops.voxel import compact_rows, voxel_downsample
from light_loam_tpu_torch.parallel.batch_sharded import (
    gather_lanes,
    init_sharded_batch_state,
    put_frames,
    sharded_batched_frame_step,
)
from light_loam_tpu_torch.parallel import sharded
from light_loam_tpu_torch.parallel.sharded import (
    _sharded_step_body,
    make_group,
    refine_hooks,
    shard_mapping_state,
    sharded_mapping_step,
)
from light_loam_tpu_torch.solver.schur import schur_solve
from light_loam_tpu_torch.utils.html_viewer import export_pipeline_html
from light_loam_tpu_torch.utils.timing import StageTimers

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
# Phase 16: the JAX package's mapped positions (m) with the "runs" less-flat
# downsample (runs_config), on the CPU, produced by:
#   JAX_PLATFORMS=cpu python -c "import dataclasses as d; from
#   light_loam_tpu.models import pipeline as pl; c = pl.PROFILES['hdl64'];
#   pl.PROFILES['hdl64'] = d.replace(c, scan=d.replace(c.scan,
#   lessflat_mode='runs')); p, _, _ = pl.run_synthetic(n_frames=12,
#   profile='hdl64', n_azimuth=1800, speed=1.0, seed=0);
#   print(p.mapped_positions().tolist())"
JAX_RUNS_MAPPED_POSITIONS = np.array([
    [0.0, 0.0, 0.0],
    [0.998348593711853, 0.02180488035082817, 0.0012694337638095021],
    [2.0058720111846924, 0.04207667335867882, 0.0007377418805845082],
    [3.008472442626953, 0.06607302278280258, 0.0006436275434680283],
    [4.015102386474609, 0.08774460852146149, 0.0014582430012524128],
    [5.003109455108643, 0.1089923158288002, 0.0025407597422599792],
    [6.012282848358154, 0.12613815069198608, 0.0012197867035865784],
    [7.02222204208374, 0.14233486354351044, 0.0033313813619315624],
    [8.00853443145752, 0.16262193024158478, 0.0030285720713436604],
    [9.005297660827637, 0.18931910395622253, 0.0032841728534549475],
    [9.998428344726562, 0.20652428269386292, 0.003075742395594716],
    [11.003267288208008, 0.23232193291187286, 0.005121775437146425],
])
POSITION_TOL_M = 0.05
# Runs on the same card.  The fused and the chunked frame run the staged
# path's own stage functions, and the voxel, store and refinement sums are
# ordered (ops/cuda_segsum.py), so two runs of the same frames, staged, fused
# or chunked, with PyTorch's default settings or deterministic ones, are
# held to each other bitwise (SAME_CARD_TOL_M).  With index_add_'s atomic
# sums the order of the adds changed from run to run, a centroid's last bit
# with it, and through the float32 plane-fit gates the trajectory: two runs
# were up to 11.41 mm apart over 12 frames and were held to 3 cm (PERF.md).
# A batched lane is not the single lane's computation (vmap's batched
# reductions round differently, and the plane-fit gates grow that to mm), so
# lanes are held to their single-lane runs at LANE_TOL_M, the JAX package's
# own band between its chunked and per-frame programs (tests/test_fused.py),
# and under deterministic sums one lane's positions to the same lanes in
# reverse order at REPEATABLE_TOL_M.  A pose file holds 7 significant digits
# (%.6e: at most 6e-6 m on this run's 12 m), so a file against a run is held
# to POSE_FILE_TOL_M.
SAME_CARD_TOL_M = 0.0
LANE_TOL_M = 0.03
REPEATABLE_TOL_M = 1e-3
POSE_FILE_TOL_M = 1e-5
RESUME_TOL = 1e-5
KITTI_CHUNK = 4
KITTI_ATE_TOL_M = 0.30
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


def _graph_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` captured as a CUDA graph and replayed
    ``reps`` times back to back: for calls of so many launches that the
    host could not keep ahead of the card."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    return knn_lanes_bound(Q, [(qc, rc)])


def knn_lanes_bound(Q: int, counts) -> tuple:
    """knn_bound summed over lanes of (qc, rc) live counts."""
    return _bound(KNN_FLOP_PER_PAIR * sum(qc * rc for qc, rc in counts),
                  sum(12 * qc + 13 * rc + 8 + 40 * Q for qc, rc in counts))


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


# lane counts of phase 3's and 4's batched calls (phase 13 runs these B)
KERNEL_LANES = (4, 8)


def knn_lane_cases(dev):
    """Phase 3's batched knn5 inputs at the mapping stage's capacities: B
    lanes, each its own draw of the two scans, with live counts near
    phase 3's "below" case that differ per lane.  Yields (name, B, query
    (B, Q, 3), ref (B, N, 3), mask (B, N), counts (B, 2))."""
    pts_a, pts_b = _scan_points(dev)
    for Q, N, name in ((2048, 32768, "corner"), (8192, 65536, "surf")):
        for B in KERNEL_LANES:
            gen = torch.Generator(device="cpu").manual_seed(Q + B)
            lanes = []
            for b in range(B):
                qc, rc = (Q * 5) // 8 - 8 * b, (N * 3) // 8 - 64 * b
                q = pts_b[torch.randperm(len(pts_b), generator=gen)[:Q].to(dev)]
                r = pts_a[torch.randperm(len(pts_a), generator=gen)[:N].to(dev)]
                holes = (torch.rand(N, generator=gen) < 0.1).to(dev)
                m = ~holes & (torch.arange(N, device=dev) < rc)
                lanes.append((q, r, m, torch.tensor([qc, rc], dtype=torch.int32,
                                                    device=dev)))
            yield (name, B, *(torch.stack(a).contiguous()
                              for a in zip(*lanes)))


def phase_knn_lanes(dev) -> dict:
    """Phase 3, lanes: ``torch.vmap(knn5)`` over B lanes (one launch), each
    lane held to the plain version on its own inputs as phase 3 holds a
    single launch, and equal to its single launch bit for bit; device ms of
    both, the plain version's ms per call over the B lanes, bound over all
    lanes' live pairs."""
    out = {}
    for name, B, query, ref, mask, counts in knn_lane_cases(dev):
        d_b, i_b = torch.vmap(knn5)(query, ref, mask, counts)
        torch.cuda.synchronize()
        err, swaps = 0.0, 0
        for b in range(B):
            lane = (query[b], ref[b], mask[b], counts[b])
            e, n = _check_knn(query[b], ref[b], d_b[b], i_b[b],
                              *knn5_plain(*lane))
            err, swaps = max(err, e), swaps + n
            d1, i1 = knn5(*lane)
            if not (torch.equal(d_b[b], d1) and torch.equal(i_b[b], i1)):
                raise AssertionError(f"knn5 {name} B={B}: lane {b} differs "
                                     "from its single launch")
        lanes = functools.partial(torch.vmap(knn5), query, ref, mask, counts)

        def singles(fn=knn5):
            for b in range(B):
                fn(query[b], ref[b], mask[b], counts[b])

        Q, N = query.shape[1], ref.shape[1]
        live = counts.tolist()
        v = out[(name, B)] = dict(
            Q=Q, N=N, B=B, counts=live, max_abs_err=err, tie_swaps=swaps,
            ms=_median_ms(lanes, 20),
            plain_ms=_median_ms(functools.partial(singles, knn5_plain), 3),
            device_ms=_device_ms(lanes, 40),
            singles_device_ms=_device_ms(singles, max(4, 80 // B)))
        v["bound_ms"], v["bound_by"] = knn_lanes_bound(Q, live)
    print("[3 knn5 lanes] torch.vmap, one launch, every lane held to the "
          "plain version and bit for bit its single launch | " + " | ".join(
              f"{n} B={v['B']} Q={v['Q']} N={v['N']}: max_abs_err "
              f"{v['max_abs_err']:.3g} tie_swaps={v['tie_swaps']}, kernel "
              f"{v['device_ms']:.4f} ms per launch on the device "
              f"({v['ms']:.4f} per call, plain {v['plain_ms']:.4f} per call "
              f"over the lanes), "
              f"{v['singles_device_ms']:.4f} ms for {v['B']} single launches, "
              f"bound {v['bound_ms']:.4f} ms ({v['bound_by']}), "
              f"{v['bound_ms'] / v['device_ms']:.1%} of the bound"
              for (n, _), v in out.items()))
    return out


def _vote_inputs(R: int, K: int, seed: int, dev):
    """(src, tgt, valid) of R chunks of K on the card: a quarter of the
    targets moved by 2-8 m, a tenth of the slots invalid."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (R, K, 3)).astype(np.float32)
    bad = rng.random((R, K)) < 0.25
    tgt = src + 0.3 + np.where(bad[..., None],
                               rng.uniform(2, 8, (R, K, 3)), 0.0)
    valid = (rng.random((R, K)) < 0.9).astype(np.float32)
    return (torch.as_tensor(src * valid[..., None]).to(dev),
            torch.as_tensor((tgt * valid[..., None]).astype(np.float32)).to(dev),
            torch.as_tensor(valid).to(dev))


# compat_votes shapes: odometry plane vote (1536 // 10 + 10), mapping vote
# (8192 // 10 + 10), odometry corner vote (768 // 5 + 5)
VOTE_SHAPES = ((10, 163), (10, 829), (5, 158))


def phase_vote(dev) -> dict:
    out = {}
    for R, K in VOTE_SHAPES:
        src_t, tgt_t, val_t = _vote_inputs(R, K, K, dev)
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


def phase_vote_lanes(dev) -> dict:
    """Phase 4, lanes: ``torch.vmap(compat_votes)`` over B lanes of the
    odometry plane shape, one launch of B·R chunks, each lane held to the
    plain version on its own inputs as phase 4 holds a single launch, and
    equal to its single launch; device ms of both and of the plain version
    over the B·R chunks, beside the bound of B·R chunks."""
    R, K = VOTE_SHAPES[0]
    out = {}
    for B in KERNEL_LANES:
        src, tgt, valid = (torch.stack(a) for a in zip(
            *(_vote_inputs(R, K, K + b, dev) for b in range(B))))
        v_b = torch.vmap(compat_votes)(src, tgt, valid)
        torch.cuda.synchronize()
        flat = [a.flatten(0, 1) for a in (src, tgt, valid)]
        diff = (v_b - compat_votes_plain(*flat).view_as(v_b)).abs()
        frac = (diff > 0).float().mean(dim=(1, 2))
        if (diff.max().item() > VOTE_MAX_DIFF
                or frac.max().item() >= VOTE_MAX_FRAC):
            raise AssertionError(
                f"compat_votes B={B}: max diff {diff.max().item()}, "
                f"differing fraction per lane {frac.tolist()}")
        for b in range(B):
            if not torch.equal(v_b[b], compat_votes(src[b], tgt[b], valid[b])):
                raise AssertionError(f"compat_votes B={B}: lane {b} differs "
                                     "from its single launch")
        lanes = functools.partial(torch.vmap(compat_votes), src, tgt, valid)
        plain = functools.partial(compat_votes_plain, *flat)

        def singles():
            for b in range(B):
                compat_votes(src[b], tgt[b], valid[b])

        v = out[B] = dict(B=B, R=B * R, K=K, max_abs_err=diff.max().item(),
                          ms=_median_ms(lanes, 50),
                          plain_ms=_median_ms(plain, 20),
                          device_ms=_device_ms(lanes, 100),
                          plain_device_ms=_device_ms(plain, 20),
                          singles_device_ms=_device_ms(singles, 100 // B))
        v["bound_ms"], v["bound_by"] = vote_bound(B * R, K)
    print("[4 vote lanes] torch.vmap, one launch, every lane held to the "
          "plain version and equal to its single launch | " + " | ".join(
              f"B={B} (R={v['R']} K={v['K']}): max_abs_err "
              f"{v['max_abs_err']:.3g}, kernel {v['device_ms']:.4f} ms "
              f"per launch on the device ({v['ms']:.4f} per call), plain "
              f"{v['plain_device_ms']:.4f} ms on the device ({v['plain_ms']:.4f} "
              f"per call), "
              f"{v['singles_device_ms']:.4f} ms for {B} single launches of R="
              f"{R}, bound {v['bound_ms']:.4f} ms ({v['bound_by']}), "
              f"{v['bound_ms'] / v['device_ms']:.1%} of the bound"
              for B, v in out.items()))
    return out


# Phase 3c: segment_sum at the main path's shapes, B lanes in one launch
SEGSUM_LANES = 4
# the modules that call segment_sum, by the name they import it under
SEGSUM_CALLERS = (voxel_module, sorted_store, refine_module)


class SegsumRecorder:
    """While active, every call of ``segment_sum`` by the port's modules is
    recorded by call site (the caller and its caller, and the shapes): the
    inputs of the newest SEGSUM_LANES calls, cloned, and the longest live
    segment over all calls, counted on the card and read once at the end."""

    def __enter__(self):
        self.calls, self.longest = {}, {}
        for module in SEGSUM_CALLERS:
            setattr(module, "segment_sum", self)
        return self

    def __exit__(self, *exc):
        for module in SEGSUM_CALLERS:
            setattr(module, "segment_sum", segment_sum)

    def __call__(self, values, seg, S):
        frame = sys._getframe(1)
        site = (f"{frame.f_back.f_code.co_name}/{frame.f_code.co_name}",
                *values.shape, S, str(values.dtype).split(".")[-1])
        calls = self.calls.setdefault(site, [])
        calls.append((values.clone(), seg.clone(), S))
        del calls[:-SEGSUM_LANES]
        rows = torch.zeros(S + 1, dtype=torch.int64, device=seg.device
                           ).index_add_(0, seg, torch.ones_like(seg))[:S].max()
        old = self.longest.get(site)
        self.longest[site] = rows if old is None else torch.maximum(old, rows)
        return segment_sum(values, seg, S)


def _segsum_err(out, values, seg, S) -> float:
    """max |kernel - plain| with the plain version on the CPU copies of the
    inputs, where ``index_add`` adds in row order, the kernel's own order:
    0 means bit for bit (signed zeros aside)."""
    want = segment_sum_plain(values.cpu(), seg.cpu(), S)
    got = out.cpu()
    if torch.equal(got, want):
        return 0.0
    return float((got - want).abs().nan_to_num(float("inf")).max())


def segsum_bound(values, seg, S) -> tuple:
    """segment_sum reads each live row (seg < S: the dump rows are neither
    read nor needed) with its slot id, and writes every slot; one add per
    value read, against bytes over 3.35 TB/s."""
    width = values.shape[-1] * values.element_size()
    live = int((seg < S).sum())
    lanes = values.shape[0] if values.dim() == 3 else 1
    return _bound(live * values.shape[-1],
                  live * (width + 8) + lanes * S * width)


def phase_segsum(dev) -> dict:
    """Phase 3c: phase 5's 12 frames staged and a refinement of their
    keyframes, with every segment_sum call recorded; then at each call
    site's shapes the kernel against its plain version (on the CPU copies:
    bit for bit), device ms, ms per call, the plain version on the card
    (index_add_ with atomics), the bound and the library calls on the same
    inputs (index_add_ into a zeroed buffer, with atomics and under
    deterministic algorithms, and torch.segment_reduce over the slots'
    offsets, given and found by torch.searchsorted); then the newest SEGSUM_LANES calls of each site as lanes of
    one launch under ``torch.vmap``, each lane bit for bit its plain
    version and its single launch.  Also the longest live segment of each
    site over the 12 frames."""
    cfg = PROFILES["hdl64"]
    frames = list(synthetic_frames(N_FRAMES, cfg, n_azimuth=1800, speed=1.0,
                                   seed=0))
    pipe = Pipeline(cfg, device="cuda")
    with SegsumRecorder() as rec:
        for _, xyz, mask in frames:
            pipe.process_frame(xyz, mask)
        pipe.refine_recent_keyframes(n_keyframes=REFINE_WINDOWS[-1],
                                     n_landmarks=REFINE_LANDMARKS,
                                     n_iterations=REFINE_ITERATIONS)
    longest = {site: int(n) for site, n in rec.longest.items()}
    out = {}
    for site, calls in rec.calls.items():
        values, seg, S = calls[-1]
        got = segment_sum(values, seg, S)
        torch.cuda.synchronize()
        err = _segsum_err(got, values, seg, S)
        if err != 0.0:
            raise AssertionError(f"segment_sum {site}: {err:.3g} from the "
                                 "plain version")
        atomic_gap = float((segment_sum_plain(values, seg, S) - got).abs().max())
        kernel = functools.partial(segment_sum, values, seg, S)
        plain = functools.partial(segment_sum_plain, values, seg, S)
        buf = values.new_zeros((S + 1, values.shape[1]))
        slots = torch.arange(S + 1, device=dev)
        offsets = torch.searchsorted(seg, slots)
        reduce = functools.partial(torch.segment_reduce, values, "sum",
                                   offsets=offsets, axis=0, unsafe=True)
        reduce_gap = float((reduce() - got).abs().max())

        def search_and_reduce():
            return torch.segment_reduce(
                values, "sum", offsets=torch.searchsorted(seg, slots), axis=0,
                unsafe=True)

        v = out[site] = dict(
            site=site[0], N=site[1], C=site[2], S=S, dtype=site[4],
            live_rows=int((seg < S).sum()), longest_live_segment=longest[site],
            max_abs_err=err, atomic_gap=atomic_gap, segment_reduce_gap=reduce_gap,
            ms=_median_ms(kernel, 20), plain_ms=_median_ms(plain, 20),
            device_ms=_device_ms(kernel, 50),
            plain_device_ms=_device_ms(plain, 50),
            library_ms={
                "index_add_": _device_ms(
                    lambda: buf.index_add_(0, seg, values), 50),
                "segment_reduce": _device_ms(reduce, 50),
                "searchsorted + segment_reduce": _device_ms(
                    search_and_reduce, 50)})
        with deterministic_sums():
            v["library_ms"]["index_add_ deterministic"] = _device_ms(
                lambda: buf.index_add_(0, seg, values), 20)
        v["bound_ms"], v["bound_by"] = segsum_bound(values, seg, S)
        if len(calls) == SEGSUM_LANES:
            v["lanes"] = _segsum_lanes(site, calls)
    for v in out.values():
        lanes = v.get("lanes")
        lib = v["library_ms"]
        print(f"[3c segment_sum] {v['site']} N={v['N']} C={v['C']} "
              f"S={v['S']} {v['dtype']}: live rows {v['live_rows']}, longest "
              f"live segment {v['longest_live_segment']} (12 frames) | "
              f"max_abs_err {v['max_abs_err']:.3g} (CPU plain), "
              f"{v['atomic_gap']:.3g} from index_add_ on the card | kernel "
              f"{v['device_ms']:.4f} ms per launch on the device, "
              f"{v['ms']:.4f} per call; plain {v['plain_device_ms']:.4f} on "
              f"the device, {v['plain_ms']:.4f} per call | bound "
              f"{v['bound_ms']:.5f} ms ({v['bound_by']}), "
              f"{v['bound_ms'] / v['device_ms']:.1%} of the bound | library: "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in lib.items())
              + f" (segment_reduce {v['segment_reduce_gap']:.3g} from the "
              "kernel)"
              + (f" | {SEGSUM_LANES} lanes in one launch: max_abs_err "
                 f"{lanes['max_abs_err']:.3g}, {lanes['device_ms']:.4f} ms "
                 f"per launch against {lanes['singles_device_ms']:.4f} for "
                 f"{SEGSUM_LANES} single launches, bound "
                 f"{lanes['bound_ms']:.5f} ms, {lanes['bound_ms'] / lanes['device_ms']:.1%}"
                 if lanes else ""))
    print(f"[3c segment_sum] longest live segment over phase 5's 12 frames: "
          f"{max(longest.values())} rows ("
          + ", ".join(f"{site[0]} {n}" for site, n in longest.items()) + ")")
    return out


def _segsum_lanes(site, calls) -> dict:
    """One site's newest calls as lanes of one launch under ``torch.vmap``:
    each lane bit for bit its plain version and its single launch."""
    values = torch.stack([c[0] for c in calls])
    seg = torch.stack([c[1] for c in calls])
    S = calls[0][2]
    lanes = functools.partial(torch.vmap(segment_sum, in_dims=(0, 0, None)),
                              values, seg, S)
    got = lanes()
    torch.cuda.synchronize()
    err = 0.0
    for b in range(len(calls)):
        err = max(err, _segsum_err(got[b], values[b], seg[b], S))
        if not torch.equal(got[b], segment_sum(values[b], seg[b], S)):
            raise AssertionError(f"segment_sum {site}: lane {b} differs from "
                                 "its single launch")
    if err != 0.0:
        raise AssertionError(f"segment_sum {site} lanes: {err:.3g} from the "
                             "plain version")

    def singles():
        for b in range(len(calls)):
            segment_sum(values[b], seg[b], S)

    v = dict(B=len(calls), max_abs_err=err, ms=_median_ms(lanes, 20),
             device_ms=_device_ms(lanes, 50),
             singles_device_ms=_device_ms(singles, 20))
    v["bound_ms"], v["bound_by"] = segsum_bound(values, seg, S)
    return v


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


def runs_config():
    """The flagship profile with the "runs" less-flat downsample."""
    base = PROFILES["hdl64"]
    return dataclasses.replace(
        base, scan=dataclasses.replace(base.scan, lessflat_mode="runs"))


def expected_launches(cfg, n_frames: int, n_mapped: int,
                      keyframes=None) -> dict:
    """Launches a run makes, from its config.  compat_votes: one per
    odometry outer iteration for each of the plane and corner votes in
    "simple" mode, and one per mapping outer iteration in mapping "simple"
    mode (all run before their gates open too; "full" launches none).
    knn5: a corner and a surf 5-NN per mapping outer iteration.
    segment_sum: the less-flat voxel sums of every frame in "exact" mode;
    per mapped frame the two stack downsamples and, for each store, the
    full re-sort and (but in "resort" mode) the sorted merge's reduce; and
    the keyframe stack the host loop downsamples after each mapped frame
    (``keyframes``, n_mapped unless given: a graph replay holds none)."""
    o, m = cfg.odometry, cfg.mapping
    simple = (o.plane_vote_mode == "simple") + (o.corner_vote_mode == "simple")
    votes = (simple * o.outer_iterations * n_frames
             + (m.vote_mode == "simple") * m.outer_iterations * n_mapped)
    per_store = 1 if m.map_store_mode == "resort" else 2
    sums = ((cfg.scan.lessflat_mode == "exact") * n_frames
            + (2 + 2 * per_store) * n_mapped
            + (n_mapped if keyframes is None else keyframes))
    return {"knn.cu": 2 * m.outer_iterations * n_mapped, "vote.cu": votes,
            "segsum.cu": sums}


def replay_launches(cfg) -> dict:
    """Launches one replay of the fused (or batched) frame makes: one frame,
    mapped, without the host loop's keyframe stack."""
    return expected_launches(cfg, 1, 1, keyframes=0)


def keyframe_launches(n: int) -> dict:
    """Launches the host loop makes around ``n`` fused frames: each frame's
    keyframe stack, one voxel downsample, outside the graph."""
    return {"knn.cu": 0, "vote.cu": 0, "segsum.cu": n}


# the device functions of the csrc/ kernels that one launch by the wrapper
# starts once (knn5 also starts its merge kernel once)
KERNEL_FUNCTIONS = {"knn.cu": "knn5_segment_kernel",
                    "vote.cu": "compat_votes_kernel",
                    "segsum.cu": "segment_sum_kernel"}


def replay_kernel_counts(graph) -> tuple:
    """Kernels of the two sources that one traced replay of a FrameGraph
    runs on the card, by source, the number of all its kernels, their
    device ms, the host wall ms of the same traced replay (launch to
    synchronize) and the three kernels that take the most device time
    (name, ms, count).  A graph captured from one stream runs its kernels
    one after another, so kernel ms over that wall ms is the share of the
    traced replay in which the card was busy; tracing stretches the gaps
    between kernels, so the untraced share is no lower.  The replay runs on
    whatever the graph's buffers hold; every call of the graph's entry
    points overwrites them."""
    from torch.profiler import ProfilerActivity, profile

    graph.index.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        graph.graph.replay()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    graph.index.zero_()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    counts = {source: sum(function in e.name for e in kernels)
              for source, function in KERNEL_FUNCTIONS.items()}
    averages = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.self_device_time_total, reverse=True)
    kernel_ms = sum(e.self_device_time_total for e in averages) / 1e3
    top = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in averages[:3]]
    return counts, len(kernels), kernel_ms, wall_ms, top


def phase_pipeline(tag, cfg, n_frames, jax_positions, kernels) -> dict:
    """Drive ``n_frames`` flagship frames under ``cfg`` and hold them to
    ``jax_positions``; returns the launch counts of this run (the wrappers'
    own, and those made through graph replays) and the mean stream ms per
    stage."""
    frames = list(synthetic_frames(n_frames, cfg, n_azimuth=1800, speed=1.0,
                                   seed=0))
    graph = fused.frame_graph(cfg, "cuda") if cfg.fused_step else None
    replays = graph.replays if graph else 0
    pipe = Pipeline(cfg, device="cuda")
    for k in kernels:
        k.launches = 0
    results = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    nothing = dict.fromkeys(launches, 0)
    replays = graph.replays - replays if graph else 0
    graph_launches = ({name: n * replays
                       for name, n in graph.kernel_launches.items()}
                      if graph else nothing)

    n_mapped = sum(r.mapped for r in results)
    if graph:
        eager_want = keyframe_launches(n_mapped)
        graph_want = expected_launches(cfg, n_frames, n_mapped, keyframes=0)
    else:
        eager_want = expected_launches(cfg, n_frames, n_mapped)
        graph_want = nothing
    if launches != eager_want or graph_launches != graph_want:
        raise AssertionError(
            f"launches counted by the wrappers {launches} != {eager_want}, or "
            f"through {replays} graph replays {graph_launches} != "
            f"{graph_want}: derived from the config for {n_frames} frames, "
            f"{n_mapped} mapped")
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
    print(f"[{tag}] hdl64 {n_frames} frames, {n_mapped} mapped, "
          f"{'fused' if cfg.fused_step else 'staged'}, votes "
          f"plane {o.plane_vote_mode} corner {o.corner_vote_mode} mapping "
          f"{cfg.mapping.vote_mode}, surf search {o.surf_knn}, distortion "
          f"{o.distortion}, occlusion filter {cfg.scan.occlusion_filter} | "
          f"launches counted by the wrappers {launches}, through {replays} "
          f"graph replays {graph_launches} | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB | max "
          f"|mapped - jax| {dev_m.max():.4f} m | "
          + " ".join(f"{n} {ms:.2f}ms" for n, ms in sorted(stages.items()))
          + f" (stream, mean of frames 2-{n_frames}) | {fps:.2f} frames/s "
          f"(host wall, frames 2-{n_frames}; first frame "
          f"{(t1 - t0) * 1e3:.0f} ms)")
    return dict(launches=launches, graph_launches=graph_launches,
                stages=stages, positions=positions, fps=fps, pipe=pipe)


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


def _check_gap(tag, a, b, limit=SAME_CARD_TOL_M) -> float:
    gap = float(np.linalg.norm(a - b, axis=1).max())
    if gap > limit:
        raise AssertionError(f"{tag}: positions differ by {gap:.6f} m "
                             f"(> {limit} m)")
    return gap


def phase_fused(kernels, staged) -> dict:
    """Phase 9: the fused frame over phase 5's frames, held to phase 5's
    positions (``staged``) and the JAX package's."""
    cfg = dataclasses.replace(PROFILES["hdl64"], fused_step=True)
    torch.cuda.reset_peak_memory_stats()
    graph = fused.frame_graph(cfg, "cuda")
    print(f"[9 fused] graph of one flagship frame: warm-up "
          f"{graph.warmup_seconds:.2f} s ({fused.WARMUP_PASSES} eager pass), "
          f"capture and instantiate {graph.capture_seconds:.2f} s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    want = replay_launches(cfg)
    traced, n_kernels, kernel_ms, traced_ms, top = replay_kernel_counts(graph)
    if graph.kernel_launches != want or traced != want:
        raise AssertionError(
            f"one replay should launch {want}: the wrappers counted "
            f"{graph.kernel_launches} at capture, a traced replay ran {traced}")
    p9 = phase_pipeline("9 fused", cfg, N_FRAMES, JAX_MAPPED_POSITIONS,
                        kernels)
    gap = _check_gap("phase 9 vs phase 5", p9["positions"],
                     staged["positions"])
    print(f"[9 fused] one graph replay per frame; a traced replay ran "
          f"{n_kernels} kernels, of them "
          + ", ".join(f"{traced[src]} {fn}"
                      for src, fn in KERNEL_FUNCTIONS.items())
          + f" (counted at capture: {graph.kernel_launches}), {kernel_ms:.2f} "
          f"ms in a traced replay of {traced_ms:.2f} ms wall (busy share "
          f"of the traced replay {kernel_ms / traced_ms:.3f}), most device "
          "time in " + ", ".join(
              f"{name[:48]} {ms:.2f} ms x{n}" for name, ms, n in top)
          + f" | max |fused - "
          f"staged (phase 5)| {gap * 1e3:.4f} mm (limit 0: ordered sums) | "
          f"{p9['fps']:.2f} frames/s fused against {staged['fps']:.2f} staged")
    return p9


def phase_merge_calls(pipe) -> None:
    """Device ms per call of the surf map-store registration on phase 9's
    final map: the sorted merge, the full re-sort, and the registration the
    mapping step runs (both, then a select on the device)."""
    cfg = pipe.cfg.mapping
    state, surf = pipe.map_state, pipe.odo_state.surf_last
    sx, _, sm, _ = voxel_downsample(surf.xyz, surf.rel, surf.mask,
                                    cfg.plane_resolution,
                                    cfg.stack_surf_capacity)
    q, t = pipe.mapped_trajectory()
    new = mapping.register_cloud(torch.as_tensor(q[-1]).cuda(),
                                 torch.as_tensor(t[-1]).cuda(), sx)
    ijk = mapping._cube_of(new, state.cen, cfg)
    inside = mapping._inside(ijk, cfg)
    cell = torch.where(inside, mapping._cell_linear(ijk, cfg),
                       torch.zeros_like(ijk[:, 0])).to(torch.int32)
    store, leaf = state.surf, cfg.plane_resolution
    select = torch.zeros((), dtype=torch.bool, device="cuda")
    calls = {
        "sorted": functools.partial(
            mapping.merge_sorted, store.xyz, store.cell, store.mask, new,
            cell, sm & inside, leaf),
        "full": functools.partial(
            mapping._merge_full, store, new, cell, sm & inside, leaf,
            cfg.map_surf_capacity),
        "both + select": functools.partial(
            mapping._merge_into_store, store, new, sm, state.cen, cfg, leaf,
            cfg.map_surf_capacity, select),
    }
    ms = {name: _graph_ms(fn, 20) for name, fn in calls.items()}
    print(f"[9 fused] surf store registration ({int(store.mask.sum())} "
          f"live of {cfg.map_surf_capacity}, {int(sm.sum())} new points), "
          "device ms per call (replayed as a graph): " + " | ".join(
              f"{n} {v:.3f}" for n, v in ms.items()))


def write_kitti_sequence(root, frames, sequence="99") -> None:
    """The frames as a KITTI-layout sequence (kittiHelper.cpp:65-130):
    sequences/<seq>/times.txt, velodyne/sequences/<seq>/velodyne/NNNNNN.bin
    (x, y, z, intensity float32 records), results/<seq>.txt (camera-frame
    ground truth: lidar (x, y, z) is camera (z, -x, -y))."""
    seq_dir = os.path.join(root, "sequences", sequence)
    vel_dir = os.path.join(root, "velodyne", "sequences", sequence, "velodyne")
    res_dir = os.path.join(root, "results")
    for d in (seq_dir, vel_dir, res_dir):
        os.makedirs(d, exist_ok=True)
    gt_rows = []
    for i, (pos, xyz, mask) in enumerate(frames):
        rec = np.zeros((int(mask.sum()), 4), np.float32)
        rec[:, :3] = xyz[mask]
        rec.tofile(os.path.join(vel_dir, f"{i:06d}.bin"))
        H = np.eye(4)
        H[:3, 3] = [-pos[1], -pos[2], pos[0]]
        gt_rows.append(H[:3].reshape(-1))
    np.savetxt(os.path.join(seq_dir, "times.txt"),
               0.1 * np.arange(len(gt_rows)), fmt="%.6f")
    np.savetxt(os.path.join(res_dir, f"{sequence}.txt"), np.asarray(gt_rows),
               fmt="%.6e")


def phase_kitti(kernels, p5, p9) -> dict:
    """Phase 10: KITTI folder in, trajectory files out, chunked and fused
    per frame; returns the launches the wrappers counted and those both
    runs made through graph replays."""
    cfg = PROFILES["hdl64"]
    frames = list(synthetic_frames(N_FRAMES, cfg, n_azimuth=1800, speed=1.0,
                                   seed=0))
    torch.cuda.reset_peak_memory_stats()
    # the graphs run_kitti will replay: the chunked runner's, and phase 9's
    graphs = {"chunked": fused.frame_graph(cfg, "cuda", chunk=KITTI_CHUNK),
              "fused": fused.frame_graph(
                  dataclasses.replace(cfg, fused_step=True), "cuda")}
    print(f"[10 kitti] graph for chunks of {KITTI_CHUNK} (one frame, "
          f"{KITTI_CHUNK} replays per chunk): warm-up "
          f"{graphs['chunked'].warmup_seconds:.2f} s, capture and instantiate "
          f"{graphs['chunked'].capture_seconds:.2f} s")
    launches, est, fps = {}, {}, {}
    want = expected_launches(cfg, N_FRAMES, N_FRAMES, keyframes=0)
    # the fused Pipeline downsamples each frame's keyframe stack eagerly
    wrappers = {"chunked": dict.fromkeys(want, 0),
                "fused": keyframe_launches(N_FRAMES)}
    with tempfile.TemporaryDirectory() as root:
        write_kitti_sequence(root, frames)
        gt_cam = read_gt_poses(os.path.join(root, "results", "99.txt"))
        for name, kwargs in (("chunked", dict(chunk_size=KITTI_CHUNK)),
                             ("fused", dict(fused=True))):
            for k in kernels:
                k.launches = 0
            graph, replays = graphs[name], graphs[name].replays
            result = os.path.join(root, f"traj_{name}.txt")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_kitti(root, "99", result, profile="hdl64", **kwargs)
            torch.cuda.synchronize()
            fps[name] = N_FRAMES / (time.perf_counter() - t0)
            replays = graph.replays - replays
            launches[name] = {src: n * replays
                              for src, n in graph.kernel_launches.items()}
            counted = {k.source.name: k.launches for k in kernels}
            if launches[name] != want or counted != wrappers[name]:
                raise AssertionError(
                    f"{name}: {replays} replays made {launches[name]} "
                    f"launches, not {want}; or the wrappers counted "
                    f"{counted}, not {wrappers[name]}")
            est[name] = read_gt_poses(result)
    R, t = gt_to_lidar_frame(gt_cam)
    gt = np.concatenate([R, t[:, :, None]], axis=2)
    ate = {}
    for name, poses in est.items():
        if poses.shape != (N_FRAMES, 3, 4) or not np.isfinite(poses).all():
            raise AssertionError(f"{name}: result file holds {poses.shape}")
        if np.abs(poses[0] - np.eye(4)[:3]).max() > 1e-6:
            raise AssertionError(f"{name}: row 0 is not the identity")
        ate[name] = ate_rmse(poses, gt)
        if ate[name] >= KITTI_ATE_TOL_M:
            raise AssertionError(f"{name}: ATE {ate[name]:.4f} m")
    gap = _check_gap("chunked vs fused file", est["chunked"][:, :, 3],
                     est["fused"][:, :, 3])
    gap9 = _check_gap("fused file vs phase 9", est["fused"][:, :, 3],
                      p9["positions"], POSE_FILE_TOL_M)
    print(f"[10 kitti] {N_FRAMES}-frame KITTI folder -> pose files | chunked "
          f"(K={KITTI_CHUNK}) {fps['chunked']:.2f} frames/s, fused per frame "
          f"{fps['fused']:.2f} frames/s (host wall over all {N_FRAMES} "
          "frames, reader thread and pose writer included, graphs captured "
          f"before) against {p9['fps']:.2f} (phase 9) and {p5['fps']:.2f} "
          f"(phase 5, staged) | ATE chunked {ate['chunked']:.4f} m fused "
          f"{ate['fused']:.4f} m | max |chunked - fused| {gap * 1e3:.4f} mm, "
          f"|fused - fused (phase 9)| {gap9 * 1e3:.4f} mm (limit "
          f"{POSE_FILE_TOL_M * 1e3:g}, the file's digits) "
          f"| launches through graph replays {launches}, by the wrappers "
          f"(the fused run's keyframe stacks) {wrappers['fused']} | peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return dict(launches=wrappers["fused"], graph_launches={
        name: sum(run[name] for run in launches.values())
        for name in launches["chunked"]})


@contextlib.contextmanager
def deterministic_sums():
    """PyTorch's deterministic algorithms (ops that have no deterministic
    version only warn).  The port's float sums are ordered anyway; what the
    setting still changes is which kernels the exact ones (integer sums,
    maxima, one-writer scatters) run.  A graph holds the kernels chosen at
    its capture, so none crosses the border."""
    fused.clear_graphs()
    sharded.clear_graphs()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        fused.clear_graphs()
        sharded.clear_graphs()


def phase_checkpoint(kernels, p5) -> dict:
    """Phase 11, under deterministic sums: save after frame 6, resume in a
    fresh Pipeline, compare frame 7; export the map as PLY.  The
    uninterrupted run repeats phase 5's first 8 frames, with PyTorch's
    default settings: held to that run bitwise."""
    cfg = PROFILES["hdl64"]
    frames = list(synthetic_frames(8, cfg, n_azimuth=1800, speed=1.0, seed=0))
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    a = Pipeline(cfg, device="cuda")
    with tempfile.TemporaryDirectory() as root:
        for _, xyz, mask in frames[:7]:
            a.process_frame(xyz, mask)
        ckpt = os.path.join(root, "frame6.npz")
        t0 = time.perf_counter()
        a.save(ckpt)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(ckpt)
        ra = a.process_frame(*frames[7][1:])
        b = Pipeline(cfg, device="cuda")
        t0 = time.perf_counter()
        b.load(ckpt)
        load_s = time.perf_counter() - t0
        rb = b.process_frame(*frames[7][1:])
        gaps = {name: float(np.abs(getattr(ra, name)
                                   - getattr(rb, name)).max())
                for name in ("odom_q", "odom_t", "map_q", "map_t")}
        if max(gaps.values()) > RESUME_TOL:
            raise AssertionError(f"frame 7 after the resume differs: {gaps}")
        if not np.array_equal(a.mapped_positions()[:7],
                              b.mapped_positions()[:7]):
            raise AssertionError("the mapped history did not survive")
        rerun = _check_gap("phase 11 vs phase 5", a.mapped_positions(),
                           p5["positions"][:8])
        counts = b.export_map(os.path.join(root, "map"))
        for name, store in (("corner", b.map_state.corner),
                            ("surf", b.map_state.surf)):
            with open(os.path.join(root, f"map_{name}.ply")) as f:
                head = [next(f).strip() for _ in range(3)]
            live = int(store.mask.sum())
            if counts[name] != live or head[2] != f"element vertex {live}":
                raise AssertionError(f"{name} PLY: {counts[name]} points, "
                                     f"{head[2]!r}, store holds {live}")
    launches = {k.source.name: k.launches for k in kernels}
    want = expected_launches(cfg, 9, 9)
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    print(f"[11 checkpoint] deterministic sums | saved after frame 6 "
          f"({size / 2**20:.1f} MiB, {save_s:.2f} s), loaded into a fresh "
          f"Pipeline ({load_s:.2f} s) | frame 7 resumed vs uninterrupted, max "
          "abs: " + " ".join(f"{n} {g:.2e}" for n, g in gaps.items())
          + f" (limit {RESUME_TOL}) | max |staged - staged (phase 5, default "
          f"settings)| over 8 frames {rerun * 1e3:.4f} mm (limit 0) | PLY "
          f"points {counts} | "
          f"launches {launches}")
    return launches


def _same_frames(cfg, tag, kernels) -> dict:
    """Phase 5's 12 frames staged, fused per frame and chunked under
    ``cfg``: each run's mapped positions and the staged and fused runs'
    numbers."""
    staged = phase_pipeline(f"12 {tag}, staged", cfg, N_FRAMES,
                            JAX_MAPPED_POSITIONS, kernels)
    per_frame = phase_pipeline(
        f"12 {tag}, fused", dataclasses.replace(cfg, fused_step=True),
        N_FRAMES, JAX_MAPPED_POSITIONS, kernels)
    frames = synthetic_frames(N_FRAMES, cfg, n_azimuth=1800, speed=1.0, seed=0)
    _, _, outs = fused.run_chunked(((xyz, mask) for _, xyz, mask in frames),
                                   cfg, chunk_size=KITTI_CHUNK)
    return dict(staged=staged, fused=per_frame, chunked=outs.map_t)


def phase_repeatable(kernels, p5, p9) -> tuple:
    """Phase 12: the 12 frames staged, fused per frame and chunked, under
    deterministic sums and with PyTorch's default settings (staged twice);
    every run, phase 5's and phase 9's too, bitwise equal to every other.
    Returns the runs of both settings and the default staged and fused
    runs."""
    cfg = PROFILES["hdl64"]
    with deterministic_sums():
        det = _same_frames(cfg, "deterministic", kernels)
    default = _same_frames(cfg, "default settings", kernels)
    again = phase_pipeline("12 default settings, staged again", cfg,
                           N_FRAMES, JAX_MAPPED_POSITIONS, kernels)
    base = default["staged"]["positions"]
    runs = {
        "staged again (default)": again["positions"],
        "fused (default)": default["fused"]["positions"],
        "chunked (default)": default["chunked"],
        "phase 5 (staged, default)": p5["positions"],
        "phase 9 (fused, default)": p9["positions"],
        "staged (deterministic)": det["staged"]["positions"],
        "fused (deterministic)": det["fused"]["positions"],
        "chunked (deterministic)": det["chunked"],
    }
    gaps = {name: _check_gap(f"phase 12 {name} vs staged (default)", pos,
                             base)
            for name, pos in runs.items()}
    print("[12 repeatable] max |run - staged (default settings)|, mm (limit "
          "0: bitwise): " + ", ".join(f"{n} {g * 1e3:.6f}"
                                      for n, g in gaps.items())
          + f" | frames/s staged default {default['staged']['fps']:.2f} and "
          f"{again['fps']:.2f} (phase 5: {p5['fps']:.2f}), deterministic "
          f"{det['staged']['fps']:.2f}; fused default "
          f"{default['fused']['fps']:.2f} (phase 9: {p9['fps']:.2f}), "
          f"deterministic {det['fused']['fps']:.2f} | fused_step ms default "
          f"{default['fused']['stages']['fused_step']:.2f} (phase 9: "
          f"{p9['stages']['fused_step']:.2f}), deterministic "
          f"{det['fused']['stages']['fused_step']:.2f}")
    return (det["staged"], det["fused"], default["staged"], again,
            default["fused"])


# Phase 13: lanes of the batched runs, frames per lane, and the chunked and
# deterministic runs
LANE_COUNTS = (1,) + KERNEL_LANES
LANE_FRAMES = 8
LANE_CHUNK, CHUNK_LANES = 4, 4
DETERMINISTIC_LANES, DETERMINISTIC_FRAMES = 2, 6
# a batched step against the lane's own step from the same state, under
# deterministic sums (m for translations, absolute for quaternion
# components): measured up to 8.8e-4 m and 4.2e-5 at 2 and 4 flagship lanes
# over 6 frames on an H100 80GB HBM3 at 700 W (PERF.md): the batched
# reductions round differently and the float32 plane-fit gates in mapping
# move every step
LANE_STEP_TOL_M, LANE_STEP_TOL_Q = 2e-3, 1e-4


def lane_frames(n_lanes: int, n_frames: int):
    """(xyz (K, B, N, 3), mask (K, B, N)) numpy: lane b is
    ``synthetic_frames(seed=b)``, the flagship run through
    ``World.urban(seed=b)``; lane 0 is phase 5's run."""
    cfg = PROFILES["hdl64"]

    def one(b):
        return list(synthetic_frames(n_frames, cfg, n_azimuth=1800, speed=1.0,
                                     seed=b))

    with concurrent.futures.ThreadPoolExecutor(n_lanes) as pool:
        lanes = list(pool.map(one, range(n_lanes)))
    return (np.stack([[f[1] for f in lane] for lane in lanes], 1),
            np.stack([[f[2] for f in lane] for lane in lanes], 1))


def fused_lane_positions(cfg, xyz, mask) -> tuple:
    """Each lane run alone through the fused single-lane frame: mapped
    positions (B, K, 3) and the launches its replays made."""
    graph = fused.frame_graph(cfg, "cuda")
    replays = graph.replays
    out = []
    for b in range(xyz.shape[1]):
        odo = OdometryState.init(cfg.scan.max_less_sharp,
                                 cfg.scan.max_less_flat, "cuda")
        mp = MappingState.init(cfg.mapping, "cuda")
        rows = []
        for k in range(xyz.shape[0]):
            odo, mp, _, mout, _ = fused.fused_frame_step(
                odo, mp, torch.from_numpy(xyz[k, b]),
                torch.from_numpy(mask[k, b]), cfg)
            rows.append(mout.t_w)
        out.append(torch.stack(rows).cpu().numpy())
    replays = graph.replays - replays
    return np.stack(out), {name: n * replays
                           for name, n in graph.kernel_launches.items()}


def batched_run(kernels, cfg, xyz, mask, keep_steps=False) -> dict:
    """The lanes of ``xyz`` (K, B, N, 3) through ``batched_frame_step``, one
    graph replay per batched frame: positions (B, K, 3), capture seconds,
    stream ms per batched frame, aggregate frames/s over frames 2-K, a
    traced replay's kernels and busy share, and peak memory; with
    ``keep_steps``, per frame the state before it and the outputs.  The
    wrappers must count nothing: every launch is a replay's."""
    K, B = xyz.shape[:2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graph = fused.frame_graph(cfg, "cuda", lanes=B)
    replays = graph.replays
    state = batch.init_batch_state(cfg, B)
    for k in kernels:
        k.launches = 0
    timers = StageTimers(device=True)
    rows, steps = [], []
    torch.cuda.synchronize()
    for i in range(K):
        if i == 1:
            torch.cuda.synchronize()
            timers.reset()
            t1 = time.perf_counter()
        before = state
        with timers.stage("batched_step"):
            state, odo, mout = batch.batched_frame_step(
                state, torch.from_numpy(xyz[i]), torch.from_numpy(mask[i]), cfg)
        rows.append(mout.t_w)
        if keep_steps:
            steps.append((before, step_outputs(odo, mout)))
    positions = torch.stack(rows, 1).cpu().numpy()
    wall_ms = (time.perf_counter() - t1) * 1e3 / (K - 1)
    if any(k.launches for k in kernels):
        raise AssertionError(f"B={B}: the wrappers counted "
                             f"{[k.launches for k in kernels]} during replays")
    replays = graph.replays - replays
    peak = torch.cuda.max_memory_allocated() / 2**20
    traced, n_kernels, kernel_ms, traced_ms, top = replay_kernel_counts(graph)
    want = replay_launches(cfg)
    if graph.kernel_launches != want or traced != want:
        raise AssertionError(
            f"B={B}: one replay should launch {want} for all lanes: the "
            f"wrappers counted {graph.kernel_launches} at capture, a traced "
            f"replay ran {traced}")
    if positions.shape != (B, K, 3) or not np.isfinite(positions).all():
        raise AssertionError(f"B={B}: positions {positions.shape} not finite")
    return dict(
        B=B, positions=positions, warmup_s=graph.warmup_seconds,
        capture_s=graph.capture_seconds,
        stream_ms=timers.device_report()["batched_step"].mean_ms,
        wall_ms=wall_ms, fps=B * 1e3 / wall_ms, n_kernels=n_kernels,
        kernel_ms=kernel_ms, traced_ms=traced_ms, top=top,
        busy=kernel_ms / traced_ms, peak_mib=peak, steps=steps,
        graph_launches={name: n * replays
                        for name, n in graph.kernel_launches.items()})


def step_outputs(odo, mout) -> dict:
    """A step's poses (odometry and mapping quaternion and translation)."""
    return {"odom_q": odo.q_w, "odom_t": odo.t_w, "map_q": mout.q_w,
            "map_t": mout.t_w}


def _lane(tree, b):
    """Lane ``b`` of a state whose leaves carry a leading lane axis."""
    if isinstance(tree, torch.Tensor):
        return tree[b]
    return type(tree)(*(_lane(part, b) for part in tree))


def lane_step_gaps(cfg, xyz, mask, steps) -> dict:
    """Every lane of a batched run stepped alone through the fused
    single-lane frame, each frame from the state the batched run carried
    into it, against the batched step's outputs: the largest gap of each
    pose output over lanes and frames, and the launches the single-lane
    replays made."""
    graph = fused.frame_graph(cfg, "cuda")
    replays = graph.replays
    gaps = dict.fromkeys(("odom_q", "odom_t", "map_q", "map_t"), 0.0)
    for k, (before, batched) in enumerate(steps):
        for b in range(xyz.shape[1]):
            _, _, odo, mout, _ = fused.fused_frame_step(
                _lane(before.odometry, b), _lane(before.mapping, b),
                torch.from_numpy(xyz[k, b]), torch.from_numpy(mask[k, b]), cfg)
            for name, got in step_outputs(odo, mout).items():
                gaps[name] = max(gaps[name], float(
                    (got - batched[name][b]).abs().max()))
    replays = graph.replays - replays
    return gaps, {name: n * replays
                  for name, n in graph.kernel_launches.items()}


def phase_lanes(kernels, p9) -> dict:
    """Phase 13: the batched lanes at B = 1, 4 and 8 against each lane's
    fused single-lane run and the JAX package's positions; the chunked
    batched step; under deterministic sums, 2 lanes step by step against
    each lane stepped alone from the same state, against the same lanes in
    reverse order (1 mm) and against their fused runs (3 cm).  Returns
    the launches made through graph replays."""
    cfg = dataclasses.replace(PROFILES["hdl64"], fused_step=True)
    xyz, mask = lane_frames(max(LANE_COUNTS), LANE_FRAMES)
    alone, graph_launches = fused_lane_positions(cfg, xyz, mask)
    jax_gap = _check_gap("phase 13 lane 0 vs the JAX package's",
                         alone[0], JAX_MAPPED_POSITIONS[:LANE_FRAMES],
                         POSITION_TOL_M)
    runs = []
    for B in LANE_COUNTS:
        run = batched_run(kernels, cfg, xyz[:, :B], mask[:, :B])
        run["jax_gap"] = _check_gap(
            f"B={B} lane 0 vs the JAX package's", run["positions"][0],
            JAX_MAPPED_POSITIONS[:LANE_FRAMES], POSITION_TOL_M)
        run["gap"] = max(_check_gap(f"B={B} lane {b} vs its fused run",
                                    run["positions"][b], alone[b],
                                    LANE_TOL_M)
                         for b in range(B))
        runs.append(run)
        print(f"[13 lanes] B={B}: graph warm-up {run['warmup_s']:.2f} s, "
              f"capture and instantiate {run['capture_s']:.2f} s | "
              f"batched_step {run['stream_ms']:.2f} ms stream, "
              f"{run['wall_ms']:.2f} ms host wall per batched frame (frames "
              f"2-{LANE_FRAMES}) | {run['fps']:.2f} frames/s aggregate "
              f"against {p9['fps']:.2f} fused single-lane (phase 9) | a "
              f"traced replay ran {run['n_kernels']} kernels, "
              f"{run['kernel_ms']:.2f} ms of kernels in {run['traced_ms']:.2f} "
              f"ms wall (busy share of the traced replay {run['busy']:.3f}), "
              "most device time in "
              + ", ".join(f"{name[:48]} {ms:.2f} ms x{n}"
                          for name, ms, n in run["top"])
              + f" | peak memory {run['peak_mib']:.0f} MiB | "
              f"max |lane - its fused run| {run['gap'] * 1e3:.4f} mm, "
              f"|lane 0 - jax| {run['jax_gap'] * 1e3:.4f} mm")
        for name, n in run["graph_launches"].items():
            graph_launches[name] += n

    # chunks of LANE_CHUNK frames over CHUNK_LANES lanes, against the
    # per-frame batched run of the same lanes
    per_frame = next(r for r in runs if r["B"] == CHUNK_LANES)
    xs, ms = (torch.from_numpy(a[:, :CHUNK_LANES]) for a in (xyz, mask))
    graph = fused.frame_graph(cfg, "cuda", chunk=LANE_CHUNK, lanes=CHUNK_LANES)
    replays = graph.replays
    state = batch.init_batch_state(cfg, CHUNK_LANES)
    chunks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k0 in range(0, LANE_FRAMES, LANE_CHUNK):
        state, (_, _, _, map_t) = batch.batched_chunk_step(
            state, xs[k0:k0 + LANE_CHUNK], ms[k0:k0 + LANE_CHUNK], cfg)
        chunks.append(map_t.cpu().numpy())
    chunk_fps = CHUNK_LANES * LANE_FRAMES / (time.perf_counter() - t0)
    chunked = np.concatenate(chunks).transpose(1, 0, 2)
    chunk_gap = max(_check_gap(f"chunked lane {b} vs per-frame batched",
                               chunked[b], per_frame["positions"][b])
                    for b in range(CHUNK_LANES))
    for name, n in graph.kernel_launches.items():
        graph_launches[name] += n * (graph.replays - replays)

    # under deterministic sums, a lane-batching fault apart from the noise:
    # each batched step against the same step of the lane alone, from the
    # state the batched run carried into it (the batched reductions round
    # differently, and over frames the float32 plane-fit gates grow that to
    # mm, so whole runs are held only to LANE_TOL_M); and the same
    # lanes in reverse order must give each lane the same positions (its
    # place and its neighbours must not matter)
    with deterministic_sums():
        d_xyz = xyz[:DETERMINISTIC_FRAMES, :DETERMINISTIC_LANES]
        d_mask = mask[:DETERMINISTIC_FRAMES, :DETERMINISTIC_LANES]
        d_alone, d_launches = fused_lane_positions(cfg, d_xyz, d_mask)
        d_run = batched_run(kernels, cfg, d_xyz, d_mask, keep_steps=True)
        d_steps, step_launches = lane_step_gaps(cfg, d_xyz, d_mask,
                                                d_run.pop("steps"))
        d_flip = batched_run(kernels, cfg, d_xyz[:, ::-1].copy(),
                             d_mask[:, ::-1].copy())
    if (max(d_steps["odom_t"], d_steps["map_t"]) > LANE_STEP_TOL_M
            or max(d_steps["odom_q"], d_steps["map_q"]) > LANE_STEP_TOL_Q):
        raise AssertionError("deterministic sums: a batched step differs from "
                             f"the lane's own step by {d_steps} (limits "
                             f"{LANE_STEP_TOL_M} m, {LANE_STEP_TOL_Q})")
    d_swap = max(_check_gap(f"deterministic lane {b}, lanes reversed",
                            d_flip["positions"][::-1][b],
                            d_run["positions"][b], REPEATABLE_TOL_M)
                 for b in range(DETERMINISTIC_LANES))
    d_gap = max(_check_gap(f"deterministic lane {b} vs its fused run",
                           d_run["positions"][b], d_alone[b], LANE_TOL_M)
                for b in range(DETERMINISTIC_LANES))
    for name in graph_launches:
        graph_launches[name] += (d_launches[name] + d_run["graph_launches"][name]
                                 + step_launches[name]
                                 + d_flip["graph_launches"][name])
    print(f"[13 lanes] chunks of {LANE_CHUNK} frames x {CHUNK_LANES} lanes "
          f"(capture {graph.capture_seconds:.2f} s): {chunk_fps:.2f} frames/s "
          f"aggregate (host wall, all {LANE_FRAMES} frames), max |chunked - "
          f"per-frame batched| {chunk_gap * 1e3:.4f} mm | deterministic sums, "
          f"{DETERMINISTIC_LANES} lanes x {DETERMINISTIC_FRAMES} frames: max "
          f"|batched step - the lane's own step from the same state| "
          + " ".join(f"{n} {g:.3e}" for n, g in d_steps.items())
          + f" (limits {LANE_STEP_TOL_M:g} m, {LANE_STEP_TOL_Q:g}), "
          f"|lane - the same lane with the lanes reversed| "
          f"{d_swap * 1e3:.6f} mm (limit {REPEATABLE_TOL_M * 1e3:g} mm), "
          f"|lane - its fused run| {d_gap * 1e3:.4f} mm, batched_step "
          f"{d_run['stream_ms']:.2f} ms | fused single lanes: |lane 0 - jax| "
          f"{jax_gap * 1e3:.4f} mm | launches through graph replays "
          f"{graph_launches}, none counted by the wrappers")
    return dict(runs=runs, graph_launches=graph_launches, xyz=xyz,
                mask=mask)


# Phase 14: the windowed Schur-complement refinement on a full keyframe
# window (models/pipeline.py keeps the newest 16)
REFINE_FRAMES = 16
REFINE_WINDOWS = (4, 16)
REFINE_LANDMARKS, REFINE_ITERATIONS = 512, 4
REFINE_REPS = 5
# card against the CPU, both in float64: refined t (m) and q, the band of
# tests/test_refine.py:111-112.  In float32 the two devices' results are up
# to 3.2 cm apart on these frames (41 of 512 landmark masks flip with the
# rounding of the ill-conditioned plane fit), and 1.5e-4 from the same
# landmarks; two calls on the card with index_add_'s atomic sums were
# 8.5e-5 apart (an H100 80GB HBM3 at 700 W, PERF.md), with the ordered sums
# they must be bitwise equal
REFINE_CPU_TOL = 1e-4
# recovery: the twin of tests/test_pipeline_guards.py's apply=True test
RECOVERY_K, RECOVERY_SHIFT_M, RECOVERY_NEXT_M = 4, 0.12, 1.5


def _tree_to(tree, device):
    return type(tree)(*(_tree_to(x, device) if isinstance(x, tuple)
                        else x.to(device) for x in tree))


def refine_float64(surf, window, device) -> tuple:
    """``refine_recent_keyframes``' work (extract_landmarks, then
    refine_window) on ``device`` with every float input promoted to
    float64: (q, t) as numpy."""
    def f64(x):
        return x.to(device, torch.float64 if x.is_floating_point()
                    else x.dtype)

    lm = extract_landmarks(f64(surf.xyz), f64(surf.mask), REFINE_LANDMARKS)
    q, t, _ = refine_window(*map(f64, window), lm,
                            n_iterations=REFINE_ITERATIONS)
    return q.cpu().numpy(), t.cpu().numpy()


def _pose_gap(a, b) -> float:
    return max(float(np.abs(a[0] - b[0]).max()),
               float(np.abs(a[1] - b[1]).max()))


def refine_trace(pipe, call) -> tuple:
    """One ``call`` traced through ``StageTimers.profiler_trace`` into a
    temporary directory: (device events, bytes written, the three events
    that take the most device time as (name, ms, count))."""
    with tempfile.TemporaryDirectory() as tmp:
        with pipe.timers.profiler_trace(tmp) as prof:
            call()
            torch.cuda.synchronize()
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, files in os.walk(tmp) for f in files)
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events())
    averages = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.self_device_time_total, reverse=True)
    top = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in averages[:3]]
    return n, size, top


def phase_refine(kernels) -> dict:
    """Phase 14: 16 fused flagship frames fill the keyframe window; then
    ``refine_recent_keyframes`` at K = 4 and 16 (apply=False) is timed, split
    into its parts, traced, held to the same call on the CPU and, under
    deterministic sums, to itself; keyframes corrupted after the fact are
    recovered with apply=True and the next staged and fused frames continue
    from the re-anchored pose; the HTML viewer is written.  Every check
    is made after the phase's line of numbers is printed."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(PROFILES["hdl64"], fused_step=True)
    staged_cfg = PROFILES["hdl64"]
    frames = list(synthetic_frames(REFINE_FRAMES + 2, cfg, n_azimuth=1800,
                                   speed=1.0, seed=0))
    failures = []
    graph = fused.frame_graph(cfg, "cuda")
    replays = graph.replays
    pipe = Pipeline(cfg, device="cuda")
    for k in kernels:
        k.launches = 0
    for _, xyz, mask in frames[:REFINE_FRAMES]:
        pipe.process_frame(xyz, mask)
    positions = pipe.mapped_positions()
    launches = {k.source.name: k.launches for k in kernels}
    replays = graph.replays - replays
    graph_launches = {n: c * replays for n, c in graph.kernel_launches.items()}
    if launches != keyframe_launches(REFINE_FRAMES) or replays != REFINE_FRAMES:
        failures.append(f"fused frames: wrappers counted {launches}, "
                        f"{replays} replays")
    if len(pipe._keyframes) != REFINE_FRAMES:
        failures.append(f"{len(pipe._keyframes)} keyframes buffered")
    jax_gap = float(np.linalg.norm(positions[:N_FRAMES] - JAX_MAPPED_POSITIONS,
                                   axis=1).max())
    if not np.isfinite(positions).all() or jax_gap > POSITION_TOL_M:
        failures.append(f"mapped positions {jax_gap:.4f} m from the JAX "
                        "package's")

    surf = pipe.map_state.surf
    cpu = Pipeline(staged_cfg, device="cpu")
    cpu.map_state = _tree_to(pipe.map_state, "cpu")
    cpu._keyframes = list(pipe._keyframes)
    parts = []
    for K in REFINE_WINDOWS:
        def call(K=K):
            return pipe.refine_recent_keyframes(
                n_keyframes=K, n_landmarks=REFINE_LANDMARKS,
                n_iterations=REFINE_ITERATIONS)

        torch.cuda.reset_peak_memory_stats()
        out = call()
        peak = torch.cuda.max_memory_allocated() / 2**20
        call_ms = _median_ms(call, REFINE_REPS)
        qs, ts, stacks, masks = pipe._window(K)
        lm = extract_landmarks(surf.xyz, surf.mask, REFINE_LANDMARKS)
        lm_ms = _median_ms(lambda: extract_landmarks(
            surf.xyz, surf.mask, REFINE_LANDMARKS), REFINE_REPS)
        win_ms = _median_ms(lambda: refine_window(
            qs, ts, stacks, masks, lm, n_iterations=REFINE_ITERATIONS),
            REFINE_REPS)
        blocks, _ = normal_equations(qs, ts, stacks, masks, lm, lm.n, lm.d,
                                     0.1, 2.0, 1.0)
        schur_ms = _median_ms(lambda: schur_solve(*blocks, damping=1e-4),
                              REFINE_REPS)
        n_events, trace_bytes, top = refine_trace(pipe, call)
        # the card against the CPU from the same map and keyframes.  In
        # float32 the landmark fit and the association gates are decided by
        # rounding (PERF.md), so the call is held to the CPU in float64,
        # where rounding decides nothing, and its float32 gaps are reported
        gap64 = _pose_gap(refine_float64(surf, pipe._window(K), "cuda"),
                          refine_float64(surf, pipe._window(K), "cpu"))
        cpu_gap = _pose_gap(cpu.refine_recent_keyframes(
            n_keyframes=K, n_landmarks=REFINE_LANDMARKS,
            n_iterations=REFINE_ITERATIONS), out)
        lm_cpu = extract_landmarks(surf.xyz.cpu(), surf.mask.cpu(),
                                   REFINE_LANDMARKS)
        mask_flips = int((lm_cpu.mask != lm.mask.cpu()).sum())
        q_w, t_w, _ = refine_window(qs, ts, stacks, masks, lm,
                                    n_iterations=REFINE_ITERATIONS)
        q_c, t_c, _ = refine_window(*(x.cpu() for x in (qs, ts, stacks,
                                                         masks)),
                                    _tree_to(lm, "cpu"),
                                    n_iterations=REFINE_ITERATIONS)
        window_gap = _pose_gap((q_w.cpu().numpy(), t_w.cpu().numpy()),
                               (q_c.numpy(), t_c.numpy()))
        if gap64 > REFINE_CPU_TOL:
            failures.append(f"K = {K}: card against CPU in float64 "
                            f"{gap64:.3e} > {REFINE_CPU_TOL}")
        parts.append(
            f"K = {K}: {call_ms:.3f} ms per call (extract_landmarks "
            f"{lm_ms:.3f}, refine_window {win_ms:.3f}, of it schur_solve "
            f"{schur_ms:.3f} x {REFINE_ITERATIONS}), {int(lm.mask.sum())} "
            f"landmarks, peak memory {peak:.0f} MiB, {n_events} device events "
            f"in a traced call ({trace_bytes / 2**20:.2f} MiB trace), most "
            "device time in " + ", ".join(
                f"{name[:40]} {ms:.3f} ms x{n}" for name, ms, n in top)
            + f", |card - CPU| float64 {gap64:.3e} (limit {REFINE_CPU_TOL:g}); "
            f"float32 {cpu_gap:.3e} ({mask_flips} landmark masks differ), "
            f"{window_gap:.3e} from the card's landmarks")

    # the landmark fit's 5-NN (knn_tiled, torch ops) against the mapping
    # kernel at the same shape: all anchors against the whole surf store
    anchors = extract_landmarks(surf.xyz, surf.mask, REFINE_LANDMARKS).anchor
    counts = torch.tensor([anchors.shape[0], surf.xyz.shape[0]],
                          dtype=torch.int32, device=anchors.device)
    tiled_ms = _median_ms(lambda: knn_tiled(anchors, surf.xyz, surf.mask, 5,
                                            tile=4096), REFINE_REPS)
    knn5_ms = _median_ms(lambda: knn5(anchors, surf.xyz, surf.mask, counts),
                         REFINE_REPS)
    d_t, _ = knn_tiled(anchors, surf.xyz, surf.mask, 5, tile=4096)
    d_k, _ = knn5(anchors, surf.xyz, surf.mask, counts)
    live = d_t < 1e20
    knn_gap = float((d_t - d_k)[live].abs().max()) if live.any() else 0.0
    parts.append(f"landmark 5-NN, {anchors.shape[0]} anchors x "
                 f"{surf.xyz.shape[0]} map points: knn_tiled {tiled_ms:.3f} "
                 f"ms, knn5 {knn5_ms:.3f} ms per call (max |d| gap "
                 f"{knn_gap:.2e} m^2)")

    # repeatability: two calls on the same inputs
    call16 = functools.partial(pipe.refine_recent_keyframes,
                               n_keyframes=REFINE_WINDOWS[-1],
                               n_landmarks=REFINE_LANDMARKS,
                               n_iterations=REFINE_ITERATIONS)
    first, second = call16(), call16()
    default_gap = _pose_gap(first, second)
    if not all(np.array_equal(x, y) for x, y in zip(first, second)):
        failures.append(f"default settings: two calls differ by "
                        f"{default_gap:.3e}")
    with deterministic_sums():
        a, b = call16(), call16()
    bitwise = all(np.array_equal(x, y) for x, y in zip(a, b))
    if not bitwise:
        failures.append(f"deterministic sums: two calls differ by "
                        f"{_pose_gap(a, b):.3e}")
    det_gap = _pose_gap(first, a)

    # recovery, then the next staged and fused frames
    clean = pipe.mapped_positions().copy()
    rng = np.random.default_rng(0)
    base = len(pipe._keyframes) - (RECOVERY_K - 1)
    rows = []
    for i in range(RECOVERY_K - 1):
        kf = pipe._keyframes[base + i]
        t_bad = (kf[1] + rng.uniform(-RECOVERY_SHIFT_M, RECOVERY_SHIFT_M,
                                     3)).astype(np.float32)
        pipe._keyframes[base + i] = (kf[0], t_bad, *kf[2:])
        pipe._map_trajectory[kf[4]] = t_bad
        rows.append(kf[4])
    corrupt = pipe.mapped_positions().copy()
    _, t_ref = pipe.refine_recent_keyframes(
        n_keyframes=RECOVERY_K, n_landmarks=REFINE_LANDMARKS,
        n_iterations=REFINE_ITERATIONS, apply=True)
    refined = pipe.mapped_positions()
    err_c = np.abs(corrupt[rows] - clean[rows]).mean(axis=0)
    err_r = np.abs(refined[rows] - clean[rows]).mean(axis=0)
    if not (err_r.sum() < 0.8 * err_c.sum() and err_r[2] < 0.2 * err_c[2]
            and (err_r[:2] < err_c[:2] * 1.3 + 0.01).all()):
        failures.append(f"recovery: error {err_r} after, {err_c} before")
    graph = fused.frame_graph(cfg, "cuda")
    replays = graph.replays
    for k in kernels:
        k.launches = 0
    pipe.cfg = staged_cfg
    staged = pipe.process_frame(*frames[REFINE_FRAMES][1:])
    next_staged = float(np.linalg.norm(staged.map_t - t_ref[-1]))
    pipe.cfg = cfg
    step_launches = {k.source.name: k.launches for k in kernels}
    if step_launches != expected_launches(staged_cfg, 1, 1):
        failures.append(f"staged frame launched {step_launches}")
    # a fused frame straight after an apply: the graph must take the
    # re-anchored state, not replay its own buffers' stale correction
    _, t_ref = pipe.refine_recent_keyframes(
        n_keyframes=RECOVERY_K, n_landmarks=REFINE_LANDMARKS,
        n_iterations=REFINE_ITERATIONS, apply=True)
    fused_r = pipe.process_frame(*frames[REFINE_FRAMES + 1][1:])
    next_fused = float(np.linalg.norm(fused_r.map_t - t_ref[-1]))
    for r, gap in ((staged, next_staged), (fused_r, next_fused)):
        if not (r.mapped and np.isfinite(r.map_t).all()
                and gap < RECOVERY_NEXT_M):
            failures.append(f"frame {r.frame} after apply=True: {r.map_t}, "
                            f"{gap:.4f} m from the refined pose")
    if graph.replays - replays != 1:
        failures.append("the fused frame after apply=True was not one replay")
    for name in launches:
        launches[name] += step_launches[name]
        graph_launches[name] += graph.kernel_launches[name]

    with tempfile.TemporaryDirectory() as tmp:
        html = os.path.getsize(export_pipeline_html(
            pipe, os.path.join(tmp, "view.html")))
    print("[14 refine] " + " | ".join(parts)
          + f" | {REFINE_WINDOWS[-1]} keyframes, two calls: default settings "
          f"{default_gap:.3e} apart, deterministic sums bitwise equal "
          f"{bitwise}, the two settings {det_gap:.3e} apart | recovery (K = {RECOVERY_K}, {RECOVERY_K - 1} "
          f"keyframes shifted up to {RECOVERY_SHIFT_M} m): mean |error| per "
          f"axis {np.round(err_c, 5).tolist()} -> {np.round(err_r, 5).tolist()}"
          f" m; next staged frame {next_staged:.4f} m and fused frame "
          f"{next_fused:.4f} m from the refined pose (limit "
          f"{RECOVERY_NEXT_M} m) | {REFINE_FRAMES} fused frames, max |mapped "
          f"- jax| {jax_gap:.4f} m over the first {N_FRAMES} | viewer "
          f"{html} bytes | launches counted by the wrappers {launches}, "
          f"through graph replays {graph_launches} | phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("phase 14: " + "; ".join(failures))
    return dict(launches=launches, graph_launches=graph_launches, pipe=pipe)


# Phase 15: the multi-device paths (light_loam_tpu_torch/parallel/), each
# rank a process spawned after phase 2 with one card, loading the libraries
# phase 2 built.  Phase 5's 12 frames, phase 6's vote over 10, phase 13's
# lanes (4 per rank) and phase 14's 16-keyframe window.
SHARD_FRAMES = N_FRAMES
SHARD_LANES_PER_RANK = 4
# one sharded step from the single-device state against the single-device
# step: tests/test_sharded.py's bounds (t_w in m; surf factors within
# max(5, 3 %), map surf points within max(10, 2 %))
SHARD_STEP_TOL_M = 2e-2
# the sharded refinement in float64 against the single call on cuda:0 (the
# float32 landmark fit is decided by rounding; phase 14)
SHARD_REFINE_TOL = 1e-9
# the captured sharded step against its eager body, both under deterministic
# sums (tests/test_torch_cuda.py's GRAPH_ATOL for the fused frame's graph;
# bitwise equality expected, reported)
SHARD_GRAPH_TOL = 1e-5
PROBE_REPLAYS = 10
SHARD_TIMEOUT_S = 600
# Mapped positions (m) of the JAX package's sharded_mapping_step on a mesh of
# n virtual CPU devices, mapping the JAX pipeline's own mapping inputs of the
# 12 flagship frames from an empty map, produced by:
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/jax_sharded_positions.py
JAX_SHARDED_POSITIONS = {
    1: np.array([
        [0.0, 0.0, 0.0],
        [0.9995206594467163, 0.02170042134821415, 0.0015200147172436118],
        [2.003796100616455, 0.04250028356909752, 0.001778800506144762],
        [3.0113422870635986, 0.06793145835399628, 0.0038703822065144777],
        [4.018343448638916, 0.08942994475364685, 0.002571233082562685],
        [5.003924369812012, 0.11174213141202927, 0.003016623668372631],
        [6.017598628997803, 0.12591886520385742, 0.003155415179207921],
        [7.022066116333008, 0.143201544880867, 0.0037113570142537355],
        [8.00963306427002, 0.16212058067321777, 0.00319398520514369],
        [9.005278587341309, 0.18893280625343323, 0.006241403520107269],
        [10.001440048217773, 0.2046716958284378, 0.005014450289309025],
        [11.005671501159668, 0.23489657044410706, 0.006110792513936758],
    ]),
    2: np.array([
        [0.0, 0.0, 0.0],
        [0.9995206594467163, 0.021700426936149597, 0.0015200148336589336],
        [2.0043203830718994, 0.042197033762931824, 0.0016247539315372705],
        [3.0100831985473633, 0.0681348368525505, 0.0019999428186565638],
        [4.012101173400879, 0.08930271118879318, 0.0005446510622277856],
        [4.9991350173950195, 0.11169404536485672, 0.0036999848671257496],
        [6.013247013092041, 0.1269041895866394, 0.004337724298238754],
        [7.017674922943115, 0.14698010683059692, 0.004580153152346611],
        [8.005496978759766, 0.16499021649360657, 0.003932006191462278],
        [9.000838279724121, 0.19011178612709045, 0.0071573881432414055],
        [9.996777534484863, 0.21143494546413422, 0.004815253429114819],
        [10.999781608581543, 0.2377360463142395, 0.0047035603784024715],
    ]),
    4: np.array([
        [0.0, 0.0, 0.0],
        [0.9995206594467163, 0.021700430661439896, 0.0015200143679976463],
        [2.003887176513672, 0.042131587862968445, 0.001659236615523696],
        [3.0094821453094482, 0.06597725301980972, 0.0016376589192077518],
        [4.0143303871154785, 0.08888303488492966, 0.00134658208116889],
        [4.999653339385986, 0.11178642511367798, 0.0036574387922883034],
        [6.012421607971191, 0.12917128205299377, 0.003141168737784028],
        [7.016554832458496, 0.1440865844488144, 0.0038172707427293062],
        [8.004632949829102, 0.16305240988731384, 0.0033194769639521837],
        [9.00131893157959, 0.18916703760623932, 0.005360455252230167],
        [9.99581241607666, 0.20671941339969635, 0.005731390789151192],
        [11.001856803894043, 0.23486120998859406, 0.004893721546977758],
    ]),
}


def shard_runs(cards: int) -> list:
    """(backend, n, device of each rank): NCCL at world 1 always; then 4 or
    2 ranks on as many cards over NCCL, or, on one card, where NCCL refuses
    a second rank, 2 gloo ranks both on cuda:0."""
    runs = [("nccl", 1, ("cuda:0",))]
    if cards >= 2:
        n = 4 if cards >= 4 else 2
        runs.append(("nccl", n, tuple(f"cuda:{i}" for i in range(n))))
    else:
        runs.append(("gloo", 2, ("cuda:0", "cuda:0")))
    return runs


def topo_links(devices) -> str:
    """``nvidia-smi topo -m``'s link between each pair of the cards used."""
    proc = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines:
        return (f"not available (exit {proc.returncode}: "
                f"{(proc.stderr or proc.stdout).strip()[:200]})")
    header = [h.strip() for h in lines[0].split("\t")]
    rows = {line.split("\t")[0].strip(): [c.strip() for c in line.split("\t")]
            for line in lines[1:] if line.startswith("GPU")}
    used = sorted({torch.device(d).index for d in devices})
    if len(used) == 1:
        return f"GPU{used[0]} alone ({' '.join(rows.get(f'GPU{used[0]}', [])[:2])})"
    return ", ".join(
        f"GPU{a}-GPU{b} {rows[f'GPU{a}'][header.index(f'GPU{b}')]}"
        for i, a in enumerate(used) for b in used[i + 1:])


def _to_npz(out: dict, prefix: str, tree) -> None:
    """Tensors of nested NamedTuples into ``out`` under dotted names."""
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
        return
    for name, x in tree._asdict().items():
        _to_npz(out, f"{prefix}.{name}", x)


def _from_npz(z, prefix: str, like, device):
    """The inverse of ``_to_npz``, shaped like ``like``, on ``device``."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(z[prefix]).to(device)
    return type(like)(*(_from_npz(z, f"{prefix}.{name}", x, device)
                        for name, x in like._asdict().items()))


def record_mapping_inputs(frames, device="cuda") -> tuple:
    """The staged flagship run over ``frames`` with every ``mapping_step``
    call recorded: ([(state before, corner_last, surf_last, q_odom, t_odom,
    output)], the pipeline)."""
    cfg = PROFILES["hdl64"]
    calls = []
    real = pipeline_module.mapping_step

    def record(state, corner, surf, q_odom, t_odom, mcfg):
        new_state, out = real(state, corner, surf, q_odom, t_odom, mcfg)
        calls.append((state, corner, surf, q_odom, t_odom, out))
        return new_state, out

    pipeline_module.mapping_step = record
    try:
        pipe = Pipeline(cfg, device=device)
        for i, (_, xyz, mask) in enumerate(frames):
            pipe.process_frame(xyz, mask)
            if i == 0:  # steady state: later frames only
                torch.cuda.synchronize()
                pipe.timers.reset()
        torch.cuda.synchronize()
    finally:
        pipeline_module.mapping_step = real
    if len(calls) != len(frames):
        raise AssertionError(f"{len(calls)} of {len(frames)} frames mapped")
    return calls, pipe


def _mapping_refs(out: dict, prefix: str, states, outs) -> None:
    for k, (state, mout) in enumerate(zip(states, outs)):
        _to_npz(out, f"{prefix}{k}.state", state)
        _to_npz(out, f"{prefix}{k}.out", mout)


def shard_inputs(path, calls, lane_xyz, lane_mask, lane_refs, window,
                 landmarks, refined) -> None:
    """Everything the ranks need, in one ``.npz``: the odometry's mapping
    inputs of each frame, the single-device states and outputs (the map
    vote's too), the lanes and their unsharded positions, and the float64
    refinement window, landmarks and single-call result."""
    out = {}
    for k, (_, corner, surf, q_odom, t_odom, _) in enumerate(calls):
        _to_npz(out, f"in{k}.corner", corner)
        _to_npz(out, f"in{k}.surf", surf)
        out[f"in{k}.q"] = q_odom.cpu().numpy()
        out[f"in{k}.t"] = t_odom.cpu().numpy()
    _mapping_refs(out, "base", [c[0] for c in calls], [c[5] for c in calls])
    vcfg = mapping_vote_config().mapping
    state = MappingState.init(vcfg, calls[0][4].device)
    states, outs = [], []
    for _, corner, surf, q_odom, t_odom, _ in calls[:VOTE_N_FRAMES]:
        states.append(state)
        state, mout = mapping.mapping_step(state, corner, surf, q_odom,
                                           t_odom, vcfg)
        outs.append(mout)
    _mapping_refs(out, "vote", states, outs)
    out["lanes.xyz"], out["lanes.mask"] = lane_xyz, lane_mask
    for B, positions in lane_refs.items():
        out[f"lanes.ref{B}"] = positions
    for name, x in zip(("q", "t", "stacks", "masks"), window):
        out[f"window.{name}"] = x.cpu().numpy()
    _to_npz(out, "landmarks", landmarks)
    out["window.q_ref"], out["window.t_ref"] = refined
    np.savez(path, **out)


class _LastCall:
    """Wraps a module attribute and keeps the arguments of its last call."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.args = None
        setattr(module, name, self)

    def __call__(self, *args):
        self.args = args
        return self.real(*args)

    def restore(self):
        setattr(self.module, self.name, self.real)


def _timed(fn):
    """(fn's result, its stream ms from CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _sharded_steps(group, z, cfg, prefix, n_frames, inputs, failures,
                   free=False) -> dict:
    """``n_frames`` sharded steps: each from the resharded single-device
    state ``prefix``k (held to that state's single-device step), or, with
    ``free``, from an empty map; the rank-0 positions, ms per step, the
    largest gaps and the collectives of one step."""
    like = MappingState.init(cfg)
    empty = MappingState.init(cfg, group.device)
    state = shard_mapping_state(empty, group, cfg) if free else None
    ms, positions, gaps, poses_equal = [], [], [0.0, 0, 0], True
    overflow = [0, 0]
    for k in range(n_frames):
        if not free:
            state = shard_mapping_state(
                _from_npz(z, f"{prefix}{k}.state", like, group.device),
                group, cfg)
        before = (group.collectives, group.bytes)
        (state, out), step_ms = _timed(lambda: sharded_mapping_step(
            state, *inputs[k], cfg, group))
        per_step = (group.collectives - before[0], group.bytes - before[1])
        ms.append(step_ms)
        pose = torch.cat([out.q_w, out.t_w])
        all_poses = group.all_gather(pose[None])
        poses_equal &= bool((all_poses == pose).all())
        positions.append(out.t_w.cpu().numpy())
        overflow = [max(overflow[0], int(out.local_overflow)),
                    max(overflow[1], int(out.stack_overflow))]
        if free:
            continue
        t_ref = z[f"{prefix}{k}.out.t_w"]
        gap = float(np.linalg.norm(positions[-1] - t_ref))
        sf, sf_ref = int(out.surf_factors), int(z[f"{prefix}{k}.out.surf_factors"])
        mp, mp_ref = (int(out.map_surf_points),
                      int(z[f"{prefix}{k}.out.map_surf_points"]))
        gaps = [max(gaps[0], gap), max(gaps[1], abs(sf - sf_ref)),
                max(gaps[2], abs(mp - mp_ref))]
        if (gap > SHARD_STEP_TOL_M or abs(sf - sf_ref) > max(5, 0.03 * sf_ref)
                or abs(mp - mp_ref) > max(10, 0.02 * mp_ref)):
            failures.append(f"{prefix} frame {k}: t_w {gap:.4f} m, surf "
                            f"factors {sf} vs {sf_ref}, map surf points {mp} "
                            f"vs {mp_ref}")
    if not poses_equal:
        failures.append(f"{prefix}: the ranks' poses differ")
    return dict(ms=ms, positions=np.stack(positions).tolist(), gaps=gaps,
                collectives=per_step[0], bytes=per_step[1],
                overflow=overflow)


def nccl_capture_probe(group, cfg, replays: int = PROBE_REPLAYS) -> dict:
    """NCCL capture with nothing around it: a bare all-gather (the sharded
    step's gather of stacks and local maps, (rows / n, 4) float32 from each
    rank) and an all-reduce (the LM step's packed H and g, 42 float32) on
    the group's NCCL process group, past ``ShardGroup``'s size-1 shortcuts,
    run once eagerly (NCCL's communicator and connections), captured once
    and replayed ``replays`` times on new inputs, every result checked
    exactly (integer-valued floats).  At world 1 the only NCCL capture a
    one-card machine runs."""
    dev, n, rank = group.device, group.size, group.rank
    rows = (cfg.stack_corner_capacity + cfg.stack_surf_capacity
            + cfg.local_corner_capacity + cfg.local_surf_capacity) // n
    x = torch.zeros((rows, 4), device=dev)
    gathered = torch.empty((n * rows, 4), device=dev)
    r = torch.zeros(42, device=dev)
    reduced = torch.empty_like(r)

    def collectives():
        sharded._all_gather_single(gathered, x, group=group.group)
        reduced.copy_(r)
        dist.all_reduce(reduced, group=group.group)

    collectives()
    torch.cuda.synchronize(dev)
    if n > 1:
        dist.barrier(group=group.group, device_ids=[dev.index])
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            collectives()
        capture_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)  # the same draws on every rank
        ranks = torch.arange(n, device=dev, dtype=torch.float32)
        wrong = 0
        for _ in range(replays):
            base = torch.randint(0, 1 << 16, (rows, 4), generator=gen,
                                 device=dev).float()
            base_r = torch.randint(0, 1 << 16, (42,), generator=gen,
                                   device=dev).float()
            x.copy_(base + rank)
            r.copy_(base_r + rank)
            graph.replay()
            want = (base[None] + ranks[:, None, None]).reshape(n * rows, 4)
            wrong += int((gathered != want).sum())
            wrong += int((reduced != n * base_r + ranks.sum()).sum())
    finally:
        # a graph that holds the group's collectives must go before the
        # group (sharded.clear_graphs)
        torch.cuda.synchronize(dev)
        graph.reset()
    return dict(rows=rows, replays=replays, capture_s=capture_s, wrong=wrong)


def _captured_vs_eager(group, z, cfg, inputs, failures) -> dict:
    """Under deterministic sums, each of phase 5's steps from its resharded
    single-device state through the captured step (``sharded_mapping_step``
    on the NCCL group, captured at the first) and through its eager body:
    the largest gap over the new state and the outputs (held to
    SHARD_GRAPH_TOL, the integer leaves equal), whether every leaf was
    bitwise equal, and ms per step of each (CUDA events)."""
    like = MappingState.init(cfg)
    ms_graph, ms_eager, gap, bitwise = [], [], 0.0, True
    with deterministic_sums():
        for k in range(SHARD_FRAMES):
            state = shard_mapping_state(
                _from_npz(z, f"base{k}.state", like, group.device), group, cfg)
            graph_out, t_graph = _timed(lambda: sharded_mapping_step(
                state, *inputs[k], cfg, group))
            eager_out, t_eager = _timed(lambda: _sharded_step_body(
                state, *inputs[k], cfg, group))
            ms_graph.append(t_graph)
            ms_eager.append(t_eager)
            for a, b in zip(fused._leaves(graph_out), fused._leaves(eager_out)):
                bitwise &= bool(torch.equal(a, b))
                if a.is_floating_point():
                    gap = max(gap, float((a - b).abs().max()))
                elif not torch.equal(a, b):
                    failures.append(f"captured vs eager step, frame {k}: an "
                                    "integer leaf differs")
    if gap > SHARD_GRAPH_TOL:
        failures.append(f"captured vs eager step: {gap:.3e} apart (> "
                        f"{SHARD_GRAPH_TOL:g})")
    return dict(gap=gap, bitwise=bitwise, ms_graph=ms_graph,
                ms_eager=ms_eager)


def _rank_lanes(group, z, failures) -> dict:
    """This rank's B/n lanes of phase 13's frames through the lane-sharded
    batched step (one graph replay per batched frame on its card); every
    lane within 3 cm of the same lane unsharded; host wall per frame."""
    cfg = dataclasses.replace(PROFILES["hdl64"], fused_step=True)
    B = SHARD_LANES_PER_RANK * group.size
    xyz, mask = z["lanes.xyz"][:, :B], z["lanes.mask"][:, :B]
    K = xyz.shape[0]
    state = init_sharded_batch_state(cfg, B, group)
    graph = fused.frame_graph(cfg, group.device, lanes=B // group.size)
    replays = graph.replays
    rows = []
    for i in range(K):
        if i == 1:
            group.all_reduce(torch.ones(1, device=group.device))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        dx, dm = put_frames(xyz[i], mask[i], group)
        state, _, mout = sharded_batched_frame_step(state, dx, dm, cfg)
        rows.append(mout.t_w)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3 / (K - 1)
    positions = gather_lanes(torch.stack(rows, 1), group).cpu().numpy()
    gap = float(np.linalg.norm(positions - z[f"lanes.ref{B}"], axis=-1).max())
    if not np.isfinite(positions).all() or gap > LANE_TOL_M:
        failures.append(f"lanes: {gap:.4f} m from the unsharded lanes")
    replays = graph.replays - replays
    return dict(B=B, wall_ms=wall_ms, gap=gap, capture_s=graph.capture_seconds,
                launches={name: c * replays
                          for name, c in graph.kernel_launches.items()})


def _rank_refine(group, z, failures) -> dict:
    """Phase 14's window in float64, its keyframes split over the ranks
    through ``refine_hooks``, against the single call on cuda:0."""
    dev = group.device
    window = [torch.from_numpy(z[f"window.{name}"]).to(dev)
              for name in ("q", "t", "stacks", "masks")]
    k = window[0].shape[0] // group.size
    local = [x[group.rank * k:(group.rank + 1) * k] for x in window]
    lm = _from_npz(z, "landmarks",
                   PlaneLandmarks(*(torch.zeros(1) for _ in range(4))), dev)
    q, t, _ = refine_window(*local, lm, n_iterations=REFINE_ITERATIONS,
                            **refine_hooks(group, k))
    gap = max(float(np.abs(group.all_gather(q).cpu().numpy()
                           - z["window.q_ref"]).max()),
              float(np.abs(group.all_gather(t).cpu().numpy()
                           - z["window.t_ref"]).max()))
    if not gap <= SHARD_REFINE_TOL:
        failures.append(f"refinement: {gap:.3e} from the single call")
    return dict(keyframes=k, gap=gap)


def _rank_kernels(knn_call, vote_call, sums_call, failures) -> dict:
    """One knn5, one compat_votes and one segment_sum call of this rank's
    runs, at the shapes the rank gave them, held to their plain versions as
    phases 3-4 and 3c do."""
    values, seg, S = sums_call
    sums_err = _segsum_err(segment_sum(values, seg, S), values, seg, S)
    if sums_err != 0.0:
        failures.append(f"segment_sum: {sums_err:.3g} from the plain version")
    query, ref, mask, counts = knn_call
    d_k, i_k = knn5(query, ref, mask, counts)
    d_p, i_p = knn5_plain(query, ref, mask, counts)
    knn_err, swaps = _check_knn(query, ref, d_k, i_k, d_p, i_p)
    v_k = compat_votes(*vote_call)
    diff = (v_k - compat_votes_plain(*vote_call)).abs()
    frac = (diff > 0).float().mean().item()
    if diff.max().item() > VOTE_MAX_DIFF or frac >= VOTE_MAX_FRAC:
        failures.append(f"compat_votes: max diff {diff.max().item()}, "
                        f"differing fraction {frac}")
    qc, rc = (int(c) for c in counts.cpu())
    return dict(knn_shape=[query.shape[0], ref.shape[0], qc, rc],
                knn_err=knn_err, knn_swaps=swaps,
                vote_shape=list(vote_call[0].shape[:2]),
                vote_err=diff.max().item(),
                sums_shape=[*values.shape, S], sums_err=sums_err)


def shard_rank(rank, backend, n, devices, init_method, npz_path, out_dir):
    """One rank of phase 15 (spawned): its group, the sharded mapping steps,
    the free run and the vote run, its lanes, its keyframes of the
    refinement and one call of each kernel; writes its numbers and any
    failed check to ``out_dir``."""
    for k in (KNN5, VOTE, SEGSUM):
        if not k.library_path().exists():
            raise RuntimeError(f"rank {rank}: {k.source.name} was not built "
                               "by phase 2")
    stage_path = os.path.join(out_dir, f"{backend}-{n}-rank{rank}.stage")

    def stage(name):
        """Record what this rank is doing: a rank that times out names it."""
        with open(stage_path, "w") as f:
            f.write(name)

    stage("joining the group")
    group = make_group(n, rank, backend, init_method, device=devices[rank])
    try:
        z = np.load(npz_path)
        dev = group.device
        cfg, vcfg = PROFILES["hdl64"].mapping, mapping_vote_config().mapping
        cloud = PointCloud.zeros(1)
        inputs = [(_from_npz(z, f"in{k}.corner", cloud, dev),
                   _from_npz(z, f"in{k}.surf", cloud, dev),
                   torch.from_numpy(z[f"in{k}.q"]).to(dev),
                   torch.from_numpy(z[f"in{k}.t"]).to(dev))
                  for k in range(SHARD_FRAMES)]
        failures = []
        torch.cuda.reset_peak_memory_stats(dev)
        # the lanes first: their graph is captured before the group has run
        # any collective
        stage("lanes")
        lanes = _rank_lanes(group, z, failures)
        stage("NCCL capture probe")
        probe = nccl_capture_probe(group, cfg) if group.captures else None
        if probe and probe["wrong"]:
            failures.append(f"NCCL capture probe: {probe['wrong']} values "
                            "wrong")
        knn_call = _LastCall(mapping, "knn5")
        vote_call = _LastCall(graphvote, "compat_votes")
        sums_call = _LastCall(voxel_module, "segment_sum")
        try:
            # on NCCL every step is a replay: both steps are captured before
            # the counts start (the wrappers count the warm-up and the
            # capture pass), and the last calls recorded are the vote
            # step's capture, on buffers its replays fill
            widths = (inputs[0][0].xyz.shape[0], inputs[0][1].xyz.shape[0])
            stage("warm-up and capture of the sharded steps")
            graphs = {name: sharded.sharded_graph(c, group, *widths)
                      for name, c in (("base", cfg), ("vote", vcfg))
                      if group.captures}
            replays = {name: g.replays for name, g in graphs.items()}
            for k in (KNN5, VOTE, SEGSUM):
                k.launches = 0
            stage("sharded steps")
            steps = _sharded_steps(group, z, cfg, "base", SHARD_FRAMES,
                                   inputs, failures)
            free = _sharded_steps(group, z, cfg, "free", SHARD_FRAMES, inputs,
                                  failures, free=True)
            vote = _sharded_steps(group, z, vcfg, "vote", VOTE_N_FRAMES,
                                  inputs, failures)
            launches = {k.source.name: k.launches
                        for k in (KNN5, VOTE, SEGSUM)}
        finally:
            knn_call.restore()
            vote_call.restore()
            sums_call.restore()
        graph_launches = dict.fromkeys(launches, 0)
        for name, g in graphs.items():
            replays[name] = g.replays - replays[name]
            for src, c in g.kernel_launches.items():
                graph_launches[src] += c * replays[name]
        # segment_sum: each step's two owned-stack downsamples and two
        # store re-sorts
        want = {"knn.cu": 2 * cfg.outer_iterations
                * (2 * SHARD_FRAMES + VOTE_N_FRAMES),
                "vote.cu": vcfg.outer_iterations * VOTE_N_FRAMES,
                "segsum.cu": 4 * (2 * SHARD_FRAMES + VOTE_N_FRAMES)}
        total = {name: launches[name] + graph_launches[name] for name in want}
        if total != want or (graphs and any(launches.values())):
            failures.append(f"launches {launches} by the wrappers and "
                            f"{graph_launches} through replays, expected "
                            f"{want} in all ({'none' if graphs else 'all'} "
                            "by the wrappers)")
        graph_info = {name: dict(
            warmup_s=g.warmup_seconds, capture_s=g.capture_seconds,
            collectives=g.collectives, bytes=g.bytes,
            launches=g.kernel_launches, replays=replays[name])
            for name, g in graphs.items()}
        stage("refinement")
        refine = _rank_refine(group, z, failures)
        kernels = _rank_kernels(knn_call.args, vote_call.args,
                                sums_call.args, failures)
        stage("captured against eager step")
        det = (_captured_vs_eager(group, z, cfg, inputs, failures)
               if group.captures and n == 1 else None)
        result = dict(rank=rank, device=str(dev), steps=steps, free=free,
                      vote=vote, lanes=lanes, refine=refine, kernels=kernels,
                      launches=launches, graph_launches=graph_launches,
                      graphs=graph_info, det=det, probe=probe,
                      failures=failures,
                      peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20)
        with open(os.path.join(out_dir, f"{backend}-{n}-rank{rank}.json"),
                  "w") as f:
            json.dump(result, f)
    finally:
        sharded.clear_graphs()
        dist.destroy_process_group()


def spawn_ranks(backend, n, devices, npz_path, out_dir) -> list:
    """Phase 15's ranks: ``n`` spawned processes, one card each; a rank that
    fails fails the phase, and one still running after SHARD_TIMEOUT_S is
    killed and fails it.  Returns each rank's numbers in rank order."""
    init_method = f"file://{out_dir}/rdzv-{backend}-{n}"
    ctx = torch.multiprocessing.start_processes(
        shard_rank, args=(backend, n, devices, init_method, npz_path, out_dir),
        nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + SHARD_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                stages = []
                for r in range(n):
                    path = os.path.join(out_dir, f"{backend}-{n}-rank{r}.stage")
                    if os.path.exists(path):
                        with open(path) as f:
                            stages.append(f"rank {r}: {f.read()}")
                raise TimeoutError(f"phase 15: {backend} ranks still running "
                                   f"after {SHARD_TIMEOUT_S} s ("
                                   + "; ".join(stages) + ")")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = []
    for r in range(n):
        with open(os.path.join(out_dir, f"{backend}-{n}-rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def phase_sharded(kernels, p5=None, p13=None, p14=None) -> dict:
    """Phase 15: the multi-device paths on the card(s), run by spawned ranks
    (``shard_rank``) from the single-device references made here: phase
    5's frames staged with every mapping call recorded, the map vote's
    single-device run over them, the lanes' unsharded runs (phase 13's
    where it ran the same B) and phase 14's window refined in float64.
    Returns the launches the ranks counted (wrappers) and made through
    their lane graphs' replays."""
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    runs = shard_runs(cards)
    print(f"[15 sharded] {cards} card(s) visible; runs: " + "; ".join(
        f"{b} n={n} on {', '.join(devices)}" for b, n, devices in runs)
        + f" | NCCL {torch.cuda.nccl.version()} (capture needs >= 2.9.6)"
        + f" | nvidia-smi topo -m: {topo_links(runs[-1][2])}"
        + (" | one card: NCCL refuses two ranks on one card, so the second "
           "run is 2 gloo ranks both on cuda:0 (the exchange runs through "
           "the host); the exchange across cards was not measured on this "
           "machine" if cards < 2 else ""))

    frames = list(synthetic_frames(SHARD_FRAMES, PROFILES["hdl64"],
                                   n_azimuth=1800, speed=1.0, seed=0))
    calls, rec = record_mapping_inputs(frames)
    single_ms = rec.timers.device_report()["mapping"].mean_ms
    fcfg = dataclasses.replace(PROFILES["hdl64"], fused_step=True)
    max_b = SHARD_LANES_PER_RANK * max(n for _, n, _ in runs)
    if p13 is not None and p13["xyz"].shape[1] >= max_b:
        lane_xyz, lane_mask = p13["xyz"][:, :max_b], p13["mask"][:, :max_b]
    else:
        lane_xyz, lane_mask = lane_frames(max_b, LANE_FRAMES)
    done = {r["B"]: r for r in (p13["runs"] if p13 else [])}
    lane_refs = {}
    for _, n, _ in runs:
        B = SHARD_LANES_PER_RANK * n
        if B not in done:
            done[B] = batched_run(kernels, fcfg, lane_xyz[:, :B],
                                  lane_mask[:, :B])
        lane_refs[B] = done[B]["positions"]
    if p14 is None:
        pipe = Pipeline(fcfg, device="cuda")
        for _, xyz, mask in synthetic_frames(REFINE_FRAMES, fcfg,
                                             n_azimuth=1800, speed=1.0,
                                             seed=0):
            pipe.process_frame(xyz, mask)
    else:
        pipe = p14["pipe"]
    surf = pipe.map_state.surf
    window = [x.to(torch.float64) if x.is_floating_point() else x
              for x in pipe._window(REFINE_FRAMES)]
    landmarks = extract_landmarks(surf.xyz.double(), surf.mask,
                                  REFINE_LANDMARKS)
    q_ref, t_ref, _ = refine_window(*window, landmarks,
                                    n_iterations=REFINE_ITERATIONS)

    names = ("knn.cu", "vote.cu", "segsum.cu")
    launches = dict.fromkeys(names, 0)
    lane_launches = dict.fromkeys(names, 0)
    graph_launches = dict.fromkeys(names, 0)
    captured_ms = {}
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "inputs.npz")
        shard_inputs(npz, calls, lane_xyz, lane_mask, lane_refs, window,
                     landmarks, (q_ref.cpu().numpy(), t_ref.cpu().numpy()))
        prep_s = time.perf_counter() - t_phase
        for backend, n, devices in runs:
            t_run = time.perf_counter()
            ranks = spawn_ranks(backend, n, devices, npz, tmp)
            run_s = time.perf_counter() - t_run
            r0 = ranks[0]
            free = np.array(r0["free"]["positions"])
            jax_gap = float(np.linalg.norm(free - JAX_SHARDED_POSITIONS[n],
                                           axis=1).max())
            if not np.isfinite(free).all() or jax_gap > POSITION_TOL_M:
                failures.append(f"{backend} n={n}: free run {jax_gap:.4f} m "
                                "from the JAX package's sharded run")
            for r in ranks:
                failures += [f"{backend} n={n} rank {r['rank']}: {f}"
                             for f in r["failures"]]
                for name in launches:
                    launches[name] += r["launches"][name]
                    lane_launches[name] += r["lanes"]["launches"][name]
                    graph_launches[name] += r["graph_launches"][name]
            B = r0["lanes"]["B"]
            lane_fps = B * 1e3 / max(r["lanes"]["wall_ms"] for r in ranks)
            b4 = done.get(4)
            st = r0["steps"]
            print(
                f"[15 sharded] {backend} n={n} ({run_s:.1f} s) | per step "
                f"from the single-device state, {SHARD_FRAMES} frames: max "
                f"|t_w - single| {st['gaps'][0] * 1e3:.4f} mm (limit "
                f"{SHARD_STEP_TOL_M * 1e3:g}), max |surf factors - single| "
                f"{st['gaps'][1]}, max |map surf points - single| "
                f"{st['gaps'][2]}, local_overflow {st['overflow'][0]}, "
                f"stack_overflow {st['overflow'][1]} | ms per sharded step on "
                f"rank 0 (CUDA events, median of frames 2-{SHARD_FRAMES}): "
                f"from a resharded state {statistics.median(st['ms'][1:]):.2f}, "
                f"free run {statistics.median(r0['free']['ms'][1:]):.2f}, "
                f"vote {statistics.median(r0['vote']['ms'][1:]):.2f}, against "
                f"the single-device mapping stage {single_ms:.2f} (staged "
                f"stream ms, this phase's recording run"
                + (f"; phase 5: {p5['stages']['mapping']:.2f}" if p5 else "")
                + f") | collectives per "
                f"step {st['collectives']} ({st['bytes'] / 2**20:.3f} MiB sent "
                f"by each rank), vote mode {r0['vote']['collectives']} "
                f"({r0['vote']['bytes'] / 2**20:.3f} MiB) | free run from an "
                f"empty map: max |mapped - JAX sharded n={n}| "
                f"{jax_gap * 1e3:.4f} mm (limit {POSITION_TOL_M * 1e3:g}) | "
                f"vote mode per step: max |t_w - single| "
                f"{r0['vote']['gaps'][0] * 1e3:.4f} mm, surf factors "
                f"{r0['vote']['gaps'][1]} | lanes: B={B} ({B // n} per rank), "
                f"max |lane - unsharded| {max(r['lanes']['gap'] for r in ranks) * 1e3:.4f} "
                f"mm, {lane_fps:.2f} frames/s aggregate (host wall, frames "
                f"2-{LANE_FRAMES})"
                + (f" against {b4['fps']:.2f} at B=4 on one card (phase 13)"
                   if b4 else "")
                + f" | refinement, {REFINE_FRAMES} keyframes "
                f"({r0['refine']['keyframes']} per rank), float64: max "
                f"|sharded - single| {max(r['refine']['gap'] for r in ranks):.3e} "
                f"(limit {SHARD_REFINE_TOL:g}) | kernels on each rank against "
                "their plain versions: " + ", ".join(
                    f"rank {r['rank']} knn5 (Q, N, qc, rc) = "
                    f"{tuple(r['kernels']['knn_shape'])} max_abs_err "
                    f"{r['kernels']['knn_err']:.3g} tie_swaps "
                    f"{r['kernels']['knn_swaps']}, compat_votes (R, K) = "
                    f"{tuple(r['kernels']['vote_shape'])} max_abs_err "
                    f"{r['kernels']['vote_err']:.3g}, segment_sum (N, C, S) = "
                    f"{tuple(r['kernels']['sums_shape'])} max_abs_err "
                    f"{r['kernels']['sums_err']:.3g}" for r in ranks)
                + " | launches counted by each rank's wrappers "
                + ", ".join(str(r["launches"]) for r in ranks)
                + ", through its lane graph's replays "
                + ", ".join(str(r["lanes"]["launches"]) for r in ranks)
                + " | peak memory per rank "
                + ", ".join(f"{r['peak_mib']:.0f}" for r in ranks) + " MiB")
            print(f"[15 sharded] {backend} n={n} " + shard_graph_line(
                ranks, n, captured_ms, SHARD_FRAMES))
    print(f"[15 sharded] phase {time.perf_counter() - t_phase:.1f} s "
          f"(references and inputs {prep_s:.1f} s)")
    if failures:
        raise AssertionError("phase 15: " + "; ".join(failures))
    return dict(launches=launches, lane_launches=lane_launches,
                graph_launches=graph_launches)


def shard_graph_line(ranks, n, captured_ms, n_frames) -> str:
    """Phase 15's numbers of the captured step of one run: per rank its
    warm-up and capture seconds, the collectives, MiB and kernel launches
    counted at capture and the replays; at NCCL n = 1 the captured step
    against the eager body under deterministic sums and the capture probe;
    at n > 1 t1 / (n tn) of the captured step.  A gloo run says it ran
    eagerly.  Records rank 0's ms per captured step in ``captured_ms``."""
    r0 = ranks[0]
    if not r0["graphs"]:
        return ("eager: gloo's collectives run through the host and cannot "
                "be captured, so every step ran the eager body")
    med = statistics.median(r0["steps"]["ms"][1:])
    captured_ms[n] = med
    parts = ["captured, one replay per step: " + "; ".join(
        f"{name}: warm-up " + "/".join(
            f"{r['graphs'][name]['warmup_s']:.2f}" for r in ranks)
        + " s, capture " + "/".join(
            f"{r['graphs'][name]['capture_s']:.2f}" for r in ranks)
        + f" s (per rank), {g['collectives']} collectives "
        f"{g['bytes'] / 2**20:.3f} MiB and launches {g['launches']} per "
        f"replay, {g['replays']} replays"
        for name, g in r0["graphs"].items())]
    probe = r0["probe"]
    parts.append(
        f"NCCL capture probe (bare all-gather of ({probe['rows']}, 4) float32 "
        f"a rank and all-reduce of 42, past the size-1 shortcuts): capture "
        f"{probe['capture_s']:.3f} s, {probe['replays']} replays, "
        f"{probe['wrong']} values wrong")
    det = r0["det"]
    if det:
        parts.append(
            f"under deterministic sums, {n_frames} steps from the resharded "
            f"states: captured vs eager body max |diff| {det['gap']:.3e} "
            f"(limit {SHARD_GRAPH_TOL:g}; bitwise {det['bitwise']}), ms per "
            f"step (CUDA events, median of frames 2-{n_frames}) captured "
            f"{statistics.median(det['ms_graph'][1:]):.2f} against eager "
            f"{statistics.median(det['ms_eager'][1:]):.2f}")
    if n > 1 and 1 in captured_ms:
        parts.append(
            f"t1 / (n tn) of the captured step {captured_ms[1] / (n * med):.3f}"
            f" ({captured_ms[1]:.2f} ms at n = 1, {med:.2f} at n = {n})")
    return " | ".join(parts)


def phase_runs(kernels) -> tuple:
    """Phase 16: phase 5's frames with the "runs" less-flat downsample,
    staged and fused, each held to the JAX package's runs-mode positions
    and to each other; frame 0's less-flat live count in both modes (the
    JAX package's test expects a few % more in "runs": one centroid per
    visit of a voxel)."""
    cfg = runs_config()
    _, xyz, mask = next(iter(synthetic_frames(1, cfg, n_azimuth=1800,
                                              speed=1.0, seed=0)))
    xyz, mask = torch.as_tensor(xyz).cuda(), torch.as_tensor(mask).cuda()
    live = {mode: int(extract_features(xyz, mask, c.scan).less_flat.mask.sum())
            for mode, c in (("exact", PROFILES["hdl64"]), ("runs", cfg))}
    ratio = live["runs"] / live["exact"]
    if not 0.97 <= ratio <= 1.10:
        raise AssertionError(f"phase 16: less-flat live count {live} (runs / "
                             f"exact {ratio:.4f}, the JAX test's band "
                             "0.97-1.10)")
    staged = phase_pipeline("16 runs mode", cfg, N_FRAMES,
                            JAX_RUNS_MAPPED_POSITIONS, kernels)
    fcfg = dataclasses.replace(cfg, fused_step=True)
    graph = fused.frame_graph(fcfg, "cuda")
    per_frame = phase_pipeline("16 runs mode", fcfg, N_FRAMES,
                               JAX_RUNS_MAPPED_POSITIONS, kernels)
    gap = _check_gap("phase 16 fused vs staged", per_frame["positions"],
                     staged["positions"])
    print(f"[16 runs mode] frame 0 less-flat live points: exact "
          f"{live['exact']}, runs {live['runs']} (runs / exact {ratio:.4f}) "
          f"| fused graph: warm-up {graph.warmup_seconds:.2f} s, capture "
          f"{graph.capture_seconds:.2f} s | max |fused - staged| "
          f"{gap * 1e3:.4f} mm (limit 0: ordered sums)"
          f" | stream ms staged " + " ".join(
              f"{n} {ms:.2f}" for n, ms in sorted(staged["stages"].items()))
          + f", fused_step {per_frame['stages']['fused_step']:.2f} | frames/s "
          f"staged {staged['fps']:.2f}, fused {per_frame['fps']:.2f}")
    return staged, per_frame


# the kernels' names in the JSON line, by source
KERNEL_NAMES = (("knn5", "knn.cu"), ("compat_votes", "vote.cu"),
                ("segment_sum", "segsum.cu"))


def segsum_json(sums, launches, graph_launches, lane_launches, p15) -> dict:
    """The segment_sum entry of the kernels line: the numbers of its
    costliest main-path site (the surf store's full re-sort) at the top,
    every site under ``shapes`` (with its lanes), the launches of the
    main-path phases."""
    site = max(sums.values(), key=lambda v: v["N"] * v["C"]
               if v["site"].startswith("_merge_full") else 0)
    return {
        "name": "segment_sum", "route": "cuda",
        "source": "light_loam_tpu_torch/csrc/segsum.cu",
        "replaces": "no Pallas kernel: the float index_add_ of "
                    "light_loam_tpu_torch/ops/voxel.py, ops/sorted_store.py "
                    "and models/refine.py (the JAX package's scatter-adds, "
                    "light_loam_tpu/ops/voxel.py:106, "
                    "light_loam_tpu/ops/sorted_store.py:125,128, "
                    "light_loam_tpu/models/refine.py:186,189,196)",
        "launches": launches["segsum.cu"],
        "graph_launches": graph_launches["segsum.cu"],
        "lane_launches": lane_launches["segsum.cu"],
        "sharded_launches": p15["launches"]["segsum.cu"],
        "sharded_graph_launches": p15["graph_launches"]["segsum.cu"],
        "sharded_lane_launches": p15["lane_launches"]["segsum.cu"],
        "max_abs_err": max([v["max_abs_err"] for v in sums.values()]
                           + [v["lanes"]["max_abs_err"] for v in sums.values()
                              if "lanes" in v]),
        "ms": site["ms"], "plain_ms": site["plain_ms"],
        "device_ms": site["device_ms"], "bound_ms": site["bound_ms"],
        "bound_by": site["bound_by"],
        "library_ms": site["library_ms"]["index_add_"],
        "library": site["library_ms"],
        "longest_live_segment": max(v["longest_live_segment"]
                                    for v in sums.values()),
        "shapes": list(sums.values())}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on the "
                                 "card(s): phases 1-16 (module docstring).")
    ap.add_argument("--only-sharded", action="store_true",
                    help="phases 1, 2 and 15 only: phase 15 makes its own "
                    "references (for a run on several cards)")
    args = ap.parse_args(argv)
    smi = phase_device()
    dev = torch.device("cuda", 0)
    kernels = (KNN5, VOTE, SEGSUM)
    phase_build(kernels)
    if args.only_sharded:
        p15 = phase_sharded(kernels)
        print(json.dumps({"kernels": [
            {"name": name, "sharded_launches": p15["launches"][src],
             "sharded_graph_launches": p15["graph_launches"][src],
             "sharded_lane_launches": p15["lane_launches"][src]}
            for name, src in KERNEL_NAMES
        ]}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    knn = phase_knn(dev)
    knn_lanes = phase_knn_lanes(dev)
    vote = phase_vote(dev)
    vote_lanes = phase_vote_lanes(dev)
    sums = phase_segsum(dev)
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
    p9 = phase_fused(kernels, p5)
    phase_merge_calls(p9["pipe"])
    p10 = phase_kitti(kernels, p5, p9)
    with deterministic_sums():
        p11 = phase_checkpoint(kernels, p5)
    p12 = phase_repeatable(kernels, p5, p9)
    p13 = phase_lanes(kernels, p9)
    p14 = phase_refine(kernels)
    p15 = phase_sharded(kernels, p5, p13, p14)
    p16 = phase_runs(kernels)
    runs = (p5, p6, p7, p8, p9, p10, p14) + p12 + p16
    launches = {name: sum(p["launches"][name] for p in runs) + p11[name]
                for name in p5["launches"]}
    graph_launches = {name: sum(p["graph_launches"][name] for p in runs)
                      for name in p5["launches"]}
    lane_launches = p13["graph_launches"]

    surf = knn[("surf", "below")]
    odo = vote[VOTE_SHAPES[0]]
    knn_err = max([v["err"] for v in knn.values()]
                  + [v["max_abs_err"] for v in knn_lanes.values()])
    print(json.dumps({"kernels": [
        {"name": "knn5", "route": "cuda",
         "source": "light_loam_tpu_torch/csrc/knn.cu",
         "replaces": "light_loam_tpu/ops/pallas_knn.py:69",
         "launches": launches["knn.cu"],
         "graph_launches": graph_launches["knn.cu"], "max_abs_err": knn_err,
         "ms": surf["ms"], "plain_ms": surf["plain_ms"],
         "device_ms": surf["device_ms"], "bound_ms": surf["bound_ms"],
         "bound_by": surf["bound_by"], "library_ms": None,
         "shapes": [
             {k: v[k] for k in ("Q", "N", "qc", "rc", "ms", "plain_ms",
                                "device_ms", "bound_ms", "bound_by")}
             | {"max_abs_err": v["err"]}
             for (_, case), v in knn.items() if case == "below"],
         "lane_launches": lane_launches["knn.cu"],
         "sharded_launches": p15["launches"]["knn.cu"],
         "sharded_graph_launches": p15["graph_launches"]["knn.cu"],
         "sharded_lane_launches": p15["lane_launches"]["knn.cu"],
         "lanes": [
             {k: v[k] for k in ("B", "Q", "N", "counts", "max_abs_err",
                                "tie_swaps", "ms", "plain_ms", "device_ms",
                                "singles_device_ms", "bound_ms", "bound_by")}
             for v in knn_lanes.values()]},
        {"name": "compat_votes", "route": "cuda",
         "source": "light_loam_tpu_torch/csrc/vote.cu",
         "replaces": "light_loam_tpu/ops/pallas_vote.py:33",
         "launches": launches["vote.cu"],
         "graph_launches": graph_launches["vote.cu"],
         "max_abs_err": max([v["err"] for v in vote.values()]
                            + [v["max_abs_err"] for v in vote_lanes.values()]),
         "ms": odo["ms"], "plain_ms": odo["plain_ms"],
         "device_ms": odo["device_ms"], "bound_ms": odo["bound_ms"],
         "bound_by": odo["bound_by"], "library_ms": None,
         "shapes": [
             {"R": R, "K": K, "max_abs_err": v["err"], "ms": v["ms"],
              "plain_ms": v["plain_ms"], "device_ms": v["device_ms"],
              "plain_device_ms": v["plain_device_ms"],
              "bound_ms": v["bound_ms"], "bound_by": v["bound_by"]}
             for (R, K), v in vote.items()],
         "lane_launches": lane_launches["vote.cu"],
         "sharded_launches": p15["launches"]["vote.cu"],
         "sharded_graph_launches": p15["graph_launches"]["vote.cu"],
         "sharded_lane_launches": p15["lane_launches"]["vote.cu"],
         "lanes": [
             {k: v[k] for k in ("B", "R", "K", "max_abs_err", "ms",
                                "plain_ms", "device_ms", "plain_device_ms",
                                "singles_device_ms", "bound_ms", "bound_by")}
             for v in vote_lanes.values()]},
        segsum_json(sums, launches, graph_launches, lane_launches, p15),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
