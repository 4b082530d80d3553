"""The staged frame's three stages, each one captured CUDA graph.

The JAX package runs its default frame (``PipelineConfig.fused_step`` off)
as three jitted programs, ``extract_features``, ``odometry_step`` and
``mapping_step``, with the host's divergence check, mapping back-pressure
and keyframe stack between them (light_loam_tpu/models/pipeline.py).  Here
each stage is one ``StageGraph``: static input buffers, one warm-up pass
on a side stream, one capture, and per call a copy of the caller's inputs
into the buffers, one replay and clones of the outputs.  So the stages stay
functions of their arguments, and the Pipeline's state is ordinary tensors
that checkpoints, refinement and the divergence repair may read or replace
between frames; a pending asynchronous mapping step holds clones, which the
next replay cannot overwrite.  All replays queue on the current stream, as
the JAX package's programs queue on its device.

On the CPU the same classes run the stage's body on their static buffers
without a capture, so the copy-in / clone-out route runs there too.
``eager()`` runs the stages op by op instead (the counterpart of
``jax.disable_jit()``): tests and the smoke run hold each graph to it.  It
is not a fallback: a capture or replay that fails raises.

The odometry body sweeps every tile of the tiled surf search
(``read_live_count=False``), the device-side form of the eager stage's one
host read (models/odometry.py), which finds the same matches.

The capture machinery here (``CapturedStep``, ``HostStaging``) is shared
with the fused frame (models/fused.py).  Each run records spans into the
``StageTimers`` whose stage is open (utils/timing.py): ``<stage>.copy_in``
(the inputs into the static buffers, pinned staging included),
``<stage>.launch`` (the ``replay()`` call; on a card, on the device, from
just before it to the graph's first node: the launch wait),
``<stage>.graph`` (on a card only: the graph's first node to its last,
marked by two timing events captured into it) and ``<stage>.clone_out``
(the clones of the outputs).  On the CPU ``<stage>.launch`` times the body.
The mapping body's phases (``mapping.search``, ``mapping.solve``,
``mapping.merge``, models/mapping.py) are timing events captured into the
mapping graph, so each replay gives their device ms too; on the CPU they
are spans of the body.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Tuple

import torch

from light_loam_tpu_torch.config import PipelineConfig, ScanConfig
from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.core.frame import PointCloud, RangeImage, ScanFeatures
from light_loam_tpu_torch.models.mapping import MappingState, mapping_step
from light_loam_tpu_torch.models.odometry import OdometryState, odometry_step
from light_loam_tpu_torch.ops.cuda_features import FEATURES
from light_loam_tpu_torch.ops.cuda_knn import KNN5
from light_loam_tpu_torch.ops.cuda_segsum import SEGSUM
from light_loam_tpu_torch.ops.cuda_vote import VOTE
from light_loam_tpu_torch.ops.features import extract_features
from light_loam_tpu_torch.solver.gauss_newton import LM
from light_loam_tpu_torch.utils.timing import GraphMarks, span, untimed

# eager passes of a step before its capture: they build the kernels at
# first use and let the allocator, cuBLAS and cuSOLVER set up their handles
# and workspaces outside the capture
WARMUP_PASSES = 1

STAGES = ("features", "odometry", "mapping")


def _leaves(tree) -> list:
    """Tensors of nested NamedTuples, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for part in tree for leaf in _leaves(part)]


def _clone(tree):
    """Copies of the tensors of nested tuples and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    parts = [_clone(part) for part in tree]
    return tuple(parts) if type(tree) is tuple else type(tree)(*parts)


class HostStaging:
    """Device buffers filled from the host through pinned memory, so the
    copy to the card does not wait for the host; the copy of the previous
    call must be done before its pinned memory is reused."""

    def __init__(self, *buffers: torch.Tensor):
        self.buffers = buffers
        self._pinned = [torch.zeros(b.shape, dtype=b.dtype).pin_memory()
                        for b in buffers]
        self._staged = None

    def load(self, *values: torch.Tensor) -> None:
        if values[0].is_cuda:
            for buf, value in zip(self.buffers, values):
                buf.copy_(value)
            return
        if self._staged is not None:
            self._staged.synchronize()
        for pinned, value in zip(self._pinned, values):
            pinned.copy_(value)
        for buf, pinned in zip(self.buffers, self._pinned):
            buf.copy_(pinned, non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record()


class CapturedStep:
    """A step on static buffers captured once as a CUDA graph on
    ``self.device``.  A subclass allocates its buffers, defines ``_step``
    (one pass of the step on them) and ``_reset`` (puts them back before
    each warm-up pass and before the capture), then calls ``_capture``.

    ``kernel_launches`` is what the hand-written kernels' wrappers counted
    while the step was captured, so what one replay launches; a replay goes
    past the wrappers and leaves their own counts alone.  ``marks`` are the
    graph's first and last nodes, two timing events, and the events of the
    ``phase``s of the step (utils/timing.py); replay through
    ``marks.replay(self.graph, name)``.  The warm-up and the capture record
    nothing into the timers of the stage that captures the step."""

    kernels = (KNN5, VOTE, SEGSUM, LM, FEATURES)

    def _step(self):
        raise NotImplementedError

    def _reset(self) -> None:
        pass

    def _capture(self) -> None:
        """Warm up on a side stream, then capture one step.  The warm-up
        runs on the static buffers as allocated (empty frames from the
        initial state), which every call overwrites with the caller's, so
        it advances no run."""
        with untimed():
            self._warm_up_and_capture()

    def _warm_up_and_capture(self) -> None:
        main = torch.cuda.current_stream(self.device)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_PASSES):
                self._reset()
                self._step()
        main.wait_stream(side)
        self._reset()
        torch.cuda.synchronize(self.device)
        self.warmup_seconds = time.perf_counter() - t0

        before = [k.launches for k in self.kernels]
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        self.marks = GraphMarks()
        with torch.cuda.graph(self.graph), self.marks.capturing():
            self.marks.first.record()
            self.last = self._step()
            self.marks.last.record()
        self.capture_seconds = time.perf_counter() - t0
        self.kernel_launches = {k.source.name: k.launches - b
                                for k, b in zip(self.kernels, before)}


# -- the stage bodies: what one replay runs on the static inputs -----------

def _features_body(xyz, mask, cfg: PipelineConfig):
    return extract_features(xyz, mask, cfg.scan)


def _odometry_body(state, feats, cfg: PipelineConfig):
    return odometry_step(state, feats, cfg.odometry, cfg.scan.scan_period,
                         read_live_count=False)


def _mapping_body(state, corner_last, surf_last, q_w, t_w,
                  cfg: PipelineConfig):
    return mapping_step(state, corner_last, surf_last, q_w, t_w, cfg.mapping)


def features_zeros(scan: ScanConfig, device) -> ScanFeatures:
    """An empty frame's features, at the shapes ``extract_features``
    returns under ``scan``."""
    R, H = scan.n_scans, scan.h_max
    return ScanFeatures(
        full=RangeImage(
            xyz=torch.zeros((R, H, 3), device=device),
            rel=torch.zeros((R, H), device=device),
            mask=torch.zeros((R, H), dtype=torch.bool, device=device),
            counts=torch.zeros(R, dtype=torch.int32, device=device)),
        sharp=PointCloud.zeros(scan.max_sharp, device),
        less_sharp=PointCloud.zeros(scan.max_less_sharp, device),
        flat=PointCloud.zeros(scan.max_flat, device),
        less_flat=PointCloud.zeros(R * (scan.max_less_flat // R), device),
    )


def _stage_inputs(stage: str, cfg: PipelineConfig, device) -> tuple:
    scan = cfg.scan
    if stage == "features":
        return (torch.zeros((scan.max_points, 3), device=device),
                torch.zeros(scan.max_points, dtype=torch.bool, device=device))
    if stage == "odometry":
        return (OdometryState.init(scan.max_less_sharp, scan.max_less_flat,
                                   device),
                features_zeros(scan, device))
    return (MappingState.init(cfg.mapping, device),
            PointCloud.zeros(scan.max_less_sharp, device),
            PointCloud.zeros(scan.max_less_flat, device),
            quat.quat_identity(device=device),
            torch.zeros(3, device=device))


_BODIES = {"features": _features_body, "odometry": _odometry_body,
           "mapping": _mapping_body}


class StageGraph(CapturedStep):
    """One stage of the staged frame under ``cfg`` on ``device``, on static
    input buffers: captured as a CUDA graph on a card, its body run on the
    buffers on the CPU.  ``run`` copies the caller's inputs in, replays (or
    runs the body) and returns clones of the outputs.  Frames come to the
    features stage from the host through pinned memory.  ``replays`` counts
    the calls."""

    def __init__(self, stage: str, cfg: PipelineConfig, device):
        self.stage, self.cfg = stage, cfg
        self.device = torch.device(device)
        self.inputs = _stage_inputs(stage, cfg, self.device)
        self._body = _BODIES[stage]
        on_card = self.device.type == "cuda"
        self._staging = (HostStaging(*self.inputs)
                         if on_card and stage == "features" else None)
        self.graph = None
        self.last = None           # the outputs of the last step
        self.replays = 0
        self.kernel_launches: Dict[str, int] = {}
        self.warmup_seconds = self.capture_seconds = 0.0
        if on_card:
            with torch.cuda.device(self.device):
                self._capture()

    def _step(self):
        return self._body(*self.inputs, self.cfg)

    def run(self, *args):
        """The stage from ``args`` (the stage function's arguments before
        its config): returns copies of its outputs."""
        static, leaves = _leaves(self.inputs), _leaves(args)
        if len(leaves) != len(static):
            raise ValueError(f"{self.stage} stage: {len(leaves)} input "
                             f"tensors, the stage takes {len(static)}")
        for dst, src in zip(static, leaves):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(
                    f"{self.stage} stage: input {tuple(src.shape)} "
                    f"{src.dtype} does not match the static buffer "
                    f"{tuple(dst.shape)} {dst.dtype}")
        with span(self.stage + ".copy_in"):
            if self._staging is not None:
                self._staging.load(*args)
            else:
                for dst, src in zip(static, leaves):
                    dst.copy_(src, non_blocking=True)
        if self.graph is None:
            with span(self.stage + ".launch"):
                self.last = self._step()
        else:
            self.marks.replay(self.graph, self.stage)
        self.replays += 1
        with span(self.stage + ".clone_out"):
            return _clone(self.last)


def stage_key(stage: str, cfg: PipelineConfig) -> tuple:
    """The parts of ``cfg`` a stage's body and buffers read: configs that
    differ elsewhere (fused_step, sync_mapping, skip_frame_num, ...) share
    the stage's graph."""
    if stage == "features":
        return (stage, cfg.scan)
    if stage == "odometry":
        return (stage, cfg.scan, cfg.odometry)
    return (stage, cfg.scan, cfg.mapping)


_GRAPHS: Dict[tuple, StageGraph] = {}


def stage_graph(stage: str, cfg: PipelineConfig, device) -> StageGraph:
    """The stage of (cfg, device), captured at first use.  A failed capture
    raises and leaves nothing behind."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = stage_key(stage, cfg) + (device,)
    if key not in _GRAPHS:
        _GRAPHS[key] = StageGraph(stage, cfg, device)
    return _GRAPHS[key]


def stage_graphs(cfg: PipelineConfig, device) -> Tuple[StageGraph, ...]:
    """The three stages of (cfg, device), captured now where not yet."""
    return tuple(stage_graph(stage, cfg, device) for stage in STAGES)


def clear_graphs() -> None:
    """Drop every stage graph and the device memory it holds."""
    _GRAPHS.clear()


_EAGER = False


@contextlib.contextmanager
def eager():
    """Run the staged path op by op inside the block, the stage functions
    called as they are, with no static buffers (``jax.disable_jit()``'s
    counterpart)."""
    global _EAGER
    before, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = before


def run_features(xyz, mask, cfg: PipelineConfig, device) -> ScanFeatures:
    """``extract_features`` of one frame (host arrays or tensors) on
    ``device``."""
    xyz = torch.as_tensor(xyz, dtype=torch.float32)
    mask = torch.as_tensor(mask, dtype=torch.bool)
    if _EAGER:
        return extract_features(xyz.to(device), mask.to(device), cfg.scan)
    return stage_graph("features", cfg, device).run(xyz, mask)


def run_odometry(state: OdometryState, feats: ScanFeatures,
                 cfg: PipelineConfig):
    """``odometry_step`` from ``state``: (new state, output)."""
    if _EAGER:
        return odometry_step(state, feats, cfg.odometry,
                             cfg.scan.scan_period)
    return stage_graph("odometry", cfg, state.q_w.device).run(state, feats)


def run_mapping(state: MappingState, corner_last: PointCloud,
                surf_last: PointCloud, q_w: torch.Tensor, t_w: torch.Tensor,
                cfg: PipelineConfig):
    """``mapping_step`` from ``state``: (new state, output)."""
    if _EAGER:
        return mapping_step(state, corner_last, surf_last, q_w, t_w,
                            cfg.mapping)
    return stage_graph("mapping", cfg, q_w.device).run(
        state, corner_last, surf_last, q_w, t_w)
