"""Whole-frame SLAM step as ONE device program — the latency mode.

Counterpart of ``light_loam_tpu/models/fused.py``.  The staged pipeline
(models/pipeline.py) enqueues tens of thousands of small kernels per frame
and reads the odometry pose back to the host between odometry and mapping,
so on the card the host sets the pace.  Here the whole frame — features →
odometry → divergence containment → mapping — is one function without a
host read (``_fused_frame_body``), which on CUDA tensors is captured once
per (config, device) into a ``torch.cuda.CUDAGraph`` and replayed: one
graph launch per frame.  On CPU tensors the same body simply runs.

Semantics match the staged path, including the divergence containment that
pipeline.py performs on the host: a non-finite odometry translation keeps
the previous world pose, resets the warm-start increment to identity, and
feeds the contained pose to mapping.  Here that policy is a ``torch.where``
on the device.  The one host decision of the staged stages is replaced by
a device-side equivalent that gives the same result: the tiled surf search
sweeps every tile (``read_live_count=False``).  The mapping step reads
nothing to the host on either path.

A graph replays on the buffers it was captured on (``FrameGraph``): the
caller's states and frames are copied into its static buffers, the
captured step writes the new state back over the old one and its outputs
into row ``index`` of per-chunk buffers, and copies of the results are
handed back.  So the entry points stay functions of their arguments, and K
frames of a chunk replay back to back with no host read between them.  The
same class captures the batched lanes of models/batch.py: given a lane count
B, its frames, states and output rows carry a lane axis after the chunk
axis, and the captured step is the vmapped body over all B lanes.

On CUDA a capture that fails raises; there is no eager fallback.  The
staged path remains the default and is required for async mapping and for
the non-mapping frames of ``skip_frame_num > 1``.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from light_loam_tpu_torch.config import PipelineConfig
from light_loam_tpu_torch.models.mapping import (
    MappingOutput,
    MappingState,
    mapping_step,
)
from light_loam_tpu_torch.models.odometry import (
    OdometryOutput,
    OdometryState,
    odometry_step,
)
from light_loam_tpu_torch.ops.cuda_knn import KNN5
from light_loam_tpu_torch.ops.cuda_segsum import SEGSUM
from light_loam_tpu_torch.ops.cuda_vote import VOTE
from light_loam_tpu_torch.ops.features import extract_features

# eager passes of the step before its capture: they build the kernels at
# first use and let the allocator, cuBLAS and cuSOLVER set up their handles
# and workspaces outside the capture
WARMUP_PASSES = 1


def _fused_frame_body(
    odo_state: OdometryState,
    map_state: MappingState,
    xyz: torch.Tensor,   # (max_points, 3)
    mask: torch.Tensor,  # (max_points,)
    cfg: PipelineConfig,
) -> Tuple[OdometryState, MappingState, OdometryOutput, MappingOutput,
           torch.Tensor]:
    """One full SLAM frame without a host read (the body shared by the
    per-frame and chunked entry points); returns (..., diverged) where
    ``diverged`` is a bool scalar for the host's failure counter."""
    feats = extract_features(xyz, mask, cfg.scan)
    prev_q, prev_t = odo_state.q_w, odo_state.t_w
    odo_state, odo = odometry_step(
        odo_state, feats, cfg.odometry, cfg.scan.scan_period,
        read_live_count=False,
    )

    # Divergence containment on the device (the staged path's host policy:
    # the check is on the translation, the warm start resets to identity,
    # the feature-cloud swap is kept).
    finite = torch.isfinite(odo.t_w).all()
    q_w = torch.where(finite, odo_state.q_w, prev_q)
    t_w = torch.where(finite, odo_state.t_w, prev_t)
    identity = torch.cat([torch.zeros_like(odo_state.q_lc[:3]),
                          torch.ones_like(odo_state.q_lc[3:])])
    odo_state = odo_state._replace(
        q_w=q_w,
        t_w=t_w,
        q_lc=torch.where(finite, odo_state.q_lc, identity),
        t_lc=torch.where(finite, odo_state.t_lc,
                         torch.zeros_like(odo_state.t_lc)),
    )
    odo = odo._replace(q_w=q_w, t_w=t_w)

    map_state, mout = mapping_step(
        map_state,
        odo_state.corner_last,
        odo_state.surf_last,
        q_w,
        t_w,
        cfg.mapping,
    )
    return odo_state, map_state, odo, mout, ~finite


class ChunkOutput(NamedTuple):
    """Per-frame outputs of a chunk, each with leading axis K."""

    odom_q: torch.Tensor         # (K, 4)
    odom_t: torch.Tensor         # (K, 3)
    map_q: torch.Tensor          # (K, 4)
    map_t: torch.Tensor          # (K, 3)
    diverged: torch.Tensor       # (K,) bool
    map_corner_points: torch.Tensor  # (K,) int32
    map_surf_points: torch.Tensor    # (K,) int32
    local_overflow: torch.Tensor     # (K,) int32


def _chunk_row(odo: OdometryOutput, mout: MappingOutput, diverged) -> ChunkOutput:
    return ChunkOutput(
        odom_q=odo.q_w,
        odom_t=odo.t_w,
        map_q=mout.q_w,
        map_t=mout.t_w,
        diverged=diverged,
        map_corner_points=mout.map_corner_points,
        map_surf_points=mout.map_surf_points,
        local_overflow=mout.local_overflow,
    )


def _leaves(tree) -> list:
    """Tensors of nested NamedTuples, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for part in tree for leaf in _leaves(part)]


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone(part) for part in tree))


def stack_lanes(tree, lanes: int):
    """``lanes`` copies of every tensor of nested NamedTuples, stacked on a
    new leading axis."""
    if isinstance(tree, torch.Tensor):
        return tree.expand((lanes,) + tuple(tree.shape)).contiguous()
    return type(tree)(*(stack_lanes(part, lanes) for part in tree))


def _lanes_frame_body(odo_state, map_state, xyz, mask, cfg):
    """B lanes of one frame (models/batch.py ``_batched_body``) in the
    fused body's form.  The batched body has no divergence containment, as
    the JAX package's has none: ``diverged`` only reports each lane's
    non-finite odometry translation."""
    # models/batch.py builds on this module, so it is imported at first use
    from light_loam_tpu_torch.models.batch import BatchState, _batched_body

    state, odo, mout = _batched_body(BatchState(odo_state, map_state), xyz,
                                     mask, cfg)
    return (state.odometry, state.mapping, odo, mout,
            ~torch.isfinite(odo.t_w).all(-1))


class FrameGraph:
    """The fused frame of one (config, device) captured as a CUDA graph,
    with the static buffers it replays on: ``chunk`` frames of input, the
    odometry and mapping state, and ``chunk`` rows of output.  The graph
    holds one frame and a chunk is ``chunk`` replays of it (a whole chunk
    captured as one graph took as long to replay and ``chunk`` times as
    long to capture, PERF.md).  With ``lanes`` = B the graph holds one
    frame of B lanes (models/batch.py): frames (chunk, B, N, 3), states
    stacked over B, rows (chunk, B, ...).  ``lanes=None`` is the single
    fused frame.

    ``kernel_launches`` is what the hand-written kernels' wrappers counted
    while the step was captured, so what one replay launches; ``replays``
    counts the replays.  A replay goes past the wrappers and leaves their
    own counts alone."""

    def __init__(self, cfg: PipelineConfig, device: torch.device,
                 chunk: int = 1, lanes: Optional[int] = None):
        self.cfg, self.device, self.chunk = cfg, device, chunk
        self._body = _fused_frame_body if lanes is None else _lanes_frame_body
        n = cfg.scan.max_points
        lead = (chunk,) if lanes is None else (chunk, lanes)
        self.xyz = torch.zeros(lead + (n, 3), device=device)
        self.mask = torch.zeros(lead + (n,), dtype=torch.bool, device=device)
        # frames arrive from the host through pinned memory, so the copy to
        # the card does not wait; `_staged` marks the last such copy done
        self._pinned_xyz = torch.zeros(lead + (n, 3)).pin_memory()
        self._pinned_mask = torch.zeros(lead + (n,),
                                        dtype=torch.bool).pin_memory()
        self._staged = None
        # the chunk frame the next captured step reads and the row it writes
        self.index = torch.zeros(1, dtype=torch.int64, device=device)
        self.odo_state = OdometryState.init(
            cfg.scan.max_less_sharp, cfg.scan.max_less_flat, device)
        self.map_state = MappingState.init(cfg.mapping, device)
        if lanes is not None:
            self.odo_state = stack_lanes(self.odo_state, lanes)
            self.map_state = stack_lanes(self.map_state, lanes)
        i32 = dict(dtype=torch.int32, device=device)
        self.rows = ChunkOutput(
            odom_q=torch.zeros(lead + (4,), device=device),
            odom_t=torch.zeros(lead + (3,), device=device),
            map_q=torch.zeros(lead + (4,), device=device),
            map_t=torch.zeros(lead + (3,), device=device),
            diverged=torch.zeros(lead, dtype=torch.bool, device=device),
            map_corner_points=torch.zeros(lead, **i32),
            map_surf_points=torch.zeros(lead, **i32),
            local_overflow=torch.zeros(lead, **i32),
        )
        self.last = None           # (odo, mout, diverged) of the last step
        self.replays = 0
        self.kernel_launches: Dict[str, int] = {}
        with torch.cuda.device(device):
            self._capture()

    def _step(self):
        """One frame on the static buffers: read frame ``index``, advance
        the state in place, write row ``index``, move ``index`` on."""
        i = self.index
        odo_state, map_state, odo, mout, diverged = self._body(
            self.odo_state, self.map_state,
            self.xyz.index_select(0, i)[0], self.mask.index_select(0, i)[0],
            self.cfg)
        for rows, value in zip(self.rows, _chunk_row(odo, mout, diverged)):
            rows.index_copy_(0, i, value[None])
        for dst, src in zip(_leaves((self.odo_state, self.map_state)),
                            _leaves((odo_state, map_state))):
            dst.copy_(src)
        i.add_(1)
        return odo, mout, diverged

    def _capture(self) -> None:
        """Warm up on a side stream, then capture one step.  The warm-up
        runs on the static state (empty frames from the initial
        state), which every call overwrites with the caller's, so it
        advances no run."""
        main = torch.cuda.current_stream(self.device)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_PASSES):
                self.index.zero_()
                self._step()
        main.wait_stream(side)
        self.index.zero_()
        torch.cuda.synchronize(self.device)
        self.warmup_seconds = time.perf_counter() - t0

        kernels = (KNN5, VOTE, SEGSUM)
        before = [k.launches for k in kernels]
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.last = self._step()
        self.capture_seconds = time.perf_counter() - t0
        for k, b in zip(kernels, before):
            self.kernel_launches[k.source.name] = k.launches - b

    def _load_frames(self, xyz: torch.Tensor, mask: torch.Tensor) -> None:
        if xyz.is_cuda:
            self.xyz.copy_(xyz)
            self.mask.copy_(mask)
            return
        if self._staged is not None:
            self._staged.synchronize()
        self._pinned_xyz.copy_(xyz)
        self._pinned_mask.copy_(mask)
        self.xyz.copy_(self._pinned_xyz, non_blocking=True)
        self.mask.copy_(self._pinned_mask, non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record()

    def run(self, odo_state: OdometryState, map_state: MappingState,
            xyz: torch.Tensor, mask: torch.Tensor):
        """``chunk`` frames (xyz (chunk, N, 3), mask (chunk, N), each with
        a lane axis after the chunk axis when the graph has lanes; on the
        host or on the card) from the given states: returns copies of the
        new states and of the chunk's output rows."""
        if xyz.shape != self.xyz.shape or mask.shape != self.mask.shape:
            raise ValueError(
                f"FrameGraph: frames {tuple(xyz.shape)}, {tuple(mask.shape)} "
                f"do not match the captured {tuple(self.xyz.shape)}, "
                f"{tuple(self.mask.shape)}")
        for dst, src in zip(_leaves((self.odo_state, self.map_state)),
                            _leaves((odo_state, map_state))):
            dst.copy_(src, non_blocking=True)
        self._load_frames(xyz, mask)
        self.index.zero_()
        for _ in range(self.chunk):
            self.graph.replay()
            self.replays += 1
        return _clone(self.odo_state), _clone(self.map_state), _clone(self.rows)


_GRAPHS: Dict[tuple, FrameGraph] = {}


def frame_graph(cfg: PipelineConfig, device, chunk: int = 1,
                lanes: Optional[int] = None) -> FrameGraph:
    """The captured frame of (cfg, device, chunk, lanes), captured at
    first use.  A failed capture raises and leaves nothing behind."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (cfg, device, chunk, lanes)
    if key not in _GRAPHS:
        _GRAPHS[key] = FrameGraph(cfg, device, chunk, lanes)
    return _GRAPHS[key]


def clear_graphs() -> None:
    """Drop every captured graph and the device memory it holds."""
    _GRAPHS.clear()


def fused_frame_step(
    odo_state: OdometryState,
    map_state: MappingState,
    xyz: torch.Tensor,
    mask: torch.Tensor,
    cfg: PipelineConfig,
):
    """One fused frame from the given states: (new odometry state, new
    mapping state, odometry output, mapping output, diverged).  The states
    name the device; on a card the frame may come from the host (it is
    staged through pinned memory) and the step is one graph replay."""
    device = odo_state.q_w.device
    if device.type != "cuda":
        return _fused_frame_body(odo_state, map_state, xyz, mask, cfg)
    graph = frame_graph(cfg, device)
    odo_state, map_state, _ = graph.run(odo_state, map_state, xyz[None],
                                        mask[None])
    odo, mout, diverged = (_clone(part) for part in graph.last)
    return odo_state, map_state, odo, mout, diverged


def fused_chunk_step(
    odo_state: OdometryState,
    map_state: MappingState,
    xyz: torch.Tensor,   # (K, max_points, 3)
    mask: torch.Tensor,  # (K, max_points)
    cfg: PipelineConfig,
) -> Tuple[OdometryState, MappingState, ChunkOutput]:
    """K consecutive frames of ONE sequence with no host read between them
    — the offline single-sequence throughput mode.

    Semantics per frame are identical to ``fused_frame_step`` including
    the containment on the device.  Host-side policies that need a
    per-frame readback (mapping back-pressure drops, skip_frame_num
    decimation) do not apply inside a chunk — this is the offline
    sync-mapping regime, every frame maps."""
    device = odo_state.q_w.device
    if device.type == "cuda":
        return frame_graph(cfg, device, chunk=xyz.shape[0]).run(
            odo_state, map_state, xyz, mask)
    rows = []
    for x, m in zip(xyz, mask):
        odo_state, map_state, odo, mout, diverged = _fused_frame_body(
            odo_state, map_state, x, m, cfg)
        rows.append(_chunk_row(odo, mout, diverged))
    return odo_state, map_state, ChunkOutput(*(torch.stack(c)
                                               for c in zip(*rows)))


def run_chunked(frame_iter, cfg: PipelineConfig, chunk_size: int = 8,
                device="cuda"):
    """Replay a frame stream through ``fused_chunk_step`` — the offline
    single-sequence runner (one host read per ``chunk_size`` frames).

    ``frame_iter`` yields (xyz (N,3), mask (N,)) host arrays.  The tail
    chunk is padded with empty (all-masked) frames — an empty scan
    degrades gracefully (damped solve, pose holds) and contributes no
    map points — and its outputs are trimmed, so the returned
    trajectories have exactly one row per input frame.  (The returned
    *states* do include the empty-frame passes: pose unchanged, map
    untouched, warm-start increment decayed toward identity.)

    Returns (odo_state, map_state, outs) where each ChunkOutput leaf is a
    numpy array stacked over ALL input frames."""
    device = torch.device(device)
    odo_state = OdometryState.init(cfg.scan.max_less_sharp,
                                   cfg.scan.max_less_flat, device)
    map_state = MappingState.init(cfg.mapping, device)
    collected = []
    buf = []

    def flush():
        nonlocal odo_state, map_state
        if not buf:
            return
        n = len(buf)
        xs = np.stack([b[0] for b in buf]).astype(np.float32, copy=False)
        ms = np.stack([b[1] for b in buf]).astype(bool, copy=False)
        if n < chunk_size:  # pad the tail; outputs trimmed below
            pad = chunk_size - n
            xs = np.concatenate([xs, np.zeros((pad,) + xs.shape[1:],
                                              xs.dtype)])
            ms = np.concatenate([ms, np.zeros((pad,) + ms.shape[1:],
                                              ms.dtype)])
        odo_state, map_state, outs = fused_chunk_step(
            odo_state, map_state, torch.from_numpy(xs), torch.from_numpy(ms),
            cfg)
        collected.append(ChunkOutput(*(leaf.cpu().numpy()[:n]
                                       for leaf in outs)))
        buf.clear()

    for xyz, mask in frame_iter:
        buf.append((xyz, mask))
        if len(buf) == chunk_size:
            flush()
    flush()
    if not collected:
        raise ValueError("run_chunked: empty frame stream")
    outs = ChunkOutput(*(np.concatenate(leaves)
                         for leaves in zip(*collected)))
    return odo_state, map_state, outs
