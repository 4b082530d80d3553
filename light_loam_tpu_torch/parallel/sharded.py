"""Map sharding over a group of processes, one device each.

Counterpart of ``light_loam_tpu/parallel/sharded.py``, on
``torch.distributed``: each rank is one process holding one device, and
collectives stand where the JAX package uses ``all_gather`` / ``psum`` /
``axis_index`` inside ``shard_map``.  gloo serves the CPU, NCCL the cards.

The cube map's point stores are split by a spatial hash of each point's
dedup voxel (``voxel_owner``), so

  * voxel dedup stays local: every point of one dedup voxel has one owner;
  * the load spreads over thousands of fine voxels;
  * ownership survives recentering, which shifts cell ids, not points;
  * the 5×5×3 local-map gather filters each rank's own slice; the live
    local neighbourhoods (bounded by local_*_capacity, never the stores)
    are all-gathered, and each rank runs the exact 5-NN of its own slice
    of the queries against them through ``ops/cuda_knn.knn5``;
  * the Gauss-Newton normal equations are summed over the ranks inside
    ``lm_solve(allreduce=...)``, so every rank solves the same 6×6 system.

The step reads nothing to the host: its collectives take static shapes and
its counts stay on the device.  So on a card, over NCCL, it is captured once
as a CUDA graph per rank with its collectives inside (``ShardedStepGraph``,
the counterpart of the JAX package's jitted ``shard_map`` step), and each
step is one replay.  gloo's collectives run through the host and cannot be
captured: on a gloo group the same body runs eagerly.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from light_loam_tpu_torch.config import MappingConfig
from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.core.frame import PointCloud
from light_loam_tpu_torch.models.fused import WARMUP_PASSES, _clone, _leaves
from light_loam_tpu_torch.models.mapping import (
    MapStore,
    MappingState,
    _cell_linear,
    _cube_of,
    _gather_local,
    _inside,
    _merge_full,
    _neighbours,
    _recenter,
    check_mapping_config,
    line_fit_factors,
    plane_fit_factors,
)
from light_loam_tpu_torch.ops import graphvote
from light_loam_tpu_torch.ops.cuda_knn import KNN5
from light_loam_tpu_torch.ops.cuda_segsum import SEGSUM
from light_loam_tpu_torch.ops.cuda_vote import VOTE
from light_loam_tpu_torch.ops.voxel import compact_rows, voxel_downsample
from light_loam_tpu_torch.solver import FactorSet, PlaneNormFactors, lm_solve
from light_loam_tpu_torch.solver.gauss_newton import LM


# the single-tensor all-gather: ``all_gather_into_tensor``, which PyTorch
# 2.13 renamed ``all_gather_single``
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)


class ShardGroup:
    """This process's place in a group of ``size`` ranks: its rank, its
    device and the process group (None: the default one).  Counts the
    collectives it runs and the bytes this rank contributes to them; a
    replay of a captured step adds the counts taken at its capture."""

    def __init__(self, rank: int, size: int, device,
                 group: Optional[dist.ProcessGroup] = None):
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.group = group
        self.collectives = 0
        self.bytes = 0

    @property
    def backend(self) -> Optional[str]:
        """The process group's backend ("nccl", "gloo"); None when this
        process has joined no group."""
        if not dist.is_initialized():
            return None
        return str(dist.get_backend(self.group))

    @property
    def captures(self) -> bool:
        """Whether the sharded step runs as a captured graph here: on a card
        over NCCL, whose collectives are device work.  gloo's go through the
        host and cannot be captured."""
        return self.device.type == "cuda" and self.backend == "nccl"

    def _count(self, x: torch.Tensor) -> None:
        self.collectives += 1
        self.bytes += x.numel() * x.element_size()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order."""
        if self.size == 1:
            return x
        if x.dtype == torch.bool:
            return self.all_gather(x.to(torch.uint8)).to(torch.bool)
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather_single(out, x, group=self.group)
        self._count(x)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x`` (a new tensor)."""
        if self.size == 1:
            return x
        out = x.clone()
        dist.all_reduce(out, group=self.group)
        self._count(x)
        return out


def make_group(world_size: int, rank: int, backend: str, init_method: str,
               device=None, local_world_size: Optional[int] = None
               ) -> ShardGroup:
    """Join the default process group as ``rank`` of ``world_size`` and
    return this rank's ``ShardGroup`` (the counterpart of ``make_mesh``).

    ``backend`` is the caller's choice ("gloo" or "nccl"); ``device``
    defaults to ``cuda:rank``.  NCCL needs a card for each rank of a host
    (``local_world_size``, all of ``world_size`` by default): with fewer
    visible cards it raises before joining."""
    device = torch.device("cuda", rank) if device is None else torch.device(
        device)
    if backend == "nccl":
        cards = torch.cuda.device_count()
        ranks_here = world_size if local_world_size is None else local_world_size
        if device.type != "cuda" or ranks_here > cards:
            raise ValueError(
                f"nccl needs one card per rank: {ranks_here} ranks on this "
                f"host, {cards} cards visible, device {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return ShardGroup(rank, world_size, device)


def voxel_owner(xyz: torch.Tensor, leaf: float, n: int) -> torch.Tensor:
    """Owner rank of each point: the 3-prime spatial hash of its absolute
    dedup-voxel coordinates (the world-anchored floor(xyz/leaf) lattice of
    ops/voxel.py).  The products wrap in int32, as they do in XLA."""
    ijk = torch.floor(xyz / leaf).to(torch.int32)
    h = (ijk[..., 0] * 73856093) ^ (ijk[..., 1] * 19349663) ^ (
        ijk[..., 2] * 83492791)
    return (h & 0x7FFFFFFF) % n


def redistribute_state(state: MappingState, n: int,
                       cfg: MappingConfig) -> MappingState:
    """Re-pack both point stores so that every point lands in its owner's
    contiguous slice (slice i covers rows [i·cap/n, (i+1)·cap/n)), in store
    order within the slice; points past a full slice are dropped.  Plain
    tensor code, the same on every rank."""

    def redistribute(store: MapStore, leaf: float) -> MapStore:
        capacity = store.cell.shape[0]
        cap_shard = capacity // n
        dev = store.cell.device
        owner = torch.where(store.mask, voxel_owner(store.xyz, leaf, n),
                            torch.full_like(store.cell, n)).to(torch.int64)
        idx = torch.arange(capacity, device=dev)
        order = torch.argsort(owner * capacity + idx, stable=True)
        owner_s = owner[order]
        first = torch.full((n + 1,), capacity, dtype=torch.int64,
                           device=dev).scatter_reduce(
            0, owner_s, idx, "amin", include_self=True)
        rank = idx - first[owner_s]
        # rows that find no place go to a dump row at ``capacity``
        dest = torch.where((owner_s < n) & (rank < cap_shard),
                           owner_s * cap_shard + rank,
                           torch.full_like(rank, capacity))

        def place(x):
            out = x.new_zeros((capacity + 1,) + tuple(x.shape[1:]))
            out[dest] = x[order]
            return out[:capacity]

        return MapStore(*(place(x) for x in store))

    return state._replace(
        corner=redistribute(state.corner, cfg.line_resolution),
        surf=redistribute(state.surf, cfg.plane_resolution))


def shard_mapping_state(state: MappingState, group: ShardGroup,
                        cfg: MappingConfig) -> MappingState:
    """This rank's part of ``state``: the stores redistributed by owner and
    cut to the rank's slice, the grid centre and pose replicated, all on the
    rank's device."""
    state = redistribute_state(state, group.size, cfg)

    def local(x):
        rows = x.shape[0] // group.size
        return x[group.rank * rows:(group.rank + 1) * rows].to(
            group.device, copy=True)

    return MappingState(
        corner=MapStore(*(local(x) for x in state.corner)),
        surf=MapStore(*(local(x) for x in state.surf)),
        **{k: getattr(state, k).to(group.device)
           for k in ("cen", "q_wm", "t_wm", "frame")})


def _with_mask(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, 4) rows [x, y, z, mask]: one collective carries both."""
    return torch.cat([xyz, mask[:, None].to(xyz.dtype)], dim=1)


def _gather_rows(group: ShardGroup, *xs: torch.Tensor):
    """All-gather several (rows_i, w) tensors in one collective; each comes
    back as (n · rows_i, w), every rank's rows in rank order."""
    if group.size == 1:
        return xs
    rows = [x.shape[0] for x in xs]
    g = group.all_gather(torch.cat(xs)).reshape(group.size, sum(rows), -1)
    return tuple(p.reshape(-1, g.shape[-1]) for p in g.split(rows, dim=1))


def _gathered_live_map(gathered: torch.Tensor, n: int):
    """The ranks' local-map buffers, gathered as [xyz, mask] rows, re-compacted
    to one live prefix so that the 5-NN visits only live rows: (xyz, mask,
    live count).  Each rank's buffer is already a live prefix, so at n = 1
    the buffer is used as it is."""
    xyz, mask = gathered[:, :3], gathered[:, 3] > 0
    count = mask.sum(dtype=torch.int32)
    if n == 1:
        return xyz.contiguous(), mask, count
    m_c, xyz_c = compact_rows(mask, mask.shape[0], xyz)
    return xyz_c, m_c, count


def _slice_for_device(x: torch.Tensor, group: ShardGroup) -> torch.Tensor:
    """This rank's contiguous 1/n of ``x`` along dim 0."""
    rows = x.shape[0] // group.size
    return x[group.rank * rows:(group.rank + 1) * rows]


def _merged_knn_sliced(stack_xyz, live_map, q_w, t_w, cfg: MappingConfig,
                       group: ShardGroup):
    """Exact 5-NN of this rank's query slice against the gathered live local
    map.  The gathered stack is owner-grouped, so the rank's slice of it is
    its own stack (``stack_xyz``): every row of it is a query, against the
    map's live rows."""
    xyz_c, m_c, count = live_map
    rows = torch.full_like(count, stack_xyz.shape[0])
    return _neighbours(stack_xyz, rows, xyz_c, m_c, count, q_w, t_w, cfg)


def _merged_knn(stack_xyz, live_map, q_w, t_w, cfg: MappingConfig,
                group: ShardGroup):
    """The 5-NN of every query on every rank (the vote needs the full set):
    the sliced search, then its (Q/n, 5) results gathered back; slice-major
    order is query order."""
    d, near = _merged_knn_sliced(stack_xyz, live_map, q_w, t_w, cfg, group)
    if group.size == 1:
        return d, near
    k = d.shape[1]
    (g,) = _gather_rows(group, torch.cat([d, near.reshape(-1, 3 * k)], 1))
    return g[:, :k], g[:, k:].reshape(-1, k, 3)


class ShardedMappingOutput(NamedTuple):
    """``models.mapping.MappingOutput`` plus ``stack_overflow``: stack
    points the owner shards dropped (input past the 2× compaction slack and
    owned voxels past a shard's capacity), summed over the ranks."""

    q_w: torch.Tensor
    t_w: torch.Tensor
    corner_factors: torch.Tensor
    surf_factors: torch.Tensor
    map_corner_points: torch.Tensor
    map_surf_points: torch.Tensor
    local_overflow: torch.Tensor
    stack_overflow: torch.Tensor


def _sharded_step_body(
    state: MappingState,
    corner_last: PointCloud,
    surf_last: PointCloud,
    q_odom: torch.Tensor,
    t_odom: torch.Tensor,
    cfg: MappingConfig,
    group: ShardGroup,
) -> Tuple[MappingState, ShardedMappingOutput]:
    """The sharded mapping step (``sharded_mapping_step``) on the tensors it
    is given, without a host read: what ``ShardedStepGraph`` captures, and
    what a gloo group runs eagerly."""
    check_mapping_config(cfg)
    n, rank = group.size, group.rank
    for name in ("stack_corner_capacity", "stack_surf_capacity",
                 "map_corner_capacity", "map_surf_capacity",
                 "local_corner_capacity", "local_surf_capacity"):
        if getattr(cfg, name) % n:
            raise ValueError(
                f"MappingConfig.{name}={getattr(cfg, name)} must be "
                f"divisible by the group size {n} (each rank holds an even "
                "slice)")

    q_w = quat.quat_normalize(quat.quat_multiply(state.q_wm, q_odom))
    t_w = quat.quat_rotate(state.q_wm, t_odom) + state.t_wm
    corner_store, surf_store, cen, center = _recenter(state, t_w, cfg)

    # the redistributed store is not ordered by cell: the argsort path
    local_c_xyz, local_c_mask, ovf_c = _gather_local(
        corner_store, center, cfg, cfg.local_corner_capacity // n,
        cell_ordered=False)
    local_s_xyz, local_s_mask, ovf_s = _gather_local(
        surf_store, center, cfg, cfg.local_surf_capacity // n,
        cell_ordered=False)

    def owner_stack(cloud: PointCloud, leaf: float, out_cap: int,
                    in_cap: int):
        """The rank's share of the stack: the downsample of the points it
        owns, which is the global downsample's owned voxels, since owners
        are whole dedup voxels.  Owned input past ``in_cap`` and owned
        voxels past ``out_cap`` are dropped and counted."""
        mine = cloud.mask & (voxel_owner(cloud.xyz, leaf, n) == rank)
        m_c, xyz_c, rel_c = compact_rows(mine, in_cap, cloud.xyz, cloud.rel)
        ovf = torch.clamp(mine.sum(dtype=torch.int32) - in_cap, min=0)
        sx, _, sm, _, n_vox = voxel_downsample(xyz_c, rel_c, m_c, leaf,
                                               out_cap, with_count=True)
        return sx, sm, ovf + torch.clamp(n_vox - out_cap, min=0)

    def in_cap(cloud: PointCloud) -> int:
        rows = cloud.xyz.shape[0]
        return rows if n == 1 else rows // n * 2

    stack_c_xyz_d, stack_c_mask_d, ovf_sc = owner_stack(
        corner_last, cfg.line_resolution, cfg.stack_corner_capacity // n,
        in_cap(corner_last))
    stack_s_xyz_d, stack_s_mask_d, ovf_ss = owner_stack(
        surf_last, cfg.plane_resolution, cfg.stack_surf_capacity // n,
        in_cap(surf_last))

    # one collective for the four buffers: the stacks (owner-grouped, so
    # slice r of each is rank r's own) and the local maps.  The local maps
    # do not change within the step, so they are gathered once, not in
    # every outer iteration as in the JAX step; no value changes.
    g_stack_c, g_stack_s, g_local_c, g_local_s = _gather_rows(
        group, _with_mask(stack_c_xyz_d, stack_c_mask_d),
        _with_mask(stack_s_xyz_d, stack_s_mask_d),
        _with_mask(local_c_xyz, local_c_mask),
        _with_mask(local_s_xyz, local_s_mask))
    stack_c_xyz, stack_c_mask = g_stack_c[:, :3], g_stack_c[:, 3] > 0
    stack_s_xyz, stack_s_mask = g_stack_s[:, :3], g_stack_s[:, 3] > 0
    live_c = _gathered_live_map(g_local_c, n)
    live_s = _gathered_live_map(g_local_s, n)
    # the live counts summed over the ranks
    big_enough = (live_c[2] > cfg.min_corner_map_points) & (
        live_s[2] > cfg.min_surf_map_points)
    use_vote = state.frame > cfg.vote_start_frame

    for _ in range(cfg.outer_iterations):
        d_c, near_c = _merged_knn_sliced(stack_c_xyz_d, live_c, q_w, t_w,
                                         cfg, group)
        ef = line_fit_factors(stack_c_xyz_d, stack_c_mask_d & big_enough,
                              d_c, near_c, cfg)
        if cfg.vote_mode == "off":
            d_s, near_s = _merged_knn_sliced(stack_s_xyz_d, live_s, q_w, t_w,
                                             cfg, group)
            pf = plane_fit_factors(stack_s_xyz_d, stack_s_mask_d & big_enough,
                                   d_s, near_s, cfg)
        else:
            # the vote chunks the full query set (laserMapping.cpp:
            # 2057-2072): every rank fits and votes over all of it, then
            # keeps its own slice of the factors
            d_s, near_s = _merged_knn(stack_s_xyz_d, live_s, q_w, t_w, cfg,
                                      group)
            pf = plane_fit_factors(stack_s_xyz, stack_s_mask & big_enough,
                                   d_s, near_s, cfg)
            sel, w = graphvote.run_vote(
                cfg.vote_mode, stack_s_xyz, near_s.mean(dim=1), pf.mask,
                n_regions=cfg.vote_regions,
                chunk_capacity=(cfg.stack_surf_capacity // cfg.vote_regions
                                + cfg.vote_regions),
                score_threshold=cfg.vote_score_threshold,
                resolution=cfg.vote_resolution,
                selected_ratio=cfg.vote_selected_ratio,
                low_vote_count=cfg.vote_low_vote_count,
                low_vote_weight=cfg.vote_low_vote_weight,
                high_vote_weight=cfg.vote_high_vote_weight,
                backend=cfg.vote_backend,
            )
            pf = pf._replace(
                mask=pf.mask & (sel | ~use_vote),
                weight=torch.where(use_vote & cfg.vote_apply_weights, w,
                                   pf.weight),
            )
            pf = PlaneNormFactors(*(_slice_for_device(x, group) for x in pf))
        q_w, t_w, _cost = lm_solve(
            q_w, t_w, FactorSet(edge=ef, plane_norm=pf),
            n_iterations=cfg.inner_iterations,
            huber_delta=cfg.huber_delta,
            allreduce=group.all_reduce,
        )

    q_wm = quat.quat_normalize(
        quat.quat_multiply(q_w, quat.quat_inverse(q_odom)))
    t_wm = t_w - quat.quat_rotate(q_wm, t_odom)

    def merge(store: MapStore, stack_xyz, stack_mask, leaf: float,
              capacity: int) -> MapStore:
        """Register the whole stack; each rank keeps the points it owns.
        The stack and the pose are the same on every rank, so exactly one
        rank keeps each point."""
        reg = quat.quat_rotate(q_w[None, :], stack_xyz) + t_w[None, :]
        ijk = _cube_of(reg, cen, cfg)
        inside = _inside(ijk, cfg)
        cell = torch.where(inside, _cell_linear(ijk, cfg),
                           torch.zeros_like(ijk[:, 0])).to(torch.int32)
        mine = voxel_owner(reg, leaf, n) == rank
        return _merge_full(store, reg, cell, stack_mask & inside & mine,
                           leaf, capacity // n)

    corner_store = merge(corner_store, stack_c_xyz, stack_c_mask,
                         cfg.line_resolution, cfg.map_corner_capacity)
    surf_store = merge(surf_store, stack_s_xyz, stack_s_mask,
                       cfg.plane_resolution, cfg.map_surf_capacity)

    totals = group.all_reduce(torch.stack([
        ef.mask.sum(dtype=torch.int32), pf.mask.sum(dtype=torch.int32),
        corner_store.mask.sum(dtype=torch.int32),
        surf_store.mask.sum(dtype=torch.int32),
        (ovf_c + ovf_s).to(torch.int32), (ovf_sc + ovf_ss).to(torch.int32),
    ]))
    new_state = MappingState(
        corner=corner_store, surf=surf_store, cen=cen, q_wm=q_wm, t_wm=t_wm,
        frame=state.frame + 1)
    return new_state, ShardedMappingOutput(q_w, t_w, *totals.unbind())


class ShardedStepGraph:
    """This rank's sharded step of one (config, group, cloud widths)
    captured as a CUDA graph with its collectives inside, and the static
    buffers it replays on: the rank's ``MappingState`` (stores at
    ``capacity // n``), ``corner_last`` and ``surf_last`` at their widths,
    the odometry pose and the ``ShardedMappingOutput``.  The captured step
    writes the new state over the old one and the outputs into their
    buffers; ``run`` copies the caller's arguments in, replays once and
    hands back copies.  Every rank of the group captures the same
    collectives in the same order, and a replay waits inside NCCL's kernels
    for its peers' replays: every rank replays once per step.

    What the capture needs, as run with PyTorch 2.11 and NCCL 2.28.9 on
    one and on four H100s: the warm-up pass runs every collective of the
    step eagerly at the captured sizes (NCCL sets up its communicator and
    its connections at a group's first collectives, which a capture cannot
    hold); the step is captured in thread-local mode, since
    ProcessGroupNCCL's watchdog thread queries the events of earlier
    collectives, and under CUDA's default global mode a query from any
    thread invalidates a capture; and the capture starts once the warm-up
    has finished on the card and on every rank (a barrier).  The global
    mode and a capture without the barrier were not tried.  A capture that
    fails raises.  Every graph that holds a group's collectives must be
    destroyed before the group (``clear_graphs``): NCCL's teardown waits
    for it, and four ranks that destroyed their group first hung.

    ``kernel_launches`` is what the hand-written kernels' wrappers counted
    while the step was captured, ``collectives`` and ``bytes`` what the
    group counted (a replay adds them to the group's counts; the capture
    itself leaves them as they were), ``replays`` the replays.  On the CPU
    there is nothing to capture: ``run`` runs the step on the same static
    buffers."""

    def __init__(self, cfg: MappingConfig, group: ShardGroup,
                 corner_width: int, surf_width: int):
        self.cfg, self.group, self.device = cfg, group, group.device
        dev = self.device
        self.state = shard_mapping_state(MappingState.init(cfg, dev), group,
                                         cfg)
        self.corner = PointCloud.zeros(corner_width, dev)
        self.surf = PointCloud.zeros(surf_width, dev)
        self.q = quat.quat_identity(device=dev)
        self.t = torch.zeros(3, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.out = ShardedMappingOutput(
            torch.zeros(4, device=dev), torch.zeros(3, device=dev),
            *(torch.zeros((), **i32) for _ in range(6)))
        self.graph = None
        self.replays = 0
        self.collectives = self.bytes = 0
        self.kernel_launches: Dict[str, int] = {}
        self.warmup_seconds = self.capture_seconds = 0.0
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                self._capture()

    def _step(self) -> None:
        """One step on the static buffers: the new state over the old."""
        state, out = _sharded_step_body(self.state, self.corner, self.surf,
                                        self.q, self.t, self.cfg, self.group)
        for dst, src in zip(_leaves((self.state, self.out)),
                            _leaves((state, out))):
            dst.copy_(src)

    def _capture(self) -> None:
        """Warm up on a side stream (the static buffers' empty map, which
        every call overwrites), then capture one step."""
        main = torch.cuda.current_stream(self.device)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_PASSES):
                self._step()
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)
        if self.group.size > 1:
            dist.barrier(group=self.group.group,
                         device_ids=[self.device.index])
            torch.cuda.synchronize(self.device)
        self.warmup_seconds = time.perf_counter() - t0

        kernels = (KNN5, VOTE, SEGSUM, LM)
        before = [k.launches for k in kernels]
        counts = (self.group.collectives, self.group.bytes)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._step()
        finally:
            self.collectives = self.group.collectives - counts[0]
            self.bytes = self.group.bytes - counts[1]
            self.group.collectives, self.group.bytes = counts
        self.capture_seconds = time.perf_counter() - t0
        self.graph = graph
        for k, b in zip(kernels, before):
            self.kernel_launches[k.source.name] = k.launches - b

    def run(self, state: MappingState, corner_last: PointCloud,
            surf_last: PointCloud, q_odom: torch.Tensor,
            t_odom: torch.Tensor) -> Tuple[MappingState, ShardedMappingOutput]:
        """One step from the given arguments (``sharded_mapping_step``'s):
        copies of the new state and of the outputs."""
        for dst, src in zip(
                _leaves((self.state, self.corner, self.surf, self.q, self.t)),
                _leaves((state, corner_last, surf_last, q_odom, t_odom))):
            if dst.shape != src.shape:
                raise ValueError(
                    f"ShardedStepGraph: argument of shape {tuple(src.shape)} "
                    f"where the step was built for {tuple(dst.shape)}")
            dst.copy_(src, non_blocking=True)
        if self.graph is None:
            self._step()
        else:
            self.graph.replay()
            self.replays += 1
            self.group.collectives += self.collectives
            self.group.bytes += self.bytes
        return _clone(self.state), _clone(self.out)


_GRAPHS: Dict[tuple, ShardedStepGraph] = {}


def sharded_graph(cfg: MappingConfig, group: ShardGroup, corner_width: int,
                  surf_width: int) -> ShardedStepGraph:
    """The captured step of (cfg, group, its device, the cloud widths),
    captured at first use; every rank of the group must ask for it at the
    same step.  A failed capture raises and leaves nothing behind."""
    key = (cfg, group, group.device, corner_width, surf_width)
    if key not in _GRAPHS:
        _GRAPHS[key] = ShardedStepGraph(cfg, group, corner_width, surf_width)
    return _GRAPHS[key]


def clear_graphs() -> None:
    """Destroy every captured sharded step and the device memory it holds:
    before its process group is destroyed (NCCL's teardown waits for the
    graphs that hold the group's collectives, and a rank that destroys its
    group first hangs), and when the deterministic-sums setting changes (a
    graph keeps the kernels it was captured with).  A graph is destroyed
    even where a caller still holds its ``ShardedStepGraph``, whose ``run``
    then raises."""
    for g in _GRAPHS.values():
        if g.graph is not None:
            torch.cuda.synchronize(g.device)
            g.graph.reset()
    _GRAPHS.clear()


def sharded_mapping_step(
    state: MappingState,
    corner_last: PointCloud,
    surf_last: PointCloud,
    q_odom: torch.Tensor,
    t_odom: torch.Tensor,
    cfg: MappingConfig,
    group: ShardGroup,
) -> Tuple[MappingState, ShardedMappingOutput]:
    """One mapping step with the point stores sharded over ``group``:
    ``state`` is this rank's part (``shard_mapping_state``), the clouds and
    the odometry pose are the same on every rank, and every rank returns
    the same pose and totals.

    Matches ``models.mapping.mapping_step`` up to the JAX package's three
    documented differences: k-NN ties, dedup slot assignment, and in vote
    mode the vote regions, since the gathered query set is owner-grouped
    rather than sorted by voxel key and the vote chunks it by index
    ranges.  Only the local neighbourhoods, the stacks, and the 6×6 normal
    equations cross between the ranks.

    The path follows the group (``ShardGroup.captures``): on a card over
    NCCL the step is one replay of this rank's ``ShardedStepGraph``,
    captured at the first call (every rank must make it), and a capture
    that fails raises; on a gloo group, on the CPU or on cards, the body
    runs eagerly, since gloo's collectives run through the host and cannot
    be captured."""
    if not group.captures:
        return _sharded_step_body(state, corner_last, surf_last, q_odom,
                                  t_odom, cfg, group)
    graph = sharded_graph(cfg, group, corner_last.xyz.shape[0],
                          surf_last.xyz.shape[0])
    return graph.run(state, corner_last, surf_last, q_odom, t_odom)


def refine_hooks(group: ShardGroup, k_local: int) -> dict:
    """Keyword arguments of ``models.refine.refine_window`` for a window
    whose keyframes are split over ``group``, ``k_local`` on each rank in
    rank order: landmark blocks summed over the ranks, pose blocks
    gathered along the keyframe axis, and this rank's first keyframe."""
    return dict(psum=group.all_reduce, gather_poses=group.all_gather,
                offset=group.rank * k_local)
