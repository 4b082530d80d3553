"""The port's map sharding (parallel/sharded.py) against the JAX package:
twins of tests/test_sharded.py and tests/test_refine.py's sharded refinement,
with ranks as spawned CPU processes joined by gloo (tests/torch_ranks.py).

The JAX package is imported inside the tests only: the ranks import this
module, and they must not load JAX.

Bitwise: ``voxel_owner`` (products that wrap in int32 included),
``redistribute_state``, ``_gather_local(cell_ordered=False)``, the voxel
count of ``voxel_downsample(with_count=True)``, and the ranks' store slices
concatenated against the JAX package's sharded global array.

Tolerances:
  * ``lm_solve`` with ``allreduce`` over 2 ranks holding half the factors
    each against one process holding all of them: 1e-6 (the sums are taken
    in another order);
  * the sharded mapping step (tests/test_sharded.py's CFG and frames, one
    step from each of 10 successive single-device states) against the
    port's ``mapping_step``: the JAX test's bounds, t_w within 2e-2 m,
    surf factors within max(5, 3 %), map surf points within max(10, 2 %);
    against the JAX package's ``sharded_mapping_step`` on a mesh of the same
    n: t_w within 2e-2 m and the same count bounds, overflow counters
    equal; every rank's pose bitwise equal.  The gap to the JAX step is the
    single-device port's gap to the jitted JAX step (tests/test_torch_
    mapping.py: XLA fuses multiply-adds, and the float32 plane-fit gates
    flip): measured up to 11.25 mm on frame 6 at n = 1, 2 and 4 alike,
    while each package's sharded step is within 5e-7 m of its own
    single-device step.  The JAX step run op by op (``jax.disable_jit``),
    which tests/test_torch_odometry.py compares with, takes over 7 minutes
    a frame under ``shard_map`` on the CPU, so the twin holds the jitted
    step at the JAX test's own 2e-2 (ROADMAP Queue 3);
  * the sharded refinement (K = 8 keyframes split over the ranks) within
    1e-4 of the single call and of the JAX package's shard_map run
    (tests/test_refine.py:111-112).
~70 s on the CPU (world 1 and 2; world 4 runs under ``slow``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from light_loam_tpu_torch import convert
from light_loam_tpu_torch.config import MappingConfig
from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.core.frame import PointCloud
from light_loam_tpu_torch.models import mapping as tm
from light_loam_tpu_torch.models.mapping import MappingState, mapping_step
from light_loam_tpu_torch.models.refine import PlaneLandmarks, refine_window
from light_loam_tpu_torch.ops.voxel import voxel_downsample
from light_loam_tpu_torch.parallel import sharded
from light_loam_tpu_torch.parallel.sharded import (
    ShardGroup,
    make_group,
    redistribute_state,
    shard_mapping_state,
    sharded_mapping_step,
    voxel_owner,
)
from light_loam_tpu_torch.solver import FactorSet, lm_solve
from light_loam_tpu_torch.solver.residuals import EdgeFactors, PlaneNormFactors
from light_loam_tpu_torch.utils.synthetic import World, simulate_scan
from torch_ranks import run_ranks

torch.set_num_threads(2)

# tests/test_sharded.py's CFG
CFG = MappingConfig(
    map_corner_capacity=8192,
    map_surf_capacity=16384,
    local_corner_capacity=8192,
    local_surf_capacity=16384,
    stack_corner_capacity=512,
    stack_surf_capacity=2048,
    knn_tile=1024,
)
T_SINGLE = T_JAX = 2e-2


def _jax_cfg(cfg):
    from light_loam_tpu.config import MappingConfig as JMappingConfig

    return JMappingConfig(**dataclasses.asdict(cfg))


def _jax_state(d):
    """A JAX MappingState from the nested numpy dict of convert.py."""
    import jax.numpy as jnp
    from light_loam_tpu.models.mapping import MappingState as JState
    from light_loam_tpu.models.mapping import MapStore as JStore

    return JState(
        corner=JStore(**{k: jnp.asarray(v) for k, v in d["corner"].items()}),
        surf=JStore(**{k: jnp.asarray(v) for k, v in d["surf"].items()}),
        **{k: jnp.asarray(d[k]) for k in ("cen", "q_wm", "t_wm", "frame")})


def _filled_state(seed, n_pts=3000):
    """A mapping state (numpy dict) whose stores hold random points, some
    masked out, with random cells in the grid."""
    rng = np.random.default_rng(seed)
    d = convert.mapping_state_to_numpy(MappingState.init(CFG, "cpu"))
    for name in ("corner", "surf"):
        store = d[name]
        xyz = rng.uniform(-60, 60, (n_pts, 3)).astype(np.float32)
        xyz[n_pts // 2:] = xyz[:n_pts // 2] + rng.uniform(
            0, 0.05, (n_pts - n_pts // 2, 3)).astype(np.float32)
        store["xyz"][:n_pts] = xyz
        store["cell"][:n_pts] = rng.integers(0, 21 * 21 * 11, n_pts)
        store["mask"][:n_pts] = rng.random(n_pts) < 0.9
    return d


def test_voxel_owner_matches_jax_bitwise():
    from light_loam_tpu.parallel.sharded import voxel_owner as jowner

    rng = np.random.default_rng(0)
    xyz = np.concatenate([
        rng.uniform(-300, 300, (4000, 3)),
        # voxel coordinates whose hash products wrap in int32
        rng.uniform(-3e5, 3e5, (4000, 3)),
        # on and beside the lattice
        np.round(rng.uniform(-50, 50, (1000, 3)) / 0.4) * 0.4,
    ]).astype(np.float32)
    ijk = np.floor(xyz / np.float32(0.4)).astype(np.int64)
    assert (np.abs(ijk * 83492791) > 2**31).mean() > 0.4
    for leaf, n in ((0.4, 2), (0.8, 4), (0.2, 3), (0.4, 8)):
        want = np.asarray(jowner(xyz, leaf, n))
        got = voxel_owner(torch.from_numpy(xyz), leaf, n).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) == set(range(n))


@pytest.mark.parametrize("n", [2, 4])
def test_redistribute_state_matches_jax_bitwise(n):
    from light_loam_tpu.parallel.sharded import redistribute_state as jred

    d = _filled_state(n)
    want = jred(_jax_state(d), n, _jax_cfg(CFG))
    got = redistribute_state(convert.mapping_state_from_numpy(d), n, CFG)
    for name in ("corner", "surf"):
        for field in ("xyz", "cell", "mask"):
            np.testing.assert_array_equal(
                getattr(getattr(got, name), field).numpy(),
                np.asarray(getattr(getattr(want, name), field)))
    assert got.corner.mask.sum() == d["corner"]["mask"].sum()


@pytest.mark.parametrize("capacity", [4096, 40])
def test_gather_local_unordered_matches_jax_bitwise(capacity):
    import jax.numpy as jnp
    from light_loam_tpu.models import mapping as jmapping

    d = _filled_state(7, n_pts=6000)
    center = np.array([10, 10, 5], np.int32)
    store = convert.mapping_state_from_numpy(d).surf
    jstore = _jax_state(d).surf
    got = tm._gather_local(store, torch.from_numpy(center), CFG, capacity,
                           cell_ordered=False)
    want = jmapping._gather_local(jstore, jnp.asarray(center),
                                  _jax_cfg(CFG), capacity,
                                  cell_ordered=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the capacity of 40 overflows, 4096 does not
    assert (int(got[2]) > 0) == (capacity == 40)
    assert int(got[1].sum()) == min(capacity, int(got[1].sum()) + int(got[2]))


def test_voxel_downsample_count_matches_jax():
    import jax.numpy as jnp
    from light_loam_tpu.ops.voxel import voxel_downsample as jvd

    rng = np.random.default_rng(3)
    xyz = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    mask = rng.random(3000) < 0.8
    rel = rng.random(3000).astype(np.float32)
    for cap in (4096, 256):
        got = voxel_downsample(torch.from_numpy(xyz), torch.from_numpy(rel),
                               torch.from_numpy(mask), 0.5, cap,
                               with_count=True)
        want = jvd(jnp.asarray(xyz), jnp.asarray(rel), jnp.asarray(mask), 0.5,
                   cap, with_count=True)
        assert len(got) == 5
        assert got[4].dtype == torch.int32
        assert int(got[4]) == int(want[4]) > 256
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        # the first four returns are the call without the count's
        for a, b in zip(got[:4], voxel_downsample(
                torch.from_numpy(xyz), torch.from_numpy(rel),
                torch.from_numpy(mask), 0.5, cap)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_slices_match_jax_global_array(n):
    """The ranks' store slices, concatenated in rank order, are the JAX
    package's sharded global array as np.asarray reads it."""
    from light_loam_tpu.parallel import make_mesh
    from light_loam_tpu.parallel import shard_mapping_state as jshard

    d = _filled_state(10 + n)
    want = jshard(_jax_state(d), make_mesh(n), _jax_cfg(CFG))
    state = convert.mapping_state_from_numpy(d)
    parts = [shard_mapping_state(state, ShardGroup(r, n, "cpu"), CFG)
             for r in range(n)]
    for name in ("corner", "surf"):
        for field in ("xyz", "cell", "mask"):
            got = torch.cat([getattr(getattr(p, name), field) for p in parts])
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(getattr(want, name), field)))
    for field in ("cen", "q_wm", "t_wm", "frame"):
        for p in parts:
            np.testing.assert_array_equal(getattr(p, field).numpy(),
                                          np.asarray(getattr(want, field)))


def test_voxel_ownership_partition():
    """Twin of tests/test_sharded.py::test_voxel_ownership_partition: every
    point lands on its owner's slice, nothing is lost, same-voxel points
    share an owner, and no shard holds more than half the points."""
    n, pts = 4, 512
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-40, 40, size=(pts, 3)).astype(np.float32)
    xyz[pts // 2:] = xyz[: pts // 2] + rng.uniform(
        0, 0.05, size=(pts // 2, 3)).astype(np.float32)
    st = MappingState.init(CFG, "cpu")
    corner = st.corner
    corner.xyz[:pts] = torch.from_numpy(xyz)
    corner.mask[:pts] = True
    parts = [shard_mapping_state(st, ShardGroup(r, n, "cpu"), CFG)
             for r in range(n)]
    counts = []
    for r, p in enumerate(parts):
        live = p.corner.xyz[p.corner.mask]
        assert (voxel_owner(live, CFG.line_resolution, n) == r).all()
        counts.append(len(live))
    assert sum(counts) == pts
    assert max(counts) <= pts // 2, counts
    # same-voxel points share an owner
    owners = voxel_owner(torch.from_numpy(xyz), CFG.line_resolution, n)
    keys = np.floor(xyz / np.float32(CFG.line_resolution)).astype(np.int64)
    for key in np.unique(keys, axis=0)[:64]:
        same = (keys == key).all(axis=1)
        assert len(np.unique(owners.numpy()[same])) == 1


def test_make_group_nccl_raises_without_cards():
    """No fallback: NCCL with fewer visible cards than ranks raises before
    joining any group (here there is no card at all)."""
    assert torch.cuda.device_count() == 0
    with pytest.raises(ValueError, match="one card per rank"):
        make_group(2, 0, "nccl", "file:///nonexistent/rdzv")
    with pytest.raises(ValueError, match="one card per rank"):
        make_group(1, 0, "nccl", "file:///nonexistent/rdzv", device="cpu")
    assert not torch.distributed.is_initialized()


def _lm_factors(seed):
    """Edge and plane factors (numpy) around a pose near identity."""
    rng = np.random.default_rng(seed)
    ne, nplane = 64, 128
    cp = rng.uniform(-10, 10, (ne, 3))
    direction = rng.normal(size=(ne, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    shift = np.array([0.05, -0.03, 0.02])
    edge = dict(cp=cp, a=cp + shift + direction, b=cp + shift - direction,
                s=np.ones(ne), weight=np.ones(ne), mask=rng.random(ne) < 0.9)
    pc = rng.uniform(-10, 10, (nplane, 3))
    nrm = rng.normal(size=(nplane, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    plane = dict(cp=pc, n=nrm, d=-np.sum(nrm * (pc + shift), axis=1),
                 weight=np.ones(nplane), mask=rng.random(nplane) < 0.9)
    return ({k: v.astype(bool) if v.dtype == bool else v.astype(np.float32)
             for k, v in edge.items()},
            {k: v.astype(bool) if v.dtype == bool else v.astype(np.float32)
             for k, v in plane.items()})


def _factor_set(edge, plane, rank=0, size=1):
    """The factors, or rank's 1/size of each family."""
    def part(v):
        rows = v.shape[0] // size
        return torch.from_numpy(v[rank * rows:(rank + 1) * rows])

    return FactorSet(
        edge=EdgeFactors(**{k: part(v) for k, v in edge.items()}),
        plane_norm=PlaneNormFactors(**{k: part(v) for k, v in plane.items()}))


def _lm_rank(group, edge, plane):
    q, t, cost = lm_solve(quat.quat_identity(), torch.zeros(3),
                          _factor_set(edge, plane, group.rank, group.size),
                          n_iterations=4, allreduce=group.all_reduce)
    return q.numpy(), t.numpy(), float(cost), group.collectives


def test_lm_solve_allreduce_matches_one_process(tmp_path):
    edge, plane = _lm_factors(0)
    q, t, cost = lm_solve(quat.quat_identity(), torch.zeros(3),
                          _factor_set(edge, plane), n_iterations=4)
    assert float(t.norm()) > 0.03  # the solve moved the pose
    ranks = run_ranks(_lm_rank, 2, tmp_path, edge, plane)
    for rq, rt, rcost, collectives in ranks:
        np.testing.assert_allclose(rq, q.numpy(), atol=1e-6)
        np.testing.assert_allclose(rt, t.numpy(), atol=1e-6)
        np.testing.assert_allclose(rcost, float(cost), atol=1e-6)
        # the count and cost once, then H and g and the trial cost each step
        assert collectives == 1 + 2 * 4
    # every rank solved the same system
    assert all(np.array_equal(r[1], ranks[0][1]) for r in ranks)


def _clouds_for_frame(world, pos, rng, seed):
    """tests/test_sharded.py's clouds: (corner, surf) numpy dicts."""
    pts = simulate_scan(world, pos, n_azimuth=500, noise=0.005, seed=seed)
    idx = rng.permutation(len(pts))

    def as_cloud(p, cap):
        xyz = np.zeros((cap, 3), np.float32)
        mask = np.zeros(cap, bool)
        m = min(len(p), cap)
        xyz[:m] = p[:m]
        mask[:m] = True
        return dict(xyz=xyz, rel=np.zeros(cap, np.float32), mask=mask)

    return as_cloud(pts[idx[:400]], 512), as_cloud(pts[idx[400:2400]], 2048)


def _cloud(d, device="cpu"):
    return PointCloud(*(torch.from_numpy(d[k]).to(device)
                        for k in ("xyz", "rel", "mask")))


def _single_chain(cfg, n_frames, seed0):
    """The port's single-device mapping over tests/test_sharded.py's frames:
    per frame (state before it as numpy, corner, surf, t_odom, output)."""
    world = World.urban(seed=11)
    rng = np.random.default_rng(0)
    state = MappingState.init(cfg, "cpu")
    frames = []
    for k in range(n_frames):
        pos = np.array([0.5 * k, 0.0, 0.0])
        c, s = _clouds_for_frame(world, pos, rng, seed=seed0 + k)
        t_odom = pos.astype(np.float32) + np.float32(0.05)
        before = convert.mapping_state_to_numpy(state)
        state, out = mapping_step(state, _cloud(c), _cloud(s),
                                  quat.quat_identity(),
                                  torch.from_numpy(t_odom), cfg)
        frames.append((before, c, s, t_odom,
                       {k: v.numpy() for k, v in out._asdict().items()}))
    return frames


def _sharded_frames_rank(group, cfg, frames):
    """One sharded step from each frame's resharded single-device state."""
    rows = []
    for before, c, s, t_odom, _ in frames:
        state = shard_mapping_state(
            convert.mapping_state_from_numpy(before), group, cfg)
        _, out = sharded_mapping_step(state, _cloud(c), _cloud(s),
                                      quat.quat_identity(),
                                      torch.from_numpy(t_odom), cfg, group)
        rows.append({k: v.numpy() for k, v in out._asdict().items()})
    return rows


def _jax_sharded_frames(cfg, frames, n):
    import jax.numpy as jnp
    from light_loam_tpu.core import quaternion as jquat
    from light_loam_tpu.core.frame import PointCloud as JCloud
    from light_loam_tpu.parallel import make_mesh
    from light_loam_tpu.parallel import shard_mapping_state as jshard
    from light_loam_tpu.parallel import sharded_mapping_step as jstep

    mesh, jcfg = make_mesh(n), _jax_cfg(cfg)
    rows = []
    for before, c, s, t_odom, _ in frames:
        state = jshard(_jax_state(before), mesh, jcfg)
        _, out = jstep(state, JCloud(**{k: jnp.asarray(v) for k, v in c.items()}),
                       JCloud(**{k: jnp.asarray(v) for k, v in s.items()}),
                       jquat.quat_identity(), jnp.asarray(t_odom), jcfg, mesh)
        rows.append({k: np.asarray(v) for k, v in out._asdict().items()})
    return rows


def _check_counts(got, want, what):
    sf, wf = int(got["surf_factors"]), int(want["surf_factors"])
    assert abs(sf - wf) <= max(5, 0.03 * wf), f"{what}: surf factors {sf} vs {wf}"
    sp, wp = int(got["map_surf_points"]), int(want["map_surf_points"])
    assert abs(sp - wp) <= max(10, 0.02 * wp), f"{what}: map points {sp} vs {wp}"


def _check_sharded(ranks, frames, jax_rows):
    for k, (frame, jrow) in enumerate(zip(frames, jax_rows)):
        single = frame[4]
        rows = [r[k] for r in ranks]
        for r in rows[1:]:  # every rank holds the same pose
            assert np.array_equal(r["q_w"], rows[0]["q_w"])
            assert np.array_equal(r["t_w"], rows[0]["t_w"])
        got = rows[0]
        gap = float(np.linalg.norm(got["t_w"] - single["t_w"]))
        assert gap < T_SINGLE, f"frame {k}: sharded vs single {gap:.4f} m"
        _check_counts(got, single, f"frame {k} vs single")
        gap = float(np.linalg.norm(got["t_w"] - jrow["t_w"]))
        assert gap < T_JAX, f"frame {k}: port vs JAX sharded {gap:.5f} m"
        _check_counts(got, jrow, f"frame {k} vs JAX sharded")
        assert int(got["local_overflow"]) == int(jrow["local_overflow"])
        assert int(got["stack_overflow"]) == int(jrow["stack_overflow"])


@pytest.fixture(scope="module")
def chain():
    return _single_chain(CFG, 10, 30)


@pytest.mark.parametrize("n", [1, 2, pytest.param(4, marks=pytest.mark.slow)])
def test_sharded_matches_single_chip(n, chain, tmp_path):
    ranks = run_ranks(_sharded_frames_rank, n, tmp_path, CFG, chain)
    _check_sharded(ranks, chain, _jax_sharded_frames(CFG, chain, n))
    assert int(ranks[0][-1]["surf_factors"]) > 100


def test_sharded_vote_mode_matches_single_chip(tmp_path):
    """The vote path under sharding (tests/test_sharded.py's vote twin, at
    n = 2): the vote engages from frame 3 and runs over the full query set
    on every rank."""
    cfg = dataclasses.replace(CFG, vote_mode="simple", vote_start_frame=2)
    frames = _single_chain(cfg, 5, 60)
    ranks = run_ranks(_sharded_frames_rank, 2, tmp_path, cfg, frames)
    _check_sharded(ranks, frames, _jax_sharded_frames(cfg, frames, 2))
    assert int(frames[-1][4]["surf_factors"]) > 0


def _refine_rank(group, q0, t0, stacks, mask, lm):
    k = q0.shape[0] // group.size
    part = slice(group.rank * k, (group.rank + 1) * k)
    q, t, _ = refine_window(
        torch.from_numpy(q0[part]), torch.from_numpy(t0[part]),
        torch.from_numpy(stacks[part]), torch.from_numpy(mask[part]),
        PlaneLandmarks(*(torch.from_numpy(x) for x in lm)), n_iterations=4,
        **sharded.refine_hooks(group, k))
    return group.all_gather(q).numpy(), group.all_gather(t).numpy()


@pytest.mark.parametrize("n", [2, pytest.param(4, marks=pytest.mark.slow)])
def test_refine_sharded_matches_single(n, tmp_path):
    """Twin of tests/test_refine.py::test_refine_sharded_matches_single: K = 8
    keyframes split over n ranks through ``refine_hooks``."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P_
    from light_loam_tpu.models import refine as jr
    from test_refine import make_ba_problem

    rng = np.random.default_rng(1)
    _, (q0, t0), stacks, jlm = make_ba_problem(rng, K=8)
    mask = np.ones(stacks.shape[:2], bool)
    lm = tuple(np.asarray(x) for x in jlm)
    q_s, t_s, _ = refine_window(
        torch.from_numpy(q0), torch.from_numpy(t0), torch.from_numpy(stacks),
        torch.from_numpy(mask), PlaneLandmarks(*map(torch.from_numpy, lm)),
        n_iterations=4)

    mesh = Mesh(jax.devices()[:n], ("kf",))
    lm_spec = jr.PlaneLandmarks(n=P_(), d=P_(), anchor=P_(), mask=P_())
    fn = jax.jit(jax.shard_map(
        partial(jr.refine_window, n_iterations=4, axis_name="kf"),
        mesh=mesh,
        in_specs=(P_("kf"), P_("kf"), P_("kf"), P_("kf"), lm_spec),
        out_specs=(P_("kf"), P_("kf"), lm_spec),
        check_vma=False,
    ))
    q_j, t_j, _ = fn(jnp.asarray(q0), jnp.asarray(t0), jnp.asarray(stacks),
                     jnp.asarray(mask), jlm)

    ranks = run_ranks(_refine_rank, n, tmp_path, q0, t0, stacks, mask, lm)
    for q_m, t_m in ranks:
        np.testing.assert_allclose(t_m, t_s.numpy(), atol=1e-4)
        np.testing.assert_allclose(q_m, q_s.numpy(), atol=1e-4)
        np.testing.assert_allclose(t_m, np.asarray(t_j), atol=1e-4)
        np.testing.assert_allclose(q_m, np.asarray(q_j), atol=1e-4)
    # the refinement moved the poses
    assert np.abs(ranks[0][1] - t0).max() > 1e-3
