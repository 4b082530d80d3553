"""The sharded mapping step as a captured graph (parallel/sharded.py
``ShardedStepGraph``), on the CPU: the parts a capture rests on.

  * The step on the graph's static buffers (copy in, the body, the new
    state over the old, copies out: what a replay does on a card, here run
    eagerly) is bitwise equal to ``sharded_mapping_step``'s eager body, the
    step gloo runs, over tests/test_sharded.py's CFG and frames, 4
    successive states from an empty map each carried by its own path: at
    world 1 and 2, and in vote mode at world 2.
  * The body reads nothing to the host: it runs at world 1 and 2, and in
    vote mode at world 2, under a dispatch mode that raises on every op
    that reads a device value to the host (``HOST_READS``, and indexing
    with a boolean mask), as a capture on the card needs.  The same guard runs over ``extract_features`` with
    ``lessflat_mode="runs"``, which the fused frame captures.
  * One body pass at world 2 runs 20 collectives, 22 with the map vote
    (one gather of stacks and local maps, 9 per ``lm_solve`` × 2 outer
    iterations, the totals' sum; the vote's two gathers of 5-NN results).
  * A gloo group runs the eager body and caches no graph.

Ranks are spawned CPU processes joined by gloo (tests/torch_ranks.py); this
module imports no JAX, since the ranks import it.  ~35 s on the CPU.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from light_loam_tpu_torch.config import HDL64_SMALL
from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.models.fused import _leaves
from light_loam_tpu_torch.models.mapping import MappingState
from light_loam_tpu_torch.ops.features import extract_features
from light_loam_tpu_torch.parallel import sharded
from light_loam_tpu_torch.parallel.sharded import (
    ShardedStepGraph,
    _sharded_step_body,
    shard_mapping_state,
    sharded_mapping_step,
)
from light_loam_tpu_torch.utils.synthetic import World, pad_cloud, simulate_scan
from test_torch_sharded import CFG, _cloud, _clouds_for_frame
from torch_ranks import run_ranks

torch.set_num_threads(2)

N_STEPS = 4
VOTE_CFG = dataclasses.replace(CFG, vote_mode="simple", vote_start_frame=1)
aten = torch.ops.aten
# ops whose result the host must read from the device before it goes on
HOST_READS = {aten._local_scalar_dense, aten.is_nonzero, aten.nonzero,
              aten.masked_select, aten.equal, aten._unique2,
              aten.unique_consecutive, aten.bincount}


class HostRead(RuntimeError):
    pass


class NoHostReads(TorchDispatchMode):
    """Raises ``HostRead`` on every op that reads a device value to the host:
    ``HOST_READS``, ``repeat_interleave`` by a tensor with no output size,
    and indexing or index writes with a boolean mask (whose output size is
    the mask's count).  A CPU run under it shows what a capture on the card
    needs: no op waits for the device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = func.overloadpacket
        if op in HOST_READS:
            raise HostRead(str(func))
        if (func is aten.repeat_interleave.Tensor
                and kwargs.get("output_size") is None):
            raise HostRead(str(func))
        if op in (aten.index, aten.index_put, aten.index_put_,
                  aten._index_put_impl_):
            if any(i is not None and i.dtype in (torch.bool, torch.uint8)
                   for i in args[1]):
                raise HostRead(f"{func} with a boolean mask")
        return func(*args, **kwargs)


def _frames():
    """tests/test_sharded.py's clouds and odometry of ``N_STEPS`` frames."""
    world = World.urban(seed=11)
    rng = np.random.default_rng(0)
    frames = []
    for k in range(N_STEPS):
        pos = np.array([0.5 * k, 0.0, 0.0])
        c, s = _clouds_for_frame(world, pos, rng, seed=30 + k)
        frames.append((c, s, pos.astype(np.float32) + np.float32(0.05)))
    return frames


def _args(frame):
    c, s, t_odom = frame
    return (_cloud(c), _cloud(s), quat.quat_identity(),
            torch.from_numpy(t_odom))


def _graph_rank(group, frames):
    """Per config (vote mode at world 2 only): the static-buffer step and the
    eager step, each carrying its own state from an empty map; whether each
    step's state and outputs are bitwise equal, the collectives of each
    eager pass, the last surf factor count; then the body under
    ``NoHostReads`` from the last state: None, or the read it raised on."""
    out = {}
    configs = [("off", CFG)] + ([("vote", VOTE_CFG)] if group.size > 1 else [])
    for name, cfg in configs:
        graph = ShardedStepGraph(cfg, group, 512, 2048)
        state_g = state_e = shard_mapping_state(MappingState.init(cfg, "cpu"),
                                                group, cfg)
        equal, passes = [], []
        for frame in frames:
            before = group.collectives
            state_e, out_e = sharded_mapping_step(state_e, *_args(frame), cfg,
                                                  group)
            passes.append(group.collectives - before)
            state_g, out_g = graph.run(state_g, *_args(frame))
            equal.append(all(
                torch.equal(a, b) for a, b in zip(
                    _leaves((state_g, out_g)), _leaves((state_e, out_e)))))
        out[name] = dict(equal=equal, collectives=passes,
                         surf_factors=int(out_e.surf_factors),
                         graph_replays=graph.replays,
                         cached=len(sharded._GRAPHS),
                         captures=group.captures, backend=group.backend,
                         host_read=None)
        try:
            with NoHostReads():
                _sharded_step_body(state_e, *_args(frames[-1]), cfg, group)
        except HostRead as e:
            out[name]["host_read"] = str(e)
    return out


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def ranks(frames, tmp_path_factory):
    """Every rank's ``_graph_rank`` result at world 1 and 2 (both groups
    at once)."""
    tmp = tmp_path_factory.mktemp("graph_ranks")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = {n: pool.submit(run_ranks, _graph_rank, n, tmp, frames,
                               timeout=240) for n in (1, 2)}
        return {n: run.result() for n, run in runs.items()}


@pytest.mark.parametrize("n", [1, 2])
def test_static_buffer_step_bitwise_equals_eager(ranks, n):
    for r in ranks[n]:
        assert r["off"]["equal"] == [True] * N_STEPS
        assert r["off"]["surf_factors"] > 100
        # on the CPU the graph's step runs eagerly: nothing was captured
        assert r["off"]["graph_replays"] == 0


def test_static_buffer_step_bitwise_equals_eager_vote_mode(ranks):
    for r in ranks[2]:
        assert r["vote"]["equal"] == [True] * N_STEPS
        assert r["vote"]["surf_factors"] > 100


@pytest.mark.parametrize("n,mode", [(1, "off"), (2, "off"), (2, "vote")])
def test_sharded_body_reads_nothing_to_host(ranks, n, mode):
    for r in ranks[n]:
        assert r[mode]["host_read"] is None, r[mode]["host_read"]


def test_collectives_per_body_pass(ranks):
    """20 a step, 22 with the map vote, the same on every rank; none at
    world 1 (``ShardGroup``'s size-1 shortcuts)."""
    assert CFG.outer_iterations == 2 and CFG.inner_iterations == 4
    for r in ranks[2]:
        assert r["off"]["collectives"] == [20] * N_STEPS
        assert r["vote"]["collectives"] == [22] * N_STEPS
    assert ranks[1][0]["off"]["collectives"] == [0] * N_STEPS


@pytest.mark.parametrize("n", [1, 2])
def test_gloo_group_runs_the_eager_body(ranks, n):
    """gloo's collectives run through the host: no capture, no graph in the
    cache (the step above was built by hand)."""
    for r in ranks[n]:
        assert r["off"]["backend"] == "gloo"
        assert not r["off"]["captures"]
        assert r["off"]["cached"] == 0


def test_guard_raises_on_host_reads():
    """The guard is not vacuous: each kind of host read raises."""
    x = torch.arange(6.0)
    m = x > 2
    reads = [lambda: x.sum().item(), lambda: bool(m.any()), lambda: x[m],
             lambda: torch.nonzero(m), lambda: x.masked_select(m),
             lambda: x.index_put_((m,), torch.zeros(())),
             lambda: torch.arange(3).repeat_interleave(torch.tensor([1, 2, 0]))]
    for read in reads:
        with pytest.raises(HostRead), NoHostReads():
            read()
    with NoHostReads():  # and lets the static forms pass
        x.gather(0, torch.tensor([1, 2]))
        torch.where(m, x, 0.0).sum()
        torch.arange(3).repeat_interleave(2)


@pytest.mark.parametrize("mode", ["exact", "runs"])
def test_extract_features_reads_nothing_to_host(mode):
    cfg = dataclasses.replace(HDL64_SMALL.scan, lessflat_mode=mode)
    pts = simulate_scan(World.urban(seed=5), np.array([0.5, 0.2, 0.0]),
                        n_rings=cfg.n_scans, lower_deg=cfg.lower_bound_deg,
                        upper_deg=cfg.upper_bound_deg, n_azimuth=700,
                        noise=0.01, seed=11)
    xyz, mask = pad_cloud(pts, cfg.max_points)
    with NoHostReads():
        feats = extract_features(torch.as_tensor(xyz), torch.as_tensor(mask),
                                 cfg)
    assert int(feats.less_flat.mask.sum()) > 1000
