"""The staged frame's three stage graphs (models/stages.py) on the CPU.

On a card each stage of the staged frame is one captured CUDA graph; on
the CPU the same ``StageGraph`` runs the stage's body on its static
buffers: the caller's inputs are copied in and clones of the outputs
handed back, as a replay's are.  Held here, bitwise:

  * each stage against its function, called eagerly on the same inputs,
    over 4 frames of tests/test_torch_pipeline.py's run (hdl64-small, 700
    azimuth steps, 0.6 m per frame, seed 2), the outputs copies of the
    graph's buffers;
  * the cache, ``eager()`` and the checks of ``run``'s inputs.

The Pipeline through the stages against its run under ``stages.eager()``
and against the JAX package's staged Pipeline is in
test_torch_stages_pipeline.py (default, checkpoint), _skip.py
(skip_frame_num=2), _async.py (sync_mapping=False with drops) and
_divergence.py; the bodies under a guard against host reads, for every
config the smoke run drives staged, in _guard.py.  This file also holds
the helpers those files share.  ~25 s on two CPU threads.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from light_loam_tpu_torch.models import fused, stages
from light_loam_tpu_torch.models.mapping import MappingState, mapping_step
from light_loam_tpu_torch.models.odometry import OdometryState, odometry_step
from light_loam_tpu_torch.models.pipeline import (
    PROFILES,
    Pipeline,
    synthetic_frames,
)
from light_loam_tpu_torch.models.stages import _leaves
from light_loam_tpu_torch.ops.features import extract_features

torch.set_num_threads(2)

BASE = PROFILES["hdl64-small"]
# tests/test_torch_pipeline.py's run
RUN = dict(n_azimuth=700, speed=0.6, seed=2)


def frames(n: int, cfg=BASE) -> list:
    """(xyz, mask) numpy frames of the run."""
    return [(xyz, mask) for _, xyz, mask in synthetic_frames(n, cfg, **RUN)]


def assert_trees_equal(got, want) -> None:
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape and x.dtype == y.dtype, i
        assert torch.equal(x, y), f"leaf {i} differs"


def drive(cfg, frame_list, eager=False, pipe=None):
    """``frame_list`` through a CPU Pipeline (``pipe`` or a new one), its
    stages through their graphs' buffers or, with ``eager``, op by op;
    the last mapping step retired.  Returns (pipeline, results)."""
    pipe = pipe or Pipeline(cfg, device="cpu")
    with stages.eager() if eager else contextlib.nullcontext():
        results = [pipe.process_frame(xyz, mask) for xyz, mask in frame_list]
        pipe._retire_mapping(wait=True)
    return pipe, results


def assert_runs_equal(run, ref, first: int = 0) -> None:
    """Two Pipeline runs bitwise: each frame's poses (``run``'s against
    ``ref``'s from frame ``first`` on, where ``run`` resumed there), the
    final states, the mapped trajectory, the keyframes and the counters."""
    (pa, ra), (pb, rb) = run, ref
    assert [r.frame for r in ra] == [r.frame for r in rb[first:]]
    for x, y in zip(ra, rb[first:]):
        assert x.mapped == y.mapped, x.frame
        for name in ("odom_q", "odom_t", "map_q", "map_t"):
            u, v = getattr(x, name), getattr(y, name)
            assert (u is None) == (v is None), (x.frame, name)
            if u is not None:
                np.testing.assert_array_equal(u, v, err_msg=f"{x.frame} {name}")
    assert_trees_equal((pa.odo_state, pa.map_state),
                       (pb.odo_state, pb.map_state))
    for a, b in zip(pa.mapped_trajectory(), pb.mapped_trajectory()):
        np.testing.assert_array_equal(a, b)
    # a resumed run buffers the keyframes of its own frames only
    kb = pb._keyframes[len(pb._keyframes) - len(pa._keyframes):] if first \
        else pb._keyframes
    assert len(pa._keyframes) == len(kb)
    for ka, kb in zip(pa._keyframes, kb):
        for u, v in zip(ka, kb):
            np.testing.assert_array_equal(u, v)
    for name in ("frame", "dropped_mapping_frames", "diverged_frames",
                 "map_saturation_events", "local_overflow_events"):
        assert getattr(pa, name) == getattr(pb, name), name


def jax_drive(cfg_name: str, frame_list, **replace):
    """The same frames through the JAX package's staged Pipeline under its
    profile ``cfg_name`` with ``replace`` applied; the last mapping step
    retired.  Returns (pipeline, results)."""
    from light_loam_tpu.models import pipeline as jpl

    cfg = dataclasses.replace(jpl.PROFILES[cfg_name], **replace)
    pipe = jpl.Pipeline(cfg)
    results = [pipe.process_frame(xyz, mask) for xyz, mask in frame_list]
    pipe._retire_mapping(wait=True)
    return pipe, results


def assert_near_jax(run, jax_run, agree_m: float) -> None:
    """The port's run against the JAX package's within ``agree_m``
    (tests/test_torch_pipeline.py's band): the same frames mapped, dropped
    and contained, each odometry and mapped position within the band."""
    (pt, rt), (pj, rj) = run, jax_run
    assert len(rt) == len(rj)
    for t, j in zip(rt, rj):
        assert t.mapped == j.mapped, t.frame
        assert np.linalg.norm(t.odom_t - np.asarray(j.odom_t)) < agree_m
        if j.map_t is not None:
            assert np.linalg.norm(t.map_t - np.asarray(j.map_t)) < agree_m
    np.testing.assert_allclose(pt.mapped_positions(), pj.mapped_positions(),
                               rtol=0, atol=agree_m)
    assert pt.dropped_mapping_frames == pj.dropped_mapping_frames
    assert pt.diverged_frames == pj.diverged_frames


def _ptrs(tree) -> set:
    return {leaf.data_ptr() for leaf in _leaves(tree)}


def test_stage_graphs_match_the_eager_functions():
    """Per frame, from the eager run's own carried state, each stage's
    graph (here its body on the static buffers) against its function."""
    stages.clear_graphs()
    cfg = BASE
    odo = OdometryState.init(cfg.scan.max_less_sharp, cfg.scan.max_less_flat,
                             "cpu")
    mp = MappingState.init(cfg.mapping, "cpu")
    graphs = stages.stage_graphs(cfg, "cpu")
    static = set().union(*(_ptrs(g.inputs) for g in graphs))
    for xyz, mask in frames(4):
        x, m = torch.as_tensor(xyz), torch.as_tensor(mask)
        feats = extract_features(x, m, cfg.scan)
        got = stages.stage_graph("features", cfg, "cpu").run(x, m)
        assert_trees_equal(got, feats)
        odo_out = odometry_step(odo, feats, cfg.odometry,
                                cfg.scan.scan_period)
        got_odo = stages.stage_graph("odometry", cfg, "cpu").run(odo, feats)
        assert_trees_equal(got_odo, odo_out)
        new_odo, o = odo_out
        map_out = mapping_step(mp, new_odo.corner_last, new_odo.surf_last,
                               o.q_w, o.t_w, cfg.mapping)
        got_map = stages.stage_graph("mapping", cfg, "cpu").run(
            mp, new_odo.corner_last, new_odo.surf_last, o.q_w, o.t_w)
        assert_trees_equal(got_map, map_out)
        # what a stage hands back is a copy, never its buffers
        for out, g in zip((got, got_odo, got_map), graphs):
            assert not _ptrs(out) & (static | _ptrs(g.last))
        odo, mp = new_odo, map_out[0]
    assert int(mp.surf.mask.sum()) > 0
    assert [g.replays for g in graphs] == [4, 4, 4]
    # on the CPU nothing is captured; one StageGraph per stage served all
    assert all(g.graph is None for g in graphs)
    assert stages.stage_graphs(cfg, "cpu") == graphs


def test_configs_share_a_stage_where_its_parts_agree():
    """A stage is cached by the parts of the config it reads: the
    Pipeline's own switches share all three, a mapping option only the
    mapping stage."""
    stages.clear_graphs()
    a = stages.stage_graphs(BASE, "cpu")
    b = stages.stage_graphs(dataclasses.replace(
        BASE, sync_mapping=False, fused_step=True), "cpu")
    assert a == b
    c = stages.stage_graphs(dataclasses.replace(BASE, mapping=dataclasses.replace(
        BASE.mapping, vote_mode="simple")), "cpu")
    assert c[:2] == a[:2] and c[2] is not a[2]
    assert len(stages._GRAPHS) == 4
    fused.clear_graphs()  # clears the stage graphs too
    assert not stages._GRAPHS


def test_eager_runs_the_functions_and_nests():
    assert not stages._EAGER
    with stages.eager():
        with stages.eager():
            assert stages._EAGER
        assert stages._EAGER
        stages.clear_graphs()
        (xyz, mask), = frames(1)
        feats = stages.run_features(xyz, mask, BASE, "cpu")
    assert not stages._EAGER
    assert not stages._GRAPHS  # eager made no StageGraph
    assert_trees_equal(feats, extract_features(
        torch.as_tensor(xyz), torch.as_tensor(mask), BASE.scan))


def test_run_refuses_inputs_of_other_shapes():
    graph = stages.stage_graph("mapping", BASE, "cpu")
    small = dataclasses.replace(BASE, mapping=dataclasses.replace(
        BASE.mapping, map_surf_capacity=BASE.mapping.map_surf_capacity // 2))
    args = (MappingState.init(small.mapping, "cpu"),) + graph.inputs[1:]
    with pytest.raises(ValueError, match="static buffer"):
        graph.run(*args)
    with pytest.raises(ValueError, match="input tensors"):
        graph.run(*graph.inputs[:-1])


@pytest.mark.parametrize("profile", ["hdl64-small", "vlp16"])
def test_feature_buffers_have_the_stage_shapes(profile):
    """The odometry stage's static features are what extract_features
    returns, leaf by leaf, at the profile's widths."""
    scan = PROFILES[profile].scan
    feats = extract_features(torch.zeros(scan.max_points, 3),
                             torch.zeros(scan.max_points, dtype=torch.bool),
                             scan)
    for got, want in zip(_leaves(stages.features_zeros(scan, "cpu")),
                         _leaves(feats)):
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
