"""The stage bodies of models/stages.py read nothing to the host, under
every config the smoke run drives staged (chip_smoke.py phases 5-8 and
16, here at hdl64-small): the default, the mapping vote and the "runs"
less-flat downsample here; the latent vote path (full graph votes, the
corner vote, the tiled surf search) and the distortion hook with the
occlusion filter in test_torch_stages_guard_latent.py.  A capture on the
card needs that; here each body runs on the CPU under
tests/test_torch_sharded_graph.py's ``NoHostReads``, which raises on every
op that waits for a device value.  The guarded odometry and mapping
bodies' outputs equal the stage functions', called eagerly (the odometry
stage's full tile sweep against the eager stage's live count read, where
the search is tiled).  ~50 s on two CPU threads.
"""

import pytest
import torch

from chip_smoke import mapping_vote_config, runs_config
from test_torch_sharded_graph import NoHostReads
from test_torch_stages import BASE, assert_trees_equal, frames
from light_loam_tpu_torch.models import stages
from light_loam_tpu_torch.models.mapping import MappingState, mapping_step
from light_loam_tpu_torch.models.odometry import OdometryState, odometry_step
from light_loam_tpu_torch.ops.features import extract_features

torch.set_num_threads(2)

CONFIGS = {
    "default": BASE,
    "mapping vote": mapping_vote_config(BASE),
    "runs": runs_config(BASE),
}


def check_bodies_read_nothing_to_host(cfg) -> None:
    """Frame 0's features and odometry eagerly, then frame 1's three
    stages under the guard, the mapping stage from an empty map (the vote
    gates are device selects and the shapes static, so every op of the
    path runs whatever the data)."""
    (x0, m0), (x1, m1) = ((torch.as_tensor(x), torch.as_tensor(m))
                          for x, m in frames(2, cfg))
    odo = OdometryState.init(cfg.scan.max_less_sharp, cfg.scan.max_less_flat,
                             "cpu")
    odo, _ = odometry_step(odo, extract_features(x0, m0, cfg.scan),
                           cfg.odometry, cfg.scan.scan_period)
    mp = MappingState.init(cfg.mapping, "cpu")

    with NoHostReads():
        feats = stages._features_body(x1, m1, cfg)
        odo_out = stages._odometry_body(odo, feats, cfg)
        new_odo, o = odo_out
        map_out = stages._mapping_body(mp, new_odo.corner_last,
                                       new_odo.surf_last, o.q_w, o.t_w, cfg)

    assert_trees_equal(odo_out, odometry_step(odo, feats, cfg.odometry,
                                              cfg.scan.scan_period))
    assert_trees_equal(map_out, mapping_step(
        mp, new_odo.corner_last, new_odo.surf_last, o.q_w, o.t_w,
        cfg.mapping))
    assert int(o.plane_count) > 100
    assert int(map_out[1].map_surf_points) > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stage_bodies_read_nothing_to_host(name):
    check_bodies_read_nothing_to_host(CONFIGS[name])
