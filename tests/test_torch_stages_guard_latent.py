"""The stage bodies of models/stages.py under the host-read guard of
test_torch_stages_guard.py, for the two configs that file leaves to this
one (chip_smoke.py phases 7 and 8, here at hdl64-small): the latent vote
path (the full graph vote for odometry planes and in mapping, the simple
corner vote with scalar edge factors, and the tiled surf search, whose
stage body sweeps every tile where the eager stage reads the live count)
and the distortion hook with the occlusion filter.  ~40 s on two CPU
threads.
"""

import pytest
import torch

from chip_smoke import latent_vote_config, undistort_config
from test_torch_stages import BASE
from test_torch_stages_guard import check_bodies_read_nothing_to_host

torch.set_num_threads(2)

CONFIGS = {
    "latent vote": latent_vote_config(BASE),
    "undistort": undistort_config(BASE),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stage_bodies_read_nothing_to_host(name):
    check_bodies_read_nothing_to_host(CONFIGS[name])
