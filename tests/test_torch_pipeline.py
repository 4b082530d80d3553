"""The PyTorch port's whole pipeline against the JAX package's.

The run of ``tests/test_pipeline.py`` (6 frames of the hdl64-small straight
run, 700 azimuth steps, 0.6 m per frame, seed 2) goes through both
packages.  Each frame's odometry and mapped positions agree within 2 cm:
one step agrees to float32 rounding, but the mapping stage's float32
plane fits flip a few percent of their factors under any change of
rounding (see test_torch_mapping.py), which walks the two trajectories a
few mm apart over the run.  Both pass that test's truth gates, and on CPU
tensors no CUDA kernel is launched.
"""

import numpy as np
import pytest
import torch

from light_loam_tpu.models import pipeline as jpl
from light_loam_tpu_torch.models import pipeline as tpl
from light_loam_tpu_torch.ops.cuda_knn import KNN5
from light_loam_tpu_torch.ops.cuda_segsum import SEGSUM
from light_loam_tpu_torch.ops.cuda_vote import VOTE

torch.set_num_threads(2)

RUN = dict(n_frames=6, profile="hdl64-small", n_azimuth=700, speed=0.6,
           seed=2)
AGREE_M = 0.02


def test_pipeline_matches_jax_and_truth():
    _, jres, truth = jpl.run_synthetic(**RUN)
    KNN5.launches = VOTE.launches = SEGSUM.launches = 0
    pipe, tres, ttruth = tpl.run_synthetic(**RUN, device="cpu")
    assert KNN5.launches == 0 and VOTE.launches == 0
    assert SEGSUM.launches == 0
    np.testing.assert_array_equal(ttruth, truth)
    assert len(tres) == len(jres) == 6

    for j, t in zip(jres, tres):
        assert t.mapped == j.mapped
        assert np.linalg.norm(t.odom_t - j.odom_t) < AGREE_M, t.frame
        if j.mapped:
            assert np.linalg.norm(t.map_t - j.map_t) < AGREE_M, t.frame
    np.testing.assert_allclose(pipe.mapped_positions(),
                               np.stack([r.map_t for r in jres if r.mapped]),
                               rtol=0, atol=AGREE_M)

    # the truth gates of tests/test_pipeline.py, for both packages
    for res in (jres, tres):
        assert np.linalg.norm(res[-1].odom_t - truth[-1]) < 0.35
        mapped = [r for r in res if r.mapped]
        assert len(mapped) >= 3
        assert np.linalg.norm(mapped[-1].map_t - truth[mapped[-1].frame]) < 0.5

    q, t = pipe.mapped_trajectory()
    assert q.shape == (len(t), 4) and np.isfinite(q).all()
    rep = pipe.timers.report()
    assert "features" in rep and "odometry" in rep and "mapping" in rep


def test_cli_runs_on_cpu(capsys):
    tpl.main(["--synthetic", "--frames", "1", "--profile", "hdl64-small",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "frames: 1" in out and "final pose error" in out


def test_cli_needs_synthetic_input(capsys, tmp_path):
    """Without --dataset the CLI runs the synthetic world, as the JAX
    package's does; --fused, --chunk and --viz apply there too."""
    small = ["--profile", "hdl64-small", "--device", "cpu"]
    tpl.main(["--frames", "1", *small])
    out = capsys.readouterr().out
    assert "frames: 1" in out and "final pose error" in out
    assert "features" in out and "fused_step" not in out
    tpl.main(["--frames", "1", "--fused", *small])
    assert "fused_step" in capsys.readouterr().out
    tpl.main(["--frames", "2", "--chunk", "2", *small])
    assert "frames: 2 (chunk=2)  final mapped pose error" in (
        capsys.readouterr().out)
    prefix = str(tmp_path / "dash")
    tpl.main(["--frames", "1", "--viz", prefix, *small])
    assert f"viz: {prefix}_map.png" in capsys.readouterr().out
    for name in ("_map.png", "_traj.png", "_view.html"):
        assert (tmp_path / f"dash{name}").stat().st_size > 0


def test_cli_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tpl.main(["--synthetic", "--frames", "1", "--profile", "hdl64-small",
                  "--device", "cuda"])
