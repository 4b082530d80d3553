"""The PyTorch port's configuration, import boundary and device policy.

The port copies the JAX package's config so that importing it pulls in no
JAX; these tests hold the copy equal to the original field for field, show
that the port imports no JAX at all, and that the options the port does not
implement (or a missing CUDA device) raise instead of running something
else.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from light_loam_tpu.models import pipeline as jax_pipeline
from light_loam_tpu_torch.models import pipeline as torch_pipeline

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("profile", sorted(jax_pipeline.PROFILES))
def test_profiles_match_jax_field_for_field(profile):
    assert sorted(torch_pipeline.PROFILES) == sorted(jax_pipeline.PROFILES)
    want = dataclasses.asdict(jax_pipeline.PROFILES[profile])
    got = dataclasses.asdict(torch_pipeline.PROFILES[profile])
    assert got == want
    # derived capacities (properties, not fields) agree too
    for name in ("max_sharp", "max_less_sharp", "max_flat", "max_less_flat"):
        assert (getattr(torch_pipeline.PROFILES[profile].scan, name)
                == getattr(jax_pipeline.PROFILES[profile].scan, name))


def _run(code, **env):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, **env},
    )


def test_port_imports_no_jax():
    # a subprocess: this test process has jax loaded by tests/conftest.py
    proc = _run(
        "import sys\n"
        "import light_loam_tpu_torch.models.pipeline\n"
        "import light_loam_tpu_torch.convert\n"
        "import light_loam_tpu_torch.models.fused\n"
        "import light_loam_tpu_torch.io.kitti\n"
        "import light_loam_tpu_torch.io.evaluation\n"
        "import light_loam_tpu_torch.core.pose\n"
        "import light_loam_tpu_torch.utils.checkpoint\n"
        "import light_loam_tpu_torch.utils.export\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'light_loam_tpu.')))\n"
        "assert not bad, bad\n"
    )
    assert proc.returncode == 0, proc.stderr


def test_port_refuses_lower_matmul_precision(monkeypatch):
    # the JAX package's tier switch: a CPU run has no cheaper tier and
    # goes on; a CUDA run refuses before it allocates anything on the card
    monkeypatch.setenv("LLT_MATMUL_PRECISION", "high")
    cfg = torch_pipeline.PROFILES["hdl64-small"]
    assert torch_pipeline.Pipeline(cfg, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="LLT_MATMUL_PRECISION"):
        torch_pipeline.Pipeline(cfg, device="cuda")


def test_port_sets_full_fp32_matmuls():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_cuda_pipeline_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_pipeline.Pipeline(torch_pipeline.PROFILES["hdl64-small"],
                                device="cuda")


@pytest.mark.parametrize("section,field,value,error", [
    ("scan", "lessflat_mode", "runs", NotImplementedError),
    ("scan", "lessflat_mode", "bogus", ValueError),
    ("odometry", "plane_vote_mode", "bogus", ValueError),
    ("mapping", "vote_mode", "bogus", ValueError),
    ("mapping", "knn_k", 4, ValueError),
])
def test_unported_options_raise(section, field, value, error):
    """Refused when the Pipeline is built, before any frame."""
    cfg = torch_pipeline.PROFILES["hdl64-small"]
    sub = dataclasses.replace(getattr(cfg, section), **{field: value})
    cfg = dataclasses.replace(cfg, **{section: sub})
    with pytest.raises(error):
        torch_pipeline.Pipeline(cfg, device="cpu")


def test_fused_step_builds():
    """``fused_step=True`` (models/fused.py) is ported: the Pipeline
    builds, and on the CPU captures nothing."""
    cfg = dataclasses.replace(torch_pipeline.PROFILES["hdl64-small"],
                              fused_step=True)
    assert torch_pipeline.Pipeline(cfg, device="cpu").cfg.fused_step
    from light_loam_tpu_torch.models import fused

    assert not fused._GRAPHS
