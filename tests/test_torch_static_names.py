"""Undefined-global guard for the PyTorch port, chip_smoke.py and the port's
profiling script, with the checker of tests/test_static_names.py (one case
per file)."""

import pytest

from test_static_names import REPO, _undefined_in

FILES = sorted(
    p for p in (REPO / "light_loam_tpu_torch").rglob("*.py")
    if "__pycache__" not in p.parts
) + [REPO / "chip_smoke.py", REPO / "scripts" / "profile_torch.py"]


def test_port_files_found():
    assert len(FILES) > 27
    names = {str(p.relative_to(REPO)) for p in FILES}
    assert {"light_loam_tpu_torch/models/fused.py",
            "light_loam_tpu_torch/io/kitti.py",
            "light_loam_tpu_torch/io/evaluation.py",
            "light_loam_tpu_torch/core/pose.py",
            "light_loam_tpu_torch/utils/checkpoint.py",
            "light_loam_tpu_torch/utils/export.py",
            "light_loam_tpu_torch/solver/schur.py",
            "light_loam_tpu_torch/models/refine.py",
            "light_loam_tpu_torch/utils/viz.py",
            "light_loam_tpu_torch/utils/html_viewer.py",
            "light_loam_tpu_torch/parallel/__init__.py",
            "light_loam_tpu_torch/parallel/sharded.py",
            "light_loam_tpu_torch/parallel/batch_sharded.py",
            "light_loam_tpu_torch/parallel/multihost.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_undefined_globals(path):
    findings = _undefined_in(path)
    assert not findings, "\n".join(findings)
