"""The port's viewers (utils/html_viewer.py, utils/viz.py, the live
dashboard of ``run_synthetic``), twins of tests/test_aux.py's
test_html_viewer_roundtrip, test_viz_renders and test_live_viz_refreshes.
The HTML payload must decode exactly to the masked input points; the PNG
renders need matplotlib (installed here; the card's machine has none, and
there a render raises instead of being skipped).  ~40 s on two CPU
threads (two 4-frame hdl64-small runs at 500 azimuth steps).
"""

import base64
import json
import re
import sys

import numpy as np
import pytest
import torch

from light_loam_tpu_torch.models import pipeline as pl
from light_loam_tpu_torch.utils import viz
from light_loam_tpu_torch.utils.html_viewer import export_html

torch.set_num_threads(2)

RUN = dict(n_frames=4, profile="hdl64-small", n_azimuth=500, speed=0.5,
           seed=3, device="cpu")


def _payload(path):
    text = open(path).read()
    m = re.search(r"const P = (\{.*?\});\n", text, re.S)
    assert m, "payload not found in html"
    return json.loads(m.group(1))


def test_html_viewer_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(500, 3)).astype(np.float32)
    mask = np.ones(500, bool)
    mask[400:] = False
    traj = np.cumsum(rng.normal(size=(20, 3)).astype(np.float32), axis=0)
    path = export_html(str(tmp_path / "v.html"), [("surf", xyz, mask)],
                       [("trajectory", traj)], max_points=1000)
    payload = _payload(path)
    [cloud] = payload["clouds"]
    pts = np.frombuffer(base64.b64decode(cloud["b64"]), np.float32)
    np.testing.assert_array_equal(pts.reshape(-1, 3), xyz[:400])
    [p] = payload["paths"]
    back = np.frombuffer(base64.b64decode(p["b64"]), np.float32)
    np.testing.assert_array_equal(back.reshape(-1, 3), traj)
    # subsampling cap respected
    path2 = export_html(str(tmp_path / "v2.html"), [("surf", xyz, None)],
                        max_points=100)
    assert _payload(path2)["clouds"][0]["n"] == 100


def test_viz_renders(tmp_path):
    pipe, results, truth = pl.run_synthetic(**RUN)
    viz.render_pipeline(pipe, str(tmp_path / "viz"), gt=truth)
    assert (tmp_path / "viz_map.png").stat().st_size > 0
    assert (tmp_path / "viz_traj.png").stat().st_size > 0
    # the HTML view holds the map stores as the pipeline keeps them
    payload = _payload(tmp_path / "viz_view.html")
    surf = {c["name"]: c["n"] for c in payload["clouds"]}["surf"]
    assert surf == int(pipe.map_state.surf.mask.sum())
    mapped = pipe.mapped_positions()
    assert len(mapped) == sum(r.mapped for r in results)
    viz.plot_trajectories(
        str(tmp_path / "tr.png"),
        [("gt", truth), ("est", np.stack([r.odom_t for r in results]))])
    assert (tmp_path / "tr.png").stat().st_size > 0


def test_live_viz_refreshes(tmp_path, monkeypatch):
    """--viz-every: the dashboard is re-rendered in place during the run."""
    calls = []
    real = viz.render_pipeline
    monkeypatch.setattr(
        viz, "render_pipeline",
        lambda pipe, prefix, gt=None: calls.append(prefix) or real(
            pipe, prefix, gt=gt))
    pl.run_synthetic(**RUN, viz_prefix=str(tmp_path / "live"), viz_every=2)
    assert len(calls) == 2  # frames 2 and 4
    assert (tmp_path / "live_view.html").exists()
    assert (tmp_path / "live_map.png").exists()


def test_viz_without_matplotlib_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ModuleNotFoundError, match="needs matplotlib"):
        viz.plot_trajectories("unused.png", [])
    with pytest.raises(ModuleNotFoundError, match="needs matplotlib"):
        pl.main(["--frames", "1", "--profile", "hdl64-small", "--device",
                 "cpu", "--viz", "unused"])
