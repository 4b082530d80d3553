"""StageTimers of the port (utils/timing.py), twin of tests/test_timing.py:
stage statistics, budget-overrun counting, the report, and
``profiler_trace`` writing a ``torch.profiler`` trace to disk (on the CPU
here: host ops only; with ``device=True`` it also records the CUDA kernels,
tests/test_torch_cuda.py).  The JAX test's ``block=`` argument has no twin:
device time comes from the CUDA events of ``device=True``.  ~1 s.
"""

import json
import time

import torch

from light_loam_tpu_torch.utils.timing import StageTimers


def test_stage_stats_accumulate_and_report():
    t = StageTimers(budget_ms=15.0)
    for _ in range(3):
        with t.stage("features"):
            time.sleep(0.002)
        with t.stage("odometry"):
            time.sleep(0.001)
        t.frame_done()
    assert t.frames == 3
    st = t.stages["features"]
    assert st.count == 3
    assert st.mean_ms >= 2.0
    assert st.max_ms >= st.mean_ms
    assert t.stages["frame"].count == 3
    rep = t.report()
    assert "features: mean" in rep and "frames: 3" in rep


def test_budget_overrun_counts_slow_frames_only():
    t = StageTimers(budget_ms=5.0)
    with t.stage("fast"):
        pass
    t.frame_done()
    with t.stage("slow"):
        time.sleep(0.012)
    t.frame_done()
    assert t.overruns == 1
    assert "over 5 ms budget: 1" in t.report()


def test_frame_done_without_stage_counts_frame():
    t = StageTimers()
    t.frame_done()
    assert t.frames == 1
    assert "frame" not in t.stages


def test_reset_forgets_recorded_times():
    t = StageTimers()
    with t.stage("features"):
        pass
    t.frame_done()
    t.reset()
    assert t.frames == 0 and not t.stages and t.device_report() == {}


def test_profiler_trace_writes_artifacts(tmp_path):
    t = StageTimers()
    d = tmp_path / "trace"
    with t.profiler_trace(str(d)) as prof:
        x = torch.ones((8, 8))
        (x @ x).sum()
    traces = [p for p in d.rglob("*.pt.trace.json") if p.is_file()]
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    # the profiler stays readable after the region
    assert any("matmul" in e.key for e in prof.key_averages())
