"""The metric arithmetic: the tail over every frame, rates over the whole
window, and the idle share from one timeline that overlaps itself."""

import numpy as np
import pytest

from harness import runner, trace
from harness.roofline import knn_bound


class Ev:
    def __init__(self, name, start, dur, cuda=False):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"


def test_p95_is_over_every_frame():
    times = np.concatenate([np.full(95, 0.05), np.full(5, 0.2)])
    np.random.default_rng(0).shuffle(times)
    # numpy's linear percentile of all 100 values, not a mean of chunks
    assert runner.percentile95(times) == pytest.approx(
        np.percentile(times, 95))
    assert runner.percentile95(times) > 0.05


def test_idle_share_from_overlapping_intervals():
    ms = 1_000_000
    events = [Ev(trace.UNIT, 0, 100 * ms), Ev(trace.UNIT, 100 * ms, 100 * ms),
              # kernels that overlap each other and a copy, one past the end
              Ev("void k1<float>(float*)", 10 * ms, 30 * ms, True),
              Ev("void k2<float>(float*)", 20 * ms, 30 * ms, True),
              Ev("Memcpy HtoD (Pinned -> Device)", 45 * ms, 10 * ms, True),
              Ev("void k3<float>(float*)", 190 * ms, 50 * ms, True),
              Ev("cudaGraphLaunch", 60 * ms, 120 * ms),
              Ev("cudaLaunchKernel", 5 * ms, 1 * ms)]
    s = trace.summarize(events)
    assert s["units"] == 2 and s["window_s"] == pytest.approx(0.2)
    # busy: [10, 55] and [190, 200] ms
    assert s["busy_s"] == pytest.approx(0.055)
    idle = runner.idle_pct(s)
    assert 0.0 <= idle <= 100.0
    assert idle == pytest.approx(72.5)
    assert s["kernels"] == 3 and s["launches"] == 2
    assert s["idle_gaps"][0][0] == "cudaGraphLaunch"
    assert s["idle_gaps"][0][1] == pytest.approx(0.135)


def test_idle_share_outside_0_100_fails():
    with pytest.raises(Exception):
        runner.idle_pct({"window_s": 1.0, "busy_s": 1.5})


def test_short_kernel_names_keep_the_functor():
    name = ("void at::native::vectorized_elementwise_kernel<4, "
            "at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3> >"
            "(int, at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3>)")
    assert trace.short_name(name) == "vectorized_elementwise_kernel/CUDAFunctor_add"
    assert trace.short_name("knn5_segment_kernel(float const*)") == "knn5_segment_kernel"


def test_rates_are_work_over_the_window():
    # a rate is all the work over all the window: 480 frames in 40 s
    assert 480 / 40.0 == 12.0


def test_knn_bound_counts_live_pairs():
    t, by = knn_bound(8192, [(5000, 24000)])
    assert by == "operations"
    assert t == pytest.approx(8 * 5000 * 24000 / 67e12)


def test_annotations_mirrored_on_the_device_are_not_busy_time():
    ms = 1_000_000
    events = [Ev(trace.UNIT, 0, 100 * ms), Ev(trace.UNIT, 0, 100 * ms, True),
              Ev("ProfilerStep#3", 0, 100 * ms),
              Ev("void k1<float>(float*)", 10 * ms, 10 * ms, True)]
    s = trace.summarize(events)
    assert s["units"] == 1
    assert s["busy_s"] == pytest.approx(0.010)
    assert runner.idle_pct(s) == pytest.approx(90.0)


def _plan(spread, runs=4, units=3, seconds=100.0, profiled=False):
    import torch

    from harness import window

    mix = {"compare": {"runs": runs, "units": units, "spread": spread},
           "profile": {"skip": 5, "units": 3}}
    src = (torch.zeros(4), (torch.zeros(2, 3),))
    plan = window.Plan({"seed": 2**31 + 9, "seconds": seconds}, mix, src, src,
                       profiled=profiled)
    for n in range(1, int(seconds * 10) + 1):
        src[0].fill_(n)        # the program's state moves on in place
        src[1][0].fill_(n)
        plan.starts(n, n * 0.1, lambda b: src, lambda b: src)
        plan.ends(n, lambda b: src, lambda b: src)
    return plan


def test_runs_start_across_the_whole_window_and_hold_their_own_copies():
    plan = _plan([0.05, 0.9])
    starts = sorted(r["start"] for r in plan.runs)
    assert starts[0] == 0 and len(starts) == 4
    assert starts[-1] > 500          # the last laps are judged too
    for r in plan.runs:
        for j, i in enumerate(r["odos"]):
            if i is not None:
                # the copy holds the state at the run's boundary j
                assert float(plan.odo.bufs[i][0][0]) == r["start"] + j
        assert float(plan.map.bufs[r["maps"][3]][1][0][0, 0]) == r["start"] + 3


def test_no_copy_falls_inside_the_profiled_slice():
    plan = _plan([0.0, 0.0], runs=5, profiled=True)
    first, n = 6, 3
    for r in plan.runs:
        if r.get("profiled"):
            assert (r["start"], r["units"]) == (first, n)
            continue
        if r["start"] == 0:
            continue
        s, e = r["start"], r["start"] + r["units"]
        assert not first + 1 <= s <= first + n
        assert not first <= e <= first + n - 1
