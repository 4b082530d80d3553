"""Structured per-stage timing — the TicToc replacement (SURVEY.md §5).

Counterpart of ``light_loam_tpu/utils/timing.py``.  The reference wraps
every stage in wall-clock ms timers and warns past the 100 ms real-time
budget (include/aloam_velodyne/tic_toc.h; scanRegistration.cpp:426-427,
laserOdometry.cpp:922-923).  Here the stages are named, with running
mean/max, budget overrun counting and a one-line report.

CUDA work is asynchronous, so the host clock around a stage measures what
the host spent queueing it.  With ``device=True`` each stage also records
a pair of CUDA events on the current stream; ``device_report()`` waits
for them and returns the device time of each stage.  ``profiler_trace``
is the deep dive: a ``torch.profiler`` trace of a region, written to a
directory.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class StageStats:
    count: int = 0
    total_ms: float = 0.0
    max_ms: float = 0.0

    def add(self, ms: float) -> None:
        self.count += 1
        self.total_ms += ms
        self.max_ms = max(self.max_ms, ms)

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.count, 1)


@dataclass
class StageTimers:
    budget_ms: float = 100.0
    device: bool = False
    stages: Dict[str, StageStats] = field(default_factory=dict)
    device_stages: Dict[str, StageStats] = field(default_factory=dict)
    frames: int = 0
    overruns: int = 0
    _frame_start: Optional[float] = None
    _pending: List[Tuple[str, object, object]] = field(default_factory=list)

    @contextmanager
    def stage(self, name: str):
        if self._frame_start is None:
            self._frame_start = time.perf_counter()
        events = None
        if self.device:
            import torch

            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if events is not None:
                events[1].record()
                self._pending.append((name, *events))
            self.stages.setdefault(name, StageStats()).add(
                (time.perf_counter() - t0) * 1000.0
            )

    def frame_done(self) -> None:
        if self._frame_start is not None:
            frame_ms = (time.perf_counter() - self._frame_start) * 1000.0
            self.stages.setdefault("frame", StageStats()).add(frame_ms)
            if frame_ms > self.budget_ms:
                self.overruns += 1
            self._frame_start = None
        self.frames += 1

    def device_report(self) -> Dict[str, StageStats]:
        """Device ms per stage over every stage recorded so far (waits for
        the recorded events)."""
        for name, start, end in self._pending:
            end.synchronize()
            self.device_stages.setdefault(name, StageStats()).add(
                start.elapsed_time(end))
        self._pending.clear()
        return self.device_stages

    @contextmanager
    def profiler_trace(self, log_dir: str):
        """Trace a region with ``torch.profiler`` (host ops, and the CUDA
        kernels when the timers are on the card) and write it into
        ``log_dir`` as ``<host>_<pid>.<time>.pt.trace.json`` (viewable in
        TensorBoard or Perfetto).  Yields the profiler, so the caller can
        read ``events()`` and ``key_averages()`` after the region."""
        from torch.profiler import (
            ProfilerActivity,
            profile,
            tensorboard_trace_handler,
        )

        activities = [ProfilerActivity.CPU]
        if self.device:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
            yield prof

    def reset(self) -> None:
        """Forget every recorded time (e.g. after warm-up frames)."""
        self.device_report()
        self.stages.clear()
        self.device_stages.clear()
        self.frames = 0
        self.overruns = 0

    def report(self) -> str:
        lines = [
            f"{name}: mean {st.mean_ms:.2f} ms, max {st.max_ms:.2f} ms "
            f"({st.count}x)"
            for name, st in sorted(self.stages.items())
        ]
        lines += [
            f"{name} (device): mean {st.mean_ms:.3f} ms, max "
            f"{st.max_ms:.3f} ms ({st.count}x)"
            for name, st in sorted(self.device_report().items())
        ]
        lines.append(
            f"frames: {self.frames}, over {self.budget_ms:.0f} ms budget: "
            f"{self.overruns}"
        )
        return "\n".join(lines)
