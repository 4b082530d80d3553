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

Spans below a stage.  ``stage()`` makes its timers the open ones (a
context variable) for the length of its block, and the program opens
``span``s inside it, which record into the open timers under their own
names: host ms, and on ``device=True`` timers the device ms between CUDA
events on the current stream.  A captured graph carries two timing events
as its first and last nodes (``GraphMarks``), so each replay gives the
launch wait (an event recorded just before ``replay()`` to the graph's
first node) and the graph's own time (first node to last).  Each top-level
stage also records ``<stage>.gap``: from the end of the previous top-level
stage of the same timers to its own start, device time in which the card
waited on the host between stages; a gap across which a ``torch.profiler``
started or stopped recording holds the profiler's own work, not the
program's, and is counted in ``profiler_gaps`` instead.  With no open
stage and no profiler a span does nothing but look both up.  While a
``torch.profiler`` records, every stage and span is also a range of the
same name on its timeline (function scope: the profiler does not mirror
such ranges onto the card's rows, where a reader of the timeline would
count them as device work).

Events are folded into ``device_stages`` at the end of each top-level
``stage()`` once the card has passed them (``query()``, never a wait) and
then reused, so a run of any length holds a bounded number of them;
``device_report()`` waits for the rest.  At a stage's end the card is
still running the stage's work, so the folding costs the card nothing,
where at its start (after a read to the host) the card would wait for it.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch


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


class _Pair:
    """A span's two device events; ``closed`` once folded or dropped."""

    __slots__ = ("name", "start", "end", "closed")

    def __init__(self, name: str, start, end):
        self.name, self.start, self.end = name, start, end
        self.closed = False

    def reached(self) -> bool:
        # start was recorded before end on the same stream
        return self.end.query()


_OPEN: ContextVar[Optional["StageTimers"]] = ContextVar(
    "light_loam_tpu_torch_open_timers", default=None)


def _cuda_event():
    return torch.cuda.Event(enable_timing=True)


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def _profiler_range(name: str):
    """A range of ``name`` on the timeline of the torch.profiler that
    records now, or None when none does."""
    if _profiling():
        return torch._C._profiler._RecordFunctionFast(name)
    return None


@contextmanager
def span(name: str):
    """A span of the open stage, recorded into its timers under ``name``
    (host ms; device ms on ``device=True`` timers), and a profiler range
    while a profiler records."""
    timers = _OPEN.get()
    rng = _profiler_range(name)
    if timers is None and rng is None:
        yield
        return
    with rng or nullcontext():
        if timers is None:
            yield
        else:
            with timers._timed(name):
                yield


class GraphMarks:
    """Two timing events captured into a CUDA graph as its first and last
    nodes (record ``first`` before the captured work and ``last`` after
    it): each replay records them anew.  ``replay`` replays the graph;
    under open ``device=True`` timers it records ``<name>.launch`` (an
    event just before the call to ``first``: the launch wait) and
    ``<name>.graph`` (``first`` to ``last``: the graph's kernels and the
    gaps between them).  They are folded at the graph's next replay with
    ``query()`` (a replay not finished by then is counted in the timers'
    ``missed``) or by the timers themselves, whichever comes first."""

    def __init__(self):
        self.first = torch.cuda.Event(enable_timing=True, external=True)
        self.last = torch.cuda.Event(enable_timing=True, external=True)
        self._sample = None    # (timers, pairs) of the last timed replay

    def replay(self, graph, name: str) -> None:
        if self._sample is not None:
            timers, pairs = self._sample
            timers._settle(pairs)
            self._sample = None
        timers = _OPEN.get()
        rng = _profiler_range(name + ".launch")
        if timers is None and rng is None:
            graph.replay()
            return
        with rng or nullcontext():
            before = (timers._event()
                      if timers is not None and timers.device else None)
            t0 = time.perf_counter()
            graph.replay()
            ms = (time.perf_counter() - t0) * 1000.0
        if timers is None:
            return
        timers._host(name + ".launch", ms)
        if before is not None:
            self._sample = (timers, (
                timers._pair(name + ".launch", before, self.first),
                timers._pair(name + ".graph", self.first, self.last)))


@dataclass
class StageTimers:
    budget_ms: float = 100.0
    device: bool = False
    stages: Dict[str, StageStats] = field(default_factory=dict)
    device_stages: Dict[str, StageStats] = field(default_factory=dict)
    # device-to-host reads of the frame path (``read``): count and host ms
    reads: StageStats = field(default_factory=StageStats)
    frames: int = 0
    overruns: int = 0
    # graph replays whose marks were recorded anew before they were read
    missed: int = 0
    # gaps between stages across which a profiler started or stopped
    profiler_gaps: int = 0
    _frame_start: Optional[float] = None
    _pending: List[_Pair] = field(default_factory=list)
    _free: list = field(default_factory=list)     # events to record again
    _refs: Dict[int, int] = field(default_factory=dict)  # id -> users
    _last_end: object = None    # end event of the last top-level stage
    _last_profiling: bool = False   # whether a profiler recorded then
    _depth: int = 0

    @contextmanager
    def stage(self, name: str):
        if self._frame_start is None:
            self._frame_start = time.perf_counter()
        top = self._depth == 0
        profiling = _profiling()
        rng = _profiler_range(name) if profiling else None
        token = _OPEN.set(self)
        self._depth += 1
        try:
            with rng or nullcontext():
                start = self._event() if self.device else None
                if top and start is not None and self._last_end is not None:
                    if profiling == self._last_profiling:
                        self._pair(name + ".gap", self._last_end, start)
                    else:
                        self.profiler_gaps += 1
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    if start is not None:
                        pair = self._pair(name, start, self._event())
                        if top:
                            self._hold_last(pair.end)
                            self._last_profiling = _profiling()
                            self._fold(wait=False)
                    self._host(name, (time.perf_counter() - t0) * 1000.0)
        finally:
            self._depth -= 1
            _OPEN.reset(token)

    @contextmanager
    def host(self, name: str):
        """A host-clock span recorded into these timers under ``name`` (and
        a profiler range while a profiler records)."""
        with _profiler_range(name) or nullcontext():
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._host(name, (time.perf_counter() - t0) * 1000.0)

    def read(self, x: torch.Tensor) -> np.ndarray:
        """``x`` on the host as a NumPy array, counted and timed in
        ``reads``: the frame path reads the card through here."""
        t0 = time.perf_counter()
        out = x.cpu().numpy()
        self.reads.add((time.perf_counter() - t0) * 1000.0)
        return out

    def frame_done(self) -> None:
        if self._frame_start is not None:
            frame_ms = (time.perf_counter() - self._frame_start) * 1000.0
            self.stages.setdefault("frame", StageStats()).add(frame_ms)
            if frame_ms > self.budget_ms:
                self.overruns += 1
            self._frame_start = None
        self.frames += 1

    def device_report(self) -> Dict[str, StageStats]:
        """Device ms per stage and span over every one recorded so far
        (waits for the recorded events)."""
        self._fold(wait=True)
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
        self._hold_last(None)
        self.stages.clear()
        self.device_stages.clear()
        self.reads = StageStats()
        self.frames = 0
        self.overruns = 0
        self.missed = 0
        self.profiler_gaps = 0

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
        r = self.reads
        lines.append(
            f"host reads: {r.count / max(self.frames, 1):.1f} a frame "
            f"({r.count} in {self.frames} frames), mean {r.mean_ms:.3f} ms, "
            f"max {r.max_ms:.3f} ms")
        if self.missed:
            lines.append(f"graph replays not timed (marks recorded anew "
                         f"first): {self.missed}")
        if self.profiler_gaps:
            lines.append(f"gaps between stages across a profiler's start or "
                         f"stop, not timed: {self.profiler_gaps}")
        lines.append(
            f"frames: {self.frames}, over {self.budget_ms:.0f} ms budget: "
            f"{self.overruns}"
        )
        return "\n".join(lines)

    # -- spans and their events -------------------------------------------
    def _host(self, name: str, ms: float) -> None:
        self.stages.setdefault(name, StageStats()).add(ms)

    @contextmanager
    def _timed(self, name: str):
        start = self._event() if self.device else None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if start is not None:
                self._pair(name, start, self._event())
            self._host(name, (time.perf_counter() - t0) * 1000.0)

    def _event(self):
        """An event of these timers recorded on the current stream."""
        ev = self._free.pop() if self._free else _cuda_event()
        ev.record()
        self._refs[id(ev)] = 0
        return ev

    def _use(self, ev, n: int) -> None:
        """Count a user more (n = 1) or fewer (n = -1) of one of these
        timers' events (a graph's marks are not theirs); an event no one
        uses any more is free to be recorded again."""
        users = self._refs.get(id(ev))
        if users is None:
            return
        if users + n > 0:
            self._refs[id(ev)] = users + n
        else:
            del self._refs[id(ev)]
            self._free.append(ev)

    def _hold_last(self, ev) -> None:
        if ev is not None:
            self._use(ev, 1)
        if self._last_end is not None:
            self._use(self._last_end, -1)
        self._last_end = ev

    def _pair(self, name: str, start, end) -> _Pair:
        pair = _Pair(name, start, end)
        self._use(start, 1)
        self._use(end, 1)
        self._pending.append(pair)
        return pair

    def _close(self, pair: _Pair) -> None:
        self.device_stages.setdefault(pair.name, StageStats()).add(
            pair.start.elapsed_time(pair.end))
        pair.closed = True

    def _settle(self, pairs: Iterable[_Pair]) -> None:
        """Before a graph records its marks anew: fold its last replay's
        pairs if the card has passed them, else drop them as missed."""
        open_pairs = [p for p in pairs if not p.closed]
        if not open_pairs:
            return
        if all(p.reached() for p in open_pairs):
            for p in open_pairs:
                self._close(p)
            return
        self.missed += 1
        for p in open_pairs:
            p.closed = True

    def _fold(self, wait: bool) -> None:
        """Fold the pending pairs the card has passed (with ``wait``, all of
        them, waiting) into ``device_stages`` and free their events."""
        keep = []
        for pair in self._pending:
            if not pair.closed:
                if wait:
                    pair.end.synchronize()
                elif not pair.reached():
                    keep.append(pair)
                    continue
                self._close(pair)
            self._use(pair.start, -1)
            self._use(pair.end, -1)
        self._pending = keep


def event_idle_pct(ms: Dict[str, float], stages: Iterable[str]):
    """The card's idle share of ``stages`` from their spans' device ms
    (means or totals alike): 100 x (launch waits + gaps between stages) /
    (gaps + the stages' own spans).  It counts the card waiting on the host
    outside the graphs' execution, not the gaps between kernels inside a
    graph.  None where a span is missing."""
    stages = list(stages)
    names = ([f"{s}.launch" for s in stages] + [f"{s}.gap" for s in stages]
             + stages)
    if not stages or any(n not in ms for n in names):
        return None
    launch = sum(ms[f"{s}.launch"] for s in stages)
    gap = sum(ms[f"{s}.gap"] for s in stages)
    return 100.0 * (launch + gap) / (gap + sum(ms[s] for s in stages))
