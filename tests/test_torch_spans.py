"""Spans inside the port's stages (utils/timing.py ``span``,
``GraphMarks``; models/stages.py ``StageGraph.run``): the names a run
records into the open timers, nothing recorded with none open, the
profiler ranges, and the timers' events folded and reused so that a window
of any length holds a bounded number.  On the CPU, with a stand-in for
CUDA events and for a captured graph; tests/test_torch_cuda.py holds the
spans to the stage's outer events and to the profiler's kernels on a card.
A few seconds.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from light_loam_tpu_torch.config import HDL64_SMALL
from light_loam_tpu_torch.models import stages
from light_loam_tpu_torch.utils import timing
from light_loam_tpu_torch.utils.timing import (
    GraphMarks,
    StageTimers,
    event_idle_pct,
    span,
)

torch.set_num_threads(2)

CFG = HDL64_SMALL
SPANS = ("copy_in", "launch", "clone_out")


class Clock:
    """A card that has reached every event once ``lag`` more have been
    recorded after it (0: at once); each event 1 ms after the last."""

    def __init__(self, lag: int = 0):
        self.now, self.lag, self.made, self.waits = 0, lag, 0, 0


class FakeEvent:
    clock = Clock()

    def __init__(self):
        FakeEvent.clock.made += 1
        self.at = None

    def record(self):
        FakeEvent.clock.now += 1
        self.at = FakeEvent.clock.now

    def query(self):
        return self.at is not None and \
            FakeEvent.clock.now - self.at >= FakeEvent.clock.lag

    def synchronize(self):
        FakeEvent.clock.waits += 1

    def elapsed_time(self, other):
        return float(other.at - self.at)


@pytest.fixture
def fake_events(monkeypatch):
    FakeEvent.clock = Clock()
    monkeypatch.setattr(timing, "_cuda_event", FakeEvent)
    return FakeEvent.clock


class FakeGraph:
    """A captured graph that records its marks as a replay would."""

    def __init__(self, marks):
        self.marks, self.replays = marks, 0

    def replay(self):
        self.replays += 1
        self.marks.first.record()
        self.marks.last.record()


def fake_marks():
    marks = GraphMarks.__new__(GraphMarks)
    marks.first, marks.last, marks._sample = FakeEvent(), FakeEvent(), None
    return marks


@pytest.fixture
def cheap_features(monkeypatch):
    """The features stage's graph on the CPU with a body of two ops."""
    monkeypatch.setitem(stages._BODIES, "features",
                        lambda xyz, mask, cfg: (xyz * 2.0, mask.logical_not()))
    graph = stages.StageGraph("features", CFG, "cpu")
    n = CFG.scan.max_points
    return graph, torch.ones((n, 3)), torch.ones(n, dtype=torch.bool)


def test_stage_graph_run_records_its_spans_into_the_open_timers(
        cheap_features):
    graph, xyz, mask = cheap_features
    timers = StageTimers()
    for _ in range(3):
        with timers.stage("features"):
            assert timing._OPEN.get() is timers
            out = graph.run(xyz, mask)
    assert timing._OPEN.get() is None
    assert torch.equal(out[0], xyz * 2.0)
    names = {f"features.{s}" for s in SPANS}
    assert set(timers.stages) == names | {"features"}
    assert all(timers.stages[n].count == 3 for n in names)
    # host clock only: no device events, no gap between stages
    assert timers.device_report() == {}
    inner = sum(timers.stages[n].total_ms for n in names)
    assert inner <= timers.stages["features"].total_ms


def test_no_open_timers_and_no_profiler_record_nothing(cheap_features,
                                                       fake_events):
    graph, xyz, mask = cheap_features
    idle = StageTimers(device=True)
    with span("features.copy_in"):
        graph.run(xyz, mask)
    marks = fake_marks()
    made = fake_events.made
    fake = FakeGraph(marks)
    marks.replay(fake, "features")
    assert fake.replays == 1 and marks._sample is None
    # the replay recorded the graph's own marks and made no event
    assert fake_events.made == made
    assert not idle.stages and not idle._pending and not idle._refs
    assert timing._OPEN.get() is None


def test_profiler_ranges_enclose_their_ops(cheap_features):
    graph, xyz, mask = cheap_features
    timers = StageTimers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.stage("features"):
            graph.run(xyz, mask)
    events = prof.events()
    ranges = {e.name: e.time_range for e in events
              if e.name.startswith("features")}
    assert set(ranges) == {"features"} | {f"features.{s}" for s in SPANS}

    def inside(op, rng):
        return any(e.name == op and rng.start <= e.time_range.start
                   and e.time_range.end <= rng.end for e in events)
    assert inside("aten::copy_", ranges["features.copy_in"])
    assert inside("aten::mul", ranges["features.launch"])
    assert inside("aten::logical_not", ranges["features.launch"])
    assert inside("aten::clone", ranges["features.clone_out"])
    for s in SPANS:
        r = ranges[f"features.{s}"]
        assert ranges["features"].start <= r.start <= r.end \
            <= ranges["features"].end
    # the spans and stages run at function scope: the profiler does not
    # mirror them onto a card's rows as it does a user-scope range
    assert all(e.scope == 0 for e in events if e.name in ranges)


def test_graph_marks_give_launch_wait_and_graph_time(fake_events):
    marks = fake_marks()
    graph = FakeGraph(marks)
    timers = StageTimers(device=True)
    for _ in range(3):
        with timers.stage("features"):
            marks.replay(graph, "features")
    report = timers.device_report()
    # before-event -> first mark, first -> last mark: 1 ms each here
    assert report["features.launch"].count == 3
    assert report["features.graph"].count == 3
    assert report["features.graph"].mean_ms == 1.0
    assert report["features.launch"].mean_ms == 1.0
    assert report["features.gap"].count == 2
    assert timers.missed == 0 and not timers._pending


def test_graph_replay_not_reached_is_missed(fake_events):
    fake_events.lag = 10**9        # the card never gets there
    marks = fake_marks()
    graph = FakeGraph(marks)
    timers = StageTimers(device=True)
    with timers.stage("fused_step"):
        for _ in range(4):
            marks.replay(graph, "fused_step")
    assert timers.missed == 3
    report = timers.device_report()
    assert report["fused_step.launch"].count == 1   # the last replay's
    assert "replays not timed" in timers.report()


def test_gap_only_between_top_level_stages(fake_events):
    timers = StageTimers(device=True)
    with timers.stage("features"):
        with timers.stage("inner"):
            with span("inner.part"):
                pass
    with timers.stage("odometry"):
        pass
    report = timers.device_report()
    assert set(report) == {"features", "inner", "inner.part", "odometry",
                           "odometry.gap"}
    assert report["odometry.gap"].count == 1
    # features' end and odometry's start were recorded one after another
    assert report["odometry.gap"].mean_ms == 1.0


@pytest.mark.parametrize("lag", [0, 6])
def test_pending_events_stay_bounded(fake_events, lag):
    """1,000 stages (a 45 s window at 11 sweeps/s) with spans and graph
    marks: the timers hold a bounded number of events, never wait inside
    the window, and report what device_report reported before."""
    fake_events.lag = lag
    marks = {"features": fake_marks(), "odometry": fake_marks()}
    graphs = {k: FakeGraph(m) for k, m in marks.items()}
    timers = StageTimers(device=True)
    held = []
    for i in range(1000):
        name = ("features", "odometry")[i % 2]
        with timers.stage(name):
            with span(name + ".copy_in"):
                pass
            marks[name].replay(graphs[name], name)
            with span(name + ".clone_out"):
                pass
        held.append(len(timers._pending) + len(timers._refs)
                    + len(timers._free))
    assert fake_events.waits == 0
    assert max(held[100:]) == max(held[:100]) <= 60
    assert fake_events.made <= 30
    report = timers.device_report()
    assert report["features"].count == report["odometry"].count == 500
    assert report["features.copy_in"].count == 500
    assert report["odometry.gap"].count == 500
    assert report["features.gap"].count == 499
    assert report["features.graph"].count + timers.missed // 2 <= 500
    assert timers.missed == 0
    assert not timers._pending


def test_reset_and_read_and_report(fake_events):
    timers = StageTimers(device=True)
    with timers.stage("features"):
        pass
    x = torch.arange(3)
    assert timers.read(x).tolist() == [0, 1, 2]
    timers.frame_done()
    assert "host reads: 1.0 a frame (1 in 1 frames)" in timers.report()
    timers.reset()
    assert timers.reads.count == 0 and timers._last_end is None
    assert not timers._pending and not timers._refs
    with timers.stage("odometry"):
        pass
    assert "odometry.gap" not in timers.device_report()


def test_event_idle_pct():
    ms = {"features": 20.0, "odometry": 60.0, "features.launch": 4.0,
          "odometry.launch": 1.0, "features.gap": 2.0, "odometry.gap": 0.0}
    assert event_idle_pct(ms, ["features", "odometry"]) == pytest.approx(
        100.0 * 7.0 / 82.0)
    assert event_idle_pct({"features": 1.0}, ["features"]) is None


def test_gap_across_a_profilers_start_or_stop_is_not_timed(fake_events):
    """The profiler's start and stop (seconds at the end of a traced
    slice) fall between two stages: not the program's wait."""
    timers = StageTimers(device=True)
    with timers.stage("features"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with timers.stage("odometry"):       # started before this stage
            pass
        with timers.stage("features"):       # recording throughout
            pass
    with timers.stage("odometry"):           # stopped before this stage
        pass
    report = timers.device_report()
    assert timers.profiler_gaps == 2
    assert report["features.gap"].count == 1
    assert "odometry.gap" not in report
    assert "profiler's start or stop, not timed: 2" in timers.report()
