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
    marks.phases = {}
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


MAP_PHASES = ("mapping.search", "mapping.solve", "mapping.merge")


def _mapping_inputs(seed=0):
    """A mapping step's inputs at HDL64_SMALL's capacities: the empty map
    and two random clouds round the sensor."""
    from light_loam_tpu_torch.core import quaternion as quat
    from light_loam_tpu_torch.core.frame import PointCloud
    from light_loam_tpu_torch.models.mapping import MappingState

    gen = torch.Generator().manual_seed(seed)

    def cloud(n):
        xyz = (torch.rand((n, 3), generator=gen) - 0.5) * 40.0
        return PointCloud(xyz=xyz, rel=torch.zeros(n),
                          mask=torch.rand(n, generator=gen) < 0.5)
    return (MappingState.init(CFG.mapping), cloud(CFG.scan.max_less_sharp),
            cloud(CFG.scan.max_less_flat), quat.quat_identity(),
            torch.zeros(3))


@pytest.mark.parametrize("device", [False, True])
def test_eager_mapping_step_records_its_phases(fake_events, device):
    """Op by op, under open timers: each phase is one sample a stage (the
    search and the solve open once per outer iteration), and the phases
    lie within the stage's own span, on the host clock and (stand-in
    events) on the card's."""
    from light_loam_tpu_torch.models.mapping import mapping_step

    state, corner, surf, q, t = _mapping_inputs()
    timers = StageTimers(device=device)
    for _ in range(2):
        with timers.stage("mapping"):
            state, _ = mapping_step(state, corner, surf, q, t, CFG.mapping)
    assert all(timers.stages[p].count == 2 for p in MAP_PHASES)
    host = sum(timers.stages[p].total_ms for p in MAP_PHASES)
    assert host <= timers.stages["mapping"].total_ms
    report = timers.device_report()
    if not device:
        assert report == {}
        return
    assert all(report[p].count == 2 for p in MAP_PHASES)
    # stand-in events tick 1 ms each: every phase's part is 1 ms
    outer = CFG.mapping.outer_iterations
    assert report["mapping.search"].mean_ms == outer + 1
    assert report["mapping.solve"].mean_ms == outer
    assert report["mapping.merge"].mean_ms == 1
    inner = sum(report[p].total_ms for p in MAP_PHASES)
    assert inner <= report["mapping"].total_ms
    assert not timers._phases and not timers._pending


class FakePhasedGraph(FakeGraph):
    """A captured graph with phases: a replay records the first mark, the
    phases' events in the order of their capture, then the last mark."""

    def __init__(self, marks, order):
        super().__init__(marks)
        self.order = order

    def replay(self):
        self.replays += 1
        self.marks.first.record()
        for ev in self.order:
            ev.record()
        self.marks.last.record()


def test_phases_captured_into_a_graph_fold_with_its_replay(fake_events,
                                                          monkeypatch):
    """Phases opened while a graph is captured record their events into
    the graph, not into the open timers; each replay then gives each
    phase's device ms, its parts added up, beside the graph's own."""
    monkeypatch.setattr(GraphMarks, "_event", staticmethod(FakeEvent))
    marks = GraphMarks()
    capturing = StageTimers(device=True)
    order = []
    with capturing.stage("mapping"), marks.capturing():
        assert timing._CAPTURING.get() is marks
        for name in ("a", "b", "a", "c"):
            with timing.phase(name):
                pass
            order += marks.phases[name][-1]
    assert timing._CAPTURING.get() is None
    assert not any(n in capturing.stages for n in "abc")
    assert {n: len(v) for n, v in marks.phases.items()} == {
        "a": 2, "b": 1, "c": 1}

    graph = FakePhasedGraph(marks, order)
    timers = StageTimers(device=True)
    for _ in range(3):
        with timers.stage("mapping"):
            marks.replay(graph, "mapping")
    report = timers.device_report()
    assert timers.missed == 0
    assert report["a"].count == report["b"].count == 3
    assert report["a"].mean_ms == 2.0 and report["c"].mean_ms == 1.0
    # first, 8 phase events, last: the graph 9 ms, the phases 4 of it
    assert report["mapping.graph"].mean_ms == 9.0
    assert not timers._pending


def test_capture_records_nothing_into_the_open_timers(fake_events):
    """A graph's warm-up and capture passes run with no timers open."""
    timers = StageTimers(device=True)
    with timers.stage("mapping"):
        with timing.untimed():
            assert timing._OPEN.get() is None
            with timing.phase("mapping.search"):
                pass
            with span("mapping.copy_in"):
                pass
        assert timing._OPEN.get() is timers
    assert set(timers.stages) == {"mapping"}


def test_counters_sum_where_they_live_and_report(fake_events, monkeypatch):
    monkeypatch.setattr(timing, "_COUNT_FOLD", 2)
    timers = StageTimers(device=True)
    for n in (1500, 1700, 1600):
        timers.count("mapping.planes", torch.tensor(n, dtype=torch.int32))
    timers.count("mapping.lines", torch.tensor(40, dtype=torch.int32))
    # the first two were summed at the fold, the third is kept as it is
    total, kept, calls = timers.counters["mapping.planes"]
    assert int(total) == 3200 and len(kept) == 1 and calls == 3
    assert timers.counter_report() == {"mapping.planes": (4800, 3),
                                       "mapping.lines": (40, 1)}
    assert "mapping.planes: 1600.0 a call (4800 in 3)" in timers.report()
    timers.reset()
    assert timers.counter_report() == {}


@pytest.mark.cuda
def test_mapping_graph_phases_on_the_card():
    """Flagship sweeps through the staged Pipeline on a card: the mapping
    graph holds the phases' events (the features and odometry graphs none),
    each replay gives every phase once, and the three add up to the
    mapping graph's own span within 5 %; the factor counters are summed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs are captured on one")
    from light_loam_tpu_torch.models import fused
    from light_loam_tpu_torch.models import pipeline as tpl

    cfg = tpl.PROFILES["hdl64"]
    pipe = tpl.Pipeline(cfg, device="cuda")
    try:
        for k, (_, xyz, mask) in enumerate(tpl.synthetic_frames(5, cfg)):
            if k == 2:
                pipe.timers.reset()
            pipe.process_frame(xyz, mask)
        report = pipe.timers.device_report()
        graphs = {s: stages.stage_graph(s, cfg, "cuda") for s in stages.STAGES}
        assert graphs["features"].marks.phases == {}
        assert graphs["odometry"].marks.phases == {}
        outer = cfg.mapping.outer_iterations
        assert {p: len(v) for p, v in graphs["mapping"].marks.phases.items()
                } == {"mapping.search": outer + 1, "mapping.solve": outer,
                      "mapping.merge": 1}
        counters = pipe.timers.counter_report()
    finally:
        stages.clear_graphs()
        fused.clear_graphs()
    assert pipe.timers.missed == 0
    assert all(report[p].count == 3 for p in MAP_PHASES)
    assert report["mapping.graph"].count == 3
    parts = sum(report[p].total_ms for p in MAP_PHASES)
    assert parts == pytest.approx(report["mapping.graph"].total_ms,
                                  rel=0.05), report
    assert counters["mapping.planes"][1] == 3
    assert counters["mapping.planes"][0] > 0
