"""The port's tracer (``utils/profiling.py``: ``region``, ``span``,
``Tracer``, ``set_tracing``, ``medians``) on the CPU.

- ``region`` opens the ``record_function`` regions the steps opened
  before, and a TINY stage-2 step's outputs are bit for bit the same with
  tracing on and off (on the CPU no graph is captured, so no mark is
  recorded: ``capture_marks`` stays empty outside a capture, and empty
  while tracing is off).
- On fake timing events, the tracer's lazy read: a replay's device times
  (the replay, each region) are read at the program's next replay or by ``snapshot`` once its end event
  has completed; a replay still running at its program's next replay is
  skipped and counted ``unread``; the host's period closes at the next
  replay. No synchronising function is ever called
  (``torch.cuda.synchronize`` and ``Event.synchronize`` raise).
- The rings stay bounded, and ``set_tracing(False)`` records nothing; a
  replay while tracing is off leaves the record before it unread.
- A ``span`` and a ``record_function`` over the same block nest in a CPU
  ``torch.profiler`` trace around every operator the block ran, and the
  span's own ring holds an interval between those operators' extent and
  its own region's.
- The training CLIs' ``trace.*`` keys (``scripts/_run.py``,
  ``Run.trace_keys``) on a stubbed snapshot: the medians of the replays
  since the last logged line when the tracer holds records, no key when
  it holds none (as on the CPU, which has no graphs).
"""

import dataclasses
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from music_synthesis_tpu_torch.config import TINY
from music_synthesis_tpu_torch.scripts import _run
from music_synthesis_tpu_torch.train import stage2
from music_synthesis_tpu_torch.train.state import state_groups
from music_synthesis_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture
def tracing():
    """The process's tracer, on, emptied before and after the test."""
    profiling.tracer.reset()
    profiling.set_tracing(True)
    yield profiling.tracer
    profiling.set_tracing(True)
    profiling.tracer.reset()


class _Event:
    """A fake timing event: ``record`` stamps the fake device clock's
    ``now``; ``query`` says whether the device has reached it."""

    def __init__(self, device):
        self.device, self.t = device, None

    def record(self, stream=None):
        self.t = self.device.now

    def query(self):
        return self.t is None or self.t <= self.device.done

    def elapsed_time(self, other):
        assert self.query() and other.query(), "read before it completed"
        return other.t - self.t

    def synchronize(self):
        raise AssertionError("the tracer synchronised")


class _Device:
    """A fake device clock: ``now`` where the next event stamps, ``done``
    how far the device has run."""

    def __init__(self):
        self.now, self.done = 0.0, -1.0

    def event(self):
        return _Event(self)


def _mark(device, name, depth, t0, t1):
    m = profiling._Mark(name, depth, device.event())
    m.exit = device.event()
    m.enter.t, m.exit.t = t0, t1
    return m


@pytest.fixture
def no_sync(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the tracer synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", refuse)


def _replay(tracer, clock, device, start, end, launch_ms=0.05):
    """One fake replay: the start event at ``start``, the end at ``end``."""
    device.now = start
    rec = tracer.begin(clock)
    device.now = end
    tracer.end(clock, rec, launch_ms)
    return rec


def test_lazy_read_skips_a_running_replay_and_never_synchronises(no_sync):
    tracer = profiling.Tracer()
    dev = _Device()
    # Regions of a graph recorded at fixed device times (a replay re-stamps
    # them; here every replay stamps the same times).
    marks = [_mark(dev, "d_step", 0, 1.0, 4.0), _mark(dev, "r1", 1, 2.0, 3.0),
             _mark(dev, "g_step", 0, 5.0, 8.5)]
    clock = tracer.clock("step", marks, event=dev.event)
    r1 = _replay(tracer, clock, dev, 0.0, 10.0)
    # Not yet done: the snapshot leaves it pending.
    snap = tracer.snapshot()["programs"]["step"]
    assert snap["captures"] == 1 and snap["replays"] == 1
    assert snap["records"][0]["replay_ms"] is None and snap["unread"] == 0
    dev.done = 10.0
    time.sleep(0.002)
    r2 = _replay(tracer, clock, dev, 0.0, 10.0)  # reads r1 at entry
    assert r1["replay_ms"] == 10.0 and r1["period_ms"] >= 2.0
    assert r1["region_ms"] == {"d_step": 3.0, "r1": 1.0, "g_step": 3.5}
    assert r1["launch_ms"] == 0.05
    # r2 still runs at the next replay: skipped, counted unread.
    dev.done = 5.0
    _replay(tracer, clock, dev, 0.0, 10.0)
    snap = tracer.snapshot()["programs"]["step"]
    assert snap["unread"] == 1 and snap["replays"] == 3
    assert r2["replay_ms"] is None and r2["region_ms"] == {}
    assert r2["period_ms"] is not None  # the host's period still closes
    # The tracer's read settles the last replay once it has ended.
    dev.done = 10.0
    last = tracer.snapshot()["programs"]["step"]["records"][-1]
    assert last["replay_ms"] == 10.0 and last["period_ms"] is None
    assert [r["replay"] for r in tracer.snapshot()["programs"]["step"][
        "records"]] == [1, 2, 3]
    # A replay while tracing is off overwrites the marks: the last record
    # keeps no device times and no period, and nothing is counted.
    dev.done = 20.0
    r4 = _replay(tracer, clock, dev, 20.0, 30.0)
    tracer.on = False
    assert _replay(tracer, clock, dev, 40.0, 50.0) is None
    tracer.on = True
    _replay(tracer, clock, dev, 60.0, 70.0)
    dev.done = 70.0
    assert r4["replay_ms"] is None and r4["period_ms"] is None
    snap = tracer.snapshot()["programs"]["step"]
    assert (snap["replays"], snap["unread"]) == (5, 1)
    assert snap["records"][-1]["replay_ms"] == 10.0


def test_rings_stay_bounded_and_off_records_nothing(no_sync, tracing):
    tracer = profiling.Tracer(ring=4)
    dev = _Device()
    dev.done = 1e9
    clock = tracer.clock("p", event=dev.event)
    for i in range(10):
        _replay(tracer, clock, dev, float(i), i + 0.5)
        tracer.add_span("graph.launch", i, i + 1)
    snap = tracer.snapshot()
    log = snap["programs"]["p"]
    assert log["replays"] == 10 and len(log["records"]) == 4
    assert [r["replay"] for r in log["records"]] == [7, 8, 9, 10]
    assert len(snap["spans"]["graph.launch"]) == 4
    # Off: no capture counted, no record, no span, no mark.
    tracing.reset()
    profiling.set_tracing(False)
    clock = tracing.clock("q", event=dev.event)
    assert tracing.begin(clock) is None
    with profiling.span("step.read"):
        pass
    with profiling.capture_marks() as marks, profiling.region("d_step"):
        pass
    assert marks == []
    snap = tracing.snapshot()
    assert (snap["programs"], snap["spans"]) == ({}, {})


def _cfg():
    return dataclasses.replace(TINY, train=dataclasses.replace(
        TINY.train, batch_size=2, segment_length=2048, r1_gamma=1.0,
        d_input_noise=0.1, ema_decay=0.999))


def _user_annotations(prof_dir):
    events = json.loads((prof_dir / profiling.TRACE_FILE).read_text())[
        "traceEvents"]
    return sorted(e["name"] for e in events
                  if e.get("cat") == "user_annotation")


def test_regions_and_outputs_are_the_same_with_tracing_on_and_off(
        tracing, tmp_path):
    cfg = _cfg()
    state = stage2.make_train_state(cfg, seed=0, device="cpu")
    wav = 0.3 * np.tanh(np.random.default_rng(2).standard_normal(
        (2, 2048))).astype(np.float32)
    runs = {}
    for on in (True, False):
        profiling.set_tracing(on)
        with profiling.trace(tmp_path / str(on)):
            new, metrics = stage2.train_step(cfg, state, wav)
        runs[on] = new, metrics, _user_annotations(tmp_path / str(on))
    (a, ma, na), (b, mb, nb) = runs[True], runs[False]
    assert ma == mb
    for ga, gb in zip(state_groups(a), state_groups(b)):
        assert all(torch.equal(ga[k], gb[k]) for k in ga)
    regions = set(profiling.step_regions(cfg, 2))
    assert regions <= set(na) and [n for n in na if n in regions] == [
        n for n in nb if n in regions]
    # Under the profiler the host spans open record_function regions too.
    assert {"step.read"} <= set(na)


def test_span_lines_up_with_record_function(tracing):
    """The span and a ``record_function`` around the same block bracket the
    same work: in a CPU profiler trace the span's region encloses the
    ``record_function``'s, which encloses every operator the block ran,
    and the span's own ring holds an interval no shorter than those
    operators' extent and no longer than its own region. Nesting, not
    clock distances, so a worker's scheduling cannot move it."""
    slack = 2.0  # us: the profiler's and perf_counter's clocks' rounding
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("step.inputs"), \
                torch.profiler.record_function("same"):
            t = time.perf_counter()
            while time.perf_counter() - t < 0.005:
                torch.ones(64) @ torch.ones(64)
    events = prof.events()
    named = {e.name: e.time_range for e in events
             if e.name in ("step.inputs", "same")}
    s, r = named["step.inputs"], named["same"]
    work = [e.time_range for e in events
            if e.name in ("aten::ones", "aten::matmul")]
    assert work
    first, last = min(w.start for w in work), max(w.end for w in work)
    assert s.start <= r.start <= first and last <= r.end <= s.end
    (t0, t1), = tracing.snapshot()["spans"]["step.inputs"]
    span_us = (t1 - t0) / 1e3
    assert last - first - slack <= span_us <= s.end - s.start + slack


def _record(replay, d, g, replay_ms, period_ms, launch_ms):
    return {"replay": replay, "period_ms": period_ms, "launch_ms": launch_ms,
            "replay_ms": replay_ms, "region_ms": {"d_step": d, "g_step": g}}


class _Stub:
    def __init__(self, records):
        self.records = records

    def snapshot(self):
        if not self.records:
            return {"programs": {}, "spans": {}}
        return {"programs": {"stage2_step": {
            "captures": 1, "replays": len(self.records), "unread": 0,
            "records": [dict(r) for r in self.records]}}, "spans": {}}


def test_run_logs_the_tracers_medians_since_the_last_line(monkeypatch):
    run = _run.Run.__new__(_run.Run)
    run.program, run.traced = "stage2_step", 0
    monkeypatch.setattr(_run, "tracer", _Stub([]))
    assert run.trace_keys() == {}  # no graphs: no key
    records = [_record(i + 1, 10.0 + i, 20.0 + i, 40.0, 50.0, 0.1 * (i + 1))
               for i in range(5)]
    records[-1]["period_ms"] = None  # the last replay's period is open
    monkeypatch.setattr(_run, "tracer", _Stub(records))
    keys = run.trace_keys()
    assert keys == {"trace.d_step_ms": 12.0, "trace.g_step_ms": 22.0,
                    "trace.off_graph": pytest.approx(0.2),
                    "trace.graph_launch_ms": pytest.approx(0.3)}
    assert run.traced == 5
    records.append(_record(6, 30.0, 40.0, 45.0, 50.0, 1.0))
    assert run.trace_keys() == {
        "trace.d_step_ms": 30.0, "trace.g_step_ms": 40.0,
        "trace.off_graph": pytest.approx(0.1), "trace.graph_launch_ms": 1.0}
    assert run.trace_keys() == {}  # nothing new since the last line


def test_run_writes_the_keys_into_the_logged_line(monkeypatch, tmp_path):
    from music_synthesis_tpu_torch.train.metrics import MetricsLogger

    run = _run.Run.__new__(_run.Run)
    run.args = SimpleNamespace(debug_nans=False, log_every=1,
                               ckpt_every=10 ** 6)
    run.main, run.guard, run.program, run.traced = True, None, \
        "stage2_step", 0
    run.logger = MetricsLogger(str(tmp_path / "metrics.jsonl"), echo=False)
    monkeypatch.setattr(_run, "tracer", _Stub(
        [_record(1, 1.0, 2.0, 3.0, 4.0, 0.5)]))
    run.after(0, True, None, {"g_loss": 2.0, "d_loss": 1.0})
    monkeypatch.setattr(_run, "tracer", _Stub([]))
    run.after(1, False, None, {"g_loss": 2.0, "d_loss": 1.0})
    run.logger.close()
    lines = [json.loads(x) for x in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert list(lines[0])[2:] == ["d_loss", "g_loss", "trace.d_step_ms",
                                  "trace.g_step_ms", "trace.off_graph",
                                  "trace.graph_launch_ms"]
    assert list(lines[1])[2:] == ["d_loss", "g_loss"]
