"""Tracing and timing helpers (counterpart of ``utils/profiling.py``).

``trace`` wraps ``torch.profiler`` and writes a Chrome/Perfetto trace; the
phases of both training steps are ``region``s under the JAX package's
``jax.named_scope`` names (``frontend``, ``generator_fwd``, ``disc_real`` /
``disc_fake`` or ``disc_both``, ``r1_penalty``, ``d_step``,
``generator_fwd_g``, ``disc_fake_g``, ``disc_real_g``, ``losses``,
``g_step``, ``ema``), and ``infer.generate.generate_long`` opens
``stitch_long_mel`` and ``vocode_chunked``, so a trace splits a step or a
call by phase; ``step_regions`` names the regions a config's step opens
and ``region_split`` reads a trace into time per region. ``device_busy``
is the device's busy share of a window: the union of its activity
intervals (overlapping kernels counted once) over the window.
``time_fn`` times a call with the device synchronised.

Inside a CUDA graph's replay no host code runs, so a profiler sees no
region there. The tracer (``tracer``, on by default) times the replays
themselves, unprofiled:

- ``region(name)`` opens ``record_function(name)``; while a
  ``_graphs.GraphedProgram`` captures (``capture_marks``), it also records
  a timing event at its enter and its exit as nodes of the graph, so every
  replay stamps the region's bounds on the device's clock. On the CPU and
  in eager runs on a card it is ``record_function`` alone.
- Each ``GraphedProgram`` carries a label (``stage2_step``,
  ``stage1_step``, a pipeline function's name) and a ``Clock``: per
  replay, the host's period since the previous replay of that program,
  the host's time in ``graph.replay()`` (``launch_ms``), and the device's
  time between two eager events around the replay (``replay_ms``), with
  each region's ms. A label's counters (``captures``, ``replays``,
  ``unread``, and ``grouped_wgrad2``: the second-order weight terms of
  grouped convolutions its last capture issued, which each replay
  repeats) and a ring of its last ``RING`` replays are
  ``tracer.snapshot()``'s, with the process-wide count of those terms
  (``ops.conv.grouped_wgrad2``) under ``counters``.
- **The tracer never synchronises.** A replay's device times are read at
  the program's next replay, or when the tracer is read, and only when its
  end event says it has ended (``query``); a replay still running at its
  program's next replay is counted ``unread`` and keeps no device times.
  The events are made once per program and recorded again at each replay:
  nothing is allocated on the device per replay.
- ``span(name)`` times host work (the steps' ``step.draws``,
  ``step.inputs``, ``step.read``, ``Programs``' ``pipeline.inputs``, and
  ``graph.launch`` around every replay) into a ring per name, and opens
  ``record_function(name)`` while a profiler runs, so a trace's idle gaps
  lie under named spans on the trace's own clock.
- ``set_tracing(False)`` turns it off: no marks at the next capture, no
  records and no spans. ``medians`` reads the training CLIs' ``trace.*``
  keys from a ring.
"""

from __future__ import annotations

import collections
import contextlib
import json
import statistics
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from music_synthesis_tpu_torch.ops import conv

__all__ = ["trace", "device_events", "device_spans", "device_union",
           "device_busy", "time_fn",
           "step_regions", "region_split", "REGIONS", "OUTSIDE",
           "TRACE_FILE", "region", "span", "capture_marks", "Clock",
           "Tracer", "tracer", "set_tracing", "medians", "RING"]

#: Every region name either step can open (the JAX steps' scope names).
REGIONS = ("frontend", "generator_fwd", "d_step", "disc_both", "disc_real",
           "disc_fake", "r1_penalty", "g_step", "generator_fwd_g",
           "disc_fake_g", "disc_real_g", "losses", "ema")

#: The trace's file name inside ``log_dir``.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """``with trace('/tmp/trace') as prof: step()`` -> ``log_dir/trace.json``
    (Chrome/Perfetto). Traces the CPU, and the card when there is one;
    yields the ``torch.profiler.profile``. Inside it the entry points
    launch eagerly (``_graphs.disable_graphs``): the trace is read by named
    region, and a CUDA graph's replay opens none on the host."""
    from music_synthesis_tpu_torch._graphs import disable_graphs

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with disable_graphs(), profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


def device_events(prof) -> list:
    """The device work in ``prof.key_averages()``: kernels, copies and
    sets, not the device-side spans of the steps' named regions."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key not in REGIONS]


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 20) -> float:
    """Mean seconds per call after ``warmup`` calls, the card synchronised
    (when it is in use) before the clock starts and before it stops."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


def step_regions(cfg, stage: int) -> list[str]:
    """The regions one training step of ``stage`` opens for ``cfg``, in
    order: the ``jax.named_scope`` names the JAX step traces for it."""
    t = cfg.train
    names = ["frontend"] if stage == 2 else []
    names.append("generator_fwd")
    names.append("d_step")
    if stage == 2 and t.concat_disc_batch:
        names.append("disc_both")
    else:
        names += ["disc_real", "disc_fake"]
    if t.r1_gamma > 0:
        names.append("r1_penalty")
    names += ["g_step", "generator_fwd_g", "disc_fake_g"]
    if not (t.reuse_real_features and t.d_input_noise == 0):
        names.append("disc_real_g")
    names.append("losses")
    if t.ema_decay > 0:
        names.append("ema")
    return names


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_events(trace_file: str | Path) -> list[dict]:
    data = json.loads(Path(trace_file).read_text())
    return data["traceEvents"] if isinstance(data, dict) else data


def device_spans(source) -> list[tuple[float, float]]:
    """The ``(start, end)`` µs of every device activity (kernels, copies,
    sets; the Chrome trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``)
    in ``source``, a ``torch.profiler.profile`` that has ended or a Chrome
    trace file, sorted by start."""
    if isinstance(source, (str, Path)):
        events = _trace_events(source)
    else:
        with tempfile.TemporaryDirectory(prefix="busy_") as tmp:
            path = Path(tmp) / TRACE_FILE
            source.export_chrome_trace(str(path))
            events = _trace_events(path)
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("cat") in _DEVICE_CATS)


def device_union(source) -> tuple[float, float]:
    """``(busy, extent)`` µs of the device's activities in ``source`` (a
    source of ``device_spans``, or its list of spans): the length of the
    union of their intervals, where activities that overlap (kernels on
    other streams, or launched with programmatic dependent launch) count
    once, and the span from the first one's start to the last one's end.
    ``(0, 0)`` when the source holds no device activity."""
    spans = source if isinstance(source, list) else device_spans(source)
    if not spans:
        return 0.0, 0.0
    busy, (start, end) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy += end - start
    return busy, end - spans[0][0]


def device_busy(source, window_s: float) -> float:
    """The device's busy share of a window of ``window_s`` seconds: the
    union of the intervals of its activities in ``source`` (``device_union``)
    divided by the window, so the share is at most 1: a window shorter than
    the span from the first activity's start to the last one's end (the
    host's clock against the trace's) is taken as that span. 0 when the
    source holds no device activity."""
    busy, extent = device_union(source)
    return busy / max(window_s * 1e6, extent) if busy else 0.0


#: ``region_split``'s row for device work launched outside every region.
OUTSIDE = "(outside)"


def region_split(trace_file: str | Path, names: list[str], calls: int = 1,
                 top: int = 3, skip: int = 0) -> dict[str, dict]:
    """Per region of ``names`` in a Chrome trace of ``calls`` steps: its
    host ms (the region's span), the device ms and kernel launches of the
    work launched inside it, and its ``top`` kernels by device time, each
    per call. Device work is found by its launch: a kernel (or copy)
    belongs to every region whose host span holds its launch (matched by
    correlation id), on any thread (the backward runs on autograd's thread
    while the region's thread waits). Regions nest as the JAX step's scopes
    do, so a parent's numbers include its children's. The row
    ``OUTSIDE`` holds the device work launched outside every region, and
    in ``no_launch_record`` the launches the trace holds no host record of
    (those cannot be placed). ``skip`` drops the first ``skip`` calls (they
    begin where ``names[0]`` does) and everything before them: in a
    process that ran the profiler before, a trace's first launches can come
    without their host records."""
    events = _trace_events(trace_file)
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in names]
    if skip:
        cut = sorted(t for t, _, n in spans if n == names[0])[skip]
        spans = [sp for sp in spans if sp[0] >= cut]
        events = [e for e in events if e.get("ts", cut) >= cut]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    out = {n: {"host_ms": 0.0, "device_ms": 0.0, "launches": 0.0,
               "top": collections.Counter(), "found": False}
           for n in [*names, OUTSIDE]}
    out[OUTSIDE]["no_launch_record"] = 0
    for start, end, name in spans:
        out[name]["host_ms"] += (end - start) / 1e3 / calls
        out[name]["found"] = True
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        regions = {name for start, end, name in spans
                   if ts is not None and start <= ts <= end} or {OUTSIDE}
        out[OUTSIDE]["no_launch_record"] += ts is None
        for name in regions:
            row = out[name]
            row["device_ms"] += e["dur"] / 1e3 / calls
            if e["cat"] == "kernel":
                row["launches"] += 1 / calls
                row["top"][e["name"][:80]] += e["dur"] / 1e3 / calls
    for row in out.values():
        row["top"] = [[k, v] for k, v in row["top"].most_common(top)]
    return out


# -- the tracer: regions inside graph replays, replays, host spans -----------

#: Replays a label's ring keeps, and spans a name's ring keeps.
RING = 1024

_local = threading.local()  # .marks: the marks of this thread's capture


class _Mark:
    """One region of a captured graph: its name, its depth (0 at the top)
    and the timing events the graph records at its enter and its exit."""

    __slots__ = ("name", "depth", "enter", "exit")

    def __init__(self, name: str, depth: int, enter):
        self.name, self.depth, self.enter, self.exit = name, depth, enter, None


def _timing_event():
    return torch.cuda.Event(enable_timing=True)


@contextlib.contextmanager
def region(name: str):
    """``record_function(name)``; inside ``capture_marks`` also a timing
    event recorded at the enter and the exit (``external``: nodes of the
    graph being captured, recorded again at every replay)."""
    marks = getattr(_local, "marks", None)
    with record_function(name):
        if marks is None:
            yield
            return
        mark = _Mark(name, _local.depth, torch.cuda.Event(
            enable_timing=True, external=True))
        marks.append(mark)
        mark.enter.record()
        _local.depth += 1
        yield
        _local.depth -= 1
        mark.exit = torch.cuda.Event(enable_timing=True, external=True)
        mark.exit.record()


@contextlib.contextmanager
def capture_marks():
    """Collects, in the order they open, the marks that ``region`` records
    in this thread within the block (a graph's capture); yields their list,
    which stays empty while tracing is off."""
    marks: list[_Mark] = []
    if tracer.on:
        _local.marks, _local.depth = marks, 0
    try:
        yield marks
    finally:
        _local.marks = None


class span:
    """``with span(name) as s: ...``: the host's time in the block, into
    ``tracer``'s ring of ``name`` (``time.perf_counter_ns`` at both ends)
    and ``s.ms``; under a running profiler also ``record_function(name)``."""

    __slots__ = ("name", "ms", "_t0", "_fn")

    def __init__(self, name: str):
        self.name, self.ms, self._fn = name, None, None

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self._fn = record_function(self.name)
            self._fn.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.ms = (t1 - self._t0) / 1e6
        if self._fn is not None:
            self._fn.__exit__(*exc)
        if tracer.on:
            tracer.add_span(self.name, self._t0, t1)


class _Log:
    """One label's counters and its ring of replay records."""

    def __init__(self, ring: int):
        self.captures = self.replays = self.unread = 0
        self.grouped_wgrad2 = 0
        self.records: collections.deque = collections.deque(maxlen=ring)


class Clock:
    """The timing of one program's replays (``GraphedProgram``): two eager
    timing events recorded around each replay, the ``marks`` its capture
    recorded, the last replay's record (its period still open) and that
    record while its device times are unread (``pending``)."""

    def __init__(self, label: str, marks=(), event=_timing_event):
        self.label, self.marks = label, list(marks)
        self.start, self.end = event(), event()
        self.last = self.pending = None
        self.last_ns = 0


class Tracer:
    """Counters, replay records and host spans, by label and by span name
    (the module's docstring). One lock guards the counters, the rings and
    the reads of pending replays, so a service's worker thread and a
    reader can share it."""

    def __init__(self, ring: int = RING):
        self.on = True
        self.ring = ring
        self._lock = threading.Lock()
        self._logs: dict[str, _Log] = {}
        self._spans: dict[str, collections.deque] = {}
        self._pending: set[Clock] = set()

    def _log(self, label: str) -> _Log:
        log = self._logs.get(label)
        if log is None:
            log = self._logs[label] = _Log(self.ring)
        return log

    def clock(self, label: str, marks=(), event=_timing_event,
              grouped_wgrad2: int = 0) -> Clock:
        """A new program's clock; counts a capture of ``label``, which
        issued ``grouped_wgrad2`` second-order weight terms."""
        if self.on:
            with self._lock:
                log = self._log(label)
                log.captures += 1
                log.grouped_wgrad2 = grouped_wgrad2
        return Clock(label, marks, event)

    def _settle(self, clock: Clock) -> bool:
        """Reads the device times of ``clock``'s pending record if its
        replay has ended; False while it runs."""
        rec = clock.pending
        if not clock.end.query():
            return False
        rec["replay_ms"] = clock.start.elapsed_time(clock.end)
        ms = rec["region_ms"]
        for m in clock.marks:
            ms[m.name] = ms.get(m.name, 0.0) + m.enter.elapsed_time(m.exit)
        self._drop(clock)
        return True

    def _drop(self, clock: Clock) -> None:
        clock.pending = None
        self._pending.discard(clock)

    def begin(self, clock: Clock) -> dict | None:
        """Before a replay: closes the previous replay's period, reads its
        device times (or counts it ``unread``), opens this replay's record
        and records the start event. None while tracing is off; a replay
        while off also drops the last record's open period and device
        times (the replay overwrites the marks)."""
        if not self.on:
            if clock.last is not None:
                with self._lock:
                    self._drop(clock)
                    clock.last = None
            return None
        now = time.perf_counter_ns()
        with self._lock:
            log = self._log(clock.label)
            if clock.pending is not None and not self._settle(clock):
                log.unread += 1
                self._drop(clock)
            if clock.last is not None:
                clock.last["period_ms"] = (now - clock.last_ns) / 1e6
            log.replays += 1
            rec = {"replay": log.replays, "period_ms": None,
                   "launch_ms": None, "replay_ms": None, "region_ms": {}}
            log.records.append(rec)
            clock.last = clock.pending = rec
            clock.last_ns = now
            self._pending.add(clock)
        clock.start.record()
        return rec

    def end(self, clock: Clock, rec: dict | None, launch_ms: float) -> None:
        """After a replay's launch: records the end event."""
        if rec is not None:
            clock.end.record()
            rec["launch_ms"] = launch_ms

    def add_span(self, name: str, t0_ns: int, t1_ns: int) -> None:
        ring = self._spans.get(name)
        if ring is None:
            with self._lock:
                ring = self._spans.setdefault(
                    name, collections.deque(maxlen=self.ring))
        ring.append((t0_ns, t1_ns))

    def snapshot(self) -> dict:
        """``{"programs": {label: {"captures", "replays", "unread",
        "grouped_wgrad2", "records"}}, "spans": {name: [(start_ns, end_ns),
        ...]}, "counters": {"grouped_wgrad2": n}}``, copies; first reads
        the device times of every replay that has ended."""
        with self._lock:
            for clock in list(self._pending):
                self._settle(clock)
            return {
                "programs": {
                    label: {"captures": log.captures, "replays": log.replays,
                            "unread": log.unread,
                            "grouped_wgrad2": log.grouped_wgrad2,
                            "records": [{**r, "region_ms": dict(
                                r["region_ms"])} for r in log.records]}
                    for label, log in self._logs.items()},
                "spans": {n: list(r) for n, r in self._spans.items()},
                "counters": {"grouped_wgrad2": conv.grouped_wgrad2.n_calls}}

    def reset(self) -> None:
        """Forgets every counter, record and span."""
        with self._lock:
            self._logs.clear()
            self._spans.clear()
            self._pending.clear()


#: The process's tracer, on by default.
tracer = Tracer()


def set_tracing(on: bool) -> None:
    """Turns the tracer on or off for the whole process (off: no marks at
    the next capture, no records, no spans)."""
    tracer.on = bool(on)


def medians(records: list[dict]) -> dict[str, float]:
    """The median over ``records`` (a label's ring, or a part of it) of
    ``d_step_ms``, ``g_step_ms`` (the regions), ``off_graph`` (``1 -
    replay_ms / period_ms``, the share of the host's period the graph did
    not run) and ``graph_launch_ms``; a key is left out where no record
    holds its numbers."""
    out = {}
    read = [r for r in records if r["replay_ms"] is not None]
    for name in ("d_step", "g_step"):
        vals = [r["region_ms"][name] for r in read if name in r["region_ms"]]
        if vals:
            out[f"{name}_ms"] = statistics.median(vals)
    off = [1.0 - r["replay_ms"] / r["period_ms"] for r in read
           if r["period_ms"]]
    if off:
        out["off_graph"] = statistics.median(off)
    launch = [r["launch_ms"] for r in records if r["launch_ms"] is not None]
    if launch:
        out["graph_launch_ms"] = statistics.median(launch)
    return out
