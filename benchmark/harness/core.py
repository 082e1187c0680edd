"""What every window driver shares: the run's context, the device trace,
the comparisons that decide ``correct``, and the result line.

A driver (``drivers/<kind>.py``) has ``run(ctx)``: it sets up the program,
calls ``ctx.open_window()`` when set-up ends, measures for ``ctx.seconds``,
fills ``ctx.e2e`` with its end-to-end metrics and ``ctx.records`` with what
the per-layer readers read, reads ``memory_peak_bytes``, frees the
program, runs the plain reference and records each compared number with
``ctx.check``. With ``ctx.trace`` it also traces a short sub-window of the
device's activity (``trace_device``) after the measured window.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import statistics
import sys
import time
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, schedule

from harness.config import BENCH, ROOT, Cell, load_module, ns
from reference.arith import PEAK_FLOPS, device_union

__all__ = ["Ctx", "Trace", "trace_device", "leaf_gap", "result_line",
           "run_cell", "log"]

TRACE_FILE = ROOT / "build" / "bench_trace" / "trace.json"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Ctx:
    cell: Cell
    device: torch.device
    seed: int
    seconds: float
    trace: bool
    t0: float
    control: bool = False
    window_start: float | None = None
    attempted: int = 0
    failed: int = 0
    e2e: dict = dataclasses.field(default_factory=dict)
    records: dict = dataclasses.field(default_factory=dict)
    checks: list = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None

    @property
    def cfg(self):
        return ns(self.cell.config)

    @property
    def traffic(self):
        return ns(self.cell.traffic)

    @property
    def peaks(self) -> dict:
        if self.device.type != "cuda":
            return {}
        return PEAK_FLOPS.get(torch.cuda.get_device_name(self.device), {})

    def generator(self, salt: int) -> torch.Generator:
        """A generator on the device for one stream of the run's inputs."""
        return torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + salt) % 2 ** 63)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open_window(self) -> float:
        """Ends set-up; returns the window's deadline (perf_counter s)."""
        self.sync()
        self.window_start = time.perf_counter()
        log(f"[{self.cell.name}] set-up {self.window_start - self.t0:.2f} s")
        return self.window_start + self.seconds

    def read_memory_peak(self) -> None:
        if self.device.type == "cuda":
            self.sync()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
                self.device))

    def check(self, name: str, value: float) -> None:
        """Records one compared number beside its limit (a NaN fails)."""
        self.checks.append((name, float(value), float(self.cell.limits[name])))
        log(f"[{self.cell.name}] check {name} {value:.6g} "
            f"(limit {self.cell.limits[name]})")

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(v <= lim for _, v, lim in self.checks))


@dataclasses.dataclass
class Trace:
    """The device's activity in a traced sub-window."""

    spans: list  # (start_us, end_us, name), sorted
    runtime: list  # host-side CUDA API calls, (start_us, end_us, name)
    wall_s: float

    def union_s(self) -> float:
        return device_union([(s, e) for s, e, _ in self.spans])[0] / 1e6

    def durations(self, needle: str) -> list[float]:
        """Seconds of each activity whose name holds ``needle``."""
        return [(e - s) / 1e6 for s, e, n in self.spans if needle in n]

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps named by the host's CUDA calls that overlap them
        and the activity before them."""
        by_name = collections.Counter()
        for s, e, n in self.spans:
            by_name[_short(n)] += (e - s) / 1e6
        merged = []
        for s, e, n in self.spans:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1] = (merged[-1][0], e, n)
            else:
                merged.append((s, e, n))
        gaps = sorted(((s1 - e0, e0, s1, n0) for (_, e0, n0), (s1, _, _)
                       in zip(merged, merged[1:])), reverse=True)[:10]
        named = []
        for gap, e0, s1, n0 in gaps:
            host = collections.Counter(
                _short(n, 40) for s, e, n in self.runtime
                if s < s1 and e > e0)
            what = host.most_common(1)[0][0] if host else "no CUDA call"
            named.append([f"{what} after {_short(n0, 60)}", gap / 1e6])
        return {"device_ops": [[k, v] for k, v in by_name.most_common(10)],
                "idle_gaps": named}


def _short(name: str, n: int = 100) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def trace_device(ctx: Ctx, warm: Callable[[], None],
                 body: Callable[[], None]) -> Trace:
    """``body()`` under ``torch.profiler`` (the device's activity and the
    host's CUDA calls only), after ``warm()`` in the profiler's warm-up
    step; sets ``ctx.busy_s``, ``ctx.window_s`` and ``ctx.breakdown``."""
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        ctx.sync()
        prof.step()
        t = time.perf_counter()
        body()
        ctx.sync()
        wall = time.perf_counter() - t
        prof.step()
    TRACE_FILE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE_FILE))
    data = json.loads(TRACE_FILE.read_text())
    TRACE_FILE.unlink()
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans, runtime = [], []
    for e in events:
        if "dur" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                str(e.get("name", "")))
        if e.get("cat") in _DEVICE_CATS:
            spans.append(span)
        elif e.get("cat") in ("cuda_runtime", "cuda_driver"):
            runtime.append(span)
    tr = Trace(sorted(spans), sorted(runtime), wall)
    ctx.busy_s, ctx.window_s = tr.union_s(), wall
    ctx.breakdown = tr.breakdown()
    log(f"[{ctx.cell.name}] traced {wall:.3f} s: {len(spans)} device "
        f"activities, busy {ctx.busy_s:.4f} s")
    return tr


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap between two norms: ``| |p| - |r| |`` over the
    larger of the reference's norm of that leaf and of the median leaf;
    ``keep`` names the leaves compared (all by default). Returns the gap
    and the leaf."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in ref)
    worst, leaf = 0.0, ""
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def _jsonable(v: float):
    return v if math.isfinite(v) else str(v)


def result_line(ctx: Ctx) -> dict:
    """The run's one result object, ``checks`` last."""
    units = {m["name"]: m["unit"] for m in ctx.cell.end_to_end
             + ctx.cell.per_layer}
    if ctx.trace:
        metrics = {}
        for m in ctx.cell.per_layer:
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                 f"bench_metric_{m['name'].replace('.', '_')}")
            value = reader.read(ctx.records)
            if value is not None:
                metrics[m["name"]] = value
    else:
        metrics = {"setup_s": ctx.window_start - ctx.t0, **ctx.e2e}
    out = {"correct": ctx.correct, "attempted": ctx.attempted,
           "failed": ctx.failed,
           "metrics": {k: {"value": _jsonable(v), "unit": units[k]}
                       for k, v in metrics.items()}}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": ctx.cell.chips,
           "memory_peak_bytes": ctx.memory_peak_bytes}
    if ctx.trace:
        dev["busy_s"], dev["window_s"] = ctx.busy_s, ctx.window_s
    out["device"] = dev
    if ctx.trace and ctx.breakdown:
        out["breakdown"] = ctx.breakdown
    out["checks"] = {n: {"value": _jsonable(v), "limit": lim}
                     for n, v, lim in ctx.checks}
    return out


def run_cell(cell: Cell, *, device, seed: int, seconds: float, trace: bool,
             t0: float | None = None, control: bool = False) -> Ctx:
    """Runs ``cell``'s window driver; returns the filled context."""
    driver = load_module(BENCH / "drivers" / f"{cell.traffic['kind']}.py",
                         f"bench_driver_{cell.traffic['kind']}")
    ctx = Ctx(cell, torch.device(device), seed, seconds, trace,
              time.perf_counter() if t0 is None else t0, control)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    driver.run(ctx)
    return ctx
