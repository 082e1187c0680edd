"""Tracing and timing helpers (counterpart of ``utils/profiling.py``).

``trace`` wraps ``torch.profiler`` and writes a Chrome/Perfetto trace; the
phases of both training steps are ``torch.profiler.record_function``
regions under the JAX package's ``jax.named_scope`` names (``frontend``,
``generator_fwd``, ``disc_real`` / ``disc_fake`` or ``disc_both``,
``r1_penalty``, ``d_step``, ``generator_fwd_g``, ``disc_fake_g``,
``disc_real_g``, ``losses``, ``g_step``, ``ema``), so a trace splits a step
by phase; ``step_regions`` names the regions a config's step opens and
``region_split`` reads a trace into time per region. ``device_busy`` is
the device's busy share of a window: the union of its activity intervals
(overlapping kernels counted once) over the window. ``time_fn`` times a
call with the device synchronised.
"""

from __future__ import annotations

import collections
import contextlib
import json
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile

from music_synthesis_tpu_torch._graphs import disable_graphs

__all__ = ["trace", "device_events", "device_busy", "time_fn",
           "step_regions", "region_split", "REGIONS", "OUTSIDE",
           "TRACE_FILE"]

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


def device_busy(source, window_s: float) -> float:
    """The device's busy share of a window of ``window_s`` seconds: the
    union of the intervals of its activities (kernels, copies, sets; the
    Chrome trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``) in
    ``source``, a ``torch.profiler.profile`` that has ended or a Chrome
    trace file, divided by the window. Activities that overlap (kernels on
    other streams, or launched with programmatic dependent launch) count
    once, so the share is at most 1: a window shorter than the span from
    the first activity's start to the last one's end (the host's clock
    against the trace's) is taken as that span. 0 when the source holds no
    device activity."""
    if isinstance(source, (str, Path)):
        events = _trace_events(source)
    else:
        with tempfile.TemporaryDirectory(prefix="busy_") as tmp:
            path = Path(tmp) / TRACE_FILE
            source.export_chrome_trace(str(path))
            events = _trace_events(path)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") in _DEVICE_CATS)
    if not spans:
        return 0.0
    busy, (start, end) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy += end - start
    return busy / max(window_s * 1e6, end - spans[0][0])


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
