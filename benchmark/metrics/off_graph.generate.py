"""``off_graph.generate``: the median over the replays of the CUDA graph
labelled ``generate_long`` (a generation call) of the share of the
host's period in which the graph did not run on the device, in %: ``1 -
replay_ms / period_ms``, ``period_ms`` the host's time from the replay's
launch to the next launch of the same program, ``replay_ms`` the
device's time between two eager timing events around the replay, read by
the program's tracer (``tracer.snapshot()``) without a synchronisation
or a profiler. None before 8 replays are read, and where the program has
no tracer."""

import statistics

LABEL, MIN_READ = "generate_long", 8


def _records() -> list:
    """The label's ring of replay records, those whose device times were
    read; empty where the program has no tracer."""
    try:
        from music_synthesis_tpu_torch.utils import profiling
    except ImportError:
        return []
    tracer = getattr(profiling, "tracer", None)
    if tracer is None:
        return []
    log = tracer.snapshot()["programs"].get(LABEL, {})
    return [r for r in log.get("records", ()) if r["replay_ms"] is not None]


def read(records: dict):
    vals = [1.0 - r["replay_ms"] / r["period_ms"] for r in _records()
            if r["period_ms"]]
    return (100.0 * statistics.median(vals) if len(vals) >= MIN_READ
            else None)
