"""``vocoder_ms``: the median over the replays of the CUDA graph labelled
``generate_long`` of the device's time in its region ``vocode_chunked``
(the chunked vocoder and the overlap-add of a generation call), in ms:
the timing events that ``utils.profiling.region`` records as nodes of
the graph, read by the program's tracer (``tracer.snapshot()``) without
a synchronisation or a profiler. None before 8 replays are read, and
where the program has no tracer."""

import statistics

LABEL, REGION, MIN_READ = "generate_long", "vocode_chunked", 8


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
    vals = [r["region_ms"][REGION] for r in _records()
            if REGION in r["region_ms"]]
    return statistics.median(vals) if len(vals) >= MIN_READ else None
