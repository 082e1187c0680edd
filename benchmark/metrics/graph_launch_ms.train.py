"""``graph_launch_ms.train``: the median over the replays of the CUDA graph
labelled ``stage2_step`` (a training step) of the host's time in
``graph.replay()`` (the program's span ``graph.launch``), in ms, read by
the program's tracer (``tracer.snapshot()``). None before 8 replays are
read, and where the program has no tracer."""

import statistics

LABEL, MIN_READ = "stage2_step", 8


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
    got = _records()
    if len(got) < MIN_READ:
        return None
    return statistics.median(r["launch_ms"] for r in got)
