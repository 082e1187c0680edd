"""``snake_ms``: the median over the replays of the CUDA graph labelled
``stage2_step`` of the device's time in DAC's Snake activations, forward
and backward: per replay the regions ``snake.fwd`` and ``snake.bwd``
(``ops/snake.py``; a replay's record sums each region over its calls, 58
of each in a step at the published widths), in ms, read by the program's
tracer without a synchronisation or a profiler. None before 8 replays are
read, where the program has no tracer, and where its step runs no Snake."""

import statistics

LABEL, REGIONS, MIN_READ = "stage2_step", ("snake.fwd", "snake.bwd"), 8


def replay_ms() -> list:
    """Per read replay of the label, its Snake calls' device ms."""
    try:
        from music_synthesis_tpu_torch.utils import profiling
    except ImportError:
        return []
    tracer = getattr(profiling, "tracer", None)
    if tracer is None:
        return []
    log = tracer.snapshot()["programs"].get(LABEL, {})
    return [sum(r["region_ms"][n] for n in REGIONS)
            for r in log.get("records", ()) if r["replay_ms"] is not None
            and all(n in r["region_ms"] for n in REGIONS)]


def read(records: dict):
    vals = replay_ms()
    return statistics.median(vals) if len(vals) >= MIN_READ else None
