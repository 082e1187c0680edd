"""``rvq_ms``: the median over the replays of the CUDA graph labelled
``stage2_step`` of the device's time in DAC's residual vector quantizer,
the region ``rvq`` around its stages in G's forward
(``models/codec.py``; 9 stages a step at the published widths), in ms,
read by the program's tracer without a synchronisation or a profiler.
None before 8 replays are read, where the program has no tracer, and
where its step runs no quantizer."""

import statistics

LABEL, REGION, MIN_READ = "stage2_step", "rvq", 8


def read(records: dict):
    try:
        from music_synthesis_tpu_torch.utils import profiling
    except ImportError:
        return None
    tracer = getattr(profiling, "tracer", None)
    if tracer is None:
        return None
    log = tracer.snapshot()["programs"].get(LABEL, {})
    vals = [r["region_ms"][REGION] for r in log.get("records", ())
            if r["replay_ms"] is not None and REGION in r["region_ms"]]
    return statistics.median(vals) if len(vals) >= MIN_READ else None
