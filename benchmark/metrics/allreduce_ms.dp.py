"""``allreduce_ms.dp``: the median over rank 0's replays of the CUDA graph
labelled ``stage2_step`` of the device's time in the region
``grad_allreduce`` (the data-parallel step's all-reduces of D's and of G's
gradients over NCCL, summed per replay), in ms, read by the program's
tracer in the harness's own process (rank 0) without a synchronisation
or a profiler. None before 8 replays are read, where the program has no
tracer, and where its step opens no such region."""

import statistics

LABEL, REGION, MIN_READ = "stage2_step", "grad_allreduce", 8


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
