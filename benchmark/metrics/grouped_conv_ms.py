"""``grouped_conv_ms``: the median over the replays of the CUDA graph
labelled ``stage2_step`` of the device's time in the MSD's grouped
convolutions that the program runs on its own kernels (groups over
``dense_groups_max_g``): per replay the regions ``grouped_conv.fwd`` and
``grouped_conv.bwd`` (``ops/conv.py::GroupedConv``; a replay's record sums
each region over its calls: every forward, and every input, weight and
second-order gradient), in ms, read by the program's tracer without a
synchronisation or a profiler. None before 8 replays are read, where the
program has no tracer, and where its step opens no such region (a program
whose grouped convolutions are library calls)."""

import statistics

LABEL, REGIONS, MIN_READ = "stage2_step", ("grouped_conv.fwd",
                                           "grouped_conv.bwd"), 8


def replay_ms() -> list:
    """Per read replay of the label, its grouped convolutions' device ms."""
    try:
        from music_synthesis_tpu_torch.utils import profiling
    except ImportError:
        return []
    tracer = getattr(profiling, "tracer", None)
    if tracer is None:
        return []
    log = tracer.snapshot()["programs"].get(LABEL, {})
    return [sum(r["region_ms"].get(n, 0.0) for n in REGIONS)
            for r in log.get("records", ()) if r["replay_ms"] is not None
            and any(n in r["region_ms"] for n in REGIONS)]


def read(records: dict):
    vals = replay_ms()
    return statistics.median(vals) if len(vals) >= MIN_READ else None
