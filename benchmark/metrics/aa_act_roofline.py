"""``aa_act_roofline``: the least time the step's anti-aliased activations
take (``aa_act_least_s``, recorded by ``drivers/train_amp.py``: the bytes
they must move, ``aa_act_bytes``, at the HBM rate; they are bound by
memory) over their median device time per replay (``aa_act_ms``), in %.
None where either is missing."""

from harness.config import BENCH, load_module


def read(records: dict):
    least = records.get("aa_act_least_s")
    took = load_module(BENCH / "metrics" / "aa_act_ms.py",
                       "bench_metric_aa_act_ms_r").read(records)
    if least is None or not took:
        return None
    return 100.0 * least / (took / 1e3)
