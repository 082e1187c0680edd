"""``snake_roofline``: the least time the step's Snake calls take
(``snake_least_s``, recorded by ``drivers/train_codec.py``: the bytes they
must move, ``snake_bytes``, at the HBM rate; they are bound by memory)
over their median device time per replay (``snake_ms``), in %. None where
either is missing."""

from harness.config import BENCH, load_module


def read(records: dict):
    least = records.get("snake_least_s")
    took = load_module(BENCH / "metrics" / "snake_ms.py",
                       "bench_metric_snake_ms_r").read(records)
    if least is None or not took:
        return None
    return 100.0 * least / (took / 1e3)
