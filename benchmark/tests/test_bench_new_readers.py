"""The readers of BigVGAN's activations and of the data-parallel step's
all-reduce (``metrics/aa_act_ms.py``, ``aa_act_roofline.py``,
``allreduce_ms.dp.py``) on synthetic tracer snapshots, as
``test_bench_tracer_readers.py`` holds the older ones; and the bytes the
roofline's least time counts (``drivers/train_amp.py::aa_act_bytes``)."""

import math
import statistics
from types import SimpleNamespace

import pytest

from harness.config import BENCH, load_module
from reference.arith import HBM_BYTES_PER_S


def _reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "t_" + name.replace(".", "_"))


def _records(n: int) -> list[dict]:
    """``n`` read replays, one unread, and one whose period is open."""
    recs = [{"replay": i + 1, "period_ms": 300.0, "launch_ms": 0.1,
             "replay_ms": 280.0 + i,
             "region_ms": {"g_step": 200.0, "aa_act.fwd": 40.0 + i,
                           "aa_act.bwd": 80.0 + 2 * (i % 4),
                           "grad_allreduce": 2.0 + 0.1 * (i % 5)}}
            for i in range(n)]
    recs.append({"replay": n + 1, "period_ms": 300.0, "launch_ms": 0.1,
                 "replay_ms": None, "region_ms": {}})
    recs.append({**recs[0], "replay": n + 2, "period_ms": None})
    return recs


class _Tracer:
    def __init__(self, programs):
        self.programs = programs

    def snapshot(self):
        return {"programs": self.programs, "spans": {}}


def _stub(monkeypatch, records, label="stage2_step"):
    from music_synthesis_tpu_torch.utils import profiling

    programs = {label: {"captures": 1, "replays": len(records), "unread": 1,
                        "records": records}} if records is not None else {}
    monkeypatch.setattr(profiling, "tracer", _Tracer(programs))


_VALUES = {"aa_act_ms": lambda r: (r["region_ms"]["aa_act.fwd"]
                                   + r["region_ms"]["aa_act.bwd"]),
           "allreduce_ms.dp": lambda r: r["region_ms"]["grad_allreduce"]}


@pytest.mark.parametrize("name", sorted(_VALUES))
def test_reader_takes_the_median_of_the_read_replays(monkeypatch, name):
    reader = _reader(name)
    recs = _records(11)
    _stub(monkeypatch, recs)
    read = [r for r in recs if r["replay_ms"] is not None]
    assert reader.read({}) == pytest.approx(
        statistics.median(_VALUES[name](r) for r in read))
    _stub(monkeypatch, recs, "generate_long")  # another label's replays
    assert reader.read({}) is None
    _stub(monkeypatch, None)
    assert reader.read({}) is None
    _stub(monkeypatch, _records(6))  # 7 read replays
    assert reader.read({}) is None
    # a step without the regions (rich's, or the parent's program)
    bare = _records(11)
    for r in bare:
        r["region_ms"] = {"g_step": 1.0}
    _stub(monkeypatch, bare)
    assert reader.read({}) is None
    from music_synthesis_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "tracer")
    assert reader.read({}) is None


def test_roofline_is_the_least_time_over_the_median(monkeypatch):
    reader = _reader("aa_act_roofline")
    recs = _records(11)
    _stub(monkeypatch, recs)
    took = _reader("aa_act_ms").read({})
    assert reader.read({"aa_act_least_s": 0.0015}) == pytest.approx(
        100 * 1.5 / took)
    assert reader.read({}) is None
    _stub(monkeypatch, _records(3))
    assert reader.read({"aa_act_least_s": 0.0015}) is None


def test_activation_bytes_at_the_published_widths():
    driver = load_module(BENCH / "drivers" / "train_amp.py", "t_train_amp")
    v = SimpleNamespace(compute_dtype="bfloat16", mrf_kernels=(3, 7, 11),
                        res_dilations=(1, 3, 5), base_channels=1536,
                        upsample_factors=(4, 4, 2, 2, 2, 2))
    got = driver.aa_act_bytes(v, 32, 8192)
    # 109 calls over 629,145,600 input elements a pass: each read and
    # written once forward, read twice and written once backward, in bf16.
    elements = 18 * (32 * 768 * 128 + 5 * 32 * 384 * 512) + 32 * 24 * 8192
    assert elements == 629_145_600
    params = 6 * 4 * (18 * (768 + 384 + 192 + 96 + 48 + 24) + 24)
    assert got == 5 * 2 * elements + params
    assert got / HBM_BYTES_PER_S == pytest.approx(1.878e-3, rel=1e-3)
    assert math.isclose(driver.aa_act_bytes(
        SimpleNamespace(**{**vars(v), "compute_dtype": "float32"}), 32, 8192),
        5 * 4 * elements + params)
