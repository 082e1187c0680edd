"""The readers of the program's tracer (``metrics/d_step_ms.py``,
``g_step_ms``, ``vocoder_ms``, ``off_graph.*``, ``graph_launch_ms.*``) on
a synthetic snapshot: each returns the median over its label's read
replays, and None on an empty snapshot, before 8 read replays, and where
the program has no tracer (the parent of the change that added it)."""

import statistics

import pytest

from harness.config import BENCH, load_module

READERS = {
    "d_step_ms": ("stage2_step", lambda r: r["region_ms"]["d_step"]),
    "g_step_ms": ("stage2_step", lambda r: r["region_ms"]["g_step"]),
    "vocoder_ms": ("generate_long",
                   lambda r: r["region_ms"]["vocode_chunked"]),
    "off_graph.train": ("stage2_step",
                        lambda r: 100 * (1 - r["replay_ms"] / r["period_ms"])),
    "off_graph.generate": ("generate_long", lambda r: 100 * (
        1 - r["replay_ms"] / r["period_ms"])),
    "graph_launch_ms.train": ("stage2_step", lambda r: r["launch_ms"]),
    "graph_launch_ms.generate": ("generate_long", lambda r: r["launch_ms"]),
}


def _records(n: int) -> list[dict]:
    """``n`` read replays with distinct numbers, one unread replay, and a
    last replay whose period is still open."""
    recs = [{"replay": i + 1, "period_ms": 50.0 + 3 * i,
             "launch_ms": 0.02 * (i % 5 + 1), "replay_ms": 40.0 + (i % 7),
             "region_ms": {"d_step": 20.0 + i, "g_step": 15.0 - 0.5 * i,
                           "vocode_chunked": 30.0 + (i % 3)}}
            for i in range(n)]
    recs.append({"replay": n + 1, "period_ms": 60.0, "launch_ms": 9.0,
                 "replay_ms": None, "region_ms": {}})
    recs.append({**recs[0], "replay": n + 2, "period_ms": None})
    return recs


class _Tracer:
    def __init__(self, programs):
        self.programs = programs

    def snapshot(self):
        return {"programs": self.programs, "spans": {}}


def _stub(monkeypatch, label, records):
    from music_synthesis_tpu_torch.utils import profiling

    programs = {label: {"captures": 1, "replays": len(records), "unread": 1,
                        "records": records}} if records is not None else {}
    monkeypatch.setattr(profiling, "tracer", _Tracer(programs))


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_takes_the_median_of_the_read_replays(monkeypatch, name):
    label, value = READERS[name]
    reader = load_module(BENCH / "metrics" / f"{name}.py",
                         "m_" + name.replace(".", "_"))
    recs = _records(11)
    _stub(monkeypatch, label, recs)
    read = [r for r in recs if r["replay_ms"] is not None
            and (r["period_ms"] or not name.startswith("off_graph"))]
    assert reader.read({}) == pytest.approx(
        statistics.median(value(r) for r in read))
    # Another label's replays are not this reader's.
    other = "generate_long" if label == "stage2_step" else "stage2_step"
    _stub(monkeypatch, other, recs)
    assert reader.read({}) is None
    _stub(monkeypatch, label, None)
    assert reader.read({}) is None
    _stub(monkeypatch, label, _records(6))  # 7 read, one period open
    assert reader.read({}) is None
    from music_synthesis_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "tracer")  # the parent's program
    assert reader.read({}) is None
