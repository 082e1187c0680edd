"""The harness's arithmetic and contract, on the CPU: seeded plans and
draws, tails over every request, the window's rates, the union of device
intervals, FLOP counts against a hand count, the result line, the
files every cell needs, and the import check."""

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from harness import flops
from harness.config import BENCH, ROOT, load_cell, load_module
from harness.core import Trace, result_line, leaf_gap
from harness.inputs import seeded_params, tone_pool
from reference.arith import device_union, logmel_gemm_flops
from reference.model import WNConv

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_inputs_are_seeded():
    p = {"f0_hz": [55.0, 880.0], "harmonics": 4, "rolloff": [0.5, 2.0],
         "attack_s": 0.01, "decay_s": [0.1, 2.0], "noise": [0.001, 0.03],
         "level": [0.1, 0.7]}
    x = tone_pool(np.random.default_rng(3), 8, 4096, 22050, p)
    y = tone_pool(np.random.default_rng(3), 8, 4096, 22050, p)
    assert np.array_equal(x, y) and np.isfinite(x).all()
    assert len({row.tobytes() for row in x}) == 8
    assert np.abs(x).max() <= 0.7 + 1e-6
    shapes = {"a.v": (3, 4, 5), "a.g": (5,), "a.b": (5,), "l.weight": (6, 4),
              "l.bias": (6,)}
    p1 = seeded_params(shapes, torch.Generator().manual_seed(9), "cpu")
    p2 = seeded_params(shapes, torch.Generator().manual_seed(9), "cpu")
    assert all(torch.equal(p1[k], p2[k]) for k in shapes)
    assert torch.allclose(p1["a.g"], p1["a.v"].square().sum((0, 1)).sqrt())
    assert not p1["a.b"].any() and not p1["l.bias"].any()
    # A gain scales its leaf's draw, and the leaf's norm with it.
    p3 = seeded_params(shapes, torch.Generator().manual_seed(9), "cpu",
                       {"a.v": 0.1})
    assert torch.allclose(p3["a.v"], 0.1 * p1["a.v"])
    assert torch.allclose(p3["a.g"], 0.1 * p1["a.g"])
    assert torch.equal(p3["l.weight"], p1["l.weight"])


def test_union_of_device_intervals():
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert device_union(spans) == (4.0, 6.0)
    assert device_union([]) == (0.0, 0.0)
    tr = Trace([(0.0, 2e6, "k1"), (1e6, 3e6, "logmel_a"), (5e6, 6e6, "k1")],
               [(3.5e6, 4e6, "cudaGraphLaunch")], 7.0)
    assert tr.union_s() == pytest.approx(4.0)
    assert tr.durations("logmel") == [2.0]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k1", 3.0]
    assert bd["idle_gaps"] == [["cudaGraphLaunch after logmel_a", 2.0]]


def test_window_rate_is_work_over_the_whole_window():
    """The drivers' rates: every step or audio second of the window over
    all of its wall time (a tiny training cell on the CPU)."""
    from harness.core import run_cell
    from tiny import train_cell

    ctx = run_cell(train_cell(), device="cpu", seed=3, seconds=1.0,
                   trace=False)
    assert ctx.attempted >= 1
    assert ctx.e2e["train_step_ms"] * ctx.attempted / 1e3 >= 1.0


def test_flops_against_a_hand_count():
    b, cin, cout, k, length, groups = 2, 4, 6, 3, 16, 2
    conv = WNConv(cin, cout, k, groups=groups, padding="valid")
    with torch.no_grad():
        for p in conv.parameters():
            p.normal_()
    x = torch.randn(b, cin, length, requires_grad=True)
    fwd = 2 * b * (length - k + 1) * cout * k * (cin // groups)
    assert flops.count(lambda: conv(x)) == fwd
    assert flops.count(lambda: conv(x).sum().backward()) == 3 * fwd
    lin = torch.nn.Linear(8, 5)
    assert flops.count(lambda: lin(torch.randn(3, 8))) == 2 * 3 * 8 * 5
    # Two GEMMs of the log-mel kernel: [rows, n_fft] x [n_fft, 2 bins] and
    # [rows, bins] x [bins, mels].
    assert logmel_gemm_flops(2, 3, 16, 4) == 2 * 6 * 16 * 18 + 2 * 6 * 9 * 4


def test_leaf_gap_takes_the_larger_of_leaf_and_median():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-6}
    prog = {"a": 1.1, "b": 2.0, "c": 2e-6}
    gap, leaf = leaf_gap(prog, ref)
    assert leaf == "a" and gap == pytest.approx(0.1)
    assert leaf_gap(prog, ref, keep={"b"})[0] == 0.0


def test_result_line_keys():
    from harness.core import Ctx

    cell = load_cell("rich-generate")
    ctx = Ctx(cell, torch.device("cpu"), 1, 1.0, False, 0.0)
    ctx.window_start = 2.5
    ctx.e2e["audio_s_per_s"] = 10.0
    ctx.attempted = 3
    ctx.check("wav_rel_err", 0.0)
    line = result_line(ctx)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["metrics"]["setup_s"] == {"value": 2.5, "unit": "s"}
    assert line["correct"] is True
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}


_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
_UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_and_every_cells_files():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert _NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert _NAME.match(m["name"]) and _UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in SPEC["workloads"]:
        assert _NAME.match(w["name"]) and len(w["why"]) <= 200
        cell = load_cell(w["name"])
        assert (BENCH / "drivers" / f"{cell.traffic['kind']}.py").is_file()
        assert cell.limits and cell.per_layer
        assert len(cell.end_to_end) >= 2


def test_forbidden_modules_compare_whole_names(monkeypatch):
    run = load_module(BENCH / "run.py", "bench_run_main")
    monkeypatch.setitem(sys.modules, "music_synthesis_tpu_torch_x", sys)
    assert "music_synthesis_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "music_synthesis_tpu.ops", sys)
    assert "music_synthesis_tpu.ops" in run.forbidden_modules()


def test_a_run_imports_no_jax():
    """Every driver and reader loaded and a tiny cell run, in a fresh
    process: nothing named jax, jaxlib, flax or music_synthesis_tpu (whole
    top-level names) is imported."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH / 'tests')!r}, {str(ROOT)!r}]
from harness.config import BENCH, load_module
for kind in ("train", "generate"):
    load_module(BENCH / "drivers" / f"{{kind}}.py", "d_" + kind)
for f in (BENCH / "metrics").glob("*.py"):
    load_module(f, "m_" + f.stem.replace(".", "_"))
from harness.core import run_cell
from tiny import train_cell
run_cell(train_cell(), device="cpu", seed=1, seconds=0.5, trace=False)
run = load_module(BENCH / "run.py", "run_main")
print(run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
