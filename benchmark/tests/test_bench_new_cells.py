"""The drivers of ``bigvgan-train`` (``drivers/train_amp.py``) and of
``flagship-train-dp4`` (``drivers/train_dp.py``) on
the CPU at sizes a test holds, under the limits of the cells they stand
for: BigVGAN's G at ``config.TINY_BIGVGAN``'s widths with the cell's
recipe (batch 2 x 2048), and the flagship recipe at TINY's widths over
two gloo ranks (batch 1 per rank; the ranks are processes of
``train_dp.py``, as on the cards).

``correct`` comes out false for the control and for each fault its timed
path can have: for BigVGAN the resampling left out (SnakeBeta at the base
rate), ``alpha`` and ``beta`` swapped, the MRF's stacks summed and not
averaged, half the batch left out; for the data-parallel step the
gradient all-reduce left out, planted in every rank. The sound
data-parallel run comes out correct."""

import dataclasses
import json
import textwrap

import pytest
import torch

from harness.config import BENCH, Cell
from harness.core import run_cell
import tiny

SEED = 2 ** 31 + 4242


def _amp_cell() -> Cell:
    from music_synthesis_tpu_torch.config import TINY_BIGVGAN, config_to_dict

    src = json.loads((BENCH / "configs" / "bigvgan.json").read_text())
    t = config_to_dict(TINY_BIGVGAN)
    t["train"] = {**src["train"]["train"], "batch_size": 2,
                  "segment_length": 2048}
    for k in ("compute_dtype", "init_scheme", "res_init_gain",
              "out_init_gain"):
        t["vocoder"][k] = src["train"]["vocoder"][k]
    for k in ("msd", "mrd"):
        t[k]["compute_dtype"] = "bfloat16"
    t["msd"]["dense_groups_max_g"] = src["train"]["msd"]["dense_groups_max_g"]
    traffic = {**json.loads((BENCH / "traffic" / "bigvgan-step.json")
                            .read_text()), "pool_batches": 4}
    limits = json.loads((BENCH / "limits" / "bigvgan-train.json").read_text())
    return Cell("tiny-amp", 1, {"train": t, "state_step": src["state_step"]},
                traffic, limits, [{"name": "setup_s", "unit": "s"},
                                  {"name": "train_step_ms", "unit": "ms"}],
                [])


def _plant(monkeypatch, fault: str) -> None:
    from music_synthesis_tpu_torch.models import vocoder
    from music_synthesis_tpu_torch.ops import alias_free as af
    from music_synthesis_tpu_torch.train import stage2

    if fault == "no_resampling":
        def forward(x, a, b):
            dt = torch.promote_types(x.dtype, torch.float32)
            return af.snake_beta(x.to(dt), a.to(dt), b.to(dt))

        monkeypatch.setattr(af, "_forward", forward)
    elif fault == "swap_ab":
        real = af._forward
        monkeypatch.setattr(af, "_forward", lambda x, a, b: real(x, b, a))
    elif fault == "mrf_sum":
        mrf = vocoder.MRF.forward
        monkeypatch.setattr(vocoder.MRF, "forward",
                            lambda self, x: mrf(self, x) * len(self.names))
    elif fault == "half_batch":
        step = stage2.train_step
        monkeypatch.setattr(stage2, "train_step", lambda cfg, st, wav, *a, **k:
                            step(cfg, st, wav[: wav.shape[0] // 2], *a, **k))


def test_amp_control_fails():
    ctx = run_cell(_amp_cell(), device="cpu", seed=SEED, seconds=0.2,
                   trace=False, control=True)
    assert not ctx.correct, ctx.checks


@pytest.mark.parametrize("fault", ["no_resampling", "swap_ab", "mrf_sum",
                                   "half_batch"])
def test_amp_fault_fails(monkeypatch, fault):
    _plant(monkeypatch, fault)
    ctx = run_cell(_amp_cell(), device="cpu", seed=SEED, seconds=0.2,
                   trace=False)
    assert not ctx.correct, ctx.checks


def _dp_cell(world: int = 2) -> Cell:
    cell = tiny.train_cell(rich=False)
    cell = dataclasses.replace(cell, chips=world)
    cell.config["train"]["train"]["batch_size"] = 1
    cell.traffic = {**json.loads((BENCH / "traffic" / "stage2-step-dp4.json")
                                 .read_text()),
                    "pool_batches": 2, "ranks": world}
    cell.limits = json.loads((BENCH / "limits" / "flagship-train-dp4.json")
                             .read_text())
    return cell


_NO_ALLREDUCE = """
    from music_synthesis_tpu_torch.parallel import mesh

    mesh.all_reduce_mean = lambda tensors, group=None: [
        t.clone() for t in tensors]
"""


@pytest.mark.parametrize("fault", [None, "no_allreduce"])
def test_dp_sound_is_correct_and_its_fault_is_not(monkeypatch, tmp_path,
                                                  fault):
    if fault:
        # every rank: this process, and the ranks' processes at start-up
        (tmp_path / "sitecustomize.py").write_text(
            f"import sys\nsys.path.append({str(BENCH.parent)!r})\n"
            + textwrap.dedent(_NO_ALLREDUCE))
        monkeypatch.setenv("PYTHONPATH", str(tmp_path))
        from music_synthesis_tpu_torch.parallel import mesh

        monkeypatch.setattr(mesh, "all_reduce_mean",
                            lambda tensors, group=None: [
                                t.clone() for t in tensors])
    ctx = run_cell(_dp_cell(), device="cpu", seed=SEED, seconds=0.5,
                   trace=False)
    assert ctx.attempted >= 1
    assert ctx.correct == (fault is None), ctx.checks
