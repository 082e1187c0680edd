"""``correct`` comes out false for each cell's control and for each fault
its timed path can have, at sizes a CPU test holds (``tiny.py``), under
the limits of the cell each stands for. The harness runs as
``benchmark/run.py`` runs it, less the look for a card; the fault is
planted in the program underneath.

On a card (``-m gpu``, ``-s`` to see the readings),
``test_control_on_the_card`` runs each cell's control at the cell's own
size, and ``test_fault_on_the_card`` plants the training cells'
half-batch fault and the STFT term left out of G's loss at theirs."""

import dataclasses

import pytest
import torch

from harness.config import load_cell
from harness.core import run_cell
import tiny

SEED = 2 ** 31 + 12345


def _run(cell, control=False, seconds=0.5):
    return run_cell(cell, device="cpu", seed=SEED, seconds=seconds,
                    trace=False, control=control)


@pytest.mark.parametrize("rich", [False, True], ids=["flagship", "rich"])
def test_train_control_fails(rich):
    ctx = _run(tiny.train_cell(rich), control=True)
    assert not ctx.correct, ctx.checks


# A G-side fault: a term left out of G's loss, and so of its gradient.
_G_TERMS = {"no_stft_in_g": "lambda_stft",
            "no_fm_in_g": "lambda_feature_matching"}


def _broken_step(monkeypatch, fault: str) -> None:
    """Plants ``fault`` in the program's ``stage2.train_step``: the state
    returned unchanged; half of the batch left out (the step's means then
    taken over the other half); or the STFT or feature-matching term left
    out of G's loss (its weight zeroed; neither term is in D's)."""
    from music_synthesis_tpu_torch.train import stage2

    real = stage2.train_step

    def broken(cfg, state, wav, *args, **kwargs):
        if fault == "half_batch":
            return real(cfg, state, wav[: wav.shape[0] // 2], *args,
                        **kwargs)
        if fault in _G_TERMS:
            train = dataclasses.replace(cfg.train, **{_G_TERMS[fault]: 0.0})
            return real(dataclasses.replace(cfg, train=train), state, wav,
                        *args, **kwargs)
        _, metrics = real(cfg, state, wav, *args, **kwargs)
        return state, metrics

    monkeypatch.setattr(stage2, "train_step", broken)


@pytest.mark.parametrize("rich", [False, True], ids=["flagship", "rich"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   *_G_TERMS])
def test_train_faults_fail(fault, rich, monkeypatch):
    _broken_step(monkeypatch, fault)
    ctx = _run(tiny.train_cell(rich))
    assert not ctx.correct, ctx.checks


def test_generate_control_fails():
    ctx = _run(tiny.generate_cell(), control=True)
    assert not ctx.correct, ctx.checks


def test_generate_altered_answer_fails(monkeypatch):
    from music_synthesis_tpu_torch.infer import generate

    real = generate.generate_long

    def broken(cfg, composer, vocoder, z, *static):
        wav = real(cfg, composer, vocoder, z, *static).clone()
        wav[0, : wav.shape[1] // 10] = 0.0
        return wav

    monkeypatch.setattr(generate, "generate_long", broken)
    ctx = _run(tiny.generate_cell())
    assert not ctx.correct, ctx.checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["flagship-train", "rich-generate",
                                  "rich-train"])
def test_control_on_the_card(cell, card):
    ctx = run_cell(load_cell(cell), device=card, seed=SEED, seconds=5.0,
                   trace=False, control=True)
    print(cell, "control", ctx.checks)
    assert not ctx.correct, ctx.checks
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["flagship-train", "rich-train"])
@pytest.mark.parametrize("fault", ["half_batch", "no_stft_in_g"])
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_fault_on_the_card(cell, fault, seed, card, monkeypatch):
    _broken_step(monkeypatch, fault)
    ctx = run_cell(load_cell(cell), device=card, seed=seed, seconds=2.0,
                   trace=False)
    print(cell, seed, fault, ctx.checks)
    assert not ctx.correct, ctx.checks
    torch.cuda.empty_cache()
