"""What the two training CLIs share: the device, the run directory (corpus,
dataset, mel statistics, ``config.json``), the checkpoints and the logged
metrics with the collapse guard.

The run directory has the JAX scripts' layout: ``config.json`` (the full
resolved config, ``config_to_dict``), ``mel_stats.json`` (with
``--auto-mel-stats``), ``metrics.jsonl``, ``ckpt/`` and, when the guard
stops a run, ``STATUS``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from music_synthesis_tpu_torch._device import resolve_device
from music_synthesis_tpu_torch.config import PipelineConfig, config_to_dict
from music_synthesis_tpu_torch.data.dataset import (
    AudioDataset,
    make_synthetic_corpus,
)
from music_synthesis_tpu_torch.data.prefetch import Prefetcher
from music_synthesis_tpu_torch.data.stats import compute_mel_stats
from music_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from music_synthesis_tpu_torch.train.guard import CollapseGuard
from music_synthesis_tpu_torch.train.metrics import MetricsLogger

__all__ = ["device_from_args", "cli_device", "prepare_run",
           "host_tensor", "host_batches", "Run"]


def device_from_args(ap: argparse.ArgumentParser,
                     args: argparse.Namespace) -> torch.device:
    """Reject what the port does not run yet, then resolve the device; both
    exit non-zero with the reason."""
    if args.mesh > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh} (--dp {args.dp}): data-parallel training is "
            "not ported yet (ROADMAP.md Queue 1 item 10, DDP); run with "
            "--mesh 1")
    return cli_device(ap, args.device)


def cli_device(ap: argparse.ArgumentParser, device: str) -> torch.device:
    """``resolve_device(device)``, or exit 1 with the reason (no card)."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        ap.exit(1, f"{ap.prog}: {e}\n")


def prepare_run(args: argparse.Namespace, cfg: PipelineConfig,
                segment_length: int, dev: torch.device):
    """Make the run directory, the corpus (a synthetic one without
    ``--corpus``) and its dataset, the mel statistics, and ``config.json``;
    returns ``(cfg, dataset, outdir)`` with the derived MelScaler."""
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    corpus = args.corpus
    if corpus is None:
        corpus = outdir / "synthetic_corpus"
        make_synthetic_corpus(corpus, n_clips=8, seconds=4.0)
        print(f"no --corpus; wrote synthetic corpus to {corpus}")
    ds = AudioDataset(corpus, sample_rate=cfg.frontend.sample_rate,
                      segment_length=segment_length,
                      ram_budget_mb=args.ram_budget_mb or None,
                      augment=cfg.train.augment)
    print(f"corpus: {len(ds)} clips on {dev}")
    if args.auto_mel_stats:
        scaler = compute_mel_stats(ds, cfg, seed=cfg.train.seed, device=dev)
        cfg = dataclasses.replace(cfg, mel_scaler=scaler)
        (outdir / "mel_stats.json").write_text(json.dumps(
            {"shift": scaler.shift, "scale": scaler.scale}))
        print(f"mel stats from corpus: shift={scaler.shift:.3f} "
              f"scale={scaler.scale:.3f}")
    (outdir / "config.json").write_text(
        json.dumps(config_to_dict(cfg), indent=1))
    return cfg, ds, outdir


def host_tensor(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A CPU tensor of ``arr``, pinned when it is bound for a card (so the
    copy to the device can run asynchronously)."""
    t = torch.from_numpy(arr)
    return t.pin_memory() if dev.type == "cuda" else t


@contextlib.contextmanager
def host_batches(make_batch, start: int, end: int, depth: int):
    """``(i, make_batch(i))`` for i in [start, end): made ``depth`` ahead by
    a worker thread (``--prefetch``), or in line when ``depth`` is 0."""
    if depth > 0:
        with Prefetcher(make_batch, start, end, depth=depth) as p:
            yield iter(p)
    else:
        yield ((i, make_batch(i)) for i in range(start, end))


class Run:
    """Checkpoints, metrics and the guard of one training run in
    ``outdir``; ``guard_keys`` are the metrics the guard reads."""

    def __init__(self, args: argparse.Namespace, outdir: Path,
                 guard_keys: tuple[str, ...]):
        self.args = args
        self.outdir = outdir
        self.ckpt = CheckpointManager(outdir / "ckpt")
        self.logger = MetricsLogger(str(outdir / "metrics.jsonl"))
        self.guard = CollapseGuard() if args.guard else None
        self.guard_keys = guard_keys
        self.guard_reason: str | None = None

    def resume(self, state, dev: torch.device):
        """The newest checkpoint's state with ``--resume``, else ``state``."""
        if self.args.resume and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(device=dev)
            print(f"resumed from step {state.step}")
        return state

    def after(self, step: int, first: bool, state, metrics: dict) -> bool:
        """Bookkeeping after the dispatch that ends at step ``step`` (0-based):
        the finite check (``--debug-nans``), the metrics line and the guard
        every ``--log-every`` steps and on the first dispatch, and the
        checkpoint every ``--ckpt-every``. True when the guard stops the
        run."""
        args = self.args
        if args.debug_nans:
            bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
            if bad:
                raise FloatingPointError(
                    f"non-finite metrics at step {step + 1}: {bad}")
        if (step + 1) % args.log_every == 0 or first:
            # The JAX step's metrics come back from jit with sorted keys.
            self.logger.log(step + 1, dict(sorted(metrics.items())))
            if self.guard is not None:
                self.guard_reason = self.guard.update(
                    step + 1, {k: metrics[k] for k in self.guard_keys})
                if self.guard_reason:
                    print(f"GUARD: {self.guard_reason}; stopping early",
                          flush=True)
                    (self.outdir / "STATUS").write_text(
                        f"guard-stopped at step {step + 1}: "
                        f"{self.guard_reason}\n")
                    return True
        if (step + 1) % args.ckpt_every == 0:
            self.ckpt.save(step + 1, state)
        return False

    def finish(self, state, start_step: int, last_step: int | None,
               t_start: float, dev: torch.device) -> None:
        """The ``loop:`` line, the final checkpoint and the ``done:`` line.
        ``last_step`` is the 0-based step the loop ended on."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t_start
        end_step = last_step + 1 if self.guard_reason else self.args.steps
        n_done = end_step - start_step
        if n_done > 0:
            print(f"loop: {n_done} steps in {dt:.1f}s "
                  f"({1e3 * dt / n_done:.1f} ms/step incl. host pipeline)")
        self.ckpt.save(end_step, state)
        self.logger.close()
        print(f"done: {end_step} steps -> {self.outdir}")

