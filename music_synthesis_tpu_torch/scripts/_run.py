"""What the two training CLIs share: the device and the ranks, the run
directory (corpus, dataset, mel statistics, ``config.json``), the
checkpoints and the logged metrics with the collapse guard.

The run directory has the JAX scripts' layout: ``config.json`` (the full
resolved config, ``config_to_dict``), ``mel_stats.json`` (with
``--auto-mel-stats``), ``metrics.jsonl``, ``ckpt/`` and, when the guard
stops a run, ``STATUS``. On a card each line of ``metrics.jsonl`` also
carries the tracer's medians of the graphed step's replays since the
previous line (``trace.*``, ``Run.trace_keys``).

Data parallelism (``--mesh N``): one process per rank. Under ``torchrun``
``WORLD_SIZE`` must equal N and each process joins the group
(``parallel/multihost.py``); otherwise the CLI starts the N ranks itself
(``parallel.mesh.launch``: ``cuda:0`` .. ``cuda:N-1`` with ``nccl``, or N
CPU ranks with ``gloo`` under ``--device cpu``). Every rank samples the
global batch and keeps its rows, as the reference's single-host mesh
shards one global batch; rank 0 alone writes the run directory (corpus,
statistics, config, metrics, checkpoints, audio) and prints.
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
import torch.distributed as dist

from music_synthesis_tpu_torch._device import resolve_device
from music_synthesis_tpu_torch.config import PipelineConfig, config_to_dict
from music_synthesis_tpu_torch.data.dataset import (
    AudioDataset,
    make_synthetic_corpus,
)
from music_synthesis_tpu_torch.data.prefetch import Prefetcher
from music_synthesis_tpu_torch.data.stats import compute_mel_stats
from music_synthesis_tpu_torch.parallel import mesh, multihost
from music_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from music_synthesis_tpu_torch.train.guard import CollapseGuard
from music_synthesis_tpu_torch.train.metrics import MetricsLogger
from music_synthesis_tpu_torch.utils.profiling import medians, tracer

__all__ = ["check_mesh", "start_ranks", "ranks", "is_main", "cli_device",
           "prepare_run", "host_tensor", "host_batches", "Run"]


def check_mesh(ap: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """The JAX scripts' checks of ``--mesh``: the batch divides over it."""
    if args.mesh < 1:
        ap.error(f"--mesh must be >= 1, got {args.mesh}")
    if args.batch % args.mesh:
        ap.error(f"--batch {args.batch} must be divisible by --mesh "
                 f"{args.mesh}")


def start_ranks(ap: argparse.ArgumentParser, args: argparse.Namespace,
                main, argv: list[str]) -> bool:
    """With ``--mesh N > 1`` outside a group and outside ``torchrun``, run
    ``main(argv)`` on N ranks started here and return True when they have
    ended; else return False (this process trains)."""
    if (args.mesh == 1 or dist.is_initialized()
            or multihost.env_world_size() > 1):
        return False
    dev = cli_device(ap, args.device)
    try:
        devices = mesh.device_list(args.mesh, dev)
    except RuntimeError as e:
        ap.exit(1, f"{ap.prog}: {e}\n")
    mesh.launch(main, args.mesh, (argv,), devices=devices)
    return True


@contextlib.contextmanager
def ranks(ap: argparse.ArgumentParser, args: argparse.Namespace):
    """``(device, group)`` of this process: ``(device, None)`` for one
    process; under ``torchrun`` it joins the group (and leaves it at the
    end). Exits non-zero with the reason when ``WORLD_SIZE`` is not
    ``--mesh`` or the device is missing."""
    world = (mesh.world_size() if dist.is_initialized()
             else multihost.env_world_size())
    if world != args.mesh:
        ap.error(f"WORLD_SIZE {world} must equal --mesh {args.mesh}")
    if world == 1:
        yield cli_device(ap, args.device), None
        return
    if torch.device(args.device).type == "cuda":
        cli_device(ap, args.device)
    try:
        dev = multihost.rank_device(args.device)
    except RuntimeError as e:
        ap.exit(1, f"{ap.prog}: {e}\n")
    joined = not dist.is_initialized()
    if joined:
        multihost.initialize(dev)
    try:
        yield dev, dist.group.WORLD
    finally:
        if joined:
            mesh.leave()


def is_main() -> bool:
    """True on rank 0 (and in a single process): the rank that writes."""
    return mesh.rank() == 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


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
    main = is_main()
    corpus = args.corpus
    if main:
        outdir.mkdir(parents=True, exist_ok=True)
        if corpus is None:
            make_synthetic_corpus(outdir / "synthetic_corpus", n_clips=8,
                                  seconds=4.0)
            print(f"no --corpus; wrote synthetic corpus to "
                  f"{outdir / 'synthetic_corpus'}")
    _barrier()
    corpus = corpus or outdir / "synthetic_corpus"
    ds = AudioDataset(corpus, sample_rate=cfg.frontend.sample_rate,
                      segment_length=segment_length,
                      ram_budget_mb=args.ram_budget_mb or None,
                      augment=cfg.train.augment)
    if main:
        print(f"corpus: {len(ds)} clips on {dev}"
              + (f" and {args.mesh - 1} more rank(s)" if args.mesh > 1
                 else ""))
    if args.auto_mel_stats:
        # Every rank computes the same statistics from the same clips.
        scaler = compute_mel_stats(ds, cfg, seed=cfg.train.seed, device=dev)
        cfg = dataclasses.replace(cfg, mel_scaler=scaler)
        if main:
            (outdir / "mel_stats.json").write_text(json.dumps(
                {"shift": scaler.shift, "scale": scaler.scale}))
            print(f"mel stats from corpus: shift={scaler.shift:.3f} "
                  f"scale={scaler.scale:.3f}")
    if main:
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
    ``outdir``; ``guard_keys`` are the metrics the guard reads, ``program``
    the tracer's label of the run's graphed step (``utils.profiling``)."""

    def __init__(self, args: argparse.Namespace, outdir: Path,
                 guard_keys: tuple[str, ...], group=None,
                 program: str = "stage2_step"):
        self.args = args
        self.outdir = outdir
        self.group = group
        self.program = program
        self.traced = 0  # the last replay a logged line has read
        self.main = is_main()
        self.ckpt = CheckpointManager(outdir / "ckpt")
        self.logger = (MetricsLogger(str(outdir / "metrics.jsonl"))
                       if self.main else None)
        self.guard = CollapseGuard() if args.guard else None
        self.guard_keys = guard_keys
        self.guard_reason: str | None = None

    def resume(self, state, dev: torch.device):
        """The newest checkpoint's state with ``--resume``, else ``state``;
        under data parallelism rank 0's, broadcast to every rank."""
        if self.args.resume and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(device=dev)
            if self.main:
                print(f"resumed from step {state.step}")
        return mesh.replicate_state(state, self.group)

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
            if self.main:
                self.logger.log(step + 1, {**dict(sorted(metrics.items())),
                                           **self.trace_keys()})
            if self.guard is not None:
                # Every rank holds the same (averaged) metrics, so every
                # rank's guard stops at the same step.
                self.guard_reason = self.guard.update(
                    step + 1, {k: metrics[k] for k in self.guard_keys})
                if self.guard_reason:
                    if self.main:
                        print(f"GUARD: {self.guard_reason}; stopping early",
                              flush=True)
                        (self.outdir / "STATUS").write_text(
                            f"guard-stopped at step {step + 1}: "
                            f"{self.guard_reason}\n")
                    return True
        if (step + 1) % args.ckpt_every == 0 and self.main:
            self.ckpt.save(step + 1, state)
        return False

    def trace_keys(self) -> dict[str, float]:
        """``trace.d_step_ms``, ``trace.g_step_ms``, ``trace.off_graph``
        and ``trace.graph_launch_ms``: the tracer's medians over the
        replays of the run's graphed step since the last logged line; none
        where it holds no record of them (the CPU, which has no graphs)."""
        log = tracer.snapshot()["programs"].get(self.program)
        records = [r for r in (log["records"] if log else ())
                   if r["replay"] > self.traced]
        if records:
            self.traced = records[-1]["replay"]
        return {f"trace.{k}": v for k, v in medians(records).items()}

    def finish(self, state, start_step: int, last_step: int | None,
               t_start: float, dev: torch.device) -> None:
        """The ``loop:`` line, the final checkpoint and the ``done:`` line.
        ``last_step`` is the 0-based step the loop ended on."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t_start
        end_step = last_step + 1 if self.guard_reason else self.args.steps
        n_done = end_step - start_step
        if not self.main:
            return
        if n_done > 0:
            print(f"loop: {n_done} steps in {dt:.1f}s "
                  f"({1e3 * dt / n_done:.1f} ms/step incl. host pipeline)")
        self.ckpt.save(end_step, state)
        self.logger.close()
        print(f"done: {end_step} steps -> {self.outdir}")

