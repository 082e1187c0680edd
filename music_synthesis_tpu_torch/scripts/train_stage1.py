"""Stage-1 spectrogram GAN training (counterpart of ``scripts/train_stage1.py``).

Trains the composer on real log-mel patches taken from the corpus:

    python -m music_synthesis_tpu_torch.scripts.train_stage1 \\
        --corpus DIR --steps 1000 [--device cpu --preset tiny]

Without ``--corpus``, a deterministic synthetic corpus is written into the
run directory. The flags, their defaults and the run directory are the JAX
script's (``scripts/_run.py``). The patches are the plain front-end's
log-mel, normalized, computed on the device on the main thread; the worker
thread of ``--prefetch`` only samples audio on the host. Runs on ``cuda``
unless ``--device cpu`` is given.

``--mesh N`` trains data-parallel over N ranks (``scripts/_run.py`` says
how they start; ``--batch`` divides by N): by default the reference's
per-device step with per-rank latents (``--dp shard_map``), or the step
on the global batch (``--dp jit``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import time

import numpy as np
import torch

from music_synthesis_tpu_torch.config import TINY, PipelineConfig, TrainConfig
from music_synthesis_tpu_torch.ops.frontend import log_mel_for_vocoder
from music_synthesis_tpu_torch.parallel.dp import make_dp_stage1_step
from music_synthesis_tpu_torch.parallel.mesh import shard_batch
from music_synthesis_tpu_torch.parallel.shard_map_dp import (
    make_shardmap_stage1_step,
)
from music_synthesis_tpu_torch.scripts._run import (
    Run,
    check_mesh,
    host_batches,
    host_tensor,
    prepare_run,
    ranks,
    start_ranks,
)
from music_synthesis_tpu_torch.train import stage1


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="train_stage1",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", default=None)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--mesh", type=int, default=1)
    ap.add_argument("--dp", choices=["shard_map", "jit"], default="shard_map")
    ap.add_argument("--outdir", default="runs/stage1")
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--preset", choices=["default", "tiny"], default="default",
                    help="'tiny' = small models for smoke runs / CPU")
    ap.add_argument("--grad-clip", type=float, default=0.0)
    ap.add_argument("--gan-loss", choices=["hinge", "nonsat"], default="hinge",
                    help="nonsat = logistic loss without flat regions")
    ap.add_argument("--g-lr", type=float, default=None)
    ap.add_argument("--d-lr", type=float, default=None)
    ap.add_argument("--d-noise", type=float, default=0.0,
                    help="instance-noise stddev on D inputs (stabilizer)")
    ap.add_argument("--out-temperature", type=float, default=1.0,
                    help="G output = tanh(T*x); T<1 widens the linear region")
    ap.add_argument("--out-init-gain", type=float, default=1.0,
                    help="init-std multiplier on G's output conv")
    ap.add_argument("--init-scheme", choices=["dcgan", "he"], default="dcgan",
                    help="weight init for all SpecGAN layers; 'he' starts G "
                         "at real-mel amplitude")
    ap.add_argument("--res-init-gain", type=float, default=1.0,
                    help="init-std multiplier on residual branch outputs")
    ap.add_argument("--r1-gamma", type=float, default=0.0,
                    help="R1 gradient penalty weight on D(real) (0 = off)")
    ap.add_argument("--noise-decay-steps", type=int, default=0,
                    help="linear decay horizon for --d-noise (0 = constant)")
    ap.add_argument("--lr-decay", type=float, default=1.0,
                    help="exponential lr decay rate per --lr-decay-every")
    ap.add_argument("--lr-decay-every", type=int, default=1000)
    ap.add_argument("--ema", type=float, default=0.0,
                    help="generator EMA decay (0 = off)")
    ap.add_argument("--lambda-flux", type=float, default=0.0,
                    help="temporal-flux profile matching weight (0 = off)")
    ap.add_argument("--reuse-real-feats", action="store_true")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute in G and D")
    ap.add_argument("--auto-mel-stats", action="store_true")
    ap.add_argument("--debug-nans", action="store_true",
                    help="autograd anomaly detection, and a finite check of "
                         "every step's metrics (debug runs only)")
    ap.add_argument("--augment", action="store_true",
                    help="random gain + polarity per segment")
    ap.add_argument("--guard", action="store_true",
                    help="online collapse detection (train/guard.py): stop "
                         "early, stamp STATUS, keep checkpoints, exit 0")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="host-side batch prefetch depth (0 = synchronous)")
    ap.add_argument("--ram-budget-mb", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on ('cpu' for smoke runs)")
    return ap


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    """The run's PipelineConfig, built from the flags as the JAX script
    builds it."""
    base = TINY if args.preset == "tiny" else PipelineConfig()
    specgan = base.specgan
    if args.bf16:
        specgan = dataclasses.replace(specgan, compute_dtype="bfloat16")
    if args.out_temperature != 1.0 or args.out_init_gain != 1.0:
        specgan = dataclasses.replace(
            specgan, out_temperature=args.out_temperature,
            out_init_gain=args.out_init_gain)
    if args.init_scheme != "dcgan" or args.res_init_gain != 1.0:
        specgan = dataclasses.replace(
            specgan, init_scheme=args.init_scheme,
            res_init_gain=args.res_init_gain)
    return dataclasses.replace(
        base, specgan=specgan,
        train=TrainConfig(
            batch_size=args.batch, augment=args.augment,
            mesh_shape=(args.mesh,), grad_clip_norm=args.grad_clip,
            ema_decay=args.ema, reuse_real_features=args.reuse_real_feats,
            gan_loss=args.gan_loss, d_input_noise=args.d_noise,
            d_noise_decay_steps=args.noise_decay_steps,
            r1_gamma=args.r1_gamma, lambda_flux=args.lambda_flux,
            lr_decay_rate=args.lr_decay, lr_decay_every=args.lr_decay_every,
            **({"g_lr": args.g_lr} if args.g_lr else {}),
            **({"d_lr": args.d_lr} if args.d_lr else {})))


def main(argv: list[str] | None = None) -> None:
    ap = parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    check_mesh(ap, args)
    cfg = config_from_args(args)
    if cfg.specgan.n_mels != cfg.frontend.n_mels:
        ap.error(f"specgan.n_mels ({cfg.specgan.n_mels}) != frontend.n_mels "
                 f"({cfg.frontend.n_mels}); real patches would not fit")
    if start_ranks(ap, args, main, argv):
        return
    with ranks(ap, args) as (dev, group):
        _train(args, cfg, dev, group)


def _train(args, cfg: PipelineConfig, dev: torch.device, group) -> None:
    """The training loop of one process (one rank under ``--mesh``)."""
    # A mel patch needs n_frames * hop samples of audio.
    seg = cfg.specgan.n_frames * cfg.frontend.hop_length
    cfg, ds, outdir = prepare_run(args, cfg, seg, dev)

    def patches(wav: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            mel = log_mel_for_vocoder(wav, cfg.frontend)
            return (mel - cfg.mel_scaler.shift) / cfg.mel_scaler.scale

    run = Run(args, outdir, guard_keys=("d_loss", "g_adv"), group=group,
              program="stage1_step")
    state = run.resume(stage1.make_train_state(cfg, cfg.train.seed, dev), dev)
    start_step = state.step
    if group is None:
        step_fn = functools.partial(stage1.train_step, cfg)
    elif args.dp == "shard_map":
        step_fn = make_shardmap_stage1_step(cfg, group)
    else:
        step_fn = make_dp_stage1_step(cfg, group)

    def make_batch(step: int) -> torch.Tensor:
        # Under --mesh every rank samples the global batch and keeps its
        # rows.
        return host_tensor(np.ascontiguousarray(shard_batch(ds.sample_batch(
            step, cfg.train.batch_size, cfg.train.seed), group)), dev)

    step = None
    t_start = time.perf_counter()
    with (torch.autograd.set_detect_anomaly(args.debug_nans),
          host_batches(make_batch, start_step, args.steps,
                       args.prefetch) as batches):
        for step, wav in batches:
            mel = patches(wav.to(dev, non_blocking=True))
            state, metrics = step_fn(state, mel)
            if run.after(step, step == start_step, state, metrics):
                break
    run.finish(state, start_step, step, t_start, dev)


if __name__ == "__main__":
    main()
