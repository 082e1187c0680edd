"""Stage-2 vocoder GAN training (counterpart of ``scripts/train_stage2.py``).

    python -m music_synthesis_tpu_torch.scripts.train_stage2 \\
        --corpus DIR --steps 1000 [--device cpu --preset tiny]

Without ``--corpus``, a deterministic synthetic corpus is written into the
run directory. The flags, their defaults and the run directory are the JAX
script's (``scripts/_run.py``), plus vocoded-audio dumps
(``vocoded_<step>.wav`` beside ``real_<step>.wav``, from the EMA generator
when there is one). ``--steps-per-dispatch K`` runs K steps per call of
``train_step_many`` on a ``[K, B, L]`` chunk of the same batches. On a
card a single-process run replays the step's CUDA graph
(``train.stage2.GraphedStep``): once per step, K times back to back per
call of ``train_step_many``, with one read of the metrics after the last.

With ``--pallas-frontend`` the conditioning (in every step and every
audio dump) runs through the fused log-mel kernel (``ops/logmel.py``): on
the card it builds and launches, or the run fails; there is no fallback to
the plain front-end. Runs on ``cuda`` unless ``--device cpu`` is given.

``--mesh N`` trains data-parallel over N ranks (``scripts/_run.py`` says
how they start), with the JAX script's checks: ``--batch`` divides by N,
``--pallas-frontend`` needs ``--dp shard_map`` (the default; the kernel
runs per rank), and so does ``--steps-per-dispatch``:

    python -m music_synthesis_tpu_torch.scripts.train_stage2 --mesh 8 ...
    python -m music_synthesis_tpu_torch.scripts.train_stage2 --mesh 2 \
        --device cpu --preset tiny --batch 2 --segment 2048 --steps 2
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import time

import numpy as np
import torch
from torch.func import functional_call

from music_synthesis_tpu_torch.config import TINY, PipelineConfig, TrainConfig
from music_synthesis_tpu_torch.parallel.dp import make_dp_stage2_step
from music_synthesis_tpu_torch.parallel.mesh import shard_batch, shard_chunk
from music_synthesis_tpu_torch.parallel.shard_map_dp import (
    make_shardmap_stage2_many,
    make_shardmap_stage2_step,
)
from music_synthesis_tpu_torch.scripts._run import (
    Run,
    check_mesh,
    host_batches,
    host_tensor,
    is_main,
    prepare_run,
    ranks,
    start_ranks,
)
from music_synthesis_tpu_torch.train import stage2
from music_synthesis_tpu_torch.utils.wav import write_wav


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="train_stage2",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", default=None)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--segment", type=int, default=8192)
    ap.add_argument("--mesh", type=int, default=1, help="data-parallel width")
    ap.add_argument("--dp", choices=["shard_map", "jit"], default="shard_map",
                    help="distributed-step implementation when --mesh > 1")
    ap.add_argument("--outdir", default="runs/stage2")
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--audio-every", type=int, default=500)
    ap.add_argument("--pallas-frontend", action="store_true",
                    help="conditioning through the fused log-mel kernel")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--preset", choices=["default", "tiny"], default="default",
                    help="'tiny' = small models for smoke runs / CPU")
    ap.add_argument("--head", choices=["waveform", "istft"], default="waveform",
                    help="vocoder output head")
    ap.add_argument("--grad-clip", type=float, default=0.0,
                    help="global-norm gradient clip (0 = off)")
    ap.add_argument("--ema", type=float, default=0.0,
                    help="generator EMA decay (0 = off); audio dumps use EMA")
    ap.add_argument("--gan-loss", choices=["hinge", "nonsat"], default="hinge",
                    help="adversarial objective (nonsat = logistic, no flat "
                         "regions)")
    ap.add_argument("--lr-decay", type=float, default=1.0,
                    help="exponential lr decay rate per --lr-decay-every "
                         "steps (1.0 = constant)")
    ap.add_argument("--lr-decay-every", type=int, default=1000)
    ap.add_argument("--r1-gamma", type=float, default=0.0,
                    help="R1 gradient penalty on D(real) (0 = off)")
    ap.add_argument("--d-noise", type=float, default=0.0,
                    help="instance-noise sigma on D's waveform inputs")
    ap.add_argument("--noise-decay-steps", type=int, default=0,
                    help="linear decay horizon for --d-noise (0 = constant)")
    ap.add_argument("--lambda-energy", type=float, default=0.0,
                    help="frame-energy L1 weight (0 = off)")
    ap.add_argument("--lambda-phase", type=float, default=0.0,
                    help="anti-wrapping IF+GD phase-coherence loss weight "
                         "(0 = off)")
    ap.add_argument("--lambda-stft", type=float, default=None,
                    help="override TrainConfig.lambda_stft (default 2.5)")
    ap.add_argument("--init-scheme", choices=["dcgan", "he"], default="dcgan",
                    help="generator weight init: dcgan = N(0,0.02), he = "
                         "fan-in-scaled")
    ap.add_argument("--g-warmup", type=int, default=0,
                    help="train G on STFT loss alone (D frozen) for the "
                         "first N steps before starting the adversarial game")
    ap.add_argument("--reuse-real-feats", action="store_true",
                    help="reuse D(real) taps from the D step for the G step's "
                         "feature-matching target")
    ap.add_argument("--concat-disc", action="store_true",
                    help="one D forward on [real; fake] in the D step")
    ap.add_argument("--dense-groups", type=int, default=0,
                    help="run the MSD's grouped convs of up to this many "
                         "groups as one dense conv over a block-diagonal "
                         "kernel (the same math and parameters)")
    ap.add_argument("--f-fold", type=int, default=0,
                    help="recorded in the config (a TPU relayout of the "
                         "MRD's convs; the same math here)")
    ap.add_argument("--mrd-complex", action="store_true",
                    help="phase-aware MRD on the compressed complex STFT")
    ap.add_argument("--bf16-disc", action="store_true",
                    help="bfloat16 compute in both discriminators")
    ap.add_argument("--bf16-gen", action="store_true",
                    help="bfloat16 compute in the generator")
    ap.add_argument("--auto-mel-stats", action="store_true",
                    help="derive MelScaler (shift, scale) from the corpus")
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
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="K training steps per call of train_step_many, on "
                         "the same batches; K must divide the log, ckpt and "
                         "audio cadences and the start and total steps")
    ap.add_argument("--ram-budget-mb", type=int, default=0,
                    help="decoded-corpus RAM budget; 0 = load fully in memory")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on ('cpu' for smoke runs)")
    return ap


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    """The run's PipelineConfig, built from the flags as the JAX script
    builds it."""
    base = TINY if args.preset == "tiny" else PipelineConfig()
    vocoder = base.vocoder
    if args.head == "istft":
        vocoder = dataclasses.replace(
            vocoder, head="istft", upsample_factors=(8, 8),
            istft_n_fft=16, istft_hop=4)
    if args.bf16_gen:
        vocoder = dataclasses.replace(vocoder, compute_dtype="bfloat16")
    if args.init_scheme != "dcgan":
        # The JAX script's calibration: he trunk, near-identity residual
        # branches, a moderated output conv (output rms ~0.1 at init).
        vocoder = dataclasses.replace(
            vocoder, init_scheme=args.init_scheme,
            res_init_gain=0.1, out_init_gain=0.003)
    msd, mrd = base.msd, base.mrd
    if args.bf16_disc:
        msd = dataclasses.replace(msd, compute_dtype="bfloat16")
        mrd = dataclasses.replace(mrd, compute_dtype="bfloat16")
    if args.dense_groups:
        msd = dataclasses.replace(msd, dense_groups_max_g=args.dense_groups)
    if args.f_fold:
        mrd = dataclasses.replace(mrd, f_fold=args.f_fold)
    if args.mrd_complex:
        mrd = dataclasses.replace(mrd, input_mode="complex")
    return dataclasses.replace(
        base, vocoder=vocoder, msd=msd, mrd=mrd,
        train=TrainConfig(
            batch_size=args.batch, segment_length=args.segment,
            augment=args.augment, mesh_shape=(args.mesh,),
            use_pallas_frontend=args.pallas_frontend,
            grad_clip_norm=args.grad_clip, ema_decay=args.ema,
            reuse_real_features=args.reuse_real_feats,
            concat_disc_batch=args.concat_disc,
            g_warmup_steps=args.g_warmup, gan_loss=args.gan_loss,
            lr_decay_rate=args.lr_decay, lr_decay_every=args.lr_decay_every,
            lambda_energy=args.lambda_energy, lambda_phase=args.lambda_phase,
            r1_gamma=args.r1_gamma, d_input_noise=args.d_noise,
            d_noise_decay_steps=args.noise_decay_steps,
            **({"lambda_stft": args.lambda_stft}
               if args.lambda_stft is not None else {})))


def main(argv: list[str] | None = None) -> None:
    ap = parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    check_mesh(ap, args)
    cfg = config_from_args(args)
    if cfg.frontend.n_mels != cfg.vocoder.n_mels:
        ap.error(f"frontend.n_mels ({cfg.frontend.n_mels}) != vocoder.n_mels "
                 f"({cfg.vocoder.n_mels}); the conditioning would not fit")
    if cfg.vocoder.hop_length != cfg.frontend.hop_length:
        ap.error(f"vocoder total upsampling ({cfg.vocoder.hop_length}) must "
                 f"equal the front-end hop ({cfg.frontend.hop_length})")
    if args.pallas_frontend and args.mesh > 1 and args.dp == "jit":
        sys.exit("--pallas-frontend with --mesh > 1 requires --dp shard_map "
                 "(pallas_call has no SPMD partitioning rule under jit "
                 "sharding; the shard_map step runs the kernel per-device)")
    k = max(1, args.steps_per_dispatch)
    for name, every in (("log", args.log_every), ("ckpt", args.ckpt_every),
                        ("audio", args.audio_every)):
        if every % k:
            ap.error(f"--{name}-every must be a multiple of "
                     "--steps-per-dispatch")
    if k > 1 and args.mesh > 1 and args.dp != "shard_map":
        ap.error("--steps-per-dispatch with --mesh needs --dp shard_map")
    if start_ranks(ap, args, main, argv):
        return
    with ranks(ap, args) as (dev, group):
        _train(ap, args, cfg, dev, group)


def _train(ap, args, cfg: PipelineConfig, dev: torch.device, group) -> None:
    """The training loop of one process (one rank under ``--mesh``)."""
    k = max(1, args.steps_per_dispatch)
    cfg, ds, outdir = prepare_run(args, cfg, cfg.train.segment_length, dev)

    run = Run(args, outdir, guard_keys=("d_loss", "g_adv", "g_stft"),
              group=group)
    state = run.resume(stage2.make_train_state(cfg, cfg.train.seed, dev), dev)
    if group is None:
        step_one = functools.partial(stage2.train_step, cfg)
        step_many = functools.partial(stage2.train_step_many, cfg)
    elif args.dp == "shard_map":
        step_one = make_shardmap_stage2_step(cfg, group)
        step_many = make_shardmap_stage2_many(cfg, group)
    else:
        step_one = make_dp_stage2_step(cfg, group)
    start_step = state.step
    if start_step % k or args.steps % k:
        ap.error("start and total steps must be multiples of "
                 "--steps-per-dispatch")
    with torch.device("meta"):
        gen, _ = stage2.make_models(cfg)

    def dump_audio(step: int) -> None:
        """Vocode one corpus segment with the EMA generator (the weights a
        deployment serves) when there is one."""
        g = state.g_ema if state.g_ema is not None else state.g_params
        raw = ds.sample_batch(step, 1, cfg.train.seed)
        with torch.no_grad():
            mel = stage2.conditioning_mel(torch.from_numpy(raw).to(dev), cfg)
            fake = functional_call(gen, g, (mel,))
        sr = cfg.frontend.sample_rate
        write_wav(outdir / f"vocoded_{step + 1:07d}.wav", sr,
                  fake[0].float().cpu().numpy())
        write_wav(outdir / f"real_{step + 1:07d}.wav", sr, raw[0])

    def make_batch(cs: int) -> torch.Tensor:
        # One [K, B, L] chunk holds the batches a one-step loop would draw,
        # so resuming replays the same data whatever K is.
        # Under --mesh every rank samples the global batch and keeps its
        # rows.
        b = cfg.train.batch_size
        if k == 1:
            arr = shard_batch(ds.sample_batch(cs, b, cfg.train.seed), group)
        else:
            arr = shard_chunk(np.stack([
                ds.sample_batch(cs + i, b, cfg.train.seed)
                for i in range(k)]), group)
        return host_tensor(np.ascontiguousarray(arr), dev)

    step = None
    t_start = time.perf_counter()
    n_chunks = (args.steps - start_step) // k
    with (torch.autograd.set_detect_anomaly(args.debug_nans),
          host_batches(lambda ci: make_batch(start_step + ci * k), 0,
                       n_chunks, args.prefetch) as batches):
        for ci, wav in batches:
            cs = start_step + ci * k
            wav = wav.to(dev, non_blocking=True)
            if k == 1:
                state, metrics = step_one(state, wav)
            else:
                state, metrics = step_many(state, wav)
            step = cs + k - 1  # the last step of this dispatch
            if run.after(step, cs == start_step, state, metrics):
                break
            if (step + 1) % args.audio_every == 0 and is_main():
                dump_audio(step)
    run.finish(state, start_step, step, t_start, dev)


if __name__ == "__main__":
    main()
