"""Two-stage generation (counterpart of ``scripts/generate.py``).

    python -m music_synthesis_tpu_torch.scripts.generate \\
        --stage1 specgan_flux --stage2 vocoder_istft --n 4 --out generated/ \\
        [--seconds 8 --gl-refine 8 --interpolate 3:7 --walk-step 0.3 \\
         --target-rms 0.1 --report --preset default|fast|tiny --device cpu]

``--stage1``/``--stage2`` take a zoo entry (name or directory) or a run's
checkpoint directory written by the port's training CLIs. A zoo entry's
card, or the run's ``config.json`` beside ``ckpt/``, overrides the preset's
model config, front-end and MelScaler; the EMA generator is used when the
checkpoint holds one (``--ema1``/``--ema2`` are accepted for the JAX
script's command lines and not read). Without a source the generator is a
seeded random init. ``--seconds`` past one patch stitches latent patches
(``infer.generate.generate_long``), by default i.i.d., along a slerp path
between two seeds (``--interpolate A:B``) or a random walk
(``--walk-step``). Latents come from PyTorch's CPU generator, so a seed
does not give the JAX script's audio. Runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from music_synthesis_tpu_torch import zoo
from music_synthesis_tpu_torch.config import (
    E2E_INFERENCE,
    E2E_INFERENCE_FAST,
    TINY,
    PipelineConfig,
    config_from_dict,
)
from music_synthesis_tpu_torch.infer import generate as gen
from music_synthesis_tpu_torch.infer.latent import latent_path, latent_walk
from music_synthesis_tpu_torch.models.specgan import SpectrogramGenerator
from music_synthesis_tpu_torch.models.vocoder import Vocoder
from music_synthesis_tpu_torch.scripts._run import cli_device
from music_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from music_synthesis_tpu_torch.utils.report import write_report
from music_synthesis_tpu_torch.utils.wav import write_wav

PRESETS = {"tiny": TINY, "fast": E2E_INFERENCE_FAST, "default": E2E_INFERENCE}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="generate",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage1", default=None,
                    help="stage-1 checkpoint dir or zoo entry")
    ap.add_argument("--stage2", default=None,
                    help="stage-2 checkpoint dir or zoo entry")
    ap.add_argument("--ema1", type=float, default=0.0,
                    help="accepted for the JAX script's command lines")
    ap.add_argument("--ema2", type=float, default=0.0,
                    help="accepted for the JAX script's command lines")
    ap.add_argument("--n", type=int, default=4, help="clips to generate")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="when > one patch, stitch latent patches by mel "
                         "crossfade (infer.generate.generate_long)")
    ap.add_argument("--crossfade-frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--interpolate", default="",
                    help="'A:B' = slerp the long-form latents from seed A "
                         "to seed B (infer/latent.py)")
    ap.add_argument("--walk-step", type=float, default=0.0,
                    help="latent random walk: each patch slerps this far "
                         "toward a fresh draw (0 = i.i.d. patches)")
    ap.add_argument("--target-rms", type=float, default=0.0,
                    help="post-gain each clip to this RMS (0 = off; gain "
                         "capped at 100x)")
    ap.add_argument("--gl-refine", type=int, default=0,
                    help="warm-started Griffin-Lim iterations of the vocoded "
                         "audio against the stage-1 mel (0 = off)")
    ap.add_argument("--out", default="generated")
    ap.add_argument("--report", action="store_true",
                    help="also write an HTML report with the audio")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="default",
                    help="fast = iSTFT-head flagship")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' for smoke runs)")
    return ap


def load_generator(src: str, stage: int, cfg: PipelineConfig,
                   device: torch.device,
                   scaler_sources: dict | None = None):
    """``src`` = zoo entry (name or dir) | checkpoint dir -> ``(module,
    cfg)``, with ``cfg``'s model config and, where the source has them, its
    MelScaler and front-end replaced by the source's (the conditioning must
    be the training run's)."""
    p = Path(src)
    is_zoo = (p / "card.json").exists() or (
        not p.exists() and (zoo.ZOO_ROOT / src / "card.json").exists())
    field, kind = (("specgan", SpectrogramGenerator) if stage == 1
                   else ("vocoder", Vocoder))
    sources = {} if scaler_sources is None else scaler_sources
    if is_zoo:
        e = zoo.load_pretrained(src)
        if e.kind != field:
            raise ValueError(f"{src} is a {e.kind}, need {field}")
        print(f"stage {stage}: zoo entry {e.name} "
              f"({e.card['n_params'] / 1e6:.2f}M params)")
        cfg = dataclasses.replace(cfg, **{field: e.config})
        if e.mel_scaler is not None:
            cfg = dataclasses.replace(cfg, mel_scaler=e.mel_scaler)
            sources[stage] = (e.name, e.mel_scaler)
        if e.frontend is not None:
            cfg = dataclasses.replace(cfg, frontend=e.frontend)
        return e.model(device), cfg
    for cand in (p / "config.json", p.parent / "config.json"):
        if cand.exists():
            run_cfg = config_from_dict(json.loads(cand.read_text()))
            cfg = dataclasses.replace(
                cfg, **{field: getattr(run_cfg, field)},
                mel_scaler=run_cfg.mel_scaler, frontend=run_cfg.frontend)
            sources[stage] = (str(cand), run_cfg.mel_scaler)
            break
    st = CheckpointManager(p).restore(device=device)
    params = st.g_ema if st.g_ema is not None else st.g_params
    which = "ema" if st.g_ema is not None else "raw"
    print(f"stage {stage}: checkpoint {src} @ step {st.step} ({which})")
    module = kind(getattr(cfg, field))
    module.load_state_dict(params, strict=True)
    return module.to(device).eval().requires_grad_(False), cfg


def _normal(seed: int, shape: tuple) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def main(argv: list[str] | None = None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    dev = cli_device(ap, args.device)
    cfg = PRESETS[args.preset]
    print(f"device: {dev}; building generators...", flush=True)
    sources: dict = {}
    if args.stage1:
        composer, cfg = load_generator(args.stage1, 1, cfg, dev, sources)
    else:
        composer = SpectrogramGenerator(
            cfg.specgan, torch.Generator().manual_seed(0)).to(dev).eval()
    if args.stage2:
        vocoder, cfg = load_generator(args.stage2, 2, cfg, dev, sources)
    else:
        vocoder = Vocoder(cfg.vocoder,
                          torch.Generator().manual_seed(1)).to(dev).eval()
    if len(sources) == 2:
        (n1, m1), (n2, m2) = sources[1], sources[2]
        if (m1.shift, m1.scale) != (m2.shift, m2.scale):
            print(f"WARNING: stage-1 ({n1}: shift={m1.shift:.3f} "
                  f"scale={m1.scale:.3f}) and stage-2 ({n2}: "
                  f"shift={m2.shift:.3f} scale={m2.scale:.3f}) were trained "
                  "with different mel scalers; the vocoder's conditioning "
                  "will be mis-normalized.")

    zdim = cfg.specgan.latent_dim
    patch_s = (cfg.specgan.n_frames * cfg.frontend.hop_length
               / cfg.frontend.sample_rate)
    if args.seconds > patch_s:
        if args.crossfade_frames >= cfg.specgan.n_frames:
            raise SystemExit(
                f"--crossfade-frames ({args.crossfade_frames}) must be < the "
                f"stage-1 patch length ({cfg.specgan.n_frames} frames)")
        hop_t = cfg.specgan.n_frames - args.crossfade_frames
        frames = int(args.seconds * cfg.frontend.sample_rate
                     / cfg.frontend.hop_length)
        n_patches = max(1, -(-(frames - args.crossfade_frames) // hop_t))
        print(f"long-form: {n_patches} patches x {cfg.specgan.n_frames} "
              f"frames, crossfade {args.crossfade_frames}")
        if args.interpolate:
            sa, sb = (int(s) for s in args.interpolate.split(":"))
            z = latent_path(_normal(sa, (args.n, zdim)),
                            _normal(sb, (args.n, zdim)), max(2, n_patches))
            print(f"latent slerp path: seed {sa} -> seed {sb}")
        elif args.walk_step > 0:
            z = latent_walk(args.seed, args.n, n_patches, zdim,
                            step=args.walk_step)
            print(f"latent random walk: step {args.walk_step}")
        else:
            z = _normal(args.seed, (args.n, n_patches, zdim))
        fn, static = ((gen.generate_long_refined,
                       (args.crossfade_frames, args.gl_refine))
                      if args.gl_refine > 0 else
                      (gen.generate_long, (args.crossfade_frames,)))
    else:
        z = _normal(args.seed, (args.n, zdim))
        fn, static = ((gen.generate_refined, (args.gl_refine,))
                      if args.gl_refine > 0 else (gen.generate, ()))
    # On a card one CUDA graph of (fn, z's shape), as the reference jits fn.
    pipe = gen.GraphedPipeline(cfg, composer, vocoder)

    def call(zi: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            out = pipe(fn, zi.to(dev), *static).float().clone()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    t0 = time.perf_counter()
    wav = call(z)
    first_s = time.perf_counter() - t0
    # Steady state over fresh latents of the same shape.
    iters = 3
    t0 = time.perf_counter()
    for i in range(iters):
        call(_normal(args.seed + 1 + i, tuple(z.shape)))
    run_s = (time.perf_counter() - t0) / iters
    wav = wav.cpu().numpy()
    audio_s = wav.shape[0] * wav.shape[1] / cfg.frontend.sample_rate
    print(f"generated {wav.shape} ({audio_s:.2f}s audio): first call "
          f"{first_s:.1f}s, steady-state {run_s * 1e3:.1f} ms -> RTF "
          f"{audio_s / run_s:.0f}x")

    if args.target_rms > 0:
        rms = np.sqrt(np.mean(np.square(wav), axis=1, keepdims=True))
        # At most 100x: near-silent clips carry nothing worth amplifying.
        gains = np.minimum(args.target_rms / np.maximum(rms, 1e-12), 100.0)
        wav = np.clip(wav * gains, -1.0, 1.0)
        print(f"gain calibration: per-clip x{np.min(gains):.2f}-"
              f"x{np.max(gains):.2f} -> RMS {args.target_rms}")

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    for i in range(args.n):
        p = outdir / f"sample_{i:03d}.wav"
        write_wav(p, cfg.frontend.sample_rate, wav[i])
        print(f"wrote {p}")

    if args.report:
        z1 = z if z.ndim == 2 else z[:, 0]  # first patch of each clip
        with torch.inference_mode():
            mel = composer(z1.to(dev)).float().cpu().numpy()
        rp = write_report(
            outdir / "report.html", "two-stage generation",
            [(f"sample {i}", wav[i]) for i in range(args.n)],
            cfg.frontend.sample_rate, [mel[i] for i in range(args.n)],
            metrics={"rtf_x_realtime": audio_s / run_s})
        print(f"wrote {rp}")


if __name__ == "__main__":
    main()
