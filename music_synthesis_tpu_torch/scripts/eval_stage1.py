"""Stage-1 composer evaluation (counterpart of ``scripts/eval_stage1.py``).

    python -m music_synthesis_tpu_torch.scripts.eval_stage1 \\
        (--run RUN | --zoo specgan_flux) --corpus DIR [--n 64 --seed 0] \\
        [--out DIR] [--device cpu]

How well the generated log-mel distribution matches real corpus patches,
with the JAX script's metrics and ``eval.json`` keys: the per-mel-bin mean
and std L2 gaps, the temporal flux of both sides and their ratio, the
mel-covariance eigenspectrum gap and both RMS. The real patches are
``AudioDataset.sample_batch(2**28, n, seed=4321)`` (the JAX script's
draws), conditioned by ``ops.logmel.fused_log_mel_for_vocoder`` in "exact"
precision (on the card one kernel launch for the whole batch) and
normalized by the MelScaler. Two calibration anchors are printed, scored
the same way: a generator with random weights (the port's own seeded
initialisation; the JAX script's ``PRNGKey(99)`` init cannot be
reproduced) and white noise in mel space (numpy, the JAX script's draw).

``--run`` takes a port stage-1 run (``config.json``, ``ckpt/<step>.pt``; the
EMA generator when there is one), ``--zoo`` a zoo composer. The latents
are drawn from a torch generator seeded by ``--seed``; ``evaluate`` takes
them injected. Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from music_synthesis_tpu_torch import zoo
from music_synthesis_tpu_torch.config import PipelineConfig, config_from_dict
from music_synthesis_tpu_torch.data.dataset import AudioDataset
from music_synthesis_tpu_torch.models.specgan import SpectrogramGenerator
from music_synthesis_tpu_torch.ops.logmel import fused_log_mel_for_vocoder
from music_synthesis_tpu_torch.scripts._run import cli_device
from music_synthesis_tpu_torch.train.checkpoint import CheckpointManager

ANCHOR_SEED = 99  # the random-weights anchor's initialisation


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="eval_stage1",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", default=None, help="training outdir (with ckpt/)")
    ap.add_argument("--zoo", default=None, help="zoo entry name instead")
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--n", type=int, default=64, help="patches per side")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="default: RUN/eval_stage1")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' for smoke runs)")
    return ap


def _stats(x: np.ndarray):
    flat = x.reshape(-1, x.shape[-1])  # [N*T, M]
    mean = flat.mean(0)
    std = flat.std(0)
    flux = np.abs(np.diff(x, axis=1)).mean()
    cov = np.cov(flat.T)
    eig = np.sort(np.linalg.eigvalsh(cov))[::-1][:32]
    return mean, std, flux, eig


def _gaps(x_stats, real_stats) -> dict:
    xm, xs, xflux, xeig = x_stats
    rm, rs, rflux, reig = real_stats
    return {
        "bin_mean_l2": float(np.linalg.norm(xm - rm) / np.sqrt(len(rm))),
        "bin_std_l2": float(np.linalg.norm(xs - rs) / np.sqrt(len(rs))),
        "flux_ratio": float(xflux / max(rflux, 1e-9)),
        "eig_log_l2": float(np.linalg.norm(
            np.log(np.maximum(xeig, 1e-9)) - np.log(np.maximum(reig, 1e-9))
        ) / np.sqrt(len(reig))),
    }


def real_patches(cfg: PipelineConfig, corpus: str | Path, n: int,
                 device: torch.device) -> np.ndarray:
    """``n`` normalized log-mel patches ``[n, n_frames, n_mels]`` of the
    corpus (the JAX script's draws), through the fused log-mel in "exact"
    precision on ``device``: one kernel launch on the card."""
    seg = cfg.specgan.n_frames * cfg.frontend.hop_length
    ds = AudioDataset(corpus, sample_rate=cfg.frontend.sample_rate,
                      segment_length=seg)
    wav = torch.from_numpy(ds.sample_batch(2**28, n, seed=4321)).to(device)
    mel = fused_log_mel_for_vocoder(wav, cfg.frontend, precision="exact")
    return ((mel - cfg.mel_scaler.shift) / cfg.mel_scaler.scale).cpu().numpy()


def score(fake: np.ndarray, real: np.ndarray, step: int) -> dict:
    """The metrics of ``eval.json`` for generated against real patches."""
    real_stats = _stats(real)
    fake_stats = _stats(fake)
    gaps = _gaps(fake_stats, real_stats)
    return {
        "checkpoint_step": step,
        "n_patches": len(fake),
        "bin_mean_l2": gaps["bin_mean_l2"],
        "bin_std_l2": gaps["bin_std_l2"],
        "real_flux": float(real_stats[2]),
        "fake_flux": float(fake_stats[2]),
        "flux_ratio": gaps["flux_ratio"],
        "eig_log_l2": gaps["eig_log_l2"],
        "fake_rms": float(np.sqrt((fake ** 2).mean())),
        "real_rms": float(np.sqrt((real ** 2).mean())),
    }


@torch.inference_mode()
def evaluate(cfg: PipelineConfig, generator: SpectrogramGenerator,
             corpus: str | Path, z: torch.Tensor, step: int,
             anchor: SpectrogramGenerator | None = None
             ) -> tuple[dict, dict]:
    """``(metrics, anchors)`` for ``generator`` on the latents ``z``
    ``[n, latent_dim]`` against ``n`` real patches of ``corpus``;
    ``anchor`` is the random-weights generator (default: the port's
    initialisation seeded by ``ANCHOR_SEED``)."""
    dev = next(generator.parameters()).device
    z = torch.as_tensor(z, dtype=torch.float32, device=dev)
    fake = generator(z).float().cpu().numpy()  # [N, T, M], normalized
    real = real_patches(cfg, corpus, z.shape[0], dev)
    metrics = score(fake, real, step)

    if anchor is None:
        anchor = SpectrogramGenerator(
            cfg.specgan, torch.Generator().manual_seed(ANCHOR_SEED))
    rnd = anchor.to(dev).eval()(z).float().cpu().numpy()
    noise = np.random.default_rng(0).normal(
        0, real.std(), size=real.shape).astype(np.float32)
    real_stats = _stats(real)
    anchors = {name: _gaps(_stats(x), real_stats)
               for name, x in (("random_weights", rnd), ("white_noise", noise))}
    return metrics, anchors


def main(argv: list[str] | None = None) -> tuple[dict, dict]:
    """Returns ``(metrics, anchors)``; ``metrics`` is ``eval.json``."""
    ap = parser()
    args = ap.parse_args(argv)
    if (args.run is None) == (args.zoo is None):
        ap.error("exactly one of --run / --zoo is required")
    dev = cli_device(ap, args.device)
    if args.zoo:
        e = zoo.load_pretrained(args.zoo)
        if e.kind != "specgan":
            ap.error(f"--zoo entry {args.zoo!r} is kind={e.kind!r}; the "
                     "composer eval needs a specgan")
        cfg = PipelineConfig(specgan=e.config)
        if e.frontend is not None:
            cfg = dataclasses.replace(cfg, frontend=e.frontend)
        if e.mel_scaler is not None:
            cfg = dataclasses.replace(cfg, mel_scaler=e.mel_scaler)
        gen = e.model(dev)
        step = e.card["metrics"].get("checkpoint_step", -1)
        out = Path(args.out or f"runs/eval_{args.zoo}")
    else:
        run = Path(args.run)
        cfg = config_from_dict(json.loads((run / "config.json").read_text()))
        state = CheckpointManager(run / "ckpt").restore(device=dev)
        step = state.step
        g = state.g_ema if state.g_ema is not None else state.g_params
        gen = SpectrogramGenerator(cfg.specgan)
        gen.load_state_dict(g, strict=True)
        gen = gen.to(dev).eval().requires_grad_(False)
        out = Path(args.out or (run / "eval_stage1"))
    out.mkdir(parents=True, exist_ok=True)

    rng = torch.Generator(device=dev).manual_seed(args.seed)
    z = torch.randn((args.n, cfg.specgan.latent_dim), generator=rng,
                    device=dev)
    metrics, anchors = evaluate(cfg, gen, args.corpus, z, step)
    (out / "eval.json").write_text(json.dumps(metrics, indent=1))
    print(json.dumps(metrics, indent=1))
    # Calibration anchors, so the numbers are interpretable.
    for name, m in anchors.items():
        print(f"anchor[{name}]: {json.dumps(m)}")
    return metrics, anchors


if __name__ == "__main__":
    main()
