"""Copy-synthesis evaluation of a vocoder (counterpart of
``scripts/eval_checkpoint.py``).

    python -m music_synthesis_tpu_torch.scripts.eval_checkpoint \\
        (--run RUN | --zoo vocoder_istft) --corpus DIR [--out DIR] \\
        [--n-clips 8 --seconds 4 --gl-anchor --gl-refine 8 --device cpu]

Resynthesizes held-out corpus segments (``sample_batch(2**29 + i, 1,
seed=1234)``, the JAX script's draws, so both packages score the same
clips) from their own log-mel through the vocoder, and writes
``eval.json`` with the JAX script's keys: the multi-resolution STFT
distance, the phase-jitter ratio, the MCD and the RMS ratio per clip and
in the mean; with ``--gl-anchor`` the same for 48-iteration Griffin-Lim on
the same mels, with ``--gl-refine N`` for the vocoder's audio after N
warm-started Griffin-Lim iterations. Also the WAVs and an HTML report.

``--zoo`` takes a zoo vocoder (its card's config, front-end and MelScaler;
the metric's resolutions from ``--preset``). ``--run`` takes a run
directory of the port's ``train_stage2`` (``config.json``,
``mel_stats.json``, ``ckpt/<step>.pt``; the EMA generator when there is
one); the conditioning is the run's: with ``use_pallas_frontend`` it goes
through the fused log-mel kernel, one launch per clip on the card, and on
the CPU through its plain version. Without ``config.json`` the model comes
from ``--preset``/``--head``. Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from music_synthesis_tpu_torch._graphs import Programs
from music_synthesis_tpu_torch import zoo
from music_synthesis_tpu_torch.config import (
    TINY,
    MelScaler,
    PipelineConfig,
    config_from_dict,
)
from music_synthesis_tpu_torch.data.dataset import AudioDataset
from music_synthesis_tpu_torch.losses.stft_loss import multires_stft_loss
from music_synthesis_tpu_torch.models.vocoder import Vocoder
from music_synthesis_tpu_torch.ops.cepstrum import mcd
from music_synthesis_tpu_torch.ops.frontend import log_mel_for_vocoder
from music_synthesis_tpu_torch.ops.griffin_lim import (
    invert_log_mel,
    refine_with_log_mel,
)
from music_synthesis_tpu_torch.ops.phase import phase_jitter_ratio
from music_synthesis_tpu_torch.scripts._run import cli_device
from music_synthesis_tpu_torch.train import stage2
from music_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from music_synthesis_tpu_torch.utils.report import write_report
from music_synthesis_tpu_torch.utils.wav import write_wav


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="eval_checkpoint",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", default=None, help="training outdir (with ckpt/)")
    ap.add_argument("--zoo", default=None,
                    help="evaluate a zoo vocoder entry instead of a run")
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--out", default=None, help="default: RUN/eval")
    ap.add_argument("--preset", choices=["default", "tiny"], default="default")
    ap.add_argument("--head", choices=["waveform", "istft"], default="waveform")
    ap.add_argument("--ema", type=float, default=0.0,
                    help="accepted for the JAX script's command lines (a "
                         "port checkpoint holds its EMA or not)")
    ap.add_argument("--n-clips", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--step", type=int, default=None, help="ckpt step (latest)")
    ap.add_argument("--gl-anchor", action="store_true",
                    help="also score 48-iteration Griffin-Lim on the same mels")
    ap.add_argument("--gl-refine", type=int, default=0,
                    help="also score the vocoder's audio after N warm-started "
                         "Griffin-Lim iterations")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' for smoke runs)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Returns the metrics written to ``eval.json``."""
    ap = parser()
    args = ap.parse_args(argv)
    if (args.run is None) == (args.zoo is None):
        ap.error("exactly one of --run / --zoo is required")
    dev = cli_device(ap, args.device)
    base = TINY if args.preset == "tiny" else PipelineConfig()

    if args.zoo is not None:
        entry = zoo.load_pretrained(args.zoo)
        if entry.kind != "vocoder":
            ap.error(f"--zoo entry {args.zoo!r} is kind={entry.kind!r}; "
                     "copy-synthesis eval needs a vocoder")
        out = Path(args.out) if args.out else Path("runs") / f"zoo_eval_{args.zoo}"
        cfg = dataclasses.replace(
            base, vocoder=entry.config,
            frontend=entry.frontend or base.frontend,
            mel_scaler=entry.mel_scaler or base.mel_scaler)
        if entry.mel_scaler is not None:
            print(f"using zoo mel scaler: shift={entry.mel_scaler.shift} "
                  f"scale={entry.mel_scaler.scale}")
        print(f"zoo entry {args.zoo} ({entry.card.get('n_params')} params)")
        step = int(entry.card.get("metrics", {}).get("step", 0) or 0)
        return eval_body(args, cfg, entry.model(dev), step, "zoo", out)

    run = Path(args.run)
    out = Path(args.out) if args.out else run / "eval"
    cfg_file = run / "config.json"
    if cfg_file.exists():
        cfg = config_from_dict(json.loads(cfg_file.read_text()))
        print(f"config from {cfg_file}")
    else:
        vocoder = base.vocoder
        if args.head == "istft":
            vocoder = dataclasses.replace(
                vocoder, head="istft", upsample_factors=(8, 8),
                istft_n_fft=16, istft_hop=4)
        cfg = dataclasses.replace(base, vocoder=vocoder)
    stats_file = run / "mel_stats.json"
    if stats_file.exists():
        s = json.loads(stats_file.read_text())
        cfg = dataclasses.replace(
            cfg, mel_scaler=MelScaler(shift=s["shift"], scale=s["scale"]))
        print(f"using corpus mel stats: {s}")
    state = CheckpointManager(run / "ckpt").restore(args.step, device=dev)
    g = state.g_ema if state.g_ema is not None else state.g_params
    which = "ema" if state.g_ema is not None else "raw"
    print(f"checkpoint step {state.step} ({which} generator weights)")
    vocoder = Vocoder(cfg.vocoder)
    vocoder.load_state_dict(g, strict=True)
    vocoder = vocoder.to(dev).eval().requires_grad_(False)
    return eval_body(args, cfg, vocoder, state.step, which, out)


@torch.inference_mode()
def eval_body(args, cfg: PipelineConfig, vocoder: Vocoder, step: int,
              which: str, out: Path) -> dict:
    """Score ``args.n_clips`` held-out clips; write the WAVs, ``eval.json``
    and ``report.html`` under ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    dev = next(vocoder.parameters()).device
    fe = cfg.frontend
    seg = int(args.seconds * fe.sample_rate) // fe.hop_length * fe.hop_length
    ds = AudioDataset(args.corpus, sample_rate=fe.sample_rate,
                      segment_length=seg)

    def np1(t: torch.Tensor) -> np.ndarray:
        return t[0].float().cpu().numpy()

    per = {k: [] for k in ("dist", "jitter", "mcd_db", "rms_ratio")}
    ref_dists, ref_jitters, gl_mcds = [], [], []
    gl_dists, gl_jitters = [], []
    clips = []
    # Copy-synthesis and its distance, one CUDA graph on a card (the
    # reference jits both): every clip has one shape.
    programs = Programs(dev)

    def copy_synth(x: torch.Tensor):
        y = vocoder(stage2.conditioning_mel(x, cfg)).float()
        return y, multires_stft_loss(y, x, cfg.stft_loss)

    for i in range(args.n_clips):
        # Held-out step indices far from any training step.
        real = ds.sample_batch(2**29 + i, 1, seed=1234)
        x = torch.from_numpy(real).to(dev)
        y, d = programs("copy", copy_synth, x)
        y, d = y.clone(), float(d)
        per["dist"].append(d)
        per["jitter"].append(float(phase_jitter_ratio(
            y, x, n_fft=fe.n_fft, hop_length=fe.hop_length)))
        per["mcd_db"].append(float(mcd(y, x, fe)))
        # The spectral distance is insensitive to broad level errors.
        y_np = y.cpu().numpy()
        per["rms_ratio"].append(float(np.sqrt(
            (np.mean(np.square(y_np)) + 1e-12)
            / (np.mean(np.square(real)) + 1e-12))))
        write_wav(out / f"real_{i:02d}.wav", fe.sample_rate, real[0])
        write_wav(out / f"resynth_{i:02d}.wav", fe.sample_rate, y_np[0])
        clips.append((f"real {i}", real[0]))
        clips.append((f"resynth {i} (stft_dist={d:.4f})", y_np[0]))
        if args.gl_refine or args.gl_anchor:
            # The real clip's raw log-mel: the vocoder's own conditioning.
            lm = log_mel_for_vocoder(x, fe)
        if args.gl_refine:
            y_ref = refine_with_log_mel(y, lm, fe, n_iter=args.gl_refine)
            y_ref = y_ref[:, : x.shape[1]]
            ref_dists.append(float(multires_stft_loss(y_ref, x, cfg.stft_loss)))
            ref_jitters.append(float(phase_jitter_ratio(
                y_ref, x, n_fft=fe.n_fft, hop_length=fe.hop_length)))
            write_wav(out / f"refined_{i:02d}.wav", fe.sample_rate, np1(y_ref))
            clips.append((f"refined {i} (n_iter={args.gl_refine}, "
                          f"stft_dist={ref_dists[-1]:.4f})", np1(y_ref)))
        if args.gl_anchor:
            # Model-free anchor: Griffin-Lim on the same mel.
            y_gl = invert_log_mel(lm, fe, 48)[:, : x.shape[1]]
            gl_dists.append(float(multires_stft_loss(y_gl, x, cfg.stft_loss)))
            gl_jitters.append(float(phase_jitter_ratio(
                y_gl, x, n_fft=fe.n_fft, hop_length=fe.hop_length)))
            gl_mcds.append(float(mcd(y_gl, x, fe)))
            clips.append((f"griffin-lim {i} (stft_dist={gl_dists[-1]:.4f})",
                          np1(y_gl)))
        print(f"clip {i}: multires_stft_distance = {d:.4f}")

    dists = per["dist"]
    metrics = {
        "checkpoint_step": step,
        "copy_synthesis_multires_stft_distance_mean": float(np.mean(dists)),
        "copy_synthesis_multires_stft_distance_std": float(np.std(dists)),
        "resynth_rms_over_real_rms_mean": float(np.mean(per["rms_ratio"])),
        "phase_jitter_ratio_mean": float(np.mean(per["jitter"])),
        "mcd_db_mean": float(np.mean(per["mcd_db"])),
        "n_clips": args.n_clips,
        "generator_weights": 0.0 if which == "raw" else 1.0,
        # Per-clip values: the held-out clips are fixed, so evals on one
        # corpus can be compared clip by clip.
        "per_clip": per,
    }
    if ref_dists:
        metrics["gl_refine_n_iter"] = args.gl_refine
        metrics["gl_refined_distance_mean"] = float(np.mean(ref_dists))
        metrics["gl_refined_phase_jitter_ratio_mean"] = float(
            np.mean(ref_jitters))
    if gl_dists:
        metrics["griffin_lim_anchor_distance_mean"] = float(np.mean(gl_dists))
        metrics["griffin_lim_phase_jitter_ratio_mean"] = float(
            np.mean(gl_jitters))
        metrics["griffin_lim_mcd_db_mean"] = float(np.mean(gl_mcds))
        per["gl_dist"] = gl_dists
        per["gl_jitter"] = gl_jitters
    (out / "eval.json").write_text(json.dumps(metrics, indent=1))
    write_report(out / "report.html",
                 f"copy-synthesis eval @ step {step} ({which})",
                 clips, fe.sample_rate, metrics=metrics)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
