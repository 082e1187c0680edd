"""Export a run's generator into the model zoo (counterpart of
``scripts/export_zoo.py``).

    python -m music_synthesis_tpu_torch.scripts.export_zoo --run RUN \\
        --stage 2 --name vocoder_x [--step N] [--root DIR] [--device cpu]

Writes the EMA generator when the run trained one (the weights a deployment
serves), else the raw one, from the newest checkpoint or ``--step``, with
the run's ``config.json`` (which decides the model config, as in the JAX
script; ``--preset``, ``--head``, ``--ema`` and ``--init-scheme`` are
accepted for its command lines and not read), ``mel_stats.json`` and
``eval/eval.json``. The entry is a Flax msgpack tree and a card that the
JAX package's ``zoo.load_pretrained`` reads as well. The checkpoint is
restored onto ``--device`` (``cuda`` unless told otherwise), the device
type the run trained on.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from music_synthesis_tpu_torch import zoo
from music_synthesis_tpu_torch._device import resolve_device
from music_synthesis_tpu_torch.config import MelScaler, config_from_dict
from music_synthesis_tpu_torch.train.checkpoint import CheckpointManager


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="export_zoo",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True)
    ap.add_argument("--stage", type=int, choices=[1, 2], required=True)
    ap.add_argument("--name", required=True, help="zoo entry name")
    ap.add_argument("--preset", choices=["default", "tiny"], default="default")
    ap.add_argument("--head", choices=["waveform", "istft"], default="waveform")
    ap.add_argument("--ema", type=float, default=0.0)
    ap.add_argument("--init-scheme", choices=["dcgan", "he"], default="dcgan")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--notes", default="")
    ap.add_argument("--root", default=None, help="zoo root (default: repo/zoo)")
    ap.add_argument("--device", default="cuda",
                    help="device to restore the checkpoint onto")
    return ap


def main(argv: list[str] | None = None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.exit(1, f"{ap.prog}: {e}\n")
    run = Path(args.run)
    cfg_file = run / "config.json"
    if not cfg_file.exists():
        ap.exit(1, f"{ap.prog}: no {cfg_file}; the port's training CLIs "
                   "write it before the first step\n")
    cfg = config_from_dict(json.loads(cfg_file.read_text()))
    print(f"config from {cfg_file} (CLI --preset/--head/--init-scheme/"
          f"--ema ignored)")
    mel_scaler = cfg.mel_scaler
    stats_file = run / "mel_stats.json"
    if stats_file.exists():
        s = json.loads(stats_file.read_text())
        mel_scaler = MelScaler(shift=s["shift"], scale=s["scale"])

    state = CheckpointManager(run / "ckpt").restore(args.step, device=dev)
    params = state.g_ema if state.g_ema is not None else state.g_params
    which = "ema" if state.g_ema is not None else "raw"
    metrics = {"checkpoint_step": state.step}
    eval_file = run / "eval" / "eval.json"
    if eval_file.exists():
        metrics.update(json.loads(eval_file.read_text()))

    kind = "vocoder" if args.stage == 2 else "specgan"
    out = zoo.save_pretrained(
        args.name, kind, params,
        cfg.vocoder if args.stage == 2 else cfg.specgan,
        frontend=cfg.frontend, mel_scaler=mel_scaler, metrics=metrics,
        notes=args.notes or f"{which} generator from {run} @ step {state.step}",
        **({"root": args.root} if args.root else {}))
    print(f"exported {kind} ({which} weights, step {state.step}) -> {out}")


if __name__ == "__main__":
    main()
