"""Checkpoint averaging of the stage-2 generator (counterpart of
``scripts/average_ckpts.py``).

    python -m music_synthesis_tpu_torch.scripts.average_ckpts --run RUN \\
        --steps 46000,47000,48000 --out RUN_AVG [--device cpu]

Averages ``g_params``, and ``g_ema`` when the run keeps one, in float64
over the listed checkpoints of a port stage-2 run, and writes a run
directory (``config.json``, ``mel_stats.json``, one checkpoint at the
largest step, ``STATUS``) that ``eval_checkpoint --run`` and
``export_zoo`` read unchanged. D, both Adam states and the generator state
are the last listed step's. A checkpoint is restored on the device type it
was saved from: ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
from pathlib import Path

import torch

from music_synthesis_tpu_torch.scripts._run import cli_device
from music_synthesis_tpu_torch.train.checkpoint import CheckpointManager


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="average_ckpts",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True)
    ap.add_argument("--steps", required=True,
                    help="comma-separated checkpoint steps to average")
    ap.add_argument("--out", required=True, help="run directory to write")
    ap.add_argument("--device", default="cuda",
                    help="device the checkpoints were saved from ('cpu')")
    return ap


def _mean(trees: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    out = {}
    for name, leaf in trees[0].items():
        acc = sum(t[name].double() for t in trees)
        out[name] = (acc / float(len(trees))).to(leaf.dtype)
    return out


def main(argv: list[str] | None = None) -> Path:
    """Returns the written run directory."""
    ap = parser()
    args = ap.parse_args(argv)
    dev = cli_device(ap, args.device)
    run = Path(args.run)
    steps = [int(s) for s in args.steps.split(",")]
    mgr = CheckpointManager(run / "ckpt")
    states = []
    for s in steps:
        states.append(mgr.restore(s, device=dev))
        print(f"loaded step {s}")
    last = states[-1]
    state = dataclasses.replace(
        last, g_params=_mean([st.g_params for st in states]))
    if last.g_ema is not None:
        state = dataclasses.replace(
            state, g_ema=_mean([st.g_ema for st in states]))

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(run / "config.json", out / "config.json")
    if (run / "mel_stats.json").exists():
        shutil.copy(run / "mel_stats.json", out / "mel_stats.json")
    CheckpointManager(out / "ckpt").save(max(steps), state)
    (out / "STATUS").write_text(
        f"SWA average of {run} checkpoints {steps} "
        "(generator weights only; D/opt state from the last step)\n")
    print(f"wrote averaged run -> {out}")
    return out


if __name__ == "__main__":
    main()
