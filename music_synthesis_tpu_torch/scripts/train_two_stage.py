"""Data-parallel two-stage training (counterpart of
``scripts/train_two_stage.py``): the stage-1 composer and the stage-2
vocoder trained back to back over one corpus, then clips generated from
the two runs with a report.

    python -m music_synthesis_tpu_torch.scripts.train_two_stage \\
        --steps 500 --mesh 8 --outdir runs/two_stage [--device cpu]

The three CLIs run one after another as ``python -m`` modules:
``train_stage1`` and ``train_stage2`` with ``--mesh`` (each starts its
ranks), then ``generate`` from both runs' checkpoints. Without ``--corpus``
a synthetic corpus is written into the run directory first. Runs on
``cuda`` unless ``--device cpu`` is given; the first CLI that fails ends
the run with its exit code.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

from music_synthesis_tpu_torch.data.dataset import make_synthetic_corpus

PACKAGE = "music_synthesis_tpu_torch.scripts"
# The directory that holds the package, for the CLIs' import path.
ROOT = Path(__file__).resolve().parents[2]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="train_two_stage",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", default=None)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--mesh", type=int, default=1)
    ap.add_argument("--outdir", default="runs/two_stage")
    ap.add_argument("--preset", choices=["default", "tiny"], default="default")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' for smoke runs)")
    return ap


def commands(args: argparse.Namespace, corpus: str) -> list[list[str]]:
    """The three CLI command lines, in order."""
    outdir = Path(args.outdir)
    base = [sys.executable, "-m"]
    common = ["--corpus", str(corpus), "--steps", str(args.steps),
              "--batch", str(args.batch), "--mesh", str(args.mesh),
              "--preset", args.preset, "--device", args.device]
    return [
        base + [f"{PACKAGE}.train_stage1", *common,
                "--outdir", str(outdir / "stage1")],
        base + [f"{PACKAGE}.train_stage2", *common,
                "--outdir", str(outdir / "stage2")],
        base + [f"{PACKAGE}.generate",
                "--stage1", str(outdir / "stage1" / "ckpt"),
                "--stage2", str(outdir / "stage2" / "ckpt"),
                "--preset", args.preset, "--device", args.device,
                "--n", "4", "--out", str(outdir / "samples"), "--report"],
    ]


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    corpus = args.corpus
    if corpus is None:
        corpus = str(outdir / "synthetic_corpus")
        make_synthetic_corpus(corpus, n_clips=8, seconds=4.0)
        print(f"no --corpus; wrote synthetic corpus to {corpus}", flush=True)
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT)] + ([path] if path else []))}
    for cmd in commands(args, corpus):
        rc = subprocess.call(cmd, env=env)
        if rc != 0:
            sys.exit(rc)


if __name__ == "__main__":
    main()
