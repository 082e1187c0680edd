"""Per-file output fidelity (counterpart of ``scripts/parity.py``).

    python -m music_synthesis_tpu_torch.scripts.parity OURS_DIR REF_DIR \\
        [--sample-rate 22050] [--device cpu]

The multi-resolution STFT distance between the WAVs of two directories
that share a file name, each per file on standard error and their mean in
one JSON line on standard output (the JAX script's line); exit code 1 with
``{"error": ...}`` when no name matches. Runs on ``cuda`` unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from music_synthesis_tpu_torch.losses.stft_loss import multires_stft_loss
from music_synthesis_tpu_torch.scripts._run import cli_device
from music_synthesis_tpu_torch.utils.wav import load_wav


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="parity",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("ours")
    ap.add_argument("reference")
    ap.add_argument("--sample-rate", type=int, default=22_050)
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' for smoke runs)")
    return ap


@torch.inference_mode()
def main(argv: list[str] | None = None) -> dict:
    """Returns the JSON line's object."""
    ap = parser()
    args = ap.parse_args(argv)
    dev = cli_device(ap, args.device)
    ours = {p.name: p for p in Path(args.ours).glob("*.wav")}
    ref = {p.name: p for p in Path(args.reference).glob("*.wav")}
    common = sorted(set(ours) & set(ref))
    if not common:
        print(json.dumps({"error": "no matching filenames"}))
        sys.exit(1)

    results = {}
    for name in common:
        a = load_wav(ours[name], args.sample_rate)
        b = load_wav(ref[name], args.sample_rate)
        n = min(len(a), len(b))
        x = torch.from_numpy(a[:n])[None].to(dev)
        y = torch.from_numpy(b[:n])[None].to(dev)
        d = float(multires_stft_loss(x, y))
        results[name] = round(d, 6)
        print(f"{name}: multires_stft_distance = {d:.6f}", file=sys.stderr)
    mean = sum(results.values()) / len(results)
    line = {
        "metric": "multires_stft_distance_vs_reference",
        "value": round(mean, 6),
        "unit": "distance (0 = identical)",
        "per_file": results,
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
