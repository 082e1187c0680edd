"""Export a deployment artifact (.msx) from zoo entries (counterpart of
``scripts/export_deploy.py``; ``deploy.py``).

    # Copy-synthesis vocoder, symbolic batch, 64-frame serving bucket:
    python -m music_synthesis_tpu_torch.scripts.export_deploy \\
        --zoo vocoder_istft --frames 64
    # The two-stage pipeline (latent -> waveform), fixed batch 8, CPU only:
    python -m music_synthesis_tpu_torch.scripts.export_deploy \\
        --pipeline specgan_flux vocoder_istft --batch 8 --platforms cpu \\
        --out deploy/two_stage.msx

Self-contained ``torch.export`` programs with the trained weights lifted
in: the serving host needs PyTorch and the artifact. One program is traced
per platform of ``--platforms`` (default ``cuda,cpu``), on that platform's
device, so ``cuda`` needs a card. ``--check`` reloads the artifact and runs
it on each listed platform this machine has.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from music_synthesis_tpu_torch import deploy, zoo
from music_synthesis_tpu_torch.config import PipelineConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="export_deploy",
                                 description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--zoo", metavar="VOCODER_ENTRY",
                      help="export copy-synthesis for one vocoder zoo entry")
    mode.add_argument("--pipeline", nargs=2,
                      metavar=("SPECGAN_ENTRY", "VOCODER_ENTRY"),
                      help="export the two-stage latent->wav pipeline")
    ap.add_argument("--frames", type=int, default=64,
                    help="mel frames per request (vocoder mode; the serving "
                         "bucket size)")
    ap.add_argument("--batch", default="poly",
                    help="'poly' (symbolic batch dim, default) or an int")
    ap.add_argument("--platforms", default="cuda,cpu",
                    help="comma-separated devices to trace a program on")
    ap.add_argument("--out", default=None,
                    help="output path (default deploy/<entry>.msx)")
    ap.add_argument("--check", action="store_true",
                    help="reload the artifact and run it on each listed "
                         "platform present")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Returns the artifact's header."""
    ap = parser()
    args = ap.parse_args(argv)
    platforms = tuple(p.strip() for p in args.platforms.split(",")
                      if p.strip())
    batch = None if args.batch == "poly" else int(args.batch)
    if "cuda" in platforms and not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: --platforms lists cuda but no CUDA device is "
                   "available; pass --platforms cpu\n")

    if args.zoo:
        entry = zoo.load_pretrained(args.zoo)
        if entry.kind != "vocoder":
            raise SystemExit(f"--zoo wants a vocoder entry, got {entry.kind}")
        exported, meta = deploy.vocoder_artifact(
            entry.state_dict, entry.config, n_frames=args.frames, batch=batch,
            platforms=platforms,
            provenance={"zoo": entry.name, "metrics": entry.card["metrics"]})
        default_out = f"deploy/{entry.name}_f{args.frames}.msx"
    else:
        s1 = zoo.load_pretrained(args.pipeline[0])
        s2 = zoo.load_pretrained(args.pipeline[1])
        if (s1.kind, s2.kind) != ("specgan", "vocoder"):
            raise SystemExit("--pipeline wants SPECGAN_ENTRY VOCODER_ENTRY "
                             f"in that order, got {s1.kind}/{s2.kind}")
        cfg = PipelineConfig(
            specgan=s1.config, vocoder=s2.config,
            **({"frontend": s2.frontend} if s2.frontend else {}),
            **({"mel_scaler": s2.mel_scaler} if s2.mel_scaler else {}))
        exported, meta = deploy.pipeline_artifact(
            cfg, s1.state_dict, s2.state_dict, batch=batch,
            platforms=platforms,
            provenance={"specgan_zoo": s1.name, "vocoder_zoo": s2.name})
        default_out = f"deploy/{s1.name}__{s2.name}.msx"

    out = deploy.save_artifact(args.out or default_out, exported, meta)
    size_mb = out.stat().st_size / 1e6
    print(f"wrote {out} ({size_mb:.1f} MB)")
    print(f"  kind={meta['kind']} platforms={meta['platforms']} "
          f"n_params_baked={meta['n_params_baked']:,}")
    print(f"  inputs={meta['inputs']} outputs={meta['outputs']}")

    if args.check:
        for platform in platforms:
            art = deploy.load_artifact(out, device=platform)
            shape = [2 if d == "b" else d for d in art.meta["inputs"][0]["shape"]]
            x = np.random.default_rng(0).standard_normal(shape).astype(
                np.float32)
            with torch.inference_mode():
                y = art(x).float().cpu().numpy()
            if not np.isfinite(y).all():
                raise SystemExit(f"check FAILED on {platform}: non-finite "
                                 "output")
            print(f"check OK: {list(x.shape)} -> {list(y.shape)}, "
                  f"output rms {float(np.sqrt((y ** 2).mean())):.4f} "
                  f"on {platform}")
    return meta


if __name__ == "__main__":
    main()
