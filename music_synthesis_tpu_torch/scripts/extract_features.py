"""Log-mel extraction of one 22.05 kHz clip (counterpart of
``scripts/extract_features.py``, BASELINE.json's judged scenario 1).

    python -m music_synthesis_tpu_torch.scripts.extract_features \\
        [clip.wav] [--out mel.npy] [--device cpu]

Without a clip, a deterministic synthetic 4 s clip is written first (one
clip of ``make_synthetic_corpus`` in the temporary directory). The
features are ``FRONTEND_CPU_CLIP.frontend``'s log-mel (n_fft 1024, hop
256, 128 mels, not centred) through ``ops.logmel.fused_log_mel`` in
"exact" precision: on the card one launch of the log-mel kernel, on the
CPU its plain version. The printed lines are the JAX script's.

The JAX script runs on the CPU unless ``--device default``, because the
judged scenario is a CPU extraction; this one runs on ``cuda`` unless
``--device cpu``, as every entry point of the port does (``default`` is
taken as ``cuda``).
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from music_synthesis_tpu_torch.config import FRONTEND_CPU_CLIP
from music_synthesis_tpu_torch.data.dataset import make_synthetic_corpus
from music_synthesis_tpu_torch.ops.logmel import fused_log_mel
from music_synthesis_tpu_torch.scripts._run import cli_device
from music_synthesis_tpu_torch.utils.wav import load_wav


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="extract_features",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("clip", nargs="?", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu'; 'default' is cuda)")
    return ap


def main(argv: list[str] | None = None) -> np.ndarray:
    """Returns the log-mel ``[1, T, n_mels]``."""
    ap = parser()
    args = ap.parse_args(argv)
    dev = cli_device(ap, "cuda" if args.device == "default" else args.device)
    cfg = FRONTEND_CPU_CLIP.frontend
    if args.clip is None:
        root = Path(tempfile.gettempdir()) / "msynth_demo_corpus"
        path = make_synthetic_corpus(root, n_clips=1, seconds=4.0)[0]
        print(f"no clip given; using synthetic {path}")
    else:
        path = args.clip
    wav = load_wav(path, cfg.sample_rate)
    x = torch.from_numpy(wav)[None].to(dev)
    t0 = time.perf_counter()
    mel = fused_log_mel(x, cfg, precision="exact")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    out = mel.cpu().numpy()
    print(f"{path}: {len(wav)} samples -> log-mel {out.shape} "
          f"in {seconds:.3f}s on {dev.type}")
    print(f"range [{float(out.min()):.2f}, {float(out.max()):.2f}]")
    if args.out:
        np.save(args.out, out[0])
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
