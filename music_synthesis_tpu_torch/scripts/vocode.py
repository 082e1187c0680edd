"""Copy-synthesis of one file (counterpart of ``scripts/vocode.py``).

    python -m music_synthesis_tpu_torch.scripts.vocode input.wav \\
        [--stage2 vocoder_istft | RUN/ckpt] [--griffin-lim --gl-iters 48] \\
        [--out resynth.wav] [--device cpu]

WAV -> log-mel -> vocoder -> WAV, and the multi-resolution STFT distance
to the input. The vocoder is a zoo entry or a port run's checkpoint
directory (``scripts/generate.py::load_generator``), or without
``--stage2`` a seeded random init (noise-like output); ``--griffin-lim``
inverts the log-mel with Griffin-Lim instead (``ops/griffin_lim.py``).
Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import torch

from music_synthesis_tpu_torch._graphs import Programs
from music_synthesis_tpu_torch.config import E2E_INFERENCE
from music_synthesis_tpu_torch.losses.stft_loss import multires_stft_loss
from music_synthesis_tpu_torch.models.vocoder import Vocoder
from music_synthesis_tpu_torch.ops.frontend import log_mel_for_vocoder
from music_synthesis_tpu_torch.ops.griffin_lim import invert_log_mel
from music_synthesis_tpu_torch.scripts._run import cli_device
from music_synthesis_tpu_torch.scripts.generate import load_generator
from music_synthesis_tpu_torch.train import stage2
from music_synthesis_tpu_torch.utils.wav import load_wav, write_wav


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="vocode",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("input")
    ap.add_argument("--stage2", default=None,
                    help="stage-2 checkpoint dir or zoo entry")
    ap.add_argument("--griffin-lim", action="store_true",
                    help="model-free Griffin-Lim instead of the vocoder")
    ap.add_argument("--gl-iters", type=int, default=48)
    ap.add_argument("--out", default="resynth.wav")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' for smoke runs)")
    return ap


def main(argv: list[str] | None = None) -> float:
    """Returns the distance to the input."""
    ap = parser()
    args = ap.parse_args(argv)
    dev = cli_device(ap, args.device)
    cfg = E2E_INFERENCE
    if args.stage2 and not args.griffin_lim:
        vocoder, cfg = load_generator(args.stage2, 2, cfg, dev)
    elif not args.griffin_lim:
        vocoder = Vocoder(cfg.vocoder,
                          torch.Generator().manual_seed(1)).to(dev).eval()
        print("note: untrained vocoder (no --stage2); output is noise-like")
    wav = load_wav(args.input, cfg.frontend.sample_rate)
    # Trimmed to a hop multiple so the conditioning aligns exactly.
    hop = cfg.frontend.hop_length
    x = torch.from_numpy(wav[: len(wav) // hop * hop])[None].to(dev)
    with torch.inference_mode():
        if args.griffin_lim:
            y = invert_log_mel(log_mel_for_vocoder(x, cfg.frontend),
                               cfg.frontend, args.gl_iters)
            dist = float(multires_stft_loss(y, x, cfg.stft_loss))
        else:
            # One CUDA graph on a card, as the reference jits the vocoder.
            def copy_synth(wav: torch.Tensor):
                out = vocoder(stage2.conditioning_mel(wav, cfg)).float()
                return out, multires_stft_loss(out, wav, cfg.stft_loss)

            y, dist = Programs(dev)("copy", copy_synth, x)
            y, dist = y.clone(), float(dist)
    print(f"resynthesized {y.shape[1]} samples; "
          f"multires_stft_distance vs input = {dist:.4f}")
    write_wav(args.out, cfg.frontend.sample_rate, y[0].cpu().numpy())
    print(f"wrote {args.out}")
    return dist


if __name__ == "__main__":
    main()
