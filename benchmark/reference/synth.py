"""The plain reference of two-stage synthesis.

Written after the port's ``infer/generate.py`` (``generate_long``:
composer patches crossfaded into one long mel, overlapping chunks through
the vocoder, windowed overlap-add) at commit 29bca4e. The models are ``reference.model``'s, loaded from the zoo
entry's own files (``card.json``, ``params.msgpack``).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from harness.config import ns
from reference.model import (
    SpectrogramGenerator,
    Vocoder,
    ola_normalizer,
    ola_window,
    overlap_add,
)
from reference.zoo_params import state_dict

__all__ = ["load_entry", "generate_long"]


def load_entry(entry_dir: Path, device, compute_dtype: str | None = None):
    """``(module, card)`` of a zoo entry on ``device``, in eval mode,
    its convolutions in ``compute_dtype`` if given, else the card's."""
    card = json.loads((entry_dir / "card.json").read_text())
    cfg = dict(card["config"])
    if compute_dtype:
        cfg["compute_dtype"] = compute_dtype
    cls = Vocoder if card["kind"] == "vocoder" else SpectrogramGenerator
    module = cls(ns(cfg))
    module.load_state_dict(state_dict(entry_dir / "params.msgpack"),
                           strict=True)
    return module.to(device).eval().requires_grad_(False), card


def _stitch(composer, z: torch.Tensor, crossfade: int, chunk: int,
            hop: int) -> torch.Tensor:
    b, n, zdim = z.shape
    t = composer.cfg.n_frames
    mel = composer(z.reshape(b * n, zdim)).reshape(b, n, t, -1)
    hop_t = t - crossfade
    window = ola_window(t, hop_t, device=z.device)
    stacked = (mel * window[:, None]).permute(0, 3, 1, 2)
    long = (overlap_add(stacked, hop_t)
            / ola_normalizer(window, n, hop_t)).transpose(1, 2)
    t_long = long.shape[1]
    return long[:, : t_long - (t_long - chunk) % hop]


def _vocode(vocoder, mel: torch.Tensor, chunk: int, hop: int) -> torch.Tensor:
    hop_audio = 1
    for u in vocoder.cfg.upsample_factors:
        hop_audio *= u
    if vocoder.cfg.head == "istft":
        hop_audio *= vocoder.cfg.istft_hop
    chunks = mel.unfold(1, chunk, hop).transpose(-1, -2)
    b, n, c, m = chunks.shape
    wav = vocoder(chunks.reshape(b * n, c, m)).reshape(b, n, c * hop_audio)
    step = hop * hop_audio
    window = ola_window(c * hop_audio, step, device=mel.device)
    return overlap_add(wav * window, step) / ola_normalizer(window, n, step)


@torch.no_grad()
def generate_long(composer, vocoder, z: torch.Tensor, crossfade: int,
                  infer) -> torch.Tensor:
    """``z [B, N, Z]`` -> ``wav [B, L]`` float32."""
    mel = _stitch(composer, z, crossfade, infer.chunk_frames,
                  infer.hop_frames)
    return _vocode(vocoder, mel, infer.chunk_frames, infer.hop_frames).float()

