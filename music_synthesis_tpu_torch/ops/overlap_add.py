"""Overlap-add of chunked waveforms (counterpart of ``ops/overlap_add.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["overlap_add", "ola_window", "ola_normalizer"]


def overlap_add(chunks: torch.Tensor, hop: int) -> torch.Tensor:
    """Sum overlapping chunks: ``[..., N, C] -> [..., (N-1)*hop + C]``.

    Chunk n starts at sample n*hop. Written as r = ceil(C/hop) shifted adds
    of hop-sized slices, as the reference does.
    """
    *lead, n_chunks, chunk_len = chunks.shape
    r = -(-chunk_len // hop)
    if r * hop != chunk_len:
        chunks = F.pad(chunks, (0, r * hop - chunk_len))
    x = chunks.reshape(*lead, n_chunks, r, hop)
    acc = chunks.new_zeros((*lead, n_chunks + r - 1, hop))
    for j in range(r):
        acc[..., j:j + n_chunks, :] += x[..., :, j, :]
    out = acc.reshape(*lead, (n_chunks + r - 1) * hop)
    return out[..., : (n_chunks - 1) * hop + chunk_len]


def ola_window(chunk_len: int, hop: int, dtype=torch.float32,
               device: torch.device | str | None = None) -> torch.Tensor:
    """Crossfade window: raised-cosine ramps of length ``chunk_len - hop``
    and a flat middle, so copies at stride ``hop`` sum to 1 in the interior.
    All ones when ``hop == chunk_len``."""
    overlap = chunk_len - hop
    if overlap <= 0:
        return torch.ones(chunk_len, dtype=dtype, device=device)
    n = torch.arange(overlap, dtype=dtype, device=device)
    ramp = 0.5 - 0.5 * torch.cos(torch.pi * (n + 0.5) / overlap)
    mid = torch.ones(chunk_len - 2 * overlap, dtype=dtype, device=device)
    return torch.cat([ramp, mid, ramp.flip(0)])


def ola_normalizer(window: torch.Tensor, n_chunks: int, hop: int) -> torch.Tensor:
    """Sum of ``n_chunks`` windows at stride ``hop``, clipped at 1e-8: divide
    an OLA output by it for unity gain."""
    tiled = window.expand(n_chunks, window.shape[0])
    return torch.clamp(overlap_add(tiled, hop), min=1e-8)
