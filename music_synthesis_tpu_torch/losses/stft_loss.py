"""Multi-resolution STFT distance (counterpart of ``losses/stft_loss.py``).

Spectral convergence plus log-magnitude L1 at several resolutions: the
copy-synthesis metric. The data-parallel ``axis_name`` correction of the
reference comes with the data-parallel slice.
"""

from __future__ import annotations

import torch

from music_synthesis_tpu_torch.config import STFTLossConfig
from music_synthesis_tpu_torch.ops.frontend import magnitude_stft

__all__ = ["stft_distance", "multires_stft_loss"]


def stft_distance(x: torch.Tensor, y: torch.Tensor, n_fft: int,
                  hop_length: int, win_length: int,
                  eps: float = 1e-7) -> tuple[torch.Tensor, torch.Tensor]:
    """(spectral convergence, log-magnitude L1) at one resolution; ``y`` is
    the reference: ``sc = ||S_y - S_x||_F / ||S_y||_F``,
    ``mag = mean |log S_x - log S_y|``."""
    sx = magnitude_stft(x, n_fft, hop_length, win_length, eps)
    sy = magnitude_stft(y, n_fft, hop_length, win_length, eps)
    diff2 = torch.sum(torch.square(sy - sx))
    ref2 = torch.sum(torch.square(sy))
    mag = torch.mean(torch.abs(torch.log(sx) - torch.log(sy)))
    sc = torch.sqrt(diff2) / torch.clamp(torch.sqrt(ref2), min=eps)
    return sc, mag


def multires_stft_loss(x: torch.Tensor, y: torch.Tensor,
                       cfg: STFTLossConfig = STFTLossConfig()) -> torch.Tensor:
    """Mean over resolutions of (sc + mag); x generated, y reference."""
    total = 0.0
    for n_fft, hop, win in cfg.resolutions:
        sc, mag = stft_distance(x, y, n_fft, hop, win, cfg.eps)
        total = total + sc + mag
    return total / len(cfg.resolutions)
