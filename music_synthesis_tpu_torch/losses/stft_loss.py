"""Multi-resolution STFT distance (counterpart of ``losses/stft_loss.py``).

Spectral convergence plus log-magnitude L1 at several resolutions: the
copy-synthesis metric, and a stage-2 training loss.

``group``: under data parallelism, the process group holding the batch's
shards. ``sc`` is a ratio of Frobenius norms, so a per-shard ``sc`` would
not average to the global-batch value: the squared norms are summed over
the ranks (``parallel.mesh.AllReduce``, whose backward gives each rank the
single-process gradient once the step has averaged the gradients), so
every rank computes the global ``sc``. ``mag`` stays the shard's mean: the
step's means of the gradients and of the metrics make it the global one
(equal shards).
"""

from __future__ import annotations

import torch

from music_synthesis_tpu_torch.config import STFTLossConfig
from music_synthesis_tpu_torch.ops.frontend import magnitude_stft
from music_synthesis_tpu_torch.parallel.mesh import AllReduce

__all__ = ["stft_distance", "multires_stft_loss"]


def _norms(x, y, n_fft, hop_length, win_length, eps):
    """``(||S_y - S_x||^2, ||S_y||^2, mag)`` at one resolution."""
    sx = magnitude_stft(x, n_fft, hop_length, win_length, eps)
    sy = magnitude_stft(y, n_fft, hop_length, win_length, eps)
    mag = torch.mean(torch.abs(torch.log(sx) - torch.log(sy)))
    return (torch.sum(torch.square(sy - sx)), torch.sum(torch.square(sy)),
            mag)


def _sc(diff2, ref2, eps):
    return torch.sqrt(diff2) / torch.clamp(torch.sqrt(ref2), min=eps)


def stft_distance(x: torch.Tensor, y: torch.Tensor, n_fft: int,
                  hop_length: int, win_length: int, eps: float = 1e-7,
                  group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(spectral convergence, log-magnitude L1) at one resolution; ``y`` is
    the reference: ``sc = ||S_y - S_x||_F / ||S_y||_F``,
    ``mag = mean |log S_x - log S_y|``."""
    diff2, ref2, mag = _norms(x, y, n_fft, hop_length, win_length, eps)
    if group is not None:
        diff2, ref2 = AllReduce.apply(torch.stack([diff2, ref2]), group, 1.0)
    return _sc(diff2, ref2, eps), mag


def multires_stft_loss(x: torch.Tensor, y: torch.Tensor,
                       cfg: STFTLossConfig = STFTLossConfig(),
                       group=None) -> torch.Tensor:
    """Mean over resolutions of (sc + mag); x generated, y reference. Under
    ``group`` the norms of every resolution are summed over the ranks in
    one collective."""
    parts = [_norms(x, y, n_fft, hop, win, cfg.eps)
             for n_fft, hop, win in cfg.resolutions]
    norms = torch.stack([torch.stack(p[:2]) for p in parts])
    if group is not None:
        norms = AllReduce.apply(norms, group, 1.0)
    total = 0.0
    for (diff2, ref2), (_, _, mag) in zip(norms, parts):
        total = total + _sc(diff2, ref2, cfg.eps) + mag
    return total / len(cfg.resolutions)
