"""Mel-cepstral distortion (counterpart of ``ops/cepstrum.py``).

Cepstra are the orthonormal DCT-II of the natural-log, vocoder-aligned
log-mel (coefficients 1..n_coeffs, c0 dropped), with an 80 dB floor under
each clip's loudest bin; MCD is the mean frame-paired Euclidean distance
scaled by ``10 * sqrt(2) / ln 10`` dB, over interior frames (the reflect
padding's seam frames are left out). Like the STFT distance it sees only
``|STFT|``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from music_synthesis_tpu_torch.config import FrontendConfig
from music_synthesis_tpu_torch.ops.frontend import log_mel_for_vocoder

__all__ = ["mel_cepstra", "mcd"]


@functools.lru_cache(maxsize=8)
def _dct2_matrix(n_mels: int, n_coeffs: int) -> np.ndarray:
    """Orthonormal DCT-II basis ``[n_mels, n_coeffs + 1]`` (c0 kept)."""
    m = np.arange(n_mels)[:, None]
    k = np.arange(n_coeffs + 1)[None, :]
    basis = np.cos(np.pi * (m + 0.5) * k / n_mels)
    basis *= np.sqrt(2.0 / n_mels)
    basis[:, 0] *= np.sqrt(0.5)
    return basis.astype(np.float32)


def mel_cepstra(x: torch.Tensor, cfg: FrontendConfig,
                n_coeffs: int = 13) -> torch.Tensor:
    """``[..., L]`` waveform -> ``[..., T, n_coeffs]`` mel cepstra c1..cK."""
    lm = log_mel_for_vocoder(x.float(), cfg)
    floor = torch.amax(lm, dim=(-2, -1), keepdim=True) - 8.0 * np.log(10.0)
    lm = torch.maximum(lm, floor)
    basis = torch.from_numpy(_dct2_matrix(cfg.n_mels, n_coeffs)).to(lm.device)
    return (lm @ basis)[..., 1:]


def mcd(a: torch.Tensor, b: torch.Tensor, cfg: FrontendConfig,
        n_coeffs: int = 13) -> torch.Tensor:
    """Mean mel-cepstral distortion in dB between equal-length waveforms."""
    ca = mel_cepstra(a, cfg, n_coeffs)
    cb = mel_cepstra(b, cfg, n_coeffs)
    per_frame = torch.sqrt(torch.sum((ca - cb) ** 2, dim=-1) + 1e-12)
    seam = -(-((cfg.n_fft - cfg.hop_length) // 2) // cfg.hop_length)
    if per_frame.shape[-1] > 2 * seam + 1:
        per_frame = per_frame[..., seam:-seam]
    return (10.0 * np.sqrt(2.0) / np.log(10.0)) * torch.mean(per_frame)
