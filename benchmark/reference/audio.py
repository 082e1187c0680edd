"""The plain reference of the conditioning log-mel and of the STFT loss.

Written from the front-end's definition (``ops/frontend.py`` of the port at
commit 29bca4e: periodic Hann window, real STFT, Slaney mel filterbank,
log), with ``torch.fft`` in fp32 where the port's kernel runs rDFT GEMMs
in 3xTF32. The filterbank is rebuilt here in float64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference.model import magnitude_stft, stft

__all__ = ["mel_matrix", "log_mel_for_vocoder", "multires_stft_loss"]


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_hz, min_hz / f_sp
                    + np.log(np.maximum(f, min_hz) / min_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    min_mel, logstep = min_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_mel, min_hz * np.exp(logstep * (m - min_mel)),
                    m * f_sp)


def mel_matrix(sr: int, n_fft: int, n_mels: int, fmin: float,
               fmax: float | None) -> np.ndarray:
    """Slaney-normalised triangular filterbank ``[n_fft//2+1, n_mels]``."""
    fmax = sr / 2.0 if fmax is None else fmax
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                   ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2:] - hz[:-2]))[:, None]
    return w.T.astype(np.float32)


def log_mel_for_vocoder(wav: torch.Tensor, fe) -> torch.Tensor:
    """``[B, L] -> [B, L // hop, n_mels]``: reflect-pad ``(n_fft - hop)//2``
    per side, frame without centring, one frame per hop of audio."""
    pad = (fe.n_fft - fe.hop_length) // 2
    x = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    s = stft(x, fe.n_fft, fe.hop_length, fe.win_length)
    if fe.power != 2.0:
        raise ValueError("the reference's log-mel is of the power spectrum")
    power = s.real ** 2 + s.imag ** 2
    mel = torch.from_numpy(mel_matrix(fe.sample_rate, fe.n_fft, fe.n_mels,
                                      fe.fmin, fe.fmax)).to(wav.device)
    return torch.log(fe.log_epsilon + power @ mel)[:, : wav.shape[-1]
                                                  // fe.hop_length]


def multires_stft_loss(x: torch.Tensor, y: torch.Tensor, cfg) -> torch.Tensor:
    """Mean over resolutions of spectral convergence plus log-magnitude L1;
    ``y`` is the target."""
    total = 0.0
    for n_fft, hop, win in cfg.resolutions:
        sx = magnitude_stft(x, n_fft, hop, win, cfg.eps)
        sy = magnitude_stft(y, n_fft, hop, win, cfg.eps)
        sc = (torch.sqrt(torch.sum(torch.square(sy - sx)))
              / torch.clamp(torch.sqrt(torch.sum(torch.square(sy))),
                            min=cfg.eps))
        total = total + sc + torch.mean(torch.abs(torch.log(sx)
                                                  - torch.log(sy)))
    return total / len(cfg.resolutions)
