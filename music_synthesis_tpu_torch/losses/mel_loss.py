"""DAC's multi-scale mel loss (upstream's ``dac/nn/loss.py``
``MelSpectrogramLoss`` over audiotools' ``mel_spectrogram``), which the JAX
package has not.

For each window ``w`` of ``WINDOWS`` with ``n`` mels of ``N_MELS``
(upstream's seven scales): a centred STFT (reflect padding by
``w // 2``, periodic Hann window of ``w`` samples, hop ``w // 4``), its
magnitude ``|S|``, the Slaney mel filterbank of ``n`` bands from 0 Hz to
Nyquist (``ops.frontend.mel_matrix``, librosa's), ``log10(max(mel,
1e-5))``, and the L1 distance of ``x``'s and ``y``'s, a mean over every
element; the loss is the sum over the scales. It computes in fp32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from music_synthesis_tpu_torch._device import refuse_capture
from music_synthesis_tpu_torch.ops.frontend import mel_matrix, stft

__all__ = ["log_mel_scale", "multiscale_mel_loss"]

CLAMP_EPS = 1e-5  # upstream's clamp_eps
WINDOWS = (32, 64, 128, 256, 512, 1024, 2048)
N_MELS = (5, 10, 20, 40, 80, 160, 320)


@functools.lru_cache(maxsize=32)
def _filters(sample_rate: int, window: int, n_mels: int,
             device: torch.device) -> torch.Tensor:
    """``mel_matrix`` ``[window // 2 + 1, n_mels]`` on ``device``, made once
    (a copy from the host inside a captured CUDA graph is not allowed)."""
    refuse_capture("the mel loss's filterbank")
    with torch.inference_mode(False):
        return torch.from_numpy(mel_matrix(sample_rate, window, n_mels, 0.0,
                                           None)).to(device)


def log_mel_scale(wav: torch.Tensor, sample_rate: int, window: int,
                  n_mels: int) -> torch.Tensor:
    """``log10(max(|S| @ mel, 1e-5))`` of ``wav [B, L]`` at one scale:
    ``[B, L // (window // 4) + 1, n_mels]``."""
    x = F.pad(wav.float()[:, None], (window // 2, window // 2),
              mode="reflect")[:, 0]
    mag = stft(x, window, window // 4, window).abs()
    mel = mag @ _filters(sample_rate, window, n_mels, wav.device)
    return torch.log10(torch.clamp(mel, min=CLAMP_EPS))


def multiscale_mel_loss(x: torch.Tensor, y: torch.Tensor,
                        sample_rate: int) -> torch.Tensor:
    """Sum over the scales of the mean L1 distance of ``x``'s and ``y``'s
    log-mels (the module's docstring); ``[B, L]`` with ``L`` over 1024,
    the widest window's reflect padding."""
    loss = 0.0
    for w, n in zip(WINDOWS, N_MELS):
        loss = loss + torch.mean(torch.abs(
            log_mel_scale(x, sample_rate, w, n)
            - log_mel_scale(y, sample_rate, w, n)))
    return loss
