"""Griffin-Lim mel inversion (counterpart of ``ops/griffin_lim.py``).

The model-free vocoder: the mel pseudo-inverse gives a linear magnitude,
and the momentum-accelerated Griffin-Lim iteration (Perraudin et al. 2013,
the librosa formulation) recovers a phase for it. ``griffin_lim_refine``
warm-starts the same iteration from a vocoded waveform's phase.

Every iteration feeds on the last, so rounding compounds: the reference pins
``precision="highest"`` on its GEMMs. Here the pseudo-inverse product runs
in float64 and the synthesis is ``torch.fft.irfft``, the same irDFT as the
reference's GEMM against ``irdft_matrices``. Neither reads the process's
TF32 switches (``torch.backends.cuda.matmul.allow_tf32``, cuDNN's), so the
result is the same whatever they say and from whichever thread calls it.
The iterations are a Python loop where the reference has ``lax.scan``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from music_synthesis_tpu_torch._device import refuse_capture
from music_synthesis_tpu_torch.config import FrontendConfig
from music_synthesis_tpu_torch.ops.frontend import hann_window, mel_matrix, stft
from music_synthesis_tpu_torch.ops.overlap_add import ola_normalizer, overlap_add

__all__ = ["mel_pinv_matrix", "log_mel_to_magnitude", "griffin_lim",
           "griffin_lim_refine", "refine_with_log_mel", "invert_log_mel"]


@functools.lru_cache(maxsize=4)
def _pinv_cached(sample_rate, n_fft, n_mels, fmin, fmax) -> np.ndarray:
    m = mel_matrix(sample_rate, n_fft, n_mels, fmin, fmax)  # [F, n_mels]
    return np.linalg.pinv(m).astype(np.float32)  # [n_mels, F]


def mel_pinv_matrix(cfg: FrontendConfig) -> np.ndarray:
    """Moore-Penrose inverse of the mel filterbank, ``[n_mels, F]``."""
    return _pinv_cached(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                        cfg.fmin, cfg.fmax_resolved)


@functools.lru_cache(maxsize=8)
def _pinv_tensor(cfg: FrontendConfig, device: torch.device) -> torch.Tensor:
    # float64 on the device, made once (a copy from the host inside a
    # captured CUDA graph is not allowed); a normal tensor, as istft's.
    refuse_capture("_pinv_tensor")
    with torch.inference_mode(False):
        return torch.from_numpy(mel_pinv_matrix(cfg)).to(device).double()


def log_mel_to_magnitude(logmel: torch.Tensor,
                         cfg: FrontendConfig) -> torch.Tensor:
    """Invert the front-end's compression: ``[.., T, n_mels] -> [.., T, F]``
    linear magnitude (undoing ``log_mel``'s eps and power)."""
    mel_lin = torch.clamp(torch.exp(logmel.float()) - cfg.log_epsilon, min=0.0)
    pinv = _pinv_tensor(cfg, logmel.device)
    spec = torch.clamp((mel_lin.double() @ pinv).float(), min=0.0)
    if cfg.power == 2.0:
        return torch.sqrt(spec)
    if cfg.power == 1.0:
        return spec
    return torch.pow(spec, 1.0 / cfg.power)


def griffin_lim(mag: torch.Tensor, n_fft: int, hop: int, n_iter: int = 48,
                momentum: float = 0.99) -> torch.Tensor:
    """Phase recovery: magnitude frames ``[B, T, F] -> waveform [B, T*hop]``,
    from zero phase."""
    mag = mag.float()
    angles0 = torch.ones(mag.shape, dtype=torch.complex64, device=mag.device)
    rebuilt0 = torch.zeros_like(angles0)
    return _gl_iterations(mag, angles0, rebuilt0, n_fft, hop, n_iter, momentum)


def _synth(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """``istft_synthesis`` of complex frames ``[B, T, F]`` -> ``[B, T*hop]``:
    irDFT, Hann-windowed COLA overlap-add, ``(n_fft - hop)//2`` trimmed on
    each side."""
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    window = hann_window(n_fft, frames.dtype, frames.device)
    wav = overlap_add(frames * window, hop)
    n_frames = frames.shape[-2]
    wav = wav / ola_normalizer(window, n_frames, hop)
    trim = (n_fft - hop) // 2
    return wav[..., trim: trim + n_frames * hop]


def _analyze(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    trim = (n_fft - hop) // 2
    return stft(F.pad(wav, (trim, trim)), n_fft=n_fft, hop_length=hop)


def _gl_iterations(mag: torch.Tensor, angles: torch.Tensor,
                   rebuilt_prev: torch.Tensor, n_fft: int, hop: int,
                   n_iter: int, momentum: float) -> torch.Tensor:
    for _ in range(n_iter):
        wav = _synth(mag * angles, n_fft, hop)
        rebuilt = _analyze(wav, n_fft, hop)
        angles = rebuilt - (momentum / (1.0 + momentum)) * rebuilt_prev
        angles = angles / (torch.abs(angles) + 1e-16)
        rebuilt_prev = rebuilt
    return _synth(mag * angles, n_fft, hop)


def griffin_lim_refine(mag: torch.Tensor, wav0: torch.Tensor, n_fft: int,
                       hop: int, n_iter: int = 8,
                       momentum: float = 0.99) -> torch.Tensor:
    """Warm-started Griffin-Lim: ``wav0``'s phase projected onto the target
    magnitude ``mag`` (``[B, T, F]``) for ``n_iter`` iterations. ``n_iter=0``
    is one magnitude-replacement synthesis that keeps ``wav0``'s phase."""
    mag = mag.float()
    rebuilt0 = _analyze(wav0.float(), n_fft, hop)
    angles0 = rebuilt0 / (torch.abs(rebuilt0) + 1e-16)
    return _gl_iterations(mag, angles0, rebuilt0, n_fft, hop, n_iter, momentum)


def refine_with_log_mel(wav: torch.Tensor, logmel: torch.Tensor,
                        cfg: FrontendConfig, n_iter: int = 8) -> torch.Tensor:
    """Refine a vocoded waveform ``[B, T*hop]`` against its own raw log-mel
    conditioning ``[B, T, n_mels]`` (``log_mel_for_vocoder`` alignment)."""
    mag = log_mel_to_magnitude(logmel, cfg)
    return griffin_lim_refine(mag, wav, cfg.n_fft, cfg.hop_length,
                              n_iter=n_iter)


def invert_log_mel(logmel: torch.Tensor, cfg: FrontendConfig,
                   n_iter: int = 48) -> torch.Tensor:
    """The baseline vocoder: vocoder-aligned log-mel ``[B, T, n_mels]`` (one
    frame per hop) -> ``[B, T*hop]``."""
    mag = log_mel_to_magnitude(logmel, cfg)
    return griffin_lim(mag, cfg.n_fft, cfg.hop_length, n_iter=n_iter)
