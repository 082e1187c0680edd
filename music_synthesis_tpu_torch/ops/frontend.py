"""Audio feature front-end in PyTorch: the oracle the log-mel kernel is held to.

Counterpart of ``music_synthesis_tpu/ops/frontend.py``: framing -> periodic
Hann window -> real STFT -> Slaney mel filterbank -> log. Layouts follow the
JAX package: waveforms ``[..., L]``, spectrograms ``[..., T, bins]``.
``mel_matrix`` and ``dft_matrices`` are numpy copies of the reference's, so
the kernel's constants are bit-identical to the TPU kernel's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from music_synthesis_tpu_torch._device import refuse_capture
from music_synthesis_tpu_torch.config import FrontendConfig

__all__ = [
    "hann_window",
    "frame",
    "stft",
    "magnitude_stft",
    "mel_matrix",
    "log_mel",
    "log_mel_for_vocoder",
    "dft_matrices",
]


def hann_window(win_length: int, dtype=torch.float32,
                device: torch.device | str | None = None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window / scipy periodic)."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / win_length)


def frame(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """``x[..., L]`` -> overlapping frames ``[..., T, frame_length]``.

    T = 1 + (L - frame_length) // hop_length; no padding. A strided view
    (``unfold``), so nothing is copied until the frames are used.
    """
    length = x.shape[-1]
    if length < frame_length:
        raise ValueError(
            f"signal length {length} shorter than frame_length {frame_length}")
    return x.unfold(-1, frame_length, hop_length)


def stft(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
         win_length: int | None = None) -> torch.Tensor:
    """Hann-windowed real STFT ``[..., L] -> [..., T, n_fft//2+1]`` complex.

    No centering; pad before calling if needed.
    """
    win_length = win_length or n_fft
    window = hann_window(win_length, x.dtype, x.device)
    frames = frame(x, win_length, hop_length) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def magnitude_stft(x: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: int | None = None,
                   eps: float = 1e-7) -> torch.Tensor:
    """|STFT| with the smooth floor ``sqrt(re^2 + im^2 + eps)``.

    The smooth floor (not ``sqrt(max(p, eps))``) keeps a gradient where the
    spectral power is below eps, as the reference does.
    """
    s = stft(x, n_fft=n_fft, hop_length=hop_length, win_length=win_length)
    return torch.sqrt(s.real ** 2 + s.imag ** 2 + eps)


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
        mel,
    )


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


@functools.lru_cache(maxsize=16)
def mel_matrix(sample_rate: int = 22_050, n_fft: int = 1024, n_mels: int = 128,
               fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank ``[n_fft//2+1, n_mels]``
    (librosa ``filters.mel(htk=False, norm='slaney')`` transposed)."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    weights = np.zeros((n_mels, n_freqs), dtype=np.float64)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_matrices(n_fft: int = 1024):
    """Windowed real-DFT bases ``(C, S)``, each ``[n_fft, n_fft//2+1]``
    float32, built in float64: ``frames @ C`` and ``frames @ S`` are the
    real and imaginary parts of the Hann-windowed rFFT. The reference's
    lane padding of the bins is not kept."""
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)
    return ((np.cos(ang) * w[:, None]).astype(np.float32),
            (-np.sin(ang) * w[:, None]).astype(np.float32))


def _power_to_log_mel(power: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    if cfg.power == 2.0:
        spec = power
    elif cfg.power == 1.0:
        spec = torch.sqrt(torch.clamp(power, min=0.0))
    else:
        spec = torch.pow(torch.clamp(power, min=0.0), cfg.power / 2.0)
    return torch.log(cfg.log_epsilon + spec @ _mel_tensor(cfg, power.device))


@functools.lru_cache(maxsize=16)
def _mel_tensor(cfg: FrontendConfig, device: torch.device) -> torch.Tensor:
    """``mel_matrix`` of ``cfg`` on ``device``, made once (a copy from the
    host inside a captured CUDA graph is not allowed); a normal tensor even
    when first asked for under inference mode, as istft's bases."""
    refuse_capture("_mel_tensor")
    with torch.inference_mode(False):
        return torch.from_numpy(mel_matrix(
            cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
            cfg.fmax_resolved)).to(device)


def log_mel(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Full front-end ``[..., L] -> [..., T, n_mels]`` via ``torch.fft``.

    cfg.center reflect-pads n_fft//2 each side (T = L//hop + 1); otherwise
    no padding (T = 1 + (L - n_fft)//hop).
    """
    if cfg.center:
        x = _pad_last(x, cfg.n_fft // 2, cfg.pad_mode)
    s = stft(x, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
             win_length=cfg.win_length)
    return _power_to_log_mel(s.real ** 2 + s.imag ** 2, cfg)


def log_mel_for_vocoder(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Vocoder conditioning: reflect pad ``(n_fft - hop)//2`` each side, frame
    without centering, keep ``T = L // hop`` frames (one per hop of audio)."""
    n_frames = x.shape[-1] // cfg.hop_length
    padded = _pad_last(x, (cfg.n_fft - cfg.hop_length) // 2, cfg.pad_mode)
    s = stft(padded, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
             win_length=cfg.win_length)
    return _power_to_log_mel(s.real ** 2 + s.imag ** 2, cfg)[..., :n_frames, :]


# numpy/jnp pad mode names -> torch's.
_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "wrap": "circular"}


def _pad_last(x: torch.Tensor, amount: int, mode: str) -> torch.Tensor:
    """Pad both ends of the last axis (any leading shape)."""
    if amount == 0:
        return x
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])
    out = F.pad(flat, (amount, amount), mode=_PAD_MODES[mode])
    return out.reshape(*lead, out.shape[-1])
