"""Fused log-mel front-end: the CUDA kernel's wrapper and its plain version.

Counterpart of ``music_synthesis_tpu/ops/pallas_frontend.py``:
``fused_log_mel`` / ``fused_log_mel_for_vocoder`` stand for
``pallas_log_mel`` / ``pallas_log_mel_for_vocoder``. For a tensor on the
card they launch ``csrc/logmel.cu`` (one launch per call) or raise; for a
tensor on the CPU they compute the same function with ``log_mel_plain`` /
``log_mel_for_vocoder_plain``: frames by ``unfold``, ``frames @ C``,
``frames @ S``, power, ``@ mel``, log, with the same fp32 constants the
kernel reads. There is no fallback from the card to the plain version.

The plain version's GEMMs run in full fp32 on the card as long as
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default, which
the port never changes).

Both precision modes (``"exact"``, ``"fast"``) run the kernel's fp32 FFMA
path in this version; the mode is validated and kept for the callers.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from music_synthesis_tpu_torch import _build
from music_synthesis_tpu_torch.config import FrontendConfig
from music_synthesis_tpu_torch.ops.frontend import (
    _pad_last,
    dft_matrices,
    mel_matrix,
)

__all__ = [
    "MAX_MELS",
    "LogMelKernel",
    "logmel_kernel",
    "logmel_constants",
    "fused_log_mel",
    "fused_log_mel_for_vocoder",
    "log_mel_frames_plain",
    "log_mel_plain",
    "log_mel_for_vocoder_plain",
    "padded_input",
]

MAX_MELS = 128  # the kernel keeps n_mels <= 128 accumulators per frame
PRECISIONS = ("exact", "fast")


@functools.lru_cache(maxsize=16)
def logmel_constants(n_fft: int, sample_rate: int, n_mels: int, fmin: float,
                     fmax: float, device: torch.device):
    """``(C, S, M, n_used)`` on ``device``: the Hann-windowed DFT bases
    ``[n_fft, n_fft//2+1]`` and the mel matrix ``[n_fft//2+1, n_mels]``,
    built in float64 and stored as float32 exactly as the reference's
    ``dft_matrices`` / ``mel_matrix``; ``n_used`` is one past the last bin
    with a non-zero mel weight (the kernel skips the bins after it)."""
    c, s = dft_matrices(n_fft)
    m = mel_matrix(sample_rate, n_fft, n_mels, fmin, fmax)
    nonzero = np.flatnonzero(np.any(m != 0.0, axis=1))
    n_used = int(nonzero[-1]) + 1 if nonzero.size else 1
    return (torch.from_numpy(c).to(device), torch.from_numpy(s).to(device),
            torch.from_numpy(np.ascontiguousarray(m)).to(device), n_used)


def _constants(cfg: FrontendConfig, device: torch.device):
    return logmel_constants(cfg.n_fft, cfg.sample_rate, cfg.n_mels, cfg.fmin,
                            cfg.fmax_resolved, device)


def _check(wav: torch.Tensor, cfg: FrontendConfig, precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    if cfg.power not in (1.0, 2.0):
        raise ValueError("the fused log-mel supports power 1.0 or 2.0")
    if cfg.win_length != cfg.n_fft:
        raise ValueError("the fused log-mel assumes win_length == n_fft")
    if not 1 <= cfg.n_mels <= MAX_MELS:
        raise ValueError(f"the fused log-mel supports 1..{MAX_MELS} mels")
    if wav.ndim != 2:
        raise ValueError(f"wav must be [B, L], got shape {tuple(wav.shape)}")
    if wav.dtype != torch.float32:
        raise TypeError(f"wav must be float32, got {wav.dtype}")
    if not wav.is_contiguous():
        raise ValueError("wav must be contiguous")
    if wav.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {wav.device}")


class LogMelKernel:
    """ctypes binding of ``csrc/logmel.cu`` with a count of its launches.

    ``n_launches`` goes up by one each time the kernel is launched, and
    nowhere else.
    """

    def __init__(self):
        self.n_launches = 0
        self._forward = None  # the C functions, bound at first launch
        self._workspace_words = None

    def _fn(self):
        if self._forward is None:
            lib = _build.load("logmel")
            i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
            words = lib.logmel_workspace_words
            words.argtypes = [i32, i32, i32, i32]
            words.restype = i64
            fn = lib.logmel_forward
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i64, i32, i32,
                           i32, i32, i32, i32, i32, ctypes.c_float, ptr]
            fn.restype = i32
            self._workspace_words, self._forward = words, fn
        return self._forward

    def __call__(self, padded: torch.Tensor, cfg: FrontendConfig,
                 n_frames: int) -> torch.Tensor:
        """Frames ``0..n_frames-1`` of each row of ``padded`` [B, L] (CUDA,
        fp32, contiguous) -> log-mel ``[B, n_frames, n_mels]``."""
        if not padded.is_cuda:
            raise ValueError("the log-mel kernel needs a CUDA tensor")
        c, s, m, n_used = _constants(cfg, padded.device)
        b, length = padded.shape
        forward = self._fn()
        out = torch.empty((b, n_frames, cfg.n_mels), dtype=torch.float32,
                          device=padded.device)
        workspace = torch.empty(
            self._workspace_words(b, n_frames, n_used, cfg.n_mels),
            dtype=torch.float32, device=padded.device)
        with torch.cuda.device(padded.device):
            stream = torch.cuda.current_stream(padded.device).cuda_stream
            rc = forward(
                padded.data_ptr(), c.data_ptr(), s.data_ptr(), m.data_ptr(),
                out.data_ptr(), workspace.data_ptr(), b, length, n_frames,
                cfg.hop_length, cfg.n_fft, c.shape[1], n_used, cfg.n_mels,
                int(cfg.power == 1.0), cfg.log_epsilon, stream)
        if rc != 0:
            raise RuntimeError(f"logmel kernel launch failed: CUDA error {rc}")
        self.n_launches += 1
        return out


#: The process-wide binding; ``logmel_kernel.n_launches`` is its count.
logmel_kernel = LogMelKernel()


def log_mel_frames_plain(padded: torch.Tensor, cfg: FrontendConfig,
                         n_frames: int) -> torch.Tensor:
    """The plain version of ``logmel_kernel``: frames ``0..n_frames-1`` of
    an already padded ``[B, L]``, on any device."""
    c, s, m, _ = _constants(cfg, padded.device)
    frames = padded.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :n_frames]
    power = (frames @ c) ** 2 + (frames @ s) ** 2
    if cfg.power == 1.0:
        power = torch.sqrt(power)
    return torch.log(cfg.log_epsilon + power @ m)


def padded_input(wav: torch.Tensor, cfg: FrontendConfig, for_vocoder: bool,
                 precision: str = "exact") -> tuple[torch.Tensor, int]:
    """Checks ``wav`` and returns ``(padded, n_frames)``, what the kernel and
    ``log_mel_frames_plain`` take: the vocoder variant reflect-pads
    ``(n_fft - hop)//2`` per side and keeps ``L // hop`` frames; the plain
    variant reflect-pads ``n_fft//2`` per side when cfg.center and keeps
    every whole frame."""
    _check(wav, cfg, precision)
    length = wav.shape[-1]
    if for_vocoder:
        pad = (cfg.n_fft - cfg.hop_length) // 2
    else:
        pad = cfg.n_fft // 2 if cfg.center else 0
    padded_len = length + 2 * pad
    if for_vocoder:
        keep = length // cfg.hop_length
    else:
        keep = 1 + (padded_len - cfg.n_fft) // cfg.hop_length
    # Reflection needs pad < length; every kept frame must fit.
    if length <= pad or padded_len < cfg.n_fft or keep < 1:
        raise ValueError(f"signal of {length} samples is too short for "
                         f"n_fft {cfg.n_fft}, hop {cfg.hop_length}")
    padded = _pad_last(wav, pad, cfg.pad_mode).contiguous() if pad else wav
    return padded, keep


def fused_log_mel(wav: torch.Tensor, cfg: FrontendConfig,
                  precision: str = "fast") -> torch.Tensor:
    """``[B, L] -> [B, T, n_mels]``, the function of ``ops.frontend.log_mel``:
    the kernel for a CUDA tensor, the plain version for a CPU one."""
    padded, n_frames = padded_input(wav, cfg, False, precision)
    if padded.is_cuda:
        return logmel_kernel(padded, cfg, n_frames)
    return log_mel_frames_plain(padded, cfg, n_frames)


def fused_log_mel_for_vocoder(wav: torch.Tensor, cfg: FrontendConfig,
                              precision: str = "fast") -> torch.Tensor:
    """Vocoder conditioning ``[B, L] -> [B, L // hop, n_mels]``, one frame
    per hop of audio: the kernel for a CUDA tensor, the plain version for a
    CPU one."""
    padded, n_frames = padded_input(wav, cfg, True, precision)
    if padded.is_cuda:
        return logmel_kernel(padded, cfg, n_frames)
    return log_mel_frames_plain(padded, cfg, n_frames)


def log_mel_plain(wav: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """The plain PyTorch version of ``fused_log_mel``, on any device."""
    padded, n_frames = padded_input(wav, cfg, False)
    return log_mel_frames_plain(padded, cfg, n_frames)


def log_mel_for_vocoder_plain(wav: torch.Tensor,
                              cfg: FrontendConfig) -> torch.Tensor:
    """The plain PyTorch version of ``fused_log_mel_for_vocoder``."""
    padded, n_frames = padded_input(wav, cfg, True)
    return log_mel_frames_plain(padded, cfg, n_frames)
