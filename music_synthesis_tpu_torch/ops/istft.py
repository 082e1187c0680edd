"""Inverse STFT synthesis as a GEMM (counterpart of ``ops/istft.py``)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from music_synthesis_tpu_torch._device import refuse_capture
from music_synthesis_tpu_torch.ops.frontend import hann_window
from music_synthesis_tpu_torch.ops.overlap_add import ola_normalizer, overlap_add

__all__ = ["irdft_matrices", "istft_synthesis"]


@functools.lru_cache(maxsize=8)
def irdft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse real-DFT bases ``[n_fft//2+1, n_fft]``:
    ``frames = re @ IC + im @ IS`` equals ``np.fft.irfft``."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    n = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(k, n) / n_fft
    w = np.full(n_fft // 2 + 1, 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    ic = (w[:, None] * np.cos(ang) / n_fft).astype(np.float32)
    is_ = (-w[:, None] * np.sin(ang) / n_fft).astype(np.float32)
    return ic, is_


@functools.lru_cache(maxsize=16)
def _irdft_tensors(n_fft: int, device: torch.device):
    # Normal tensors even when first asked for under inference_mode (as
    # copy-synthesis and serving run), so that a training step in the same
    # process can save them for its backward.
    refuse_capture("_irdft_tensors")
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(m).to(device)
                     for m in irdft_matrices(n_fft))


def _irdft_bases(n_fft: int, x: torch.Tensor):
    """The bases on ``x``'s device. While ``torch.export``, ``torch.compile``
    or a fake or functional mode traces (``x`` is then a tensor subclass),
    they are made anew, so the cache never holds a traced tensor: one would
    turn every later eager call on that device into a fake one."""
    if torch.compiler.is_compiling() or type(x) is not torch.Tensor:
        return tuple(torch.from_numpy(m).to(x.device)
                     for m in irdft_matrices(n_fft))
    return _irdft_tensors(n_fft, x.device)


def istft_synthesis(re: torch.Tensor, im: torch.Tensor, n_fft: int,
                    hop: int) -> torch.Tensor:
    """``[B, T, n_fft//2+1]`` x2 -> ``[B, T*hop]``.

    irDFT as one fp32 GEMM per part, Hann-windowed COLA overlap-add, and
    the ``(n_fft - hop)//2`` edge samples trimmed on each side. On the card
    the GEMMs run in full fp32: PyTorch's default leaves
    ``torch.backends.cuda.matmul.allow_tf32`` False, and nothing in the port
    turns it on.
    """
    ic, is_ = _irdft_bases(n_fft, re)
    frames = re.float() @ ic + im.float() @ is_
    window = hann_window(n_fft, frames.dtype, re.device)
    wav = overlap_add(frames * window, hop)
    n_frames = frames.shape[-2]
    wav = wav / ola_normalizer(window, n_frames, hop)
    trim = (n_fft - hop) // 2
    return wav[..., trim: trim + n_frames * hop]
