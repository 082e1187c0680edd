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

The kernel replaces the TPU kernel ``pallas_frontend.py::_kernel``. Its
work is the rDFT GEMM (~94% of the operations), so it is bound by
arithmetic, and the two precision modes take two paths through it:

- ``"fast"`` (the default, and what copy-synthesis runs) computes the rDFT
  on the tensor cores in 3xTF32: each operand is split into TF32 hi and lo
  parts and ``hi*hi + hi*lo + lo*hi`` is accumulated in fp32 by
  ``mma.sync``, which keeps fp32-level accuracy at three tensor-core passes
  (495 TFLOP/s dense for TF32 on an H100, against 67 for fp32 FFMA). The
  bases are packed once per device in the order of the MMA's B fragments
  (``fragment_bases``); the kernel splits both operands in registers.
- ``"exact"`` computes it in fp32 FFMA, in the plain version's summation
  order, so it agrees with the plain version to ~1e-6; the 3xTF32 path,
  rounded elsewhere, lands up to ~7e-4 away in near-silent mel bins (on an
  H100, PERF.md), past the 2e-4 gate that ``"exact"`` is held to.

Both end in the same mel product and log. The reference's ``fast`` is a
bf16x3 split, which keeps fewer mantissa bits than 3xTF32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from music_synthesis_tpu_torch import _build
from music_synthesis_tpu_torch._device import refuse_capture
from music_synthesis_tpu_torch.config import FrontendConfig
from music_synthesis_tpu_torch.ops.frontend import (
    _pad_last,
    dft_matrices,
    mel_matrix,
)

__all__ = [
    "LogMelKernel",
    "logmel_kernel",
    "logmel_constants",
    "fragment_bases",
    "mel_groups",
    "fused_log_mel",
    "fused_log_mel_for_vocoder",
    "log_mel_frames_plain",
    "log_mel_plain",
    "log_mel_for_vocoder_plain",
    "logmel_gemm_flops",
    "padded_input",
]

PRECISIONS = ("exact", "fast")
_TENSOR_CORES = {"exact": 0, "fast": 1}  # the kernel path of each mode
# The "fast" path's tiles (csrc/logmel.cu, tc::kBK and tc::kBN): its packed
# bases are zero-padded to multiples of these samples and bins.
TC_K_STEP = 16
TC_BINS = 64


@functools.lru_cache(maxsize=16)
def _host_constants(n_fft: int, sample_rate: int, n_mels: int, fmin: float,
                    fmax: float):
    c, s = dft_matrices(n_fft)
    m = np.ascontiguousarray(mel_matrix(sample_rate, n_fft, n_mels, fmin,
                                        fmax))
    nonzero = np.flatnonzero(np.any(m != 0.0, axis=1))
    n_used = int(nonzero[-1]) + 1 if nonzero.size else 1
    return c, s, m, n_used


@functools.lru_cache(maxsize=16)
def logmel_constants(n_fft: int, sample_rate: int, n_mels: int, fmin: float,
                     fmax: float, device: torch.device):
    """``(C, S, M, n_used)`` on ``device``: the Hann-windowed DFT bases
    ``[n_fft, n_fft//2+1]`` and the mel matrix ``[n_fft//2+1, n_mels]``,
    built in float64 and stored as float32 exactly as the reference's
    ``dft_matrices`` / ``mel_matrix``; ``n_used`` is one past the last bin
    with a non-zero mel weight (the kernel skips the bins after it)."""
    refuse_capture("logmel_constants")
    c, s, m, n_used = _host_constants(n_fft, sample_rate, n_mels, fmin, fmax)
    return (torch.from_numpy(c).to(device), torch.from_numpy(s).to(device),
            torch.from_numpy(m).to(device), n_used)


@functools.lru_cache(maxsize=16)
def fragment_bases(n_fft: int, sample_rate: int, n_mels: int, fmin: float,
                   fmax: float, device: torch.device) -> torch.Tensor:
    """The "fast" path's bases on ``device``: C and S (bins below n_used),
    zero-padded to ``round_up(n_fft, TC_K_STEP)`` samples and
    ``round_up(n_used, TC_BINS)`` bins, in the order of ``mma.m16n8k8``'s B
    fragments: ``[k // 8, bin // 8, lane 4 g + t, 4]`` holds
    ``C[8 kb + t], C[8 kb + t + 4], S[8 kb + t], S[8 kb + t + 4]`` of bin
    ``8 nb + g``, so a thread reads its fragments of a k8 x n8 tile, cos and
    sin, as one 16-byte word. fp32, ~4.2 MB at n_fft 1024 (the kernel
    splits them into TF32 parts in registers)."""
    refuse_capture("fragment_bases")
    c, s, _, n_used = _host_constants(n_fft, sample_rate, n_mels, fmin, fmax)
    kp = -(-n_fft // TC_K_STEP) * TC_K_STEP
    bins = -(-n_used // TC_BINS) * TC_BINS
    parts = []
    for basis in (c, s):
        b = np.zeros((kp, bins), np.float32)
        b[:n_fft, :n_used] = basis[:, :n_used]
        parts.append(b.reshape(kp // 8, 2, 4, bins // 8, 8))
    # k = 8 kb + 4 h + t, bin = 8 nb + g: [cs, kb, h, t, nb, g] ->
    # [kb, nb, g, t, cs, h].
    packed = np.stack(parts).transpose(1, 4, 5, 3, 0, 2)
    return torch.from_numpy(np.ascontiguousarray(
        packed.reshape(kp // 8, bins // 8, 32, 4))).to(device)


@functools.lru_cache(maxsize=16)
def mel_groups(n_fft: int, sample_rate: int, n_mels: int, fmin: float,
               fmax: float, device: torch.device) -> torch.Tensor:
    """``[ceil(n_used / 64), 2]`` int32 on ``device``: for each chunk of 64
    bins, the first and last 32-mel group (mels ``32 g .. 32 g + 31``) with
    a non-zero weight in those bins; ``(2**30, -1)`` where there is none.
    The kernel's mel stage computes only these groups (mel filters are
    narrow: a 1024-point DFT's 64-bin chunks feed 1-2 groups of 128 mels)."""
    refuse_capture("mel_groups")
    _, _, m, n_used = _host_constants(n_fft, sample_rate, n_mels, fmin, fmax)
    out = []
    for b0 in range(0, n_used, TC_BINS):
        nz = np.flatnonzero(np.any(m[b0:min(b0 + TC_BINS, n_used)] != 0.0,
                                   axis=0))
        out.append((int(nz[0]) // 32, int(nz[-1]) // 32) if nz.size
                   else (2 ** 30, -1))
    return torch.tensor(out, dtype=torch.int32).to(device)


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
    if cfg.n_mels < 1:
        raise ValueError("the fused log-mel needs n_mels >= 1")
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
    nowhere else: here for an eager launch, and in
    ``_graphs.GraphedProgram`` for each replay of a CUDA graph that holds
    the kernel (by the launches its capture recorded; the warm-up and the
    capture that build a graph are taken back out of the count). The
    launch is captured whole: the tile counters' ``cudaMemsetAsync`` and
    the kernel on the current stream, the workspace from the graph's pool.
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
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i64,
                           i32, i32, i32, i32, i32, i32, i32, ctypes.c_float,
                           i32, i32, ptr]
            fn.restype = i32
            self._workspace_words, self._forward = words, fn
        return self._forward

    def __call__(self, padded: torch.Tensor, cfg: FrontendConfig,
                 n_frames: int, precision: str = "fast",
                 tile_frames: int = 0) -> torch.Tensor:
        """Frames ``0..n_frames-1`` of each row of ``padded`` [B, L] (CUDA,
        fp32, contiguous) -> log-mel ``[B, n_frames, n_mels]``, on the
        kernel's path for ``precision``. ``tile_frames`` 64, 48 or 32 forces
        the "fast" path's frame tile (0: the launcher's choice)."""
        if not padded.is_cuda:
            raise ValueError("the log-mel kernel needs a CUDA tensor")
        tensor_cores = _TENSOR_CORES[precision]
        c, s, m, n_used = _constants(cfg, padded.device)
        key = (cfg.n_fft, cfg.sample_rate, cfg.n_mels, cfg.fmin,
               cfg.fmax_resolved, padded.device)
        packed = fragment_bases(*key).data_ptr() if tensor_cores else None
        groups = mel_groups(*key)
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
                padded.data_ptr(), c.data_ptr(), s.data_ptr(), packed,
                m.data_ptr(), groups.data_ptr(), out.data_ptr(),
                workspace.data_ptr(), b, length, n_frames, cfg.hop_length,
                cfg.n_fft, c.shape[1], n_used, cfg.n_mels,
                int(cfg.power == 1.0), cfg.log_epsilon, tensor_cores,
                tile_frames, stream)
        if rc != 0:
            raise RuntimeError(f"logmel kernel launch failed: CUDA error {rc}")
        self.n_launches += 1
        return out


#: The process-wide binding; ``logmel_kernel.n_launches`` is its count.
logmel_kernel = LogMelKernel()


def log_mel_frames_plain(padded: torch.Tensor, cfg: FrontendConfig,
                         n_frames: int) -> torch.Tensor:
    """The plain version of ``logmel_kernel``: frames ``0..n_frames-1`` of
    an already padded ``[B, L]``, on any device, in ``padded``'s dtype (the
    fp32 constants are widened for a float64 input, which gives the exact
    answer the kernel's fp32 arithmetic is held to)."""
    c, s, m = (t.to(padded.dtype) for t in _constants(cfg, padded.device)[:3])
    frames = padded.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :n_frames]
    power = (frames @ c) ** 2 + (frames @ s) ** 2
    if cfg.power == 1.0:
        power = torch.sqrt(power)
    return torch.log(cfg.log_epsilon + power @ m)


def logmel_gemm_flops(batch: int, n_frames: int, cfg: FrontendConfig) -> int:
    """Operations of one call's two GEMMs, ``frames @ [C | S]`` and
    ``power @ mel`` over every bin, at 2 per multiply-add: what the plain
    version's matmuls count, and the tensor-core bound's operations."""
    n_bins = cfg.n_fft // 2 + 1
    rows = batch * n_frames
    return (2 * rows * cfg.n_fft * 2 * n_bins
            + 2 * rows * n_bins * cfg.n_mels)


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
        return logmel_kernel(padded, cfg, n_frames, precision)
    return log_mel_frames_plain(padded, cfg, n_frames)


def fused_log_mel_for_vocoder(wav: torch.Tensor, cfg: FrontendConfig,
                              precision: str = "fast") -> torch.Tensor:
    """Vocoder conditioning ``[B, L] -> [B, L // hop, n_mels]``, one frame
    per hop of audio: the kernel for a CUDA tensor, the plain version for a
    CPU one."""
    padded, n_frames = padded_input(wav, cfg, True, precision)
    if padded.is_cuda:
        return logmel_kernel(padded, cfg, n_frames, precision)
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
