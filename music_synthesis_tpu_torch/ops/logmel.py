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
  parts and ``hi*hi + hi*lo + lo*hi`` is accumulated in fp32 by Hopper's
  ``wgmma``, which keeps fp32-level accuracy at three tensor-core passes
  (495 TFLOP/s dense for TF32 on an H100, against 67 for fp32 FFMA). The
  bases are split once per device into hi and lo and stored K-major, their
  samples in four phases ``k = 4 j + phase`` (``split_bases``); TMA loads
  them into a ring of shared memory, from which ``wgmma`` reads them, and
  the kernel splits the frames in registers. Each phase is summed on the
  tensor cores from zero and the phases are added in fp32, which keeps
  near-silent bins accurate. The phases of a tile may be shared by a
  cluster of 2 or 4 blocks (``split``).
- ``"exact"`` computes it in fp32 FFMA, in the plain version's summation
  order, so it agrees with the plain version to ~1e-6; the 3xTF32 path,
  rounded elsewhere, lands further away in near-silent mel bins (on an
  H100, PERF.md) than the 2e-4 gate that ``"exact"`` is held to.

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
from music_synthesis_tpu_torch.utils.profiling import counter

__all__ = [
    "LogMelKernel",
    "logmel_kernel",
    "logmel_launches",
    "logmel_constants",
    "split_bases",
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
_ENCODE_MISSING = 10000  # csrc/logmel.cu, tc::kEncodeMissing; + 1 + CUresult

#: Launches of the kernel: up by one per launch here, and in
#: ``_graphs.GraphedProgram`` by what its capture issued at each replay.
logmel_launches = counter("logmel_kernel")
# The "fast" path's stage, sample phases and chunk (csrc/logmel.cu,
# tc::kBK, tc::kPhases and tc::kBN): its split bases hold whole stages of
# each phase of K_PHASES and whole chunks of bins, zero-padded, and both
# paths' mel partial sums are kept per chunk of CHUNK_BINS bins.
K_STAGE = 32
K_PHASES = 4
CHUNK_BINS = 64
SPLITS = (1, 2, 4)  # the blocks that may share a tile's K walk


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
def split_bases(n_fft: int, sample_rate: int, n_mels: int, fmin: float,
                fmax: float, device: torch.device) -> torch.Tensor:
    """The "fast" path's bases on ``device``: C and S (bins below n_used)
    split into TF32 parts, ``[chunk, hi | lo, cos | sin, 64 bins, kp]``
    fp32, K-major (a bin's samples are contiguous), with ``kp =
    round_up(n_fft, K_STAGE * K_PHASES)`` samples in phase order: column
    ``phase * kp / K_PHASES + j`` holds sample ``K_PHASES * j + phase``
    (so a block that takes one phase's samples reads whole stages); zero
    past n_fft and n_used. ``hi`` keeps the top 10 mantissa bits of each
    value and ``lo = value - hi`` (exact in fp32), so ``hi + lo`` is the
    fp32 basis; the tensor cores read ``lo``'s top 10 bits. A chunk's cos
    and sin rows are the N = 128 operand of one ``wgmma``; ~8.4 MB at
    n_fft 1024."""
    refuse_capture("split_bases")
    c, s, _, n_used = _host_constants(n_fft, sample_rate, n_mels, fmin, fmax)
    kp = -(-n_fft // (K_STAGE * K_PHASES)) * K_STAGE * K_PHASES
    chunks = -(-n_used // CHUNK_BINS)
    full = np.zeros((2, chunks * CHUNK_BINS, kp), np.float32)  # [cs, bin, k]
    full[0, :n_used, :n_fft] = c[:, :n_used].T
    full[1, :n_used, :n_fft] = s[:, :n_used].T
    column = np.arange(kp)
    full = full[..., K_PHASES * (column % (kp // K_PHASES))
                + column // (kp // K_PHASES)]
    hi = (full.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    parts = np.stack([hi, full - hi])  # [hi | lo, cs, bin, k]
    parts = parts.reshape(2, 2, chunks, CHUNK_BINS, kp).transpose(2, 0, 1, 3, 4)
    return torch.from_numpy(np.ascontiguousarray(parts)).to(device)


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
    for b0 in range(0, n_used, CHUNK_BINS):
        nz = np.flatnonzero(np.any(m[b0:min(b0 + CHUNK_BINS, n_used)] != 0.0,
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


def _error(rc: int) -> str:
    """The C function's return code in words (csrc/logmel.cu,
    logmel_forward)."""
    if rc == _ENCODE_MISSING:
        return "libcuda has no cuTensorMapEncodeTiled"
    if rc > _ENCODE_MISSING:
        return (f"cuTensorMapEncodeTiled refused the bases' map "
                f"(CUresult {rc - _ENCODE_MISSING - 1})")
    return f"CUDA error {rc}"


class LogMelKernel:
    """ctypes binding of ``csrc/logmel.cu``. Its launches are counted in
    ``logmel_launches``. The launch is captured whole: the tile counters'
    ``cudaMemsetAsync`` and the kernel on the current stream, the
    workspace from the graph's pool.
    """

    def __init__(self):
        self._forward = None  # the C functions, bound at first launch
        self._workspace_words = None
        self._fast_split = None

    def _fn(self):
        if self._forward is None:
            lib = _build.load("logmel")
            i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
            words = lib.logmel_workspace_words
            words.argtypes = [i32, i32, i32, i32]
            words.restype = i64
            split = lib.logmel_fast_split
            split.argtypes = [i32, i32, i32, i32]
            split.restype = i32
            fn = lib.logmel_forward
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i64,
                           i32, i32, i32, i32, i32, i32, i32, ctypes.c_float,
                           i32, i32, ptr]
            fn.restype = i32
            self._workspace_words, self._fast_split = words, split
            self._forward = fn
        return self._forward

    def launcher_split(self, batch: int, n_frames: int, cfg: FrontendConfig,
                       device: torch.device) -> int:
        """The K split (1, 2 or 4) the "fast" path's launcher picks on the
        card ``device`` for ``batch`` clips of ``n_frames`` frames."""
        self._fn()
        n_used = _constants(cfg, device)[3]
        with torch.cuda.device(device):
            split = self._fast_split(batch, n_frames, cfg.n_fft, n_used)
        if split < 1:
            raise RuntimeError(f"no launch fits: {_error(-split)}")
        return split

    def __call__(self, padded: torch.Tensor, cfg: FrontendConfig,
                 n_frames: int, precision: str = "fast",
                 split: int = 0) -> torch.Tensor:
        """Frames ``0..n_frames-1`` of each row of ``padded`` [B, L] (CUDA,
        fp32, contiguous) -> log-mel ``[B, n_frames, n_mels]``, on the
        kernel's path for ``precision``. ``split`` 1, 2 or 4 forces how many
        blocks of a cluster share a tile's K walk on the "fast" path (0: the
        launcher's choice, from ``SPLITS``)."""
        if not padded.is_cuda:
            raise ValueError("the log-mel kernel needs a CUDA tensor")
        tensor_cores = _TENSOR_CORES[precision]
        c, s, m, n_used = _constants(cfg, padded.device)
        key = (cfg.n_fft, cfg.sample_rate, cfg.n_mels, cfg.fmin,
               cfg.fmax_resolved, padded.device)
        bases = split_bases(*key).data_ptr() if tensor_cores else None
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
                padded.data_ptr(), c.data_ptr(), s.data_ptr(), bases,
                m.data_ptr(), groups.data_ptr(), out.data_ptr(),
                workspace.data_ptr(), b, length, n_frames, cfg.hop_length,
                cfg.n_fft, c.shape[1], n_used, cfg.n_mels,
                int(cfg.power == 1.0), cfg.log_epsilon, tensor_cores,
                split, stream)
        if rc != 0:
            raise RuntimeError(f"logmel kernel launch failed: {_error(rc)}")
        logmel_launches.n_calls += 1
        return out


#: The process-wide binding.
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
