"""The benchmark's yardstick arithmetic, frozen here so that no change to the
program moves it.

Copied from the port at commit 29bca4e:

- ``PEAK_FLOPS`` and ``conv_precision``: ``music_synthesis_tpu_torch/bench.py``
  (``conv_precision`` takes the config's dtype strings and the cuDNN TF32
  switch in place of a config and a device);
- ``device_union``: ``music_synthesis_tpu_torch/utils/profiling.py``;
- ``logmel_gemm_flops``: ``music_synthesis_tpu_torch/ops/logmel.py``.

``HBM_BYTES_PER_S`` is the H100 SXM's published 3.35 TB/s, and
``logmel_least_s`` the least time of one launch of the log-mel kernel (the
bound of PERF.md §6: both GEMMs as three TF32 passes at the TF32 peak, or
the audio read once and the log-mel written once at the HBM rate).
"""

from __future__ import annotations


__all__ = ["PEAK_FLOPS", "HBM_BYTES_PER_S", "conv_precision", "device_union",
           "logmel_gemm_flops", "logmel_least_s"]

#: Published dense peaks (NVIDIA's data sheet) by the card's name, at 700 W.
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12,
                                        "fp32": 67e12}}

HBM_BYTES_PER_S = 3.35e12


def conv_precision(dtypes: set[str], cudnn_tf32: bool) -> str:
    """The precision convolutions of these compute dtypes run in: ``bf16``;
    for fp32, ``tf32`` under cuDNN's TF32 (PyTorch's default on a card),
    else ``fp32``; ``mixed`` when they differ."""
    if dtypes == {"bfloat16"}:
        return "bf16"
    if dtypes != {"float32"}:
        return "mixed"
    return "tf32" if cudnn_tf32 else "fp32"


def device_union(spans: list[tuple[float, float]]) -> tuple[float, float]:
    """``(busy, extent)`` of sorted ``(start, end)`` spans: the length of
    their union, overlaps counted once, and the span from the first start
    to the last end. ``(0, 0)`` for no spans."""
    if not spans:
        return 0.0, 0.0
    busy, (start, end) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy += end - start
    return busy, end - spans[0][0]


def logmel_gemm_flops(batch: int, n_frames: int, n_fft: int,
                      n_mels: int) -> int:
    """Operations of one launch's two GEMMs, ``frames @ [C | S]`` and
    ``power @ mel`` over every bin, 2 per multiply-add."""
    n_bins = n_fft // 2 + 1
    rows = batch * n_frames
    return 2 * rows * n_fft * 2 * n_bins + 2 * rows * n_bins * n_mels


def logmel_least_s(batch: int, length: int, hop: int, n_fft: int,
                   n_mels: int, peaks: dict) -> float:
    """The least time one launch at ``[batch, length]`` can take."""
    frames = length // hop
    compute = 3 * logmel_gemm_flops(batch, frames, n_fft, n_mels) / peaks[
        "tf32"]
    memory = 4 * (batch * length + batch * frames * n_mels) / HBM_BYTES_PER_S
    return max(compute, memory)

