"""Anti-wrapping phase-coherence loss (counterpart of
``losses/phase_loss.py``).

For the complex STFTs ``S`` of the generated (x) and real (y) signals, the
phase advance along time (instantaneous frequency, ``S[t+1] conj S[t]``)
and along frequency (group delay, ``S[k+1] conj S[k]``) are compared by
the smooth, bounded ``1 - cos(difference)``, weighted by the real pair's
magnitude (detached): phase derivatives are offset-invariant, and quiet
cells, whose phase means nothing, weigh little.

``group``: under data parallelism, the process group holding the batch's
shards. The weighted means are ratios, so their numerators and
denominators are summed over the ranks (``parallel.mesh.AllReduce``, as
``losses/stft_loss.py`` sums its norms) and every rank computes the
global-batch value, with the single-process gradient once the step has
averaged the gradients.
"""

from __future__ import annotations

import torch

from music_synthesis_tpu_torch.ops.frontend import stft
from music_synthesis_tpu_torch.parallel.mesh import AllReduce

__all__ = ["phase_coherence_loss"]


def _shifted_product(re: torch.Tensor, im: torch.Tensor, dim: int):
    """(re, im) of ``S_shifted * conj(S)`` along ``dim``, in reals."""
    n = re.shape[dim]
    a0, a1 = re.narrow(dim, 0, n - 1), re.narrow(dim, 1, n - 1)
    b0, b1 = im.narrow(dim, 0, n - 1), im.narrow(dim, 1, n - 1)
    return a1 * a0 + b1 * b0, b1 * a0 - a1 * b0


def _weighted_antiwrap(px, py, eps: float):
    """``sum(w * (1 - cos(angle(px) - angle(py))))`` and ``sum(w)``, with
    ``w = |py|`` detached."""
    rx, ix = px
    ry, iy = py
    mx = torch.sqrt(rx * rx + ix * ix + eps * eps)
    my = torch.sqrt(ry * ry + iy * iy + eps * eps)
    cos_d = (rx * ry + ix * iy) / (mx * my + eps)
    w = my.detach()
    return torch.sum(w * (1.0 - cos_d)), torch.sum(w)


def phase_coherence_loss(x: torch.Tensor, y: torch.Tensor, n_fft: int = 1024,
                         hop_length: int = 256, eps: float = 1e-8,
                         group=None) -> torch.Tensor:
    """IF + GD anti-wrapping phase loss of generated ``x`` against
    time-aligned real ``y`` (both ``[..., L]``): each term a weighted mean
    of ``1 - cos`` in ``[0, 2]``."""
    sx = stft(x, n_fft=n_fft, hop_length=hop_length)
    sy = stft(y, n_fft=n_fft, hop_length=hop_length)
    rex, imx, rey, imy = sx.real, sx.imag, sy.real, sy.imag
    num_if, den_if = _weighted_antiwrap(
        _shifted_product(rex, imx, -2), _shifted_product(rey, imy, -2), eps)
    num_gd, den_gd = _weighted_antiwrap(
        _shifted_product(rex, imx, -1), _shifted_product(rey, imy, -1), eps)
    if group is not None:
        num_if, den_if, num_gd, den_gd = AllReduce.apply(
            torch.stack([num_if, den_if, num_gd, den_gd]), group, 1.0)
    return (num_if / torch.clamp(den_if, min=eps)
            + num_gd / torch.clamp(den_gd, min=eps))
