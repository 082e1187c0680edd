"""Anti-aliased SnakeBeta: BigVGAN's activation (Lee et al.,
arXiv:2206.04658; upstream ``activations.py`` and ``alias_free_torch/``).

``[B, C, L] -> [B, C, L]``: the signal is upsampled 2x, passed through
SnakeBeta at the doubled rate, and downsampled 2x, both resamplings with
one 12-tap Kaiser-windowed sinc low-pass filter (``kaiser_sinc``):

- ``upsample2``: replicate-pad 5 per side, ``2 * conv_transpose1d`` with
  the filter (stride 2, one filter per channel), 15 samples dropped from
  each end: length ``2L``;
- ``snake_beta``: ``u + sin(alpha u)^2 / (beta + 1e-9)``, with ``alpha =
  exp(a)`` and ``beta = exp(b)`` per channel (upstream's log scale);
- ``downsample2``: replicate-pad 5 on the left and 6 on the right,
  ``conv1d`` with the filter at stride 2: length ``L``.

``aa_snake_beta(x, a, b)`` is one ``torch.autograd.Function`` over the
three. It computes in fp32 (fp64 for fp64), returns ``x``'s dtype,
and saves only its input and ``a``, ``b``: the backward recomputes the
fp32 forward under autograd and differentiates it (once: G's gradient
never needs a second derivative). So the backward pass of a BigVGAN G
holds one tensor per activation, where plain autograd would hold about
ten at twice its length. Each call's forward and backward are the
tracer's regions ``aa_act.fwd`` and ``aa_act.bwd`` (``utils.profiling``),
and ``aa_act.n_calls`` counts the forward calls, as
``ops.conv.grouped_wgrad2`` counts its terms (``_graphs`` keeps it per
replay).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from music_synthesis_tpu_torch._device import refuse_capture
from music_synthesis_tpu_torch.utils.profiling import (
    counter,
    current_capture,
    join_capture,
    region,
)

__all__ = ["KERNEL", "kaiser_sinc", "upsample2", "downsample2",
           "snake_beta", "aa_snake_beta", "aa_act"]

KERNEL = 12  # taps of the resampling filter (6 * ratio // 2 * 2, ratio 2)
_CUTOFF, _HALF_WIDTH = 0.25, 0.3  # 0.5 / ratio, 0.6 / ratio
_EPS = 1e-9  # upstream's no_div_by_zero

#: Forward calls of ``aa_snake_beta``: up by one per call here, and in
#: ``_graphs.GraphedProgram`` by what its capture issued at each replay.
aa_act = counter("aa_act")


def kaiser_sinc(cutoff: float = _CUTOFF, half_width: float = _HALF_WIDTH,
                kernel_size: int = KERNEL) -> torch.Tensor:
    """The low-pass filter ``[kernel_size]`` in float64: a sinc at
    ``cutoff`` (of the sample rate) under a Kaiser window whose beta
    follows Kaiser's formula for the attenuation ``A`` of a transition
    band ``4 * half_width`` wide, normalised to sum 1."""
    half = kernel_size // 2
    atten = 2.285 * (half - 1) * math.pi * (4 * half_width) + 7.95
    if atten > 50.0:
        beta = 0.1102 * (atten - 8.7)
    elif atten >= 21.0:
        beta = 0.5842 * (atten - 21.0) ** 0.4 + 0.07886 * (atten - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, periodic=False, beta=beta,
                                 dtype=torch.float64)
    if kernel_size % 2 == 0:
        t = torch.arange(-half, half, dtype=torch.float64) + 0.5
    else:
        t = torch.arange(kernel_size, dtype=torch.float64) - half
    h = 2 * cutoff * window * torch.sinc(2 * cutoff * t)
    return h / h.sum()


@functools.lru_cache(maxsize=64)
def _filter(channels: int, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """``kaiser_sinc()`` as depthwise weights ``[C, 1, KERNEL]``."""
    refuse_capture("the anti-aliasing filter")
    return kaiser_sinc().to(dtype).to(device).view(1, 1, KERNEL).expand(
        channels, 1, KERNEL).contiguous()


def upsample2(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``[B, C, L] -> [B, C, 2L]`` through the filter ``h [C, 1, K]``."""
    pad = KERNEL // 2 - 1
    crop = pad * 2 + (KERNEL - 2) // 2
    y = 2.0 * F.conv_transpose1d(F.pad(x, (pad, pad), mode="replicate"), h,
                                 stride=2, groups=x.shape[1])
    return y[..., crop:-crop]


def downsample2(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``[B, C, 2L] -> [B, C, L]`` through the filter ``h [C, 1, K]``."""
    x = F.pad(x, (KERNEL // 2 - 1, KERNEL // 2), mode="replicate")
    return F.conv1d(x, h, stride=2, groups=x.shape[1])


def snake_beta(u: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """``u + sin(exp(a) u)^2 / (exp(b) + 1e-9)``, ``a`` and ``b`` ``[C]``."""
    alpha = torch.exp(a)[:, None]
    beta = torch.exp(b)[:, None]
    return u + torch.sin(u * alpha).square() / (beta + _EPS)


def _forward(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """The activation in fp32 (fp64 for fp64 inputs)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    h = _filter(x.shape[1], x.device, dt)
    return downsample2(snake_beta(upsample2(x.to(dt), h), a.to(dt),
                                  b.to(dt)), h)


class _AASnakeBeta(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b):
        ctx.save_for_backward(x, a, b)
        ctx.capture = current_capture()
        aa_act.n_calls += 1
        with region("aa_act.fwd"):
            return _forward(x, a, b).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, a, b = ctx.saved_tensors
        with join_capture(ctx.capture), region("aa_act.bwd"), \
                torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in
                      zip((x, a, b), ctx.needs_input_grad)]
            y = _forward(*leaves)
            asked = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, asked, gy.to(y.dtype)))
            out = [next(grads).to(t.dtype) if t.requires_grad else None
                   for t in leaves]
        return tuple(out)


def aa_snake_beta(x: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Anti-aliased SnakeBeta of ``x [B, C, L]`` with the log-scale
    ``a``, ``b`` ``[C]`` (the module's docstring); ``x``'s dtype out."""
    return _AASnakeBeta.apply(x, a, b)
