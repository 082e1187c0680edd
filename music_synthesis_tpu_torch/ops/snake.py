"""Snake, DAC's activation (Kumar et al., arXiv:2306.06546; Ziyin et al.,
arXiv:2006.08195): ``x + sin(alpha x)^2 / (alpha + 1e-9)`` with one
``alpha`` per channel (linear scale, upstream's init 1), on ``[B, C, L]``.

``snake(x, alpha)`` is one ``torch.autograd.Function`` that computes in
fp32 (fp64 for fp64), returns ``x``'s dtype, and saves only ``x`` and
``alpha``. Its backward is the closed form

- ``dy/dx = 1 + alpha sin(2 alpha x) / (alpha + 1e-9)``,
- ``dy/dalpha = x sin(2 alpha x) / (alpha + 1e-9) - sin(alpha x)^2 /
  (alpha + 1e-9)^2``, summed over the batch and the length,

so a codec's backward holds one tensor per activation in the dtype it
travels in, where the plain chain of autograd operations would hold
several fp32 copies. Each call's forward and backward are the tracer's
regions ``snake.fwd`` and ``snake.bwd`` (the backward, on autograd's
thread, joins the capture its forward ran in); ``snake.n_calls`` counts
the forward calls (``_graphs`` keeps it per replay).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from music_synthesis_tpu_torch.utils.profiling import (
    counter,
    current_capture,
    join_capture,
    region,
)

__all__ = ["snake", "snake_calls"]

_EPS = 1e-9  # upstream's

#: Forward calls of ``snake``: up by one per call here, and in
#: ``_graphs.GraphedProgram`` by what its capture issued at each replay.
snake_calls = counter("snake")


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


class _Snake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x, alpha)
        ctx.capture = current_capture()
        snake_calls.n_calls += 1
        with region("snake.fwd"):
            dt = _compute_dtype(x)
            a = alpha.to(dt)[:, None]
            xf = x.to(dt)
            return (xf + torch.sin(a * xf).square() / (a + _EPS)).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, alpha = ctx.saved_tensors
        need_x, need_a = ctx.needs_input_grad
        with join_capture(ctx.capture), region("snake.bwd"):
            dt = _compute_dtype(x)
            a = alpha.to(dt)[:, None]
            xf, g = x.to(dt), gy.to(dt)
            inv = 1.0 / (a + _EPS)
            ax = a * xf
            s2 = torch.sin(2.0 * ax)
            gx = ga = None
            if need_x:
                gx = (g + g * (a * inv) * s2).to(x.dtype)
            if need_a:
                sin = torch.sin(ax)
                da = xf * s2 * inv - sin.square() * inv.square()
                ga = (g * da).sum(dim=(0, 2)).to(alpha.dtype)
            return gx, ga


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake of ``x [B, C, L]`` with ``alpha [C]`` (the module's
    docstring); ``x``'s dtype out."""
    return _Snake.apply(x, alpha)
