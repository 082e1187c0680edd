"""Logical FLOPs of a call, counted by the benchmark from the shapes.

``count`` runs a function of the plain reference on ``meta`` tensors under
a dispatch mode that sums ``torch.utils.flop_counter``'s formulas (its
``FlopCounterMode`` tracks modules with hooks that R1's
``autograd.grad(create_graph=True)`` refuses): convolutions (grouped ones
as grouped, their backward and R1's double backward included) and matrix
products at 2 per multiply-add. Nothing of the program runs, so a kernel
the program adds or a dense lowering it picks cannot move the count. FFTs
are not counted.

PyTorch's formula for a convolution's backward counts the weight gradient
of a grouped convolution as if it were dense (``groups`` times too much);
``_conv_backward`` replaces it: each gradient asked for costs what the
forward costs.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["conv_flops", "count"]


def conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> int:
    """2 per multiply-add of a (grouped, possibly transposed)
    convolution: ``w_shape`` is ``[Cout, Cin/groups, *K]``, or ``[Cin,
    Cout/groups, *K]`` transposed, so ``w[0] * w[1]`` is one output
    position's channel products whatever the groups."""
    spatial = x_shape[2:] if transposed else out_shape[2:]
    return (2 * x_shape[0] * math.prod(spatial) * w_shape[0] * w_shape[1]
            * math.prod(w_shape[2:]))


def _shape(x):
    return x.shape if isinstance(x, torch.Tensor) else x


def _conv_backward(grad_out, x, w, _bias, _stride, _padding, _dilation,
                   transposed, _output_padding, _groups, output_mask,
                   out_val=None) -> int:
    fwd = conv_flops(_shape(x), _shape(w), _shape(grad_out), transposed)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet is torch.ops.aten.convolution_backward:
            self.total += _conv_backward(*args, **kwargs)
        elif packet in flop_registry:
            self.total += flop_registry[packet](*args, out_val=out, **kwargs)
        return out


def count(fn: Callable[[], object]) -> int:
    """FLOPs of ``fn()``, which builds its tensors on ``meta``."""
    with _Counter() as counter:
        fn()
    return int(counter.total)
