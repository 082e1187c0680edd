"""Weight-normalized convolutions (counterpart of ``ops/conv.py``).

Parameters keep the JAX package's names and layout, so a Flax parameter
tree converts to a ``state_dict`` by flattening alone (``convert.py``):

- ``v``: the direction, ``[*K, Cin/groups, Cout]`` (JAX's HIO / HWIO);
- ``g``: the per-output-channel gain ``[Cout]`` (only with weight norm);
- ``b``: the bias ``[Cout]``.

The kernel is ``g * v / sqrt(sum(v^2) + 1e-12)`` with the norm over every
axis except Cout, and is permuted (and, for the transposed convolution,
flipped) into PyTorch's layout inside ``forward``. Activations are PyTorch's
``[B, C, L]`` (1-D) and ``[B, C, T, F]`` (2-D, JAX's ``[B, T, F, C]``).
With ``compute_dtype="bfloat16"`` the parameters stay fp32 and the input,
kernel and bias are cast, so activations flow onward in bf16.

``WNConv(dense_groups=True)`` runs a grouped convolution as the JAX
package's does with that flag: one dense convolution over the
block-diagonal ``[*K, Cin, Cout]`` kernel built from the grouped one, the
same parameters, gradients reaching only the real blocks. The JAX
package's 2-D relayout ``FFoldedWNConv2d`` is not ported: the port
computes the logical convolution it equals.

Every other grouped convolution (``groups > 1``) runs as ``GroupedConv``,
whose second derivative takes one grouped call per term. PyTorch's own
double backward of a grouped convolution (R1's ``create_graph`` input
gradient, differentiated again) computes the weight term one group at a
time: a slice, a copy and a convolution per group, then a concatenation.
In ``GroupedConv`` the input gradient taken under grad mode is itself a
function, ``_GroupedConvInputGrad``, whose backward issues one grouped
convolution for the output-gradient term and one grouped weight-gradient
call for the weight term; ``grouped_wgrad2.n_calls`` counts the latter.
Without grad mode, the backward is the single ``convolution_backward``
that native autograd dispatches, with the same mask.

On the card ``GroupedConv`` runs ``csrc/grouped_conv.cu``
(``ops/grouped_conv.py``) for each of these calls: the forward, the input
gradient (first order, and ``_GroupedConvInputGrad``'s forward), the
weight and bias gradients, and the double backward's two terms. A CUDA
call launches the kernels or raises (a 2-D one, which no model of the
port builds, raises); only a CPU tensor keeps the aten calls. On the card
each call is a region of the tracer,
``grouped_conv.fwd`` (the forward) or ``grouped_conv.bwd`` (every
gradient; from autograd's thread it joins the capture the forward ran
in), and ``grouped_conv_kernel.n_calls`` counts the launches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from music_synthesis_tpu_torch.ops import grouped_conv
from music_synthesis_tpu_torch.utils.profiling import (
    counter,
    current_capture,
    join_capture,
    region,
)

__all__ = ["GroupedConv", "WNConv", "WNConvTranspose1d", "avg_pool1d",
           "block_diagonal", "conv_transpose_padding", "grouped_wgrad2"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_aten = torch.ops.aten


#: Second-order weight terms issued as one grouped weight-gradient call
#: (``_GroupedConvInputGrad.backward``): up by one per call here, and in
#: ``_graphs.GraphedProgram`` by what its capture issued at each replay
#: (the warm-up and the capture that build a graph are taken back out).
grouped_wgrad2 = counter("grouped_wgrad2")


def _needed(ctx, n_inputs: int) -> list[bool]:
    """Which of a function's first ``n_inputs`` inputs (tensors or None)
    this backward must return a gradient for, as the engine asks a native
    node: none where the input takes no gradient or the engine will not
    run its node in this pass; a leaf, which the engine cannot be asked
    about under ``autograd.grad``, where it requires grad."""
    nodes = [node for node, _ in ctx.next_functions]
    nodes += [None] * (n_inputs - len(nodes))
    out = []
    for node, need in zip(nodes[:n_inputs], ctx.needs_input_grad):
        if node is None or not need:
            out.append(False)
        elif hasattr(node, "variable"):  # AccumulateGrad
            out.append(True)
        else:
            out.append(torch._C._will_engine_execute_node(node))
    return out


def _conv(x, w, b, args):
    """``aten.convolution`` as ``F.conv{1,2}d(x, w, b, stride, padding 0,
    dilation, groups)`` calls it; ``args`` is ``(stride, dilation,
    groups)``."""
    stride, dilation, groups = args
    zeros = [0] * len(stride)
    return _aten.convolution(x, w, b, stride, zeros, dilation, False, zeros,
                             groups)


def _conv_backward(gy, x, w, bias_sizes, args, mask):
    """``aten.convolution_backward`` of ``_conv(x, w, b, args)`` as native
    autograd calls it; None for each gradient ``mask`` leaves out (the
    CPU's grouped path can return a tensor there)."""
    stride, dilation, groups = args
    zeros = [0] * len(stride)
    grads = _aten.convolution_backward(gy, x, w, bias_sizes, stride, zeros,
                                       dilation, False, zeros, groups, mask)
    return [g if m else None for g, m in zip(grads, mask)]


def _on_card(x: torch.Tensor) -> bool:
    """A call for ``csrc/grouped_conv.cu``: a CUDA tensor (the launchers
    raise on what the kernels do not take, a 2-D call included)."""
    return x.is_cuda


class _GroupedConvInputGrad(torch.autograd.Function):
    """``grad_x`` of a grouped convolution, from ``grad_y`` and the kernel
    (``x`` only for its shape), closed under one more derivative: the
    backward issues one grouped convolution of ``gg_x`` with ``w`` for
    ``grad_y``'s gradient and one grouped weight-gradient call for ``w``'s,
    each over all groups at once."""

    @staticmethod
    def forward(ctx, gy, x, w, bias_sizes, args):
        ctx.save_for_backward(gy, w)
        ctx.args = args
        ctx.capture = current_capture()
        if _on_card(x):  # inside GroupedConv.backward's region
            return grouped_conv.input_grad(gy, w, x.shape[-1], *args)
        return _conv_backward(gy, x, w, bias_sizes, args,
                              [True, False, False])[0]

    @staticmethod
    def backward(ctx, ggx):
        gy, w = ctx.saved_tensors
        need_gy, _, need_w = _needed(ctx, 3)
        ggy = gw = None
        if _on_card(gy):
            if torch.is_grad_enabled():
                raise NotImplementedError(
                    "a third derivative of a grouped convolution on the "
                    "card")
            with join_capture(ctx.capture), region("grouped_conv.bwd"):
                ggx = ggx.contiguous()
                if need_gy:
                    ggy = grouped_conv.forward(ggx, w, None, *ctx.args)
                if need_w:
                    gw = grouped_conv.weight_grad(gy, ggx, w.shape,
                                                  *ctx.args, True, False)[0]
        else:
            if need_gy:
                ggy = _conv(ggx, w, None, ctx.args)
            if need_w:
                gw = _conv_backward(gy, ggx, w, None, ctx.args,
                                    [False, True, False])[1]
        if need_w:
            grouped_wgrad2.n_calls += 1
        return ggy, None, gw, None, None


class GroupedConv(torch.autograd.Function):
    """``F.conv{1,2}d(x, w, b, stride=, dilation=, groups=)`` with no
    padding (``WNConv`` pads first), the same aten call. Its backward
    without grad mode is the one ``convolution_backward`` native autograd
    dispatches, with the same mask; under grad mode (``create_graph``)
    ``grad_x`` is ``_GroupedConvInputGrad``'s and the kernel's and bias's
    gradients, where asked for, one native call's. A CUDA call runs
    ``csrc/grouped_conv.cu`` instead (the module's docstring)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.bias_sizes = None if b is None else [b.shape[0]]
        ctx.args = (list(stride), list(dilation), groups)
        if _on_card(x):
            ctx.capture = current_capture()
            with region("grouped_conv.fwd"):
                return grouped_conv.forward(x, w, b, *ctx.args)
        return _conv(x, w, b, ctx.args)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        mask = _needed(ctx, 3)
        closed = torch.is_grad_enabled() and mask[0]
        if closed:
            mask[0] = False
        if _on_card(x):
            return _backward_on_card(ctx, gy, x, w, mask, closed)
        gx, gw, gb = (_conv_backward(gy, x, w, ctx.bias_sizes, ctx.args, mask)
                      if any(mask) else (None, None, None))
        if closed:
            gx = _GroupedConvInputGrad.apply(gy, x, w, ctx.bias_sizes,
                                             ctx.args)
        return gx, gw, gb, None, None, None


class _WeightGradOnCard(torch.autograd.Function):
    """The kernel's weight and bias gradients taken under grad mode (R1's
    ``create_graph`` pass asks for them where the bias or kernel is a leaf,
    whose node the engine cannot be asked about): the values, and a
    derivative that raises, as the kernels carry none further."""

    @staticmethod
    def forward(ctx, gy, x, w, args, need_w, need_b):
        return grouped_conv.weight_grad(gy, x, w.shape, *args, need_w,
                                        need_b)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "a derivative of a grouped convolution's weight or bias "
            "gradient on the card")


def _backward_on_card(ctx, gy, x, w, mask, closed):
    """``GroupedConv.backward`` through ``csrc/grouped_conv.cu``; under grad
    mode ``grad_x`` is ``_GroupedConvInputGrad``'s and the kernel's and
    bias's gradients ``_WeightGradOnCard``'s."""
    gx = gw = gb = None
    with join_capture(ctx.capture), region("grouped_conv.bwd"):
        gy = gy.contiguous()  # autograd may hand it expanded
        if mask[0]:
            gx = grouped_conv.input_grad(gy, w, x.shape[-1], *ctx.args)
        if (mask[1] or mask[2]) and torch.is_grad_enabled():
            gw, gb = _WeightGradOnCard.apply(gy, x, w, ctx.args, mask[1],
                                             mask[2])
        elif mask[1] or mask[2]:
            gw, gb = grouped_conv.weight_grad(gy, x, w.shape, *ctx.args,
                                              mask[1], mask[2])
        if closed:
            gx = _GroupedConvInputGrad.apply(gy, x, w, ctx.bias_sizes,
                                             ctx.args)
    return gx, gw, gb, None, None, None


def _init_std(scheme: str, init_scale: float, fan_in: int,
              gain: float = 1.0) -> float:
    """Init std of ``v``: 'dcgan' N(0, init_scale), 'he' N(0, sqrt(2/fan_in))."""
    if scheme == "he":
        return float(gain * (2.0 / max(fan_in, 1)) ** 0.5)
    if scheme != "dcgan":
        raise ValueError(f"unknown init_scheme {scheme!r}")
    return gain * init_scale


def _norm(v: torch.Tensor, gain_axis: int,
          keepdim: bool = False) -> torch.Tensor:
    """``||v||`` over all axes but ``gain_axis``."""
    axis = gain_axis % v.ndim
    dims = tuple(i for i in range(v.ndim) if i != axis)
    return torch.sqrt(torch.sum(v * v, dim=dims, keepdim=keepdim) + 1e-12)


def _normalize(v: torch.Tensor, g: torch.Tensor,
               gain_axis: int = -1) -> torch.Tensor:
    """``g * v / ||v||`` with the norm over all axes but ``gain_axis``
    (the last, Cout, by default), along which ``g`` lies."""
    shape = [1] * v.ndim
    shape[gain_axis] = -1
    return v * (g.view(shape) / _norm(v, gain_axis, keepdim=True))


class _WNBase(nn.Module):
    """Holds ``v`` (and ``g``, ``b``) and computes the normalized kernel;
    ``g`` lies along ``gain_axis`` of ``v`` (Cout, the last, by
    default)."""

    def __init__(self, kshape: tuple[int, ...], fan_in: int, *,
                 use_weight_norm: bool, use_bias: bool, init_scale: float,
                 init_scheme: str, init_gain: float, compute_dtype: str,
                 generator: torch.Generator | None, gain_axis: int = -1):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
        self.compute_dtype = _DTYPES[compute_dtype]
        std = _init_std(init_scheme, init_scale, fan_in, init_gain)
        v = torch.empty(kshape).normal_(0.0, std, generator=generator)
        self.v = nn.Parameter(v)
        self.use_weight_norm = use_weight_norm
        self.gain_axis = gain_axis
        if use_weight_norm:
            self.g = nn.Parameter(_norm(v, gain_axis))
        self.b = nn.Parameter(torch.zeros(kshape[-1])) if use_bias else None

    def kernel(self) -> torch.Tensor:
        """The effective kernel in the JAX layout ``[K, Cin/groups, Cout]``."""
        return (_normalize(self.v, self.g, self.gain_axis)
                if self.use_weight_norm else self.v)

    def _bias(self) -> torch.Tensor | None:
        return None if self.b is None else self.b.to(self.compute_dtype)


def block_diagonal(kernel: torch.Tensor, groups: int) -> torch.Tensor:
    """The dense ``[*K, Cin, Cout]`` kernel equal to the grouped
    ``[*K, Cin/groups, Cout]`` one: ``dense[..., h*ci + c, g*co + o] =
    kernel[..., c, g*co + o]`` where ``h == g``, else 0 (the JAX package's
    ``einsum("...cgo,hg->...hcgo")``)."""
    *ks, ci, cout = kernel.shape
    kr = kernel.reshape(*ks, ci, groups, cout // groups)
    eye = torch.eye(groups, dtype=kernel.dtype, device=kernel.device)
    return torch.einsum("...cgo,hg->...hcgo", kr, eye).reshape(
        *ks, ci * groups, cout)


class WNConv(_WNBase):
    """1-D ``[B, Cin, L] -> [B, Cout, L']`` or 2-D ``[B, Cin, T, F] ->
    [B, Cout, T', F']`` convolution with explicit padding.

    ``kernel_size``, ``stride`` and ``dilation`` are an int (1-D) or one
    int per spatial axis. padding: 'same' (torch-style symmetric zeros,
    total ``d*(k-1)`` per axis with the extra sample at the end), 'reflect'
    (the same amounts, reflected), 'valid', or an int: that many zeros at
    each end of each axis (``nn.Conv1d``'s ``padding``). ``dense_groups``: with
    ``groups > 1``, one dense convolution over ``block_diagonal`` of the
    kernel in place of ``groups`` grouped ones.
    """

    def __init__(self, in_channels: int, features: int,
                 kernel_size: int | tuple[int, ...], *,
                 stride: int | tuple[int, ...] = 1,
                 dilation: int | tuple[int, ...] = 1, groups: int = 1,
                 dense_groups: bool = False, padding: str | int = "same",
                 use_weight_norm: bool = True, use_bias: bool = True,
                 init_scale: float = 0.02,
                 init_scheme: str = "dcgan", init_gain: float = 1.0,
                 compute_dtype: str = "float32",
                 generator: torch.Generator | None = None):
        kernel = ((kernel_size,) if isinstance(kernel_size, int)
                  else tuple(kernel_size))
        ndim = len(kernel)
        if ndim not in (1, 2):
            raise ValueError(f"{ndim}-D convolutions are not supported")

        def per_axis(v):
            return (v,) * ndim if isinstance(v, int) else tuple(v)

        if in_channels % groups:
            raise ValueError(f"in_channels {in_channels} not divisible by "
                             f"groups {groups}")
        if not isinstance(padding, int) and padding not in (
                "same", "reflect", "valid"):
            raise ValueError(f"unsupported padding {padding!r}")
        super().__init__(
            (*kernel, in_channels // groups, features),
            (in_channels // groups) * math.prod(kernel),
            use_weight_norm=use_weight_norm, use_bias=use_bias,
            init_scale=init_scale, init_scheme=init_scheme,
            init_gain=init_gain, compute_dtype=compute_dtype,
            generator=generator)
        self.stride, self.dilation = per_axis(stride), per_axis(dilation)
        self.groups, self.padding = groups, padding
        self.dense_groups = dense_groups and groups > 1
        # F.pad order: the last axis first, (lo, hi) for each.
        pads = []
        for k, d in zip(reversed(kernel), reversed(self.dilation)):
            if isinstance(padding, int):
                pads += [padding, padding]
                continue
            total = 0 if padding == "valid" else d * (k - 1)
            pads += [total // 2, total - total // 2]
        self.pads = tuple(pads)
        self._conv = F.conv1d if ndim == 1 else F.conv2d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if any(self.pads):
            mode = "reflect" if self.padding == "reflect" else "constant"
            x = F.pad(x, self.pads, mode=mode)
        k = self.kernel()
        groups = self.groups
        if self.dense_groups:
            k, groups = block_diagonal(k, groups), 1
        w = k.permute(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))
        cdt = self.compute_dtype
        if groups > 1:
            return GroupedConv.apply(x.to(cdt), w.to(cdt), self._bias(),
                                     self.stride, self.dilation, groups)
        return self._conv(x.to(cdt), w.to(cdt), self._bias(),
                          stride=self.stride, dilation=self.dilation,
                          groups=groups)


def conv_transpose_padding(kernel_size: int, stride: int) -> tuple[int, int]:
    """``(pad_a, torch_padding)`` that make ``F.conv_transpose1d`` equal
    ``lax.conv_transpose(..., padding="SAME")`` with an HIO kernel.

    JAX (``transpose_kernel=False``) dilates the input by the stride, pads
    it by ``pad_a`` before and ``k + s - 2 - pad_a`` after, and correlates
    with the kernel as stored: ``out[t] = sum_j xd[t + j - pad_a] K[j]``.
    ``F.conv_transpose1d`` computes ``out[t] = sum_i x[i] W[t + P - i*s]``.
    With ``W[j'] = K[k-1-j']`` (the kernel flipped) the two agree when
    ``P = k - 1 - pad_a``. PyTorch's output is then
    ``(L-1)*s - 2P + k`` long, which is ``L*s`` or ``L*s + 1``; the first
    ``L*s`` samples are JAX's output.
    """
    if kernel_size < stride:
        raise ValueError("kernel_size must be >= stride")
    pad_len = kernel_size + stride - 2
    pad_a = kernel_size - 1 if stride > kernel_size - 1 else -(-pad_len // 2)
    return pad_a, kernel_size - 1 - pad_a


class WNConvTranspose1d(_WNBase):
    """Transposed 1-D convolution ``[B, Cin, L] -> [B, Cout, L*stride]``,
    equal to the reference's ``lax.conv_transpose(k, s, "SAME", HIO)``.
    ``gain_per_input``: weight norm with one gain per input channel
    (``g [Cin]``, the norm over the kernel and the outputs), as
    ``torch.nn.utils.weight_norm``'s default (dim 0) normalises a
    ``ConvTranspose1d``; else one per output channel."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int, *, use_weight_norm: bool = True,
                 use_bias: bool = True, init_scale: float = 0.02,
                 init_scheme: str = "dcgan", init_gain: float = 1.0,
                 compute_dtype: str = "float32",
                 generator: torch.Generator | None = None,
                 gain_per_input: bool = False):
        super().__init__(
            (kernel_size, in_channels, features),
            in_channels * max(kernel_size // stride, 1),
            use_weight_norm=use_weight_norm, use_bias=use_bias,
            init_scale=init_scale, init_scheme=init_scheme,
            init_gain=init_gain, compute_dtype=compute_dtype,
            generator=generator, gain_axis=1 if gain_per_input else -1)
        self.stride = stride
        self.torch_padding = conv_transpose_padding(kernel_size, stride)[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel().flip(0).permute(1, 2, 0)  # [Cin, Cout, K]
        cdt = self.compute_dtype
        out = F.conv_transpose1d(x.to(cdt), w.to(cdt), self._bias(),
                                 stride=self.stride,
                                 padding=self.torch_padding)
        return out[..., : x.shape[-1] * self.stride]


def avg_pool1d(x: torch.Tensor, window: int, stride: int,
               pad: int) -> torch.Tensor:
    """Average pool over the last axis of ``[B, C, L]``, zero-padded by
    ``pad`` per side and divided by the unpadded window overlap (AvgPool1d
    with ``count_include_pad=False``), as between the MSD's scales."""
    return F.avg_pool1d(x, window, stride, pad, count_include_pad=False)
