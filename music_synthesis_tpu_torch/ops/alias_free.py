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
and saves only its input and ``a``, ``b`` (once differentiable: G's
gradient never needs a second derivative). So the backward pass of a
BigVGAN G holds one tensor per activation, where plain autograd would
hold about ten at twice its length.

For a CUDA tensor (fp32 or bf16, contiguous) each direction is one launch
of ``csrc/aa_act.cu`` (the backward adds a second, small one for the
parameters' gradients), which keeps everything at the doubled rate in
registers and shared memory; any other CUDA input raises. For a CPU tensor
the function is the plain version above, and the backward recomputes the
forward under autograd and differentiates it: that path is the reference
the tests hold the kernel to. Each call's forward and backward are the
tracer's regions ``aa_act.fwd`` and ``aa_act.bwd`` (``utils.profiling``);
``aa_act.n_calls`` counts the forward calls and ``aa_act_kernel.n_calls``
the kernel's launches, as ``ops.conv.grouped_wgrad2`` counts its terms
(``_graphs`` keeps both per replay).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from music_synthesis_tpu_torch import _build
from music_synthesis_tpu_torch._device import refuse_capture
from music_synthesis_tpu_torch.utils.profiling import (
    counter,
    current_capture,
    join_capture,
    region,
)

__all__ = ["KERNEL", "kaiser_sinc", "upsample2", "downsample2",
           "snake_beta", "aa_snake_beta", "aa_act", "aa_act_kernel",
           "Tiling", "tiling"]

KERNEL = 12  # taps of the resampling filter (6 * ratio // 2 * 2, ratio 2)
_CUTOFF, _HALF_WIDTH = 0.25, 0.3  # 0.5 / ratio, 0.6 / ratio
_EPS = 1e-9  # upstream's no_div_by_zero

#: Forward calls of ``aa_snake_beta``: up by one per call here, and in
#: ``_graphs.GraphedProgram`` by what its capture issued at each replay.
aa_act = counter("aa_act")
#: Launches of ``csrc/aa_act.cu``'s kernels, counted the same way: one a
#: forward call, one or two a backward call (two when ``a`` or ``b`` asks
#: for its gradient).
aa_act_kernel = counter("aa_act_kernel")

# The kernel's tiles (csrc/aa_act.cu, which launches the grid ``tiling``
# gives and refuses a tile over its budget): a block takes
# ``rows_per_block`` rows x ``span`` outputs, holds each row's inputs from
# ``span + _HALO`` samples in shared memory, and computes 8 outputs a
# thread at a time.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SPAN_MAX = 2048  # outputs a block takes along one row, at most
_TILE_WORDS = 2304  # rows_per_block * (span + _HALO), at most: kTileInputs
_HALO = 24  # csrc/aa_act.cu: kLead + kTail
_BLOCKS_PER_SM = 4  # fewer blocks than this a SM: cut the tiles


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


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


@dataclasses.dataclass(frozen=True)
class Tiling:
    """The kernel's grid over ``rows`` rows of ``length`` samples: the
    kernel launches ``blocks`` blocks over ``n_col`` spans a row, and block
    ``i`` takes rows ``r0 .. r0 + nr - 1`` and outputs ``t0 .. t0 + tn - 1``
    of each (``block``, as the kernel's ``tile_at`` maps it)."""

    rows: int
    length: int
    rows_per_block: int
    span: int  # a multiple of 8

    @property
    def n_col(self) -> int:
        return -(-self.length // self.span)

    @property
    def blocks(self) -> int:
        return -(-self.rows // self.rows_per_block) * self.n_col

    @property
    def partial_words(self) -> int:
        """fp32 words of the backward's parameter partials: a pair per row
        and span."""
        return 2 * self.rows * self.n_col

    def block(self, i: int) -> tuple[int, int, int, int]:
        """``(r0, nr, t0, tn)`` of block ``i``."""
        col, r0 = i % self.n_col, (i // self.n_col) * self.rows_per_block
        t0 = col * self.span
        return (r0, min(self.rows_per_block, self.rows - r0), t0,
                min(self.span, self.length - t0))


@functools.lru_cache(maxsize=256)
def tiling(rows: int, length: int, n_sm: int) -> Tiling:
    """The tiles for ``rows`` rows of ``length`` samples on a card of
    ``n_sm`` SMs: a span of up to ``_SPAN_MAX`` outputs and as many rows a
    block as ``_TILE_WORDS`` of shared memory hold, then rows and span cut
    while the grid has fewer than ``_BLOCKS_PER_SM`` blocks a SM. At batch
    32 BigVGAN's six shapes all give about 2048 outputs a block."""
    span = min(_round_up(length, 8), _SPAN_MAX)
    per_block = max(1, min(rows, _TILE_WORDS // (span + _HALO)))
    want = _BLOCKS_PER_SM * n_sm
    t = Tiling(rows, length, per_block, span)
    while t.blocks < want and t.rows_per_block > 1:
        t = dataclasses.replace(t, rows_per_block=-(-t.rows_per_block // 2))
    while t.blocks < want and t.span > 256:
        t = dataclasses.replace(t, span=_round_up(t.span // 2, 8))
    return t


@functools.lru_cache(maxsize=8)
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1)
def _library():
    """``csrc/aa_act.cu``'s C functions, built and bound at first use."""
    lib = _build.load("aa_act")
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.aa_act_forward.argtypes = [ptr] * 5 + [i32] * 9 + [ptr]
    lib.aa_act_forward.restype = i32
    lib.aa_act_backward.argtypes = [ptr] * 9 + [i32] * 9 + [ptr]
    lib.aa_act_backward.restype = i32
    return lib


def _check_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """Raises on what the kernel does not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"the anti-aliased SnakeBeta kernel takes float32 "
                        f"or bfloat16, got {x.dtype}")
    if x.ndim != 3 or min(x.shape) < 1:
        raise ValueError(f"x must be a non-empty [B, C, L], got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for name, p in (("a", a), ("b", b)):
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
        if p.dtype != torch.float32 or p.shape != (x.shape[1],) \
                or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"[{x.shape[1]}], got {p.dtype} "
                             f"{tuple(p.shape)}")


def _launch_args(x: torch.Tensor, *out: torch.Tensor):
    """The tiles, and ``(dtype, batch, channels, length, rows_per_block,
    span, n_col, blocks, vec)`` for the C functions: 16-byte accesses when
    every row of every tensor is 16-byte aligned."""
    batch, channels, length = x.shape
    t = tiling(batch * channels, length, _n_sm(x.device))
    vec = (length * x.element_size() % 16 == 0
           and all(v.data_ptr() % 16 == 0 for v in (x, *out)))
    return t, (_DTYPES[x.dtype], batch, channels, length, t.rows_per_block,
               t.span, t.n_col, t.blocks, int(vec))


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"aa_act {what} kernel launch failed: CUDA error "
                           f"{rc}")


def _forward_cuda(x, a, b):
    _check_cuda(x, a, b)
    lib = _library()
    taps = _filter(1, x.device, torch.float32)
    y = torch.empty_like(x)
    _, args = _launch_args(x, y)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.aa_act_forward(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                                taps.data_ptr(), y.data_ptr(), *args, stream)
    _raise_on(rc, "forward")
    aa_act_kernel.n_calls += 1
    return y


def _backward_cuda(x, a, b, gy, needs):
    _check_cuda(x, a, b)
    gy = gy.contiguous()  # autograd gives y's dtype and shape, maybe expanded
    lib = _library()
    taps = _filter(1, x.device, torch.float32)
    gx = torch.empty_like(x) if needs[0] else None
    ga = torch.empty_like(a) if needs[1] else None
    gb = torch.empty_like(b) if needs[2] else None
    tiles, args = _launch_args(x, gy, *([gx] if gx is not None else []))
    partial = None
    if ga is not None or gb is not None:
        partial = torch.empty(tiles.partial_words, dtype=torch.float32,
                              device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.aa_act_backward(x.data_ptr(), gy.data_ptr(), a.data_ptr(),
                                 b.data_ptr(), taps.data_ptr(), ptr(gx),
                                 ptr(partial), ptr(ga), ptr(gb), *args,
                                 stream)
    _raise_on(rc, "backward")
    aa_act_kernel.n_calls += 1 if partial is None else 2
    return gx, ga, gb


class _AASnakeBeta(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b):
        ctx.save_for_backward(x, a, b)
        ctx.capture = current_capture()
        aa_act.n_calls += 1
        with region("aa_act.fwd"):
            if x.is_cuda:
                return _forward_cuda(x, a, b)
            return _forward(x, a, b).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, a, b = ctx.saved_tensors
        with join_capture(ctx.capture), region("aa_act.bwd"):
            if x.is_cuda:
                return _backward_cuda(x, a, b, gy, ctx.needs_input_grad)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(need) for t, need in
                          zip((x, a, b), ctx.needs_input_grad)]
                y = _forward(*leaves)
                asked = [t for t in leaves if t.requires_grad]
                grads = iter(torch.autograd.grad(y, asked, gy.to(y.dtype)))
                return tuple(next(grads).to(t.dtype) if t.requires_grad
                             else None for t in leaves)


def aa_snake_beta(x: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Anti-aliased SnakeBeta of ``x [B, C, L]`` with the log-scale
    ``a``, ``b`` ``[C]`` (the module's docstring); ``x``'s dtype out."""
    return _AASnakeBeta.apply(x, a, b)
