"""Grouped, strided 1-D convolutions on the card (``csrc/grouped_conv.cu``).

``ops.conv.GroupedConv`` sends every 1-D CUDA call here: the forward
``y = conv(x, w) + b`` on an input ``WNConv`` has already padded, the input
gradient (the transposed convolution onto the padded input, as
``convolution_backward`` returns it) and the weight and bias gradients.
Each is fp32 sums in a fixed order rounded once to the working type (fp32
or bf16): no atomics, so a graph's replay gives the bits of the eager call.
Launches: one for the forward, one for the input gradient, and for the
weight and bias gradients one that writes fp32 partial sums (when the
weight gradient is asked for) and one that finishes them and sums the
bias's; ``grouped_conv_kernel.n_calls`` counts them (``_graphs`` keeps the
count per replay). A CPU tensor never comes here: ``GroupedConv`` keeps
the aten calls there.

The tiles come from ``plan_forward``, ``plan_input_grad`` and
``plan_weight_grad``, functions of the shape and the card's SM count that
the kernels check; what each tile holds is written in the kernel's
source, and its shared memory is asked of the library, which lays it
out. What the kernels do not take (another dtype, a dilation, a shape
whose tile cannot fit a block) raises, as does a launch the card refuses.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from music_synthesis_tpu_torch import _build
from music_synthesis_tpu_torch.utils.profiling import counter

__all__ = ["Conv", "ForwardPlan", "InputGradPlan", "WeightGradPlan",
           "conv_of", "plan_forward", "plan_input_grad", "plan_weight_grad",
           "forward", "input_grad", "weight_grad", "grouped_conv_kernel"]

#: Launches of ``csrc/grouped_conv.cu``'s kernels: up by one per launch
#: here, and in ``_graphs.GraphedProgram`` by what its capture issued at
#: each replay.
grouped_conv_kernel = counter("grouped_conv_kernel")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # a block's threads (kThreads)
_SMEM_MAX = 227 * 1024  # bytes of shared memory a block may take (kMaxSmem)
_PER_THREAD = (16, 8, 4, 2, 1)  # outputs or input channels a thread
UPT = 8  # forward, input gradient: consecutive t (q) a thread (kUpt)
J_MAX = 16  # taps of a phase, ceil(kernel / stride), at most (kJMax)
_PAIR_THREADS = 128  # forward, input gradient: a block's threads, about
_MIN_THREADS_PER_SM = 512  # fewer threads than this a SM: fewer a thread
_T_TILE = 128  # forward: outputs a block takes along t, at most
_Q_TILE = 64  # input gradient: positions a phase a block takes, at most
_WT_TILE = 64  # weight gradient: t a tile, at most
_BLOCKS_PER_SM = 4  # fewer blocks than this a SM: smaller tiles


def _div_up(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(n: int, k: int) -> int:
    return _div_up(n, k) * k


@dataclasses.dataclass(frozen=True)
class Conv:
    """One call's shape: ``x [batch, groups * ci, length]`` (padded),
    ``w [groups * co, ci, kernel]``, ``y [batch, groups * co, out]``."""

    batch: int
    groups: int
    ci: int
    co: int
    kernel: int
    stride: int
    length: int

    @property
    def out(self) -> int:
        return (self.length - self.kernel) // self.stride + 1

    @property
    def flops(self) -> int:
        """Multiply-adds of the forward (as of each gradient), times 2."""
        return (2 * self.batch * self.groups * self.co * self.out * self.ci
                * self.kernel)


def _per_thread(n: int, most: int = 16) -> int:
    return next(k for k in _PER_THREAD if k <= most and n % k == 0)


def _smem(kind: int, itemsize: int, conv: Conv, a: int, b: int,
          c: int) -> int:
    """Shared memory bytes of a launch as ``csrc/grouped_conv.cu`` lays it
    out, asked of the library (``grouped_conv_smem``): kind 0 the forward
    (``a, b, c`` = gt, nb, tt), 1 the input gradient (gt, nb, qq), 2 the
    weight gradient (gt, tt, nb); ``itemsize`` x's bytes an element."""
    return _library().grouped_conv_smem(
        kind, 0 if itemsize == 4 else 1, conv.groups, conv.ci, conv.co,
        conv.kernel, conv.stride, a, b, c)


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """A block takes ``nb`` batch rows, ``gt`` groups and ``tt`` outputs
    of each; a thread ``opt`` output channels of one group at ``UPT``
    consecutive t. ``itemsize``: x's bytes an element."""

    conv: Conv
    opt: int
    gt: int
    nb: int
    tt: int
    itemsize: int = 2

    @property
    def threads(self) -> int:
        return self.nb * self.gt * (self.conv.co // self.opt) * (self.tt
                                                                  // UPT)

    @property
    def blocks(self) -> int:
        c = self.conv
        return (_div_up(c.batch, self.nb) * _div_up(c.groups, self.gt)
                * _div_up(c.out, self.tt))

    @property
    def smem_bytes(self) -> int:
        return _smem(0, self.itemsize, self.conv, self.gt, self.nb, self.tt)


@dataclasses.dataclass(frozen=True)
class InputGradPlan:
    """A block takes ``nb`` batch rows, ``gt`` groups and the positions
    ``stride * q0 .. stride * (q0 + qq) - 1``; a thread ``cpt`` input
    channels of one group at ``UPT`` consecutive positions of one phase."""

    conv: Conv
    cpt: int
    gt: int
    nb: int
    qq: int
    itemsize: int = 2

    @property
    def threads(self) -> int:
        c = self.conv
        return (self.nb * self.gt * (c.ci // self.cpt) * c.stride
                * (self.qq // UPT))

    @property
    def blocks(self) -> int:
        c = self.conv
        return (_div_up(c.batch, self.nb) * _div_up(c.groups, self.gt)
                * _div_up(_div_up(c.length, c.stride), self.qq))

    @property
    def smem_bytes(self) -> int:
        return _smem(1, self.itemsize, self.conv, self.gt, self.nb, self.qq)


@dataclasses.dataclass(frozen=True)
class WeightGradPlan:
    """A block takes ``gt`` groups and a run of ``bps`` batch rows, ``nb``
    rows by ``tt`` t's a load; a thread one (c, k) and ``opt`` output
    channels of one group. ``splits`` runs of rows write fp32 partials
    (``partial_words``) that the finishing launch adds in order."""

    conv: Conv
    opt: int
    gt: int
    tt: int
    nb: int
    bps: int

    @property
    def threads(self) -> int:
        c = self.conv
        return self.gt * (c.co // self.opt) * c.ci * c.kernel

    @property
    def splits(self) -> int:
        return _div_up(self.conv.batch, self.bps)

    @property
    def blocks(self) -> int:
        return _div_up(self.conv.groups, self.gt) * self.splits

    @property
    def partial_words(self) -> int:
        c = self.conv
        return self.splits * c.groups * c.co * c.ci * c.kernel

    @property
    def smem_bytes(self) -> int:
        return _smem(2, 4, self.conv, self.gt, self.tt, self.nb)


def _rows_and_groups(make, per_pair: int, conv: Conv, n_sm: int):
    """The plan ``make(gt, nb)`` with about ``_PAIR_THREADS`` threads a
    block: as many batch rows as fit, in equal runs, then groups; fewer
    while its shared memory does not fit a block or the grid has fewer
    blocks than the card has SMs."""
    pairs = max(1, _PAIR_THREADS // per_pair)
    while True:
        nb = _div_up(conv.batch, _div_up(conv.batch, min(conv.batch, pairs)))
        gt = max(1, min(conv.groups, pairs // nb))
        p = make(gt, nb)
        if p.smem_bytes <= _SMEM_MAX and (p.blocks >= n_sm or pairs == 1):
            return p
        if pairs == 1:
            raise ValueError(f"no tile of the grouped convolution {conv} "
                             f"fits a block's shared memory")
        pairs //= 2


def _check_taps(conv: Conv) -> None:
    if _div_up(conv.kernel, conv.stride) > J_MAX:
        raise ValueError(f"the grouped convolution kernel takes at most "
                         f"{J_MAX} taps a phase (kernel / stride), got "
                         f"{conv.kernel} / {conv.stride}")


def _per_thread_for(n: int, most: int, threads_at, n_sm: int) -> int:
    """The most of ``n``'s channels a thread (``_per_thread``, at most
    ``most``), fewer while ``threads_at(k)`` gives the call fewer than
    ``_MIN_THREADS_PER_SM`` threads a SM."""
    k = _per_thread(n, most)
    while k > 1 and threads_at(k) < _MIN_THREADS_PER_SM * n_sm:
        k = _per_thread(n, k // 2)
    return k


@functools.lru_cache(maxsize=256)
def plan_forward(conv: Conv, n_sm: int, itemsize: int = 2) -> ForwardPlan:
    """The forward's tiles: up to 4 outputs a thread (the most that
    divides ``co``, fewer where the call has few threads) at ``UPT``
    consecutive t, up to ``_T_TILE`` outputs a block along t in equal tiles
    (multiples of ``UPT``), and batch rows and groups until a block has
    about ``_PAIR_THREADS`` threads."""
    _check_taps(conv)
    n_t = _div_up(conv.out, UPT)
    opt = _per_thread_for(conv.co, 4, lambda k: (
        conv.batch * conv.groups * conv.co // k * n_t), n_sm)
    chunks = conv.co // opt
    if chunks > _THREADS // UPT:
        raise ValueError(f"the grouped convolution kernel takes at most "
                         f"{8 * _THREADS // UPT} outputs a group, got "
                         f"{conv.co}")
    tt = _round_up(_div_up(conv.out, _div_up(conv.out, _T_TILE)), UPT)
    tt = min(tt, _THREADS // chunks // UPT * UPT)
    return _rows_and_groups(
        lambda gt, nb: ForwardPlan(conv, opt, gt, nb, tt, itemsize),
        chunks * tt // UPT, conv, n_sm)


@functools.lru_cache(maxsize=256)
def plan_input_grad(conv: Conv, n_sm: int,
                    itemsize: int = 2) -> InputGradPlan:
    """The input gradient's tiles: up to 4 input channels a thread (fewer
    where the call has few threads) at ``UPT`` consecutive positions of a
    phase, ``stride * qq`` positions a block (qq a multiple of ``UPT``, at
    most ``_Q_TILE``, in equal tiles), and batch rows and groups until a
    block has about ``_PAIR_THREADS`` threads."""
    _check_taps(conv)
    q = _div_up(conv.length, conv.stride)
    cpt = _per_thread_for(conv.ci, 4, lambda k: (
        conv.batch * conv.groups * conv.ci // k * conv.stride
        * _div_up(q, UPT)), n_sm)
    per_q = (conv.ci // cpt) * conv.stride
    if per_q > _THREADS // UPT:
        raise ValueError(f"the grouped convolution kernel takes at most "
                         f"{_THREADS // UPT} input channels times stride a "
                         f"group, got {conv.ci} x {conv.stride}")
    qq = _round_up(_div_up(q, _div_up(q, _Q_TILE)), UPT)
    qq = min(qq, _THREADS // per_q // UPT * UPT)
    return _rows_and_groups(
        lambda gt, nb: InputGradPlan(conv, cpt, gt, nb, qq, itemsize),
        per_q * qq // UPT, conv, n_sm)


@functools.lru_cache(maxsize=256)
def plan_weight_grad(conv: Conv, n_sm: int) -> WeightGradPlan:
    """The weight gradient's tiles: a thread per (c, k) and up to 16
    outputs, as many groups a block as 256 threads hold, t in tiles of up
    to ``_WT_TILE`` and up to ``_WT_TILE * 4 / tt`` batch rows a load, and
    the batch cut into runs until the grid has ``_BLOCKS_PER_SM`` blocks a
    SM."""
    opt = _per_thread(conv.co)
    per_group = (conv.co // opt) * conv.ci * conv.kernel
    if per_group > _THREADS:
        raise ValueError(f"the grouped convolution kernel's weight gradient "
                         f"takes at most {_THREADS} (output chunks x ci x "
                         f"kernel) a group, got {per_group}")
    tt = min(_round_up(conv.out, 8), _WT_TILE)
    gt = max(1, min(conv.groups, _THREADS // per_group))
    n_g = _div_up(conv.groups, gt)
    splits = min(conv.batch, max(1, _div_up(_BLOCKS_PER_SM * n_sm, n_g)))
    bps = _div_up(conv.batch, splits)
    nb = max(1, min(bps, 4 * _WT_TILE // tt))
    while nb > 1 and WeightGradPlan(conv, opt, gt, tt, nb, bps
                                    ).smem_bytes > _SMEM_MAX:
        nb -= 1
    p = WeightGradPlan(conv, opt, gt, tt, nb, bps)
    if p.smem_bytes > _SMEM_MAX:
        raise ValueError(f"no tile of the grouped convolution {conv} fits "
                         f"a block's shared memory")
    return p


def conv_of(x_shape, w_shape, stride, dilation, groups: int) -> Conv:
    """The ``Conv`` of a padded input ``[B, Cin, L]`` and a kernel
    ``[Cout, Cin / groups, K]``; raises on what the kernels do not take:
    another rank, a dilation, a tensor of 2**31 elements or more."""
    stride, dilation = tuple(stride), tuple(dilation)
    x_shape, w_shape = tuple(x_shape), tuple(w_shape)
    if len(x_shape) != 3 or len(w_shape) != 3 or len(stride) != 1:
        raise ValueError(f"the grouped convolution kernel is 1-D, got x "
                         f"{x_shape} and w {w_shape}")
    if dilation != (1,):
        raise ValueError(f"the grouped convolution kernel takes dilation 1, "
                         f"got {dilation}")
    batch, cin, length = x_shape
    cout, ci, kernel = w_shape
    if (groups < 1 or cin % groups or cout % groups or ci != cin // groups
            or stride[0] < 1 or min(batch, kernel) < 1 or length < kernel):
        raise ValueError(f"no grouped convolution of x {x_shape} with w "
                         f"{w_shape}, groups {groups}, stride {stride[0]}")
    conv = Conv(batch, groups, ci, cout // groups, kernel, stride[0], length)
    if max(batch * cin * length, batch * cout * conv.out,
           cout * ci * kernel) >= 2 ** 31:
        raise ValueError(f"the grouped convolution {conv} has 2**31 "
                         f"elements or more in one tensor")
    return conv


def _check(dtype_of: torch.Tensor, **tensors) -> None:
    """Raises unless every tensor given has ``dtype_of``'s dtype (fp32 or
    bf16) and device, and those named ``x``, ``gy`` are contiguous."""
    if dtype_of.dtype not in _DTYPES:
        raise TypeError(f"the grouped convolution kernel takes float32 or "
                        f"bfloat16, got {dtype_of.dtype}")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.dtype != dtype_of.dtype or t.device != dtype_of.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, not "
                            f"{dtype_of.dtype} on {dtype_of.device}")
        if name in ("x", "gy") and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=8)
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1)
def _library():
    """``csrc/grouped_conv.cu``'s C functions, built and bound at first
    use."""
    lib = _build.load("grouped_conv")
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.grouped_conv_forward.argtypes = [ptr] * 4 + [i32] * 17 + [ptr]
    lib.grouped_conv_input_grad.argtypes = [ptr] * 3 + [i32] * 18 + [ptr]
    lib.grouped_conv_smem.argtypes = [i32] * 10
    lib.grouped_conv_smem.restype = ctypes.c_longlong
    lib.grouped_conv_weight_grad.argtypes = [ptr] * 5 + [i32] * 16 + [ptr]
    for fn in (lib.grouped_conv_forward, lib.grouped_conv_input_grad,
               lib.grouped_conv_weight_grad):
        fn.restype = i32
    return lib


def _vec(length: int, step: int, *tensors: torch.Tensor) -> int:
    """1 where 16-byte accesses fit: rows of ``length`` and tile starts at
    multiples of ``step`` lie on 16-byte boundaries of every tensor."""
    per = 16 // tensors[0].element_size()
    return int(length % per == 0 and step % per == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch(fn, *args, device: torch.device, what: str, launches: int):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"grouped convolution {what} kernel launch "
                           f"failed: CUDA error {rc}")
    grouped_conv_kernel.n_calls += launches


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _shape_args(conv: Conv, w_strides=(0, 0, 0)):
    return (conv.batch, conv.groups, conv.ci, conv.co, conv.kernel,
            conv.stride, conv.length, conv.out, *w_strides)


def forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
            stride, dilation, groups: int) -> torch.Tensor:
    """``F.conv1d(x, w, b, stride, 0, dilation, groups)`` in one launch:
    x contiguous, w any strides, b ``[Cout]`` or None."""
    _check(x, x=x, w=w, b=b)
    conv = conv_of(x.shape, w.shape, stride, dilation, groups)
    if b is not None and tuple(b.shape) != (conv.groups * conv.co,):
        raise ValueError(f"b must be [{conv.groups * conv.co}], got "
                         f"{tuple(b.shape)}")
    p = plan_forward(conv, _n_sm(x.device), x.element_size())
    y = torch.empty(conv.batch, conv.groups * conv.co, conv.out,
                    dtype=x.dtype, device=x.device)
    _launch(_library().grouped_conv_forward, x.data_ptr(), w.data_ptr(),
            _ptr(b), y.data_ptr(), _DTYPES[x.dtype],
            *_shape_args(conv, w.stride()), p.opt, p.gt, p.nb, p.tt,
            _vec(conv.length, conv.stride * p.tt, x), device=x.device,
            what="forward", launches=1)
    return y


def _check_gy(gy: torch.Tensor, conv: Conv) -> None:
    if tuple(gy.shape) != (conv.batch, conv.groups * conv.co, conv.out):
        raise ValueError(f"gy {tuple(gy.shape)} is not the output of {conv}")


def input_grad(gy: torch.Tensor, w: torch.Tensor, length: int, stride,
               dilation, groups: int) -> torch.Tensor:
    """The gradient of ``forward``'s padded input ``[B, Cin, length]`` from
    ``gy`` (contiguous) and ``w`` (any strides), in one launch."""
    _check(gy, gy=gy, w=w)
    conv = conv_of((gy.shape[0], w.shape[1] * groups, length), w.shape,
                   stride, dilation, groups)
    _check_gy(gy, conv)
    p = plan_input_grad(conv, _n_sm(gy.device), gy.element_size())
    gx = torch.empty(conv.batch, conv.groups * conv.ci, length,
                     dtype=gy.dtype, device=gy.device)
    _launch(_library().grouped_conv_input_grad, gy.data_ptr(), w.data_ptr(),
            gx.data_ptr(), _DTYPES[gy.dtype], *_shape_args(conv, w.stride()),
            p.cpt, p.gt, p.nb, p.qq, _vec(conv.out, p.qq, gy),
            _vec(length, conv.stride * p.qq, gx), device=gy.device,
            what="input gradient", launches=1)
    return gx


def weight_grad(gy: torch.Tensor, x: torch.Tensor, w_shape, stride,
                dilation, groups: int, need_w: bool, need_b: bool):
    """``(gw, gb)`` of ``forward`` from ``gy`` and ``x`` (both contiguous),
    each None unless asked for: gw ``w_shape`` contiguous, gb ``[Cout]``,
    in x's dtype; one launch for the partial sums when gw is asked for,
    one to finish them and sum gb."""
    _check(x, x=x, gy=gy)
    conv = conv_of(x.shape, w_shape, stride, dilation, groups)
    _check_gy(gy, conv)
    if not (need_w or need_b):
        return None, None
    p = plan_weight_grad(conv, _n_sm(x.device))
    gw = (torch.empty(tuple(w_shape), dtype=x.dtype, device=x.device)
          if need_w else None)
    gb = (torch.empty(conv.groups * conv.co, dtype=x.dtype, device=x.device)
          if need_b else None)
    partial = (torch.empty(p.partial_words, dtype=torch.float32,
                           device=x.device) if need_w else None)
    _launch(_library().grouped_conv_weight_grad, x.data_ptr(),
            gy.data_ptr(), _ptr(partial), _ptr(gw), _ptr(gb),
            _DTYPES[x.dtype], *_shape_args(conv)[:8], p.opt, p.gt, p.tt,
            p.nb, p.bps, _vec(conv.length, conv.stride * p.tt, x),
            _vec(conv.out, p.tt, gy), device=x.device,
            what="weight gradient", launches=2 if need_w else 1)
    return gw, gb
