"""Card-only tests of the anti-aliased SnakeBeta kernel (``csrc/aa_act.cu``,
launched by ``ops/alias_free.py`` for CUDA tensors) against the plain
version of the same module.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and skips
without one. This file imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_aa_act_gpu.py --noconftest -q

Shapes: BigVGAN's six activation shapes at batch 2, each under the
wrapper's own tiles for that batch and under the tiles of batch 32 (what
training runs); lengths 1, 2 and 7 (shorter than a tile's 8 outputs), 2100
(not a multiple of the span, nor of 8: the one-by-one loads and stores) and
2104 (not a multiple of the span, 16-byte loads and stores), on 3 channels.

Tolerances, each against the plain version evaluated in float64 on the
same inputs (the exact answer to the kernel's arithmetic):

- fp32 input, ``y``, ``gx``, ``ga`` and ``gb``: the kernel and the plain
  version in fp32 (cuDNN's TF32 off) compute the same fp32 arithmetic in
  other orders, so their errors are of one size: the kernel's max abs
  error may be 4 times the plain version's, plus 1e-6 of the largest
  magnitude (for a case where the plain version rounds luckily).
- bf16 input, ``y`` and ``gx``: the kernel rounds its fp32 result once to
  bf16, half a bf16 unit, at most 2^-8 of the value: that, elementwise,
  plus twice the fp32 tolerance. ``ga`` and ``gb`` are fp32 sums from
  the bf16 inputs: the fp32 tolerance.

Inputs past sinf's fast range (``|alpha u|`` over 105615, where the kernel
reduces the argument modulo pi itself; past 2^42, where sinf takes its own
path): x scaled to 1.5e5 to 1e10, and rows whose blocks of 16 samples cycle
through scales 1 to 1e13. There the fp32 rounding of ``alpha u`` moves the
sines by up to a radian or more, so the tolerance is a rounding bound
(``_rounding_bounds``), elementwise for ``y`` and ``gx`` and per channel for
``ga`` and ``gb``: each fp32 sum of n terms may err by n units of roundoff of
the sum of the terms' magnitudes (12 for the filters, 2^8 for the
parameters' sums), and each sine by as much as its argument's error can move
it, at most its whole range. The plain version in fp32 is held to the same
bound, which shows the bound is not tighter than fp32 allows. Where
``|alpha u|`` is under about 1e6 the bound is tight enough that a reduced
argument off by a quarter of a radian exceeds it (``gx`` by 1.1-4 times,
checked on the CPU with the plain version so broken); past that, fp32's own
rounding of ``alpha u`` is a radian or more and the sines carry no
information the float64 version shares, so the bound holds the outputs
finite and their fp32 parts as exact as fp32 allows.
"""

import pytest
import torch

from music_synthesis_tpu_torch.ops import alias_free as af

pytestmark = pytest.mark.gpu

BIGVGAN_SHAPES = [(2, 768, 128), (2, 384, 512), (2, 192, 1024),
                  (2, 96, 2048), (2, 48, 4096), (2, 24, 8192)]
ODD_SHAPES = [(2, 3, 1), (2, 3, 2), (2, 3, 7), (2, 3, 2100), (2, 3, 2104)]
FP32_FACTOR, FP32_FLOOR = 4.0, 1e-6
BF16_HALF_UNIT = 2.0 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen)
    gy = torch.randn(shape, generator=gen)
    a, b = (0.3 * torch.randn(shape[1], generator=gen) for _ in range(2))
    return (x.to(dtype).to(device), a.to(device), b.to(device),
            gy.to(dtype).to(device))


def _plain(x, a, b, gy, dtype):
    """``(y, gx, ga, gb)`` of the plain version in ``dtype`` from the same
    values, cuDNN's TF32 off."""
    leaves = [t.detach().to(dtype).requires_grad_() for t in (x, a, b)]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = af._forward(*leaves)
        grads = torch.autograd.grad(y, leaves, gy.to(dtype))
    return [y.detach(), *grads]


def _kernel(x, a, b, gy):
    leaves = [t.detach().requires_grad_() for t in (x, a, b)]
    y = af.aa_snake_beta(*leaves)
    return [y.detach(), *torch.autograd.grad(y, leaves, gy)]


def _err(got, want):
    return float((got.double() - want).abs().max())


def _check(x, a, b, gy):
    want = _plain(x, a, b, gy, torch.float64)
    plain = _plain(x, a, b, gy, torch.float32)
    before = af.aa_act_kernel.n_calls
    got = _kernel(x, a, b, gy)
    torch.cuda.synchronize()
    assert af.aa_act_kernel.n_calls - before == 3  # forward; backward, sums
    for name, g, p, w in zip(("y", "gx", "ga", "gb"), got, plain, want):
        assert g.dtype == (x.dtype if name in ("y", "gx") else torch.float32)
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        tol = FP32_FACTOR * _err(p, w) + FP32_FLOOR * float(w.abs().max())
        if x.dtype == torch.bfloat16 and name in ("y", "gx"):
            bound = BF16_HALF_UNIT * w.abs() + 2 * tol
            over = (g.double() - w).abs() - bound
            assert float(over.max()) <= 0, (name, float(over.max()))
        else:
            assert _err(g, w) <= tol, (name, _err(g, w), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tiles", ["own", "batch32"])
@pytest.mark.parametrize("shape", BIGVGAN_SHAPES)
def test_kernel_matches_the_plain_version_at_bigvgan_shapes(
        cuda, monkeypatch, shape, tiles, dtype):
    if tiles == "batch32":
        n_sm = af._n_sm(cuda)
        t32 = af.tiling(32 * shape[1], shape[2], n_sm)
        monkeypatch.setattr(af, "tiling", lambda rows, length, _: af.Tiling(
            rows, length, t32.rows_per_block, t32.span))
    _check(*_inputs(shape, dtype, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_kernel_matches_the_plain_version_at_odd_lengths(cuda, shape, dtype):
    _check(*_inputs(shape, dtype, cuda, seed=1))


U32 = 2.0 ** -24  # fp32's unit roundoff
SUM_DEPTH = 2.0 ** 8  # roundings a parameter's fp32 sum may chain, at most
MIXED_SCALES = (1.0, 1e5, 1e6, 1e8, 1e10, 1e13)


def _large_inputs(scale, dtype, device, shape=(2, 24, 8192), seed=4):
    """``_inputs`` with x scaled by ``scale``, or ("mixed") each block of 16
    samples of a row by the next of ``MIXED_SCALES``."""
    x, a, b, gy = _inputs(shape, torch.float32, "cpu", seed)
    if scale == "mixed":
        block = torch.arange(shape[-1]) // 16 % len(MIXED_SCALES)
        x = x * torch.tensor(MIXED_SCALES)[block]
    else:
        x = x * float(scale)
    return (x.to(dtype).to(device), a.to(device), b.to(device),
            gy.to(dtype).to(device))


def _rounding_bounds(x, a, b, gy):
    """Bounds on ``|y - y64|``, ``|gx - gx64|`` (elementwise) and on the
    parameters' gradients (per channel) for an fp32 evaluation of the
    activation, in float64 from the magnitudes of each sum's terms: the
    filters' sums through the filters' absolute taps (``U|h|``, ``D|h|`` and
    their transposes, pads and folds included), the sines' errors from
    their arguments' (``dtheta``: the upsampling's 12 roundings of ``V``,
    ``alpha``'s and the product's of ``|theta|``), capped at each sine's
    range."""
    dev, channels = x.device, x.shape[1]
    h = af.kaiser_sinc().to(dev).view(1, 1, -1).expand(channels, 1, -1)
    habs = h.abs()
    xd, gyd = x.double(), gy.double()
    alpha = torch.exp(a.double())[:, None]
    beta = torch.exp(b.double())[:, None]
    inv = 1.0 / (beta + 1e-9)

    def transpose(fn, shape, w):
        z = torch.zeros(shape, dtype=torch.float64, device=dev,
                        requires_grad=True)
        return torch.autograd.grad(fn(z), z, w)[0]

    def up_t(w):  # U|h|^T, the factor 2 and the pad's fold in
        return transpose(lambda z: af.upsample2(z, habs), xd.shape, w)

    double = (*xd.shape[:2], 2 * xd.shape[2])
    v = af.upsample2(xd, h)
    big_v = af.upsample2(xd.abs(), habs)
    theta = alpha * v
    dtheta = alpha * 12 * U32 * big_v + theta.abs() * 8 * U32
    ds1 = dtheta.clamp(max=1.0) + 4 * U32  # sin^2
    ds2 = (2 * dtheta).clamp(max=2.0) + 4 * U32  # sin(2 theta)
    big_s = big_v + inv
    ds = 12 * U32 * big_v + inv * ds1 + 8 * U32 * big_s
    tol_y = (af.downsample2(ds, habs)
             + 12 * U32 * af.downsample2(big_s, habs))
    big_gs = transpose(lambda z: af.downsample2(z, habs), double, gyd.abs())
    big_c = 1.0 + alpha * inv
    dc = alpha * inv * ds2 + 8 * U32 * big_c
    dgu = 16 * U32 * big_gs * big_c + big_gs * dc
    tol_gx = up_t(dgu) + 12 * U32 * up_t(big_gs * big_c)
    big_ta = big_gs * big_v * alpha * inv
    dta = (alpha * inv * big_gs * (24 * U32 * big_v + big_v * ds2)
           + 8 * U32 * big_ta)
    tol_ga = (dta + SUM_DEPTH * U32 * big_ta).sum(dim=(0, 2))
    dtb = big_gs * (20 * U32 + ds1)
    tol_gb = ((beta * inv * inv)[:, 0]
              * (dtb + SUM_DEPTH * U32 * big_gs).sum(dim=(0, 2)))
    return tol_y, tol_gx, tol_ga, tol_gb


def _check_rounding_bound(got, want, tols, dtype):
    """Each of ``got`` (y, gx, ga, gb) against ``want`` (float64) within
    ``tols``, and y and gx also within half a bf16 unit when ``dtype`` is
    bf16."""
    for name, g, w, tol in zip(("y", "gx", "ga", "gb"), got, want, tols):
        assert torch.isfinite(g).all(), name
        bound = tol * (1 + 8 * U32)
        if dtype == torch.bfloat16 and name in ("y", "gx"):
            bound = bound + BF16_HALF_UNIT * (w.abs() + tol)
        over = (g.double() - w).abs() - bound
        assert float(over.max()) <= 0, (name, float(over.max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", ["1.5e5", "1e6", "1e8", "1e10", "mixed"])
def test_kernel_past_the_sines_fast_range(cuda, scale, dtype):
    """Where ``|alpha u|`` passes 105615 (the kernel's own reduction modulo
    pi) and 2^42 (sinf's), the kernel and the plain version in fp32 both
    lie within the rounding bound of the float64 plain version; in the
    mixed rows the samples in range are held as tightly as elsewhere."""
    x, a, b, gy = _large_inputs(scale, dtype, cuda)
    want = _plain(x, a, b, gy, torch.float64)
    tols = _rounding_bounds(x, a, b, gy)
    _check_rounding_bound(_plain(x, a, b, gy, torch.float32), want, tols,
                          torch.float32)
    _check_rounding_bound(_kernel(x, a, b, gy), want, tols, dtype)


@pytest.mark.parametrize("asked", [(True, False, False), (False, True, True),
                                   (False, False, True)])
def test_backward_computes_only_what_is_asked(cuda, asked):
    """Each subset of the gradients, from one backward launch (and the sums'
    when ``a`` or ``b`` asks), equals the same gradients asked together."""
    x, a, b, gy = _inputs((2, 48, 4096), torch.bfloat16, cuda, seed=2)
    full = _kernel(x, a, b, gy)[1:]
    leaves = [t.detach().requires_grad_(need)
              for t, need in zip((x, a, b), asked)]
    before = af.aa_act_kernel.n_calls
    y = af.aa_snake_beta(*leaves)
    grads = torch.autograd.grad(y, [t for t in leaves if t.requires_grad],
                                gy)
    assert af.aa_act_kernel.n_calls - before == 2 + (asked[1] or asked[2])
    want = [f for f, need in zip(full, asked) if need]
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_replays_give_the_same_bits(cuda, dtype):
    """A captured forward and backward, replayed twice from one state, gives
    the same bits both times and the bits of the eager call: the kernel
    sums alpha's and beta's gradients in a fixed order, with no atomics."""
    x, a, b, gy = _inputs((4, 96, 2048), dtype, cuda, seed=3)
    eager = _kernel(x, a, b, gy)
    # The graphed leaves are first used on a side stream, as a capture
    # needs (autograd keeps the stream of a leaf's first use).
    leaves = [t.detach().requires_grad_() for t in (x, a, b)]

    def step():
        y = af.aa_snake_beta(*leaves)
        return [y, *torch.autograd.grad(y, leaves, gy)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in out])
    for first, second, e in zip(*replays, eager):
        assert torch.equal(_bits(first), _bits(second))
        assert torch.equal(_bits(first), _bits(e))


@pytest.mark.parametrize("case", ["float16", "float64", "strided", "2d",
                                  "a_on_cpu", "b_bf16"])
def test_kernel_refuses_what_it_does_not_take(cuda, case):
    """A CUDA input the kernel does not take raises (there is no fallback
    to the plain version), and nothing is launched."""
    x, a, b, _ = _inputs((2, 3, 16), torch.float32, cuda)
    error = ValueError
    if case == "float16":
        x, error = x.half(), TypeError
    elif case == "float64":
        x, error = x.double(), TypeError
    elif case == "strided":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "2d":
        x = x[0]
    elif case == "a_on_cpu":
        a = a.cpu()
    else:
        b = b.bfloat16()
    before = af.aa_act_kernel.n_calls
    with pytest.raises(error):
        af.aa_snake_beta(x, a, b)
    assert af.aa_act_kernel.n_calls == before
