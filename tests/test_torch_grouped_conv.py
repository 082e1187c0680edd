"""``ops.conv.GroupedConv`` against PyTorch's native grouped convolution,
on the CPU.

- Values: at the MSD's grouped layers (kernel 41, stride 4, "same"
  padding, bias; groups 4, 64, 256), the forward, R1's input gradient
  (``create_graph``) and the second-order gradients of an R1-style loss
  into the kernel and the bias equal native ``F.conv1d``'s to 1e-12 of
  each tensor's norm in float64. In bf16 the forward and the input
  gradient are bit for bit (the same calls); the second-order gradients
  are within bf16's unit roundoff (2**-8) of the norm: only the weight
  term's call differs (one grouped weight-gradient call against a
  convolution per group), 2.1e-5 at most when the test was written.
- Dispatch: R1's double backward through the flagship's
  ``MultiScaleDiscriminator`` (fp32, [1, 8192]) issues as many
  convolutions at groups (4, 16, 64, 256) as at (4, 16, 32, 128), where
  native autograd issues one per group (996 against 516); a first-order
  backward without grad mode (the D step without R1) dispatches the very
  aten calls native autograd does, masks included.
- The count: a stage-2 step with R1 issues one second-order weight term
  per grouped (not dense) layer and scale, read from
  ``tracer.snapshot()["counters"]``.
"""

import collections
import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils._python_dispatch import TorchDispatchMode

from music_synthesis_tpu_torch.config import TINY, MSDConfig
from music_synthesis_tpu_torch.models.discriminators import (
    MultiScaleDiscriminator,
)
from music_synthesis_tpu_torch.ops import conv
from music_synthesis_tpu_torch.train import stage2
from music_synthesis_tpu_torch.train.flagship import FLAGSHIP_SECTIONS
from music_synthesis_tpu_torch.utils.profiling import tracer

torch.set_num_threads(1)

# (in, out) channels of the flagship MSD's layer with these groups.
WIDTHS = {4: (16, 64), 64: (256, 1024), 256: (1024, 1024)}


def _native(x, w, b, stride, dilation, groups):
    return F.conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups)


@pytest.fixture
def native_grouped(monkeypatch):
    """Within the test, ``WNConv`` runs grouped layers on ``F.conv1d``, as
    before ``GroupedConv``."""
    def use():
        monkeypatch.setattr(conv.GroupedConv, "apply", _native)
    return use


class _Dispatched(TorchDispatchMode):
    """Records each aten call's name, and a ``convolution_backward``'s
    output mask."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.calls.append((name, tuple(args[-1])
                           if name == "convolution_backward" else None))
        return func(*args, **(kwargs or {}))


def _r1_grads(groups, dtype, apply):
    """The layer's output, R1's input gradient and the second-order
    gradients of ``sum(gx^2) + mean(y)`` into the kernel and the bias,
    from float64 leaves cast to ``dtype`` (the kernel and bias through an
    op, as weight norm and the bf16 cast make them)."""
    cin, cout = WIDTHS[groups]
    gen = torch.Generator().manual_seed(groups)
    x = torch.randn(2, cin, 256, generator=gen, dtype=torch.float64)
    x.requires_grad_()
    v = torch.randn(cout, cin // groups, 41, generator=gen,
                    dtype=torch.float64) / (41 * cin // groups) ** 0.5
    v.requires_grad_()
    b = (0.1 * torch.randn(cout, generator=gen, dtype=torch.float64)
         ).requires_grad_()
    xp = F.pad(x.to(dtype), (20, 20))
    y = apply(xp, (v * 1.0).to(dtype), (b * 1.0).to(dtype), (4,), (1,),
              groups)
    (gx,) = torch.autograd.grad(F.leaky_relu(y, 0.2).float().square().sum(),
                                x, create_graph=True)
    gv, gb = torch.autograd.grad(gx.float().square().sum()
                                 + y.float().mean(), [v, b])
    return y, gx, gv, gb


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("groups", [4, 64, 256])
def test_grouped_conv_equals_native_through_r1s_second_derivative(groups):
    want = _r1_grads(groups, torch.float64, _native)
    got = _r1_grads(groups, torch.float64, conv.GroupedConv.apply)
    for name, g, w in zip(("y", "gx", "gv", "gb"), got, want):
        assert _rel(g, w) <= 1e-12, name
    want = _r1_grads(groups, torch.bfloat16, _native)
    got = _r1_grads(groups, torch.bfloat16, conv.GroupedConv.apply)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for name, g, w in zip(("gv", "gb"), got[2:], want[2:]):
        assert _rel(g, w) <= 2.0 ** -8, name


def _msd(**changes) -> MultiScaleDiscriminator:
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in FLAGSHIP_SECTIONS["msd"].items()}
    cfg = dataclasses.replace(MSDConfig(**fields), **changes)
    return MultiScaleDiscriminator(cfg, torch.Generator().manual_seed(0))


def _r1_convolutions(disc) -> int:
    """aten ``convolution`` + ``convolution_backward`` calls of R1's
    input gradient and its backward into D's parameters."""
    params = {k: p.detach().requires_grad_()
              for k, p in disc.named_parameters()}
    x = torch.randn(1, 8192, generator=torch.Generator().manual_seed(1))
    x.requires_grad_()
    logits, _ = functional_call(disc, params, (x,))
    with _Dispatched() as seen:
        (gx,) = torch.autograd.grad(sum(l.float().sum() for l in logits), x,
                                    create_graph=True)
        torch.autograd.grad(gx.square().sum(), list(params.values()),
                            allow_unused=True)
    counts = collections.Counter(name for name, _ in seen.calls)
    return counts["convolution"] + counts["convolution_backward"]


def _first_order_calls(disc) -> list:
    """Every aten call of D's hinge loss on a batch and its first-order
    backward into D's parameters (grad mode off, as without R1)."""
    params = {k: p.detach().requires_grad_()
              for k, p in disc.named_parameters()}
    x = torch.randn(2, 8192, generator=torch.Generator().manual_seed(1))
    with _Dispatched() as seen:
        logits, _ = functional_call(disc, params, (x,))
        loss = sum(F.relu(1 - l.float()).mean() for l in logits)
        torch.autograd.grad(loss, list(params.values()))
    return seen.calls


@pytest.mark.parametrize("case", ["r1_double_backward",
                                  "first_order_bypass"])
def test_grouped_conv_dispatch(case, native_grouped):
    if case == "r1_double_backward":
        cfg = dict(compute_dtype="float32")
        wide = _r1_convolutions(_msd(**cfg))
        narrow = _r1_convolutions(_msd(groups=(4, 16, 32, 128), **cfg))
        assert wide == narrow
        native_grouped()
        assert _r1_convolutions(_msd(**cfg)) == 996 + 39
        assert _r1_convolutions(_msd(groups=(4, 16, 32, 128),
                                     **cfg)) == 516 + 39
        assert 10 * wide < 996  # 87 when the test was written
    else:
        got = _first_order_calls(_msd(dense_groups_max_g=64))
        native_grouped()
        want = _first_order_calls(_msd(dense_groups_max_g=64))
        assert ("convolution_backward", (True, True, True)) in got
        assert got == want


def _counted_step_cfg(dense_max_g: int, r1_gamma: float):
    msd = dataclasses.replace(TINY.msd, channels=(32, 128, 128),
                              groups=(32, 128),
                              dense_groups_max_g=dense_max_g)
    return dataclasses.replace(TINY, msd=msd, train=dataclasses.replace(
        TINY.train, r1_gamma=r1_gamma))


@pytest.mark.parametrize("dense_max_g,r1_gamma,per_scale",
                         [(16, 1.0, 2), (64, 1.0, 1), (16, 0.0, 0)])
def test_stage2_step_counts_second_order_weight_terms(dense_max_g, r1_gamma,
                                                      per_scale):
    cfg = _counted_step_cfg(dense_max_g, r1_gamma)
    state = stage2.make_train_state(cfg, seed=0, device="cpu")
    wav = 0.3 * torch.tanh(torch.randn(
        2, 2048, generator=torch.Generator().manual_seed(2)))
    for _ in range(2):
        before = tracer.snapshot()["counters"]["grouped_wgrad2"]
        state, _ = stage2.train_step(cfg, state, wav.numpy())
        after = tracer.snapshot()["counters"]["grouped_wgrad2"]
        assert after - before == per_scale * cfg.msd.n_scales
