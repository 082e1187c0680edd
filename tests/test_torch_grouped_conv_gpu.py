"""Card-only tests of the grouped convolution kernels (``csrc/
grouped_conv.cu``, launched by ``ops/grouped_conv.py`` for every 1-D CUDA
``GroupedConv``) against native ``F.conv1d`` computed in float64 on the
CPU.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and skips
without one. This file imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_grouped_conv_gpu.py --noconftest -q

Shapes: every grouped layer the benchmark's configurations run on the
kernels (groups 64: 4 in, 16 out, padded lengths 552, 296 and 168; groups
256: 4 in, 4 out, 168, 104 and 72; kernel 41, stride 4) at batches 16, 32
and 64, ``TINY``'s two (groups 2: 2 or 4 in, 4 out, kernel 11), and an odd
one (stride 3, 6 outputs a group), in bf16 and fp32, the kernel as
``WNConv`` hands it (permuted strides) and contiguous.

Tolerances: each output's max abs error against float64 may be
``FACTOR`` (4) times cuDNN's own error at the same shape and dtype (TF32
off), plus ``FLOOR`` (1e-6) of the largest magnitude. Both sum in fp32 and
round once, in other orders; in bf16 both errors are the output's rounding
(2.0e-3 to 3.4e-3 of the largest magnitude when the test was written, the
kernel's 0.5 to 1.2 times cuDNN's); in fp32 the kernel's were 0.7 to 3.6
times cuDNN's. A wrong tap, phase or group reads of order 1.

R1's pass (the forward, ``create_graph``'s input gradient, and the
second-order gradients of ``sum(gx^2) + mean(y)`` into the kernel and the
bias, through ``GroupedConv``) is held to the same bound against native
autograd on the card. Two runs are bit for bit, and a CUDA graph of the
pass replays the eager bits. Launch counts per replay of the graphed
stage-2 step at batch 2 are pinned at what the card gave, and the
generation pipeline launches none. The plans' shared memory, asked of
the library (``grouped_conv_smem``), fits a block at every layer, and what
the kernels do not take raises on the card, a 2-D grouped convolution
included.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from music_synthesis_tpu_torch import config
from music_synthesis_tpu_torch.infer import generate as gen
from music_synthesis_tpu_torch.models.specgan import SpectrogramGenerator
from music_synthesis_tpu_torch.models.vocoder import Vocoder
from music_synthesis_tpu_torch.ops import conv
from music_synthesis_tpu_torch.ops import grouped_conv as gc
from music_synthesis_tpu_torch.train import stage2
from music_synthesis_tpu_torch.train.state import drop_graphed_steps
from music_synthesis_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FACTOR, FLOOR = 4.0, 1e-6
_aten = torch.ops.aten

# (groups, ci, co, kernel, stride, padded length)
CELL_LAYERS = [(64, 4, 16, 41, 4, 552), (64, 4, 16, 41, 4, 296),
               (64, 4, 16, 41, 4, 168), (256, 4, 4, 41, 4, 168),
               (256, 4, 4, 41, 4, 104), (256, 4, 4, 41, 4, 72)]
OTHER_LAYERS = [(2, 2, 4, 11, 4, 2058), (2, 4, 4, 11, 4, 523),
                (3, 2, 6, 5, 3, 37)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(batch, layer, dtype, device, permuted=True, seed=0):
    groups, ci, co, k, s, length = layer
    gen_ = torch.Generator().manual_seed(seed)
    out = (length - k) // s + 1
    x = torch.randn(batch, groups * ci, length, generator=gen_)
    w = torch.randn(k, ci, groups * co, generator=gen_) / (ci * k) ** 0.5
    b = torch.randn(groups * co, generator=gen_)
    gy = torch.randn(batch, groups * co, out, generator=gen_)
    x, w, b, gy = (t.to(dtype).to(device) for t in (x, w, b, gy))
    w = w.permute(2, 1, 0)  # [Cout, ci, K], WNConv's strides
    return x, (w if permuted else w.contiguous()), b, gy


def _library_calls(x, w, b, gy, s, groups):
    """``(y, gx, gw, gb)`` of the native calls (cuDNN on the card, TF32
    off; aten in float64 on the CPU)."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv1d(x, w, b, stride=s, groups=groups)
        grads = _aten.convolution_backward(
            gy, x, w, [w.shape[0]], [s], [0], [1], False, [0], groups,
            [True, True, True])
    return [y, *grads]


def _kernel_calls(x, w, b, gy, s, groups):
    return [gc.forward(x, w, b, [s], [1], groups),
            gc.input_grad(gy, w, x.shape[-1], [s], [1], groups),
            *gc.weight_grad(gy, x, w.shape, [s], [1], groups, True, True)]


def _err(got, want):
    return float((got.detach().double().cpu() - want).abs().max())


def _check(got, lib, want, names=("y", "gx", "gw", "gb")):
    for name, g, c, w in zip(names, got, lib, want):
        assert g.shape == w.shape and g.dtype == c.dtype, name
        tol = FACTOR * _err(c, w) + FLOOR * float(w.abs().max())
        assert _err(g, w) <= tol, (name, _err(g, w), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [16, 32, 64])
@pytest.mark.parametrize("layer", CELL_LAYERS, ids=str)
def test_kernels_match_float64_at_the_cells_layers(cuda, layer, batch,
                                                   dtype):
    x, w, b, gy = _inputs(batch, layer, dtype, cuda)
    groups, s = layer[0], layer[4]
    before = gc.grouped_conv_kernel.n_calls
    got = _kernel_calls(x, w, b, gy, s, groups)
    torch.cuda.synchronize()
    assert gc.grouped_conv_kernel.n_calls - before == 4
    want = _library_calls(*(t.double().cpu() for t in (x, w, b, gy)), s,
                          groups)
    _check(got, _library_calls(x, w, b, gy, s, groups), want)


@pytest.mark.parametrize("permuted", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", OTHER_LAYERS, ids=str)
def test_kernels_match_float64_at_tiny_and_odd_layers(cuda, layer, dtype,
                                                      permuted):
    x, w, b, gy = _inputs(3, layer, dtype, cuda, permuted)
    groups, s = layer[0], layer[4]
    got = _kernel_calls(x, w, b, gy, s, groups)
    want = _library_calls(*(t.double().cpu() for t in (x, w, b, gy)), s,
                          groups)
    _check(got, _library_calls(x, w, b, gy, s, groups), want)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_plans_shared_memory_is_the_kernels(cuda, itemsize):
    """``ops/grouped_conv.py``'s plans take each launch's shared memory
    from ``csrc/grouped_conv.cu`` (``grouped_conv_smem``), and it fits a
    block at every layer and batch."""
    lib = gc._library()
    dtype = 0 if itemsize == 4 else 1
    for batch in (2, 16, 32, 64):
        for groups, ci, co, k, s, length in CELL_LAYERS + OTHER_LAYERS:
            c = gc.Conv(batch, groups, ci, co, k, s, length)
            f = gc.plan_forward(c, 132, itemsize)
            i = gc.plan_input_grad(c, 132, itemsize)
            w = gc.plan_weight_grad(c, 132)
            assert lib.grouped_conv_smem(0, dtype, groups, ci, co, k, s, f.gt,
                                         f.nb, f.tt) == f.smem_bytes
            assert lib.grouped_conv_smem(1, dtype, groups, ci, co, k, s, i.gt,
                                         i.nb, i.qq) == i.smem_bytes
            assert lib.grouped_conv_smem(2, dtype, groups, ci, co, k, s, w.gt,
                                         w.tt, w.nb) == w.smem_bytes
            for p in (f, i, w):
                assert 0 < p.smem_bytes <= gc._SMEM_MAX, p


def test_bias_or_weight_alone(cuda):
    x, w, b, gy = _inputs(4, CELL_LAYERS[3], torch.bfloat16, cuda)
    before = gc.grouped_conv_kernel.n_calls
    gw, gb = gc.weight_grad(gy, x, w.shape, [4], [1], 256, False, True)
    assert gw is None and gc.grouped_conv_kernel.n_calls - before == 1
    gw2, gb2 = gc.weight_grad(gy, x, w.shape, [4], [1], 256, True, False)
    assert gb2 is None and gc.grouped_conv_kernel.n_calls - before == 3
    gw3, gb3 = gc.weight_grad(gy, x, w.shape, [4], [1], 256, True, True)
    assert torch.equal(gb, gb3) and torch.equal(gw2, gw3)


def _r1(x, w, b, s, groups, apply):
    """R1's pass through one grouped layer from leaves ``x``, ``w``,
    ``b``: y, gx (``create_graph``), and the second-order gradients into
    the kernel and the bias."""
    leaves = [t.detach().requires_grad_() for t in (x, w, b)]
    xl, wl, bl = leaves
    y = apply(xl, wl * 1.0, bl * 1.0, [s], [1], groups)
    (gx,) = torch.autograd.grad(F.leaky_relu(y, 0.2).float().square().sum(),
                                xl, create_graph=True)
    gw, gb = torch.autograd.grad(gx.float().square().sum()
                                 + y.float().mean(), [wl, bl])
    return [y.detach(), gx.detach(), gw, gb]


def _native(x, w, b, stride, dilation, groups):
    return F.conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", [CELL_LAYERS[0], CELL_LAYERS[3],
                                   OTHER_LAYERS[0]], ids=str)
def test_r1_pass_matches_float64(cuda, layer, dtype):
    x, w, b, _ = _inputs(8, layer, dtype, cuda)
    groups, s = layer[0], layer[4]
    before = conv.grouped_wgrad2.n_calls
    got = _r1(x, w, b, s, groups, conv.GroupedConv.apply)
    assert conv.grouped_wgrad2.n_calls - before == 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib = _r1(x, w, b, s, groups, _native)
    want = _r1(*(t.double().cpu() for t in (x, w, b)), s, groups, _native)
    _check(got, lib, want, ("y", "gx", "gw2", "gb2"))


@pytest.mark.parametrize("layer", [CELL_LAYERS[0], CELL_LAYERS[3]], ids=str)
def test_runs_and_graph_replays_are_bit_for_bit(cuda, layer):
    x, w, b, _ = _inputs(16, layer, torch.bfloat16, cuda)
    groups, s = layer[0], layer[4]
    static = [t.clone() for t in (x, w, b)]

    def run():
        return _r1(*static, s, groups, conv.GroupedConv.apply)

    first, second = run(), run()
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm-up on the capturing stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(outs, first))


# Launches of the kernels per replay of the graphed stage-2 step at batch 2
# (the card's count when the test was written). Per grouped layer and
# scale, the flagship (groups 64 and 256, 3 scales: 6) launches 15: five
# forwards (D on both batches, R1's forward, G's D pass, the clean real
# pass, the double backward's ggy), four input gradients (R1's, D's
# backward through both batches and through R1's forward, whose
# activations take a zero gradient there, and G's) and three weight
# gradients of two launches (both batches', R1's forward's, the double
# backward's term); rich and BigVGAN (groups 256 only: 3) launch 6: two
# forwards, two input gradients, one weight gradient.
STEP_LAUNCHES = {"flagship": 90, "rich": 18, "bigvgan": 18}


@pytest.fixture
def tracing(cuda):
    drop_graphed_steps()
    profiling.tracer.reset()
    profiling.set_tracing(True)
    yield profiling.tracer
    drop_graphed_steps()
    profiling.tracer.reset()


@pytest.mark.parametrize("name", ["flagship", "rich", "bigvgan"])
def test_graphed_stage2_step_launches_the_kernels(cuda, tracing, name):
    raw = json.loads((REPO / "benchmark" / "configs" / f"{name}.json"
                      ).read_text())
    cfg = config.config_from_dict(raw["train"])
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=2))
    state = stage2.make_train_state(cfg, seed=0, device=cuda)
    wav = (0.5 * torch.tanh(torch.randn(
        2, cfg.train.segment_length,
        generator=torch.Generator().manual_seed(5)))).to(cuda)
    state, _ = stage2.train_step(cfg, state, wav)  # builds, then replays
    before = gc.grouped_conv_kernel.n_calls
    for _ in range(2):
        state, metrics = stage2.train_step(cfg, state, wav)
    per_replay = (gc.grouped_conv_kernel.n_calls - before) // 2
    snap = tracing.snapshot()
    log = snap["programs"]["stage2_step"]
    assert log["grouped_conv_kernel"] == per_replay
    assert snap["counters"]["grouped_conv_kernel"] == \
        gc.grouped_conv_kernel.n_calls
    assert per_replay == STEP_LAUNCHES[name]
    ms = log["records"][-1]["region_ms"]
    assert ms["grouped_conv.fwd"] > 0 and ms["grouped_conv.bwd"] > 0, ms
    assert ms["d_step"] > ms["grouped_conv.bwd"]
    assert all(v == v for v in metrics.values())


def test_generation_launches_no_grouped_convolution(cuda):
    """Generation runs no discriminator: the rich pair's graphed pipeline
    (composer, crossfade, waveform-head vocoder) at TINY's widths."""
    cfg = config.TINY
    comp = SpectrogramGenerator(cfg.specgan, torch.Generator().manual_seed(0))
    voc = Vocoder(cfg.vocoder, torch.Generator().manual_seed(1))
    pipe = gen.GraphedPipeline(cfg, comp.to(cuda).eval(), voc.to(cuda).eval())
    z = torch.randn((2, 3, cfg.specgan.latent_dim), device=cuda)
    before = gc.grouped_conv_kernel.n_calls
    for _ in range(3):
        pipe(gen.generate_long, z, 4)
    torch.cuda.synchronize()
    assert gc.grouped_conv_kernel.n_calls == before
    program, = pipe.programs.programs.values()
    assert program.counts_per_replay.get("grouped_conv_kernel", 0) == 0


def test_refused_on_the_card(cuda):
    x, w, b, gy = _inputs(2, OTHER_LAYERS[0], torch.float16, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv.GroupedConv.apply(x, w, b, (4,), (1,), 2)
    x, w, b, gy = _inputs(2, OTHER_LAYERS[0], torch.float32, cuda)
    with pytest.raises(ValueError, match="dilation"):
        conv.GroupedConv.apply(x, w, b, (4,), (2,), 2)
    # A 2-D grouped convolution is refused too: no quiet cuDNN call.
    before = gc.grouped_conv_kernel.n_calls
    x4 = torch.randn(2, 4, 8, 8, device=cuda)
    w4 = torch.randn(4, 2, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="1-D"):
        conv.GroupedConv.apply(x4, w4, None, (1, 1), (1, 1), 2)
    assert gc.grouped_conv_kernel.n_calls == before
