"""The grouped convolution kernel's Python side (``ops/grouped_conv.py``)
and ``GroupedConv``'s card branch, on the CPU.

- Tiles: at every grouped layer the three benchmark configurations run on
  the kernels (the MSD's groups over ``dense_groups_max_g``, at each
  scale's length), at batches 16, 32 and 64, each plan fits a block's 256
  threads and fills the card; a plan asks the library for its shared
  memory (``grouped_conv_smem``, here a stand-in), shrinks its tile until
  that fits a block and raises where no tile does. That every output is
  computed, and right, the card tests check at every layer.
- Arguments: ``conv_of`` and the launchers refuse what the kernels do not
  take (another rank or dtype, a dilation, mismatched groups or devices, a
  strided input) before any library is built.
- Dispatch: a CPU tensor never reaches the kernels' launchers, and a
  CUDA one always does (a 2-D one then raises); with ``_on_card`` forced
  and the launchers replaced by the aten calls they stand for, R1's input
  gradient and the second-order gradients into the kernel and the bias
  equal native autograd's in float64, each call asks for the gradients its
  mask names, and a derivative of a weight gradient taken under grad mode
  raises, whether or not the input's gradient was asked for too.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from music_synthesis_tpu_torch import config
from music_synthesis_tpu_torch.ops import conv
from music_synthesis_tpu_torch.ops import grouped_conv as gc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
H100_SMS = 132
_aten = torch.ops.aten


def _msd_convs(msd, segment: int, batch: int) -> list:
    """``gc.Conv`` of each MSD layer that runs on the kernels (grouped, not
    dense), at each scale, as ``ScaleDiscriminator`` pads it."""
    out, length = [], segment
    for _ in range(msd.n_scales):
        lin = length
        for cin, cout, s, grp in zip(msd.channels, msd.channels[1:],
                                     msd.strides, msd.groups):
            g = min(grp, cin)
            lp = lin + msd.kernel - 1
            if g > 1 and g > msd.dense_groups_max_g:
                out.append(gc.Conv(batch, g, cin // g, cout // g, msd.kernel,
                                   s, lp))
            lin = (lp - msd.kernel) // s + 1
        length = (length + 2 - 4) // msd.downsample_factor + 1
    return out


def _cell_convs(batch: int) -> list:
    convs = []
    for name in ("flagship", "rich", "bigvgan"):
        raw = json.loads((REPO / "benchmark" / "configs" / f"{name}.json"
                          ).read_text())
        cfg = config.config_from_dict(raw["train"])
        convs += _msd_convs(cfg.msd, cfg.train.segment_length, batch)
    return sorted(set(convs), key=repr)


CELL_CONVS = _cell_convs(2)
TINY_CONVS = _msd_convs(config.TINY.msd, 2048, 2)
ODD_CONVS = [gc.Conv(3, 3, 2, 6, 5, 3, 37), gc.Conv(1, 5, 1, 3, 7, 2, 19),
             gc.Conv(2, 4, 3, 16, 9, 5, 100), gc.Conv(2, 2, 8, 32, 3, 1, 11)]
SHAPES = CELL_CONVS + TINY_CONVS + ODD_CONVS


def test_the_cells_run_the_grouped_layers_of_their_configurations():
    """Groups 64 (4 in, 16 out) and 256 (4 in, 4 out), kernel 41, stride 4,
    at the three scales' lengths; TINY's groups 2."""
    assert {(c.groups, c.ci, c.co, c.kernel, c.stride, c.length)
            for c in CELL_CONVS} == {
        (64, 4, 16, 41, 4, 552), (64, 4, 16, 41, 4, 296),
        (64, 4, 16, 41, 4, 168), (256, 4, 4, 41, 4, 168),
        (256, 4, 4, 41, 4, 104), (256, 4, 4, 41, 4, 72)}
    assert {(c.groups, c.ci, c.co) for c in TINY_CONVS} == {(2, 2, 4),
                                                            (2, 4, 4)}


@pytest.fixture
def smem(monkeypatch):
    """The library's ``grouped_conv_smem`` replaced by ``smem.fn(kind,
    itemsize, conv, a, b, c)`` (0 bytes unless a test sets it), the plans'
    caches emptied around the test."""
    class Stand:
        fn = staticmethod(lambda *args: 0)

    def clear():
        for plan in (gc.plan_forward, gc.plan_input_grad,
                     gc.plan_weight_grad):
            plan.cache_clear()

    clear()
    monkeypatch.setattr(gc, "_smem", lambda *args: Stand.fn(*args))
    yield Stand
    clear()


@pytest.mark.parametrize("batch", [16, 32, 64])
def test_plans_fit_a_block_and_fill_the_card(batch, smem):
    for shape in _cell_convs(batch):
        for p in (gc.plan_forward(shape, H100_SMS),
                  gc.plan_input_grad(shape, H100_SMS),
                  gc.plan_weight_grad(shape, H100_SMS)):
            assert 0 < p.threads <= gc._THREADS, p
            assert p.blocks >= H100_SMS, p
        f = gc.plan_forward(shape, H100_SMS)
        assert shape.co % f.opt == 0 and f.tt % gc.UPT == 0
        i = gc.plan_input_grad(shape, H100_SMS)
        assert shape.ci % i.cpt == 0 and i.qq % gc.UPT == 0
        w = gc.plan_weight_grad(shape, H100_SMS)
        assert w.nb <= w.bps and w.splits * w.bps >= batch
        assert w.partial_words == (w.splits * shape.groups * shape.co
                                   * shape.ci * shape.kernel)


_PLANS = {"forward": (gc.plan_forward, 0), "input_grad": (gc.plan_input_grad,
                                                          1),
          "weight_grad": (gc.plan_weight_grad, 2)}


def _rows_times_groups(kind, a, b, c):
    """A tile's batch rows times groups from ``grouped_conv_smem``'s
    arguments (gt, nb, .. for kinds 0 and 1; gt, tt, nb for 2)."""
    return a * (c if kind == 2 else b)


@pytest.mark.parametrize("kind", list(_PLANS))
def test_plans_shrink_until_the_kernels_shared_memory_fits(kind, smem):
    """With shared memory of 100 KB a (row, group) pair, each plan takes
    at most two pairs a block, where 0 bytes let it take more."""
    plan, code = _PLANS[kind]
    shape = _cell_convs(32)[0]
    roomy = plan(shape, H100_SMS)
    smem.fn = lambda k, itemsize, conv, a, b, c: (
        100 * 1024 * _rows_times_groups(k, a, b, c))
    plan.cache_clear()
    tight = plan(shape, H100_SMS)
    pairs = _rows_times_groups(code, *((tight.gt, tight.nb, 0) if code < 2
                                       else (tight.gt, 0, tight.nb)))
    assert pairs <= 2 < _rows_times_groups(
        code, *((roomy.gt, roomy.nb, 0) if code < 2
                else (roomy.gt, 0, roomy.nb)))
    assert tight.smem_bytes <= gc._SMEM_MAX


@pytest.mark.parametrize("kind", list(_PLANS))
def test_plans_raise_where_no_tile_fits(kind, smem):
    plan, _ = _PLANS[kind]
    smem.fn = lambda *args: gc._SMEM_MAX + 1
    with pytest.raises(ValueError, match="fits a block's shared memory"):
        plan(_cell_convs(32)[0], H100_SMS)


@pytest.mark.parametrize("kind", list(_PLANS))
def test_plans_ask_the_library_for_shared_memory(kind, monkeypatch):
    """``smem_bytes`` is ``grouped_conv_smem(kind, dtype, groups, ci, co,
    kernel, stride, ..)`` with the tile's own numbers."""
    asked = []

    class Library:
        @staticmethod
        def grouped_conv_smem(*args):
            asked.append(args)
            return 1234

    monkeypatch.setattr(gc, "_library", lambda: Library)
    shape = gc.Conv(32, 256, 4, 4, 41, 4, 168)
    if kind == "forward":
        p = gc.ForwardPlan(shape, opt=4, gt=2, nb=3, tt=16, itemsize=4)
        want = (0, 0, 256, 4, 4, 41, 4, 2, 3, 16)
    elif kind == "input_grad":
        p = gc.InputGradPlan(shape, cpt=4, gt=2, nb=3, qq=8, itemsize=2)
        want = (1, 1, 256, 4, 4, 41, 4, 2, 3, 8)
    else:
        p = gc.WeightGradPlan(shape, opt=4, gt=5, tt=32, nb=2, bps=4)
        want = (2, 0, 256, 4, 4, 41, 4, 5, 32, 2)
    assert p.smem_bytes == 1234 and asked == [want]


def test_plans_refuse_what_no_block_holds():
    with pytest.raises(ValueError, match="outputs a group"):
        gc.plan_forward(gc.Conv(1, 2, 4, 1024, 41, 4, 100), H100_SMS)
    with pytest.raises(ValueError, match="taps a phase"):
        gc.plan_forward(gc.Conv(1, 2, 4, 4, 41, 2, 100), H100_SMS)
    with pytest.raises(ValueError, match="weight gradient"):
        gc.plan_weight_grad(gc.Conv(1, 2, 16, 16, 41, 4, 100), H100_SMS)
    with pytest.raises(ValueError, match="input channels times stride"):
        gc.plan_input_grad(gc.Conv(1, 2, 1, 4, 41, 64, 100), H100_SMS)


@pytest.mark.parametrize("x_shape,w_shape,stride,dilation,groups,match", [
    ((2, 8, 100, 3), (4, 2, 5, 3), (1, 1), (1, 1), 4, "1-D"),
    ((2, 8, 100), (8, 2, 5), (1,), (2,), 4, "dilation"),
    ((2, 8, 100), (8, 3, 5), (1,), (1,), 4, "no grouped convolution"),
    ((2, 8, 100), (6, 2, 5), (1,), (1,), 4, "no grouped convolution"),
    ((2, 8, 4), (8, 2, 5), (1,), (1,), 4, "no grouped convolution"),
    ((2, 8, 100), (8, 2, 5), (0,), (1,), 4, "no grouped convolution"),
    ((2 ** 16, 2 ** 10, 2 ** 6), (2 ** 10, 1, 5), (1,), (1,), 2 ** 10,
     "2\\*\\*31"),
])
def test_conv_of_refuses(x_shape, w_shape, stride, dilation, groups, match):
    with pytest.raises(ValueError, match=match):
        gc.conv_of(x_shape, w_shape, stride, dilation, groups)


def test_conv_of_reads_the_shape():
    c = gc.conv_of((32, 1024, 168), (1024, 4, 41), [4], [1], 256)
    assert c == gc.Conv(32, 256, 4, 4, 41, 4, 168)
    assert c.out == 32 and c.flops == 2 * 32 * 1024 * 32 * 4 * 41


def _args(dtype=torch.bfloat16):
    x = torch.zeros(2, 8, 20, dtype=dtype)
    w = torch.zeros(8, 2, 5, dtype=dtype)
    return x, w, torch.zeros(8, dtype=dtype)


@pytest.mark.parametrize("case", ["float16", "w_dtype", "b_dtype",
                                  "strided_x", "strided_gy", "gy_shape"])
def test_launchers_refuse_before_building(case, monkeypatch):
    def no_library():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(gc, "_library", no_library)
    x, w, b = _args()
    gy = torch.zeros(2, 8, 4, dtype=torch.bfloat16)
    if case == "float16":
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            gc.forward(x.half(), w.half(), None, [4], [1], 4)
    elif case == "w_dtype":
        with pytest.raises(TypeError, match="not torch.bfloat16"):
            gc.input_grad(gy, w.float(), 20, [4], [1], 4)
    elif case == "b_dtype":
        with pytest.raises(TypeError, match="not torch.bfloat16"):
            gc.forward(x, w, b.float(), [4], [1], 4)
    elif case == "strided_x":
        with pytest.raises(ValueError, match="x must be contiguous"):
            gc.forward(x.transpose(1, 2).contiguous().transpose(1, 2), w, b,
                       [4], [1], 4)
    elif case == "strided_gy":
        with pytest.raises(ValueError, match="gy must be contiguous"):
            gc.weight_grad(gy.transpose(1, 2).contiguous().transpose(1, 2),
                           x, w.shape, [4], [1], 4, True, True)
    else:
        with pytest.raises(ValueError, match="is not the output"):
            gc.input_grad(gy[..., :3].contiguous(), w, 20, [4], [1], 4)


def _fake_launchers(monkeypatch, calls: list):
    """The launchers replaced by the aten calls they stand for, each call
    recorded with what it was asked for; ``_on_card`` true."""
    def forward(x, w, b, stride, dilation, groups):
        calls.append(("forward", b is not None))
        return _aten.convolution(x, w, b, stride, [0], dilation, False, [0],
                                 groups)

    def input_grad(gy, w, length, stride, dilation, groups):
        calls.append(("input_grad",))
        assert gy.is_contiguous()
        x = gy.new_empty(gy.shape[0], w.shape[1] * groups, length)
        return _aten.convolution_backward(gy, x, w, None, stride, [0],
                                          dilation, False, [0], groups,
                                          [True, False, False])[0]

    def weight_grad(gy, x, w_shape, stride, dilation, groups, need_w,
                    need_b):
        calls.append(("weight_grad", need_w, need_b))
        assert gy.is_contiguous() and x.is_contiguous()
        w = x.new_empty(w_shape)
        _, gw, gb = _aten.convolution_backward(
            gy, x, w, [w_shape[0]], stride, [0], dilation, False, [0], groups,
            [False, need_w, need_b])
        return (gw if need_w else None), (gb if need_b else None)

    monkeypatch.setattr(conv, "_on_card", lambda x: True)
    monkeypatch.setattr(gc, "forward", forward)
    monkeypatch.setattr(gc, "input_grad", input_grad)
    monkeypatch.setattr(gc, "weight_grad", weight_grad)


def _r1(groups, apply, cin=16, cout=32, length=64):
    """R1's input gradient of a leaky-ReLU'd grouped layer and the
    second-order gradients of ``sum(gx^2) + mean(y)`` into its input, kernel
    (through an op, as weight norm makes it) and bias, in float64."""
    gen = torch.Generator().manual_seed(groups)
    x = torch.randn(2, cin, length, generator=gen, dtype=torch.float64)
    x.requires_grad_()
    v = torch.randn(cout, cin // groups, 9, generator=gen,
                    dtype=torch.float64).requires_grad_()
    b = torch.randn(cout, generator=gen, dtype=torch.float64
                    ).requires_grad_()
    w = (v * 0.3).permute(2, 1, 0).contiguous().permute(2, 1, 0)
    y = apply(F.pad(x, (4, 4)), w, b * 1.0, (4,), (1,), groups)
    (gx,) = torch.autograd.grad(F.leaky_relu(y, 0.2).square().sum(), x,
                                create_graph=True)
    return (y, gx, *torch.autograd.grad(gx.square().sum() + y.mean(),
                                        [x, v, b]))


def _native(x, w, b, stride, dilation, groups):
    return F.conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups)


@pytest.mark.parametrize("groups", [2, 4, 16])
def test_card_branch_equals_native_through_r1(groups, monkeypatch):
    want = _r1(groups, _native)
    calls = []
    _fake_launchers(monkeypatch, calls)
    before = conv.grouped_wgrad2.n_calls
    got = _r1(groups, conv.GroupedConv.apply)
    for name, g, w in zip(("y", "gx", "ggx", "gv", "gb"), got, want):
        assert torch.allclose(g, w, rtol=1e-12, atol=1e-12), name
    assert conv.grouped_wgrad2.n_calls - before == 1
    # The forward with its bias; R1's input gradient; then the double
    # backward's two terms (its forward without bias, its weight term) and
    # the first-order backward of the layer for x, the kernel and the bias.
    assert sorted(calls) == sorted([
        ("forward", True), ("input_grad",), ("forward", False),
        ("weight_grad", True, False), ("input_grad",),
        ("weight_grad", True, True)])


@pytest.mark.parametrize("asked", [(True, True, True), (True, False, False),
                                   (False, True, False), (False, False, True),
                                   (True, True, False)])
def test_card_branch_asks_for_what_the_mask_names(asked, monkeypatch):
    calls = []
    _fake_launchers(monkeypatch, calls)
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(2, 8, 40, generator=gen),
              torch.randn(8, 2, 5, generator=gen),
              torch.randn(8, generator=gen)]
    leaves = [t.requires_grad_(a) for t, a in zip(leaves, asked)]
    y = conv.GroupedConv.apply(*leaves, (4,), (1,), 4)
    grads = torch.autograd.grad(y.square().sum(),
                                [t for t in leaves if t.requires_grad])
    assert len(grads) == sum(asked)
    want = [("forward", True)]
    if asked[0]:
        want.append(("input_grad",))
    if asked[1] or asked[2]:
        want.append(("weight_grad", asked[1], asked[2]))
    assert calls == want


def test_card_branch_weight_gradient_under_grad_mode_has_no_derivative(
        monkeypatch):
    """Under ``create_graph`` the kernel's weight and bias gradients come
    back (R1's pass asks for a leaf bias's) with the same values, and a
    derivative of them raises rather than reading 0."""
    calls = []
    _fake_launchers(monkeypatch, calls)
    x = torch.randn(2, 8, 40, dtype=torch.float64, requires_grad=True)
    w = torch.randn(8, 2, 5, dtype=torch.float64, requires_grad=True)
    b = torch.randn(8, dtype=torch.float64, requires_grad=True)
    y = conv.GroupedConv.apply(x, w, b, (4,), (1,), 4)
    gx, gw, gb = torch.autograd.grad(y.square().sum(), [x, w, b],
                                     create_graph=True)
    want = torch.autograd.grad(_native(x, w, b, (4,), (1,), 4).square().sum(),
                               [x, w, b])
    for g, v in zip((gx, gw, gb), want):
        assert torch.allclose(g, v, rtol=1e-12, atol=1e-12)
    assert ("weight_grad", True, True) in calls
    torch.autograd.grad(gx.square().sum(), [w])  # R1's term: fine
    with pytest.raises(NotImplementedError, match="weight or bias gradient"):
        torch.autograd.grad(gb.sum(), [w])


def test_card_branch_weight_gradient_alone_under_grad_mode_has_no_derivative(
        monkeypatch):
    """Under ``create_graph`` with the input taking no gradient, the
    kernel's and bias's gradients still come through ``_WeightGradOnCard``:
    the values, and a derivative that raises rather than reading 0."""
    calls = []
    _fake_launchers(monkeypatch, calls)
    x = torch.randn(2, 8, 40, dtype=torch.float64)
    w = torch.randn(8, 2, 5, dtype=torch.float64, requires_grad=True)
    b = torch.randn(8, dtype=torch.float64, requires_grad=True)
    gw, gb = torch.autograd.grad(
        conv.GroupedConv.apply(x, w, b, (4,), (1,), 4).square().sum(),
        [w, b], create_graph=True)
    want = torch.autograd.grad(_native(x, w, b, (4,), (1,), 4).square().sum(),
                               [w, b])
    for g, v in zip((gw, gb), want):
        assert torch.allclose(g, v, rtol=1e-12, atol=1e-12)
    assert calls == [("forward", True), ("weight_grad", True, True)]
    assert gw.requires_grad and gb.requires_grad
    with pytest.raises(NotImplementedError, match="weight or bias gradient"):
        torch.autograd.grad(gw.square().sum(), [w])


def test_cpu_tensors_take_the_aten_calls(monkeypatch):
    """Without ``_on_card`` forced a CPU call never reaches a launcher,
    and the kernels' launch count stays."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernels")

    for name in ("forward", "input_grad", "weight_grad"):
        monkeypatch.setattr(gc, name, refuse)
    before = gc.grouped_conv_kernel.n_calls
    want = _r1(4, _native)
    got = _r1(4, conv.GroupedConv.apply)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-12, atol=1e-12)
    assert gc.grouped_conv_kernel.n_calls == before


def test_two_dimensional_calls_keep_the_aten_call(monkeypatch):
    """A 2-D CPU call keeps the aten call; on the card ``_on_card`` sends a
    2-D call to the launchers like any other, and they refuse it before
    any library is built (no model of the port has one)."""
    def no_library():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(gc, "_library", no_library)
    x = torch.randn(2, 4, 8, 8, dtype=torch.float64)
    w = torch.randn(4, 2, 3, 3, dtype=torch.float64)
    y = conv.GroupedConv.apply(x, w, None, (1, 1), (1, 1), 2)
    assert torch.equal(y, F.conv2d(x, w, groups=2))

    class Fake:
        is_cuda = True
        ndim = 4

    assert conv._on_card(Fake())
    with pytest.raises(ValueError, match="1-D"):
        gc.forward(x.float(), w.float(), None, (1, 1), (1, 1), 2)


def test_tiny_msd_step_runs_on_the_card_branch(monkeypatch):
    """A stage-2 step of ``TINY`` with its grouped layers on the card branch
    (the aten stand-ins) and R1: finite, and every grouped layer's calls
    through the branch."""
    from music_synthesis_tpu_torch.train import stage2

    calls = []
    _fake_launchers(monkeypatch, calls)
    cfg = dataclasses.replace(config.TINY, train=dataclasses.replace(
        config.TINY.train, r1_gamma=1.0))
    state = stage2.make_train_state(cfg, seed=0, device="cpu")
    wav = 0.3 * torch.tanh(torch.randn(
        2, 2048, generator=torch.Generator().manual_seed(2)))
    state, metrics = stage2.train_step(cfg, state, wav)
    assert all(torch.isfinite(torch.tensor(v)) for v in metrics.values())
    layers = len(_msd_convs(cfg.msd, 2048, 2))
    assert sum(1 for c in calls if c == ("forward", True)) >= 3 * layers
    assert ("weight_grad", True, False) in calls


def _reader():
    import importlib.util

    path = REPO / "benchmark" / "metrics" / "grouped_conv_ms.py"
    spec = importlib.util.spec_from_file_location("grouped_conv_ms", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Tracer:
    def __init__(self, records):
        self.records = records

    def snapshot(self):
        return {"programs": {"stage2_step": {"records": self.records}}}


@pytest.mark.parametrize("case", ["both_regions", "parent", "too_few"])
def test_grouped_conv_ms_reads_the_median_replay(case, monkeypatch):
    """``benchmark/metrics/grouped_conv_ms.py``: per read replay the sum of
    ``grouped_conv.fwd`` and ``grouped_conv.bwd``, their median over at
    least 8 replays; None where no replay has the regions (a program whose
    grouped layers are library calls) or fewer are read."""
    from music_synthesis_tpu_torch.utils import profiling

    def record(i, regions):
        return {"replay_ms": 100.0 + i, "region_ms": dict(
            {"d_step": 50.0}, **regions)}

    if case == "parent":
        records = [record(i, {}) for i in range(12)]
    else:
        n = 12 if case == "both_regions" else 7
        records = [record(i, {"grouped_conv.fwd": 1.0 + i,
                              "grouped_conv.bwd": 2.0}) for i in range(n)]
        records.append({"replay_ms": None, "region_ms": {}})  # unread
    monkeypatch.setattr(profiling, "tracer", _Tracer(records))
    got = _reader().read({})
    if case == "both_regions":
        assert got == pytest.approx(3.0 + 5.5)  # median of 3 .. 14
    else:
        assert got is None
