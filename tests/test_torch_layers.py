"""The port's layers against the JAX package's, on the CPU.

Same numpy inputs and the same (JAX-initialised) parameters go through each
JAX layer and its port; parameters cross by ``convert.to_state_dict``.
fp32 layers are held at 1e-5 (fp32 in another summation order); bf16
layers at 2e-2 (bf16 keeps ~3 significant digits, rounded at other places
by XLA and PyTorch). ``_msgpack`` must reproduce Flax's restore exactly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from music_synthesis_tpu.losses.stft_loss import (
    multires_stft_loss as jax_multires,
)
from music_synthesis_tpu.losses.stft_loss import stft_distance as jax_distance
from music_synthesis_tpu.ops import conv as jax_conv
from music_synthesis_tpu.ops import istft as jax_istft
from music_synthesis_tpu.ops import overlap_add as jax_ola
from music_synthesis_tpu.ops.frontend import magnitude_stft as jax_mag_stft
from music_synthesis_tpu_torch import _msgpack
from music_synthesis_tpu_torch.config import STFTLossConfig
from music_synthesis_tpu_torch.convert import to_state_dict
from music_synthesis_tpu_torch.losses.stft_loss import (
    multires_stft_loss,
    stft_distance,
)
from music_synthesis_tpu_torch.ops import conv, istft, overlap_add
from music_synthesis_tpu_torch.ops.frontend import magnitude_stft

torch.set_num_threads(1)

FP32_TOL = 1e-5
BF16_TOL = 2e-2
ZOO_FILES = sorted((Path(__file__).resolve().parents[1] / "zoo")
                   .glob("*/params.msgpack"))


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _jax_params(module, x, seed):
    """Random JAX params (g and b perturbed away from their init)."""
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(
        lambda p: np.asarray(p) * (1.0 + 0.1 * rng.standard_normal(p.shape))
        .astype(np.float32) + 0.01, params)


def _run_conv(jax_module, port_module, x, seed):
    """x: [B, L, C] numpy -> (jax out, port out) as [B, L', C'] numpy."""
    params = _jax_params(jax_module, x, seed)
    want = jax_module.apply({"params": params}, jnp.asarray(x))
    port_module.load_state_dict(to_state_dict(params))
    got = port_module(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    return np.asarray(want.astype(jnp.float32)), got.float().detach().numpy()


@pytest.mark.parametrize("k, stride, dilation, padding, groups", [
    (7, 1, 1, "reflect", 1),   # vocoder conv_in / conv_out
    (3, 1, 3, "reflect", 1),   # dilated residual conv
    (3, 1, 9, "reflect", 1),
    (1, 1, 1, "same", 1),      # pointwise / shortcut
    (5, 2, 1, "same", 1),      # strided 'same' (stage-1 critic)
    (4, 1, 1, "same", 1),      # even kernel: the extra pad goes right
    (5, 1, 1, "valid", 2),     # grouped, no padding
])
@pytest.mark.parametrize("weight_norm", [True, False])
def test_wnconv_fp32(k, stride, dilation, padding, groups, weight_norm):
    cin, cout = 8, 6
    x = _rand((2, 40, cin), seed=k + dilation)
    j = jax_conv.WNConv(cout, (k,), strides=(stride,), dilations=(dilation,),
                        groups=groups, padding=padding,
                        use_weight_norm=weight_norm)
    p = conv.WNConv(cin, cout, k, stride=stride, dilation=dilation,
                    groups=groups, padding=padding, use_weight_norm=weight_norm)
    want, got = _run_conv(j, p, x, seed=k)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("k, stride", [
    (4, 2), (8, 4), (16, 8),   # the models' k = 2u
    (3, 3), (6, 3), (5, 2),    # k == s, odd stride, odd kernel
])
def test_wnconv_transpose_fp32(k, stride):
    cin, cout = 6, 5
    x = _rand((2, 9, cin), seed=k * stride)
    j = jax_conv.WNConvTranspose1d(cout, kernel_size=k, stride=stride)
    p = conv.WNConvTranspose1d(cin, cout, k, stride)
    want, got = _run_conv(j, p, x, seed=k)
    assert got.shape == want.shape == (2, 9 * stride, cout)
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("u", [2, 4, 8])
def test_conv_transpose_padding_matches_the_closed_form(u):
    """For k = 2u the JAX equivalence reduces to padding u // 2."""
    assert conv.conv_transpose_padding(2 * u, u)[1] == u // 2


def test_bf16_compute_dtype():
    """Params stay fp32; activations come out in bf16, close to JAX's bf16."""
    x = _rand((2, 32, 8), seed=1)
    j = jax_conv.WNConv(8, (3,), dilations=(3,), padding="reflect",
                        compute_dtype="bfloat16")
    p = conv.WNConv(8, 8, 3, dilation=3, padding="reflect",
                    compute_dtype="bfloat16")
    want, got = _run_conv(j, p, x, seed=2)
    assert all(t.dtype == torch.float32 for t in p.parameters())
    assert p(torch.from_numpy(x).transpose(1, 2)).dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)

    jt = jax_conv.WNConvTranspose1d(4, kernel_size=8, stride=4,
                                    compute_dtype="bfloat16")
    pt = conv.WNConvTranspose1d(8, 4, 8, 4, compute_dtype="bfloat16")
    want, got = _run_conv(jt, pt, x, seed=3)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("n_fft, hop", [(16, 4), (8, 2), (32, 8)])
def test_istft_synthesis(n_fft, hop):
    bins = n_fft // 2 + 1
    re, im = _rand((2, 12, bins), 1), _rand((2, 12, bins), 2)
    want = jax_istft.istft_synthesis(jnp.asarray(re), jnp.asarray(im),
                                      n_fft, hop, precision="highest")
    got = istft.istft_synthesis(torch.from_numpy(re), torch.from_numpy(im),
                                n_fft, hop)
    assert got.shape == want.shape == (2, 12 * hop)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)
    jic, jis = jax_istft.irdft_matrices(n_fft)
    ic, is_ = istft.irdft_matrices(n_fft)
    np.testing.assert_array_equal(ic, jic)
    np.testing.assert_array_equal(is_, jis)


@pytest.mark.parametrize("n, c, hop", [(5, 16, 4), (3, 10, 4), (4, 8, 8),
                                       (6, 64, 32)])
def test_overlap_add(n, c, hop):
    chunks = _rand((2, 3, n, c), seed=n + c)
    want = jax_ola.overlap_add(jnp.asarray(chunks), hop)
    got = overlap_add.overlap_add(torch.from_numpy(chunks), hop)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("c, hop", [(64, 32), (48, 32), (16, 16), (120, 112)])
def test_ola_window_and_normalizer(c, hop):
    want_w = np.asarray(jax_ola.ola_window(c, hop))
    got_w = overlap_add.ola_window(c, hop)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=FP32_TOL,
                               atol=FP32_TOL)
    want_n = jax_ola.ola_normalizer(jnp.asarray(want_w), 5, hop)
    got_n = overlap_add.ola_normalizer(got_w, 5, hop)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n),
                               rtol=FP32_TOL, atol=FP32_TOL)


def test_magnitude_stft_and_distances():
    """|STFT| to 1e-4 (rfft vs XLA's FFT on values up to ~50); the
    distances are reductions of it, to 1e-4 relative."""
    x, y = _rand((2, 4096), 1, 0.3), _rand((2, 4096), 2, 0.3)
    want = jax_mag_stft(jnp.asarray(x), 512, 128, 512)
    got = magnitude_stft(torch.from_numpy(x), 512, 128, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for res in ((256, 64, 256), (512, 128, 512), (1024, 256, 1024)):
        want_sc, want_mag = jax_distance(jnp.asarray(x), jnp.asarray(y), *res)
        sc, mag = stft_distance(tx, ty, *res)
        np.testing.assert_allclose(float(sc), float(want_sc), rtol=1e-4)
        np.testing.assert_allclose(float(mag), float(want_mag), rtol=1e-4)
    want_total = jax_multires(jnp.asarray(x), jnp.asarray(y))
    got_total = multires_stft_loss(tx, ty, STFTLossConfig())
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-4)
    assert float(multires_stft_loss(tx, tx)) == 0.0


def _assert_same_tree(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(b, dict):
        assert list(a) == list(b), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("path", ZOO_FILES, ids=lambda p: p.parent.name)
def test_msgpack_reads_zoo_files_like_flax(path):
    data = path.read_bytes()
    _assert_same_tree(_msgpack.restore(data),
                      serialization.msgpack_restore(data))


def test_msgpack_scalar_and_container_types():
    obj = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1,
                    -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1,
                    -2**63],
           "floats": [0.5, -1.25e300], "str": "x" * 40 + "é",
           "long_str": "y" * 70000, "bin": b"\x00\x01" * 200,
           "none": None, "bools": [True, False],
           "nested": {str(i): list(range(i)) for i in range(20)}}
    packed = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.unpackb(packed) == msgpack.unpackb(packed, raw=False)
    f32 = msgpack.packb(np.float32(1.5).item(), use_single_float=True)
    assert _msgpack.unpackb(f32) == 1.5


def test_msgpack_arrays_like_flax():
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": {"c": np.array([1, -2], np.int64)},
            "e": np.zeros((0, 3), np.float16)}
    data = serialization.msgpack_serialize(tree)
    _assert_same_tree(_msgpack.restore(data),
                      serialization.msgpack_restore(data))


def test_msgpack_rejects_what_it_does_not_read():
    """Truncated or trailing bytes, Flax's scalar ext type, and a file that
    is not a parameter tree: ValueError, never a wrong tree."""
    data = ZOO_FILES[0].read_bytes() if ZOO_FILES else msgpack.packb({"a": 1})
    with pytest.raises(ValueError):
        _msgpack.restore(data[: len(data) // 2])
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="ext type"):
        _msgpack.restore(serialization.msgpack_serialize({"s": np.float32(1)}))
    with pytest.raises(ValueError, match="parameter tree"):
        _msgpack.restore(msgpack.packb([1, 2]))
