"""The port's log-mel front-end against the JAX package, on the CPU.

On a CPU tensor the fused log-mel wrapper computes its plain PyTorch
version (the CUDA kernel itself is held to that version on the card, in
tests/test_torch_gpu.py and chip_smoke.py). Here the plain version is held
to the JAX Pallas kernel in interpret mode with precision="exact" and to
the JAX oracle, at the 2e-4 tolerance tests/test_pallas_frontend.py uses
(fp32 GEMMs in a different summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_synthesis_tpu.config import FrontendConfig as JaxFrontendConfig
from music_synthesis_tpu.ops.frontend import log_mel as jax_log_mel
from music_synthesis_tpu.ops.frontend import (
    log_mel_for_vocoder as jax_log_mel_for_vocoder,
)
from music_synthesis_tpu.ops.pallas_frontend import (
    pallas_log_mel,
    pallas_log_mel_for_vocoder,
)
from music_synthesis_tpu_torch import _device
from music_synthesis_tpu_torch.config import FrontendConfig
from music_synthesis_tpu_torch.ops import frontend as torch_frontend
from music_synthesis_tpu_torch.ops import logmel as L

torch.set_num_threads(1)

TOL = 2e-4  # fp32 vs fp32 in another summation order


def _signal(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (0.5 * np.tanh(rng.standard_normal(shape))).astype(np.float32)


def _both(**kw):
    return JaxFrontendConfig(**kw), FrontendConfig(**kw)


@pytest.mark.parametrize("n_mels", [128, 32])
def test_matches_pallas_interpret(n_mels):
    jcfg, cfg = _both(n_mels=n_mels)
    wav = _signal((2, 8192))
    want = np.asarray(pallas_log_mel(jnp.asarray(wav), jcfg, tile_frames=16,
                                     interpret=True, precision="exact"))
    got = L.fused_log_mel(torch.from_numpy(wav), cfg).numpy()
    assert got.shape == want.shape == (2, 29, n_mels)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_mels", [128, 32])
def test_vocoder_variant_matches_pallas_interpret(n_mels):
    jcfg, cfg = _both(n_mels=n_mels)
    wav = _signal((2, 4096), seed=1)
    want = np.asarray(pallas_log_mel_for_vocoder(
        jnp.asarray(wav), jcfg, tile_frames=8, interpret=True,
        precision="exact"))
    got = L.fused_log_mel_for_vocoder(torch.from_numpy(wav), cfg).numpy()
    assert got.shape == want.shape == (2, 16, n_mels)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_non_tile_multiple_frames():
    """11 frames: not a multiple of the TPU tile (8) or the CUDA tile (32)."""
    jcfg, cfg = _both(n_mels=32)
    wav = _signal((1, 1024 + 256 * 10), seed=2)
    want = np.asarray(pallas_log_mel(jnp.asarray(wav), jcfg, tile_frames=8,
                                     interpret=True, precision="exact"))
    got = L.fused_log_mel(torch.from_numpy(wav), cfg).numpy()
    assert got.shape == want.shape == (1, 11, 32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_magnitude_mode():
    jcfg, cfg = _both(n_mels=32, power=1.0)
    wav = _signal((1, 4096), seed=3)
    want = np.asarray(pallas_log_mel(jnp.asarray(wav), jcfg, tile_frames=8,
                                     interpret=True, precision="exact"))
    got = L.fused_log_mel(torch.from_numpy(wav), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    want_v = np.asarray(jax_log_mel_for_vocoder(jnp.asarray(wav), jcfg))
    got_v = L.fused_log_mel_for_vocoder(torch.from_numpy(wav), cfg).numpy()
    np.testing.assert_allclose(got_v, want_v, rtol=TOL, atol=TOL)


def test_center_mode():
    jcfg, cfg = _both(n_mels=32, center=True)
    wav = _signal((1, 4096), seed=4)
    want = np.asarray(pallas_log_mel(jnp.asarray(wav), jcfg, tile_frames=8,
                                     interpret=True, precision="exact"))
    got = L.fused_log_mel(torch.from_numpy(wav), cfg).numpy()
    assert got.shape == want.shape == (1, 4096 // 256 + 1, 32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("variant", ["log_mel", "for_vocoder"])
def test_n_fft_equal_to_hop_is_supported(variant):
    """n_fft == hop, where the reference's `_pallas_log_mel_core` divides
    by zero: held to the JAX oracle instead."""
    jcfg, cfg = _both(n_fft=256, win_length=256, hop_length=256, n_mels=32)
    wav = _signal((2, 4096), seed=5)
    if variant == "log_mel":
        want = np.asarray(jax_log_mel(jnp.asarray(wav), jcfg))
        got = L.fused_log_mel(torch.from_numpy(wav), cfg).numpy()
    else:
        want = np.asarray(jax_log_mel_for_vocoder(jnp.asarray(wav), jcfg))
        got = L.fused_log_mel_for_vocoder(torch.from_numpy(wav), cfg).numpy()
    assert got.shape == want.shape == (2, 16, 32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [
    {}, {"n_mels": 32}, {"power": 1.0, "n_mels": 32},
    {"center": True, "n_mels": 64}, {"fmin": 30.0, "fmax": 8000.0},
])
def test_plain_and_torch_oracle_match_jax_oracle(kw):
    """Both the plain version and the port's torch.fft oracle
    (ops/frontend.py) against ops.frontend.log_mel / log_mel_for_vocoder."""
    jcfg, cfg = _both(**kw)
    wav = _signal((2, 6000), seed=6)
    x = torch.from_numpy(wav)
    want = np.asarray(jax_log_mel(jnp.asarray(wav), jcfg))
    np.testing.assert_allclose(L.log_mel_plain(x, cfg).numpy(), want,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(torch_frontend.log_mel(x, cfg).numpy(), want,
                               rtol=TOL, atol=TOL)
    want_v = np.asarray(jax_log_mel_for_vocoder(jnp.asarray(wav), jcfg))
    np.testing.assert_allclose(L.log_mel_for_vocoder_plain(x, cfg).numpy(),
                               want_v, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        torch_frontend.log_mel_for_vocoder(x, cfg).numpy(), want_v,
        rtol=TOL, atol=TOL)


def test_constants_equal_the_reference():
    """Bases and mel matrix are bit-identical to the JAX package's numpy
    constants; n_used stops at the last bin with a mel weight."""
    from music_synthesis_tpu.ops.frontend import dft_matrices, mel_matrix

    c, s, m, n_used = L.logmel_constants(1024, 22050, 128, 0.0, 11025.0,
                                         torch.device("cpu"))
    jc, js = dft_matrices(1024, 513)  # the reference, unpadded
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_array_equal(s.numpy(), js)
    jm = mel_matrix(22050, 1024, 128, 0.0, 11025.0)
    np.testing.assert_array_equal(m.numpy(), jm)
    assert n_used == 512 and not jm[512:].any() and jm[511].any()


def test_cpu_tensor_takes_the_plain_version():
    cfg = FrontendConfig(n_mels=32)
    x = torch.from_numpy(_signal((2, 4096), seed=7))
    before = L.logmel_kernel.n_launches
    got = L.fused_log_mel_for_vocoder(x, cfg, precision="exact")
    got_fast = L.fused_log_mel_for_vocoder(x, cfg, precision="fast")
    assert L.logmel_kernel.n_launches == before  # no kernel on the CPU
    want = L.log_mel_for_vocoder_plain(x, cfg)
    assert torch.equal(got, want) and torch.equal(got_fast, want)


def test_kernel_binding_refuses_cpu_tensors():
    """The kernel itself takes only CUDA tensors: no silent CPU path."""
    x = torch.zeros(1, 4096)
    with pytest.raises(ValueError, match="CUDA"):
        L.logmel_kernel(x, FrontendConfig(), 13)


def test_cuda_without_a_card_raises(monkeypatch):
    """Asking for the card where there is none raises; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _device.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _device.resolve_device("cuda")
    assert _device.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("bad, err", [
    (lambda x: x.double(), TypeError),
    (lambda x: x[:, ::2], ValueError),
    (lambda x: x[0], ValueError),
])
def test_wrapper_rejects_bad_input(bad, err):
    x = torch.from_numpy(_signal((2, 4096), seed=8))
    with pytest.raises(err):
        L.fused_log_mel(bad(x), FrontendConfig())


@pytest.mark.parametrize("kw", [{"power": 0.5}, {"win_length": 512},
                                {"n_mels": 129}])
def test_wrapper_rejects_unsupported_configs(kw):
    x = torch.from_numpy(_signal((1, 4096), seed=9))
    with pytest.raises(ValueError):
        L.fused_log_mel(x, FrontendConfig(**kw))
    with pytest.raises(ValueError):
        L.fused_log_mel(x, FrontendConfig(), precision="bf16")


@pytest.mark.parametrize("variant, length, kw", [
    ("log_mel", 1000, {}),                     # shorter than n_fft
    ("log_mel", 300, {"center": True}),        # shorter than the pad (512)
    ("for_vocoder", 200, {}),                  # shorter than the pad (384)
    ("for_vocoder", 255, {"n_fft": 256, "win_length": 256,
                          "hop_length": 256}),  # no whole hop
])
def test_too_short_signals_are_rejected(variant, length, kw):
    """A clear ValueError, from the wrapper and the plain version alike."""
    x = torch.from_numpy(_signal((1, length), seed=10))
    cfg = FrontendConfig(**kw)
    fns = ((L.fused_log_mel, L.log_mel_plain) if variant == "log_mel" else
           (L.fused_log_mel_for_vocoder, L.log_mel_for_vocoder_plain))
    for fn in fns:
        with pytest.raises(ValueError, match="too short"):
            fn(x, cfg)
