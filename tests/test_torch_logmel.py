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


@pytest.mark.parametrize("n_mels", [128, 32, 160, 256])
def test_matches_pallas_interpret(n_mels):
    jcfg, cfg = _both(n_mels=n_mels)
    wav = _signal((2, 8192))
    want = np.asarray(pallas_log_mel(jnp.asarray(wav), jcfg, tile_frames=16,
                                     interpret=True, precision="exact"))
    got = L.fused_log_mel(torch.from_numpy(wav), cfg).numpy()
    assert got.shape == want.shape == (2, 29, n_mels)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_mels", [128, 32, 160, 256])
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
    before = L.logmel_launches.n_calls
    got = L.fused_log_mel_for_vocoder(x, cfg, precision="exact")
    got_fast = L.fused_log_mel_for_vocoder(x, cfg, precision="fast")
    assert L.logmel_launches.n_calls == before  # no kernel on the CPU
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
                                {"n_mels": 0}])
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


def _tf32_truncate(x):
    """The top 10 mantissa bits, as the kernel's split and the MMA read."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def _split_bases(n_fft, n_mels, fmin=0.0, fmax=11025.0, sample_rate=22050):
    """The stored parts ``[chunk, hi | lo, cos | sin, bin, column]`` read
    back as ``[hi | lo, cos | sin, k, bin]`` (bins of all chunks in order,
    samples in natural order: column ``phase * kp / 4 + j`` holds sample
    ``4 j + phase``)."""
    parts = L.split_bases(n_fft, sample_rate, n_mels, fmin, fmax,
                          torch.device("cpu")).numpy()
    chunks, _, _, bins, kp = parts.shape
    column = np.arange(kp)
    sample = 4 * (column % (kp // 4)) + column // (kp // 4)
    natural = np.empty_like(parts)
    natural[..., sample] = parts
    return natural.transpose(1, 2, 4, 0, 3).reshape(2, 2, kp, chunks * bins)


@pytest.mark.parametrize("n_fft, n_mels", [(1024, 128), (256, 32), (1000, 160)])
def test_bases_are_split_k_major(n_fft, n_mels):
    """The "fast" path's bases: per 64-bin chunk, hi and lo of cos and sin,
    each bin's samples contiguous (K-major) in phase order, zero-padded to
    whole ring stages of each of the 4 sample phases and a whole chunk of
    bins; hi + lo is the fp32 basis exactly and hi keeps at most 10
    mantissa bits."""
    c, s, _, n_used = L.logmel_constants(n_fft, 22050, n_mels, 0.0, 11025.0,
                                         torch.device("cpu"))
    stored = L.split_bases(n_fft, 22050, n_mels, 0.0, 11025.0,
                           torch.device("cpu"))
    kp = -(-n_fft // (4 * L.K_STAGE)) * 4 * L.K_STAGE
    assert L.K_PHASES == 4
    chunks = -(-n_used // L.CHUNK_BINS)
    assert stored.dtype == torch.float32 and stored.is_contiguous()
    assert stored.shape == (chunks, 2, 2, L.CHUNK_BINS, kp)
    # K-major: neighbouring samples of one bin are neighbours in memory.
    assert stored.stride()[-1] == 1 and stored.stride()[-2] == kp
    parts = _split_bases(n_fft, n_mels)
    hi, lo = parts
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    for cs, basis in enumerate((c.numpy(), s.numpy())):
        padded = np.pad(basis[:, :n_used],
                        ((0, kp - n_fft), (0, chunks * L.CHUNK_BINS - n_used)))
        np.testing.assert_array_equal(hi[cs] + lo[cs], padded)
        np.testing.assert_array_equal(_tf32_truncate(basis[:, :n_used]),
                                      hi[cs, :n_fft, :n_used])
        assert not parts[:, cs, n_fft:].any()
        assert not parts[:, cs, :, n_used:].any()


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("variant", ["log_mel", "for_vocoder"])
def test_3xtf32_arithmetic_matches_pallas_interpret(variant, split):
    """The "fast" kernel path's arithmetic, emulated on the CPU from the
    stored hi and lo bases as the kernel walks them: in phase order (stored
    column ``phase * kp / 4 + j`` against sample ``4 j + phase``), each
    phase summed on its own, rank r of a split taking phases r, r + split,
    ..., the phases' sums added in rank order; the frames split by
    truncation into TF32 hi + lo as the kernel does in registers;
    lo*hi + hi*lo + hi*hi, each operand read by the tensor cores through
    its top 10 mantissa bits. Against the Pallas kernel in interpret mode,
    within the 2e-4 of the fp32 comparisons above on this signal (the card
    holds the kernel itself to its plain version in chip_smoke.py)."""
    jcfg, cfg = _both(n_mels=80)
    wav = _signal((2, 4096), seed=12)
    if variant == "log_mel":
        want = np.asarray(pallas_log_mel(jnp.asarray(wav), jcfg, tile_frames=8,
                                         interpret=True, precision="exact"))
    else:
        want = np.asarray(pallas_log_mel_for_vocoder(
            jnp.asarray(wav), jcfg, tile_frames=8, interpret=True,
            precision="exact"))
    padded, n_frames = L.padded_input(torch.from_numpy(wav), cfg,
                                      variant == "for_vocoder")
    frames = padded.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :n_frames]
    x = frames.reshape(-1, cfg.n_fft).numpy().astype(np.float32)
    _, _, m, n_used = L.logmel_constants(cfg.n_fft, cfg.sample_rate,
                                         cfg.n_mels, cfg.fmin,
                                         cfg.fmax_resolved,
                                         torch.device("cpu"))
    stored = L.split_bases(cfg.n_fft, cfg.sample_rate, cfg.n_mels, cfg.fmin,
                           cfg.fmax_resolved, torch.device("cpu")).numpy()
    chunks, _, _, bins, kp = stored.shape
    # [hi | lo, cos | sin, column, bin], the columns as stored.
    b_hi, b_lo = (_tf32_truncate(part) for part in stored.transpose(
        1, 2, 4, 0, 3).reshape(2, 2, kp, chunks * bins)[..., :n_used])
    per = kp // L.K_PHASES
    x_pad = np.zeros((x.shape[0], kp), np.float32)
    x_pad[:, :cfg.n_fft] = x
    x_hi = _tf32_truncate(x_pad)
    x_lo = _tf32_truncate(x_pad - x_hi)
    re_im = 0.0
    for rank in range(split):
        for phase in range(rank, L.K_PHASES, split):
            k = L.K_PHASES * np.arange(per) + phase
            cols = slice(phase * per, (phase + 1) * per)
            re_im = re_im + np.stack([
                x_lo[:, k] @ bh[cols] + x_hi[:, k] @ bl[cols]
                + x_hi[:, k] @ bh[cols] for bh, bl in zip(b_hi, b_lo)])
    re, im = re_im
    power = re * re + im * im
    got = np.log(cfg.log_epsilon + power @ m.numpy()[:n_used])
    got = got.reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_fft, n_mels, fmin, fmax", [
    (1024, 128, 0.0, 11025.0), (1024, 160, 0.0, 11025.0),
    (512, 64, 30.0, 8000.0), (256, 32, 0.0, 11025.0), (1024, 7, 0.0, 11025.0)])
def test_mel_groups_cover_every_weight(n_fft, n_mels, fmin, fmax):
    """Every non-zero mel weight lies in its 64-bin chunk's group range, so
    the kernel's mel stage, which computes only those groups, adds exactly
    the terms the dense product adds (the others are zeros)."""
    _, _, m, n_used = L.logmel_constants(n_fft, 22050, n_mels, fmin, fmax,
                                         torch.device("cpu"))
    groups = L.mel_groups(n_fft, 22050, n_mels, fmin, fmax,
                          torch.device("cpu")).numpy()
    assert groups.shape == (-(-n_used // L.CHUNK_BINS), 2)
    bins, mels = np.nonzero(m.numpy()[:n_used])
    lo, hi = groups[bins // L.CHUNK_BINS].T
    assert ((lo <= mels // 32) & (mels // 32 <= hi)).all()
    # The group-skipping sum equals the dense product on a power spectrum.
    power = np.random.default_rng(13).random((5, n_used)).astype(np.float32)
    dense = power @ m.numpy()[:n_used]
    sparse = np.zeros_like(dense)
    for c, (g0, g1) in enumerate(groups):
        cols = slice(32 * g0, 32 * (g1 + 1))
        rows = slice(c * L.CHUNK_BINS, min((c + 1) * L.CHUNK_BINS, n_used))
        sparse[:, cols] += power[:, rows] @ m.numpy()[rows, cols]
    np.testing.assert_allclose(sparse, dense, rtol=1e-5, atol=1e-7)
