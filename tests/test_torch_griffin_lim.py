"""The port's Griffin-Lim (``ops/griffin_lim.py``) and refined generation
against the JAX package, on the CPU.

Inputs: two seeded tone clips (0.4 s at 22.05 kHz, the flagship front-end:
n_fft 1024, hop 256, 128 mels) and the TINY composer and iSTFT vocoder of
``torch_tiny_ref``. Tolerances, each a few times the gap measured on this
CPU between the two packages:

- the mel pseudo-inverse: equal (both are ``np.linalg.pinv`` of the same
  filterbank); the magnitude: 1e-5 of its peak (the port's product runs in
  float64, the reference's in fp32);
- cold Griffin-Lim, sample by sample: 1e-6 at 0 iterations (measured
  1.2e-7), 1e-3 at 1 (1.3e-4) and 1e-2 at 8 (2.7e-3), of a 0.5 peak. Each
  iteration normalizes the phase of every bin, and in near-silent bins the
  two packages' rounding (1e-7) becomes an arbitrary phase, so the gap
  grows with the iterations. At 48 iterations the samples are not held;
  the spectral convergence against the target magnitude is, to 1e-3
  relative (measured 1.2e-4), and the multi-resolution STFT distance to
  the input clip to 1e-2 relative (1.4e-3);
- ``invert_log_mel`` (the magnitude and GL together): at 1 iteration as
  cold GL; at 48, where the two magnitudes' 1e-7 apart start two phase
  trajectories, spectral convergence and distance to 3e-2 relative
  (measured 6.9e-3 and 7.7e-3);
- warm-started refinement from the clip itself (well conditioned: no
  near-silent bin under a large target): 1e-5 at 0 iterations (measured
  1.1e-6), 1e-4 at 1 (2.0e-5), 2e-4 at 8 (4.8e-5, also through
  ``refine_with_log_mel``);
- refined generation from the TINY models: their random vocoder leaves
  bins near-silent where the composer's mel asks for energy, so the
  refinement's phase there is rounding noise in both packages (sample gap
  5.5e-3 at 0 iterations, 6.4e-2 at 8). It is held as the composition it
  is (the port's unrefined generation to 1e-4 of JAX's, and refined =
  ``refine_with_log_mel`` of it, exactly) and by the refinement's own
  objective: spectral convergence against the target magnitude within
  1e-2 relative of JAX's (measured 2.5e-4 to 1.1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_synthesis_tpu.config import FrontendConfig as JaxFrontend
from music_synthesis_tpu.infer import generate as jax_generate
from music_synthesis_tpu.losses.stft_loss import multires_stft_loss
from music_synthesis_tpu.ops import griffin_lim as jax_gl
from music_synthesis_tpu.ops.frontend import log_mel_for_vocoder, stft
from music_synthesis_tpu_torch.config import FrontendConfig
from music_synthesis_tpu_torch.infer import generate
from music_synthesis_tpu_torch.ops import griffin_lim as gl

from torch_tiny_ref import tiny_pair

torch.set_num_threads(1)

N_FFT, HOP = 1024, 256


def _tones(seconds=0.4, sr=22050):
    n = int(seconds * sr) // HOP * HOP
    t = np.arange(n) / sr
    rng = np.random.default_rng(0)
    return np.stack([
        0.3 * np.sin(2 * np.pi * 440 * t) + 0.15 * np.sin(2 * np.pi * 660 * t)
        + 0.01 * rng.standard_normal(n),
        0.25 * np.sin(2 * np.pi * 330 * t) * np.exp(-t * 2.0),
    ]).astype(np.float32)


@pytest.fixture(scope="module")
def clip():
    """(wav, vocoder-aligned log-mel, JAX's magnitude) of the tone clips."""
    x = _tones()
    lm = np.asarray(log_mel_for_vocoder(jnp.asarray(x), JaxFrontend()))
    mag = np.asarray(jax_gl.log_mel_to_magnitude(jnp.asarray(lm),
                                                 JaxFrontend()))
    return x, lm, mag


def _spectral_convergence(y, mag):
    """||(|STFT(y)| - mag)||_F / ||mag||_F on GL's own analysis grid."""
    trim = (N_FFT - HOP) // 2
    s = np.abs(np.asarray(stft(jnp.pad(jnp.asarray(y), ((0, 0), (trim, trim))),
                               N_FFT, HOP)))
    return float(np.linalg.norm(s - mag) / np.linalg.norm(mag))


@pytest.mark.parametrize("kw", [{}, {"n_mels": 32}, {"n_mels": 80,
                                                     "fmax": 8000.0}])
def test_mel_pinv_matches_jax(kw):
    np.testing.assert_array_equal(gl.mel_pinv_matrix(FrontendConfig(**kw)),
                                  jax_gl.mel_pinv_matrix(JaxFrontend(**kw)))


@pytest.mark.parametrize("power", [2.0, 1.0])
def test_log_mel_to_magnitude_matches_jax(clip, power):
    _, lm, _ = clip
    want = np.asarray(jax_gl.log_mel_to_magnitude(
        jnp.asarray(lm), JaxFrontend(power=power)))
    got = gl.log_mel_to_magnitude(torch.from_numpy(lm),
                                  FrontendConfig(power=power)).numpy()
    assert got.shape == (2, lm.shape[1], N_FFT // 2 + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())


@pytest.mark.parametrize("n_iter, tol", [(0, 1e-6), (1, 1e-3), (8, 1e-2)])
def test_griffin_lim_matches_jax(clip, n_iter, tol):
    _, _, mag = clip
    want = np.asarray(jax_gl.griffin_lim(jnp.asarray(mag), N_FFT, HOP,
                                         n_iter=n_iter))
    got = gl.griffin_lim(torch.from_numpy(mag), N_FFT, HOP,
                         n_iter=n_iter).numpy()
    assert got.shape == (2, mag.shape[1] * HOP)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_griffin_lim_48_matches_jax_by_distance(clip):
    x, _, mag = clip
    want = np.asarray(jax_gl.griffin_lim(jnp.asarray(mag), N_FFT, HOP))
    got = gl.griffin_lim(torch.from_numpy(mag), N_FFT, HOP).numpy()
    sc_want, sc_got = (_spectral_convergence(y, mag) for y in (want, got))
    assert sc_want < 0.35  # converging: 0.85 from zero phase
    np.testing.assert_allclose(sc_got, sc_want, rtol=1e-3)
    d_want, d_got = (float(multires_stft_loss(jnp.asarray(y), jnp.asarray(x)))
                     for y in (want, got))
    np.testing.assert_allclose(d_got, d_want, rtol=1e-2)


@pytest.mark.parametrize("n_iter, tol", [(0, 1e-5), (1, 1e-4), (8, 2e-4)])
def test_griffin_lim_refine_matches_jax(clip, n_iter, tol):
    x, _, mag = clip
    want = np.asarray(jax_gl.griffin_lim_refine(
        jnp.asarray(mag), jnp.asarray(x), N_FFT, HOP, n_iter=n_iter))
    got = gl.griffin_lim_refine(torch.from_numpy(mag), torch.from_numpy(x),
                                N_FFT, HOP, n_iter=n_iter).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_refine_with_log_mel_matches_jax(clip):
    x, lm, _ = clip
    want = np.asarray(jax_gl.refine_with_log_mel(
        jnp.asarray(x), jnp.asarray(lm), JaxFrontend(), n_iter=8))
    got = gl.refine_with_log_mel(torch.from_numpy(x), torch.from_numpy(lm),
                                 FrontendConfig(), n_iter=8).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("n_iter", [1, 48])
def test_invert_log_mel_matches_jax(clip, n_iter):
    """One iteration sample by sample (1e-3, as cold GL); 48, the eval's
    anchor, by spectral convergence and distance (3e-2)."""
    x, lm, mag = clip
    want = np.asarray(jax_gl.invert_log_mel(jnp.asarray(lm), JaxFrontend(),
                                            n_iter))
    got = gl.invert_log_mel(torch.from_numpy(lm), FrontendConfig(),
                            n_iter).numpy()
    if n_iter == 1:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        return
    np.testing.assert_allclose(_spectral_convergence(got, mag),
                               _spectral_convergence(want, mag), rtol=3e-2)
    d_want, d_got = (float(multires_stft_loss(jnp.asarray(y), jnp.asarray(x)))
                     for y in (want, got))
    np.testing.assert_allclose(d_got, d_want, rtol=3e-2)


def test_gl_ignores_the_tf32_switch(clip):
    """On the CPU the switch reads nothing; the card test holds the same
    on cuBLAS (tests/test_torch_gpu.py)."""
    x, lm, _ = clip
    args = (torch.from_numpy(lm), FrontendConfig(), 2)
    before = gl.invert_log_mel(*args)
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        after = gl.invert_log_mel(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert torch.equal(before, after)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.mark.parametrize("n_iter", [0, 2, 8])
@pytest.mark.parametrize("long", [False, True], ids=["generate", "long"])
def test_refined_generation_matches_jax(pair, n_iter, long):
    jcfg, cfg, sp, vp, comp, voc = pair
    rng = np.random.default_rng(6)
    shape = (2, 3, 16) if long else (2, 16)
    z = rng.standard_normal(shape).astype(np.float32)
    zt = torch.from_numpy(z)
    with torch.no_grad():
        if long:
            got = generate.generate_long_refined(cfg, comp, voc, zt, 4, n_iter)
            wav = generate.generate_long(cfg, comp, voc, zt, 4)
            mel = generate.stitch_long_mel(cfg, comp, zt, 4)
        else:
            got = generate.generate_refined(cfg, comp, voc, zt, n_iter)
            wav = generate.generate(cfg, comp, voc, zt)
            mel = comp(zt)
        lm = mel * cfg.mel_scaler.scale + cfg.mel_scaler.shift
        assert torch.equal(got, gl.refine_with_log_mel(wav, lm, cfg.frontend,
                                                       n_iter))
    if long:
        want = jax_generate.generate_long_refined(jcfg, sp, vp, jnp.asarray(z),
                                                  4, n_iter)
        wav_want = jax_generate.generate_long(jcfg, sp, vp, jnp.asarray(z), 4)
        lm_want = jax_generate.stitch_long_mel(jcfg, sp, jnp.asarray(z), 4)
    else:
        want = jax_generate.generate_refined(jcfg, sp, vp, jnp.asarray(z),
                                             n_iter)
        wav_want = jax_generate.generate(jcfg, sp, vp, jnp.asarray(z))
        lm_want = jax.jit(lambda z: jax_generate.SpectrogramGenerator(
            jcfg.specgan).apply({"params": sp}, z))(jnp.asarray(z))
    np.testing.assert_allclose(wav.numpy(), np.asarray(wav_want), rtol=1e-4,
                               atol=1e-4)
    lm_want = np.asarray(lm_want) * jcfg.mel_scaler.scale + jcfg.mel_scaler.shift
    mag = np.asarray(jax_gl.log_mel_to_magnitude(jnp.asarray(lm_want),
                                                 jcfg.frontend))
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(_spectral_convergence(got.numpy(), mag),
                               _spectral_convergence(want, mag), rtol=1e-2)


def test_refined_generation_uses_the_frontend_of_cfg(pair):
    """The pseudo-inverse follows ``cfg.frontend`` (TINY: 32 mels)."""
    _, cfg, _, _, comp, voc = pair
    assert cfg.frontend.n_mels == 32
    z = torch.zeros((1, 16))
    with torch.no_grad():
        got = generate.generate_refined(cfg, comp, voc, z, 1)
    assert got.shape == (1, cfg.specgan.n_frames * cfg.frontend.hop_length)
    bad = dataclasses.replace(cfg, frontend=FrontendConfig(n_mels=64))
    with pytest.raises(RuntimeError):
        generate.generate_refined(bad, comp, voc, z, 1)
