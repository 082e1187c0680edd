"""The port's serving and copy-synthesis path against the JAX package.

TINY models on random JAX-initialised parameters (jittered so the outputs
are far from zero), carried across by ``convert.py``; the full-width zoo
models on their committed weights. Same numpy inputs go to both sides.
Tolerances: 1e-4 for fp32 pipelines (fp32 convolutions and FFTs in another
summation order, through several layers), 2e-2 for the zoo vocoder in its
card's bf16.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_synthesis_tpu import config as jax_config
from music_synthesis_tpu import zoo as jax_zoo
from music_synthesis_tpu.infer import generate as jax_generate
from music_synthesis_tpu.losses.stft_loss import multires_stft_loss
from music_synthesis_tpu.models.specgan import (
    SpectrogramGenerator as JaxGenerator,
)
from music_synthesis_tpu.models.vocoder import Vocoder as JaxVocoder
from music_synthesis_tpu.serve import ServeConfig as JaxServeConfig
from music_synthesis_tpu.serve import SynthService as JaxSynthService
from music_synthesis_tpu.train.stage2 import conditioning_mel
from music_synthesis_tpu_torch import config, zoo
from music_synthesis_tpu_torch.infer import generate
from music_synthesis_tpu_torch.infer.copy_synthesis import (
    CopySynthesizer,
    copy_synthesis,
)
from music_synthesis_tpu_torch.serve import ServeConfig, SynthService

import torch_tiny_ref
from torch_tiny_ref import ISTFT
from torch_tiny_ref import tiny_composer as _tiny_composer
from torch_tiny_ref import tiny_vocoder as _tiny_vocoder

torch.set_num_threads(1)

TOL = 1e-4
BF16_TOL = 2e-2


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    assert np.abs(want).max() > 1e-2  # a non-trivial output
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("kw", [{}, ISTFT, {"upsample_mode": "repeat"}],
                         ids=["waveform", "istft", "repeat"])
def test_tiny_vocoder_matches_jax(kw):
    jv, params, port = _tiny_vocoder(**kw)
    mel = np.random.default_rng(2).standard_normal((2, 12, 32)).astype(np.float32)
    want = jv.apply({"params": params}, jnp.asarray(mel))
    with torch.no_grad():
        got = port(torch.from_numpy(mel))
    _close(got, want)


def test_tiny_composer_matches_jax():
    jg, params, port = _tiny_composer()
    z = np.random.default_rng(3).standard_normal((3, 16)).astype(np.float32)
    want = jg.apply({"params": params}, jnp.asarray(z))
    with torch.no_grad():
        got = port(torch.from_numpy(z))
    assert got.shape == (3, 32, 32)
    _close(got, want)


@pytest.fixture(scope="module")
def tiny_pair():
    """TINY composer + iSTFT vocoder: (jax cfg, port cfg, jax params x2,
    port modules x2)."""
    return torch_tiny_ref.tiny_pair(seed=4)


@pytest.mark.parametrize("crossfade", [8, 0])
def test_generate_long_matches_jax(tiny_pair, crossfade):
    jcfg, cfg, sp, vp, comp, voc = tiny_pair
    z = np.random.default_rng(6).standard_normal((2, 3, 16)).astype(np.float32)
    want = jax_generate.generate_long(jcfg, sp, vp, jnp.asarray(z), crossfade)
    with torch.no_grad():
        got = generate.generate_long(cfg, comp, voc, torch.from_numpy(z),
                                     crossfade)
        mel = generate.stitch_long_mel(cfg, comp, torch.from_numpy(z),
                                       crossfade)
    _close(got, want)
    _close(mel, jax_generate.stitch_long_mel(jcfg, sp, jnp.asarray(z),
                                             crossfade))


def test_generate_and_generate_direct_match_jax(tiny_pair):
    jcfg, cfg, sp, vp, comp, voc = tiny_pair
    z = np.random.default_rng(7).standard_normal((2, 16)).astype(np.float32)
    with torch.no_grad():
        got = generate.generate(cfg, comp, voc, torch.from_numpy(z))
        got_direct = generate.generate_direct(cfg, comp, voc,
                                              torch.from_numpy(z))
    _close(got, jax_generate.generate(jcfg, sp, vp, jnp.asarray(z)))
    _close(got_direct, jax_generate.generate_direct(jcfg, sp, vp,
                                                    jnp.asarray(z)))


def test_chunk_frames_matches_jax():
    mel = np.arange(2 * 40 * 3, dtype=np.float32).reshape(2, 40, 3)
    want = jax_generate.chunk_frames(jnp.asarray(mel), 16, 8)
    got = generate.chunk_frames(torch.from_numpy(mel), 16, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        generate.chunk_frames(torch.from_numpy(mel), 16, 7)


@pytest.mark.parametrize("pallas", [False, True], ids=["oracle", "pallas"])
def test_copy_synthesis_matches_jax(tiny_pair, pallas):
    """wav -> log-mel -> MelScaler -> vocoder -> wav and its distance, with
    the JAX conditioning from the oracle or the Pallas kernel (interpret
    mode, the package's default "fast" precision, gated at 2e-2 against
    the oracle: 2e-2 here on the mel and on what follows from it)."""
    jcfg, cfg, _, vp, _, voc = tiny_pair
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, use_pallas_frontend=pallas))
    rng = np.random.default_rng(8)
    wav = (0.3 * np.sin(np.arange(4200) * 0.05)[None]
           + 0.05 * rng.standard_normal((2, 4200))).astype(np.float32)
    x = jnp.asarray(wav[:, : 4200 // 256 * 256])
    y_want = JaxVocoder(jcfg.vocoder).apply(
        {"params": vp}, conditioning_mel(x, jcfg))
    d_want = float(multires_stft_loss(y_want, x, jcfg.stft_loss))
    y, d = copy_synthesis(voc, torch.from_numpy(wav), cfg.frontend,
                          cfg.mel_scaler, cfg.stft_loss, precision="exact")
    tol = 2e-2 if pallas else TOL
    _close(y, y_want, tol)
    np.testing.assert_allclose(float(d), d_want, rtol=tol)


def test_zoo_cards_and_parameter_counts():
    assert {"vocoder_istft", "specgan_flux"} <= set(zoo.list_pretrained())
    for name, n in (("vocoder_istft", 4_333_860), ("specgan_flux", 2_878_720)):
        e = zoo.load_pretrained(name)
        je = jax_zoo.load_pretrained(name)
        assert e.card["n_params"] == n
        assert sum(t.numel() for t in e.state_dict.values()) == n
        assert dataclasses.asdict(e.config) == dataclasses.asdict(je.config)
        assert dataclasses.asdict(e.frontend) == dataclasses.asdict(je.frontend)
        assert dataclasses.asdict(e.mel_scaler) == dataclasses.asdict(je.mel_scaler)
    with pytest.raises(FileNotFoundError):
        zoo.load_pretrained("no_such_entry")


@pytest.mark.parametrize("dtype, tol", [("float32", TOL), (None, BF16_TOL)],
                         ids=["fp32", "card_bf16"])
def test_zoo_vocoder_full_width_matches_jax(dtype, tol):
    je = jax_zoo.load_pretrained("vocoder_istft")
    jcfg = je.config if dtype is None else dataclasses.replace(
        je.config, compute_dtype=dtype)
    mel = (0.5 * np.random.default_rng(9).standard_normal((1, 16, 128))
           ).astype(np.float32)
    want = JaxVocoder(jcfg).apply({"params": je.params}, jnp.asarray(mel))
    with torch.no_grad():
        got = zoo.load_pretrained("vocoder_istft").model("cpu", dtype)(
            torch.from_numpy(mel))
    assert got.shape == (1, 16 * 256)
    _close(got, want, tol)


def test_zoo_composer_full_width_matches_jax():
    je = jax_zoo.load_pretrained("specgan_flux")
    z = np.random.default_rng(10).standard_normal((1, 128)).astype(np.float32)
    want = JaxGenerator(je.config).apply({"params": je.params}, jnp.asarray(z))
    with torch.no_grad():
        got = zoo.load_pretrained("specgan_flux").model("cpu")(
            torch.from_numpy(z))
    _close(got, want)


def test_copy_synthesizer_full_width_on_cpu():
    """The entry point on the CPU with the card's vocoder: shape, finite
    output, and no kernel launch (the plain version runs on the CPU)."""
    from music_synthesis_tpu_torch.ops.logmel import logmel_kernel

    before = logmel_kernel.n_launches
    cs = CopySynthesizer("vocoder_istft", device="cpu")
    wav = 0.3 * np.sin(np.arange(2 * 3000) * 0.03).reshape(2, 3000)
    y, dist = cs(wav)
    assert y.shape == (2, 3000 // 256 * 256) and torch.isfinite(y).all()
    assert np.isfinite(dist) and dist > 0
    assert logmel_kernel.n_launches == before


@pytest.fixture(scope="module")
def tiny_zoo(tmp_path_factory):
    """TINY composer + iSTFT vocoder saved as JAX zoo entries."""
    return torch_tiny_ref.save_tiny_zoo(tmp_path_factory.mktemp("zoo"),
                                        seed=11)


SERVE = dict(composer="composer_t", vocoder="vocoder_t", batch_buckets=(1, 2),
             patch_buckets=(1, 2, 4), crossfade_frames=4,
             max_clips_per_request=4)


@pytest.fixture(scope="module")
def services(tiny_zoo):
    jax_svc = JaxSynthService(
        JaxServeConfig(zoo_root=str(tiny_zoo), **SERVE),
        base_cfg=jax_config.TINY, warmup=False)
    svc = SynthService(ServeConfig(zoo_root=str(tiny_zoo), **SERVE),
                       base_cfg=config.TINY, device="cpu", warmup=False)
    return jax_svc, svc


def test_service_bucketing_matches_jax(services):
    jax_svc, svc = services
    for n in range(1, 7):
        assert svc.out_samples(n) == jax_svc.out_samples(n)
    sr = svc.cfg.frontend.sample_rate
    for seconds in (1e-3, 0.05, 0.1, 0.2, 0.3, 0.5, 1.0, 10.0):
        assert svc.patches_for_seconds(seconds) == \
            jax_svc.patches_for_seconds(seconds)
    for n_clips in range(1, 5):
        assert svc.batch_bucket(n_clips) == jax_svc.batch_bucket(n_clips)
    assert svc.out_samples(1) / sr < 0.5


@pytest.mark.parametrize("seconds, n_clips", [(0.1, 1), (0.25, 3)])
def test_service_synth_matches_jax_on_the_same_latents(services, seconds,
                                                      n_clips):
    """A request through the port's service equals the JAX program on the
    port's latents, trimmed and loudness-calibrated as the JAX service
    does (the two services' own seeds give different latents)."""
    jax_svc, svc = services
    wav, meta = svc.synth(seconds, seed=7, n_clips=n_clips)
    n = svc.patches_for_seconds(seconds)
    z = svc._z_rows(7, n_clips, n).numpy()
    want = np.asarray(jax_generate.generate_long(
        jax_svc.cfg, jax_svc._composer.params, jax_svc._vocoder.params,
        jnp.asarray(z), SERVE["crossfade_frames"]))[:, : meta["samples"]]
    rms = np.sqrt(np.mean(np.square(want), axis=-1, keepdims=True))
    want = np.clip(want * (0.1 / np.maximum(rms, 1e-8)), -1.0, 1.0)
    assert meta["patches"] == n and meta["samples"] == min(
        int(round(seconds * svc.cfg.frontend.sample_rate)), svc.out_samples(n))
    assert wav.shape == (n_clips, meta["samples"])
    _close(wav, want)
    again, _ = svc.synth(seconds, seed=7, n_clips=n_clips)
    np.testing.assert_array_equal(again, wav)


def test_service_validates_requests(services):
    _, svc = services
    with pytest.raises(ValueError):
        svc.synth(0.1, n_clips=0)
    with pytest.raises(ValueError):
        svc.synth(0.1, n_clips=5)
    with pytest.raises(ValueError):
        svc.synth(0.0)
    m = svc.metrics()
    assert m["requests"] >= 0 and m["device_calls"] >= m["requests"]
