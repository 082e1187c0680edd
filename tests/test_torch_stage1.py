"""The port's stage-1 composer training against the JAX package's, on the CPU.

- ``SpectrogramDiscriminator``: the logit and every feature tap, from
  converted JAX weights with gains near one, on TINY and at the flagship's
  width (kernel 5, stride 2 over 128 frames, where an off-by-one in the
  "same" padding split would still give the right lengths), within 1e-5
  relative to the largest value.
- ``forward_and_loss`` and ``train_step``: from a JAX state two steps in
  (gains near one, then two JAX steps, so both Adam states hold moments;
  ``torch_train_ref`` says why), with JAX's latents and instance noise
  injected, one and three steps, under the flagship's knobs (R1, decaying
  noise, flux, EMA, hinge) and under the logistic loss with reused real
  features. Every metric to 1e-4 relative, every G, D and EMA parameter to
  1e-5 absolute (the tolerances of ``torch_train_ref``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ref as ref
from music_synthesis_tpu import config as jax_config
from music_synthesis_tpu.models.specgan import (
    SpectrogramDiscriminator as JaxDisc,
)
from music_synthesis_tpu.train import stage1 as jax_stage1
from music_synthesis_tpu_torch import config
from music_synthesis_tpu_torch.convert import (
    to_state_dict,
    train_state_from_jax,
)
from music_synthesis_tpu_torch.models.specgan import SpectrogramDiscriminator
from music_synthesis_tpu_torch.train import stage1

torch.set_num_threads(1)

PRE_STEPS = 2
# The stage-1 flagship recipe (runs/stage1_flux_40k/config.json) at TINY's
# size, its noise decay cut from 10000 to 8 steps so that it moves here.
FLAGSHIP = dict(batch_size=2, r1_gamma=1.0, d_input_noise=0.2,
                d_noise_decay_steps=8, lambda_flux=10.0, ema_decay=0.999,
                reuse_real_features=True)
VARIANTS = {
    "flagship": FLAGSHIP,
    "nonsat_reuse": dict(batch_size=2, gan_loss="nonsat",
                         reuse_real_features=True, ema_decay=0.999),
}


def configs(train):
    jcfg = dataclasses.replace(jax_config.TINY, train=dataclasses.replace(
        jax_config.TINY.train, **train))
    return jcfg, config.config_from_dict(jax_config.config_to_dict(jcfg))


def real_mel(shape=(2, 32, 32), seed=5):
    rng = np.random.default_rng(seed)
    return (0.8 * np.tanh(rng.standard_normal(shape))).astype(np.float32)


def jax_draws(rng, cfg, shape):
    """The latents and the three noise normals JAX's step draws."""
    rng, zk = jax.random.split(rng)
    z = np.array(jax.random.normal(zk, (shape[0], cfg.specgan.latent_dim)))
    noise = None
    if cfg.train.d_input_noise > 0:
        _, nk = jax.random.split(rng)
        noise = [np.array(jax.random.normal(k, shape, jnp.float32))
                 for k in jax.random.split(nk, 3)]
    return z, noise


def warm_jax_state(jcfg, mel):
    st = jax_stage1.make_train_state(jcfg, jax.random.PRNGKey(0))
    g = ref._unit_gain(st.g_params, 1, out_gain=0.05)
    st = st.replace(g_params=g, d_params=ref._unit_gain(st.d_params, 2),
                    g_ema=jax.tree.map(jnp.copy, g))
    for _ in range(PRE_STEPS):
        st, _ = jax_stage1.train_step(jcfg, st, jnp.asarray(mel))
    return st.replace(step=jnp.asarray(PRE_STEPS, jnp.int32))


@pytest.fixture(scope="module", params=list(VARIANTS))
def run(request):
    jcfg, cfg = configs(VARIANTS[request.param])
    mel = real_mel()
    st = warm_jax_state(jcfg, mel)
    st0 = ref.numpy_state(st)
    steps = []
    for _ in range(3):
        z, noise = jax_draws(st.rng, jcfg, mel.shape)
        st, m = jax_stage1.train_step(jcfg, st, jnp.asarray(mel))
        steps.append((ref.numpy_state(st), {k: float(v) for k, v in m.items()},
                      z, noise))
    return dict(name=request.param, jcfg=jcfg, cfg=cfg, mel=mel, st0=st0,
                steps=steps)


def port_steps(run, n):
    st = train_state_from_jax(run["st0"], device="cpu")
    out = []
    for _, _, z, noise in run["steps"][:n]:
        st, m = stage1.train_step(run["cfg"], st, torch.from_numpy(run["mel"]),
                                  z=z, noise=noise)
        out.append((st, m))
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(run, n_steps):
    for i, ((jst, jm, _, _), (pst, pm)) in enumerate(
            zip(run["steps"], port_steps(run, n_steps))):
        where = f"{run['name']} step {PRE_STEPS + i}"
        ref.assert_metrics_close(pm, jm, where)
        ref.assert_params_close(pst, jst, where)
        assert pst.step == int(jst.step) == PRE_STEPS + i + 1
        assert pst.g_opt.count == pst.d_opt.count == PRE_STEPS + i + 1


def test_metric_keys_are_jax_keys(run):
    t = run["cfg"].train
    keys = {"d_loss", "g_loss", "g_rms_ratio", "g_adv", "g_fm",
            "d_grad_norm", "g_grad_norm", "d_update_norm", "g_update_norm"}
    keys |= {"d_r1"} if t.r1_gamma > 0 else set()
    keys |= {"g_flux"} if t.lambda_flux > 0 else set()
    assert set(run["steps"][0][1]) == keys


def test_forward_and_loss_matches_jax(run):
    z, _ = jax_draws(jax.random.PRNGKey(3), run["jcfg"], run["mel"].shape)
    want = jax_stage1.forward_and_loss(
        run["jcfg"], jax.tree.map(jnp.asarray, run["st0"]),
        jnp.asarray(run["mel"]), jnp.asarray(z))
    got = stage1.forward_and_loss(
        run["cfg"], train_state_from_jax(run["st0"], device="cpu"),
        run["mel"], z)
    ref.assert_metrics_close(got, {k: float(v) for k, v in want.items()},
                             "forward_and_loss")


def test_steps_draw_from_the_state_generator():
    """Without injected draws, a step draws its latents and noise from the
    state's generator: equal states take equal steps, and the input state
    is left as it was."""
    _, cfg = configs(FLAGSHIP)
    st = stage1.make_train_state(cfg, seed=4, device="cpu")
    before = st.rng.get_state().clone()
    a, ma = stage1.train_step(cfg, st, real_mel())
    b, mb = stage1.train_step(cfg, st, real_mel())
    assert ma == mb and torch.equal(st.rng.get_state(), before)
    assert all(torch.equal(a.g_params[k], b.g_params[k]) for k in a.g_params)
    assert not torch.equal(a.rng.get_state(), before)
    c, _ = stage1.train_step(cfg, a, real_mel())
    assert c.step == 2


@pytest.mark.parametrize("specgan, mel_shape", [
    (jax_config.TINY.specgan, (2, 32, 32)),
    (jax_config.SpecGANConfig(), (1, 128, 128)),  # flagship width
])
def test_discriminator_logit_and_taps_match_jax(specgan, mel_shape):
    mel = real_mel(mel_shape, seed=9)
    disc = JaxDisc(specgan)
    params = disc.init(jax.random.PRNGKey(1), jnp.asarray(mel))["params"]
    params = ref._unit_gain(params, 3)
    want_logit, want_feats = disc.apply({"params": params}, jnp.asarray(mel))
    port = SpectrogramDiscriminator(config.SpecGANConfig(**dataclasses.asdict(
        specgan)))
    port.load_state_dict(to_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        logit, feats = port(torch.from_numpy(mel))
    assert logit.dtype == torch.float32
    pairs = [(logit, want_logit)] + list(zip(feats, want_feats))
    assert len(feats) == len(specgan.disc_channels)
    for got, want in pairs:
        want = np.asarray(want)
        got = got.transpose(1, 2).numpy()  # [B, C, T] -> JAX's [B, T, C]
        assert got.shape == want.shape
        scale = np.abs(want).max()
        assert scale > 1e-2
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_fresh_state_has_jax_names_and_shapes():
    jcfg, cfg = configs(FLAGSHIP)
    st = stage1.make_train_state(cfg, seed=0, device="cpu")
    want = jax_stage1.make_train_state(jcfg, jax.random.PRNGKey(0))
    for got, w in ((st.g_params, want.g_params), (st.d_params, want.d_params),
                   (st.g_ema, want.g_ema)):
        w = to_state_dict(jax.tree.map(np.asarray, w))
        assert {k: v.shape for k, v in got.items()} == {
            k: v.shape for k, v in w.items()}


def test_make_train_state_runs_on_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, cfg = configs(FLAGSHIP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage1.make_train_state(cfg)


def test_chip_smoke_stage1_literal_equals_the_run_config():
    """chip_smoke.py cannot read runs/ on the card's machine, so the
    stage-1 flagship it trains (``train.flagship.stage1_flagship_config``)
    carries the train section of ``runs/stage1_flux_40k/config.json`` as a
    literal and takes the rest from ``zoo/specgan_flux``'s card."""
    import json
    from pathlib import Path

    from music_synthesis_tpu_torch.train.flagship import (
        stage1_flagship_config,
    )

    run = config.config_from_dict(json.loads(
        (Path(__file__).resolve().parents[1]
         / "runs/stage1_flux_40k/config.json").read_text()))
    got = stage1_flagship_config()
    for name in ("frontend", "mel_scaler", "specgan", "train"):
        assert getattr(got, name) == getattr(run, name), name
