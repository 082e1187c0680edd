"""The training slice's parts against the JAX package, on the CPU: configs,
the 2-D weight-normed conv and the MSD's average pool, the GAN and phase
losses, the optimizer, and the checkpoint.

Same numpy inputs go to both sides; parameters cross by
``convert.to_state_dict``. Tolerances: 1e-5 for fp32 layers and losses
(fp32 in another summation order), 2e-2 for bf16 layers (bf16 keeps ~3
significant digits, rounded at other places by XLA and PyTorch), 1e-6 for
the optimizer's parameters (elementwise fp32, the same operations).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_synthesis_tpu import config as jax_config
from music_synthesis_tpu.losses import gan as jax_gan
from music_synthesis_tpu.losses.phase_loss import (
    phase_coherence_loss as jax_phase_loss,
)
from music_synthesis_tpu.ops import conv as jax_conv
from music_synthesis_tpu.train.state import make_optimizer as jax_optimizer
from music_synthesis_tpu_torch import config
from music_synthesis_tpu_torch.convert import to_state_dict
from music_synthesis_tpu_torch.losses import gan
from music_synthesis_tpu_torch.losses.phase_loss import phase_coherence_loss
from music_synthesis_tpu_torch.ops import conv
from music_synthesis_tpu_torch.train import stage2
from music_synthesis_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from music_synthesis_tpu_torch.train.state import make_optimizer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN_CONFIGS = sorted(ROOT.glob("runs/*/config.json"))
FP32_TOL = 1e-5
BF16_TOL = 2e-2


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# --- configs -------------------------------------------------------------

def test_every_run_config_loads_equal_to_jax():
    assert len(RUN_CONFIGS) == 14
    for path in RUN_CONFIGS:
        d = json.loads(path.read_text())
        want = jax_config.config_from_dict(d)
        got = config.config_from_dict(d)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), path
        assert config.config_to_dict(got) == jax_config.config_to_dict(want)
        assert config.config_from_dict(config.config_to_dict(got)) == got


@pytest.mark.parametrize("name", [
    "FRONTEND_CPU_CLIP", "STAGE1_SINGLE_BATCH", "STAGE2_VOCODER_TRAIN",
    "E2E_INFERENCE", "E2E_INFERENCE_FAST", "DP_V5E8_TRAIN", "TINY"])
def test_presets_equal_jax(name):
    assert (dataclasses.asdict(getattr(config, name))
            == dataclasses.asdict(getattr(jax_config, name)))


@pytest.mark.parametrize("section", [
    "FrontendConfig", "MelScaler", "SpecGANConfig", "VocoderConfig",
    "MSDConfig", "MRDConfig", "STFTLossConfig", "TrainConfig",
    "InferConfig"])
def test_section_fields_and_defaults_equal_jax(section):
    def fields(mod):
        return [(f.name, f.default)
                for f in dataclasses.fields(getattr(mod, section))]

    assert fields(config) == fields(jax_config)


def test_config_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError):
        config.config_from_dict({"train": {"no_such_field": 1}})
    with pytest.raises(ValueError):
        config.config_from_dict({"no_such_section": {}})


def test_chip_smoke_flagship_literal_equals_the_run_config():
    """chip_smoke.py cannot read runs/ on the card's machine, so the
    flagship recipe it trains (``train.flagship``) carries the run's
    msd/mrd/stft_loss/train sections as a literal, and takes
    frontend/mel_scaler/vocoder from the zoo card."""
    from music_synthesis_tpu_torch.train.flagship import flagship_config

    run = config.config_from_dict(json.loads(
        (ROOT / "runs/stage2_istft_long/config.json").read_text()))
    got = flagship_config()
    for name in ("frontend", "mel_scaler", "vocoder", "msd", "mrd",
                 "stft_loss", "train"):
        assert getattr(got, name) == getattr(run, name), name


# --- layers --------------------------------------------------------------

@pytest.mark.parametrize("kernel, stride", [
    ((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 3), (1, 1)), ((3, 3), (1, 2))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wnconv2d_matches_jax(kernel, stride, dtype):
    cin, cout = 3, 5
    x = _rand((2, 7, 13, cin), seed=sum(kernel) + stride[1])  # [B, T, F, C]
    j = jax_conv.WNConv(cout, kernel, strides=stride, padding="same",
                        compute_dtype=dtype)
    params = j.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda p: np.asarray(p) * (
        1.0 + 0.2 * rng.standard_normal(p.shape)).astype(np.float32) + 0.05,
        params)
    want = np.asarray(j.apply({"params": params}, jnp.asarray(x))
                      .astype(jnp.float32))
    p = conv.WNConv(cin, cout, kernel, stride=stride, compute_dtype=dtype)
    p.load_state_dict(to_state_dict(params))
    with torch.no_grad():
        got = p(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == want.shape  # F' = ceil(F / stride)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("length, stride", [(16, 2), (17, 2), (5, 2),
                                            (9, 3)])
def test_avg_pool1d_matches_jax_at_the_edges(length, stride):
    x = _rand((2, length, 3), seed=length)
    want = np.asarray(jax_conv.avg_pool1d(jnp.asarray(x), 4, stride, 1))
    got = conv.avg_pool1d(torch.from_numpy(x).transpose(1, 2), 4, stride, 1)
    got = got.transpose(1, 2).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    # The first and last windows overlap the padding: divided by 3, not 4.
    np.testing.assert_allclose(got[:, 0], x[:, :3].mean(1), rtol=1e-6)


# --- losses --------------------------------------------------------------

def _logits(seed):
    return [_rand((2, 5, 1), seed, 1.5), _rand((2, 4, 3, 1), seed + 1, 1.5)]


@pytest.mark.parametrize("kind", ["hinge", "nonsat"])
def test_gan_losses_match_jax_values_and_gradients(kind):
    real, fake = _logits(1), _logits(3)

    def jax_loss(r, f):
        return (jax_gan.d_loss_fn(kind)(r, f)
                + 0.7 * jax_gan.g_loss_fn(kind)(f))

    want = float(jax_loss(real, fake))
    want_gr, want_gf = jax.grad(jax_loss, argnums=(0, 1))(
        [jnp.asarray(a) for a in real], [jnp.asarray(a) for a in fake])
    tr = [torch.tensor(a, requires_grad=True) for a in real]
    tf = [torch.tensor(a, requires_grad=True) for a in fake]
    got = gan.d_loss_fn(kind)(tr, tf) + 0.7 * gan.g_loss_fn(kind)(tf)
    got.backward()
    assert abs(got.item() - want) <= FP32_TOL * max(1.0, abs(want))
    for t, w in zip(tr + tf, list(want_gr) + list(want_gf)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=FP32_TOL, atol=1e-7)
    # A single head is taken as a list of one.
    assert torch.allclose(gan.d_loss_fn(kind)(tr[0], tf[0]),
                          gan.d_loss_fn(kind)([tr[0]], [tf[0]]))


def test_feature_matching_matches_jax_and_stops_real_gradients():
    real = [[_rand((2, 6, 3), 10), _rand((2, 3, 4), 11)], [_rand((2, 5), 12)]]
    fake = [[_rand((2, 6, 3), 20), _rand((2, 3, 4), 21)], [_rand((2, 5), 22)]]
    jr = jax.tree.map(jnp.asarray, real)
    jf = jax.tree.map(jnp.asarray, fake)
    want = float(jax_gan.feature_matching_loss(jr, jf))
    want_gf = jax.grad(lambda f: jax_gan.feature_matching_loss(jr, f))(jf)
    tr = [[torch.tensor(a, requires_grad=True) for a in h] for h in real]
    tf = [[torch.tensor(a, requires_grad=True) for a in h] for h in fake]
    got = gan.feature_matching_loss(tr, tf)
    got.backward()
    assert abs(got.item() - want) <= FP32_TOL
    for th, wh in zip(tf, want_gf):
        for t, w in zip(th, wh):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       rtol=FP32_TOL, atol=1e-7)
    assert all(t.grad is None for h in tr for t in h)


def test_phase_loss_matches_jax_values_and_gradients():
    y = 0.5 * np.tanh(_rand((2, 2048), 30))
    x = (y + 0.1 * _rand((2, 2048), 31)).astype(np.float32)
    want = float(jax_phase_loss(jnp.asarray(x), jnp.asarray(y), 256, 64))
    want_g = np.asarray(jax.grad(lambda a: jax_phase_loss(
        a, jnp.asarray(y), 256, 64))(jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    got = phase_coherence_loss(tx, torch.from_numpy(y), 256, 64)
    got.backward()
    assert abs(got.item() - want) <= FP32_TOL * abs(want)
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(tx.grad.numpy(), want_g, rtol=1e-4,
                               atol=FP32_TOL * scale)
    # Identical signals: zero loss.
    assert phase_coherence_loss(torch.from_numpy(y), torch.from_numpy(y),
                                256, 64).item() < 1e-6


# --- optimizer -----------------------------------------------------------

@pytest.mark.parametrize("knobs", [
    {},
    {"grad_clip_norm": 0.5},
    {"lr_decay_rate": 0.5, "lr_decay_every": 3},
    {"grad_clip_norm": 50.0, "lr_decay_rate": 0.9, "lr_decay_every": 1},
])
def test_optimizer_matches_optax(knobs):
    """Four updates of the port's Adam against optax's on the same
    gradients (clipped or not, constant or decaying lr)."""
    tcfg = dataclasses.replace(jax_config.TrainConfig(), **knobs)
    params = {"a": _rand((3, 4), 40), "b": _rand((5,), 41)}
    tx = jax_optimizer(1e-3, tcfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    opt = make_optimizer(1e-3, config.TrainConfig(**dataclasses.asdict(tcfg)))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = opt.init(tp)
    for i in range(4):
        grads = {k: _rand(v.shape, 50 + i, 2.0) for k, v in params.items()}
        ju, js = tx.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = opt.update({k: torch.from_numpy(grads[k]) for k in tp}, ts)
        tp = {k: p + u for (k, p), u in zip(tp.items(), tu)}
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
    assert ts.count == 4


def test_training_after_inference_on_the_same_device():
    """Serving and copy-synthesis run under inference_mode; the iSTFT
    head's cached bases must still be usable by a training step after."""
    import music_synthesis_tpu_torch.ops.istft as istft
    from music_synthesis_tpu_torch.infer.copy_synthesis import copy_synthesis
    from music_synthesis_tpu_torch.models.vocoder import Vocoder

    cfg = dataclasses.replace(config.TINY, vocoder=dataclasses.replace(
        config.TINY.vocoder, upsample_factors=(8, 8), head="istft"))
    istft._irdft_tensors.cache_clear()
    wav = torch.from_numpy(0.5 * np.tanh(_rand((2, 2048), 70)))
    copy_synthesis(Vocoder(cfg.vocoder), wav, cfg.frontend, cfg.mel_scaler,
                   cfg.stft_loss)
    state = stage2.make_train_state(cfg, seed=0, device="cpu")
    _, metrics = stage2.train_step(cfg, state, wav)
    assert np.isfinite(list(metrics.values())).all()


# --- checkpoint ----------------------------------------------------------

def test_checkpoint_restore_gives_a_bitwise_equal_next_step(tmp_path):
    cfg = dataclasses.replace(config.TINY, train=dataclasses.replace(
        config.TINY.train, d_input_noise=0.1, ema_decay=0.99, r1_gamma=1.0))
    wav = torch.from_numpy(0.5 * np.tanh(_rand((2, 2048), 60)))
    state = stage2.make_train_state(cfg, seed=3, device="cpu")
    state, _ = stage2.train_step(cfg, state, wav)
    save_checkpoint(tmp_path / "ckpt" / "state.pt", state)
    direct, m_direct = stage2.train_step(cfg, state, wav)
    restored = restore_checkpoint(tmp_path / "ckpt" / "state.pt", "cpu")
    resumed, m_resumed = stage2.train_step(cfg, restored, wav)
    assert m_direct == m_resumed
    assert resumed.step == direct.step == 2
    for a, b in ((direct.g_params, resumed.g_params),
                 (direct.d_params, resumed.d_params),
                 (direct.g_ema, resumed.g_ema),
                 (direct.g_opt.mu, resumed.g_opt.mu),
                 (direct.d_opt.nu, resumed.d_opt.nu)):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(direct.rng.get_state(), resumed.rng.get_state())
