"""The port's stage-2 discriminators against the JAX package, on the CPU.

Under identical parameters (JAX's init with every weight-norm gain and bias
jittered, so that each layer has a gain near one and the logits are far
from zero), the same numpy waveform goes through the JAX
``CombinedDiscriminator`` and the port's; every logit and every feature tap
is compared after permuting the port's ``[B, C, ...]`` back to JAX's
channel-last layout. With ``dense_groups_max_g`` both packages run the
MSD's grouped convolutions of up to that many groups as dense ones over
block-diagonal kernels; JAX's MRD relayout ``f_fold`` must give what the
port's logical layer gives. Tolerance: 1e-4 of each tap's peak magnitude,
in fp32 (up to seven convolutions of up to 41 x 1024 terms, and FFTs on
the MRD side, summed in other orders).

The port's dense and grouped MSD, from one set of parameters (the
flagship's widths, fp32): every logit and tap, and the gradient of every
``v``, ``g`` and ``b`` of a loss over all of them, within 1e-5 of each
tensor's peak magnitude; the parameter names and shapes are the same, so
one ``state_dict`` loads into both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_synthesis_tpu import config as jax_config
from music_synthesis_tpu.models.discriminators import (
    CombinedDiscriminator as JaxDiscriminator,
)
from music_synthesis_tpu_torch import config
from music_synthesis_tpu_torch.convert import to_state_dict
from music_synthesis_tpu_torch.models.discriminators import (
    CombinedDiscriminator,
    MultiScaleDiscriminator,
)

torch.set_num_threads(1)

TOL = 1e-4


def _unit_gain(params, seed):
    rng = np.random.default_rng(seed)

    def f(path, p):
        r = rng.standard_normal(p.shape)
        name = path[-1].key
        if name == "g":
            return (np.sqrt(2.0) * (1.0 + 0.3 * r)).astype(np.float32)
        if name == "b":
            return (0.05 * r).astype(np.float32)
        return np.asarray(p)

    return jax.tree_util.tree_map_with_path(f, params)


def _wav(batch, length, seed=0):
    rng = np.random.default_rng(seed)
    return (0.5 * np.tanh(rng.standard_normal((batch, length)))
            ).astype(np.float32)


def _compare(jmsd, jmrd, pmsd, pmrd, wav, seed=0):
    jd = JaxDiscriminator(jmsd, jmrd)
    # Parameters depend only on the logical layers: init without relayouts.
    plain = JaxDiscriminator(
        dataclasses.replace(jmsd, dense_groups_max_g=0),
        dataclasses.replace(jmrd, f_fold=0))
    params = _unit_gain(plain.init(jax.random.PRNGKey(seed),
                                   jnp.asarray(wav))["params"], seed)
    want_logits, want_feats = jax.jit(
        lambda p, x: jd.apply({"params": p}, x))(params, jnp.asarray(wav))
    port = CombinedDiscriminator(pmsd, pmrd)
    port.load_state_dict(to_state_dict(params), strict=True)
    with torch.no_grad():
        logits, feats = port(torch.from_numpy(wav))
    assert len(logits) == len(want_logits) == len(feats) == len(want_feats)

    def close(got, want):
        got = np.moveaxis(got.float().numpy(), 1, -1)
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        scale = float(np.abs(want).max())
        assert scale > 1e-3  # far from a trivially zero tap
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)

    for got, want in zip(logits, want_logits):
        close(got, want)
    for head, want_head in zip(feats, want_feats):
        assert len(head) == len(want_head)
        for got, want in zip(head, want_head):
            close(got, want)


@pytest.mark.parametrize("input_mode", ["logmag", "complex"])
def test_tiny_discriminator_matches_jax(input_mode):
    jmrd = dataclasses.replace(jax_config.TINY.mrd, input_mode=input_mode)
    pmrd = dataclasses.replace(config.TINY.mrd, input_mode=input_mode)
    _compare(jax_config.TINY.msd, jmrd, config.TINY.msd, pmrd,
             _wav(2, 2048, seed=1), seed=1)


@pytest.mark.parametrize("dense_max_g, f_fold, input_mode", [
    (0, 0, "logmag"),
    (16, 4, "logmag"),   # the flagship's: dense MSD on both sides
    (0, 4, "complex"),
    (16, 0, "complex"),
])
def test_flagship_discriminator_matches_jax(dense_max_g, f_fold, input_mode):
    """The flagship's MSD and MRD at full width, batch 1 x 8192, fp32;
    with ``dense_max_g`` 16 JAX's dense MSD against the port's."""
    jmsd = dataclasses.replace(jax_config.MSDConfig(),
                               dense_groups_max_g=dense_max_g)
    jmrd = dataclasses.replace(jax_config.MRDConfig(), f_fold=f_fold,
                               input_mode=input_mode)
    pmsd = config.MSDConfig(dense_groups_max_g=dense_max_g)
    pmrd = config.MRDConfig(f_fold=f_fold, input_mode=input_mode)
    _compare(jmsd, jmrd, pmsd, pmrd, _wav(1, 8192, seed=2), seed=2)


@pytest.mark.parametrize("preset", ["TINY", "STAGE2_VOCODER_TRAIN"])
@pytest.mark.parametrize("input_mode", ["logmag", "complex"])
def test_seeded_init_has_jax_parameter_names_and_shapes(preset, input_mode):
    jcfg, cfg = getattr(jax_config, preset), getattr(config, preset)
    jd = JaxDiscriminator(
        jcfg.msd, dataclasses.replace(jcfg.mrd, input_mode=input_mode))
    shapes = jax.eval_shape(
        lambda: jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 8192))))
    want = {k: tuple(v.shape) for k, v in to_state_dict(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"])).items()}
    port = CombinedDiscriminator(
        cfg.msd, dataclasses.replace(cfg.mrd, input_mode=input_mode),
        torch.Generator().manual_seed(0))
    got = {k: tuple(v.shape) for k, v in port.named_parameters()}
    assert got == want


DENSE_TOL = 1e-5


def test_dense_groups_equal_grouped_convolutions_with_their_gradients():
    grouped_cfg = config.MSDConfig()
    dense_cfg = dataclasses.replace(grouped_cfg, dense_groups_max_g=16)
    grouped = MultiScaleDiscriminator(grouped_cfg,
                                      torch.Generator().manual_seed(3))
    dense = MultiScaleDiscriminator(dense_cfg)
    lowered = [n for n, m in dense.named_modules()
               if getattr(m, "dense_groups", False)]
    assert lowered == [f"scale_{s}.down_{i}" for s in range(3)
                       for i in range(2)]  # groups 4 and 16; 64, 256 stay
    assert {k: v.shape for k, v in dense.state_dict().items()} == {
        k: v.shape for k, v in grouped.state_dict().items()}
    # Gains near one and small biases (as ``_unit_gain``), so that each
    # layer keeps its input's scale and the logits are far from zero.
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in grouped.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if name.endswith(".g"):
                p.copy_(2.0 ** 0.5 * (1.0 + 0.3 * r))
            elif name.endswith(".b"):
                p.copy_(0.05 * r)
    dense.load_state_dict(grouped.state_dict(), strict=True)
    wav = torch.from_numpy(_wav(1, 8192, seed=4))

    def outputs_and_grads(module):
        logits, feats = module(wav)
        outs = logits + [f for head in feats for f in head]
        loss = sum((o.float() * torch.linspace(-1, 1, o.shape[-1])).sum()
                   for o in outs)
        names, params = zip(*module.named_parameters())
        grads = torch.autograd.grad(loss, params)
        return [o.detach() for o in outs], dict(zip(names, grads))

    want_outs, want_grads = outputs_and_grads(grouped)
    got_outs, got_grads = outputs_and_grads(dense)
    for got, want in zip(got_outs, want_outs):
        scale = float(want.abs().max())
        assert scale > 1e-3
        torch.testing.assert_close(got, want, rtol=0, atol=DENSE_TOL * scale)
    assert got_grads.keys() == want_grads.keys()
    for name, want in want_grads.items():
        scale = float(want.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(got_grads[name], want, rtol=0,
                                   atol=DENSE_TOL * scale, msg=name)
