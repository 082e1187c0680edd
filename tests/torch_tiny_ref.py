"""TINY models on random JAX-initialised parameters, jittered so that their
outputs are far from zero, carried into the port by ``convert.py``: the
shared fixtures of the port's inference tests. Imports JAX."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from music_synthesis_tpu import config as jax_config
from music_synthesis_tpu.models.specgan import (
    SpectrogramGenerator as JaxGenerator,
)
from music_synthesis_tpu.models.vocoder import Vocoder as JaxVocoder
from music_synthesis_tpu_torch import config
from music_synthesis_tpu_torch.convert import to_state_dict
from music_synthesis_tpu_torch.models.specgan import SpectrogramGenerator
from music_synthesis_tpu_torch.models.vocoder import Vocoder

ISTFT = dict(upsample_factors=(8, 8), head="istft")


def jitter(params, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (np.asarray(p) + scale * rng.standard_normal(p.shape))
        .astype(np.float32), params)


def tiny_vocoder(seed=0, **kw):
    """(JAX module, JAX params, port module) of a TINY vocoder."""
    jcfg = dataclasses.replace(jax_config.TINY.vocoder, **kw)
    cfg = dataclasses.replace(config.TINY.vocoder, **kw)
    mel0 = jnp.zeros((1, 8, jcfg.n_mels))
    params = jitter(JaxVocoder(jcfg).init(jax.random.PRNGKey(seed), mel0)
                    ["params"], seed)
    port = Vocoder(cfg)
    port.load_state_dict(to_state_dict(params))
    return JaxVocoder(jcfg), params, port.eval()


def tiny_composer(seed=1):
    """(JAX module, JAX params, port module) of a TINY composer."""
    jcfg, cfg = jax_config.TINY.specgan, config.TINY.specgan
    z0 = jnp.zeros((1, jcfg.latent_dim))
    params = jitter(JaxGenerator(jcfg).init(jax.random.PRNGKey(seed), z0)
                    ["params"], seed)
    port = SpectrogramGenerator(cfg)
    port.load_state_dict(to_state_dict(params))
    return JaxGenerator(jcfg), params, port.eval()


def tiny_pair(seed=4):
    """TINY composer + iSTFT vocoder: (JAX cfg, port cfg, JAX composer and
    vocoder params, port composer and vocoder)."""
    jcfg = dataclasses.replace(
        jax_config.TINY,
        vocoder=dataclasses.replace(jax_config.TINY.vocoder, **ISTFT))
    cfg = dataclasses.replace(
        config.TINY, vocoder=dataclasses.replace(config.TINY.vocoder, **ISTFT))
    _, vp, voc = tiny_vocoder(seed=seed, **ISTFT)
    _, sp, comp = tiny_composer(seed=seed + 1)
    return jcfg, cfg, sp, vp, comp, voc


def save_tiny_zoo(root, seed=11):
    """The TINY composer and iSTFT vocoder saved as JAX zoo entries
    ``composer_t`` and ``vocoder_t`` under ``root``."""
    from music_synthesis_tpu import zoo as jax_zoo

    jv_cfg = dataclasses.replace(jax_config.TINY.vocoder, **ISTFT)
    _, vp, _ = tiny_vocoder(seed=seed, **ISTFT)
    _, sp, _ = tiny_composer(seed=seed + 1)
    t = jax_config.TINY
    jax_zoo.save_pretrained("composer_t", "specgan", sp, t.specgan,
                            frontend=t.frontend, mel_scaler=t.mel_scaler,
                            root=root)
    jax_zoo.save_pretrained("vocoder_t", "vocoder", vp, jv_cfg,
                            frontend=t.frontend, mel_scaler=t.mel_scaler,
                            root=root)
    return root
