"""Shared set-up of the stage-2 training-step tests (``test_torch_train_*``):
a JAX reference run and the port's run from one converted state.

The state. JAX's own ``make_train_state`` on TINY, with every weight-norm
gain set near one (``g = sqrt(2) (1 + 0.3 r)``, the generator's output conv
at 0.05 so its tanh works in its linear range) and small random biases,
then two JAX steps with the warmup gate open (the state's step set past
the gate, so the same compiled step serves), so that both Adam states hold
moments. The compared steps start there, at step 2, under the flagship's
training knobs with ``g_warmup_steps = 4``: two steps inside the gate, the
third past it.

Why not JAX's fresh init. Adam's first update is ``lr * g / (|g| + 1e-8)``,
about ``lr * sign(g)``, so a gradient element that sits at rounding level
(a hinge bias whose real and fake terms cancel exactly, a near-silent STFT
bin) can move by +lr on one side and -lr on the other, twenty times the
parameter tolerance, while every metric agrees. With moments in the state,
the update is a smooth function of the gradient.

The instance noise is JAX's own realisation (``split(rng)``, then
``split(nk, 3)``), passed to the port's step.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from music_synthesis_tpu import config as jax_config
from music_synthesis_tpu.train import stage2 as jax_stage2
from music_synthesis_tpu_torch import config
from music_synthesis_tpu_torch.convert import (
    to_state_dict,
    train_state_from_jax,
)
from music_synthesis_tpu_torch.train import stage2

METRIC_RTOL = 1e-4  # every metric, relative
PARAM_ATOL = 1e-5  # every G, D and EMA parameter: 1/10 of one step at lr 1e-4

# The flagship's training knobs at TINY's size (the flagship recipe in
# runs/stage2_istft_long/config.json has warmup 5000, noise decay 20000).
FLAGSHIP_KNOBS = dict(
    batch_size=2, segment_length=2048, r1_gamma=1.0, d_input_noise=0.1,
    d_noise_decay_steps=8, g_warmup_steps=4, ema_decay=0.999,
    concat_disc_batch=True, reuse_real_features=True)
PRE_STEPS = 2


def configs(train=None, vocoder=None):
    """(JAX config, port config) of TINY with the flagship's knobs and
    ``train``/``vocoder`` overrides."""
    jcfg = dataclasses.replace(
        jax_config.TINY,
        train=dataclasses.replace(jax_config.TINY.train,
                                  **{**FLAGSHIP_KNOBS, **(train or {})}),
        vocoder=dataclasses.replace(jax_config.TINY.vocoder,
                                    **(vocoder or {})))
    return jcfg, config.config_from_dict(jax_config.config_to_dict(jcfg))


def waveform(seed=7):
    rng = np.random.default_rng(seed)
    return (0.5 * np.tanh(rng.standard_normal((2, 2048)))).astype(np.float32)


def _unit_gain(params, seed, out_gain=None):
    rng = np.random.default_rng(seed)

    def f(path, p):
        r = rng.standard_normal(p.shape)
        name = path[-1].key
        if name == "g":
            gain = (out_gain if out_gain is not None
                    and path[0].key == "conv_out" else np.sqrt(2.0))
            return jnp.asarray((gain * (1.0 + 0.3 * r)).astype(np.float32))
        if name == "b":
            return jnp.asarray((0.05 * r).astype(np.float32))
        return p

    return jax.tree_util.tree_map_with_path(f, params)


def warm_jax_state(jcfg, wav):
    """The JAX state the compared steps start from (see the module doc)."""
    st = jax_stage2.make_train_state(jcfg, jax.random.PRNGKey(0))
    g = _unit_gain(st.g_params, 1, out_gain=0.05)
    st = st.replace(g_params=g, d_params=_unit_gain(st.d_params, 2),
                    g_ema=(jax.tree.map(jnp.copy, g)
                           if st.g_ema is not None else None))
    st = st.replace(step=jnp.asarray(1000, jnp.int32))  # past the gate
    for _ in range(PRE_STEPS):
        st, _ = jax_stage2.train_step(jcfg, st, jnp.asarray(wav))
    return st.replace(step=jnp.asarray(PRE_STEPS, jnp.int32))


def jax_noise(rng, shape):
    """The three normals JAX's step draws from ``state.rng``."""
    _, nk = jax.random.split(rng)
    return [np.array(jax.random.normal(k, shape, jnp.float32))
            for k in jax.random.split(nk, 3)]


def numpy_state(st):
    return jax.tree.map(np.asarray, st)


def run_jax(jcfg, st, wav, n_steps):
    """[(numpy state after the step, metrics, the step's noise)]. ``st``
    is copied first: the JAX step donates its state."""
    st = jax.tree.map(jnp.copy, st)
    out = []
    for _ in range(n_steps):
        noise = jax_noise(st.rng, wav.shape)
        st, m = jax_stage2.train_step(jcfg, st, jnp.asarray(wav))
        out.append((numpy_state(st), {k: float(v) for k, v in m.items()},
                    noise))
    return out


def run_port(cfg, jax_state0, wav, ref):
    """The port's steps from the converted state, with JAX's noise:
    [(port state after the step, metrics)]."""
    st = train_state_from_jax(jax_state0, device="cpu")
    out = []
    for _, _, noise in ref:
        st, m = stage2.train_step(cfg, st, torch.from_numpy(wav), noise=noise)
        out.append((st, m))
    return out


def assert_metrics_close(got: dict, want: dict, where: str):
    assert set(got) == set(want), where
    for k, w in want.items():
        assert abs(got[k] - w) <= METRIC_RTOL * abs(w), (
            f"{where}: {k} {got[k]!r} vs JAX {w!r}")


def assert_params_close(port_state, jax_state, where: str):
    pairs = [("g", port_state.g_params, jax_state.g_params),
             ("d", port_state.d_params, jax_state.d_params),
             ("ema", port_state.g_ema, jax_state.g_ema)]
    for name, got, want in pairs:
        assert (got is None) == (want is None), where
        if got is None:
            continue
        want = to_state_dict(want)
        assert got.keys() == want.keys()
        for k in want:
            err = (got[k] - want[k]).abs().max().item()
            assert err <= PARAM_ATOL, f"{where}: {name} {k} off by {err}"


def exact_pallas(monkeypatch):
    """JAX's fused log-mel kernel (interpret mode on the CPU) in its
    "exact" mode: the port's kernel on a CPU tensor computes the fp32
    function, which the reference's bf16x3 "fast" mode only approximates
    (to its 2e-2 gate)."""
    from music_synthesis_tpu.ops import pallas_frontend

    monkeypatch.setattr(
        pallas_frontend, "pallas_log_mel_for_vocoder",
        functools.partial(pallas_frontend.pallas_log_mel_for_vocoder,
                          precision="exact"))
