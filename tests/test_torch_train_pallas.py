"""The stage-2 step of the port with the flagship's conditioning path (the
fused log-mel kernel, ``use_pallas_frontend``) and the iSTFT head, against
the JAX package's, on the CPU: three steps across the warmup gate from one
converted JAX state (``torch_train_ref``; every metric to 1e-4 relative,
every G, D and EMA parameter to 1e-5 absolute), and the conditioning
alone.

On a CPU tensor the port's kernel wrapper computes its plain fp32 version,
and JAX's kernel runs in interpret mode, as ``train/stage2.py`` runs it on
the CPU. The step is held to JAX's kernel in its "exact" mode (the same
fp32 function); JAX's default "fast" mode (bf16x3) is held to the port's
conditioning within that kernel's 2e-2 gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ref as ref
from music_synthesis_tpu.train.stage2 import (
    conditioning_mel as jax_conditioning_mel,
)
from music_synthesis_tpu_torch.train import stage2

torch.set_num_threads(1)


def test_three_steps_with_the_fused_conditioning_and_istft_head_match_jax(
        monkeypatch):
    ref.exact_pallas(monkeypatch)
    jcfg, cfg = ref.configs(dict(use_pallas_frontend=True),
                            dict(upsample_factors=(8, 8), head="istft"))
    wav = ref.waveform()
    st0 = ref.warm_jax_state(jcfg, wav)
    steps = ref.run_jax(jcfg, st0, wav, 3)
    port = ref.run_port(cfg, ref.numpy_state(st0), wav, steps)
    for i, ((jst, jm, _), (pst, pm)) in enumerate(zip(steps, port)):
        where = f"step {ref.PRE_STEPS + i}"
        ref.assert_metrics_close(pm, jm, where)
        ref.assert_params_close(pst, jst, where)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_conditioning_matches_jax(use_pallas, monkeypatch):
    """Normalized log-mel conditioning: 2e-4 in log-mel (the fp32 tolerance
    of tests/test_torch_logmel.py) over MelScaler's scale; JAX's "fast"
    kernel within 2e-2 over the same scale."""
    jcfg, cfg = ref.configs(dict(use_pallas_frontend=use_pallas))
    wav = ref.waveform(3)
    got = stage2.conditioning_mel(torch.from_numpy(wav), cfg).numpy()
    assert got.shape == (2, 2048 // cfg.frontend.hop_length,
                         cfg.frontend.n_mels)
    scale = cfg.mel_scaler.scale
    if use_pallas:
        fast = np.asarray(jax_conditioning_mel(jnp.asarray(wav), jcfg))
        np.testing.assert_allclose(got, fast, rtol=0, atol=2e-2 / scale)
        ref.exact_pallas(monkeypatch)
    want = np.asarray(jax_conditioning_mel(jnp.asarray(wav), jcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 / scale)
