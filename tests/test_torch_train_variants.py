"""The port's stage-2 ``train_step`` against the JAX package's under the
other knobs of the step, on the CPU: three steps across the warmup gate
from one converted JAX state, as in ``test_torch_train_step.py`` (same
state, same tolerances: every metric to 1e-4 relative, every G, D and EMA
parameter to 1e-5 absolute).

Each case turns several knobs at once, so that few JAX compilations cover
them all: the logistic loss with global-norm clipping and the exponential
lr decay; the frame energy and phase losses with G's forward recomputed in
its backward; and the reference-shaped step (no instance noise, no R1, no
EMA, no warmup, D on real and fake in two passes, FM target from the D
step's taps). The fused log-mel conditioning and the iSTFT head are in
``test_torch_train_pallas.py``.
"""

import pytest
import torch

import torch_train_ref as ref

torch.set_num_threads(1)

CASES = {
    "nonsat_clip_decay": dict(gan_loss="nonsat", grad_clip_norm=1.0,
                              lr_decay_rate=0.5, lr_decay_every=2),
    "energy_phase_remat": dict(lambda_energy=1.0, lambda_phase=1.0,
                               phase_n_fft=256, phase_hop=64,
                               remat_generator=True),
    "plain": dict(d_input_noise=0.0, r1_gamma=0.0, ema_decay=0.0,
                  g_warmup_steps=0, concat_disc_batch=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(case):
    train = CASES[case]
    jcfg, cfg = ref.configs(train)
    wav = ref.waveform()
    st0 = ref.warm_jax_state(jcfg, wav)
    steps = ref.run_jax(jcfg, st0, wav, 3)
    port = ref.run_port(cfg, ref.numpy_state(st0), wav, steps)
    for i, ((jst, jm, _), (pst, pm)) in enumerate(zip(steps, port)):
        where = f"{case} step {ref.PRE_STEPS + i}"
        ref.assert_metrics_close(pm, jm, where)
        ref.assert_params_close(pst, jst, where)
    if train.get("lambda_energy"):
        assert {"g_energy", "g_phase"} <= set(port[-1][1])

