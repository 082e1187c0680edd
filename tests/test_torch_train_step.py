"""The port's stage-2 ``train_step`` against the JAX package's, on the CPU.

TINY with the flagship's training knobs (``torch_train_ref.FLAGSHIP_KNOBS``:
R1, decaying instance noise with JAX's own realisations, the warmup gate,
EMA, the concatenated D batch, reused real features), from one JAX state
carried across by ``convert.train_state_from_jax``: one step, and three
steps across the warmup gate. Every metric to 1e-4 relative; every G, D
and EMA parameter to 1e-5 absolute (a tenth of one Adam step at lr 1e-4).
``torch_train_ref`` says how the state is made, and why.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_train_ref as ref
from music_synthesis_tpu.train import stage2 as jax_stage2
from music_synthesis_tpu_torch.convert import (
    to_state_dict,
    train_state_from_jax,
)
from music_synthesis_tpu_torch.train import stage2
from music_synthesis_tpu_torch.train.state import noise_scale

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def base():
    jcfg, cfg = ref.configs()
    wav = ref.waveform()
    st0 = ref.warm_jax_state(jcfg, wav)
    return dict(jcfg=jcfg, cfg=cfg, wav=wav, st0=ref.numpy_state(st0),
                jax_st0=st0, steps=ref.run_jax(jcfg, st0, wav, 3))


def test_jax_state_converts_exactly(base):
    st0, cfg = base["st0"], base["cfg"]
    port = train_state_from_jax(st0, device="cpu")
    assert port.step == ref.PRE_STEPS
    assert port.g_opt.count == port.d_opt.count == ref.PRE_STEPS
    for got, want in ((port.g_params, st0.g_params),
                      (port.d_params, st0.d_params),
                      (port.g_ema, st0.g_ema),
                      # optax.adam is chain(scale_by_adam, scale(-lr)).
                      (port.g_opt.mu, st0.g_opt[0].mu),
                      (port.d_opt.nu, st0.d_opt[0].nu)):
        want = to_state_dict(want)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    # The converted names are those of the port's own modules.
    fresh = stage2.make_train_state(cfg, device="cpu")
    assert fresh.g_params.keys() == port.g_params.keys()
    assert fresh.d_params.keys() == port.d_params.keys()
    assert all(fresh.d_params[k].shape == v.shape
               for k, v in port.d_params.items())


def test_one_step_matches_jax(base):
    """The state carried across from two JAX steps, then one more step on
    each side."""
    (jst, jm, _), = base["steps"][:1]
    (pst, pm), = ref.run_port(base["cfg"], base["st0"], base["wav"],
                              base["steps"][:1])
    ref.assert_metrics_close(pm, jm, "step 2")
    ref.assert_params_close(pst, jst, "step 2")
    assert pst.step == int(jst.step) == 3


def test_three_steps_across_the_warmup_gate_match_jax(base):
    st0 = base["st0"]
    port = ref.run_port(base["cfg"], st0, base["wav"], base["steps"])
    d0 = to_state_dict(st0.d_params)
    for i, ((jst, jm, _), (pst, pm)) in enumerate(zip(base["steps"], port)):
        where = f"step {ref.PRE_STEPS + i}"
        ref.assert_metrics_close(pm, jm, where)
        ref.assert_params_close(pst, jst, where)
        gate_open = ref.PRE_STEPS + i >= base["cfg"].train.g_warmup_steps
        # Inside the gate D and its Adam state stay exactly as they were.
        same_d = all(torch.equal(pst.d_params[k], d0[k]) for k in d0)
        assert same_d != gate_open, where
        assert (pm["d_update_norm"] == 0.0) != gate_open
        assert pst.d_opt.count == ref.PRE_STEPS + int(gate_open)
    assert [p.step for p, _ in port] == [3, 4, 5]


def test_train_step_many_equals_chained_steps(base):
    cfg = base["cfg"]
    wavs = np.stack([base["wav"], base["wav"][::-1].copy()])
    st = train_state_from_jax(base["st0"], device="cpu", seed=11)
    many, m_many = stage2.train_step_many(cfg, st, torch.from_numpy(wavs))
    chained = st
    for w in wavs:
        chained, m = stage2.train_step(cfg, chained, torch.from_numpy(w))
    assert m == m_many and many.step == chained.step == st.step + 2
    assert all(torch.equal(many.g_params[k], chained.g_params[k])
               for k in many.g_params)
    assert all(torch.equal(many.d_opt.nu[k], chained.d_opt.nu[k])
               for k in many.d_opt.nu)
    # The input state is left as it was (steps return new states).
    again = train_state_from_jax(base["st0"], device="cpu", seed=11)
    assert all(torch.equal(st.g_params[k], again.g_params[k])
               for k in st.g_params)
    assert torch.equal(st.rng.get_state(), again.rng.get_state())


def test_fresh_state_matches_jax_init_in_names_and_noise_schedule(base):
    cfg = base["cfg"]
    st = stage2.make_train_state(cfg, seed=0, device="cpu")
    want = jax_stage2.make_train_state(base["jcfg"], jax.random.PRNGKey(0))
    for got, w in ((st.g_params, want.g_params), (st.d_params, want.d_params),
                   (st.g_ema, want.g_ema)):
        w = to_state_dict(jax.tree.map(np.asarray, w))
        assert {k: v.shape for k, v in got.items()} == {
            k: v.shape for k, v in w.items()}
    assert st.step == 0 and st.g_opt.count == st.d_opt.count == 0
    t = cfg.train
    for step in (0, 3, 8, 9):
        want_s = np.float32(t.d_input_noise) * max(
            np.float32(0.0), np.float32(1.0) - np.float32(step)
            / np.float32(t.d_noise_decay_steps))
        assert noise_scale(cfg, step) == float(want_s)


def test_entry_points_run_on_cuda_unless_told(base):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage2.make_train_state(base["cfg"])


def test_jax_state_converts_onto_cuda_unless_told(base):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_state_from_jax(base["st0"])
