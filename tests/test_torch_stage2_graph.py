"""The stage-2 step in the form a CUDA graph captures (``train.stage2.
GraphedStep``), on the CPU, where it runs eagerly.

TINY with the flagship's knobs (``torch_train_ref.FLAGSHIP_KNOBS``: R1,
instance noise decaying over 8 steps, the warmup gate at step 4, EMA, the
concatenated D batch, reused real features) and the MSD's grouped
convolutions lowered to dense block-diagonal ones (``dense_groups_max_g
16``), as the flagship recipe trains:

- the captured body (the in-place step's update, ``train.state.
  InPlaceStep._body``: per-step scalars, the warmup gate among them, as
  0-d tensors, draws made before it) makes no host read
  (``test_torch_graphs.NoHostReads``);
- ``GraphedStep`` equals the functional ``train_step`` bit for bit in
  every metric and state tensor over 7 steps from step 0 (four inside the
  gate, three past it), with the same step, Adam counts and generator
  state; inside the gate D and D's Adam moments stay exactly as they were;
- it copies a foreign state into its buffers and leaves it untouched;
- the eager step keeps the state's tensor layouts (a step's results come
  in the layouts of their gradients; a weight norm's sum rounds by the
  parameter's strides, so a drifting layout made the functional step
  differ from the in-place one at rounding level from its third step);
- from a JAX state two steps in (``torch_train_ref``: both Adam states
  hold moments), with JAX's instance noise injected, three ``GraphedStep``
  calls match three JAX ``train_step`` calls and the port's
  ``train_step_many`` (K = 3) matches JAX's ``train_step_many``, across
  the gate: every metric to ``METRIC_RTOL`` (1e-4 relative), every G, D
  and EMA parameter to ``PARAM_ATOL`` (1e-5 absolute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ref as ref
from music_synthesis_tpu import config as jax_config
from music_synthesis_tpu.train import stage2 as jax_stage2
from music_synthesis_tpu_torch import config
from music_synthesis_tpu_torch.convert import train_state_from_jax
from music_synthesis_tpu_torch.train import stage2
from music_synthesis_tpu_torch.train.state import state_groups
from test_torch_graphs import NoHostReads

torch.set_num_threads(1)

K = 3


def dense_configs(train=None):
    """(JAX config, port config): ``torch_train_ref.configs`` with the
    MSD's ``dense_groups_max_g`` at the flagship's 16."""
    jcfg, _ = ref.configs(train)
    jcfg = dataclasses.replace(jcfg, msd=dataclasses.replace(
        jcfg.msd, dense_groups_max_g=16))
    return jcfg, config.config_from_dict(jax_config.config_to_dict(jcfg))


def wavs(k=K):
    return np.stack([ref.waveform(seed=7 + i) for i in range(k)])


def _tensors(state):
    return [(f"{i}/{k}", v) for i, group in enumerate(state_groups(state))
            for k, v in group.items()]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX state two steps in, K chained ``train_step`` calls on
    ``wavs()`` (with each step's noise) and one ``train_step_many`` over
    them, from that state."""
    jcfg, cfg = dense_configs()
    w = wavs()
    st0 = ref.warm_jax_state(jcfg, w[0])
    st, steps = jax.tree.map(jnp.copy, st0), []
    for wav in w:
        noise = ref.jax_noise(st.rng, wav.shape)
        st, m = jax_stage2.train_step(jcfg, st, jnp.asarray(wav))
        steps.append((ref.numpy_state(st), {k: float(v) for k, v in
                                             m.items()}, noise))
    many, m_many = jax_stage2.train_step_many(
        jcfg, jax.tree.map(jnp.copy, st0), jnp.asarray(w))
    return dict(cfg=cfg, wavs=w, st0=ref.numpy_state(st0), steps=steps,
                many=(ref.numpy_state(many),
                      {k: float(v) for k, v in m_many.items()}))


def test_config_lowers_grouped_convs_and_gates():
    _, cfg = dense_configs()
    t = cfg.train
    assert t.r1_gamma > 0 and t.d_input_noise > 0 and t.g_warmup_steps > 0
    assert t.concat_disc_batch and t.ema_decay > 0
    assert ref.PRE_STEPS < t.g_warmup_steps < ref.PRE_STEPS + K
    _, disc = stage2._modules(cfg)
    assert disc.msd.scale_0.down_0.dense_groups


def test_captured_body_makes_no_host_read():
    _, cfg = dense_configs()
    wav = torch.from_numpy(ref.waveform())
    for step in (0, cfg.train.g_warmup_steps):  # both sides of the gate
        st = dataclasses.replace(
            stage2.make_train_state(cfg, seed=1, device="cpu"), step=step)
        _, noise = stage2._draws(cfg, st, wav.device, wav.shape, None)
        scalars = torch.tensor(stage2._scalars(cfg, st))
        with NoHostReads():
            metrics = stage2.GraphedStep(cfg, "cpu")._body(st, wav, scalars,
                                                           *noise)
        assert set(metrics) >= {"d_loss", "g_loss", "d_r1", "d_update_norm"}


def test_graphed_step_equals_functional_step_across_the_gate():
    _, cfg = dense_configs()
    wav = torch.from_numpy(ref.waveform())
    functional = stage2.make_train_state(cfg, seed=3, device="cpu")
    inplace = stage2.make_train_state(cfg, seed=3, device="cpu")
    step = stage2.GraphedStep(cfg, "cpu")
    warmup = cfg.train.g_warmup_steps
    for i in range(warmup + 3):
        d_before = [v.clone() for v in state_groups(inplace)[1].values()]
        d_opt_before = [v.clone() for g in state_groups(inplace)[4:6]
                        for v in g.values()]
        functional, want = stage2.train_step(cfg, functional, wav)
        inplace, got = step(inplace, wav)
        assert list(got) == list(want)
        assert [float(v) for v in got.values()] == list(want.values())
        for (name, a), (_, b) in zip(_tensors(inplace), _tensors(functional)):
            assert torch.equal(a, b), (i, name)
        assert (inplace.step, inplace.g_opt.count, inplace.d_opt.count) == (
            functional.step, functional.g_opt.count, functional.d_opt.count)
        assert torch.equal(inplace.rng.get_state(),
                           functional.rng.get_state())
        d_after = list(state_groups(inplace)[1].values())
        d_opt_after = [v for g in state_groups(inplace)[4:6]
                       for v in g.values()]
        same = (all(map(torch.equal, d_before, d_after))
                and all(map(torch.equal, d_opt_before, d_opt_after)))
        assert same == (i < warmup), i  # D and its Adam frozen in the gate
        assert (got["d_update_norm"] == 0) == (i < warmup)
    assert functional.d_opt.count == 3
    # The returned state is the step's buffers, updated in place.
    assert inplace.g_params is step.buffers.g_params


def test_graphed_step_copies_in_a_foreign_state_and_leaves_it():
    _, cfg = dense_configs()
    wav = torch.from_numpy(ref.waveform())
    st = dataclasses.replace(
        stage2.make_train_state(cfg, seed=5, device="cpu"),
        step=cfg.train.g_warmup_steps)
    before = [v.clone() for _, v in _tensors(st)]
    rng_before = st.rng.get_state()
    step = stage2.GraphedStep(cfg, "cpu")
    _, ma = step(st, wav)
    b, mb = step(st, wav)  # from the same state again: copied in
    assert [float(v) for v in ma.values()] == [float(v) for v in mb.values()]
    assert all(torch.equal(v, w) for (_, v), w in zip(_tensors(st), before))
    assert torch.equal(st.rng.get_state(), rng_before)
    want, wm = stage2.train_step(cfg, st, wav)
    assert [float(v) for v in mb.values()] == list(wm.values())
    for (name, x), (_, y) in zip(_tensors(b), _tensors(want)):
        assert torch.equal(x, y), name


def test_eager_step_keeps_the_state_layouts():
    _, cfg = dense_configs()
    st = stage2.make_train_state(cfg, seed=2, device="cpu")
    strides = [(name, v.stride()) for name, v in _tensors(st)]
    for _ in range(2):
        st, _ = stage2.train_step(cfg, st, ref.waveform())
    assert [(name, v.stride()) for name, v in _tensors(st)] == strides


def test_graphed_steps_match_jax(jax_runs):
    cfg, w = jax_runs["cfg"], jax_runs["wavs"]
    pst = train_state_from_jax(jax_runs["st0"], device="cpu")
    step = stage2.GraphedStep(cfg, "cpu")
    for i, (jst, jm, noise) in enumerate(jax_runs["steps"]):
        pst, pm = step(pst, torch.from_numpy(w[i]), noise=noise)
        where = f"graphed step form, step {ref.PRE_STEPS + i}"
        ref.assert_metrics_close({k: float(v) for k, v in pm.items()}, jm,
                                 where)
        ref.assert_params_close(pst, jst, where)
    assert pst.step == ref.PRE_STEPS + K
    assert pst.d_opt.count == ref.PRE_STEPS + 1  # one step past the gate


def test_train_step_many_matches_jax(jax_runs):
    cfg, w = jax_runs["cfg"], jax_runs["wavs"]
    pst = train_state_from_jax(jax_runs["st0"], device="cpu")
    noise = np.stack([np.stack(n) for _, _, n in jax_runs["steps"]])
    pst, pm = stage2.train_step_many(cfg, pst, torch.from_numpy(w), noise)
    jst, jm = jax_runs["many"]
    ref.assert_metrics_close(pm, jm, f"train_step_many, K = {K}")
    ref.assert_params_close(pst, jst, f"train_step_many, K = {K}")
    # JAX's scan returns the last step's metrics, as K train_step calls do
    # (its program rounds differently: 6.1e-5 apart in g_grad_norm).
    ref.assert_metrics_close(jm, jax_runs["steps"][-1][1],
                             "JAX's train_step_many against its steps")
    assert pst.step == int(jst.step) == ref.PRE_STEPS + K
