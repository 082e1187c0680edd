"""The port's CUDA-graph programs (``_graphs.py``) on the CPU, where no
graph is built: what the card captures must run here as it runs eagerly.

- ``stage1.GraphedStep``, the single-process stage-1 step in the form a
  graph captures (per-step scalars as 0-d fp32 tensors, draws made before
  the call, the state's tensors updated in place), run eagerly on TINY
  for 3 steps with decaying instance noise (sigma moves every step),
  learning-rate decay and EMA: equal to the functional
  ``stage1.train_step`` bit for bit in every parameter, Adam moment, EMA
  tensor and metric, with the same step, counts and generator state; and
  from a warmed JAX state with JAX's draws injected, within
  ``torch_train_ref``'s tolerances of the JAX step (1e-4 relative on the
  metrics, 1e-5 absolute on the parameters), as ``test_torch_stage1``
  holds the functional step.
- Every body a graph captures on the card runs here under a dispatch mode
  that raises on the host reads that break a capture
  (``aten._local_scalar_dense``: ``.item()``, ``float(t)``, ``.tolist()``;
  ``aten.is_nonzero``: ``bool(t)``): the ``generate`` bucket bodies
  through ``GraphedPipeline``, the stream's two forwards, copy-synthesis
  (the plain log-mel on the CPU), the eval CLIs' copy-synthesis body and
  the stage-1 step. ``GraphedPipeline`` on the CPU equals the eager
  function bit for bit, and ``generate_long`` through it stays within the
  serving tests' tolerance of the JAX ``generate_long``.
- ``GraphedProgram`` refuses a non-CUDA device; ``Programs`` runs eagerly
  on the CPU and builds nothing; ``enabled`` and ``flags`` follow the
  device, ``disable_graphs`` and the backend switches.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_tiny_ref as tiny
import torch_train_ref as ref
from music_synthesis_tpu.infer import generate as jax_generate
from music_synthesis_tpu.train import stage1 as jax_stage1
from music_synthesis_tpu_torch import _graphs
from music_synthesis_tpu_torch.convert import train_state_from_jax
from music_synthesis_tpu_torch.infer import generate as gen
from music_synthesis_tpu_torch.infer.copy_synthesis import copy_synthesis
from music_synthesis_tpu_torch.infer.stream import make_stream_fns
from music_synthesis_tpu_torch.losses.stft_loss import multires_stft_loss
from music_synthesis_tpu_torch.train import stage1, stage2
from music_synthesis_tpu_torch.train import state as engine
from music_synthesis_tpu_torch.train.state import noise_scale, state_groups
from test_torch_stage1 import (
    FLAGSHIP,
    PRE_STEPS,
    configs,
    jax_draws,
    real_mel,
    warm_jax_state,
)

torch.set_num_threads(1)

# The serving tests' tolerance of the port's generate_long against JAX's.
RTOL, ATOL = 1e-4, 1e-5

HOST_READS = (torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.is_nonzero.default)


class NoHostReads(TorchDispatchMode):
    """Raises on an operator that copies a device value to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST_READS:
            raise AssertionError(f"host read in a captured body: {func}")
        return func(*args, **(kwargs or {}))


# -- the stage-1 step in place ------------------------------------------------

# The flagship recipe at TINY's size with the noise decaying over 2 steps
# (sigma 0.2, 0.1, 0) and the learning rate halving every 2 Adam steps.
MOVING = dict(FLAGSHIP, d_noise_decay_steps=2, ema_decay=0.9,
              lr_decay_rate=0.5, lr_decay_every=2)


def _tensors(state):
    return [(f"{i}/{k}", v) for i, group in enumerate(state_groups(state))
            for k, v in group.items()]


def test_graphed_step_form_equals_functional_step_bit_for_bit():
    _, cfg = configs(MOVING)
    mel = torch.from_numpy(real_mel())
    functional = stage1.make_train_state(cfg, seed=3, device="cpu")
    inplace = stage1.make_train_state(cfg, seed=3, device="cpu")
    step = stage1.GraphedStep(cfg, "cpu")
    sigmas = []
    for _ in range(3):
        sigmas.append(noise_scale(cfg, functional.step))
        functional, want = stage1.train_step(cfg, functional, mel)
        inplace, got = step(inplace, mel)
        assert list(got) == list(want)
        assert [float(v) for v in got.values()] == list(want.values())
        for (name, a), (_, b) in zip(_tensors(inplace), _tensors(functional)):
            assert torch.equal(a, b), name
        assert (inplace.step, inplace.g_opt.count, inplace.d_opt.count) == (
            functional.step, functional.g_opt.count, functional.d_opt.count)
        assert torch.equal(inplace.rng.get_state(),
                           functional.rng.get_state())
    assert sigmas == pytest.approx([0.2, 0.1, 0.0])
    # The returned state is the step's buffers, updated in place.
    assert inplace.g_params is step.buffers.g_params


def test_graphed_step_copies_in_a_foreign_state_and_leaves_it():
    _, cfg = configs(MOVING)
    mel = torch.from_numpy(real_mel())
    st = stage1.make_train_state(cfg, seed=5, device="cpu")
    before = [v.clone() for _, v in _tensors(st)]
    step = stage1.GraphedStep(cfg, "cpu")
    a, ma = step(st, mel)
    b, mb = step(st, mel)  # from the same state again: copied in
    assert [float(v) for v in ma.values()] == [float(v) for v in mb.values()]
    assert all(torch.equal(v, w) for (_, v), w in zip(_tensors(st), before))
    want, wm = stage1.train_step(cfg, st, mel)
    assert [float(v) for v in mb.values()] == list(wm.values())
    for (name, x), (_, y) in zip(_tensors(b), _tensors(want)):
        assert torch.equal(x, y), name


def test_graphed_step_form_matches_jax():
    jcfg, cfg = configs(FLAGSHIP)
    mel = real_mel()
    jst = warm_jax_state(jcfg, mel)
    pst = train_state_from_jax(ref.numpy_state(jst), device="cpu")
    step = stage1.GraphedStep(cfg, "cpu")
    for i in range(3):
        z, noise = jax_draws(jst.rng, jcfg, mel.shape)
        jst, jm = jax_stage1.train_step(jcfg, jst, jnp.asarray(mel))
        pst, pm = step(pst, torch.from_numpy(mel), z=z, noise=noise)
        where = f"graphed step form, step {PRE_STEPS + i}"
        ref.assert_metrics_close({k: float(v) for k, v in pm.items()},
                                 {k: float(v) for k, v in jm.items()}, where)
        ref.assert_params_close(pst, ref.numpy_state(jst), where)


# -- captured bodies make no host read ---------------------------------------

@pytest.fixture(scope="module")
def pair():
    return tiny.tiny_pair()


def test_no_host_reads_catches_them():
    x = torch.ones(3)
    with NoHostReads(), pytest.raises(AssertionError, match="host read"):
        float(x.sum())
    with NoHostReads(), pytest.raises(AssertionError, match="host read"):
        bool(x.sum() > 0)


@pytest.mark.parametrize("fn, static", [
    (gen.generate, ()), (gen.generate_refined, (2,)),
    (gen.generate_long, (4,)), (gen.generate_long_refined, (4, 2))])
def test_generate_bodies_make_no_host_read(pair, fn, static):
    _, cfg, _, _, comp, voc = pair
    rng = np.random.default_rng(0)
    shape = (2, 3, cfg.specgan.latent_dim) if "long" in fn.__name__ else (
        2, cfg.specgan.latent_dim)
    z = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    pipe = gen.GraphedPipeline(cfg, comp, voc)
    with NoHostReads():
        got = pipe(fn, z, *static)
    with torch.inference_mode():
        want = fn(cfg, comp, voc, z, *static)
    assert torch.equal(got, want)
    assert pipe.programs.programs == {}  # nothing is built on the CPU


def test_graphed_pipeline_matches_jax_generate_long(pair):
    jcfg, cfg, sp, vp, comp, voc = pair
    z = np.random.default_rng(1).standard_normal(
        (2, 3, cfg.specgan.latent_dim)).astype(np.float32)
    want = np.asarray(jax_generate.generate_long(jcfg, sp, vp,
                                                 jnp.asarray(z), 4))
    got = gen.GraphedPipeline(cfg, comp, voc)(gen.generate_long,
                                              torch.from_numpy(z), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_stream_forwards_make_no_host_read(pair):
    _, cfg, _, _, comp, voc = pair
    patch_fn, chunk_fn = make_stream_fns(cfg)
    rng = np.random.default_rng(2)
    z = rng.standard_normal((1, cfg.specgan.latent_dim)).astype(np.float32)
    mel = rng.standard_normal((1, cfg.infer.chunk_frames,
                               cfg.specgan.n_mels)).astype(np.float32)
    for fn, module, x in ((patch_fn, comp, z), (chunk_fn, voc, mel)):
        x = torch.from_numpy(x)
        with torch.inference_mode(), NoHostReads():
            out = module(x)
        np.testing.assert_array_equal(fn(module, x.numpy()), out.numpy())


def test_copy_synthesis_bodies_make_no_host_read(pair):
    _, cfg, _, _, _, voc = pair
    hop = cfg.frontend.hop_length
    wav = torch.from_numpy(np.random.default_rng(3).uniform(
        -0.5, 0.5, (2, 16 * hop)).astype(np.float32))
    with NoHostReads():
        y, dist = copy_synthesis(voc, wav, cfg.frontend, cfg.mel_scaler)
    assert y.shape == wav.shape and dist.ndim == 0
    # The eval and vocode CLIs' body: conditioning_mel (the kernel, or the
    # torch.fft front-end) + vocoder + distance.
    for pallas in (False, True):
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, use_pallas_frontend=pallas))
        with torch.inference_mode(), NoHostReads():
            y = voc(stage2.conditioning_mel(wav, c)).float()
            multires_stft_loss(y, wav, c.stft_loss)


def test_stage1_body_makes_no_host_read():
    _, cfg = configs(MOVING)
    st = stage1.make_train_state(cfg, seed=1, device="cpu")
    real = torch.from_numpy(real_mel())
    _, draws = stage1._draws(cfg, st, real.device, real.shape, None, None)
    scalars = torch.tensor(stage1._scalars(cfg, st))
    with NoHostReads():
        metrics = stage1.GraphedStep(cfg, "cpu")._body(st, real, scalars,
                                                       *draws)
    assert set(metrics) >= {"d_loss", "g_loss", "d_r1", "g_flux"}


# -- the mechanism off the card ----------------------------------------------

def test_graphed_program_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        _graphs.GraphedProgram(lambda x: x, "cpu")


def test_programs_run_eagerly_on_the_cpu():
    programs = _graphs.Programs("cpu")
    x = torch.arange(4.0)
    assert torch.equal(programs("double", lambda t: 2 * t, x), 2 * x)
    assert programs.programs == {} and programs.pool_bytes() is None


def test_enabled_and_flags_follow_device_and_switches():
    assert not _graphs.enabled("cpu")
    assert not _graphs.enabled(torch.device("cpu"))
    before = _graphs.flags()
    with torch.backends.cudnn.flags(enabled=True,
                                    allow_tf32=not before[1]):
        assert _graphs.flags() != before
    assert _graphs.flags() == before
    with _graphs.disable_graphs():
        with _graphs.disable_graphs():
            assert _graphs._disabled == 2
        assert _graphs._disabled == 1
    assert _graphs._disabled == 0


def test_single_process_train_step_stays_functional_on_the_cpu():
    _, cfg = configs(MOVING)
    st = stage1.make_train_state(cfg, seed=2, device="cpu")
    new, _ = stage1.train_step(cfg, st, real_mel())
    assert new.g_params is not st.g_params
    assert not engine._STEPS.get(stage1.STAGE.label)
