"""The port's data parallelism (``parallel/``) on the CPU: two gloo ranks
against the JAX package's DP steps on a 2-device mesh and against the
port's single-process step on the concatenated batch.

One group of two ranks (``parallel.mesh.launch``, ``tests/torch_dp_ref.py``)
runs every case of this module, on TINY with the flagship's training knobs
(``torch_train_ref.FLAGSHIP_KNOBS``, stage 1's from ``test_torch_stage1``),
from a JAX state two steps in (``torch_train_ref`` says why; the two
steps are JAX's DP steps, which equal its single-device ones), for 3 steps
(stage 2: two inside the warmup gate, the third past it). Stage 1 runs a
global batch of 4 (2 rows per rank); stage 2 the batch of
``torch_train_ref.waveform()`` (2 rows, 1 per rank): from the state that
``warm_jax_state``'s recipe makes of a 4-row batch, the port's single-process step
is itself 2.4e-3 off JAX's in ``g_update_norm`` at the first step past the
gate (the property of the reference in ROADMAP Queue 3 item 8: G's Adam
amplifies rounding in elements whose second moment is near 0), so no DP
comparison with JAX could hold there.

- ``--dp jit`` (``make_dp_stage{1,2}_step``): JAX's jit-sharded step draws
  the global batch's noise (and latents) from the state; each rank gets its
  rows of that draw. Held to JAX's step and to the port's single-process
  step on the concatenated batch with the same draws: every metric to 1e-4
  relative, every G, D and EMA parameter to 1e-5 absolute.
- ``--dp shard_map`` (``make_shardmap_stage{1,2}_step``): JAX's per-device
  draws (``fold_in(key, axis_index)``) injected into each rank. Stage 1 is
  held to JAX's shard_map step and to the port's single-process step on
  the concatenated batch with the concatenated draws (``g_rms_ratio``, the
  mean of the shards' ratios, to JAX's alone), 1e-4 / 1e-5.
  Stage 2 is held to the port's single-process step in the same way. JAX's
  stage-2 shard_map step is not the single-device step: under
  ``shard_map(check_vma=False)`` ``psum`` transposes to ``psum``, so its
  spectral-convergence gradient comes out N times the single-device one
  (``test_reference_shard_map_scales_the_global_loss_gradients_by_n``);
  the port gives the single-process gradient. So against JAX's shard_map
  step the first step's losses and D side (which the G gradient does not
  reach) are held to 1e-4 / 1e-5, and the G side is not.
- ``make_shardmap_stage2_many`` on a ``[2, 2, 2048]`` chunk equals two
  chained shard_map steps, both drawing their own noise: metrics to 1e-6
  relative, parameters to 1e-7 (the same operations in the same order).
- The cross-rank corrections of the STFT and phase losses: the value, and
  the gradient of a replicated gain averaged over the ranks, equal the
  single-process ones on the concatenated batch (1e-5 relative).
- Every rank ends with the same state, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ref
import torch_train_ref as ref
from music_synthesis_tpu import config as jax_config
from music_synthesis_tpu.losses.phase_loss import (
    phase_coherence_loss as jax_phase_loss,
)
from music_synthesis_tpu.losses.stft_loss import (
    multires_stft_loss as jax_stft_loss,
)
from music_synthesis_tpu.parallel.dp import (
    make_dp_stage1_step as jax_dp1,
    make_dp_stage2_step as jax_dp2,
)
from music_synthesis_tpu.parallel.mesh import (
    make_mesh,
    replicate_state as jax_replicate,
    shard_batch as jax_shard_batch,
)
from music_synthesis_tpu.parallel.shard_map_dp import (
    make_shardmap_stage1_step as jax_sm1,
    make_shardmap_stage2_step as jax_sm2,
    shard_map,
)
from music_synthesis_tpu.train import stage1 as jax_stage1
from music_synthesis_tpu.train import stage2 as jax_stage2
from music_synthesis_tpu_torch import config
from music_synthesis_tpu_torch.convert import (
    to_state_dict,
    train_state_from_jax,
)
from music_synthesis_tpu_torch.losses.phase_loss import phase_coherence_loss
from music_synthesis_tpu_torch.losses.stft_loss import multires_stft_loss
from music_synthesis_tpu_torch.parallel import mesh
from music_synthesis_tpu_torch.train import stage1, stage2
from music_synthesis_tpu_torch.train.checkpoint import save_checkpoint

torch.set_num_threads(1)

N = 2  # ranks, and JAX devices
B1 = 4  # stage 1's global batch (stage 2's is torch_train_ref.waveform()'s)
N_STEPS = 3
STAGE1_KNOBS = dict(r1_gamma=1.0, d_input_noise=0.2, d_noise_decay_steps=8,
                    lambda_flux=10.0, ema_decay=0.999,
                    reuse_real_features=True)
PHASE = (256, 64)  # n_fft, hop of the phase-loss case
LOSS_RTOL = 1e-5
MANY_RTOL, MANY_ATOL = 1e-6, 1e-7


def _mesh():
    return make_mesh((N,), devices=jax.devices()[:N])


def _copy(st):
    return jax.tree.map(jnp.copy, st)


def _split_rows(a):
    per = len(a) // N
    return [a[r * per:(r + 1) * per] for r in range(N)]


def _jax_noise_per_device(rng, shape):
    """The three normals each device of JAX's shard_map step draws:
    ``split(rng)``, then ``fold_in(nk, i)`` split in three."""
    _, nk = jax.random.split(rng)
    return [[np.array(jax.random.normal(k, shape, jnp.float32))
             for k in jax.random.split(jax.random.fold_in(nk, i), 3)]
            for i in range(N)]


def _jax_stage1_draws_per_device(rng, cfg, shape):
    """(z, noise) each device of JAX's stage-1 shard_map step draws."""
    rng, zk = jax.random.split(rng)
    zs = [np.array(jax.random.normal(jax.random.fold_in(zk, i),
                                     (shape[0], cfg.specgan.latent_dim)))
          for i in range(N)]
    return zs, _jax_noise_per_device(rng, shape)


def _stage1_configs():
    jcfg = dataclasses.replace(jax_config.TINY, train=dataclasses.replace(
        jax_config.TINY.train, batch_size=B1, **STAGE1_KNOBS))
    return jcfg, config.config_from_dict(jax_config.config_to_dict(jcfg))


def _warm(st, step, batch):
    """``torch_train_ref.warm_jax_state``'s recipe on an initialised state
    (gains near one, two steps with the warmup gate open, the step count
    set back to 2), with JAX's jit-sharded DP ``step`` (which equals its
    single-device step), so that no single-device step is compiled."""
    g = ref._unit_gain(st.g_params, 1, out_gain=0.05)
    st = st.replace(g_params=g, d_params=ref._unit_gain(st.d_params, 2),
                    g_ema=jax.tree.map(jnp.copy, g),
                    step=jnp.asarray(1000, jnp.int32))
    st = jax_replicate(st, _mesh())
    for _ in range(ref.PRE_STEPS):
        st, _ = step(st, jax_shard_batch(jnp.asarray(batch), _mesh()))
    return st.replace(step=jnp.asarray(ref.PRE_STEPS, jnp.int32))


def _run_jax(step, st0, batch, draws):
    """JAX DP steps from ``st0``: [(numpy state, metrics)]; ``draws(st)``
    is called before each step (it reads the state's rng)."""
    st = jax_replicate(_copy(st0), _mesh())
    out = []
    for _ in range(N_STEPS):
        d = draws(st)
        st, m = step(st, jax_shard_batch(jnp.asarray(batch), _mesh()))
        out.append((ref.numpy_state(st), {k: float(v) for k, v in m.items()},
                    d))
    return out


def _port_single(stage, cfg, st0, batch, draws_list):
    """The port's single-process steps on the whole batch with the given
    global draws: [(state, metrics)]."""
    st = train_state_from_jax(st0, device="cpu")
    out = []
    for z, noise in draws_list:
        if stage == 2:
            st, m = stage2.train_step(cfg, st, torch.from_numpy(batch),
                                      noise=noise)
        else:
            st, m = stage1.train_step(cfg, st, torch.from_numpy(batch), z=z,
                                      noise=noise)
        out.append((st, m))
    return out


def jax_dp_runs(tmp):
    """Both stages' JAX DP runs of every mode from the warmed JAX states
    (saved for the ranks as ``tmp/st{stage}.pt``): per ``(stage, dp)`` the
    JAX steps ``[(numpy state, metrics, draws)]`` (``jax``), each rank's
    ``(batch, z, noise)`` per step (``per_rank``), the global draws of the
    single-process step (``single_draws``), the port's config, the numpy
    start state, the global batch and the saved state's path."""
    mesh2 = _mesh()

    # Stage 2.
    jcfg2, cfg2 = ref.configs()
    wav = ref.waveform()
    steps = {(2, "jit"): jax_dp2(jcfg2, mesh2),
             (2, "shard_map"): jax_sm2(jcfg2, mesh2)}
    st2 = _warm(jax_stage2.make_train_state(jcfg2, jax.random.PRNGKey(0)),
                steps[2, "jit"], wav)
    np2 = ref.numpy_state(st2)
    save_checkpoint(tmp / "st2.pt", train_state_from_jax(np2, device="cpu"))
    # Stage 1.
    jcfg1, cfg1 = _stage1_configs()
    mel = (0.8 * np.tanh(np.random.default_rng(5).standard_normal(
        (B1, 32, 32)))).astype(np.float32)
    steps[1, "jit"] = jax_dp1(jcfg1, mesh2)
    steps[1, "shard_map"] = jax_sm1(jcfg1, mesh2)
    st1 = _warm(jax_stage1.make_train_state(jcfg1, jax.random.PRNGKey(0)),
                steps[1, "jit"], mel)
    np1 = ref.numpy_state(st1)
    save_checkpoint(tmp / "st1.pt", train_state_from_jax(np1, device="cpu"))

    def stage1_global(st):
        rng, zk = jax.random.split(st.rng)
        z = np.array(jax.random.normal(zk, (B1, jcfg1.specgan.latent_dim)))
        return z, ref.jax_noise(rng, mel.shape)

    specs = {
        (2, "jit"): (jcfg2, cfg2, st2, np2, wav,
                     lambda st: (None, ref.jax_noise(st.rng, wav.shape))),
        (2, "shard_map"): (jcfg2, cfg2, st2, np2, wav,
                           lambda st: (None, _jax_noise_per_device(
                               st.rng, (len(wav) // N, 2048)))),
        (1, "jit"): (jcfg1, cfg1, st1, np1, mel, stage1_global),
        (1, "shard_map"): (jcfg1, cfg1, st1, np1, mel,
                           lambda st: _jax_stage1_draws_per_device(
                               st.rng, jcfg1, (B1 // N, 32, 32))),
    }
    runs = {}
    for (stage, dp), (jcfg, cfg, st, st_np, batch, draws) in specs.items():
        jax_steps = _run_jax(steps[stage, dp], st, batch, draws)
        rows = _split_rows(batch)
        if dp == "jit":  # global draws: each rank takes its rows
            per_rank = [[(rows[r], None if z is None else _split_rows(z)[r],
                          [_split_rows(n)[r] for n in noise])
                         for _, _, (z, noise) in jax_steps]
                        for r in range(N)]
            single_draws = [d for _, _, d in jax_steps]
        else:  # per-device draws: concatenated for the single process
            per_rank = [[(rows[r], None if z is None else z[r], noise[r])
                         for _, _, (z, noise) in jax_steps]
                        for r in range(N)]
            single_draws = [
                (None if z is None else np.concatenate(z),
                 [np.concatenate([noise[r][i] for r in range(N)])
                  for i in range(3)])
                for _, _, (z, noise) in jax_steps]
        runs[stage, dp] = {"jax": jax_steps, "per_rank": per_rank,
                           "single_draws": single_draws, "cfg": cfg,
                           "st_np": st_np, "batch": batch,
                           "state_path": str(tmp / f"st{stage}.pt")}
    return runs


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Every JAX reference, the port's single-process references, and the
    ranks' results of one launched group."""
    tmp = tmp_path_factory.mktemp("dp")
    out, jobs = {}, []
    specs = jax_dp_runs(tmp)
    for (stage, dp), r in specs.items():
        out[stage, dp] = {
            "jax": r["jax"],
            "single": _port_single(stage, r["cfg"], r["st_np"], r["batch"],
                                   r["single_draws"])}
        jobs.append({"kind": "train", "args": dict(
            stage=stage, cfg=r["cfg"], state_path=r["state_path"], dp=dp,
            data=r["per_rank"])})
    cfg2, wav = specs[2, "jit"]["cfg"], specs[2, "jit"]["batch"]

    # The K-step chain, and the losses' corrections.
    chunk = (0.5 * np.tanh(np.random.default_rng(8).standard_normal(
        (2, len(wav), 2048)))).astype(np.float32)
    jobs.append({"kind": "many", "args": dict(
        cfg=cfg2, state_path=str(tmp / "st2.pt"), chunk=chunk)})
    rng = np.random.default_rng(9)
    x, y = (rng.standard_normal((B1, 2048)).astype(np.float32) * 0.3
            for _ in range(2))
    gain = (0.1 * rng.standard_normal(2048)).astype(np.float32)
    jobs.append({"kind": "loss_grads", "args": dict(
        stft_cfg=cfg2.stft_loss, phase_args=PHASE, x=x, y=y, gain=gain)})
    out["loss_inputs"] = (cfg2.stft_loss, x, y, gain)

    ranks = mesh.launch(torch_dp_ref.run_jobs, N, (jobs,),
                        devices=["cpu"] * N)
    for i, key in enumerate(list(specs)):
        out[key]["ranks"] = [r[i] for r in ranks]
    out["many"] = [r[len(specs)] for r in ranks]
    out["loss_grads"] = [r[len(specs) + 1] for r in ranks]
    return out


def _params_close(got: dict, want, where, atol=ref.PARAM_ATOL):
    """``got``: the ranks' parameter dicts; ``want``: a port state or a
    numpy JAX state."""
    if isinstance(want, stage2.GANState):
        want = {"g": want.g_params, "d": want.d_params, "ema": want.g_ema}
    else:
        want = {"g": to_state_dict(want.g_params),
                "d": to_state_dict(want.d_params),
                "ema": to_state_dict(want.g_ema)}
    for part in ("g", "d", "ema"):
        for k, w in want[part].items():
            err = (got[part][k] - w).abs().max().item()
            assert err <= atol, f"{where}: {part} {k} off by {err}"


def _metrics_close(got, want, where, rtol=ref.METRIC_RTOL, skip=()):
    assert set(got) == set(want), where
    for k, w in want.items():
        if k not in skip:
            assert abs(got[k] - w) <= rtol * abs(w), (
                f"{where}: {k} {got[k]!r} vs {w!r}")


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("dp", ["jit", "shard_map"])
def test_every_rank_ends_with_the_same_state(cases, stage, dp):
    r0, r1 = cases[stage, dp]["ranks"]
    assert r0["step"] == r1["step"] == ref.PRE_STEPS + N_STEPS
    for part in ("g", "d", "ema"):
        for k in r0["params"][part]:
            assert torch.equal(r0["params"][part][k], r1["params"][part][k])
    assert r0["metrics"] == r1["metrics"]


@pytest.mark.parametrize("stage", [1, 2])
def test_jit_dp_matches_jax_and_the_single_process_step(cases, stage):
    c = cases[stage, "jit"]
    rank = c["ranks"][0]
    for i in range(N_STEPS):
        where = f"stage {stage} jit step {ref.PRE_STEPS + i}"
        jst, jm, _ = c["jax"][i]
        _metrics_close(rank["metrics"][i], jm, where + " vs JAX")
        _metrics_close(rank["metrics"][i], c["single"][i][1],
                       where + " vs single")
    _params_close(rank["params"], c["jax"][-1][0], f"stage {stage} jit JAX")
    _params_close(rank["params"], c["single"][-1][0],
                  f"stage {stage} jit single")


@pytest.mark.parametrize("stage", [1, 2])
def test_shard_map_dp_matches_the_single_process_step(cases, stage):
    """The concatenated batch with the concatenated per-rank draws. The one
    metric a single process cannot give is ``g_rms_ratio``, the mean of
    the shards' ratios: it is held to JAX's shard_map step (stage 1 here,
    stage 2 at its first step in the next test but one)."""
    c = cases[stage, "shard_map"]
    rank = c["ranks"][0]
    for i in range(N_STEPS):
        where = f"stage {stage} shard_map step {ref.PRE_STEPS + i}"
        _metrics_close(rank["metrics"][i], c["single"][i][1], where,
                       skip=("g_rms_ratio",))
    _params_close(rank["params"], c["single"][-1][0],
                  f"stage {stage} shard_map single")


def test_stage1_shard_map_dp_matches_jax(cases):
    c = cases[1, "shard_map"]
    rank = c["ranks"][0]
    for i in range(N_STEPS):
        _metrics_close(rank["metrics"][i], c["jax"][i][1],
                       f"stage 1 shard_map step {ref.PRE_STEPS + i}")
    _params_close(rank["params"], c["jax"][-1][0], "stage 1 shard_map JAX")


def test_stage2_shard_map_dp_matches_jax_where_its_fault_does_not_reach(
        cases):
    """JAX's stage-2 shard_map step scales the STFT loss's sc gradient by
    N (module docstring): its first step's losses and D side, which that
    gradient does not reach, are held to the port's."""
    c = cases[2, "shard_map"]
    got = c["ranks"][0]["metrics"][0]
    want = c["jax"][0][1]
    _metrics_close(got, want, "stage 2 shard_map first step",
                   skip=("g_grad_norm", "g_update_norm"))
    # D's update precedes G's in the step, so one step in D is JAX's. (The
    # port's first step is its single-process one, which the ranks equal:
    # test_shard_map_dp_matches_the_single_process_step.)
    port_first = c["single"][0][0]
    for k, w in to_state_dict(c["jax"][0][0].d_params).items():
        err = (port_first.d_params[k] - w).abs().max().item()
        assert err <= ref.PARAM_ATOL, f"D {k} off by {err}"


def test_reference_shard_map_scales_the_global_loss_gradients_by_n(cases):
    """The fault of the reference that the port does not copy: under
    ``shard_map(check_vma=False)`` the gradient of the psum'd spectral
    convergence and phase terms, after the step's pmean, is N times the
    single-device gradient (the port's, ``test_loss_corrections...``)."""
    stft_cfg, x, y, gain = cases["loss_inputs"]
    jcfg = jax_config.TINY.stft_loss
    assert tuple(map(tuple, jcfg.resolutions)) == tuple(
        map(tuple, stft_cfg.resolutions))
    from jax.sharding import PartitionSpec as P

    def sc_only(fn):
        def loss(g, xs, ys, axis):
            return fn(xs * (1.0 + g), ys, axis)
        return loss

    def phase(a, b, axis):
        return jax_phase_loss(a, b, *PHASE, axis_name=axis)

    def sc(a, b, axis):  # the spectral-convergence term alone
        from music_synthesis_tpu.losses.stft_loss import stft_distance
        n_fft, hop, win = jcfg.resolutions[0]
        return stft_distance(a, b, n_fft, hop, win, jcfg.eps, axis)[0]

    mesh2 = _mesh()
    for name, fn in (("sc", sc), ("phase", phase)):
        loss = sc_only(fn)
        single = jax.grad(loss)(jnp.asarray(gain), jnp.asarray(x),
                                jnp.asarray(y), None)

        def body(g, xs, ys):
            return jax.lax.pmean(jax.grad(loss)(g, xs, ys, "data"), "data")

        sharded = shard_map(body, mesh=mesh2, in_specs=(P(), P("data"),
                                                        P("data")),
                            out_specs=P(), check_vma=False)(
            jnp.asarray(gain), jnp.asarray(x), jnp.asarray(y))
        ratio = float(jnp.vdot(sharded, single) / jnp.vdot(single, single))
        assert abs(ratio - N) < 1e-3, (name, ratio)


def test_loss_corrections_give_the_single_process_gradient(cases):
    stft_cfg, x, y, gain = cases["loss_inputs"]
    for name, fn in (
            ("stft", lambda a: multires_stft_loss(a, torch.from_numpy(y),
                                                  stft_cfg)),
            ("phase", lambda a: phase_coherence_loss(
                a, torch.from_numpy(y), *PHASE))):
        g = torch.from_numpy(gain).requires_grad_()
        value = fn(torch.from_numpy(x) * (1.0 + g))
        (grad,) = torch.autograd.grad(value, g)
        for r, res in enumerate(cases["loss_grads"]):
            got_value, got_grad = res[name]
            assert abs(got_value - value.item()) <= LOSS_RTOL * abs(
                value.item()), (name, r, got_value, value.item())
            err = (got_grad - grad).abs().max().item()
            assert err <= LOSS_RTOL * grad.abs().max().item(), (name, r, err)
    # The JAX package's single-device values are the port's.
    jx = float(jax_stft_loss(jnp.asarray(x * (1.0 + gain)), jnp.asarray(y),
                             jax_config.TINY.stft_loss))
    assert abs(cases["loss_grads"][0]["stft"][0] - jx) <= 1e-4 * abs(jx)


def test_shard_map_many_equals_chained_steps(cases):
    for r, res in enumerate(cases["many"]):
        for k, w in res["chain_metrics"].items():
            got = res["many_metrics"][k]
            assert abs(got - w) <= MANY_RTOL * abs(w), (r, k, got, w)
        for part in ("g", "d", "ema"):
            for k, w in res["chain_params"][part].items():
                err = (res["many_params"][part][k] - w).abs().max().item()
                assert err <= MANY_ATOL, (r, part, k, err)
    a, b = cases["many"]
    assert a["many_metrics"] == b["many_metrics"]


def test_draws_outside_a_group_come_from_the_shared_generator():
    """Outside a group both modes draw from the shared generator, as the
    single-process step does; they differ only under a group (the ranks'
    cases above), and an unknown mode is refused."""
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = stage2.Draws(g1, None, "jit").normal((2, 5))
    b = stage2.Draws(g2, None, "shard_map").normal((2, 5))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dp must be one of"):
        stage2.Draws(g1, None, "pjit")
