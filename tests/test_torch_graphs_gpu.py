"""Card-only tests of the port's CUDA graphs (``_graphs.py``): each graphed
path against its eager launches at TINY width, the log-mel kernel's
launches per replay, and replays after a second service's capture.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and skips
without one. This file imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_graphs_gpu.py --noconftest -q

Graphed against eager: max |graphed - eager| may not exceed the card's own
run-to-run gap, max |eager - eager| over three eager calls on the same
input (0 where the kernels are deterministic). The stage-1 step: three
graphed steps against three eager ones from one state, every metric
within the gap between two eager runs or ``chip_smoke.py``'s
``STAGE1_TOL`` (1e-6 relative on the losses, 1e-4 on the gradient norms),
whichever is larger, and every state tensor within that gap or 1e-6 of
its largest magnitude: the metrics agree bit for bit on the card, but
after a few steps D's Adam moments can differ at rounding level
(PERF.md §7). The stage-2 flagship step at full width ([16, 8192],
bf16, zoo G, seeded D, ``flagship_config``: R1, instance noise, the
MSD's dense block-diagonal convolutions), one step on each side of the
warmup gate: graphed against eager within the same tolerances, one
log-mel launch per replay. The same flagship step under a one-rank NCCL
group in this process (a real ``ProcessGroupNCCL``, whose collectives the
step's graph captures), both ``dp`` modes, graphed against eager within
the same tolerances. Sequence-sharded vocoding over ``[cuda, cuda]``, one
graph per shard, against its eager run within the card's own eager gap.
A second service's audio against the first's: 2e-3 (``FP32_TOL``).
Deployment artifacts (``deploy.load_artifact`` on the card, symbolic
batch, the vocoder and the pipeline): the graphed call bit for bit with
the same artifact's eager call at batch 1 and 4, one program per batch
size, and a kept batch-1 result unchanged by a batch-4 replay; a
``Programs`` call with ``fresh`` returns copies of the graph's buffers
(tensor, tuple and dict outputs).
"""

import contextlib
import dataclasses
import threading

import numpy as np
import pytest
import torch

from music_synthesis_tpu_torch import _graphs, config
from music_synthesis_tpu_torch.infer import generate as gen
from music_synthesis_tpu_torch.infer.copy_synthesis import copy_synthesis
from music_synthesis_tpu_torch.infer.stream import make_stream_fns
from music_synthesis_tpu_torch.models.specgan import SpectrogramGenerator
from music_synthesis_tpu_torch.models.vocoder import Vocoder
from music_synthesis_tpu_torch.ops.logmel import logmel_kernel
from music_synthesis_tpu_torch.train import stage1, stage2
from music_synthesis_tpu_torch.train.state import state_groups

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)

STAGE1_TOL = {"loss": 1e-6, "grad_norm": 1e-4}
STATE_RTOL = 1e-6
FP32_TOL = 2e-3
CFG = dataclasses.replace(config.TINY, vocoder=dataclasses.replace(
    config.TINY.vocoder, upsample_factors=(8, 8), head="istft"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture
def pair(cuda):
    comp = SpectrogramGenerator(CFG.specgan, torch.Generator().manual_seed(0))
    voc = Vocoder(CFG.vocoder, torch.Generator().manual_seed(1))
    return comp.to(cuda).eval(), voc.to(cuda).eval()


def _outputs(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [t.detach().float().clone() for t in outs]


def _gap(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _graphed_within_eager_gap(call):
    """Three eager and two graphed outputs of ``call()``; returns (max
    |graphed - eager|, max |eager - eager|)."""
    with torch.inference_mode():
        with _graphs.disable_graphs():
            eager = [_outputs(call()) for _ in range(3)]
        graphed = [_outputs(call()) for _ in range(2)]
    floor = max(_gap(eager[i], eager[j]) for i, j in ((0, 1), (0, 2), (1, 2)))
    gap = max(_gap(g, eager[0]) for g in graphed)
    assert gap <= floor, (gap, floor)
    return gap, floor


@pytest.mark.parametrize("fn, static", [
    (gen.generate, ()), (gen.generate_refined, (2,)),
    (gen.generate_long, (4,)), (gen.generate_long_refined, (4, 2))])
def test_generate_graphed_equals_eager(pair, cuda, fn, static):
    comp, voc = pair
    shape = (2, 3, CFG.specgan.latent_dim) if "long" in fn.__name__ else (
        2, CFG.specgan.latent_dim)
    z = torch.randn(shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    pipe = gen.GraphedPipeline(CFG, comp, voc)
    _graphed_within_eager_gap(lambda: pipe(fn, z, *static))
    program, = pipe.programs.programs.values()
    assert program.graph is not None
    assert pipe.programs.pool_bytes() > 0


def test_stream_forwards_graphed_equal_eager(pair, cuda):
    comp, voc = pair
    programs = _graphs.Programs(cuda)
    patch_fn, chunk_fn = make_stream_fns(CFG, programs)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((1, CFG.specgan.latent_dim)).astype(np.float32)
    mel = rng.standard_normal((1, CFG.infer.chunk_frames,
                               CFG.specgan.n_mels)).astype(np.float32)
    for fn, module, x in ((patch_fn, comp, z), (chunk_fn, voc, mel)):
        x_dev = torch.from_numpy(x).to(cuda)
        _graphed_within_eager_gap(lambda: programs((module,), module, x_dev))
        # The stream's own call replays the same graph.
        with torch.inference_mode():
            want = programs((module,), module, x_dev).cpu().numpy()
        np.testing.assert_array_equal(fn(module, x), want)
    assert len(programs.programs) == 2


def test_copy_synthesis_graph_launches_the_kernel_once_per_replay(pair, cuda):
    _, voc = pair
    hop = CFG.frontend.hop_length
    wav = (0.3 * torch.sin(torch.arange(2 * 64 * hop) * 0.03)).reshape(
        2, -1).to(cuda)
    programs = _graphs.Programs(cuda)

    def call():
        return programs("copy", lambda x: copy_synthesis(
            voc, x, CFG.frontend, CFG.mel_scaler), wav)

    before = logmel_kernel.n_launches
    _graphed_within_eager_gap(call)
    # 3 eager calls, then the build (not counted) and 2 replays.
    assert logmel_kernel.n_launches == before + 5
    program, = programs.programs.values()
    assert program.launches_per_replay == 1
    before = logmel_kernel.n_launches
    with torch.inference_mode():
        for _ in range(10):
            call()
    assert logmel_kernel.n_launches == before + 10


def test_graph_keys_follow_the_tf32_switch(pair, cuda):
    comp, voc = pair
    z = torch.randn((1, CFG.specgan.latent_dim), device=cuda)
    pipe = gen.GraphedPipeline(CFG, comp, voc)
    pipe(gen.generate, z)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        pipe(gen.generate, z)
    pipe(gen.generate, z)
    assert len(pipe.programs.programs) == 2


def test_mutated_tensors_are_updated_once_per_call(cuda):
    acc = torch.zeros(4, device=cuda)

    def add(x):
        acc.add_(x)
        return acc * 2

    program = _graphs.GraphedProgram(add, cuda, mutates=[acc])
    out = program(torch.ones(4))
    torch.testing.assert_close(acc, torch.ones(4, device=cuda))
    program(torch.full((4,), 2.0))
    torch.testing.assert_close(out, torch.full((4,), 6.0, device=cuda))
    with pytest.raises(ValueError, match="differ"):
        program(torch.ones(5))


def test_programs_fresh_outputs_are_copies_of_the_buffers(cuda):
    programs = _graphs.Programs(cuda)
    for key, fn in (("tensor", lambda x: x * 2),
                    ("tuple", lambda x: (x * 2, x + 1)),
                    ("dict", lambda x: {"a": x * 2, "b": x + 1})):
        first = programs(key, fn, torch.ones(4, device=cuda), fresh=True)
        again = programs(key, fn, torch.full((4,), 3.0, device=cuda))
        assert type(first) is type(again)
        out, buffers = ([t] if isinstance(t, torch.Tensor) else list(
            t.values() if isinstance(t, dict) else t) for t in (first, again))
        for o, b in zip(out, buffers):  # b: the graph's own buffers
            assert o.data_ptr() != b.data_ptr()
        torch.testing.assert_close(out[0], torch.full((4,), 2.0,
                                                      device=cuda))
        torch.testing.assert_close(buffers[0], torch.full((4,), 6.0,
                                                          device=cuda))


def test_stage1_graphed_steps_match_eager(cuda):
    cfg = dataclasses.replace(CFG, train=dataclasses.replace(
        CFG.train, batch_size=2, r1_gamma=1.0, d_input_noise=0.2,
        d_noise_decay_steps=2, lambda_flux=10.0, ema_decay=0.9,
        lr_decay_rate=0.5, lr_decay_every=2))
    mel = (0.8 * torch.tanh(torch.randn(
        (2, cfg.specgan.n_frames, cfg.specgan.n_mels),
        generator=torch.Generator().manual_seed(4)))).to(cuda)
    state0 = stage1.make_train_state(cfg, seed=3, device=cuda)
    runs = []
    for graphs in (False, False, True):
        st, out = state0, []
        with (contextlib.nullcontext() if graphs
              else _graphs.disable_graphs()):
            for _ in range(3):
                st, m = stage1.train_step(cfg, st, mel)
                out.append(m)
        runs.append(([g[k].clone() for g in state_groups(st)
                      for k in sorted(g)], out))
    step = stage1.graphed_step(cfg, mel.shape, mel.device)
    assert step.program.graph is not None
    (eager, m_eager), (again, m_again), (graphed, m_graphed) = runs
    for e, a, g in zip(eager, again, graphed):
        tol = max(STATE_RTOL * float(e.abs().max()),
                  float((a - e).abs().max()))
        assert float((g - e).abs().max()) <= tol
    for e, a, g in zip(m_eager, m_again, m_graphed):
        for k in e:
            kind = "grad_norm" if k.endswith("_norm") else "loss"
            tol = max(STAGE1_TOL[kind] * abs(e[k]), abs(a[k] - e[k]))
            assert abs(g[k] - e[k]) <= tol, (k, g[k], e[k])


def test_stage2_flagship_graphed_step_matches_eager(cuda):
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.train.flagship import (flagship_config,
                                                          zoo_train_state)

    entry = zoo.load_pretrained("vocoder_istft")
    cfg = flagship_config(entry)
    t = cfg.train
    assert cfg.msd.dense_groups_max_g == 16 and t.g_warmup_steps > 0
    state0 = zoo_train_state(cfg, entry, cuda, seed=0)
    wav = (0.5 * torch.tanh(torch.randn(
        (t.batch_size, t.segment_length),
        generator=torch.Generator().manual_seed(5)))).to(cuda)
    runs = []
    for graphs in (False, False, True):
        st, out = state0, []
        with (contextlib.nullcontext() if graphs
              else _graphs.disable_graphs()):
            for step in (0, t.g_warmup_steps):  # both sides of the gate
                before = logmel_kernel.n_launches
                st, m = stage2.train_step(
                    cfg, dataclasses.replace(st, step=step), wav)
                assert logmel_kernel.n_launches == before + 1
                out.append(m)
        runs.append(([g[k].clone() for g in state_groups(st)
                      for k in sorted(g)], out))
    program = stage2.graphed_step(cfg, wav.shape, wav.device).program
    assert program.graph is not None and program.launches_per_replay == 1
    (eager, m_eager), (again, m_again), (graphed, m_graphed) = runs
    for e, a, g in zip(eager, again, graphed):
        tol = max(STATE_RTOL * float(e.abs().max()),
                  float((a - e).abs().max()))
        assert float((g - e).abs().max()) <= tol
    for e, a, g in zip(m_eager, m_again, m_graphed):
        for k in e:
            if k == "d_update_norm" and e[k] == 0:  # inside the gate
                assert g[k] == 0
                continue
            kind = "grad_norm" if k.endswith("_norm") else "loss"
            tol = max(STAGE1_TOL[kind] * abs(e[k]), abs(a[k] - e[k]))
            assert abs(g[k] - e[k]) <= tol, (k, g[k], e[k])


@pytest.fixture
def nccl_group(cuda):
    """A one-rank NCCL group in this process, left (``mesh.leave``, which
    drops the graphs that hold its collectives first) after the test."""
    from music_synthesis_tpu_torch.parallel import mesh

    mesh.init_process_group(0, 1, mesh.free_port(), "nccl",
                            torch.device("cuda", torch.cuda.current_device()))
    try:
        yield torch.distributed.group.WORLD
    finally:
        mesh.leave()


@pytest.mark.parametrize("dp", ["jit", "shard_map"])
def test_stage2_flagship_dp_step_at_one_nccl_rank_graphed_matches_eager(
        nccl_group, cuda, dp):
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.parallel import mesh
    from music_synthesis_tpu_torch.train.flagship import (flagship_config,
                                                          zoo_train_state)

    assert mesh.graphable(nccl_group)
    entry = zoo.load_pretrained("vocoder_istft")
    cfg = flagship_config(entry)
    t = cfg.train
    state0 = zoo_train_state(cfg, entry, cuda, seed=0)
    wav = (0.5 * torch.tanh(torch.randn(
        (t.batch_size, t.segment_length),
        generator=torch.Generator().manual_seed(5)))).to(cuda)
    runs = []
    for graphs in (False, False, True):
        st, out = state0, []
        with (contextlib.nullcontext() if graphs
              else _graphs.disable_graphs()):
            for step in (0, t.g_warmup_steps):  # both sides of the gate
                before = logmel_kernel.n_launches
                st, m = stage2.train_step(
                    cfg, dataclasses.replace(st, step=step), wav,
                    group=nccl_group, dp=dp)
                assert logmel_kernel.n_launches == before + 1
                out.append(m)
        runs.append(([g[k].clone() for g in state_groups(st)
                      for k in sorted(g)], out))
    program = stage2.graphed_step(cfg, wav.shape, wav.device,
                                  group=nccl_group, dp=dp).program
    assert program.graph is not None and program.launches_per_replay == 1
    (eager, m_eager), (again, m_again), (graphed, m_graphed) = runs
    for e, a, g in zip(eager, again, graphed):
        tol = max(STATE_RTOL * float(e.abs().max()),
                  float((a - e).abs().max()))
        assert float((g - e).abs().max()) <= tol
    for e, a, g in zip(m_eager, m_again, m_graphed):
        for k in e:
            if k == "d_update_norm" and e[k] == 0:  # inside the gate
                assert g[k] == 0
                continue
            kind = "grad_norm" if k.endswith("_norm") else "loss"
            tol = max(STAGE1_TOL[kind] * abs(e[k]), abs(a[k] - e[k]))
            assert abs(g[k] - e[k]) <= tol, (k, g[k], e[k])


def test_seqshard_graphed_matches_eager(pair, cuda):
    from music_synthesis_tpu_torch.parallel.seqshard import (
        make_seqshard_vocode)

    _, voc = pair
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 64, CFG.vocoder.n_mels)).astype(np.float32)).to(cuda)
    fn = make_seqshard_vocode(voc, [cuda, cuda])
    _graphed_within_eager_gap(lambda: fn(mel))
    assert len(fn.programs[cuda].programs) == 2  # one per shard


def test_service_replays_after_a_second_service_captures(cuda):
    from music_synthesis_tpu_torch.serve import ServeConfig, SynthService

    sc = ServeConfig(composer="specgan_flux", vocoder="vocoder_istft",
                     batch_buckets=(1,), patch_buckets=(1, 2))
    first = SynthService(sc)
    try:
        want, _ = first.synth(4.0, seed=7)
        stop, seen, errors = threading.Event(), [], []

        def load():  # the old service keeps answering, as under /reload
            while not stop.is_set():
                try:
                    seen.append(first.synth(4.0, seed=7)[0])
                except Exception as e:  # noqa: BLE001 -- asserted below
                    errors.append(e)
                    return

        thread = threading.Thread(target=load)
        thread.start()
        try:
            second = SynthService(sc)
        finally:
            stop.set()
            thread.join(timeout=300)
        assert not thread.is_alive() and not errors and seen
        try:
            other, _ = second.synth(4.0, seed=7)
        finally:
            second.close()
        again, _ = first.synth(4.0, seed=7)
        for got in seen + [again]:
            np.testing.assert_array_equal(got, want)
        assert np.abs(other - want).max() <= FP32_TOL
        assert len(first.programs[first.device].programs) >= 3
    finally:
        first.close()


@pytest.fixture
def artifacts(pair, cuda, tmp_path):
    from music_synthesis_tpu_torch import deploy

    comp, voc = pair
    out = {}
    for kind, (programs, meta) in (
            ("vocoder", deploy.vocoder_artifact(
                voc.state_dict(), CFG.vocoder, n_frames=16, batch=None,
                platforms=("cuda",))),
            ("pipeline", deploy.pipeline_artifact(
                CFG, comp.state_dict(), voc.state_dict(), batch=None,
                platforms=("cuda",)))):
        path = deploy.save_artifact(tmp_path / f"{kind}.msx", programs, meta)
        out[kind] = deploy.load_artifact(path, device=cuda)
    return out


def _artifact_input(kind, b, seed, device):
    shape = ((b, 16, CFG.vocoder.n_mels) if kind == "vocoder"
             else (b, CFG.specgan.latent_dim))
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)
                       ).to(device)


@pytest.mark.parametrize("kind", ["vocoder", "pipeline"])
def test_artifact_graphed_equals_eager_one_program_per_batch(artifacts, cuda,
                                                              kind):
    art = artifacts[kind]
    for b in (1, 4):
        x = _artifact_input(kind, b, b, cuda)
        with torch.inference_mode():
            with _graphs.disable_graphs():
                eager = art(x)
            graphed = [art(x) for _ in range(2)]  # the first builds
        for g in graphed:
            assert torch.equal(g, eager)
    assert len(art.programs.programs) == 2
    assert art.programs.pool_bytes() > 0


@pytest.mark.parametrize("kind", ["vocoder", "pipeline"])
def test_artifact_result_survives_the_next_replay(artifacts, cuda, kind):
    art = artifacts[kind]
    first = art(_artifact_input(kind, 1, 30, cuda))
    kept = first.clone()
    art(_artifact_input(kind, 4, 31, cuda))
    art(_artifact_input(kind, 1, 32, cuda))  # the same program again
    torch.cuda.synchronize()
    assert torch.equal(first, kept)
    buffers = [p._outputs for p in art.programs.programs.values()]
    assert all(first.data_ptr() != b.data_ptr() for b in buffers)
