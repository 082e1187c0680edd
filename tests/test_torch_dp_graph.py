"""The data-parallel steps in the form a CUDA graph captures, on the CPU,
where they run eagerly: ``stage2.GraphedStep`` and ``stage1.GraphedStep``
under a process group (``group``, ``dp``), the bodies that one NCCL rank
replays as a graph on a card, over two gloo ranks here.

One group of two ranks (``parallel.mesh.launch``, ``tests/torch_dp_ref.py``)
runs every case, from ``test_torch_parallel.jax_dp_runs``' JAX references
(TINY with the flagship's knobs, stage 2 on 2 rows and stage 1 on 4, from
a JAX state two steps in, 3 steps: for stage 2 two inside the warmup gate
and the third past it):

- the in-place DP step equals the eager DP step (``make_dp_stage*_step``,
  ``make_shardmap_stage*_step``) bit for bit, in every metric and every G,
  D and EMA parameter, in both stages and both modes, with JAX's draws
  injected and with the steps drawing their own (the shard_map seeding
  among them);
- ``stage2.train_step_many`` under the group (K = 3, both modes) equals
  three in-place steps bit for bit;
- the in-place DP step is held to JAX's DP steps as ``test_torch_parallel``
  holds the eager one: every metric to 1e-4 relative, every parameter to
  1e-5 absolute, except JAX's stage-2 shard_map step's G side, which the
  reference's N-times gradient reaches (ROADMAP Queue 3 item 12): there
  the first step's losses and D side only.

And, in this process: ``mesh.graphable`` and ``mesh.group_key`` on a
one-rank gloo group, which a graphed step refuses on a card; and
sequence-sharded vocoding through its per-shard programs against the
direct vocoder (2e-5, ``test_torch_seqshard``'s tolerance), with programs
whose outputs share one buffer, as graphs replayed from one pool may.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dp_ref
import torch_train_ref as ref
from music_synthesis_tpu_torch.parallel import mesh, seqshard
from music_synthesis_tpu_torch.parallel.seqshard import (
    make_seqshard_vocode,
    receptive_field_frames,
)
from music_synthesis_tpu_torch.train import stage1, stage2
from test_torch_parallel import (
    N,
    N_STEPS,
    _metrics_close,
    _params_close,
    jax_dp_runs,
)
from torch_tiny_ref import tiny_vocoder

torch.set_num_threads(1)

K = 3
MODES = [(stage, dp) for stage in (2, 1) for dp in ("jit", "shard_map")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and the ranks' results: per (stage, dp) the eager
    and the in-place DP step, each with JAX's draws and with its own; per
    dp ``train_step_many`` against K in-place steps."""
    specs = jax_dp_runs(tmp_path_factory.mktemp("dp_graph"))
    jobs, keys = [], []
    for (stage, dp), r in specs.items():
        own = [[(batch, None, None) for batch, _, _ in rank]
               for rank in r["per_rank"]]
        for draws, data in (("jax", r["per_rank"]), ("own", own)):
            for graphed in (False, True):
                jobs.append({"kind": "train", "args": dict(
                    stage=stage, cfg=r["cfg"], state_path=r["state_path"],
                    dp=dp, data=data, graphed=graphed)})
                keys.append((stage, dp, draws, graphed))
    chunk = (0.5 * np.tanh(np.random.default_rng(11).standard_normal(
        (K, len(specs[2, "jit"]["batch"]), 2048)))).astype(np.float32)
    for dp in ("jit", "shard_map"):
        jobs.append({"kind": "many_in_place", "args": dict(
            cfg=specs[2, dp]["cfg"], state_path=specs[2, dp]["state_path"],
            dp=dp, chunk=chunk)})
        keys.append(("many", dp))
    ranks = mesh.launch(torch_dp_ref.run_jobs, N, (jobs,),
                        devices=["cpu"] * N)
    return {"jax": {k: r["jax"] for k, r in specs.items()},
            "ranks": {key: [r[i] for r in ranks]
                      for i, key in enumerate(keys)}}


def _params_equal(a: dict, b: dict, where: str) -> None:
    for part in ("g", "d", "ema"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), f"{where}: {part} {k}"


@pytest.mark.parametrize("draws", ["jax", "own"])
@pytest.mark.parametrize("stage, dp", MODES)
def test_in_place_dp_step_equals_the_eager_dp_step(runs, stage, dp, draws):
    eager = runs["ranks"][stage, dp, draws, False]
    graphed = runs["ranks"][stage, dp, draws, True]
    for r, (e, g) in enumerate(zip(eager, graphed)):
        where = f"stage {stage} {dp} ({draws} draws) rank {r}"
        assert g["step"] == e["step"] == ref.PRE_STEPS + N_STEPS, where
        assert g["metrics"] == e["metrics"], where
        _params_equal(g["params"], e["params"], where)
    assert graphed[0]["metrics"] == graphed[1]["metrics"]
    _params_equal(graphed[0]["params"], graphed[1]["params"], "ranks")


@pytest.mark.parametrize("dp", ["jit", "shard_map"])
def test_train_step_many_under_a_group_equals_in_place_steps(runs, dp):
    for r, res in enumerate(runs["ranks"]["many", dp]):
        assert res["many_metrics"] == res["steps_metrics"], (dp, r)
        _params_equal(res["many_params"], res["steps_params"], f"{dp} {r}")


@pytest.mark.parametrize("stage, dp", MODES)
def test_in_place_dp_step_matches_jax(runs, stage, dp):
    rank = runs["ranks"][stage, dp, "jax", True][0]
    jax_steps = runs["jax"][stage, dp]
    if (stage, dp) == (2, "shard_map"):
        # The reference's fault reaches G's gradient (module docstring).
        _metrics_close(rank["metrics"][0], jax_steps[0][1],
                       "stage 2 shard_map first step",
                       skip=("g_grad_norm", "g_update_norm"))
        return
    for i in range(N_STEPS):
        _metrics_close(rank["metrics"][i], jax_steps[i][1],
                       f"stage {stage} {dp} step {ref.PRE_STEPS + i}")
    _params_close(rank["params"], jax_steps[-1][0], f"stage {stage} {dp}")


@pytest.fixture
def gloo_group():
    """A one-rank gloo group in this process, left (``mesh.leave``)
    after the test."""
    mesh.init_process_group(0, 1, mesh.free_port(), "gloo", "cpu")
    try:
        yield dist.group.WORLD
    finally:
        mesh.leave()


def test_gloo_groups_run_eagerly_and_a_graph_refuses_them(gloo_group):
    assert mesh.graphable(None)
    assert not mesh.graphable(gloo_group)
    key = mesh.group_key(gloo_group, "jit")
    assert key == (gloo_group, (0,), "gloo", "jit")
    assert mesh.group_key(None, "jit") is None
    assert hash(key) == hash(mesh.group_key(gloo_group, "jit"))
    assert key != mesh.group_key(gloo_group, "shard_map")
    _, cfg = ref.configs()
    with pytest.raises(ValueError, match="cannot capture the collectives"):
        stage2.GraphedStep(cfg, "cuda", group=gloo_group, dp="jit")
    with pytest.raises(ValueError, match="cannot capture the collectives"):
        stage1.GraphedStep(cfg, "cuda", gloo_group, "jit")
    # On the CPU a step under the group keeps its cache key per mode.
    steps = {dp: stage2.graphed_step(cfg, (1, 2048), torch.device("cpu"),
                                     group=gloo_group, dp=dp)
             for dp in ("jit", "shard_map")}
    assert steps["jit"] is not steps["shard_map"]
    assert steps["jit"].group is gloo_group and steps["jit"].dp == "jit"
    assert stage2.graphed_step(cfg, (1, 2048), torch.device("cpu"),
                               group=gloo_group, dp="jit") is steps["jit"]


class OneBuffer:
    """A stand-in for ``_graphs.Programs`` whose programs all return one
    output buffer, overwritten by every call, as programs replayed from
    one memory pool may; it records the keys it is called with."""

    def __init__(self, device):
        self.keys, self.out = [], None

    def __call__(self, key, fn, *inputs):
        self.keys.append(key)
        out = fn(*inputs)
        if self.out is None or self.out.shape != out.shape:
            self.out = torch.empty_like(out)
        return self.out.copy_(out)


def test_seqshard_copies_each_shard_out_before_the_next_program(
        monkeypatch):
    monkeypatch.setattr(seqshard, "Programs", OneBuffer)
    _, _, voc = tiny_vocoder(seed=3)
    mel = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 64, voc.cfg.n_mels)).astype(np.float32))
    fn = make_seqshard_vocode(voc, ["cpu", "cpu"])
    got = fn(mel)
    (programs,) = fn.programs.values()
    assert programs.keys == [(0,), (1,)]
    with torch.inference_mode():
        direct = voc(mel)
    h = receptive_field_frames(voc.cfg) + 2
    mid = slice(h * voc.cfg.hop_length, -h * voc.cfg.hop_length)
    assert got.shape == direct.shape
    np.testing.assert_allclose(got[:, mid].numpy(), direct[:, mid].numpy(),
                               atol=2e-5)
    # Each shard's piece is its own: the first half is not the second's.
    half = got.shape[1] // 2
    assert not torch.equal(got[:, :half], got[:, half:])


def test_seqshard_programs_are_one_per_device():
    _, _, voc = tiny_vocoder(seed=3)
    fn = make_seqshard_vocode(voc, ["cpu", "cpu", "cpu", "cpu"])
    assert list(fn.programs) == [torch.device("cpu")]
