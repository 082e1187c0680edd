"""The ranks' side of the port's data-parallel tests (``test_torch_parallel``,
``test_torch_dp_graph``, and on the card ``test_torch_gpu``): functions that
``parallel.mesh.launch``
runs in each spawned rank. Imports no JAX (the ranks do not load ``conftest.py``);
the JAX references are computed in the test process and arrive here as
arrays.

``run_jobs(jobs)`` runs a list of jobs in one group of ranks, so that the
group starts once for all of them. Each job is a dict with a ``kind`` and
its arguments; a training job's per-step data is given per rank (the
rank's rows of the batch and, when injected, of the draws).
"""

from __future__ import annotations

import numpy as np
import torch

from music_synthesis_tpu_torch.losses.phase_loss import phase_coherence_loss
from music_synthesis_tpu_torch.losses.stft_loss import multires_stft_loss
from music_synthesis_tpu_torch.parallel import mesh
from music_synthesis_tpu_torch.parallel.dp import (
    make_dp_stage1_step,
    make_dp_stage2_step,
)
from music_synthesis_tpu_torch.parallel.shard_map_dp import (
    make_shardmap_stage1_step,
    make_shardmap_stage2_many,
    make_shardmap_stage2_step,
)
from music_synthesis_tpu_torch.train import stage1, stage2
from music_synthesis_tpu_torch.train.checkpoint import restore_checkpoint
from music_synthesis_tpu_torch.train.state import _floats

STEPS = {("jit", 1): make_dp_stage1_step, ("jit", 2): make_dp_stage2_step,
         ("shard_map", 1): make_shardmap_stage1_step,
         ("shard_map", 2): make_shardmap_stage2_step}


def params(state) -> dict:
    """G, D and EMA parameters of a state, as CPU tensors."""
    return {"g": {k: v.cpu() for k, v in state.g_params.items()},
            "d": {k: v.cpu() for k, v in state.d_params.items()},
            "ema": ({k: v.cpu() for k, v in state.g_ema.items()}
                    if state.g_ema is not None else None)}


def in_place(stage: int, cfg, dp: str, device: str = "cpu"):
    """The DP step in place, ``GraphedStep`` under the default group (its
    body runs eagerly on the CPU), as ``(state, batch, z=None,
    noise=None) -> (state, metrics as floats)``."""
    group = torch.distributed.group.WORLD
    if stage == 2:
        step = stage2.GraphedStep(cfg, device, group=group, dp=dp)
    else:
        step = stage1.GraphedStep(cfg, device, group, dp)

    def run(state, batch, z=None, noise=None):
        kw = {"noise": noise} if stage == 2 else {"z": z, "noise": noise}
        state, metrics = step(state, batch, **kw)
        return state, _floats(metrics)

    return run


def train(stage: int, cfg, state_path: str, dp: str, data: list,
          device: str = "cpu", graphed: bool = False) -> dict:
    """Steps of one DP mode from the saved state; ``data[rank]`` is this
    rank's list of ``(batch, z, noise)`` per step (``z`` for stage 1 only,
    ``None`` where the step draws). ``graphed``: the step in place
    (``in_place``, on the CPU) in place of the DP step's factory. On a
    card: fp32 with cuDNN's TF32 off and the log-mel kernel's "exact"
    mode."""
    step = in_place(stage, cfg, dp, device) if graphed else STEPS[dp, stage](
        cfg)
    state = restore_checkpoint(state_path, device)
    cuda = torch.device(device).type == "cuda"
    torch.backends.cudnn.allow_tf32 = not cuda
    metrics = []
    for batch, z, noise in data[mesh.rank()]:
        kw = {"noise": noise} if stage == 2 else {"z": z, "noise": noise}
        if cuda and stage == 2:
            kw["precision"] = "exact"
        state, m = step(state, torch.from_numpy(batch), **kw)
        metrics.append(m)
    return {"metrics": metrics, "params": params(state), "step": state.step}


def many(cfg, state_path: str, chunk: np.ndarray) -> dict:
    """``make_shardmap_stage2_many`` on this rank's rows of ``chunk [K, B,
    L]`` against K chained ``make_shardmap_stage2_step`` calls, both from
    the saved state and drawing their own noise."""
    local = torch.from_numpy(np.ascontiguousarray(mesh.shard_chunk(chunk)))
    out = {}
    st = restore_checkpoint(state_path, "cpu")
    st, out["many_metrics"] = make_shardmap_stage2_many(cfg)(st, local)
    out["many_params"] = params(st)
    st = restore_checkpoint(state_path, "cpu")
    step = make_shardmap_stage2_step(cfg)
    for wav in local:
        st, m = step(st, wav)
    out["chain_metrics"], out["chain_params"] = m, params(st)
    return out


def many_in_place(cfg, state_path: str, dp: str, chunk: np.ndarray) -> dict:
    """``stage2.train_step_many`` under the group on this rank's rows of
    ``chunk [K, B, L]`` against K calls of the in-place step
    (``in_place``), both from the saved state and drawing their own
    noise."""
    group = torch.distributed.group.WORLD
    local = torch.from_numpy(np.ascontiguousarray(mesh.shard_chunk(chunk)))
    out = {}
    st = restore_checkpoint(state_path, "cpu")
    st, out["many_metrics"] = stage2.train_step_many(cfg, st, local,
                                                     group=group, dp=dp)
    out["many_params"] = params(st)
    st = restore_checkpoint(state_path, "cpu")
    step = in_place(2, cfg, dp)
    for wav in local:
        st, m = step(st, wav)
    out["steps_metrics"], out["steps_params"] = m, params(st)
    return out


def loss_grads(stft_cfg, phase_args: tuple, x: np.ndarray, y: np.ndarray,
               gain: np.ndarray) -> dict:
    """Both losses of ``x * (1 + gain)`` against ``y`` on this rank's rows,
    under the group, and the gradient of each with respect to the
    replicated ``gain`` averaged over the ranks (what a DP step hands
    Adam): the value (averaged over the ranks) and that gradient."""
    group = torch.distributed.group.WORLD
    xs, ys = (torch.from_numpy(mesh.shard_batch(a)) for a in (x, y))
    out = {}
    for name, fn in (
            ("stft", lambda a: multires_stft_loss(a, ys, stft_cfg, group)),
            ("phase", lambda a: phase_coherence_loss(a, ys, *phase_args,
                                                     group=group))):
        g = torch.from_numpy(gain).requires_grad_()
        value = fn(xs * (1.0 + g))
        (grad,) = torch.autograd.grad(value, g)
        value, grad = mesh.all_reduce_mean([value.detach(), grad], group)
        out[name] = (value.item(), grad)
    return out


KINDS = {"train": train, "many": many, "many_in_place": many_in_place,
         "loss_grads": loss_grads}


def run_jobs(jobs: list[dict]) -> list:
    """Each job's result, in order (the function a group of ranks runs)."""
    return [KINDS[job["kind"]](**job["args"]) for job in jobs]

