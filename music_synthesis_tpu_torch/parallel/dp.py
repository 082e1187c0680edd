"""Data-parallel training steps that follow the global batch (counterpart
of ``parallel/dp.py``, the CLIs' ``--dp jit``).

Each rank calls the step with its rows of the global batch
(``parallel.mesh.shard_batch``) and holds the whole state. The step draws
the whole global batch's instance noise (and, in stage 1, its latents)
from the state's generator, which is the same on every rank, and keeps its
rows; gradients and metrics are averaged over the ranks. So with the same
batch the step equals the single-process step on the concatenated batch,
as the reference's jit-sharded step equals its single-device step.

On a card, over an NCCL group, each rank replays the step's CUDA graph
(``stage2.GraphedStep``, ``stage1.GraphedStep``, the reference's
``jax.jit(..., donate_argnums=0)``): the gradient all-reduces, the
losses' cross-rank sums and the metrics' means are NCCL kernels captured
in it; the draws stay eager. Over gloo, whose collectives run on the host
and cannot be captured, and on the CPU, the step runs eagerly. Every rank
must call the same steps in the same order (``train.state.cached_step``).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch.distributed as dist

from music_synthesis_tpu_torch.config import PipelineConfig
from music_synthesis_tpu_torch.train import stage1, stage2

__all__ = ["make_dp_step", "make_dp_stage1_step", "make_dp_stage2_step"]


def make_dp_step(step_fn: Callable, cfg: PipelineConfig, group=None,
                 dp: str = "jit") -> Callable:
    """``step_fn(cfg, state, batch, ..., group=, dp=)`` as ``(state,
    batch, **kw) -> (state, metrics)`` over ``group`` (the default group
    unless given; it must be initialised)."""
    if not dist.is_initialized():
        raise RuntimeError("data-parallel steps need a process group "
                           "(parallel.multihost.initialize or "
                           "parallel.mesh.launch)")
    return functools.partial(step_fn, cfg, group=group or dist.group.WORLD,
                             dp=dp)


def make_dp_stage2_step(cfg: PipelineConfig, group=None) -> Callable:
    """``(state, wav [B/N, L], noise=None, precision="fast") -> (state,
    metrics)``; ``noise`` is this rank's rows of the global draws. One
    CUDA graph per rank over NCCL, eager over gloo (the module's
    docstring)."""
    return make_dp_step(stage2.train_step, cfg, group)


def make_dp_stage1_step(cfg: PipelineConfig, group=None) -> Callable:
    """``(state, mel [B/N, T, M], z=None, noise=None) -> (state,
    metrics)``. One CUDA graph per rank over NCCL, eager over gloo (the
    module's docstring)."""
    return make_dp_step(stage1.train_step, cfg, group)
