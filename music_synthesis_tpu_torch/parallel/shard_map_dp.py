"""Data-parallel training steps that follow the reference's per-device
step (counterpart of ``parallel/shard_map_dp.py``, the CLIs' default
``--dp shard_map``).

Each rank runs the step on its rows of the global batch, with its own
draws of instance noise (and, in stage 1, latents): a generator seeded
from one draw of the state's shared generator and the rank, where the
reference folds the device's mesh index into the key. Gradients and the
losses are averaged over the ranks (``lax.pmean``), ``g_rms_ratio`` is the
mean of the shards' ratios, and the STFT, phase and flux terms are the
global batch's (``losses/``, ``train/stage1.py``). The fused log-mel
kernel runs per rank, on the rank's rows.

On a card, over an NCCL group, each rank replays the step's CUDA graph
(the reference's ``jax.jit(shard_map(...), donate_argnums=0)``), its
collectives captured; the draws, the seeding of the rank's generator
(a host read) among them, stay eager. Over gloo, and on the CPU, the step
runs eagerly (``parallel/dp.py`` says why).
"""

from __future__ import annotations

from typing import Callable

from music_synthesis_tpu_torch.config import PipelineConfig
from music_synthesis_tpu_torch.parallel.dp import make_dp_step
from music_synthesis_tpu_torch.train import stage1, stage2

__all__ = ["make_shardmap_stage2_step", "make_shardmap_stage1_step",
           "make_shardmap_stage2_many"]


def make_shardmap_stage2_step(cfg: PipelineConfig, group=None) -> Callable:
    """``(state, wav [B/N, L], noise=None, precision="fast") -> (state,
    metrics)``; ``noise`` replaces this rank's own draws. One CUDA graph
    per rank over NCCL, eager over gloo (the module's docstring)."""
    return make_dp_step(stage2.train_step, cfg, group, dp="shard_map")


def make_shardmap_stage1_step(cfg: PipelineConfig, group=None) -> Callable:
    """Stage-1 twin: ``(state, mel [B/N, T, M], z=None, noise=None)``,
    graphed or eager as the stage-2 step."""
    return make_dp_step(stage1.train_step, cfg, group, dp="shard_map")


def make_shardmap_stage2_many(cfg: PipelineConfig, group=None) -> Callable:
    """``(state, wavs [K, B/N, L]) -> (state, last step's metrics)``: K
    chained steps on this rank's rows of a step chunk
    (``parallel.mesh.shard_chunk``), the same as K steps of
    ``make_shardmap_stage2_step``: over NCCL K replays of its graph back
    to back and one read of the metrics (the reference's K-step
    ``lax.scan``)."""
    return make_dp_step(stage2.train_step_many, cfg, group, dp="shard_map")
