"""Multi-process initialisation (counterpart of ``parallel/multihost.py``).

Under ``torchrun`` (or any launcher that sets its variables: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) every
process calls ``initialize()`` once; without the variables, or with a world
size of 1, it does nothing, as the reference's single-process fallback.
Rank r runs on ``cuda:LOCAL_RANK`` unless the caller names a device, and
feeds ``local_batch_slice`` of each global batch. There is no fallback:
with fewer cards than local ranks ``rank_device`` raises with the reason,
and the backend is the one the device asks for (``nccl`` for CUDA,
``gloo`` for the CPU) unless the caller names one.

    torchrun --nproc-per-node 8 \\
        -m music_synthesis_tpu_torch.scripts.train_stage2 --mesh 8 ...
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from music_synthesis_tpu_torch.parallel import mesh

__all__ = ["env_world_size", "initialize", "local_batch_slice",
           "rank_device"]


def env_world_size() -> int:
    """``WORLD_SIZE`` from the environment, 1 when it is not set."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """This rank's device: ``device`` when it names an index or the CPU,
    else ``cuda:LOCAL_RANK``; raises when that card is not visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= have:
        raise RuntimeError(
            f"local rank {local} needs cuda:{local}, but {have} CUDA "
            "device(s) are visible; start fewer ranks per node or pass "
            "device='cpu'")
    return torch.device("cuda", local)


def initialize(device: str | torch.device | None = None,
               backend: str | None = None):
    """Join the group that torchrun's variables describe; returns the
    default group, or None for a single process (no variables, or
    ``WORLD_SIZE`` 1). ``device`` as ``rank_device`` takes it."""
    world = env_world_size()
    if world <= 1:
        return None
    if dist.is_initialized():
        return dist.group.WORLD
    dev = rank_device(device)
    return mesh.init_process_group(
        int(os.environ["RANK"]), world, int(os.environ["MASTER_PORT"]),
        backend or mesh.backend_for(dev), dev,
        host=os.environ.get("MASTER_ADDR", "127.0.0.1"))


def local_batch_slice(global_batch: int) -> slice:
    """The rows of the global batch this rank feeds."""
    per = global_batch // mesh.world_size()
    start = per * mesh.rank()
    return slice(start, start + per)
