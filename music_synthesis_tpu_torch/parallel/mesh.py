"""Process groups, ranks and device lists (counterpart of
``parallel/mesh.py``).

The reference shards one program over a device mesh. The port has two
mechanisms in its place:

- training runs one process per rank. ``torch.distributed`` carries the
  collectives (``nccl`` for CUDA tensors, ``gloo`` for CPU ones; a caller
  may name ``gloo`` for CUDA tensors too). Each rank holds the whole state
  and its own rows of the global batch (``shard_batch``, ``shard_chunk``);
  the gradient and metric reductions are explicit ``all_reduce`` calls in
  the training steps (``train/stage2.py``, ``train/stage1.py``);
- inference shards over a list of devices in one process
  (``device_list``): module replicas, and split, run and gather steps
  (``parallel/seqshard.py``, ``serve.SynthService``).

``launch`` starts the ranks of one program from one process:
``torch.multiprocessing`` with the ``spawn`` start method and a free
localhost port. Under ``torchrun`` the ranks exist already and
``parallel/multihost.py`` joins them.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import tempfile
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from music_synthesis_tpu_torch._graphs import drop_graphed_steps

__all__ = ["world_size", "rank", "backend_for", "init_process_group",
           "leave", "graphable", "group_key", "shard_batch", "shard_chunk",
           "replicate_state", "all_reduce_mean", "AllReduce", "device_list",
           "free_port", "launch"]

# How long a collective may wait for the other ranks before it raises.
TIMEOUT = timedelta(seconds=600)


def world_size(group=None) -> int:
    """Ranks in ``group`` (the default group if None); 1 without one."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without one."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def backend_for(device: str | torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(rank_: int, world_size_: int, port: int,
                       backend: str, device: str | torch.device,
                       host: str = "127.0.0.1"):
    """Join a ``world_size_``-rank group at ``tcp://host:port`` as
    ``rank_`` with ``backend``, and make ``device`` this process's current
    CUDA device when it is one. Returns the default group."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            rank=rank_, world_size=world_size_,
                            timeout=TIMEOUT)
    return dist.group.WORLD


def leave() -> None:
    """Destroys the default group, after dropping the process's graphed
    training steps: a CUDA graph that captured NCCL's collectives holds
    resources of the group's communicator, so it goes first."""
    drop_graphed_steps()
    dist.destroy_process_group()


def graphable(group) -> bool:
    """Whether a training step under ``group`` replays a CUDA graph on a
    card: without a group, or over NCCL, whose collectives are kernels on
    the card that a graph captures. gloo's collectives run on the host and
    cannot be captured, so a step over gloo runs eagerly, by design."""
    return group is None or dist.get_backend(group) == "nccl"


def group_key(group, dp: str):
    """What a cache of graphed steps keys on for ``group``: the group, its
    ranks, its backend and the step's ``dp`` mode (None without a group)."""
    if group is None:
        return None
    return (group, tuple(dist.get_process_group_ranks(group)),
            dist.get_backend(group), dp)


def _rows(n: int, group) -> slice:
    w = world_size(group)
    if n % w:
        raise ValueError(f"a batch of {n} rows does not divide over {w} "
                         "ranks")
    per = n // w
    return slice(per * rank(group), per * (rank(group) + 1))


def shard_batch(batch, group=None):
    """This rank's rows of a global batch (leading dim), a tensor or array
    (or a list of them)."""
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(b, group) for b in batch)
    return batch[_rows(batch.shape[0], group)]


def shard_chunk(chunk, group=None):
    """This rank's rows of a ``[K, B, ...]`` step chunk (dim 1)."""
    return chunk[:, _rows(chunk.shape[1], group)]


def replicate_state(state, group=None, src: int = 0):
    """Broadcast every tensor of a training state (and its generator's
    state) from rank ``src``, in place; returns ``state``. A no-op without
    a process group."""
    if world_size(group) == 1:
        return state
    tensors = []
    for field in dataclasses.fields(state):
        value = getattr(state, field.name)
        if isinstance(value, dict):
            tensors += list(value.values())
        elif dataclasses.is_dataclass(value):  # an AdamState
            tensors += list(value.mu.values()) + list(value.nu.values())
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src, group=group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    buf = state.rng.get_state().to(flat.device)
    dist.broadcast(buf, src, group=group)
    state.rng.set_state(buf.cpu())
    return state


def all_reduce_mean(tensors: list[torch.Tensor], group=None
                    ) -> list[torch.Tensor]:
    """The mean over ranks of each tensor (``lax.pmean``), in one
    collective; new tensors, the inputs are not changed."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(world_size(group))
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


class AllReduce(torch.autograd.Function):
    """``scale * sum over ranks`` of ``x``, whose gradient is the one the
    single-process computation would give after the training step's mean
    of the gradients over ranks.

    Every rank computes the same loss from the reduced value, so the
    gradient arriving here is the same on every rank; the single-process
    gradient of this rank's ``x`` is ``scale`` times it, and the step's
    mean over ranks divides by N, so the backward returns ``N * scale``
    times the incoming gradient with no collective. (An all-reduce in the
    backward, as ``torch.distributed.nn.functional.all_reduce`` does,
    would multiply by N once more.)
    """

    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.factor = world_size(group) * scale
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out * scale

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.factor, None, None


def device_list(n: int, device: str | torch.device | None = None,
                devices: Sequence[str | torch.device] | None = None
                ) -> list[torch.device]:
    """``n`` devices for the one-process paths: ``devices`` as given (it
    may repeat a device, as ``make_mesh(devices=...)`` takes any list);
    else ``cuda:0`` .. ``cuda:n-1`` for a CUDA ``device`` (``cuda`` unless
    told otherwise), raising with the reason when fewer cards are visible;
    else ``n`` times the CPU."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if len(out) != n:
            raise ValueError(f"{len(out)} devices given for {n}")
        return out
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return [dev] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"{n} CUDA devices asked for, {have} visible; pass an explicit "
            "device list, or device='cpu' to run on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank_: int, world: int, port: int, backend: str,
               devices: list[str], threads: int, out_dir: str,
               fn: Callable, args: tuple) -> None:
    """One spawned rank: torchrun's variables, the group, ``fn(*args)``,
    its result to ``out_dir/<rank>.pt``."""
    os.environ.update(RANK=str(rank_), LOCAL_RANK=str(rank_),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    init_process_group(rank_, world, port, backend, devices[rank_])
    try:
        result = fn(*args)
        torch.save(result, Path(out_dir) / f"{rank_}.pt")
    finally:
        leave()


def launch(fn: Callable, world: int, args: tuple = (), *,
           backend: str | None = None,
           devices: Sequence[str | torch.device] | None = None
           ) -> list[Any]:
    """Run ``fn(*args)`` on ``world`` ranks, each a process started with
    the ``spawn`` method, in a group on a free localhost port; returns each
    rank's return value (``torch.save``-able, loaded onto the CPU), in
    rank order.

    ``devices``: rank r's device (default: ``device_list(world)``,
    ``cuda:0`` .. ``cuda:world-1``, which raises before any rank starts
    when fewer cards are visible; the CPU only when named); ranks may share
    a device. ``backend``:
    ``backend_for`` the first device unless named (``nccl`` refuses two
    ranks on one device; ``gloo`` takes CUDA tensors through the host).
    ``fn`` must be importable by name (a module-level function), and the
    caller's main script must guard its entry point (each rank imports it).
    The ranks share this process's CPU threads. When a rank raises, the
    others are stopped and the error is raised here.
    """
    import torch.multiprocessing as mp

    devices = [str(d) for d in device_list(world, devices=devices)]
    backend = backend or backend_for(devices[0])
    threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory(prefix="ranks_") as out_dir:
        mp.start_processes(
            _rank_main, args=(world, free_port(), backend, devices, threads,
                              out_dir, fn, tuple(args)),
            nprocs=world, join=True, start_method="spawn")
        return [torch.load(Path(out_dir) / f"{r}.pt", map_location="cpu",
                           weights_only=False) for r in range(world)]
