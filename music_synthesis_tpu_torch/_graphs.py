"""CUDA graphs of the port's fixed-shape programs (the reference's ``jit``).

The JAX package runs each public program as one compiled XLA program per
static shape, dispatched in one call. The port's counterpart is one CUDA
graph per shape: ``GraphedProgram`` runs its function eagerly a few times
on a side stream (which fills every cache of device constants, loads the
kernel library and makes cuDNN's and cuFFT's choices), captures one call
with ``torch.cuda.graph``, and from then on copies each call's inputs into
its static input buffers, replays the graph and returns its static
outputs. ``Programs`` keeps one such program per key and input shapes;
``cached_step`` keeps the training steps (``train.state.InPlaceStep``),
each of which owns one.

- Graphs run on CUDA devices only. A call site decides by the device
  (``enabled``): on the CPU it runs its function eagerly, as before, and
  ``GraphedProgram`` refuses a non-CUDA device. Nothing falls back: a
  capture or a replay that fails raises.
- The outputs are the graph's buffers, overwritten by the next replay of
  any graph of the same pool. A caller that keeps one, or hands it to a
  user, clones it or copies it to the host first.
- A graph reads the tensors its function read at capture where they lay
  then: module parameters updated in place (``load_state_dict``, an
  optimizer's in-place step) are seen by the next replay; parameters
  replaced by new tensors are not.
- The switches that choose kernels (cuDNN's and cuBLAS's TF32 and
  reduced-precision flags, ``flags()``) are baked in at capture; they are
  part of every key, so a call under other switches captures its own graph.
- The tracer's ``COUNTERS`` (``ops/logmel.py``'s ``logmel_kernel``, the
  log-mel kernel's launches; ``ops/conv.py``'s ``grouped_wgrad2``, the
  second-order weight terms of grouped convolutions; ``ops/alias_free.py``'s
  ``aa_act`` and ``aa_act_kernel``; ``ops/snake.py``'s ``snake`` and
  ``models/codec.py``'s ``rvq_stage``) count calls: a replay adds the calls
  its capture issued. The warm-up's eager calls and the capture build the
  program (as the reference's first call compiles its program) and are
  taken back out of the counts; the tracer holds each label's counts per
  capture.
- A program may hold NCCL's collectives (a training step under an NCCL
  group: ``parallel.mesh.graphable``). NCCL makes its communicator at the
  group's first collective, on the host, which is outside any capture
  when it falls in the eager warm-up; the capture runs with
  ``capture_error_mode="thread_local"``, because NCCL's watchdog thread
  queries its events while a capture runs, which the global mode would
  count as a forbidden call that invalidates the capture. The ranks must
  warm up, capture, replay and drop their programs in the same order: each
  rank makes the same calls with the same keys in the same order
  (``cached_step``), or the collectives of one rank's warm-up or replay
  pair with another program's on another rank and hang. A group is left
  only after its programs are dropped (``drop_graphed_steps``, which
  ``parallel.mesh.leave`` calls). gloo's collectives run on the host, and
  no graph can hold them.
- ``disable_graphs()`` runs the entry points eagerly on the card too, as
  ``jax.disable_jit()`` does for the reference: to time the eager
  launches beside the graphs, and to compare the two.
- A replay is timed from inside, unprofiled (``utils.profiling``'s
  tracer, on by default): the capture collects the timing events that
  ``profiling.region`` records as nodes of the graph (``capture_marks``),
  and each program's ``Clock`` times every replay under the program's
  ``label`` (``stage2_step``, ``stage1_step``, a pipeline function's
  name): the host's period since its previous replay, the host's time in
  ``replay()`` (the ``graph.launch`` span), the device's time between two
  eager events around it and each region's. The events are read at the
  next replay or by ``tracer.snapshot()``, only once they have completed:
  the tracer never synchronises, and allocates nothing on the device per
  replay. ``profiling.set_tracing(False)`` turns it off.
"""

from __future__ import annotations

import contextlib

import torch

from music_synthesis_tpu_torch._device import capturing
from music_synthesis_tpu_torch.utils.profiling import (
    COUNTERS,
    capture_marks,
    span,
    tracer,
)

__all__ = ["GraphedProgram", "Programs", "disable_graphs", "enabled",
           "flags", "pool_bytes", "cached_step", "drop_graphed_steps"]

_disabled = 0  # open disable_graphs() blocks
WARMUP = 2  # eager calls before a capture


@contextlib.contextmanager
def disable_graphs():
    """Within the block, ``enabled`` is False for every device, in every
    thread of the process (a service's worker thread included)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def enabled(device: torch.device | str) -> bool:
    """Whether a call on ``device`` replays a graph: on a CUDA device,
    outside ``disable_graphs()``, anomaly detection (whose checks read the
    device), another graph's capture (the outer graph captures the call)
    and ``torch.compile`` / ``torch.export`` tracing."""
    return (torch.device(device).type == "cuda" and _disabled == 0
            and not torch.is_anomaly_enabled()
            and not torch.compiler.is_compiling()
            and not capturing())


def flags() -> tuple:
    """The process's switches that choose the kernels a graph captures."""
    matmul = torch.backends.cuda.matmul
    return (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark, matmul.allow_tf32,
            matmul.allow_fp16_reduced_precision_reduction,
            matmul.allow_bf16_reduced_precision_reduction,
            torch.get_float32_matmul_precision())


class GraphedProgram:
    """``fn(*inputs)`` as one CUDA graph for one set of input shapes.

    ``fn`` takes tensors and returns a tensor or a tuple or dict of
    tensors, all on ``device``, and makes no host synchronisation. The
    first call builds the program: static input buffers on ``device``, the
    eager warm-up (``WARMUP`` calls on a side stream), the capture (into
    ``pool``, a ``torch.cuda.graph_pool_handle()`` shared with other
    programs, else a pool of its own), with the marks of its regions
    (``profiling.capture_marks``). Every call copies its inputs (on any
    device, of the first call's shapes) into the buffers (``load``),
    replays, and returns the static outputs (``replay``), timed by the
    tracer under ``label`` (``fn``'s name by default).

    ``mutates``: tensors ``fn`` updates in place (a training step's state).
    The warm-up's updates to them are undone before the first replay, so
    each call updates them once.
    """

    def __init__(self, fn, device: torch.device | str, pool=None,
                 mutates=(), label: str | None = None):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.fn, self.device, self.pool = fn, device, pool
        self.mutates = list(mutates)
        self.label = label or getattr(fn, "__name__", "program")
        self.graph: torch.cuda.CUDAGraph | None = None
        self.clock = None
        self.counts_per_replay: dict[str, int] = {}
        self._inputs: list[torch.Tensor] = []
        self._outputs = None

    def _build(self, args) -> None:
        with torch.inference_mode(False):
            self._inputs = [torch.empty(a.shape, dtype=a.dtype,
                                        device=self.device) for a in args]
        for buf, a in zip(self._inputs, args):
            buf.copy_(a)
        saved = [t.clone() for t in self.mutates]
        counts = {n: c.n_calls for n, c in COUNTERS.items()}
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.fn(*self._inputs)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        marked = {n: c.n_calls for n, c in COUNTERS.items()}
        # thread_local: other threads (NCCL's watchdog) may call CUDA.
        with capture_marks() as marks, torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode="thread_local"):
            self._outputs = self.fn(*self._inputs)
        self.counts_per_replay = {n: c.n_calls - marked.get(n, 0)
                                  for n, c in COUNTERS.items()}
        self.clock = tracer.clock(self.label, marks,
                                  counts=self.counts_per_replay)
        # building is not a call
        for n, c in COUNTERS.items():
            c.n_calls = counts.get(n, 0)
        if self.mutates:
            torch._foreach_copy_(self.mutates, saved)
        self.pool = graph.pool()
        self.graph = graph
        self.fn = None  # the graph holds what the capture read

    def load(self, *args) -> None:
        """Copies a call's inputs into the static buffers (building the
        program at the first call)."""
        with torch.cuda.device(self.device):
            if self.graph is None:
                self._build(args)
            elif len(args) != len(self._inputs) or any(
                    a.shape != b.shape for a, b in zip(args, self._inputs)):
                raise ValueError(
                    f"inputs {[tuple(a.shape) for a in args]} differ from "
                    f"the captured {[tuple(b.shape) for b in self._inputs]}")
            for buf, a in zip(self._inputs, args):
                buf.copy_(a)

    def replay(self):
        """Replays the graph on the loaded inputs; returns the outputs."""
        with torch.cuda.device(self.device):
            rec = tracer.begin(self.clock)
            with span("graph.launch") as launch:
                self.graph.replay()
            tracer.end(self.clock, rec, launch.ms)
        for n, k in self.counts_per_replay.items():
            COUNTERS[n].n_calls += k
        return self._outputs

    def __call__(self, *args):
        self.load(*args)
        return self.replay()


def _shapes(args) -> tuple:
    return tuple((tuple(a.shape), a.dtype) for a in args)


class Programs:
    """One ``GraphedProgram`` per (key, input shapes and dtypes,
    ``flags()``) on one device, all in one memory pool, built at first use.

    ``programs(key, fn, *inputs)`` returns ``fn(*inputs)``: eagerly when
    ``enabled(device)`` is False (on the CPU), else by replaying the
    program of that key, built from ``fn`` at the first such call. So
    ``key`` must name everything ``fn`` reads besides its inputs (the
    modules, the static arguments). The programs replay one at a time:
    every output is used or copied before the next call. With ``fresh``,
    a replay's outputs are copied out of the graph's buffers, so the
    caller may keep them (an eager call's outputs are its own already).
    ``label``: the tracer's name for a new program (``fn``'s name by
    default); a call copies its inputs under the ``pipeline.inputs`` span.
    """

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.pool = None
        self.programs: dict[tuple, GraphedProgram] = {}

    def __call__(self, key, fn, *inputs, fresh: bool = False,
                 label: str | None = None):
        if not enabled(self.device) or any(
                type(a) is not torch.Tensor for a in inputs):
            return fn(*inputs)  # the CPU, or a fake or traced input
        full = (key, _shapes(inputs), flags())
        program = self.programs.get(full)
        if program is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            program = GraphedProgram(fn, self.device, self.pool, label=label)
            self.programs[full] = program
        with span("pipeline.inputs"):
            program.load(*inputs)
        out = program.replay()
        if not fresh:
            return out
        if isinstance(out, torch.Tensor):
            return out.clone()
        if isinstance(out, dict):
            return {k: v.clone() for k, v in out.items()}
        return type(out)(v.clone() for v in out)

    def pool_bytes(self) -> int | None:
        """Device bytes the shared pool holds (``pool_bytes``)."""
        return None if self.pool is None else pool_bytes(self.pool,
                                                         self.device)


def pool_bytes(pool, device: torch.device | str) -> int:
    """Bytes of the segments the caching allocator holds for ``pool`` (a
    ``graph_pool_handle()`` or ``CUDAGraph.pool()``) on ``device``."""
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == index
               and tuple(seg.get("segment_pool_id", ())) == tuple(pool))


#: Every cache of steps that ``cached_step`` has filled in this process.
_CACHES: list[dict] = []


def cached_step(steps: dict, key, make, limit: int = 4):
    """``steps[key]``, made by ``make()`` if missing; the oldest entries
    beyond ``limit`` are dropped (with their graphs and pools). Ranks of
    a group call it in the same order (the module's docstring)."""
    if not any(c is steps for c in _CACHES):
        _CACHES.append(steps)
    step = steps.pop(key, None) or make()
    steps[key] = step
    while len(steps) > limit:
        del steps[next(iter(steps))]
    return step


def drop_graphed_steps() -> None:
    """Drops every step that ``cached_step`` holds in this process, with
    its graph and pool (``parallel.mesh.leave`` calls it before the group
    is destroyed), after the card has run every replay it was given."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for steps in _CACHES:
        steps.clear()
