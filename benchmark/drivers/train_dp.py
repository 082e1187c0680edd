"""Window driver ``train_dp``: the stage-2 GAN step data-parallel over
``ranks`` cards, one process per rank, as ``train_stage2 --mesh N --dp
shard_map`` trains.

Rank 0 runs in the harness's own process (so the tracer's readers see
its replays); it starts ranks 1 .. N-1 as processes of this file
(``python3 benchmark/drivers/train_dp.py --rank r ...``), each on card
``r``, and all join one NCCL group on a free localhost port (gloo on the
CPU, where the steps run eagerly). Every rank draws the same training
state from the seed (``drivers/train.py``'s draw, then broadcast from
rank 0) and the same pool of global batches (``harness.inputs.tone_pool``,
``pool_batches`` x [N x batch, segment]), keeps its own rows, and calls
``parallel.shard_map_dp.make_shardmap_stage2_step``: on a card each rank
replays the step's CUDA graph, NCCL's all-reduces captured in it.

- ``check_steps`` steps first (the first captures the graph); rank 0
  keeps its losses (the ranks' means), its first gradients (Adam's first
  moments, the all-reduced gradient) and its state after the last.
- The window's step count is fixed before the window opens: rank 0 times
  its second and third steps and broadcasts ``ceil(seconds / step)``, one
  collective outside the timed steps. ``train_step_ms`` is rank 0's wall
  time over that many steps, each reading its metrics.
- With ``--trace 1`` every rank takes ``1 + trace_steps`` steps more, rank
  0's under the profiler (``trace_device``).
- Then the ranks leave the group and ranks 1 .. N-1 exit; rank 0 reads
  its peak memory, frees the program and runs the plain reference
  (``reference.train_step``) on the concatenated global batches: the
  shard_map step on N equal shards with sigma 0 (the state is past the
  noise's decay) is the single-process step on the global batch (its
  means, the global spectral convergence). Compared as ``drivers/
  train.py`` compares.

Failure never hangs: a rank whose phase raises prints the error and
exits at once (exit 1); a watchdog thread of rank 0 ends its process
(exit 1) when another rank exits with an error or when the ranks' phase
outlasts ``deadline_s``; each other rank ends itself when rank 0's
process is gone or the same deadline passes. ``--control 1`` runs the reference in fp8 in
the program's place, on rank 0 alone.
"""

from __future__ import annotations

if __name__ == "__main__":  # a rank this driver started: run.py's set-up
    import os
    import sys
    from pathlib import Path

    _BENCH = Path(__file__).resolve().parents[1]
    for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                       ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                       ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[_var] = str(_BENCH.parent / "build" / _sub)
    sys.path[:0] = [str(_BENCH), str(_BENCH.parent)]

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness.config import BENCH, ROOT, Cell, load_module  # noqa: E402
from harness.core import Ctx, log, trace_device  # noqa: E402
from harness.inputs import tone_pool  # noqa: E402
from reference.arith import conv_precision  # noqa: E402

train = load_module(BENCH / "drivers" / "train.py", "bench_driver_train_dp_base")

WATCH_S = 0.5  # how often a watchdog looks


def _watch(deadline: float, failed, done: threading.Event) -> None:
    """Ends this process (exit 1) when ``failed()`` names a fault or the
    deadline passes before ``done`` is set."""
    def loop():
        while not done.wait(WATCH_S):
            why = failed() or (time.monotonic() > deadline
                               and "the ranks' phase outlasted its deadline")
            if why:
                print(f"benchmark: train_dp: {why}", file=sys.stderr,
                      flush=True)
                os._exit(1)

    threading.Thread(target=loop, daemon=True).start()


def _exit_on_error(fn, *args):
    """``fn(*args)``; on an error, its traceback and an immediate exit 1:
    a process that unwinds with NCCL's collectives pending can wait on
    them in its shutdown."""
    try:
        return fn(*args)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _pool(ctx: Ctx, cfg, world: int) -> np.ndarray:
    """The global batches ``[pool_batches, world x batch, segment]``, the
    same on every rank."""
    tr, t = ctx.traffic, cfg.train
    return tone_pool(np.random.default_rng(ctx.seed),
                     tr.pool_batches * t.batch_size * world,
                     t.segment_length, cfg.frontend.sample_rate,
                     ctx.cell.traffic["tones"]).reshape(
        tr.pool_batches, t.batch_size * world, t.segment_length)


def _ranks_phase(ctx: Ctx, rank: int, world: int, port: int) -> dict:
    """Set-up, the check steps, the window and the traced steps on this
    rank; returns rank 0's readings (nothing for the others)."""
    from music_synthesis_tpu_torch.config import config_from_dict
    from music_synthesis_tpu_torch.parallel import mesh
    from music_synthesis_tpu_torch.parallel.shard_map_dp import (
        make_shardmap_stage2_step,
    )
    from music_synthesis_tpu_torch.train import stage2

    tr, raw = ctx.traffic, ctx.cell.config["train"]
    cfg = config_from_dict(raw)
    t = cfg.train
    b, seg = t.batch_size, t.segment_length
    start = ctx.cell.config["state_step"]
    dev = ctx.device
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    group = mesh.init_process_group(rank, world, port,
                                    mesh.backend_for(dev), dev)
    with torch.device("meta"):
        g_meta, d_meta = stage2.make_models(cfg)
    shapes_g = {k: tuple(v.shape) for k, v in g_meta.named_parameters()}
    shapes_d = {k: tuple(v.shape) for k, v in d_meta.named_parameters()}
    pool = _pool(ctx, cfg, world)
    local = torch.from_numpy(np.ascontiguousarray(
        pool[:, rank * b:(rank + 1) * b]))
    if dev.type == "cuda":
        local = local.pin_memory()
    state, d_count = train._program_state(ctx, cfg, shapes_g, shapes_d,
                                          start)
    mesh.replicate_state(state, group)
    out = {"pool": pool, "d_count": d_count, "shapes": (shapes_g, shapes_d)}
    if rank == 0:
        out["p0"] = {"g": {k: v.clone() for k, v in state.g_params.items()},
                     "d": {k: v.clone() for k, v in state.d_params.items()}}
        log(f"[{ctx.cell.name}] {world} ranks, state and pool at "
            f"{time.perf_counter() - ctx.t0:.2f} s")
    step = make_shardmap_stage2_step(cfg, group)

    def batch(i):
        return local[i % tr.pool_batches].to(dev, non_blocking=True)

    losses, grads, took = [], None, []
    for i in range(tr.check_steps):
        t0 = time.perf_counter()
        state, m = step(state, batch(i))
        took.append(time.perf_counter() - t0)
        losses.append({k: m[k] for k in train._LOSSES})
        if i == 0:
            grads = {p: train._norms({k: v / (1.0 - t.adam_b1)
                                      for k, v in opt.mu.items()})
                     for p, opt in (("g", state.g_opt), ("d", state.d_opt))}
    out.update(losses=losses, grads=grads, p3={
        "g": {k: v.clone() for k, v in state.g_params.items()},
        "d": {k: v.clone() for k, v in state.d_params.items()},
        "ema": {k: v.clone() for k, v in (state.g_ema or {}).items()}})

    # The window's step count, fixed outside the timed steps.
    probe = took[1:] or took
    n = torch.tensor([max(1, math.ceil(ctx.seconds * len(probe)
                                       / sum(probe)))], device=dev)
    torch.distributed.broadcast(n, 0, group=group)
    n = int(n.item())
    if rank == 0:
        ctx.open_window()
    for i in range(tr.check_steps, tr.check_steps + n):
        state, m = step(state, batch(i))
    if rank == 0:
        wall = time.perf_counter() - ctx.window_start
        ctx.attempted = n
        ctx.failed = sum(not np.isfinite(v) for v in m.values())
        ctx.e2e["train_step_ms"] = 1e3 * wall / n
        out["step_s"] = wall / n
        log(f"[{ctx.cell.name}] {n} steps in {wall:.3f} s: "
            f"{1e3 * wall / n:.3f} ms/step")
        ctx.read_memory_peak()

    if ctx.trace:
        j = [tr.check_steps + n]

        def steps_(k):
            nonlocal state
            for _ in range(k):
                state, _ = step(state, batch(j[0]))
                j[0] += 1

        if rank == 0 and dev.type == "cuda":
            out["trace"] = trace_device(ctx, lambda: steps_(1),
                                        lambda: steps_(tr.trace_steps))
        else:
            steps_(1 + tr.trace_steps)
    del state, m, step
    mesh.leave()
    return out


def _children(ctx: Ctx, world: int, port: int, cell_file: Path) -> list:
    """Ranks 1 .. world-1, each a process of this file; the cell's
    contents reach them in ``cell_file``."""
    cell_file.write_text(json.dumps(dataclasses.asdict(ctx.cell)))
    me = Path(__file__).resolve()
    dev = "cpu" if ctx.device.type == "cpu" else "cuda"
    return [subprocess.Popen(
        [sys.executable, str(me), "--rank", str(r), "--world", str(world),
         "--port", str(port), "--cell", str(cell_file),
         "--seed", str(ctx.seed), "--seconds", str(ctx.seconds),
         "--trace", str(int(ctx.trace)), "--device", dev,
         "--parent", str(os.getpid())],
        cwd=ROOT, stdout=subprocess.DEVNULL) for r in range(1, world)]


def run(ctx: Ctx) -> None:
    from music_synthesis_tpu_torch.config import config_from_dict
    from music_synthesis_tpu_torch.parallel.mesh import free_port

    tr = ctx.traffic
    world = tr.ranks
    cfg = config_from_dict(ctx.cell.config["train"])
    rcfg = ctx.cfg.train
    start = ctx.cell.config["state_step"]
    if ctx.control:
        from music_synthesis_tpu_torch.train import stage2

        with torch.device("meta"):
            g_meta, d_meta = stage2.make_models(cfg)
        shapes_g = {k: tuple(v.shape) for k, v in g_meta.named_parameters()}
        shapes_d = {k: tuple(v.shape) for k, v in d_meta.named_parameters()}
        state, d_count = train._program_state(ctx, cfg, shapes_g, shapes_d,
                                              start)
        p0 = {"g": dict(state.g_params), "d": dict(state.d_params)}
        pool = _pool(ctx, cfg, world)
        ctx.open_window()
        checked = [torch.from_numpy(pool[i % tr.pool_batches])
                   for i in range(tr.check_steps)]
        losses, grads, cs = train._reference(ctx, rcfg, p0, checked, start,
                                             d_count, "fp8")
        p3 = {"g": cs.g, "d": cs.d, "ema": cs.ema}
        ctx.attempted = tr.check_steps
    else:
        port = free_port()
        tmp = tempfile.TemporaryDirectory(prefix="train_dp_")
        procs = _children(ctx, world, port, Path(tmp.name) / "cell.json")
        done = threading.Event()

        def failed():
            bad = [(r + 1, p.returncode) for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            return bad and f"rank(s) {bad} exited with an error"

        _watch(time.monotonic() + tr.deadline_s, failed, done)
        try:
            out = _exit_on_error(_ranks_phase, ctx, 0, world, port)
            for p in procs:
                p.wait(timeout=max(1.0, tr.deadline_s / 4))
        finally:
            done.set()
            for p in procs:
                if p.poll() is None:
                    p.kill()
            tmp.cleanup()
        if any(p.returncode for p in procs):
            raise RuntimeError("a rank exited with an error: "
                               f"{[p.returncode for p in procs]}")
        losses, grads, p0, p3 = (out[k] for k in ("losses", "grads", "p0",
                                                  "p3"))
        d_count, pool = out["d_count"], out["pool"]
        if "trace" in out:
            tr_ = out["trace"]
            shapes_g, shapes_d = out["shapes"]
            ctx.records.update(
                step_s=out["step_s"], trace_union_s=tr_.union_s(),
                trace_wall_s=tr_.wall_s,
                peak_flops=ctx.peaks.get(conv_precision(
                    {cfg.vocoder.compute_dtype, cfg.msd.compute_dtype,
                     cfg.mrd.compute_dtype},
                    torch.backends.cudnn.allow_tf32)),
                step_flops=train._step_flops(
                    rcfg, shapes_g, shapes_d, cfg.train.batch_size,
                    cfg.train.segment_length, start, d_count))
        checked = [torch.from_numpy(pool[i % tr.pool_batches])
                   for i in range(tr.check_steps)]
        del out
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
    ref_losses, ref_grads, rs = train._reference(ctx, rcfg, p0, checked,
                                                 start, d_count, None)
    train._compare(ctx, losses, grads, p0, p3, ref_losses, ref_grads, rs)


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="train_dp rank")
    for name in ("rank", "world", "port", "seed", "trace", "parent"):
        ap.add_argument(f"--{name}", type=int, required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    args = ap.parse_args(argv)
    cell = Cell(**json.loads(Path(args.cell).read_text()))
    dev = (torch.device("cuda", args.rank) if args.device == "cuda"
           else torch.device("cpu"))
    ctx = Ctx(cell, dev, args.seed, args.seconds, bool(args.trace),
              time.perf_counter())
    done = threading.Event()

    def parent_gone():
        return os.getppid() != args.parent and "rank 0's process is gone"

    _watch(time.monotonic() + ctx.traffic.deadline_s, parent_gone, done)
    _exit_on_error(_ranks_phase, ctx, args.rank, args.world, args.port)
    done.set()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
