"""Window driver ``train``: the stage-2 GAN step as the CLI drives it.

Set-up builds one training state from the seed (weights drawn on the
device, G's with the gains its configuration's init states, Adam's
moments zero, the step counter at the configuration's ``state_step``)
and a pool of host batches (``harness.inputs.tone_pool``, pinned). It
then drives that state through the window's own call,
``stage2.train_step`` on the next pool batch copied to the card, for
``check_steps`` steps (the first captures the step's CUDA graph), keeping
the initial parameters, the first moments after step 1 and the state
after the last. The window runs the same call back to back; each call
reads its metrics, as ``scripts/train_stage2.py`` does with K = 1.
``train_step_ms`` is the window's wall time over the steps in it.

Once the window has closed and the peak memory is read, the program's
state is freed and the plain reference (``reference.train_step``) follows
the first ``check_steps`` steps from the same initial tensors on the same
batches. Compared (each against its limit in ``limits/<cell>.json``):

- ``loss_gap`` (``d_loss_gap``, ``g_loss_gap``): the relative gap of
  the first step's losses, the larger of the two; ``g_adv_gap``,
  ``g_fm_gap``, ``g_stft_gap``: that of each term of G's loss (the
  adversarial and feature-matching terms are bf16 means on both sides, so
  their gaps, and G's total with them, read 0 or whole bf16 steps; the
  STFT term is fp32);
- ``grad_gap`` (``.g``, ``.d``): the worst leaf's gap between the norms
  of the first gradient, the program's read from Adam's first moment
  after step 1 (``mu / (1 - b1)``, the moments starting at zero);
  ``grad_gap_median``: the median leaf's; ``grad_norm_gap``: the relative
  gap between the norms of the whole player's first gradient;
- ``change_gap`` (``.g``, ``.d``, ``.ema``): the worst leaf's gap between
  the norms of the change of G, D and the EMA over the steps, leaving out
  leaves whose reference gradient is under a thousandth of the median
  leaf's (they move by round-off alone under Adam);
  ``change_gap_median``: the median leaf's.

Every reading is logged; those named in ``limits/<cell>.json`` are
compared.

``--control`` puts the reference computed in fp8 (``lower="fp8"``) in the
program's place, with no window.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import time

import numpy as np
import torch

from harness.core import Ctx, leaf_gap, log, trace_device
from harness.inputs import seeded_params, tone_pool
from harness import flops
from reference import train_step as ref
from reference.arith import conv_precision, logmel_least_s
from reference.model import strict_fp32


_LOSSES = ("d_loss", "g_loss", "g_adv", "g_fm", "g_stft")


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in d.items()}


def _program_state(ctx: Ctx, cfg, shapes_g, shapes_d, start: int):
    from music_synthesis_tpu_torch.train.state import (
        AdamState,
        GANState,
    )

    v = cfg.vocoder
    if v.init_scheme != "he":
        raise NotImplementedError("G's weights are drawn as 'he' only")
    gains = {k: v.res_init_gain if k.endswith(".pointwise.v")
             else v.out_init_gain for k in shapes_g
             if k.endswith(".pointwise.v") or k == "conv_out.v"}
    gen = ctx.generator(1)
    g = seeded_params(shapes_g, gen, ctx.device, gains)
    d = seeded_params(shapes_d, gen, ctx.device)
    t = cfg.train
    d_count = max(0, start - max(t.g_warmup_steps, 0))

    def zeros(p):
        return {k: torch.zeros_like(v) for k, v in p.items()}

    return GANState(
        step=start, g_params=g, d_params=d,
        g_opt=AdamState(start, zeros(g), zeros(g)),
        d_opt=AdamState(d_count, zeros(d), zeros(d)),
        rng=ctx.generator(2),
        g_ema={k: v.clone() for k, v in g.items()} if t.ema_decay > 0
        else None), d_count


def _reference(ctx: Ctx, rcfg, p0, batches, start: int, d_count: int,
               lower: str | None):
    """The reference's ``check_steps`` steps from ``p0``: (losses per step,
    first gradients, state after the last step)."""
    gen, disc = ref.models(rcfg, lower)
    s = ref.RefState(p0["g"], p0["d"], start, start, d_count)
    losses, grads = [], None
    with strict_fp32():
        for i, wav in enumerate(batches):
            out = ref.step(rcfg, s, wav.to(ctx.device), gen, disc,
                           keep_grads=i == 0)
            losses.append({k: float(out[k]) for k in _LOSSES})
            if i == 0:
                grads = {"g": _norms(out["g_grads"]),
                         "d": _norms(out["d_grads"])}
            del out
    return losses, grads, s


def _gaps(prog: dict, ref: dict, keep=None) -> tuple[float, float, str]:
    """The worst leaf's gap (``leaf_gap``), the median leaf's, and the
    worst leaf."""
    gap, leaf = leaf_gap(prog, ref, keep)
    med = statistics.median(ref.values())
    per = [abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref
           if keep is None or k in keep]
    return gap, statistics.median(per), leaf


def _compare(ctx: Ctx, losses, grads, p0, p3, ref_losses, ref_grads, rs):
    """Every reading, logged; those named in the cell's limits are
    checked."""
    for i, (a, b) in enumerate(zip(losses, ref_losses)):
        log(f"[{ctx.cell.name}] step {i + 1} losses "
            + ", ".join(f"{k} {a[k]:.6g} vs {b[k]:.6g}" for k in a))
    first, ref_first = losses[0], ref_losses[0]
    rel = {k: abs(first[k] - ref_first[k]) / max(abs(ref_first[k]), 1e-12)
           for k in first}
    r = {f"{k}_gap": v for k, v in rel.items()}
    r["loss_gap"] = max(rel["d_loss"], rel["g_loss"])
    for p in ("g", "d"):
        r[f"grad_gap.{p}"], r[f"grad_gap_median.{p}"], leaf = _gaps(
            grads[p], ref_grads[p])
        log(f"[{ctx.cell.name}] grad {p}: worst at {leaf}")
        total = math.sqrt(sum(x * x for x in ref_grads[p].values()))
        r[f"grad_norm_gap.{p}"] = abs(math.sqrt(sum(
            x * x for x in grads[p].values())) - total) / total
    ref_p3 = {"g": rs.g, "d": rs.d, "ema": rs.ema}
    for part in ("g", "d", "ema"):
        gref = ref_grads["d" if part == "d" else "g"]
        med = statistics.median(gref.values())
        keep = {k for k, v in gref.items() if v >= 1e-3 * med}
        start = p0["d" if part == "d" else "g"]
        prog = _norms({k: p3[part][k] - start[k] for k in start})
        refc = _norms({k: ref_p3[part][k] - start[k] for k in start})
        r[f"change_gap.{part}"], r[f"change_gap_median.{part}"], leaf = \
            _gaps(prog, refc, keep)
        log(f"[{ctx.cell.name}] change {part}: worst at {leaf}, "
            f"{len(start) - len(keep)} leaves left out")
    for name in ("grad_gap", "grad_gap_median", "grad_norm_gap",
                 "change_gap", "change_gap_median"):
        r[name] = max(v for k, v in r.items() if k.startswith(name + "."))
    log(f"[{ctx.cell.name}] readings " + json.dumps(r))
    ctx.records["readings"] = r
    for name in ctx.cell.limits:
        ctx.check(name, r[name])


def run(ctx: Ctx) -> None:
    from music_synthesis_tpu_torch.config import config_from_dict
    from music_synthesis_tpu_torch.train import stage2
    from music_synthesis_tpu_torch.train.state import drop_graphed_steps

    raw = ctx.cell.config["train"]
    cfg = config_from_dict(raw)
    rcfg = ctx.cfg.train
    tr = ctx.traffic
    t = cfg.train
    b, seg = t.batch_size, t.segment_length
    start = ctx.cell.config["state_step"]
    with torch.device("meta"):
        g_meta, d_meta = stage2.make_models(cfg)
    shapes_g = {k: tuple(v.shape) for k, v in g_meta.named_parameters()}
    shapes_d = {k: tuple(v.shape) for k, v in d_meta.named_parameters()}
    rg, rd = ref.models(rcfg)
    if ({k: tuple(v.shape) for k, v in rg.named_parameters()} != shapes_g
            or {k: tuple(v.shape) for k, v in rd.named_parameters()}
            != shapes_d):
        raise RuntimeError("the reference's parameters are not the program's")

    pool = torch.from_numpy(tone_pool(
        np.random.default_rng(ctx.seed), tr.pool_batches * b, seg,
        cfg.frontend.sample_rate, ctx.cell.traffic["tones"])).view(
        tr.pool_batches, b, seg)
    if ctx.device.type == "cuda":
        pool = pool.pin_memory()
    checked = [pool[i] for i in range(tr.check_steps)]
    log(f"[{ctx.cell.name}] batch pool at "
        f"{time.perf_counter() - ctx.t0:.2f} s")
    state, d_count = _program_state(ctx, cfg, shapes_g, shapes_d, start)
    p0 = {"g": {k: v.clone() for k, v in state.g_params.items()},
          "d": {k: v.clone() for k, v in state.d_params.items()}}

    if ctx.control:
        ctx.open_window()
        del state
        losses, grads, cs = _reference(ctx, rcfg, p0, checked, start,
                                       d_count, "fp8")
        p3 = {"g": cs.g, "d": cs.d, "ema": cs.ema}
    else:
        step_fn = stage2.train_step
        losses, grads = [], None
        for i in range(tr.check_steps):
            state, m = step_fn(cfg, state, pool[i].to(ctx.device,
                                                      non_blocking=True))
            losses.append({k: m[k] for k in _LOSSES})
            log(f"[{ctx.cell.name}] step {i + 1} done at "
                f"{time.perf_counter() - ctx.t0:.2f} s")
            if i == 0:
                grads = {p: _norms({k: v / (1.0 - t.adam_b1) for k, v in
                                    opt.mu.items()})
                         for p, opt in (("g", state.g_opt),
                                        ("d", state.d_opt))}
        p3 = {"g": {k: v.clone() for k, v in state.g_params.items()},
              "d": {k: v.clone() for k, v in state.d_params.items()},
              "ema": {k: v.clone() for k, v in (state.g_ema or {}).items()}}

        deadline = ctx.open_window()
        steps, i = 0, tr.check_steps
        while True:
            wav = pool[i % tr.pool_batches].to(ctx.device, non_blocking=True)
            state, m = step_fn(cfg, state, wav)
            steps, i = steps + 1, i + 1
            if time.perf_counter() >= deadline:
                break
        wall = time.perf_counter() - ctx.window_start
        ctx.attempted = steps
        ctx.failed = sum(not np.isfinite(v) for v in m.values())
        step_s = wall / steps
        ctx.e2e["train_step_ms"] = 1e3 * step_s
        log(f"[{ctx.cell.name}] {steps} steps in {wall:.3f} s: "
            f"{1e3 * step_s:.3f} ms/step")
        ctx.read_memory_peak()

        if ctx.trace and ctx.device.type == "cuda":
            j = [i]

            def steps_(n):
                nonlocal state
                for _ in range(n):
                    w = pool[j[0] % tr.pool_batches].to(ctx.device,
                                                        non_blocking=True)
                    state, _ = step_fn(cfg, state, w)
                    j[0] += 1

            n = tr.trace_steps
            trace = trace_device(ctx, lambda: steps_(1), lambda: steps_(n))
            launches = trace.durations("logmel")
            peaks = ctx.peaks
            ctx.records.update(
                step_s=step_s, trace_union_s=trace.union_s(),
                trace_wall_s=trace.wall_s,
                peak_flops=peaks.get(conv_precision(
                    {cfg.vocoder.compute_dtype, cfg.msd.compute_dtype,
                     cfg.mrd.compute_dtype},
                    torch.backends.cudnn.allow_tf32)),
                step_flops=_step_flops(rcfg, shapes_g, shapes_d, b, seg,
                                       start, d_count),
                logmel_launch_s=(statistics.median(launches) if launches
                                 else None),
                logmel_least_s=(logmel_least_s(
                    b, seg, cfg.frontend.hop_length, cfg.frontend.n_fft,
                    cfg.frontend.n_mels, peaks)
                    if peaks and t.use_pallas_frontend else None))
        del state, m
        drop_graphed_steps()
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    ref_losses, ref_grads, rs = _reference(ctx, rcfg, p0, checked, start,
                                           d_count, None)
    _compare(ctx, losses, grads, p0, p3, ref_losses, ref_grads, rs)
    if ctx.control:
        ctx.attempted = tr.check_steps


def _step_flops(rcfg, shapes_g, shapes_d, b, seg, start, d_count) -> int:
    """Logical FLOPs of one step (``harness.flops``)."""
    def body():
        with torch.device("meta"):
            g = {k: torch.empty(s) for k, s in shapes_g.items()}
            d = {k: torch.empty(s) for k, s in shapes_d.items()}
            wav = torch.empty(b, seg)
        gen, disc = ref.models(rcfg)
        ref.step(rcfg, ref.RefState(g, d, start, start, d_count), wav, gen,
                 disc)

    return flops.count(body)

