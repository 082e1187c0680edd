"""Window driver ``train_codec``: the stage-2 GAN step of DAC's codec
(``vocoder.block`` ``codec``), as the CLI drives it.

Set-up builds one training state from the seed: weights drawn on the
device at upstream's scale (every conv's direction normal with PyTorch's
default conv std, ``1 / sqrt(3 fan_in)``, which is He's times
``INIT_GAIN``; weight-norm gains the norms of their directions, per input
channel for the transposed convs; biases zero; codebooks N(0, 1); every
Snake ``alpha`` ``exp(N(0, SNAKE_STD^2))``),
Adam's moments zero, the step and both Adam counts at the configuration's
``state_step``; and a pool of host batches (``harness.inputs.tone_pool``
at the configuration's sample rate, pinned). The first ``check_steps``
steps run ``stage2.train_step`` on the first pool batches with quantizer
counts drawn here from the seed (``keep``: the first half of the rows a
uniform 1 .. n_codebooks, the rest every stage, as the program draws
them), keeping the initial parameters, the first moments after step 1 and
the state after the last. The window then runs the same call back to
back, each step drawing its own quantizer dropout and reading its
metrics, as ``scripts/train_stage2.py`` does; ``train_step_ms`` is the
window's wall time over its steps.

Once the window has closed and the peak memory is read, the program's
state is freed and the plain reference (``reference/dac.py``) follows the
check steps from the same tensors, batches and quantizer counts, in fp32
without TF32 and the configuration's bf16 casts. Compared (each named in
``limits/<cell>.json`` against its limit; every one is logged):

- ``<loss>_gap``: the relative gap of step 1's ``d_loss``, ``g_loss``,
  ``g_adv``, ``g_fm``, ``g_mel`` (fp32), ``g_commitment`` (``vq_gap``) and
  ``g_codebook``;
- ``grad_gap`` (``.g``, ``.d``) and ``grad_gap_median``: the worst and
  the median leaf's gap between the norms of the first gradient after
  the clip, the program's read from Adam's first moment after step 1
  (``mu / (1 - b1)``), the reference's its gradient times its clip
  coefficient; ``grad_norm_gap``: the whole player's;
- ``change_gap`` (``.g``, ``.d``), ``change_gap_median`` and
  ``change_gap_mean``: the worst, the median and the mean leaf's gap
  between the norms of the change over the check steps, leaving out
  leaves whose reference gradient is under a thousandth of the median
  leaf's; ``alpha_change_gap``: the median over
  the Snake ``alpha`` leaves alone (1 where they did not move);
  ``codebook_grad_gap``: the median over the codebooks of the first
  gradient's gap (a codebook's gradient is its codebook loss's alone
  while the straight-through estimator holds).

With ``--trace 1`` it also records ``step_flops`` (``harness.flops`` on
the reference's step) and ``snake_least_s``, the least time of the step's
Snake calls (``snake_bytes`` at the HBM rate), which
``metrics/snake_roofline.py`` reads against the tracer's ``snake.fwd``
and ``snake.bwd`` regions.

``--control`` puts the reference with fp8 convolutions (``lower="fp8"``)
in the program's place, with no window.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import time

import numpy as np
import torch

from harness import flops
from harness.config import BENCH, load_module
from harness.core import Ctx, log, trace_device
from harness.inputs import seeded_params, tone_pool
from reference import dac as ref
from reference.arith import HBM_BYTES_PER_S, conv_precision
from reference.model import strict_fp32

train = load_module(BENCH / "drivers" / "train.py", "bench_driver_train_base")

INIT_GAIN = 1 / math.sqrt(6)  # PyTorch's default conv std over He's
SNAKE_STD = 0.3
RES_UNITS = 3  # DAC's residual units a block (dilations 1, 3, 9)
_LOSSES = ("d_loss", "g_loss", "g_adv", "g_fm", "g_mel", "g_commitment",
           "g_codebook")
_DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def _program_state(ctx: Ctx, shapes_g, shapes_d, start: int):
    from music_synthesis_tpu_torch.train.state import AdamState, GANState

    gen = ctx.generator(1)
    g = seeded_params(shapes_g, gen, ctx.device,
                      {k: INIT_GAIN for k in shapes_g if k.endswith(".v")})
    d = seeded_params(shapes_d, gen, ctx.device,
                      {k: INIT_GAIN for k in shapes_d if k.endswith(".v")})
    for k in shapes_g:
        if k.endswith(".up.g"):  # one gain per input channel
            v = g[k[:-2] + ".v"]
            g[k] = torch.sqrt(torch.sum(v * v, dim=(0, 2)) + 1e-12)
    extra = ctx.generator(3)
    for k in shapes_g:
        if k.endswith(".alpha"):
            g[k] = torch.exp(SNAKE_STD * torch.randn(
                shapes_g[k], generator=extra, device=ctx.device))
        elif k.endswith(".codebook"):
            g[k] = torch.randn(shapes_g[k], generator=extra,
                               device=ctx.device)
    for k, v in g.items():
        if tuple(v.shape) != tuple(shapes_g[k]):
            raise RuntimeError(f"drawn {k} {tuple(v.shape)}, the program "
                               f"has {shapes_g[k]}")

    def zeros(p):
        return {k: torch.zeros_like(v) for k, v in p.items()}

    return GANState(step=start, g_params=g, d_params=d,
                    g_opt=AdamState(start, zeros(g), zeros(g)),
                    d_opt=AdamState(start, zeros(d), zeros(d)),
                    rng=ctx.generator(2), g_ema=None)


def _keeps(seed: int, steps: int, batch: int, codec) -> list[torch.Tensor]:
    """The check steps' quantizer counts ``[batch]``, drawn from the seed."""
    rng = np.random.default_rng([seed, 23])
    n, drop = codec.n_codebooks, int(batch * codec.quantizer_dropout)
    out = []
    for _ in range(steps):
        keep = np.full(batch, float(n), np.float32)
        keep[:drop] = rng.integers(1, n + 1, drop)
        out.append(torch.from_numpy(keep))
    return out


def _reference(ctx: Ctx, rcfg, p0, batches, keeps, start: int,
               lower: str | None):
    """The reference's check steps from ``p0``: (losses per step, the
    first clipped gradients' norms, state after the last step)."""
    gen, disc = ref.models(rcfg, lower)
    s = ref.RefState(p0["g"], p0["d"], start, start, start)
    t = rcfg.train
    losses, grads = [], None
    with strict_fp32():
        for i, (wav, keep) in enumerate(zip(batches, keeps)):
            out = ref.step(rcfg, s, wav.to(ctx.device), gen, disc,
                           keep.to(ctx.device), keep_grads=i == 0)
            losses.append({k: float(out[k]) for k in _LOSSES})
            if i == 0:
                grads = {}
                for p, clip in (("g", t.g_grad_clip_norm),
                                ("d", t.d_grad_clip_norm)):
                    coef = float(ref.clip_coefficient(out[f"{p}_grads"],
                                                      clip))
                    grads[p] = {k: coef * v for k, v in
                                train._norms(out[f"{p}_grads"]).items()}
            del out
    return losses, grads, s


def _compare(ctx: Ctx, losses, grads, p0, p3, ref_losses, ref_grads, rs):
    for i, (a, b) in enumerate(zip(losses, ref_losses)):
        log(f"[{ctx.cell.name}] step {i + 1} losses "
            + ", ".join(f"{k} {a[k]:.6g} vs {b[k]:.6g}" for k in a))
    first, ref_first = losses[0], ref_losses[0]
    r = {f"{k}_gap": abs(first[k] - ref_first[k])
         / max(abs(ref_first[k]), 1e-12) for k in first}
    r["vq_gap"] = r["g_commitment_gap"]
    for p in ("g", "d"):
        r[f"grad_gap.{p}"], r[f"grad_gap_median.{p}"], leaf = train._gaps(
            grads[p], ref_grads[p])
        log(f"[{ctx.cell.name}] grad {p}: worst at {leaf}")
        total = math.sqrt(sum(x * x for x in ref_grads[p].values()))
        r[f"grad_norm_gap.{p}"] = abs(math.sqrt(sum(
            x * x for x in grads[p].values())) - total) / total
    ref_p3 = {"g": rs.g, "d": rs.d}
    for part in ("g", "d"):
        gref = ref_grads[part]
        med = statistics.median(gref.values())
        keep = {k for k, v in gref.items() if v >= 1e-3 * med}
        start = p0[part]
        prog = train._norms({k: p3[part][k] - start[k] for k in start})
        refc = train._norms({k: ref_p3[part][k] - start[k] for k in start})
        r[f"change_gap.{part}"], r[f"change_gap_median.{part}"], leaf = \
            train._gaps(prog, refc, keep)
        med_c = statistics.median(refc.values())
        r[f"change_gap_mean.{part}"] = statistics.fmean(
            abs(prog[k] - refc[k]) / max(refc[k], med_c) for k in keep)
        log(f"[{ctx.cell.name}] change {part}: worst at {leaf}, "
            f"{len(start) - len(keep)} leaves left out")
    for name in ("grad_gap", "grad_gap_median", "grad_norm_gap",
                 "change_gap", "change_gap_median"):
        r[name] = max(v for k, v in r.items() if k.startswith(name + "."))
    books = [k for k in p0["g"] if k.endswith(".codebook")]
    _, r["codebook_grad_gap"], _ = train._gaps(
        {k: grads["g"][k] for k in books},
        {k: ref_grads["g"][k] for k in books})
    alphas = [k for k in p0["g"] if k.endswith(".alpha")]
    prog = train._norms({k: p3["g"][k] - p0["g"][k] for k in alphas})
    refc = train._norms({k: rs.g[k] - p0["g"][k] for k in alphas})
    _, r["alpha_change_gap"], _ = train._gaps(prog, refc)
    log(f"[{ctx.cell.name}] readings " + json.dumps(r))
    ctx.records["readings"] = r
    for name in ctx.cell.limits:
        ctx.check(name, r[name])


def snake_elements(ccfg, length: int) -> int:
    """Elements one row's Snake calls take in one G pass, at the excerpt's
    padded ``length``: each encoder block's residual units (two calls each)
    and its own call at the block's input width and length, the encoder's
    last call, each decoder block's call at its input, its residual units'
    at its output, and the decoder's last call."""
    units = 2 * RES_UNITS
    total, ch, n = 0, ccfg.encoder_dim, length
    for r in ccfg.encoder_rates:
        total += (units + 1) * ch * n
        ch, n = 2 * ch, n // r
    total += ch * n
    ch = ccfg.decoder_dim
    for r in ccfg.decoder_rates:
        total += ch * n
        ch, n = ch // 2, n * r
        total += units * ch * n
    return total + ch * n


def snake_bytes(ccfg, batch: int, segment: int) -> int:
    """Bytes the step's Snake calls must move at the least: each forward
    reads its input and writes its output, each backward reads the input
    and the output's gradient and writes the input's, in the dtype they
    travel in (the convolutions' compute dtype), and each reads its fp32
    ``alpha`` and the backward writes its gradient. One G forward and one
    backward a step."""
    hop = math.prod(ccfg.encoder_rates)
    length = math.ceil(segment / hop) * hop
    size = _DTYPE_BYTES[ccfg.compute_dtype]
    alphas = _snake_channels(ccfg)
    return (5 * size * batch * snake_elements(ccfg, length)
            + 3 * 4 * alphas)


def _snake_channels(ccfg) -> int:
    units = 2 * RES_UNITS
    total, ch = 0, ccfg.encoder_dim
    for _ in ccfg.encoder_rates:
        total += (units + 1) * ch
        ch *= 2
    total += ch
    ch = ccfg.decoder_dim
    for _ in ccfg.decoder_rates:
        total += ch + units * (ch // 2)
        ch //= 2
    return total + ch


def run(ctx: Ctx) -> None:
    from music_synthesis_tpu_torch.config import config_from_dict
    from music_synthesis_tpu_torch.train import stage2
    from music_synthesis_tpu_torch.train.state import drop_graphed_steps

    cfg = config_from_dict(ctx.cell.config["train"])
    if not stage2.is_codec(cfg):
        raise ValueError("train_codec drives a codec configuration")
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
    keeps = _keeps(ctx.seed, tr.check_steps, b, cfg.codec)
    log(f"[{ctx.cell.name}] batch pool at "
        f"{time.perf_counter() - ctx.t0:.2f} s")
    state = _program_state(ctx, shapes_g, shapes_d, start)
    p0 = {"g": {k: v.clone() for k, v in state.g_params.items()},
          "d": {k: v.clone() for k, v in state.d_params.items()}}

    if ctx.control:
        ctx.open_window()
        del state
        losses, grads, cs = _reference(ctx, rcfg, p0, checked, keeps, start,
                                       "fp8")
        p3 = {"g": cs.g, "d": cs.d}
    else:
        step_fn = stage2.train_step
        losses, grads = [], None
        for i in range(tr.check_steps):
            state, m = step_fn(cfg, state, pool[i].to(
                ctx.device, non_blocking=True), keep=keeps[i])
            losses.append({k: m[k] for k in _LOSSES})
            log(f"[{ctx.cell.name}] step {i + 1} done at "
                f"{time.perf_counter() - ctx.t0:.2f} s")
            if i == 0:
                grads = {p: train._norms({k: v / (1.0 - t.adam_b1) for k, v
                                          in opt.mu.items()})
                         for p, opt in (("g", state.g_opt),
                                        ("d", state.d_opt))}
        p3 = {"g": {k: v.clone() for k, v in state.g_params.items()},
              "d": {k: v.clone() for k, v in state.d_params.items()}}

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
        log(f"[{ctx.cell.name}] memory peak {ctx.memory_peak_bytes} bytes")

        if ctx.trace and ctx.device.type == "cuda":
            j = [i]

            def steps_(n):
                nonlocal state
                for _ in range(n):
                    w = pool[j[0] % tr.pool_batches].to(ctx.device,
                                                        non_blocking=True)
                    state, _ = step_fn(cfg, state, w)
                    j[0] += 1

            trace = trace_device(ctx, lambda: steps_(1),
                                 lambda: steps_(tr.trace_steps))
            dtypes = {cfg.codec.compute_dtype, cfg.mpd.compute_dtype,
                      cfg.mrd.compute_dtype}
            ctx.records.update(
                step_s=step_s, trace_union_s=trace.union_s(),
                trace_wall_s=trace.wall_s,
                peak_flops=ctx.peaks.get(conv_precision(
                    dtypes, torch.backends.cudnn.allow_tf32)),
                step_flops=_step_flops(rcfg, shapes_g, shapes_d, b, seg,
                                       start),
                snake_least_s=snake_bytes(cfg.codec, b, seg)
                / HBM_BYTES_PER_S)
        del state, m
        drop_graphed_steps()
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    ref_losses, ref_grads, rs = _reference(ctx, rcfg, p0, checked, keeps,
                                           start, None)
    _compare(ctx, losses, grads, p0, p3, ref_losses, ref_grads, rs)
    if ctx.control:
        ctx.attempted = tr.check_steps


def _step_flops(rcfg, shapes_g, shapes_d, b, seg, start) -> int:
    """Logical FLOPs of one step (``harness.flops``) on the reference."""
    def body():
        with torch.device("meta"):
            g = {k: torch.empty(s) for k, s in shapes_g.items()}
            d = {k: torch.empty(s) for k, s in shapes_d.items()}
            wav, keep = torch.empty(b, seg), torch.empty(b)
        gen, disc = ref.models(rcfg)
        ref.step(rcfg, ref.RefState(g, d, start, start, start), wav, gen,
                 disc, keep)

    return flops.count(body)
