"""Window driver ``train_amp``: the stage-2 GAN step with BigVGAN's
generator (``block`` ``amp``: anti-aliased SnakeBeta AMP blocks), as the
CLI drives it.

It is ``drivers/train.py`` (imported, run as it is) with three parts put
in place of that driver's:

- the weights: ``train.py``'s draw (He-normal directions, ``conv_out`` at
  the configuration's ``out_init_gain``, gains the norms of their
  directions, biases zero, Adam's moments zero), then each AMP branch's
  second convolution (``c2_d*``) scaled to ``res_init_gain``, the weight-norm
  gain of each upsampling taken per input channel (BigVGAN's), and every
  activation's log-scale ``alpha`` and ``beta`` drawn N(0, ``SNAKE_STD``^2)
  from a stream of their own;
- the plain reference: BigVGAN's G from ``reference/bigvgan.py`` (written
  from the published equations) beside ``reference/model.py``'s D, in
  ``reference/train_step.py``'s step, with the log-mel of the magnitude
  that the front end states (``bigvgan.magnitude_mel``);
- the EMA: the recipe keeps none, so the program's state after the steps
  stands in for it (the reference's EMA at decay 0 is G itself).

With ``--trace 1`` it also records ``aa_act_least_s``: the least time the
step's anti-aliased activations take (``aa_act_bytes`` at the HBM rate),
which ``metrics/aa_act_roofline.py`` reads against the tracer's
``aa_act.fwd`` and ``aa_act.bwd`` regions.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from harness.config import BENCH, load_module
from harness.core import Ctx
from reference import bigvgan
from reference import train_step as ref
from reference.arith import HBM_BYTES_PER_S
from reference.model import CombinedDiscriminator

train = load_module(BENCH / "drivers" / "train.py", "bench_driver_train_base")

SNAKE_STD = 0.3  # the activations' alpha and beta (log scale)
_DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


class _Reference:
    """``reference.train_step`` with BigVGAN's G and the magnitude
    log-mel, under the names ``train.py`` calls."""

    RefState = ref.RefState

    @staticmethod
    def models(cfg, lower: str | None = None):
        with torch.device("meta"):
            return (bigvgan.BigVGAN(cfg.vocoder, lower),
                    CombinedDiscriminator(cfg.msd, cfg.mrd, lower))

    @staticmethod
    def step(*args, **kwargs):
        with bigvgan.magnitude_mel():
            return ref.step(*args, **kwargs)


def _program_state(ctx: Ctx, cfg, shapes_g, shapes_d, start: int):
    from music_synthesis_tpu_torch.train.state import AdamState

    state, d_count = _base_state(ctx, cfg, shapes_g, shapes_d, start)
    g = state.g_params
    gain = cfg.vocoder.res_init_gain
    for k in shapes_g:
        if ".c2_d" in k and k.endswith(".v"):
            g[k] = g[k] * gain
    for k in shapes_g:
        if k.endswith(".g"):
            v = g[k[:-2] + ".v"]
            axis = 1 if k.startswith("upsample_") else v.ndim - 1
            dims = tuple(i for i in range(v.ndim) if i != axis)
            g[k] = torch.sqrt(torch.sum(v * v, dim=dims) + 1e-12)
    snake = [k for k in shapes_g if k.endswith((".alpha", ".beta"))]
    flat = SNAKE_STD * torch.randn(sum(math.prod(shapes_g[k]) for k in snake),
                                   generator=ctx.generator(3),
                                   device=ctx.device)
    off = 0
    for k in snake:
        n = math.prod(shapes_g[k])
        g[k] = flat[off:off + n].view(shapes_g[k]).contiguous()
        off += n
    for k, v in g.items():
        if tuple(v.shape) != tuple(shapes_g[k]):
            raise RuntimeError(f"drawn {k} {tuple(v.shape)}, the program "
                               f"has {shapes_g[k]}")
    zeros = [{k: torch.zeros_like(v) for k, v in g.items()} for _ in "mv"]
    return dataclasses.replace(
        state, g_params=g, g_opt=AdamState(state.g_opt.count, *zeros),
        g_ema=None if state.g_ema is None else {
            k: v.clone() for k, v in g.items()}), d_count


def _compare(ctx, losses, grads, p0, p3, *rest):
    if not p3["ema"]:
        p3 = {**p3, "ema": p3["g"]}
    return _base_compare(ctx, losses, grads, p0, p3, *rest)


_base_state, _base_compare = train._program_state, train._compare
train.ref, train._program_state, train._compare = (_Reference, _program_state,
                                                   _compare)


def aa_act_bytes(vcfg, batch: int, segment: int) -> int:
    """Bytes the step's anti-aliased activations must move at the least:
    each forward call reads its input and writes its output, each backward
    call reads the input and the output's gradient and writes the input's,
    in the dtype the program stores them (the convolutions' compute
    dtype), and reads its ``alpha``, ``beta`` (fp32) in both and writes
    their gradients. One G forward and one backward a step."""
    size = _DTYPE_BYTES[vcfg.compute_dtype]
    per_act = len(vcfg.mrf_kernels) * len(vcfg.res_dilations) * 2
    length = segment // math.prod(vcfg.upsample_factors)
    channels, total = vcfg.base_channels, 0
    stages = list(vcfg.upsample_factors)
    for i, u in enumerate(stages):
        channels //= 2
        length *= u
        calls = per_act + (1 if i == len(stages) - 1 else 0)
        total += calls * (5 * size * batch * channels * length
                          + 6 * 4 * channels)
    return total


def run(ctx: Ctx) -> None:
    train.run(ctx)
    if ctx.trace and not ctx.control:
        t = ctx.cfg.train
        ctx.records["aa_act_least_s"] = aa_act_bytes(
            t.vocoder, t.train.batch_size,
            t.train.segment_length) / HBM_BYTES_PER_S
