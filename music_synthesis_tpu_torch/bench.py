"""Benchmark harness of the port (counterpart of the JAX build's ``bench.py``).

    python -m music_synthesis_tpu_torch.bench [--metric rtf|stage2_step] \\
        [--device cpu] [--out PATH] [--seed N]

Every scenario of the JAX script, each a function under the JAX function's
name, its numbers under the JAX script's keys:

- ``bench_inference_rtf`` (the JAX ``main()``'s headline):
  ``fused_two_stage_inference_rtf``, audio seconds generated per wall second
  by ``infer.generate.generate`` (composer, chunked iSTFT-head vocoder,
  overlap-add) at batch 16, seeded random weights;
- ``bench_waveform_head``: the same with the waveform head
  (``E2E_INFERENCE``), ``..._rtf_waveform_head``;
- ``bench_refined_rtf``: ``generate_refined`` with 8 Griffin-Lim
  projections, ``..._rtf_gl_refined``;
- ``bench_stage2_step``: the stage-2 GAN step at [16, 8192] in the
  reference-faithful fp32 recipe and the fast recipe,
  ``stage2_gan_step_ms`` / ``stage2_gan_step_fast_ms``, each with its FLOPs
  (``torch.utils.flop_counter``) and ``_mfu``, the share of the card's
  published peak for the precision its convolutions ran in, of the
  logical FLOPs (those of the recipe without ``dense_groups_max_g``);
- ``bench_stage1_fwd_loss``: ``train.stage1.forward_and_loss``,
  ``stage1_fwd_loss_ms``;
- ``bench_frontend_cpu_clip``: log-mel of a 30 s clip on the host CPU;
- ``bench_frontend_ab``: the log-mel kernel against its plain version at
  [16, 8192] (card only).

Method (the JAX scenarios' estimator): a run makes ``n`` calls, each on
fresh inputs drawn on the device from a ``torch.Generator`` seeded for the
run (on a card the inference calls and both stages' steps replay CUDA
graphs, as the JAX scenarios time jitted programs: the fresh input's copy
into the graph's input buffer is part of the call; the same runs with the
graphs disabled follow, their time on stderr), sums a device-side checksum of
every call (``sum |wav|``, the summed losses) and reads it once, after the
last call; the host clock measures the run, as a user of the port waits
on it. The time per call is
``(t_n - t_1) / (n - 1)`` of a 1-call and an n-call run, the least over
the repeats of the pairs that give a positive difference, after one
warm-up pair. The CUDA-event time of each run, the device's busy share
(``torch.profiler`` over an extra window of ``busy_calls`` calls, with
the union of the device's activity per call beside the unprofiled call)
and the peak memory of each scenario go to stderr.

Exactly one JSON line goes to stdout, as soon as the metric ``--metric``
selects is measured: ``{"metric", "value", "unit", "device",
"power_limit_w"}``. Everything else goes to stderr. The record, every key
of every scenario with the card's name and power limit, is rewritten after
each scenario into ``--out`` (default ``build/bench/bench_torch_full.json``
in the repository, which git ignores). A scenario that fails is recorded
with its error and the others run; the exit code is then 1.

Runs on ``cuda`` unless ``--device cpu`` is given. The TPU build's
``bench.py`` and its records are the JAX package's, measured on a TPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, schedule
from torch.utils.flop_counter import FlopCounterMode

from music_synthesis_tpu_torch._device import resolve_device
from music_synthesis_tpu_torch._graphs import Programs, disable_graphs
from music_synthesis_tpu_torch.config import (
    E2E_INFERENCE,
    E2E_INFERENCE_FAST,
    PipelineConfig,
)
from music_synthesis_tpu_torch.infer.generate import (
    GraphedPipeline,
    generate,
    generate_refined,
)
from music_synthesis_tpu_torch.models.specgan import SpectrogramGenerator
from music_synthesis_tpu_torch.models.vocoder import Vocoder
from music_synthesis_tpu_torch.ops.logmel import (
    fused_log_mel_for_vocoder,
    log_mel_for_vocoder_plain,
    log_mel_plain,
    logmel_gemm_flops,
    logmel_launches,
)
from music_synthesis_tpu_torch.train import stage1, stage2
from music_synthesis_tpu_torch.train.state import run, run_step
from music_synthesis_tpu_torch.utils.profiling import (
    device_busy,
    device_spans,
    device_union,
)

__all__ = ["DEFAULT_OUT", "PEAK_FLOPS", "ITERS", "RESULT_KEYS", "Env",
           "card_record", "busy_calls", "per_call_s", "graphed_and_eager_s",
           "inference_models",
           "generate_checksum", "stage1_checksum", "stage2_variants",
           "step_flops", "conv_precision", "bench_inference_rtf",
           "bench_waveform_head", "bench_refined_rtf", "bench_stage2_step",
           "bench_stage1_fwd_loss", "bench_frontend_cpu_clip",
           "bench_frontend_ab", "main"]

DEFAULT_OUT = (Path(__file__).resolve().parents[1] / "build" / "bench"
               / "bench_torch_full.json")

#: Published dense peaks (NVIDIA's data sheet) by the card's name, at its
#: 700 W limit; a card without an entry gets no MFU.
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12,
                                        "fp32": 67e12}}

#: Calls (steps) of the n-call run of each scenario, sized so that the
#: timed window of each takes at least about a second on an H100.
ITERS = {"bench_inference_rtf": 121, "bench_waveform_head": 65,
         "bench_refined_rtf": 71, "bench_stage2_step": 8,
         "bench_stage1_fwd_loss": 201, "bench_frontend_cpu_clip": 21,
         "bench_frontend_ab": 10001}

#: Every key a run on the card records: the JAX script's, ``_mfu`` and
#: ``_gflop_per_step`` of both stage-2 recipes, and the kernel's calls.
RESULT_KEYS = (
    "fused_two_stage_inference_rtf",
    "fused_two_stage_inference_rtf_waveform_head",
    "fused_two_stage_inference_rtf_gl_refined", "gl_refine_n_iter",
    *(f"{name}{suffix}"
      for name in ("stage2_gan_step_ms", "stage2_gan_step_fast_ms")
      for suffix in ("", "_gflop_per_step", "_tflops_per_s",
                     "_logical_tflops_per_s", "_executed_flop_inflation",
                     "_mfu")),
    "stage2_steps_run", "stage1_fwd_loss_ms", "frontend_cpu_clip_ms",
    "frontend_cpu_clip_x_realtime", "frontend_kernel_ms", "frontend_plain_ms",
    "frontend_kernel_speedup", "frontend_kernel_calls")

# The profiled window that reads the device's busy share holds at least
# this many calls and this many seconds of them (so more calls than
# n_iters where a call is long), after one unprofiled warm call and one
# call in the profiler's warm-up step, which takes its start. It holds at
# most _BUSY_MAX_CALLS calls: the trace's export and parsing grow with
# the activities it recorded, and the profiler's start, outside the
# window, no longer needs seconds of short calls to dilute it.
_BUSY_MIN_CALLS = 5
_BUSY_MAX_CALLS = 64
_BUSY_S = 0.5


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card_record(device: torch.device) -> dict:
    """``device`` (the card's name), ``power_limit_w`` and ``card``, the
    line ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints; without nvidia-smi the name comes from
    ``torch.cuda.get_device_name`` and ``card`` says so. Off the card each
    says ``cpu``."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": "cpu", "card": "cpu"}
    index = device.index if device.index is not None else 0
    name = torch.cuda.get_device_name(index)
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return {"device": name, "power_limit_w": None,
                "card": f"{name} (from torch.cuda.get_device_name; "
                        f"nvidia-smi failed: {e})"}
    watts = line.rpartition(",")[2].strip().removesuffix(" W")
    try:
        power = float(watts)
    except ValueError:  # "[N/A]"
        power = None
    return {"device": name, "power_limit_w": power, "card": line}


@dataclasses.dataclass
class Env:
    """What every scenario shares: the device, the seed of weights and
    inputs, the card record, and ``notes``, what a scenario records beside
    its numbers (the precision each stage-2 recipe's MFU is taken at)."""

    device: torch.device
    seed: int = 0
    card: dict = dataclasses.field(init=False)
    notes: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.card = card_record(self.device)

    def generator(self, salt: int) -> torch.Generator:
        """A generator on the device for the inputs of one run."""
        return torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + salt) % 2 ** 63)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def busy_calls(best: float) -> int:
    """Calls of the profiled window, for calls of ``best`` seconds."""
    return min(_BUSY_MAX_CALLS,
               max(_BUSY_MIN_CALLS, math.ceil(_BUSY_S / best)))


def _busy_share(env: Env, many: Callable,
                n: int) -> tuple[float, float, float, float]:
    """``(busy, kernel_ms, window_ms, union_ms)`` of a profiled ``n``-call
    window: the share of its wall time that the card spent in kernels,
    copies and sets (the union of their intervals,
    ``utils.profiling.device_busy``), the summed time of those activities
    per call (overlapping ones counted each), the window's wall ms per
    call, and the union's ms per call. The profiler stretches a call of
    many short activities, so the share reads low by the window's stretch
    over the unprofiled call; the union per call, held against the
    unprofiled call, does not take that stretch. One unprofiled call warms
    the path; one more runs in the profiler's warm-up step, where the
    profiler starts and records nothing; the window is the recorded step
    after it. Only the card's activity is traced (tracing the host's
    operators too lengthens the host's side, and the trace's processing,
    several times over), and both numbers come from the trace's device
    spans (``key_averages`` over the hundreds of thousands of activities
    of a few graphed training steps takes tens of seconds)."""
    float(many(1, env.generator(-1)))
    env.sync()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        float(many(1, env.generator(-1)))
        prof.step()
        t0 = time.perf_counter()
        float(many(n, env.generator(-1)))
        wall = time.perf_counter() - t0
        prof.step()
    spans = device_spans(prof)
    kernel_ms = sum(e - s for s, e in spans) / 1e3 / n
    union_ms = device_union(spans)[0] / 1e3 / n
    return device_busy(spans, wall), kernel_ms, 1e3 * wall / n, union_ms


def per_call_s(label: str, env: Env, many: Callable, n_iters: int,
               repeats: int = 3, positive: bool = False) -> float:
    """Seconds per call by the JAX scenarios' estimator (the module's
    docstring). ``many(n, gen)`` makes n calls on inputs drawn from ``gen``
    and returns the summed checksum, a device scalar; it is read once per
    run, and must be finite (and > 0 with ``positive``)."""
    if n_iters < 2:
        raise ValueError(f"{label}: n_iters must be >= 2, got {n_iters}")
    cuda = env.device.type == "cuda"

    def run(n: int, r: int) -> float:
        gen = env.generator(1000 * n + r)
        env.sync()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        total = many(n, gen)
        if cuda:
            end.record()
        v = float(total)
        dt = time.perf_counter() - t0
        if not math.isfinite(v) or (positive and v <= 0):
            raise FloatingPointError(f"{label}: checksum {v} over {n} calls")
        if cuda and r > 0:
            log(f"[{label}] run {r}: n={n} host {dt * 1e3:.3f} ms, CUDA "
                f"events {start.elapsed_time(end):.3f} ms")
        return dt

    t0 = time.perf_counter()
    run(1, 0)
    run(n_iters, 0)
    log(f"[{label}] warm-up pair: {time.perf_counter() - t0:.2f} s")
    per = []
    for r in range(1, repeats + 1):
        t1 = run(1, r)
        tn = run(n_iters, r)
        d = (tn - t1) / (n_iters - 1)
        log(f"[{label}] run {r}: n=1 {t1 * 1e3:.3f} ms, n={n_iters} "
            f"{tn * 1e3:.3f} ms -> {d * 1e3:.4f} ms/call")
        if d > 0:
            per.append(d)
    if not per:
        raise RuntimeError(f"{label}: every timing pair was noise-dominated")
    best = min(per)
    if cuda:
        calls = busy_calls(best)
        t0 = time.perf_counter()
        busy, kernel_ms, window_ms, union_ms = _busy_share(env, many, calls)
        log(f"[{label}] device busy share {busy:.3f}, kernel time "
            f"{kernel_ms:.4f} ms per call (profiled window of {calls} calls, "
            f"{window_ms:.4f} ms per call, {window_ms / (best * 1e3):.3f}x "
            f"the unprofiled call; {time.perf_counter() - t0:.2f} s); "
            f"union {union_ms:.4f} ms per call, "
            f"{union_ms / (best * 1e3):.3f} of the unprofiled call")
    return best


# -- inference -------------------------------------------------------------


def inference_models(cfg: PipelineConfig, env: Env):
    """The composer and vocoder of ``cfg`` with seeded random weights on
    the device, in eval mode (the real-time factor does not depend on the
    weights)."""
    composer = SpectrogramGenerator(
        cfg.specgan, torch.Generator().manual_seed(env.seed))
    vocoder = Vocoder(cfg.vocoder, torch.Generator().manual_seed(env.seed + 1))
    return composer.to(env.device).eval(), vocoder.to(env.device).eval()


def _wav_abs_sum(cfg: PipelineConfig, composer, vocoder, z: torch.Tensor,
                 n_gl: int) -> torch.Tensor:
    wav = (generate_refined(cfg, composer, vocoder, z, n_gl) if n_gl
           else generate(cfg, composer, vocoder, z))
    return wav.float().abs().sum()


def generate_checksum(cfg: PipelineConfig, composer, vocoder,
                      z: torch.Tensor, n_gl: int = 0,
                      pipe: GraphedPipeline | None = None) -> torch.Tensor:
    """One call of the inference loops: ``sum |wav|`` of ``generate`` (or
    ``generate_refined`` with ``n_gl`` projections) on latents ``z``;
    through ``pipe`` (a ``GraphedPipeline`` of the same modules: on a card
    the replay of one CUDA graph, ``z`` copied into its input buffer) if
    given, else eagerly. The sum is a device scalar (``pipe``'s is its
    graph's buffer: add it up before the next call)."""
    if pipe is not None:
        return pipe(_wav_abs_sum, z, n_gl)
    with torch.inference_mode():
        return _wav_abs_sum(cfg, composer, vocoder, z, n_gl)


def graphed_and_eager_s(label: str, env: Env, many: Callable, n_iters: int,
                        repeats: int = 3, positive: bool = False) -> float:
    """``per_call_s`` of ``many``, whose calls replay CUDA graphs on a card
    (the reference times jitted programs); on a card the same runs with
    the graphs disabled follow, their time on a stderr line."""
    best = per_call_s(label, env, many, n_iters, repeats, positive)
    if env.device.type == "cuda":
        with disable_graphs():
            eager = per_call_s(f"{label} eager", env, many, n_iters, repeats,
                               positive)
        log(f"[{label}] graphed {best * 1e3:.4f} ms/call, eager "
            f"{eager * 1e3:.4f} ms/call on {env.card['card']}")
    return best


def _rtf(results: dict, env: Env, key: str, cfg: PipelineConfig,
         batch: int, n_iters: int, repeats: int, n_gl: int = 0) -> None:
    composer, vocoder = inference_models(cfg, env)
    pipe = GraphedPipeline(cfg, composer, vocoder)
    samples = batch * cfg.specgan.n_frames * cfg.vocoder.hop_length
    audio_sec = samples / cfg.frontend.sample_rate

    def many(n: int, gen: torch.Generator) -> torch.Tensor:
        total = torch.zeros((), device=env.device)
        for _ in range(n):
            z = torch.randn((batch, cfg.specgan.latent_dim), generator=gen,
                            device=env.device)
            total = total + generate_checksum(cfg, composer, vocoder, z, n_gl,
                                              pipe)
        return total

    best = graphed_and_eager_s(key, env, many, n_iters, repeats,
                               positive=True)
    results[key] = audio_sec / best
    log(f"[{key}] batch {batch}, {audio_sec:.3f} audio-s per call: "
        f"{best * 1e3:.4f} ms/call -> real-time factor {audio_sec / best:.1f} "
        f"on {env.card['card']}")


def bench_inference_rtf(results: dict, env: Env,
                        cfg: PipelineConfig = E2E_INFERENCE_FAST,
                        batch: int = 16,
                        n_iters: int = ITERS["bench_inference_rtf"]) -> None:
    """The headline: the real-time factor of two-stage inference with the
    iSTFT-head vocoder (``E2E_INFERENCE_FAST``) at batch 16."""
    _rtf(results, env, "fused_two_stage_inference_rtf", cfg, batch, n_iters,
         repeats=3)


def bench_waveform_head(results: dict, env: Env,
                        cfg: PipelineConfig = E2E_INFERENCE, batch: int = 16,
                        n_iters: int = ITERS["bench_waveform_head"]) -> None:
    """The same with the reference-faithful waveform-head vocoder."""
    _rtf(results, env, "fused_two_stage_inference_rtf_waveform_head", cfg,
         batch, n_iters, repeats=2)


def bench_refined_rtf(results: dict, env: Env,
                      cfg: PipelineConfig = E2E_INFERENCE_FAST,
                      batch: int = 16, n_gl: int = 8,
                      n_iters: int = ITERS["bench_refined_rtf"]) -> None:
    """The headline plus ``n_gl`` warm-started Griffin-Lim projections
    (``generate_refined``)."""
    _rtf(results, env, "fused_two_stage_inference_rtf_gl_refined", cfg, batch,
         n_iters, repeats=2, n_gl=n_gl)
    results["gl_refine_n_iter"] = n_gl


# -- training --------------------------------------------------------------


def stage2_variants(base: PipelineConfig | None = None) -> dict:
    """The JAX script's two stage-2 recipes, by result key, conditioned
    through the log-mel kernel as the flagship recipe trains
    (``use_pallas_frontend``; the JAX script's recipes use its XLA
    front-end, the same function). The fast recipe is the JAX script's
    ``dataclasses.replace``: bf16 G and D, D(real)-feature reuse, one D
    call on the concatenated batch, and the MSD's grouped convolutions of
    up to 16 groups as dense block-diagonal ones (``dense_groups_max_g``);
    its ``f_fold`` chooses a TPU relayout the port does not make
    (``config.py``)."""
    base = PipelineConfig() if base is None else base
    base = dataclasses.replace(base, train=dataclasses.replace(
        base.train, use_pallas_frontend=True))
    fast = dataclasses.replace(
        base,
        msd=dataclasses.replace(base.msd, compute_dtype="bfloat16",
                                dense_groups_max_g=16),
        mrd=dataclasses.replace(base.mrd, compute_dtype="bfloat16", f_fold=4),
        vocoder=dataclasses.replace(base.vocoder, compute_dtype="bfloat16"),
        train=dataclasses.replace(base.train, reuse_real_features=True,
                                  concat_disc_batch=True))
    return {"stage2_gan_step_ms": base, "stage2_gan_step_fast_ms": fast}


def step_flops(cfg: PipelineConfig, state, wav: torch.Tensor) -> dict:
    """FLOPs of one stage-2 step by operator: ``FlopCounterMode``'s count
    of the PyTorch operators (2 per multiply-add of the convolutions, their
    backward and the matmuls, by PyTorch's formulas), and under
    ``logmel_kernel`` the kernel's GEMMs for each launch (a ctypes call, so
    no counter sees it). The step runs once; its result is dropped."""
    before = logmel_launches.n_calls
    with FlopCounterMode(display=False) as counter:
        run(stage2.stage("fast"), cfg, state, wav)
    launches = logmel_launches.n_calls - before
    out = {str(op): int(n) for op, n in
           counter.get_flop_counts().get("Global", {}).items()}
    b, length = wav.shape
    out["logmel_kernel"] = launches * logmel_gemm_flops(
        b, length // cfg.frontend.hop_length, cfg.frontend)
    return out


def conv_precision(cfg: PipelineConfig, device: torch.device) -> str:
    """The precision the step's convolutions run in: ``bf16``; for fp32,
    ``tf32`` on the card under cuDNN's TF32 (PyTorch's default), else
    ``fp32``; ``mixed`` when the models differ."""
    dtypes = {cfg.vocoder.compute_dtype, cfg.msd.compute_dtype,
              cfg.mrd.compute_dtype}
    if dtypes == {"bfloat16"}:
        return "bf16"
    if dtypes != {"float32"}:
        return "mixed"
    tf32 = device.type == "cuda" and torch.backends.cudnn.allow_tf32
    return "tf32" if tf32 else "fp32"


def bench_stage2_step(results: dict, env: Env, variants: dict | None = None,
                      n_iters: int = ITERS["bench_stage2_step"]) -> None:
    """Stage-2 GAN step time at [16, 8192] for each recipe of
    ``variants`` (``stage2_variants()``), then its FLOPs and MFU.

    Steps are chained from one seeded state, each on a fresh batch
    ``0.5 tanh(normal)`` drawn on the device, with the metrics left there
    (``train.state.run_step``: on a card the replay of the step's CUDA
    graph, as the JAX script times its jitted step; the same runs with
    the graphs disabled follow, their time on stderr): the run's one host
    read is its summed ``d_loss``. The log-mel kernel runs once per step,
    in "fast", as in training; ``stage2_steps_run`` counts every step this
    scenario ran, so its launches can be checked. The FLOPs are counted
    over one more eager step, outside the timed runs (``step_flops``):
    ``<key>_gflop_per_step`` and ``_tflops_per_s`` are the executed ones.
    A recipe with ``dense_groups_max_g`` executes the zero blocks of its
    block-diagonal kernels too, so its logical FLOPs are counted over one
    step of its twin without it (the same parameters), as the JAX script
    counts them: ``_logical_tflops_per_s`` is logical FLOPs over the step
    time, ``_executed_flop_inflation`` executed over logical, and
    ``_mfu`` the logical FLOPs' share of the card's published peak
    (``PEAK_FLOPS``) for ``conv_precision``, null off the card or on a
    card without an entry."""
    variants = stage2_variants() if variants is None else variants
    peaks = PEAK_FLOPS.get(env.card["device"], {})
    steps = 0
    for name, cfg in variants.items():
        b, seg = cfg.train.batch_size, cfg.train.segment_length
        t0 = time.perf_counter()
        state0 = stage2.make_train_state(cfg, env.seed, env.device)
        log(f"[{name}] seeded state in {time.perf_counter() - t0:.2f} s")

        def draw(gen: torch.Generator) -> torch.Tensor:
            return 0.5 * torch.tanh(torch.randn((b, seg), generator=gen,
                                                device=env.device))

        def many(n: int, gen: torch.Generator, _cfg=cfg, _state=state0,
                 _draw=draw) -> torch.Tensor:
            nonlocal steps
            st, total = _state, torch.zeros((), device=env.device)
            for _ in range(n):
                st, m = run_step(stage2.stage(), _cfg, st, _draw(gen))
                total = total + m["d_loss"]
                steps += 1
            return total

        best = graphed_and_eager_s(name, env, many, n_iters)
        results[name] = best * 1e3
        t0 = time.perf_counter()
        wav = draw(env.generator(-2))
        flops = step_flops(cfg, state0, wav)
        steps += 1
        executed = sum(flops.values())
        logical = executed
        if cfg.msd.dense_groups_max_g:
            twin = dataclasses.replace(cfg, msd=dataclasses.replace(
                cfg.msd, dense_groups_max_g=0))
            logical = sum(step_flops(twin, state0, wav).values())
            steps += 1
        log(f"[{name}] FLOPs counted in {time.perf_counter() - t0:.2f} s")
        precision = conv_precision(cfg, env.device)
        peak = peaks.get(precision)
        results[f"{name}_gflop_per_step"] = executed / 1e9
        results[f"{name}_tflops_per_s"] = executed / best / 1e12
        results[f"{name}_logical_tflops_per_s"] = logical / best / 1e12
        results[f"{name}_executed_flop_inflation"] = executed / logical
        results[f"{name}_mfu"] = (logical / best / peak if peak else None)
        env.notes[f"{name}_mfu_precision"] = precision
        log(f"[{name}] {best * 1e3:.2f} ms/step; "
            + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in flops.items())
            + f" GFLOP executed, {logical / 1e9:.3f} logical ("
            f"{executed / logical:.4f}x) -> {logical / best / 1e12:.2f} "
            f"TFLOP/s useful; convolutions in {precision}, MFU "
            f"{results[f'{name}_mfu']} against "
            f"{peak / 1e12 if peak else None} TFLOP/s on {env.card['card']}")
    results["stage2_steps_run"] = steps


def stage1_checksum(cfg: PipelineConfig, state, real: torch.Tensor,
                    z: torch.Tensor) -> torch.Tensor:
    """One call of the stage-1 loop: ``d_loss + g_loss`` of
    ``train.stage1.forward_and_loss``, on the device."""
    m = stage1.forward_losses(cfg, state, real, z)
    return m["d_loss"] + m["g_loss"]


def bench_stage1_fwd_loss(results: dict, env: Env,
                          cfg: PipelineConfig | None = None,
                          n_iters: int = ITERS["bench_stage1_fwd_loss"]
                          ) -> None:
    """Stage-1 generator forward and hinge losses on one batch
    (``PipelineConfig()``: 16 x 128 frames x 128 mels), fresh latents each
    call, against a fixed uniform real batch; on a card one CUDA graph."""
    cfg = PipelineConfig() if cfg is None else cfg
    b, s = cfg.train.batch_size, cfg.specgan
    state = stage1.make_train_state(cfg, env.seed, env.device)
    real = torch.rand((b, s.n_frames, s.n_mels), generator=env.generator(-3),
                      device=env.device) * 2.0 - 1.0

    programs = Programs(env.device)

    def checksum(z: torch.Tensor) -> torch.Tensor:
        return stage1_checksum(cfg, state, real, z)

    def many(n: int, gen: torch.Generator) -> torch.Tensor:
        total = torch.zeros((), device=env.device)
        for _ in range(n):
            z = torch.randn((b, s.latent_dim), generator=gen,
                            device=env.device)
            total = total + programs("stage1", checksum, z)
        return total

    best = graphed_and_eager_s("stage1_fwd_loss", env, many, n_iters)
    results["stage1_fwd_loss_ms"] = best * 1e3
    log(f"[stage1_fwd_loss] {best * 1e3:.4f} ms/batch{b} on "
        f"{env.card['card']}")


# -- front-end ---------------------------------------------------------------


def bench_frontend_cpu_clip(results: dict, env: Env,
                            cfg: PipelineConfig | None = None,
                            n_iters: int = ITERS["bench_frontend_cpu_clip"],
                            seconds: float = 30.0) -> None:
    """Log-mel of one 30 s 22.05 kHz sine on the host CPU, whatever the
    device: BASELINE config 1 says CPU. The plain version
    (``ops.logmel.log_mel_plain``, what the kernel's wrapper takes for a
    CPU tensor); the least wall time of ``n_iters`` calls after one."""
    fcfg = (PipelineConfig() if cfg is None else cfg).frontend
    n = int(seconds * fcfg.sample_rate)
    t = torch.arange(n, dtype=torch.float32) / fcfg.sample_rate
    wav = (0.1 * torch.sin(2 * math.pi * 440.0 * t))[None, :]
    with torch.inference_mode():
        out = log_mel_plain(wav, fcfg)
        if not bool(torch.isfinite(out).all()):
            raise FloatingPointError("frontend_cpu_clip: non-finite log-mel")
        times = []
        for _ in range(n_iters):
            t0 = time.perf_counter()
            log_mel_plain(wav, fcfg)
            times.append(time.perf_counter() - t0)
    best = min(times)
    results["frontend_cpu_clip_ms"] = best * 1e3
    results["frontend_cpu_clip_x_realtime"] = seconds / best
    log(f"[frontend_cpu_clip] {seconds:g} s clip on the host CPU "
        f"({torch.get_num_threads()} threads): {best * 1e3:.3f} ms "
        f"({seconds / best:.1f}x real time)")


def bench_frontend_ab(results: dict, env: Env,
                      cfg: PipelineConfig | None = None,
                      n_iters: int = ITERS["bench_frontend_ab"]) -> None:
    """The log-mel kernel (``fused_log_mel_for_vocoder``, "fast") against
    its plain version (``log_mel_for_vocoder_plain``) at the stage-2 batch
    [16, 8192], each on fresh ``0.5 tanh(normal)`` audio drawn on the card
    every call; ``frontend_kernel_calls`` counts the kernel's calls. Skipped
    on the CPU: there is no kernel to time there."""
    if env.device.type != "cuda":
        log("[frontend_ab] skipped on the CPU (the kernel runs on the card "
            "only)")
        return
    cfg = PipelineConfig() if cfg is None else cfg
    b, seg = cfg.train.batch_size, cfg.train.segment_length
    calls = 0

    def kernel(w):
        nonlocal calls
        calls += 1
        return fused_log_mel_for_vocoder(w, cfg.frontend, "fast")

    for key, fn in (("frontend_kernel_ms", kernel),
                    ("frontend_plain_ms", lambda w: log_mel_for_vocoder_plain(
                        w, cfg.frontend))):
        def many(n: int, gen: torch.Generator, _fn=fn) -> torch.Tensor:
            total = torch.zeros((), device=env.device)
            for _ in range(n):
                wav = 0.5 * torch.tanh(torch.randn(
                    (b, seg), generator=gen, device=env.device))
                total = total + _fn(wav).sum()
            return total

        with torch.inference_mode():
            best = per_call_s(key, env, many, n_iters)
        results[key] = best * 1e3
        log(f"[{key}] {best * 1e3:.5f} ms at [{b}, {seg}] on "
            f"{env.card['card']}")
    results["frontend_kernel_speedup"] = (results["frontend_plain_ms"]
                                          / results["frontend_kernel_ms"])
    results["frontend_kernel_calls"] = calls


# -- the command -------------------------------------------------------------

#: The scenarios after the headline, in the JAX script's order.
EXTRAS = ("bench_waveform_head", "bench_refined_rtf", "bench_stage2_step",
          "bench_stage1_fwd_loss", "bench_frontend_cpu_clip",
          "bench_frontend_ab")

# --metric -> (its scenario, the contract line's metric, key and unit).
METRICS = {
    "rtf": ("bench_inference_rtf", "fused_two_stage_inference_rtf",
            "fused_two_stage_inference_rtf", "x_realtime_per_card"),
    "stage2_step": ("bench_stage2_step", "stage2_gan_step_ms",
                    "stage2_gan_step_fast_ms", "ms_per_step_b16x8192"),
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--metric", choices=sorted(METRICS), default="rtf",
                    help="the metric of the one stdout line")
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu: a check of the harness)")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="the record of every key (JSON)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of every run's inputs")
    return ap


def main(argv: list[str] | None = None,
         overrides: dict[str, dict] | None = None) -> int:
    """Runs the scenarios; returns the exit code (1 when one failed).
    ``overrides`` maps a scenario's name to keyword arguments of its
    function (its ``n_iters``, its configs), for the tests and the smoke
    run. The record's ``notes`` hold each scenario's log-mel kernel
    launches."""
    ap = parser()
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.exit(1, f"{ap.prog}: {e}\n")
    overrides = overrides or {}
    env = Env(device, args.seed)
    out = Path(args.out)
    record = {**env.card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "seed": args.seed,
              "metric": args.metric, "results": {}, "failed": {}}
    log(f"[bench] {env.card['card']}, torch {torch.__version__}, "
        f"seed {args.seed}, record {out}")

    def save() -> None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))

    def scenario(name: str) -> None:
        fn = globals()[name]
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        before = logmel_launches.n_calls
        try:
            fn(record["results"], env, **overrides.get(name, {}))
        except Exception as e:  # noqa: BLE001 -- recorded, the rest run
            record["failed"][name] = repr(e)
            log(f"[{name}] failed: {e!r}\n{traceback.format_exc()}")
        env.notes.setdefault("logmel_launches", {})[name] = (
            logmel_launches.n_calls - before)
        peak = (f", peak memory "
                f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.3f} GiB"
                if device.type == "cuda" else "")
        log(f"[{name}] {time.perf_counter() - t0:.1f} s{peak}")
        save()

    first, metric, key, unit = METRICS[args.metric]
    scenario(first)
    value = record["results"].get(key)
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      "device": env.card["device"],
                      "power_limit_w": env.card["power_limit_w"]}),
          flush=True)
    for name in ("bench_inference_rtf", *EXTRAS):
        if name != first:
            scenario(name)
    record["notes"] = env.notes
    save()
    log(f"[bench] all metrics on {env.card['card']}: "
        f"{json.dumps(record['results'])}")
    if record["failed"]:
        log(f"[bench] failed: {record['failed']}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
