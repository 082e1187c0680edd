#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed 0] [--budget 1200]
    python3 chip_smoke.py --cpu-gaps     # on any machine: the CPU's own
                                         # bf16-vs-fp32 gaps (see CPU_GAPS)
    python3 chip_smoke.py --kernel-times [--tree DIR]
                                         # the log-mel kernel of the
                                         # checkout DIR (default: this one):
                                         # errors and times, and the
                                         # anti-aliased SnakeBeta and the
                                         # grouped convolution kernels'
                                         # times: one JSON line

Drives ``music_synthesis_tpu_torch`` through the entry points a user calls,
at the flagship's full width with the committed zoo weights, in phases:

1. build: ``csrc/logmel.cu`` with nvcc and ``csrc/msynth_io.cc`` with g++,
   started together; prints the build seconds, ptxas' register and spill
   lines, and the card's name and power limit;
2. kernel vs plain: the log-mel kernel against its plain PyTorch version at
   [16, 8192], [16, 88064], [4, 88064], [1, 8192] and [1, 88064] (every
   shape the main path gives it, and the 4 s batch of 16), both precision
   modes (the 3xTF32 tensor-core path for "fast", the fp32 FFMA path for
   "exact"), the
   vocoder and plain variants, power 2 and 1, and 160 mels at [16, 8192]
   ([1, 8192], the stage-2 CLI's audio dump, and [1, 88064], one 4 s eval
   clip, in the vocoder variant); max abs error against the plain version
   evaluated in float64 <= 2e-4 ("exact"), <= 2e-2 ("fast"); the times of both
   paths and of the plain version under two timers (``time_ms``: median of
   21 CUDA-event samples of 10 back-to-back calls, after warm-up;
   ``graph_time_ms``: the same 10 calls captured in one CUDA graph and its
   replays timed, so no host work is in the window) beside two bounds:
   fp32 FFMA, and three TF32 tensor-core passes (the one in the
   ``kernels`` line); and at the five vocoder shapes the "fast" path's
   launch choices, each forced (a tile's K walk on 1, 2 or 4 blocks of a
   cluster), with their errors and times under both timers, beside the
   launcher's pick; the build's SASS must hold ``wgmma`` (``HGMMA``) and
   TMA loads (``UTMALDG``) and no ``mma.sync`` (``HMMA``), and ptxas must
   report no spills;
3. copy-synthesis (main path): seeded harmonic test audio [16, 8192] and
   [4, 88064] through ``infer.copy_synthesis`` with ``zoo/vocoder_istft``;
   the kernel's launch count must rise;
4. serving (main path): ``SynthService(specgan_flux, vocoder_istft)``
   answers three requests; shapes, finiteness, bucketed lengths and
   repeat-seed identity are checked;
5. checks against the CPU: both entry points in fp32 with cuDNN TF32 off
   (2e-3), and as they run by default (copy-synthesis in the card's bf16,
   serving in fp32 under cuDNN's default TF32 convolutions) against CPU
   fp32, within the CPU's own bf16-vs-fp32 gap at the same input
   (``CPU_GAPS``) times a stated factor (``GAP_FACTOR``);
6. training (main path): stage-2 GAN training at the flagship's full width
   (``train.flagship.flagship_config``: ``zoo/vocoder_istft``'s vocoder,
   front-end and MelScaler, the MSD+MRD and training knobs of the flagship
   run, its MSD's grouped convolutions of up to 16 groups dense) through
   ``train.stage2.train_step`` (one CUDA graph: its first call captures
   it), batch [16, 8192] in bf16, G from the zoo, D seeded: 2 steps inside
   the warmup gate (D and its Adam state must not move, G must), then
   1 + 3 steps past it (D must move); finite metrics under the JAX step's
   keys; one log-mel kernel launch per step; the median step time (CUDA
   events) and peak memory; then one step at
   [2, 8192] in fp32 with TF32 off on the card (the "exact" kernel), from
   a D whose logits are away from 0, against the same step on the CPU
   (``TRAIN_TOL``), and the same step with TF32 on, which must fail it;
7. stage-1 training (main path) at the composer flagship's full width
   (``train.flagship.stage1_flagship_config``: ``zoo/specgan_flux``'s G,
   a seeded D, batch 16 of 128 frames x 128 mels, instance noise 0.2
   decaying over 10k steps, R1 1, flux 10, EMA 0.999) through
   ``train.stage1.train_step`` on log-mel patches of test audio: finite
   metrics under the JAX step's keys, G, D and the EMA moving, no kernel
   launch (the reference's stage 1 runs none), the median step time (CUDA
   events, 10 steps after 2 warm-ups), peak memory, and kernel launches,
   kernel time and device busy share per step (``torch.profiler``, 3
   steps); then one step in
   fp32 with TF32 off from a D whose logits are away from 0 against the
   same step on the CPU (``STAGE1_TOL``), and with TF32 on, which must
   fail it;
8. the lifecycle through the port's CLIs (main path), in a temporary
   directory: ``train_stage1`` with the composer flagship's flags on the
   synthetic corpus it writes, ``export_zoo --stage 1``, ``train_stage2``
   with the vocoder flagship's flags (``--head istft --pallas-frontend``,
   R1, noise, the warmup gate, EMA, bf16) at ``--batch 16 --segment 8192``
   for 2 steps, then ``--resume`` to 4 at ``--steps-per-dispatch 2``, with
   checkpoints and audio dumps, ``export_zoo --stage 2``, and a
   ``SynthService`` on the two exported entries answering one 4 s request;
   the log-mel kernel must launch once per stage-2 step and audio dump,
   the resumed run must start at the checkpoint's step, and the audio must
   be finite and of the requested length; each CLI's ``loop:`` line is
   printed beside the card's name and power limit;
9. the HTTP server (main path) at the flagships' full width
   (``specgan_flux`` + ``vocoder_istft``, fp32, warmed with the stream):
   ``serve.make_server`` on 127.0.0.1, port 0, in a thread of this
   process; ``GET /healthz``, ``/models``, ``/metrics``; ``POST /generate``
   (4 s x 1, 8 s x 4), whose bytes must equal ``wav_bytes`` of the
   in-process ``synth`` for the same seed, and its latency over HTTP against
   in process; ``POST /stream`` of 8 s, exactly ``44 + 2 * samples`` bytes
   with the time to its first PCM block, and (a second stream, cuDNN TF32
   off) decoding to the raw ``_execute`` audio of the same seed and patch
   count (``FP32_TOL`` plus one 16-bit step); a service with ``coalesce_window_ms=20``
   answering 4 requests from 4 threads in fewer device calls, each clip its
   solo audio (``FP32_TOL``, TF32 off); a ``gl_refine=8`` service on one
   4 s request (finite, not the unrefined audio, timed); ``POST /reload`` to
   a missing entry (400, the old service answers the same bytes), then onto
   the pair phase 8 exported, by directory (200; the next ``/generate`` is
   the new pair's), with the card's peak memory across the reload; and
   ``/metrics``' p50/p95;
10. evaluation and the inference CLIs (main path), in process:
   ``make_corpus`` (256 x 30 s, seed 0) into a temporary directory;
   ``eval_checkpoint --zoo vocoder_istft --head istft --gl-anchor
   --gl-refine 8`` on it, each clip's ``dist``, ``jitter``, ``mcd_db``,
   ``rms_ratio`` and ``gl_dist`` held to the JAX package's own eval of the
   same corpus on a CPU (``EVAL_JAX_CPU``, ``EVAL_TOL``) and printed beside
   the TPU values in ``zoo/vocoder_istft/card.json``; ``eval_checkpoint
   --run`` on phase 8's stage-2 run and corpus, one log-mel launch per
   clip; ``vocode`` (neural and ``--griffin-lim``) on a corpus clip; and
   ``generate`` from the zoo pair (``--seconds 8 --gl-refine 8``, and with
   ``--interpolate``, ``--walk-step`` and ``--report``): files written,
   audio finite;
12. data parallelism (main path), in ranks that ``parallel.mesh.launch``
   spawns (each builds nothing: it loads phase 1's library): two gloo
   ranks sharing ``cuda:0`` run one fp32 step (TF32 off, the "exact"
   kernel) of each DP mode (``--dp jit`` and ``--dp shard_map``) of both
   flagships at their full width, global batch 16 (8 per rank), from the
   state of phases 6-7's card-vs-CPU checks with the draws injected,
   against the single-process step on the whole batch in this process
   (``TRAIN_TOL``, ``STAGE1_TOL``; ``g_rms_ratio`` of ``shard_map``, the
   mean of the shards' ratios, is not compared); the ranks' states must
   be equal and each rank's stage-2 step must launch the kernel once; then
   the bf16 flagship step per rank and the gradient all-reduce, timed (two
   ranks on one card: not a scaling number; gloo's steps run eagerly);
   one NCCL rank, whose DP steps replay CUDA graphs with NCCL's
   collectives captured, runs the same four checks, then per stage and
   mode the flagship DP step (stage 2 in bf16 at [16, 8192], 3 steps
   inside the warmup gate and 3 past it; stage 1 at [16, 128, 128], 6
   steps) graphed against eager, every metric and state tensor bit for
   bit, one log-mel launch per stage-2 replay, ``train_step_many`` (K = 4)
   against four steps bit for bit, and times the DP step graphed and
   eager and the single-process step graphed; two NCCL ranks on two cards
   run the same when there are two (else a line says so); the flagship
   vocoder's sequence-sharded vocode over ``[cuda:0, cuda:0]``, one graph
   per shard, against its eager run (bit for bit) and one device
   (interior, ``FP32_TOL``); the serving split and gather over
   ``[cuda:0, cuda:0]`` against one device (``FP32_TOL``), and
   ``mesh_devices=2`` refused on a one-card machine (this process
   launches the kernel once here, in the single-process stage-2 step);
13. the JAX package's last modules in the port (main path), in phases
   8-12's directory: the C++ IO library (built beside the kernel in phase
   1 by g++, its seconds printed) decodes and resamples a 30 s 44.1 kHz
   stereo clip against scipy (interior within 2e-3, host ms of both);
   ``extract_features`` on a 4 s clip (one launch of the kernel in
   "exact", the plain variant at [1, 88200]; its mel and the kernel
   within 2e-4 of the plain version in float64, times beside both
   bounds); ``eval_stage1 --zoo specgan_flux --n 64`` on phase 10's corpus
   (one launch, the vocoder variant at [64, 32768], held as above), then
   its metrics on the card (fp32, cuDNN TF32 off) against the CPU with the
   same latents (``EVAL1_CPU_GAPS`` x ``EVAL1_GAP_FACTOR``); ``parity`` on
   phase 10's eval WAVs (real against itself 0, against the resynthesis
   and the refinement > 0); ``average_ckpts`` over phase 8's stage-2
   checkpoints (the float64 mean, exactly) and ``eval_checkpoint --run``
   on the average; ``deploy``: the ``vocoder_istft`` artifact (64 frames)
   and the ``specgan_flux`` + ``vocoder_istft`` pipeline, symbolic batch,
   in fp32, for ``cuda,cpu``, saved, read, loaded and run at batch 1 and 4
   on the card and 1 on the CPU against the live modules (``FP32_TOL``,
   cuDNN TF32 off), with file MB and export s; on the card the artifact
   replays one CUDA graph per batch size: at batch 4 bit for bit with its
   eager call and within ``FP32_TOL`` of the live graphed module (TF32
   off), a batch-1 result kept across a batch-4 call unchanged, the
   graphed, eager and live graphed ms and the artifact's pool bytes; and
   one flagship stage-2 step and one stage-1 step under
   ``utils.profiling.trace``: every JAX region name of the config's step
   in the trace, and host ms, device ms and launches per region;
14. the benchmark scripts (main path), in process: every scenario of
   ``python -m music_synthesis_tpu_torch.bench`` at full width with a few
   calls or steps each (``BENCH_SMOKE_ITERS``), its record in phases
   8-13's directory: one stdout line, the contract line, that parses;
   every key of ``bench.RESULT_KEYS`` in the record, finite and positive;
   each stage-2 recipe's MFU in (0, 1.05]; the kernel launched once per
   stage-2 step and kernel-vs-plain call the bench counts, and in no
   other scenario; ``bench_rtf_batch --batches 8,16`` (``BENCH_SWEEP_CALLS``);
   ``bench_serve --requests 8 --concurrency 4`` at 5 and 0 ms of
   coalescing: every request answered, p50 <= p95, a merge ratio of 1.0
   at 0 ms and >= 1.0 at 5 ms;
15. CUDA graphs (main path): each graphed program against its eager
   launches (``_graphs.disable_graphs``) at the widths the phases above
   run: ``generate`` at batch 16 over the flagship pair (``specgan_flux``
   fp32, ``vocoder_istft`` bf16), every bucket and both stream calls of a
   fresh flagship ``SynthService`` (fp32, on its worker thread),
   copy-synthesis at [16, 8192] (``vocoder_istft`` bf16, the log-mel
   kernel inside the graph) and the stage-1 flagship step at [16, 128,
   128]: eager and graphed ms per call (CUDA events, median of 21),
   launches per call and the device's busy share under both
   (``torch.profiler``), the graph pool's bytes; for the first four max
   |graphed - eager| must not exceed max |eager - eager| over three eager
   calls on the same input (the card's own run-to-run gap); five graphed
   stage-1 steps from one state must match five eager ones within
   ``STAGE1_TOL``, printed beside two eager runs' gap; 10 replays of the
   copy-synthesis graph must raise ``logmel_launches.n_calls`` by 10;
   and the stage-2 flagship step at [16, 8192] (bf16, ``flagship_config``,
   zoo G, seeded D; ``stage2_graphs``): 3 steps inside the warmup gate and
   3 past it, graphed against two eager runs from one state, within
   ``STAGE2_GRAPH_TOL`` or the eager runs' own gap per metric, the gap per
   state group printed, D and D's Adam unmoved inside the gate;
   ``train_step_many`` (K = 4) against four graphed steps, 4 log-mel
   launches each; the graph pool's bytes; the MSD alone in bf16 with
   ``dense_groups_max_g`` 16 against 0 (logits and taps within
   ``MSD_DENSE_TOL`` of their peaks; forward and forward + R1 ms); the
   step eager and graphed with and without ``dense_groups`` (ms, launches,
   busy share, kernel ms, and the eager ``d_step`` / ``g_step`` split);
16. the demo notebook (main path): every code cell of
   ``notebooks/generate_and_listen_torch.ipynb`` not tagged ``display``,
   in order in one namespace, from the notebook's directory (as Jupyter
   runs it), with ``DEVICE = "cuda"`` (the zoo pair,
   ``GraphedPipeline``: ``generate`` on 4 clips, the mel, the STFT
   distance, ``generate_long`` of 8 patches, 6 interpolated clips and the
   drifting walk): shapes, finite outputs, no log-mel launch, the clips
   bit for bit with ``generate`` run eagerly; seconds per cell;
17. the anti-aliased SnakeBeta kernel (``csrc/aa_act.cu``, main path of
   BigVGAN's G): ``aa_snake_beta`` forward and backward at
   ``AA_ACT_SHAPES`` (BigVGAN's six at batch 32) in bf16, y, x's, alpha's
   and beta's gradients against the plain version in float64 on the same
   inputs within the card test's bounds (``AA_ACT_FP32_FACTOR``, ...); the
   kernels' device-only times beside their bounds from bytes and the plain
   version's (``aa_act_times``); and one replay of a graphed BigVGAN
   stage-2 step (batch 2, published widths), its launch counts set to 0
   just before: 109 activations and 327 kernel launches;
18. the grouped convolution kernels (``csrc/grouped_conv.cu``, main path
   of the MSD's grouped layers over ``dense_groups_max_g``):
   ``GroupedConv`` forward and backward at ``GROUPED_CONV_SHAPES`` in
   bf16, y and the input's, kernel's and bias's gradients against float64
   within the card test's bound (``GROUPED_CONV_FACTOR`` times cuDNN's own
   error, ...); the kernels' device-only times beside their bounds and
   cuDNN's (``grouped_conv_times``); and one replay of the flagship's
   graphed stage-2 step (batch 2), its launch count set to 0 just before:
   90 launches;
11. the ``kernels`` JSON line (printed after phase 18).

On the card the entry points replay CUDA graphs (``_graphs.py``): phases
3-4 (copy-synthesis, serving), 5, 6 (the single-process stage-2 step and
its card-vs-CPU check), 7 (the single-process stage-1 step), 8 (both
training CLIs, the exported pair's service), 9 (every service, its
buckets and streams, ``/reload``'s new service), 10 (``eval_checkpoint``,
``vocode``, ``generate``), 12 (the NCCL ranks' DP steps, the
single-process reference steps, seqshard), 13's ``eval_checkpoint --run``
and deployment artifacts, 14 (every scenario but the host clip and the
kernel's own) and 16 run through them; the gloo ranks' DP steps, the
traced steps and the kernel's own checks launch eagerly. Every busy
share printed is the union of the device's activity intervals over the
window (``utils.profiling.device_busy``: overlapping kernels count once),
beside the summed kernel time. A graph's warm-up and capture build it and
count no kernel launch; each replay counts the launches its capture
recorded.

The launch counts are set to 0 just before phases 3-4 and read just after,
and again around each of phases 6, 7, 8, 9, 10, 14, 15, 16, 17 and 18 (and around phase
10's ``eval_checkpoint --run``) and around phase 13's ``extract_features``
and ``eval_stage1``; phase 12's ranks read theirs around their steps.
Any failed check raises, so the exit code is non-zero and no result line is
printed. The last line is ``{"ok": true, "device": {...}}``.
Needs a CUDA card; exits non-zero without one. Starts no process other than
nvcc, g++, nvidia-smi and phase 12's ranks (which it joins: a rank that fails
stops the others and fails the phase); phase 9's server and coalescer
threads are shut down before it ends, and the CLIs' batch-prefetch threads
end with each CLI.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import io
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # tensor cores, dense
PEAK_BYTES_PER_S = 3.35e12
TOL = {"exact": 2e-4, "fast": 2e-2}

# The default-path checks' inputs are fixed, whatever --seed says, so that
# their tolerances can be set before a card run: the CPU's own max abs gap
# between bf16 and fp32 on the same input and weights, as
# `python3 chip_smoke.py --cpu-gaps` printed it (x86-64 CPU, PyTorch
# 2.13.0+cpu), times a factor.
DEFAULT_PATH_SEED = 1017
CPU_GAPS = {"copy_wav": 0.02714693546295166,
            "copy_distance": 0.00685429573059082,
            "serve_wav": 0.030373774468898773}
# Copy-synthesis, bf16 on the card against fp32 on the CPU: the card's
# cuDNN and the CPU round to bf16 at different places (the same size of
# error, not the same errors), so up to twice the CPU's own gap.
# Serving, fp32 with TF32 convolutions on the card: TF32 keeps three more
# mantissa bits than bf16 and rounds only the convolutions' inputs, so its
# gap should be well under the CPU's bf16 gap: held to that gap, once.
GAP_FACTOR = {"copy": 2.0, "serve": 1.0}

# Training step, card (fp32, cuDNN and matmul TF32 off, "exact" log-mel)
# against the CPU (fp32), from a state whose D gives logits well away from 0
# (``he_gain_d``) and whose D update is continuous in the gradient
# (``warm_second_moment``): |card - cpu| <= rtol * |cpu|, per metric kind.
# On an H100 the largest gaps were 1.27e-5 on the losses (d_r1) and
# 9.48e-5 on the gradient norms (d_grad_norm), and the same step with TF32
# on was 3.2e-4 off in d_loss, 3.8e-4 in d_r1 and 3.2e-4 in g_adv
# (PERF.md): the tolerances are about four and three times the fp32
# gaps, and the TF32 step must fail them (``check_training_on_cpu``).
TRAIN_TOL = {"loss": 5e-5, "grad_norm": 3e-4}
# The flagship D's output gains for that check: MSD logits of 0.1-0.3, MRD
# logits near 1e-3 (their R1, through log|S|, would otherwise reach 1e7);
# R1 is then about 75 and the hinge terms about 12 of d_loss.
TRAIN_D_OUT_GAIN = {"msd": 2.0 ** 0.5, "mrd": 1e-3}
TRAIN_LOSSES = ("d_loss", "g_loss", "g_rms_ratio", "g_adv", "g_fm", "g_stft",
                "d_r1")
TRAIN_GRAD_NORMS = ("d_grad_norm", "g_grad_norm")

# Stage-1 training step at full width, card (fp32, cuDNN and matmul TF32
# off) against the CPU (fp32), from a D with He gains and its output gain at
# STAGE1_D_OUT_GAIN (logits of order 0.5: g_adv about -0.6, R1 about 2.2 of
# a d_loss of 4.1 on the CPU) and Adam's second moment at 1:
# |card - cpu| <= rtol * |cpu|, per metric kind. On an H100 the largest
# gaps were 1.15e-7 on the losses (d_loss) and 2.88e-5 on the gradient
# norms (d_grad_norm), and the same step with TF32 on was 9.2e-5 off in
# d_loss, 1.8e-4 in d_r1 and 6.9e-4 in g_grad_norm (PERF.md): the
# tolerances are about nine and three and a half times the fp32 gaps, and
# the TF32 step must fail them (``check_stage1_on_cpu``).
STAGE1_TOL = {"loss": 1e-6, "grad_norm": 1e-4}
STAGE1_D_OUT_GAIN = 0.5
STAGE1_LOSSES = ("d_loss", "g_loss", "g_rms_ratio", "g_adv", "g_fm", "g_flux",
                 "d_r1")

# Phase 9: audio that two fp32 paths compute on the card with cuDNN's TF32
# off (the stream against generate_long, coalesced clips against solo ones:
# other batch sizes, so other cuDNN algorithms), max abs difference: the
# card-vs-CPU fp32 gate of phase 5.
FP32_TOL = 2e-3

# Phase 10: the JAX package's own copy-synthesis eval of the zoo flagship
# (its vocoder in the card's bf16, as here) on the regenerated rich corpus,
# on an x86-64 CPU (jax 0.9.0, numpy 2.0.2; eval.json's per_clip):
#   python scripts/make_corpus.py --out C --clips 256 --seconds 30 --seed 0
#   JAX_PLATFORMS=cpu python scripts/eval_checkpoint.py --zoo vocoder_istft \
#       --corpus C --head istft --gl-anchor --gl-refine 8
EVAL_JAX_CPU = {
    "dist": [1.5284101963043213, 1.2366943359375, 1.5259073972702026,
        1.110978126525879, 1.1843135356903076, 1.2159274816513062,
        1.194472074508667, 1.130416989326477],
    "jitter": [1.2368292808532715, 1.3526853322982788, 3.087221622467041,
        1.479310154914856, 1.4204399585723877, 1.9051101207733154,
        1.1029548645019531, 1.4853744506835938],
    "mcd_db": [75.4854507446289, 50.08938980102539, 58.08373260498047,
        44.11587142944336, 45.49138641357422, 39.875144958496094,
        50.55168533325195, 47.758270263671875],
    "rms_ratio": [0.8434630036354065, 0.8791916966438293, 0.5744284987449646,
        0.8754728436470032, 0.8477376103401184, 0.8524762988090515,
        0.9220963716506958, 0.889865517616272],
    "gl_dist": [2.1055686473846436, 1.7996124029159546, 1.9912450313568115,
        1.5716705322265625, 1.5420222282409668, 1.3408966064453125,
        1.4462575912475586, 1.1590943336486816],
}
# Tolerance per clip and metric (|card - EVAL_JAX_CPU|): the CPU's own max
# gap over the 8 clips between the port's eval in bf16 and in fp32 on that
# corpus (`python3 chip_smoke.py --cpu-gaps`, PyTorch 2.13.0+cpu) times 2,
# as GAP_FACTOR["copy"]: the card's bf16 and the CPU's round at different
# places. Griffin-Lim runs no bf16, so gl_dist's gap is the port's eval on
# the CPU (`python -m music_synthesis_tpu_torch.scripts.eval_checkpoint
# --device cpu`, same flags) against the JAX one, times 4: 48 iterations
# turn the two packages' rounding into two phase trajectories, and the
# card's cuFFT rounds differently again.
EVAL_CPU_GAPS = {"dist": 0.09899640083312988, "jitter": 0.015469074249267578,
                 "mcd_db": 1.4188690185546875,
                 "rms_ratio": 0.0012016892433166504,
                 "gl_dist": 0.002544999122619629}
EVAL_GAP_FACTOR = {"dist": 2.0, "jitter": 2.0, "mcd_db": 2.0, "rms_ratio": 2.0,
                   "gl_dist": 4.0}
EVAL_TOL = {k: EVAL_GAP_FACTOR[k] * v for k, v in EVAL_CPU_GAPS.items()}

# Phase 14: the n-call runs of the bench's scenarios, cut to a few calls at
# full width (the kernel-vs-plain scenario's calls take about 0.1 ms, so it
# keeps enough of them to stand above the host clock's noise).
BENCH_SMOKE_ITERS = {"bench_inference_rtf": 5, "bench_waveform_head": 5,
                     "bench_refined_rtf": 5, "bench_stage2_step": 3,
                     "bench_stage1_fwd_loss": 5, "bench_frontend_cpu_clip": 3,
                     "bench_frontend_ab": 50}
# bench_rtf_batch's --calls at batch 16 for about a second per timed run.
BENCH_SWEEP_CALLS = 100


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, samples: int = 21, reps: int = 10, warmup: int = 5) -> float:
    """Device time of one ``fn()`` in ms, after ``warmup`` calls: the median
    over ``samples`` samples, each a pair of CUDA events around ``reps``
    calls issued back to back (so the host's launch overhead hides behind
    the device's work), divided by ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def graph_time_ms(fn, samples: int = 21, reps: int = 10,
                  warmup: int = 3) -> float:
    """Device time of one ``fn()`` in ms with no host work in the window:
    after ``warmup`` eager calls (which fill the caches), ``reps`` calls
    captured in one CUDA graph, whose replay is timed by a pair of CUDA
    events; the median over ``samples`` replays, divided by ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(times))


def logmel_bound_ms(batch: int, padded_len: int, n_frames: int, cfg) -> dict:
    """Least times for one fused log-mel call on an H100, each the larger
    of operations over a peak rate and bytes over HBM bandwidth:
    ``ffma_ms`` counts every operation in fp32 FFMA; ``tc_ms`` counts the
    rDFT and mel GEMMs as three TF32 tensor-core passes (the least an
    fp32-accurate product takes on the tensor cores). ``bound_ms`` and
    ``bound_by`` are the tensor-core bound's."""
    from music_synthesis_tpu_torch.ops.logmel import logmel_gemm_flops

    n_bins = cfg.n_fft // 2 + 1
    rows = batch * n_frames
    gemm = logmel_gemm_flops(batch, n_frames, cfg)  # frames @ [C | S], @ mel
    flops = (gemm
             + 3 * rows * n_bins                         # re^2 + im^2
             + 2 * rows * cfg.n_mels)                    # log(eps + .)
    nbytes = 4 * (batch * padded_len                    # wav, read once
                  + 2 * cfg.n_fft * n_bins              # bases
                  + n_bins * cfg.n_mels                 # mel matrix
                  + rows * cfg.n_mels)                  # output
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ffma = flops / PEAK_FP32_FLOPS
    t_tc = 3 * gemm / PEAK_TF32_FLOPS
    return {"ffma_ms": 1e3 * max(t_ffma, t_bytes),
            "ffma_by": "operations" if t_ffma >= t_bytes else "bytes",
            "bound_ms": 1e3 * max(t_tc, t_bytes),
            "bound_by": "operations" if t_tc >= t_bytes else "bytes"}


def test_audio(rng: np.random.Generator, batch: int, length: int,
               sample_rate: int) -> np.ndarray:
    """Harmonic tones with attack/decay envelopes plus a little noise."""
    t = np.arange(length) / sample_rate
    out = np.zeros((batch, length), np.float64)
    for b in range(batch):
        for _ in range(3):
            f0 = rng.uniform(80.0, 800.0)
            onset = rng.uniform(0.0, 0.5) * t[-1]
            env = np.where(t >= onset, np.exp(-(t - onset) * rng.uniform(1.0, 6.0)), 0.0)
            env *= 1.0 - np.exp(-np.maximum(t - onset, 0.0) * 200.0)
            for h in range(1, 7):
                if f0 * h < sample_rate / 2:
                    out[b] += env * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi)) / h
        out[b] += 0.01 * rng.standard_normal(length)
        out[b] *= 0.5 / max(np.abs(out[b]).max(), 1e-6)
    return out.astype(np.float32)


def profile_launches(fn, calls: int = 3) -> dict:
    """Kernel launches and kernel time (the summed time of the device's
    kernels, copies and sets) per ``fn()`` call, and the device's busy
    share of the window (the union of those activities' intervals,
    ``utils.profiling.device_busy``), from ``torch.profiler`` over
    ``calls`` calls after a synchronise (the profiler adds host time to
    every launch, so the window is longer than an unprofiled one)."""
    from torch.profiler import ProfilerActivity, profile

    from music_synthesis_tpu_torch.utils.profiling import (device_busy,
                                                           device_events)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    return {"launches_per_call": sum(e.count for e in events) / calls,
            "kernel_ms_per_call": device_us / calls / 1e3,
            "profiled_wall_ms_per_call": 1e3 * wall / calls,
            "device_busy": device_busy(prof, wall)}


def card_name_and_power() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def phase_build():
    """Builds ``csrc/logmel.cu`` (nvcc) and ``csrc/msynth_io.cc`` (g++), the
    two compilers started together; returns the kernel's result."""
    from concurrent.futures import ThreadPoolExecutor

    from music_synthesis_tpu_torch import _build

    with ThreadPoolExecutor(2) as pool:
        results = list(pool.map(_build.build, ("logmel", "msynth_io")))
    for r in results:
        log(f"[build] {r.name}: {r.seconds:.2f} s -> {r.library}")
        for line in r.ptxas:
            log(f"[build]   {line}")
    result = results[0]
    result_native = results[1]
    log(card_name_and_power())
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "fp32 GEMMs must not run in TF32 (the plain versions assume it)")
    return result, result_native


KERNEL_SHAPES = ((16, 8192), (16, 88064), (4, 88064), (1, 8192), (1, 88064))


def kernel_cases() -> list:
    """Phase 2's cases, (shape, power, n_mels, variant): every shape the
    main path gives the kernel, both variants and powers at the three
    large ones, 160 mels."""
    cases = [(shape, power, 128, variant)
             for shape in KERNEL_SHAPES[:3]
             for power in (2.0, 1.0)
             for variant in ("for_vocoder", "log_mel")]
    cases.append(((16, 8192), 2.0, 160, "for_vocoder"))
    cases.append(((1, 8192), 2.0, 128, "for_vocoder"))  # stage-2 audio dumps
    cases.append(((1, 88064), 2.0, 128, "for_vocoder"))  # one 4 s eval clip
    return cases


def kernel_case(L, audio: dict, rng: np.random.Generator, shape, power: float,
                n_mels: int, variant: str) -> tuple:
    """The case's padded input, frame count, config, and each precision's
    max abs error against the plain version evaluated in float64 (checked
    against ``TOL``), and the plain version's own in fp32."""
    from music_synthesis_tpu_torch.config import FrontendConfig

    if shape not in audio:
        audio[shape] = torch.from_numpy(test_audio(rng, *shape, 22050)).cuda()
    wav = audio[shape]
    cfg = FrontendConfig(power=power, n_mels=n_mels)
    fused = (L.fused_log_mel_for_vocoder if variant == "for_vocoder"
             else L.fused_log_mel)
    # The plain version on the same padded input, in float64: the exact
    # answer to the kernel's fp32 arithmetic. (In fp32 on the card its
    # cuBLAS GEMM changes summation order with the batch: at [1, 88064]
    # it is 2.4e-4 from the float64 answer, the kernel 8.5e-5.)
    padded, n_frames = L.padded_input(wav, cfg, variant == "for_vocoder")
    want = L.log_mel_frames_plain(padded.double(), cfg, n_frames)
    plain_err = (L.log_mel_frames_plain(padded, cfg, n_frames).double()
                 - want).abs().max().item()
    errs = {}
    for mode in ("exact", "fast"):
        got = fused(wav, cfg, mode)
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"shape {got.shape} vs {want.shape}")
        err = (got.double() - want).abs().max().item()
        check(np.isfinite(err) and err <= TOL[mode],
              f"log-mel kernel {shape} {variant} power={power} "
              f"n_mels={n_mels} {mode}: max abs err {err} > {TOL[mode]}")
        errs[mode] = err
    return padded, n_frames, cfg, errs, plain_err, want


def check_sass(library: Path, ptxas: tuple) -> dict:
    """The built kernel's instructions: the "fast" path's ``wgmma``
    (``HGMMA``) and TMA loads (``UTMALDG``) must be in the library's SASS
    (``cuobjdump -sass``), and ptxas must report no spill bytes."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass))
              for op in ("HGMMA", "UTMALDG", "HMMA")}
    spills = [int(n) for line in ptxas
              for n in re.findall(r"(\d+) bytes spill", line)]
    log(f"[build] SASS of {library.name}: {counts}; spill bytes {sum(spills)}")
    check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
          "the fast path's kernel has no wgmma or no TMA load in its SASS")
    check(counts["HMMA"] == 0, "an mma.sync product is left in the library")
    check(not any(spills), f"ptxas spilled: {spills}")
    return counts


def phase_kernel_vs_plain(rng: np.random.Generator) -> dict:
    from music_synthesis_tpu_torch.ops import logmel as L

    worst = {"exact": 0.0, "fast": 0.0}
    rows = []
    audio = {}
    for shape, power, n_mels, variant in kernel_cases():
        padded, n_frames, cfg, errs, plain_err, want = kernel_case(
            L, audio, rng, shape, power, n_mels, variant)
        for mode in worst:
            worst[mode] = max(worst[mode], errs[mode])
        # Time both kernel paths and the plain version (fp32) on the same
        # padded input (padding is outside all three), under both timers.
        calls = {
            "ms": lambda: L.logmel_kernel(padded, cfg, n_frames, "fast"),
            "ms_exact": lambda: L.logmel_kernel(padded, cfg, n_frames, "exact"),
            "plain_ms": lambda: L.log_mel_frames_plain(padded, cfg, n_frames)}
        times = {key: time_ms(fn) for key, fn in calls.items()}
        times.update({f"{key}_device": graph_time_ms(fn)
                      for key, fn in calls.items()})
        bound = logmel_bound_ms(shape[0], padded.shape[1], n_frames, cfg)
        split_ms, split_err, pick = {}, {}, None
        if variant == "for_vocoder" and power == 2.0 and n_mels == 128:
            # Each of the "fast" path's launch choices, forced (the
            # launcher's table rests on these times): its error, and its
            # time under the host timer and on the device alone.
            pick = L.logmel_kernel.launcher_split(shape[0], n_frames, cfg,
                                                  padded.device)
            for split in L.SPLITS:
                def one(split=split):
                    return L.logmel_kernel(padded, cfg, n_frames, "fast",
                                           split=split)
                split_err[split] = (one().double() - want).abs().max().item()
                check(split_err[split] <= TOL["fast"],
                      f"fast split {split} at {shape}: max abs err "
                      f"{split_err[split]} > {TOL['fast']}")
                split_ms[split] = (time_ms(one), graph_time_ms(one))
            log(f"[kernel]   fast by K split (the launcher's: {pick}; err, ms "
                "under the host timer / device): " + ", ".join(
                    f"{k}: {split_err[k]:.3g}, {a:.4f} / {b:.4f}"
                    for k, (a, b) in split_ms.items()))
        ms, ms_device = times["ms"], times["ms_device"]
        rows.append(dict(shape=list(shape), variant=variant, power=power,
                         n_mels=n_mels, max_abs_err=errs,
                         plain_fp32_err=plain_err, **times, **bound,
                         bound_share=bound["bound_ms"] / ms,
                         bound_share_device=bound["bound_ms"] / ms_device,
                         ffma_share=bound["ffma_ms"] / ms, split=pick,
                         split_ms=split_ms, split_err=split_err))
        log(f"[kernel] logmel {list(shape)} {variant} power={power:g} "
            f"mels={n_mels}: err exact {errs['exact']:.3g} fast "
            f"{errs['fast']:.3g} (plain fp32 {plain_err:.3g}); host timer / "
            f"device: fast (3xTF32) {ms:.4f} / {ms_device:.4f} ms, exact "
            f"(FFMA) {times['ms_exact']:.4f} / {times['ms_exact_device']:.4f} "
            f"ms, plain {times['plain_ms']:.4f} / "
            f"{times['plain_ms_device']:.4f} ms; bound "
            f"{bound['bound_ms']:.4f} ms (3xTF32, {bound['bound_by']}), "
            f"share {bound['bound_ms'] / ms:.3f} / "
            f"{bound['bound_ms'] / ms_device:.3f}; FFMA bound "
            f"{bound['ffma_ms']:.4f} ms, share {bound['ffma_ms'] / ms:.3f}")
    return {"worst": worst, "rows": rows}


def kernel_times(seed: int) -> dict:
    """The log-mel kernel of the importable package (``--tree``): phase 2's
    errors at every case (the same audio for the same seed), and at
    ``KERNEL_SHAPES`` (vocoder variant, power 2, 128 mels) both paths'
    times under both timers, the launcher's choices; the anti-aliased
    SnakeBeta kernel's (``aa_act_times``) and the grouped convolution
    kernels' times (``grouped_conv_times``). For holding two trees against
    each other in one session on one card."""
    from music_synthesis_tpu_torch import _build
    from music_synthesis_tpu_torch.ops import logmel as L

    built = _build.build("logmel")
    rng = np.random.default_rng(seed)
    audio, worst, times = {}, {"exact": 0.0, "fast": 0.0}, {}
    for shape, power, n_mels, variant in kernel_cases():
        padded, n_frames, cfg, errs, _, _ = kernel_case(
            L, audio, rng, shape, power, n_mels, variant)
        for mode in worst:
            worst[mode] = max(worst[mode], errs[mode])
        if shape in KERNEL_SHAPES and variant == "for_vocoder" \
                and power == 2.0 and n_mels == 128:
            row = {}
            for mode in ("fast", "exact"):
                def one(mode=mode):
                    return L.logmel_kernel(padded, cfg, n_frames, mode)
                row[mode] = time_ms(one)
                row[f"{mode}_device"] = graph_time_ms(one)
            times[str(list(shape))] = row
    return {"package": str(Path(L.__file__).resolve().parents[1]),
            "build_s": built.seconds, "ptxas": list(built.ptxas),
            "worst": worst, "times": times, "aa_act": aa_act_times(seed),
            "grouped_conv": grouped_conv_times(seed),
            "card": card_name_and_power()}


# The MSD's grouped layers that the benchmark's cells run on the grouped
# convolution kernels, as (batch, groups, ci, co, kernel, stride, padded
# length): D's both-batch pass at scale 0 of each layer (groups 64 in the
# flagship, 256 in every cell) and BigVGAN's [64, ...] pass.
GROUPED_CONV_SHAPES = ((32, 64, 4, 16, 41, 4, 552), (32, 64, 4, 16, 41, 4, 168),
                       (32, 256, 4, 4, 41, 4, 168), (32, 256, 4, 4, 41, 4, 72),
                       (16, 256, 4, 4, 41, 4, 168), (64, 256, 4, 4, 41, 4, 168))


def grouped_conv_times(seed: int) -> dict | None:
    """The grouped convolution kernels (``csrc/grouped_conv.cu``) of the
    importable package at ``GROUPED_CONV_SHAPES`` in bf16, the kernel as
    ``WNConv`` hands it: device-only times (``graph_time_ms``) of the
    forward (with bias), the input gradient and the weight and bias
    gradients (both launches), each beside its least time (the larger of
    its bytes, each operand read once and the result written once, at 3.35
    TB/s and its FLOPs in fp32 FFMA at 67 TFLOP/s) and beside cuDNN's time
    for the same call (``library_ms``: ``F.conv1d`` and aten's
    ``convolution_backward``, a yardstick the port never calls). None when
    the package has no such kernels."""
    import torch.nn.functional as F

    from music_synthesis_tpu_torch import _build

    try:
        from music_synthesis_tpu_torch.ops import grouped_conv as gc
    except ImportError:
        return None
    built = _build.build("grouped_conv")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    aten = torch.ops.aten
    rows = {}
    for batch, groups, ci, co, k, s, length in GROUPED_CONV_SHAPES:
        conv = gc.Conv(batch, groups, ci, co, k, s, length)
        bf16 = torch.bfloat16
        x = torch.randn(batch, groups * ci, length, generator=gen,
                        device="cuda").to(bf16)
        w = (0.05 * torch.randn(k, ci, groups * co, generator=gen,
                                device="cuda")).to(bf16).permute(2, 1, 0)
        b = torch.randn(groups * co, generator=gen, device="cuda").to(bf16)
        gy = torch.randn(batch, groups * co, conv.out, generator=gen,
                         device="cuda").to(bf16)
        args = ([s], [1], groups)
        calls = {
            "fwd": lambda: gc.forward(x, w, b, *args),
            "dgrad": lambda: gc.input_grad(gy, w, length, *args),
            "wgrad": lambda: gc.weight_grad(gy, x, w.shape, *args, True,
                                            True),
            "library_fwd": lambda: F.conv1d(x, w, b, stride=s, groups=groups),
            "library_dgrad": lambda: aten.convolution_backward(
                gy, x, w, None, [s], [0], [1], False, [0], groups,
                [True, False, False]),
            "library_wgrad": lambda: aten.convolution_backward(
                gy, x, w, [groups * co], [s], [0], [1], False, [0], groups,
                [False, True, True])}
        row = {f"{key}_ms": graph_time_ms(fn) for key, fn in calls.items()}
        sizes = {"x": x.numel(), "y": gy.numel(), "w": w.numel()}
        moved = {"fwd": sizes["x"] + sizes["w"] + sizes["y"],
                 "dgrad": sizes["y"] + sizes["w"] + sizes["x"],
                 "wgrad": sizes["x"] + sizes["y"] + sizes["w"]}
        for key, elems in moved.items():
            bound = max(2 * elems / PEAK_BYTES_PER_S,
                        conv.flops / PEAK_FP32_FLOPS) * 1e3
            row[f"{key}_bound_ms"] = bound
            row[f"{key}_share"] = bound / row[f"{key}_ms"]
        rows[str([batch, groups * ci, length, groups])] = row
        log(f"[grouped_conv] x [{batch}, {groups * ci}, {length}] groups "
            f"{groups}, bf16, device only: " + ", ".join(
                f"{key} {row[f'{key}_ms']:.4f} ms (bound "
                f"{row[f'{key}_bound_ms']:.4f}, share "
                f"{row[f'{key}_share']:.3f}; cuDNN "
                f"{row[f'library_{key}_ms']:.4f})"
                for key in ("fwd", "dgrad", "wgrad")))
    return {"build_s": built.seconds, "ptxas": list(built.ptxas),
            "shapes": rows}


# BigVGAN's six anti-aliased SnakeBeta shapes at the benchmark's batch.
AA_ACT_SHAPES = ((32, 768, 128), (32, 384, 512), (32, 192, 1024),
                 (32, 96, 2048), (32, 48, 4096), (32, 24, 8192))
# The inputs x of the sets a timed call cycles through, at least: twice the
# H100's 50 MB L2, so that each call finds its data cold.
AA_ACT_COLD_BYTES = 100e6


def aa_act_times(seed: int) -> dict | None:
    """The anti-aliased SnakeBeta kernel (``csrc/aa_act.cu``) of the
    importable package at ``AA_ACT_SHAPES`` in bf16: device-only times
    (``graph_time_ms``) of the forward and the backward (x's, alpha's and
    beta's gradients, the sums' launch included), each beside its least
    time from bytes at 3.35 TB/s (forward: x read, y written; backward: x
    and gy read, gx written) and beside the plain version's time (the
    backward's: its recompute and autograd). Each call reads another of
    several input sets, together over ``AA_ACT_COLD_BYTES``. None when the
    package has no such kernel."""
    from music_synthesis_tpu_torch import _build
    from music_synthesis_tpu_torch.ops import alias_free as af

    if not hasattr(af, "aa_act_kernel"):
        return None
    built = _build.build("aa_act")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for shape in AA_ACT_SHAPES:
        n = int(np.prod(shape))
        n_sets = max(1, int(np.ceil(AA_ACT_COLD_BYTES / (2 * n))))
        sets = [tuple(torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2)) for _ in range(n_sets)]
        a, b = (0.3 * torch.randn(shape[1], generator=gen, device="cuda")
                for _ in range(2))
        turn = iter(range(10 ** 9))

        def pick():
            return sets[next(turn) % n_sets]

        def backward():
            x, gy = pick()
            return af._backward_cuda(x, a, b, gy, (True, True, True))

        def plain_backward():
            x, gy = pick()
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (x, a, b)]
                y = af._forward(*leaves)
                return torch.autograd.grad(y, leaves, gy.float())

        calls = {
            "fwd": lambda: af._forward_cuda(pick()[0], a, b),
            "bwd": backward,
            "plain_fwd": lambda: af._forward(pick()[0], a, b).to(
                torch.bfloat16),
            "plain_bwd": plain_backward}
        row = {f"{k}_ms": graph_time_ms(fn) for k, fn in calls.items()}
        row["fwd_bound_ms"] = 2 * 2 * n / PEAK_BYTES_PER_S * 1e3
        row["bwd_bound_ms"] = 3 * 2 * n / PEAK_BYTES_PER_S * 1e3
        for k in ("fwd", "bwd"):
            row[f"{k}_roofline"] = row[f"{k}_bound_ms"] / row[f"{k}_ms"]
        t = af.tiling(shape[0] * shape[1], shape[2], af._n_sm(a.device))
        row["tiles"] = [t.rows_per_block, t.span, t.blocks]
        rows[str(list(shape))] = row
        log(f"[aa_act] {list(shape)} bf16, device only: forward "
            f"{row['fwd_ms']:.4f} ms (bound {row['fwd_bound_ms']:.4f}, "
            f"{row['fwd_roofline']:.3f}; plain {row['plain_fwd_ms']:.4f}), "
            f"backward {row['bwd_ms']:.4f} ms (bound "
            f"{row['bwd_bound_ms']:.4f}, {row['bwd_roofline']:.3f}; plain "
            f"{row['plain_bwd_ms']:.4f}); tiles {row['tiles']}")
    return {"build_s": built.seconds, "ptxas": list(built.ptxas),
            "shapes": rows}


# tests/test_torch_aa_act_gpu.py's bounds: the kernel's max abs error may be
# this many times the plain version's in fp32 (both against float64), plus
# AA_ACT_FP32_FLOOR of the largest magnitude; a bf16 output also half a
# bf16 unit of its value, elementwise.
AA_ACT_FP32_FACTOR, AA_ACT_FP32_FLOOR, AA_ACT_BF16_HALF_UNIT = 4.0, 1e-6, 2.0 ** -8


def aa_act_errors(seed: int) -> dict:
    """``aa_snake_beta`` (the public wrapper, so the kernel launched as
    the model launches it) forward and backward at ``AA_ACT_SHAPES`` in
    bf16: y and the gradients of x, alpha and beta against the plain
    version evaluated in float64 on the same inputs (cuDNN's TF32 off),
    each within its bound (``AA_ACT_FP32_FACTOR``); per shape and output
    the max abs error and its bound."""
    from music_synthesis_tpu_torch.ops import alias_free as af

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, worst = {}, 0.0
    for shape in AA_ACT_SHAPES:
        x, gy = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        a, b = (0.3 * torch.randn(shape[1], generator=gen, device="cuda")
                for _ in range(2))

        def plain(dtype):
            leaves = [t.detach().to(dtype).requires_grad_() for t in (x, a, b)]
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                y = af._forward(*leaves)
                grads = torch.autograd.grad(y, leaves, gy.to(dtype))
            return [y.detach(), *grads]

        want, fp32 = plain(torch.float64), plain(torch.float32)
        before = af.aa_act_kernel.n_calls
        leaves = [t.detach().requires_grad_() for t in (x, a, b)]
        y = af.aa_snake_beta(*leaves)
        got = [y.detach(), *torch.autograd.grad(y, leaves, gy)]
        torch.cuda.synchronize()
        check(af.aa_act_kernel.n_calls - before == 3,
              f"aa_snake_beta at {list(shape)} did not launch the kernel "
              f"three times (forward, backward, sums)")
        row = {}
        for name, g, p, w in zip(("y", "gx", "ga", "gb"), got, fp32, want):
            err = float((g.double() - w).abs().max())
            tol = (AA_ACT_FP32_FACTOR * float((p.double() - w).abs().max())
                   + AA_ACT_FP32_FLOOR * float(w.abs().max()))
            if name in ("y", "gx"):
                over = float(((g.double() - w).abs() - AA_ACT_BF16_HALF_UNIT
                              * w.abs() - 2 * tol).max())
            else:
                over = err - tol
            check(bool(torch.isfinite(g).all()) and over <= 0,
                  f"aa_snake_beta's {name} at {list(shape)} bf16 is off the "
                  f"plain version by {err:.3g} (over its bound by {over:.3g})")
            row[name] = {"max_abs_err": err, "fp32_tol": tol}
            worst = max(worst, err)
        rows[str(list(shape))] = row
        log(f"[aa_act] {list(shape)} bf16 against float64: " + ", ".join(
            f"{k} {v['max_abs_err']:.3g} (fp32 tol {v['fp32_tol']:.3g})"
            for k, v in row.items()))
    return {"max_abs_err": worst, "shapes": rows}


def aa_act_step_launches(rng: np.random.Generator) -> dict:
    """One replay of the graphed stage-2 step of ``BIGVGAN_22K_80BAND`` at
    batch 2 (the published widths): the activation's calls and its kernel's
    launches, both counts set to 0 just before the replay."""
    from music_synthesis_tpu_torch import config
    from music_synthesis_tpu_torch.ops import alias_free as af
    from music_synthesis_tpu_torch.train import stage2
    from music_synthesis_tpu_torch.train.state import drop_graphed_steps

    base = config.BIGVGAN_22K_80BAND
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, batch_size=2))
    state = stage2.make_train_state(cfg, seed=DEFAULT_PATH_SEED,
                                    device="cuda")
    wav = torch.from_numpy(test_audio(rng, 2, cfg.train.segment_length,
                                      cfg.frontend.sample_rate)).cuda()
    state, _ = stage2.train_step(cfg, state, wav)  # builds the graph
    af.aa_act.n_calls = af.aa_act_kernel.n_calls = 0
    state, metrics = stage2.train_step(cfg, state, wav)
    out = {"acts": af.aa_act.n_calls, "launches": af.aa_act_kernel.n_calls,
           "finite": all(np.isfinite(v) for v in metrics.values())}
    del state
    drop_graphed_steps()
    torch.cuda.empty_cache()
    log(f"[aa_act] one graphed BigVGAN step (batch 2): {out['acts']} "
        f"activations, {out['launches']} kernel launches")
    check(out["acts"] == 109 and out["launches"] == 3 * 109
          and out["finite"],
          "a graphed BigVGAN step did not launch the activation's kernel "
          "three times for each of its 109 activations")
    return out


def phase_aa_act(rng: np.random.Generator, seed: int) -> dict:
    """Phase 17: the anti-aliased SnakeBeta kernel against the plain
    version, its times, and its launches in a graphed BigVGAN step."""
    errors = aa_act_errors(seed)
    times = aa_act_times(seed)
    step = aa_act_step_launches(rng)
    return {"errors": errors, "times": times, "step": step}


def aa_act_kernel_entry(aa: dict) -> dict:
    """The ``kernels`` line's entry of ``csrc/aa_act.cu`` from phase 17:
    times at the largest row count's shape, [32, 24, 8192] (forward plus
    backward, device only), errors over every shape."""
    shape = str(list(AA_ACT_SHAPES[-1]))
    t = aa["times"]["shapes"][shape]
    return {
        "name": "aa_act",
        "route": "cuda",
        "source": "music_synthesis_tpu_torch/csrc/aa_act.cu",
        "replaces": None,
        "launches": aa["step"]["launches"],
        "max_abs_err": aa["errors"]["max_abs_err"],
        "ms": t["fwd_ms"] + t["bwd_ms"],
        "plain_ms": t["plain_fwd_ms"] + t["plain_bwd_ms"],
        "bound_ms": t["fwd_bound_ms"] + t["bwd_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "ok": True,
        "path": "one launch forward; backward and the parameters' sums",
        "shape": list(AA_ACT_SHAPES[-1]),
        "dtype": "bfloat16",
        "launches_by_path": {"bigvgan_train_step_replay":
                             aa["step"]["launches"]},
        "by_shape": {k: {**{n: v[n] for n in (
            "fwd_ms", "bwd_ms", "plain_fwd_ms", "plain_bwd_ms",
            "fwd_bound_ms", "bwd_bound_ms")},
            "max_abs_err": max(e["max_abs_err"] for e in
                               aa["errors"]["shapes"][k].values())}
            for k, v in aa["times"]["shapes"].items()},
        "build_s": aa["times"]["build_s"],
        "ptxas": aa["times"]["ptxas"],
    }


# tests/test_torch_grouped_conv_gpu.py's bound: each output's max abs error
# against float64 may be this many times cuDNN's own (TF32 off, the same
# shape and dtype), plus GROUPED_CONV_FLOOR of the largest magnitude.
GROUPED_CONV_FACTOR, GROUPED_CONV_FLOOR = 4.0, 1e-6


def grouped_conv_errors(seed: int) -> dict:
    """``GroupedConv`` (the function the MSD's grouped layers call, so the
    kernels launched as the model launches them) forward and backward at
    ``GROUPED_CONV_SHAPES`` in bf16, the kernel as ``WNConv`` hands it: y
    and the input's, kernel's and bias's gradients against native
    ``F.conv1d`` and aten's ``convolution_backward`` in float64 on the CPU,
    each within ``GROUPED_CONV_FACTOR`` times cuDNN's own error plus
    ``GROUPED_CONV_FLOOR`` of the largest magnitude; four launches a shape.
    Per shape and output the max abs error and its bound."""
    import torch.nn.functional as F

    from music_synthesis_tpu_torch.ops import conv as conv_ops
    from music_synthesis_tpu_torch.ops import grouped_conv as gc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, worst = {}, 0.0
    for batch, groups, ci, co, k, s, length in GROUPED_CONV_SHAPES:
        out = (length - k) // s + 1
        x, gy = (torch.randn(batch, groups * c, n, generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for c, n in ((ci, length), (co, out)))
        w = (torch.randn(k, ci, groups * co, generator=gen, device="cuda")
             / (ci * k) ** 0.5).to(torch.bfloat16).permute(2, 1, 0)
        b = torch.randn(groups * co, generator=gen,
                        device="cuda").to(torch.bfloat16)

        def library(*tensors):
            xs, ws, bs, gys = tensors
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                y = F.conv1d(xs, ws, bs, stride=s, groups=groups)
                grads = torch.ops.aten.convolution_backward(
                    gys, xs, ws, [groups * co], [s], [0], [1], False, [0],
                    groups, [True, True, True])
            return [y, *grads]

        want = library(*(t.double().cpu() for t in (x, w, b, gy)))
        cudnn = library(x, w, b, gy)
        before = gc.grouped_conv_kernel.n_calls
        leaves = [t.detach().requires_grad_() for t in (x, w, b)]
        y = conv_ops.GroupedConv.apply(*leaves, (s,), (1,), groups)
        got = [y.detach(), *torch.autograd.grad(y, leaves, gy)]
        torch.cuda.synchronize()
        check(gc.grouped_conv_kernel.n_calls - before == 4,
              f"GroupedConv at x [{batch}, {groups * ci}, {length}] did not "
              f"launch the kernels four times (forward, input gradient, "
              f"weight partials, finish)")
        row = {}
        for name, g, c, wv in zip(("y", "gx", "gw", "gb"), got, cudnn, want):
            err = float((g.double().cpu() - wv).abs().max())
            tol = (GROUPED_CONV_FACTOR * float((c.double().cpu() - wv).abs()
                                               .max())
                   + GROUPED_CONV_FLOOR * float(wv.abs().max()))
            check(g.shape == wv.shape and bool(torch.isfinite(g).all())
                  and err <= tol,
                  f"the grouped convolution's {name} at x [{batch}, "
                  f"{groups * ci}, {length}] groups {groups} is off float64 "
                  f"by {err:.3g} (bound {tol:.3g})")
            row[name] = {"max_abs_err": err, "tol": tol}
            worst = max(worst, err)
        rows[str([batch, groups * ci, length, groups])] = row
        log(f"[grouped_conv] x [{batch}, {groups * ci}, {length}] groups "
            f"{groups} bf16 against float64: " + ", ".join(
                f"{n} {v['max_abs_err']:.3g} (bound {v['tol']:.3g})"
                for n, v in row.items()))
    return {"max_abs_err": worst, "shapes": rows}


# Launches of the grouped convolution kernels per replay of the flagship's
# graphed stage-2 step (tests/test_torch_grouped_conv_gpu.py's
# STEP_LAUNCHES): 15 for each of the 6 grouped layers and scales.
GROUPED_CONV_FLAGSHIP_LAUNCHES = 90


def grouped_conv_step_launches(rng: np.random.Generator) -> dict:
    """One replay of the graphed stage-2 step of the benchmark's flagship
    configuration (``benchmark/configs/flagship.json``) at batch 2: the
    grouped convolution kernels' launches, the count set to 0 just before
    the replay."""
    from music_synthesis_tpu_torch import config
    from music_synthesis_tpu_torch.ops import grouped_conv as gc
    from music_synthesis_tpu_torch.train import stage2
    from music_synthesis_tpu_torch.train.state import drop_graphed_steps

    raw = json.loads((Path(__file__).resolve().parent / "benchmark"
                      / "configs" / "flagship.json").read_text())
    base = config.config_from_dict(raw["train"])
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, batch_size=2))
    state = stage2.make_train_state(cfg, seed=DEFAULT_PATH_SEED,
                                    device="cuda")
    wav = torch.from_numpy(test_audio(rng, 2, cfg.train.segment_length,
                                      cfg.frontend.sample_rate)).cuda()
    state, _ = stage2.train_step(cfg, state, wav)  # builds the graph
    gc.grouped_conv_kernel.n_calls = 0
    state, metrics = stage2.train_step(cfg, state, wav)
    out = {"launches": gc.grouped_conv_kernel.n_calls,
           "finite": all(np.isfinite(v) for v in metrics.values())}
    del state
    drop_graphed_steps()
    torch.cuda.empty_cache()
    log(f"[grouped_conv] one graphed flagship step (batch 2): "
        f"{out['launches']} kernel launches")
    check(out["launches"] == GROUPED_CONV_FLAGSHIP_LAUNCHES and out["finite"],
          f"a graphed flagship step launched the grouped convolution "
          f"kernels {out['launches']} times, not "
          f"{GROUPED_CONV_FLAGSHIP_LAUNCHES}")
    return out


def phase_grouped_conv(rng: np.random.Generator, seed: int) -> dict:
    """Phase 18: the grouped convolution kernels against float64, their
    times beside their bounds and cuDNN's, and their launches in a graphed
    flagship step."""
    errors = grouped_conv_errors(seed)
    times = grouped_conv_times(seed)
    step = grouped_conv_step_launches(rng)
    return {"errors": errors, "times": times, "step": step}


def grouped_conv_kernel_entry(gcv: dict) -> dict:
    """The ``kernels`` line's entry of ``csrc/grouped_conv.cu`` from phase
    18: times at the group-256 layer's scale 0 in the flagship's D pass,
    x [32, 1024, 168] (forward, input gradient, weight and bias gradients,
    device only), beside cuDNN's for the same calls; errors over every
    shape."""
    shape = str([32, 1024, 168, 256])
    t = gcv["times"]["shapes"][shape]
    keys = ("fwd", "dgrad", "wgrad")
    library_ms = sum(t[f"library_{k}_ms"] for k in keys)
    return {
        "name": "grouped_conv",
        "route": "cuda",
        "source": "music_synthesis_tpu_torch/csrc/grouped_conv.cu",
        "replaces": None,
        "launches": gcv["step"]["launches"],
        "max_abs_err": gcv["errors"]["max_abs_err"],
        "ms": sum(t[f"{k}_ms"] for k in keys),
        "plain_ms": library_ms,
        "bound_ms": sum(t[f"{k}_bound_ms"] for k in keys),
        "bound_by": "fp32 FFMA at 67 TFLOP/s or bytes at 3.35 TB/s, the "
                    "larger",
        "library_ms": library_ms,
        "ok": True,
        "path": "one launch forward, one input gradient, two weight and "
                "bias gradients (the plain version, the aten calls, is "
                "cuDNN's on the card)",
        "shape": [32, 1024, 168],
        "groups": 256,
        "dtype": "bfloat16",
        "launches_by_path": {"flagship_train_step_replay":
                             gcv["step"]["launches"]},
        "by_shape": {k: {**{n: v[n] for n in (
            "fwd_ms", "dgrad_ms", "wgrad_ms", "fwd_bound_ms",
            "dgrad_bound_ms", "wgrad_bound_ms", "library_fwd_ms",
            "library_dgrad_ms", "library_wgrad_ms")},
            "max_abs_err": max(e["max_abs_err"] for e in
                               gcv["errors"]["shapes"][k].values())}
            for k, v in gcv["times"]["shapes"].items()},
        "build_s": gcv["times"]["build_s"],
        "ptxas": gcv["times"]["ptxas"],
    }


def phase_copy_synthesis(rng: np.random.Generator) -> dict:
    from music_synthesis_tpu_torch.infer.copy_synthesis import CopySynthesizer
    from music_synthesis_tpu_torch.ops.logmel import logmel_launches

    cs = CopySynthesizer("vocoder_istft")  # card's own dtype, on cuda
    out = {}
    for shape in ((16, 8192), (4, 88064)):
        wav = test_audio(rng, *shape, cs.frontend.sample_rate)
        walls = []
        for _ in range(2):  # the first call includes cuDNN's set-up
            before = logmel_launches.n_calls
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, dist = cs(wav)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(logmel_launches.n_calls == before + 1,
                  "copy-synthesis did not launch the log-mel kernel once")
        hop = cs.frontend.hop_length
        check(tuple(y.shape) == (shape[0], shape[1] // hop * hop),
              f"copy-synthesis shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()) and np.isfinite(dist),
              "copy-synthesis output not finite")
        seconds = shape[0] * shape[1] / cs.frontend.sample_rate
        out[str(list(shape))] = {"distance": dist, "first_wall_s": walls[0],
                                 "wall_s": walls[1],
                                 "rtf": seconds / walls[1]}
        log(f"[copy] {list(shape)} {cs.config.compute_dtype}: multires STFT "
            f"distance {dist:.4f}, wall {walls[1] * 1e3:.2f} ms "
            f"(first call {walls[0] * 1e3:.1f} ms), real-time factor "
            f"{seconds / walls[1]:.1f}")
    return out


def default_path_input(sample_rate: int) -> np.ndarray:
    """The fixed [2, 8192] input of the copy-synthesis checks."""
    return test_audio(np.random.default_rng(DEFAULT_PATH_SEED), 2, 8192,
                      sample_rate)


def check_copy_synthesis_on_cpu() -> dict:
    """Copy-synthesis of a small fixed input on the card against the same
    modules in fp32 on the CPU: in fp32 with cuDNN TF32 off (2e-3), and as
    it runs by default, in the card's bf16 with the "fast" log-mel
    (``CPU_GAPS`` x ``GAP_FACTOR``)."""
    from music_synthesis_tpu_torch.infer.copy_synthesis import CopySynthesizer

    cpu = CopySynthesizer("vocoder_istft", device="cpu", compute_dtype="float32")
    wav = default_path_input(cpu.frontend.sample_rate)
    y_cpu, d_cpu = cpu(wav)
    gpu = CopySynthesizer("vocoder_istft", compute_dtype="float32")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y_gpu, d_gpu = gpu(wav)
    err = (y_gpu.float().cpu() - y_cpu).abs().max().item()
    log(f"[copy] card vs CPU (fp32, [2, 8192]): max abs err {err:.3g}, "
        f"distance {d_gpu:.5f} vs {d_cpu:.5f}")
    check(err <= 2e-3, f"copy-synthesis card vs CPU: {err} > 2e-3")
    check(abs(d_gpu - d_cpu) <= 1e-3, "copy-synthesis distance card vs CPU")

    card = CopySynthesizer("vocoder_istft")  # the card's own dtype
    check(card.config.compute_dtype == "bfloat16" and card.precision == "fast",
          f"copy-synthesis default is {card.config.compute_dtype}/{card.precision}")
    y_def, d_def = card(wav)
    err_def = (y_def.float().cpu() - y_cpu).abs().max().item()
    tol = GAP_FACTOR["copy"] * CPU_GAPS["copy_wav"]
    tol_d = GAP_FACTOR["copy"] * CPU_GAPS["copy_distance"]
    log(f"[copy] card default (bf16, fast log-mel) vs CPU fp32: max abs err "
        f"{err_def:.4g} (tolerance {tol:.4g}), distance {d_def:.5f} vs "
        f"{d_cpu:.5f} (tolerance {tol_d:.4g})")
    check(err_def <= tol, f"default copy-synthesis vs CPU fp32: {err_def} > {tol}")
    check(abs(d_def - d_cpu) <= tol_d,
          f"default copy-synthesis distance: |{d_def} - {d_cpu}| > {tol_d}")
    return {"fp32": err, "default_bf16": err_def,
            "default_bf16_distance": abs(d_def - d_cpu),
            "default_tolerance": tol, "default_distance_tolerance": tol_d}


def phase_serving() -> dict:
    from music_synthesis_tpu_torch.serve import ServeConfig, SynthService

    t0 = time.perf_counter()
    svc = SynthService(ServeConfig(composer="specgan_flux", vocoder="vocoder_istft"))
    log(f"[serve] loaded and warmed {svc._warm} in {time.perf_counter() - t0:.2f} s")
    sr = svc.cfg.frontend.sample_rate
    out = {}
    results = []
    for seconds, seed, n_clips in ((4.0, 3, 1), (8.0, 5, 4), (4.0, 3, 1)):
        wav, meta = svc.synth(seconds, seed=seed, n_clips=n_clips)
        n = svc.patches_for_seconds(seconds)
        want = min(int(round(seconds * sr)), svc.out_samples(n))
        check(meta["patches"] == n and wav.shape == (n_clips, want),
              f"serving shape {wav.shape} / meta {meta}")
        check(bool(np.isfinite(wav).all()), "serving output not finite")
        check(float(np.abs(wav).max()) > 0.0, "serving output is silent")
        results.append(wav)
        log(f"[serve] {seconds:g} s x {n_clips} (seed {seed}): patches {n}, "
            f"bucket {meta['batch_bucket']}, {wav.shape[1]} samples, "
            f"latency {meta['gen_ms']:.2f} ms, real-time factor {meta['rtf']:.1f}")
        out[f"{seconds:g}s_x{n_clips}_seed{seed}"] = {
            "latency_ms": meta["gen_ms"], "rtf": meta["rtf"]}
    diff = float(np.abs(results[0] - results[2]).max())
    check(diff == 0.0, f"repeated seed gave different audio (max diff {diff})")
    out["metrics"] = svc.metrics()
    log(f"[serve] metrics {out['metrics']}")
    check(out["metrics"]["requests"] == 3, "request count")
    return out, svc


def check_serving_on_cpu(svc) -> dict:
    """One request's raw output on the card against the same zoo modules in
    fp32 on the CPU: with cuDNN TF32 off (2e-3), and as the service runs by
    default, fp32 under cuDNN's default TF32 convolutions
    (``CPU_GAPS`` x ``GAP_FACTOR``)."""
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.infer.generate import generate_long

    check(svc.cfg.vocoder.compute_dtype == "float32", "service runs fp32")
    n = svc.patches_for_seconds(4.0)
    z = svc._z_rows(3, 1, n)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y_gpu = svc._execute(n, z)
    composer = zoo.load_pretrained(svc.composer_name).model("cpu", "float32")
    vocoder = zoo.load_pretrained(svc.vocoder_name).model("cpu", "float32")
    with torch.inference_mode():
        y_cpu = generate_long(svc.cfg, composer, vocoder, z,
                              svc.serve_cfg.crossfade_frames).numpy()
    err = float(np.abs(y_gpu - y_cpu).max())
    log(f"[serve] card vs CPU (fp32, 4 s, seed 3): max abs err {err:.3g} "
        f"(output peak {np.abs(y_cpu).max():.3g})")
    check(err <= 2e-3, f"serving card vs CPU: {err} > 2e-3")

    check(torch.backends.cudnn.allow_tf32,
          "serving's default path runs cuDNN's TF32 convolutions")
    y_def = svc._execute(n, z)
    err_def = float(np.abs(y_def - y_cpu).max())
    tol = GAP_FACTOR["serve"] * CPU_GAPS["serve_wav"]
    log(f"[serve] card default (fp32, cuDNN TF32) vs CPU fp32: max abs err "
        f"{err_def:.4g} (tolerance {tol:.4g})")
    check(err_def <= tol, f"default serving vs CPU fp32: {err_def} > {tol}")
    return {"fp32": err, "default_tf32": err_def, "default_tolerance": tol}


def train_metric_keys(cfg) -> set:
    """The metric keys the JAX stage-2 step returns for ``cfg``."""
    t = cfg.train
    keys = {"d_loss", "g_loss", "g_rms_ratio", "g_adv", "g_fm", "g_stft",
            "d_grad_norm", "g_grad_norm", "d_update_norm", "g_update_norm"}
    keys |= {"g_energy"} if t.lambda_energy > 0 else set()
    keys |= {"g_phase"} if t.lambda_phase > 0 else set()
    keys |= {"d_r1"} if t.r1_gamma > 0 else set()
    return keys


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _copy(d: dict) -> dict:
    return {k: v.clone() for k, v in d.items()}


def phase_training(rng: np.random.Generator, device: str = "cuda",
                   cfg=None) -> dict:
    """Stage-2 training steps on both sides of the warmup gate (main path);
    the caller zeroes the launch counts before and reads them after."""
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.ops.logmel import logmel_launches
    from music_synthesis_tpu_torch.train import stage2
    from music_synthesis_tpu_torch.train.flagship import (flagship_config,
                                                          zoo_train_state)

    entry = zoo.load_pretrained("vocoder_istft")
    cfg = cfg or flagship_config(entry)
    t = cfg.train
    check(t.use_pallas_frontend and t.g_warmup_steps > 0,
          "the training phase runs the flagship's kernel and warmup gate")
    state = zoo_train_state(cfg, entry, device, seed=t.seed)
    wav = torch.from_numpy(test_audio(rng, t.batch_size, t.segment_length,
                                      cfg.frontend.sample_rate)).to(device)
    keys = train_metric_keys(cfg)
    cuda = device == "cuda"

    def step(state):
        before = logmel_launches.n_calls
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        state, m = stage2.train_step(cfg, state, wav)
        if cuda:
            end.record()
            end.synchronize()
        wall = time.perf_counter() - t0
        ms = start.elapsed_time(end) if cuda else 1e3 * wall
        check(set(m) == keys, f"metric keys {sorted(m)} != {sorted(keys)}")
        check(all(np.isfinite(v) for v in m.values()), f"metrics {m}")
        if cuda:
            check(logmel_launches.n_calls == before + 1,
                  "a training step did not launch the log-mel kernel once")
        return state, m, ms, wall

    d0, g0 = _copy(state.d_params), _copy(state.g_params)
    d_mu0, d_nu0 = _copy(state.d_opt.mu), _copy(state.d_opt.nu)
    gated = []
    for _ in range(2):
        state, m, ms, wall = step(state)
        gated.append({"metrics": m, "ms": ms, "wall_s": wall})
        log(f"[train] step {state.step - 1} (warmup gate closed): {ms:.2f} ms, "
            + ", ".join(f"{k} {v:.5g}" for k, v in sorted(m.items())))
    check(_same(state.d_params, d0) and _same(state.d_opt.mu, d_mu0)
          and _same(state.d_opt.nu, d_nu0) and state.d_opt.count == 0,
          "D or its Adam state moved inside the warmup gate")
    check(not _same(state.g_params, g0), "G did not move inside the gate")
    check(gated[-1]["metrics"]["d_update_norm"] == 0.0, "D update inside gate")

    state = dataclasses.replace(state, step=t.g_warmup_steps)
    d1 = _copy(state.d_params)
    state, m, ms, wall = step(state)  # warm-up of the adversarial step
    log(f"[train] step {state.step - 1} (gate open, warm-up): {ms:.2f} ms")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    adversarial = []
    for _ in range(3):
        state, m, ms, wall = step(state)
        adversarial.append({"metrics": m, "ms": ms, "wall_s": wall})
        log(f"[train] step {state.step - 1} (gate open): {ms:.2f} ms, "
            + ", ".join(f"{k} {v:.5g}" for k, v in sorted(m.items())))
    check(not _same(state.d_params, d1), "D did not move past the gate")
    check(state.d_opt.count == 4, f"D's Adam count {state.d_opt.count} != 4")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    median_ms = float(np.median([a["ms"] for a in adversarial]))
    log(f"[train] flagship [{t.batch_size}, {t.segment_length}] "
        f"{cfg.vocoder.compute_dtype}: median adversarial step {median_ms:.2f} "
        f"ms (CUDA events, 3 steps after 1 warm-up), wall "
        f"{np.median([a['wall_s'] for a in adversarial]) * 1e3:.2f} ms, "
        f"peak memory {peak} B")
    return {"median_step_ms": median_ms, "peak_memory_bytes": peak,
            "gated": gated, "adversarial": adversarial,
            "steps": state.step - t.g_warmup_steps + 2}


def he_gain_d(d_params: dict, seed: int, out_gain: dict) -> dict:
    """D's weight-norm gains set to He's sqrt(2) (+-30%), its biases to
    small values, and the gains of each ``conv_out`` to ``out_gain`` of the
    first name in its key (+-30%): the MSD and MRD heads' at
    ``out_gain["msd"]`` and ``out_gain["mrd"]``, the stage-1 D's at
    ``out_gain["conv_out"]``.

    At D's init each gain equals its filter's norm, so the logits sit near
    0, where the hinge losses read about 2 per head and g_adv about 0
    whatever D computes. With He gains the features are of order 1. R1 is
    the squared input gradient of the logits; the MRD's runs through
    ``log|S|``, whose derivative is 1/|S| in quiet bins, so at MRD logits
    of order 1 it reaches 1e7 and buries the hinge terms of d_loss: the
    output gains set the logits' scale and with it R1's."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in d_params.items():
        r = torch.randn(v.shape, generator=gen).to(v.device)
        if k.endswith(".g"):
            names = k.split(".")
            gain = (out_gain[names[0]] if names[-2] == "conv_out"
                    else 2.0 ** 0.5)
            out[k] = gain * (1.0 + 0.3 * r)
        elif k.endswith(".b"):
            out[k] = 0.05 * r
        else:
            out[k] = v
    return out


def warm_second_moment(opt):
    """An Adam state whose second moment is 1 everywhere. The G step runs
    against the updated D, and a fresh Adam's first update is about
    ``lr * sign(g)``, which rounding flips where g is near 0; from this
    state it is ``lr * g / sqrt(9 + g^2)`` (b2 = 0.9), continuous in g."""
    return dataclasses.replace(
        opt, nu={k: torch.ones_like(v) for k, v in opt.nu.items()})


def check_training_on_cpu(seed: int = DEFAULT_PATH_SEED) -> dict:
    """One flagship step at [2, 8192] in fp32 from one state (zoo G, D with
    ``he_gain_d`` and ``warm_second_moment``, past the gate, fixed audio
    and instance noise): on the card with TF32 off and the "exact" log-mel
    kernel, against the CPU (``TRAIN_TOL``). As a control, the same step
    on the card with TF32 on (cuDNN and matmul) must fail the tolerance."""
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.train import stage2
    from music_synthesis_tpu_torch.train.flagship import (flagship_config,
                                                          zoo_train_state)

    entry = zoo.load_pretrained("vocoder_istft")
    cfg = flagship_config(entry)
    cfg = dataclasses.replace(
        cfg, vocoder=dataclasses.replace(cfg.vocoder, compute_dtype="float32"),
        msd=dataclasses.replace(cfg.msd, compute_dtype="float32"),
        mrd=dataclasses.replace(cfg.mrd, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=2))
    rng = np.random.default_rng(seed)
    wav = test_audio(rng, 2, 8192, cfg.frontend.sample_rate)
    noise = [rng.standard_normal((2, 8192)).astype(np.float32)
             for _ in range(3)]
    out = {}
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        for run, device, tf32 in (("cpu", "cpu", False),
                                  ("card", "cuda", False),
                                  ("card_tf32", "cuda", True)):
            state = zoo_train_state(cfg, entry, device, seed=cfg.train.seed)
            state = dataclasses.replace(
                state, step=cfg.train.g_warmup_steps,
                d_params=he_gain_d(state.d_params, seed, TRAIN_D_OUT_GAIN),
                d_opt=warm_second_moment(state.d_opt))
            torch.backends.cuda.matmul.allow_tf32 = tf32
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
                _, out[run] = stage2.train_step(
                    cfg, state, wav, noise=noise,
                    precision="exact" if device == "cuda" else "fast")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    cpu = out["cpu"]
    kinds = {k: kind for names, kind in ((TRAIN_LOSSES, "loss"),
                                         (TRAIN_GRAD_NORMS, "grad_norm"))
             for k in names}
    rel = {run: {k: abs(out[run][k] - cpu[k]) / abs(cpu[k]) for k in kinds}
           for run in ("card", "card_tf32")}
    for run, label in (("card", "TF32 off"), ("card_tf32", "TF32 on")):
        log(f"[train] card ({label}) vs CPU, fp32 [2, 8192]: |diff| / |cpu| "
            + ", ".join(f"{k} {v:.3g}" for k, v in rel[run].items()))
    log(f"[train] CPU metrics: {cpu}")
    check(abs(cpu["g_adv"]) > 1e-2,
          f"D's logits sit near 0 (g_adv {cpu['g_adv']}): the check would "
          f"not read D's forward")
    for k, kind in kinds.items():
        check(rel["card"][k] <= TRAIN_TOL[kind],
              f"training step card vs CPU: {k} {out['card'][k]} vs {cpu[k]}, "
              f"|diff| / |cpu| {rel['card'][k]:.3g} > {TRAIN_TOL[kind]}")
    check(any(rel["card_tf32"][k] > TRAIN_TOL[kind] for k, kind in kinds.items()),
          "the same step with TF32 on passes TRAIN_TOL: it does not tell "
          "fp32 from TF32")
    return {"rel_diff": rel["card"], "rel_diff_tf32": rel["card_tf32"],
            "tolerance": TRAIN_TOL, "card": out["card"], "cpu": cpu,
            "card_tf32": out["card_tf32"]}


def stage1_metric_keys(cfg) -> set:
    """The metric keys the JAX stage-1 step returns for ``cfg``."""
    t = cfg.train
    keys = {"d_loss", "g_loss", "g_rms_ratio", "g_adv", "g_fm",
            "d_grad_norm", "g_grad_norm", "d_update_norm", "g_update_norm"}
    keys |= {"g_flux"} if t.lambda_flux > 0 else set()
    keys |= {"d_r1"} if t.r1_gamma > 0 else set()
    return keys


def stage1_patches(rng: np.random.Generator, cfg, device: str) -> torch.Tensor:
    """Normalized log-mel patches ``[B, n_frames, n_mels]`` of seeded test
    audio, through the plain front-end as the stage-1 CLI makes them."""
    from music_synthesis_tpu_torch.ops.frontend import log_mel_for_vocoder

    seg = cfg.specgan.n_frames * cfg.frontend.hop_length
    wav = torch.from_numpy(test_audio(rng, cfg.train.batch_size, seg,
                                      cfg.frontend.sample_rate)).to(device)
    with torch.no_grad():
        mel = log_mel_for_vocoder(wav, cfg.frontend)
    return (mel - cfg.mel_scaler.shift) / cfg.mel_scaler.scale


def phase_stage1_training(rng: np.random.Generator) -> dict:
    """Stage-1 steps at the composer flagship's full width (main path); the
    caller zeroes the launch counts before and reads them after."""
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.train import stage1
    from music_synthesis_tpu_torch.train.flagship import (
        stage1_flagship_config, zoo_train_state)

    entry = zoo.load_pretrained("specgan_flux")
    cfg = stage1_flagship_config(entry)
    t, s = cfg.train, cfg.specgan
    state = zoo_train_state(cfg, entry, "cuda", seed=t.seed)
    mel = stage1_patches(rng, cfg, "cuda")
    check(tuple(mel.shape) == (t.batch_size, s.n_frames, s.n_mels),
          f"stage-1 patches {tuple(mel.shape)}")
    keys = stage1_metric_keys(cfg)
    g0, d0, e0 = _copy(state.g_params), _copy(state.d_params), _copy(state.g_ema)

    def step(state):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = stage1.train_step(cfg, state, mel)
        end.record()
        end.synchronize()
        check(set(m) == keys, f"metric keys {sorted(m)} != {sorted(keys)}")
        check(all(np.isfinite(v) for v in m.values()), f"metrics {m}")
        return state, m, start.elapsed_time(end)

    warm = []
    for _ in range(2):
        state, m, ms = step(state)
        warm.append(ms)
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    timed = []
    for _ in range(10):
        state, m, ms = step(state)
        timed.append(ms)
    peak = torch.cuda.max_memory_allocated()
    last = state.step - 1
    holder = {"state": state}

    def profiled_step():
        holder["state"], _ = stage1.train_step(cfg, holder["state"], mel)

    prof = profile_launches(profiled_step)
    state = holder["state"]
    check(state.step == 15 and state.d_opt.count == 15, "stage-1 step count")
    for name, before, after in (("G", g0, state.g_params),
                                ("D", d0, state.d_params),
                                ("EMA", e0, state.g_ema)):
        check(not _same(before, after), f"stage-1 {name} did not move")
    median_ms = float(np.median(timed))
    log(f"[stage1] step {last}: " + ", ".join(
        f"{k} {v:.5g}" for k, v in sorted(m.items())))
    log(f"[stage1] flagship [{t.batch_size}, {s.n_frames}, {s.n_mels}] "
        f"{s.compute_dtype}: median step {median_ms:.3f} ms (CUDA events, "
        f"10 steps after 2 warm-ups: {', '.join(f'{x:.3f}' for x in timed)}; "
        f"warm-ups {', '.join(f'{x:.1f}' for x in warm)}), peak memory {peak} B "
        f"({peak - baseline} B above the {baseline} B held before)")
    log(f"[stage1] under the profiler: {prof['launches_per_call']:.0f} kernel "
        f"launches and kernel time {prof['kernel_ms_per_call']:.3f} ms per "
        f"step, {prof['profiled_wall_ms_per_call']:.3f} ms wall per step, "
        f"device busy {prof['device_busy']:.3f} of the window")
    return {"median_step_ms": median_ms, "step_ms": timed, "warmup_ms": warm,
            "peak_memory_bytes": peak, "baseline_bytes": baseline,
            "profile": prof, "metrics": m}


def check_stage1_on_cpu(seed: int = DEFAULT_PATH_SEED) -> dict:
    """One stage-1 flagship step at full width in fp32 from one state (zoo
    G, D with ``he_gain_d`` and ``warm_second_moment``, fixed patches,
    latents and instance noise): on the card with TF32 off against the CPU
    (``STAGE1_TOL``), and on the card with TF32 on (cuDNN and matmul),
    which must fail it."""
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.train import stage1
    from music_synthesis_tpu_torch.train.flagship import (
        stage1_flagship_config, zoo_train_state)

    entry = zoo.load_pretrained("specgan_flux")
    cfg = stage1_flagship_config(entry)
    check(cfg.specgan.compute_dtype == "float32", "stage-1 flagship is fp32")
    rng = np.random.default_rng(seed)
    mel = stage1_patches(rng, cfg, "cpu")
    z = rng.standard_normal((mel.shape[0], cfg.specgan.latent_dim)).astype(
        np.float32)
    noise = [rng.standard_normal(tuple(mel.shape)).astype(np.float32)
             for _ in range(3)]
    out = {}
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        for run, device, tf32 in (("cpu", "cpu", False),
                                  ("card", "cuda", False),
                                  ("card_tf32", "cuda", True)):
            state = zoo_train_state(cfg, entry, device, seed=cfg.train.seed)
            state = dataclasses.replace(
                state, d_params=he_gain_d(state.d_params, seed,
                                          {"conv_out": STAGE1_D_OUT_GAIN}),
                d_opt=warm_second_moment(state.d_opt))
            torch.backends.cuda.matmul.allow_tf32 = tf32
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
                _, out[run] = stage1.train_step(cfg, state, mel, z=z,
                                                noise=noise)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    cpu = out["cpu"]
    kinds = {k: kind for names, kind in ((STAGE1_LOSSES, "loss"),
                                         (TRAIN_GRAD_NORMS, "grad_norm"))
             for k in names}
    rel = {run: {k: abs(out[run][k] - cpu[k]) / abs(cpu[k]) for k in kinds}
           for run in ("card", "card_tf32")}
    for run, label in (("card", "TF32 off"), ("card_tf32", "TF32 on")):
        log(f"[stage1] card ({label}) vs CPU, fp32 {list(mel.shape)}: "
            f"|diff| / |cpu| " + ", ".join(f"{k} {v:.3g}"
                                           for k, v in rel[run].items()))
    log(f"[stage1] CPU metrics: {cpu}")
    check(abs(cpu["g_adv"]) > 1e-2,
          f"D's logits sit near 0 (g_adv {cpu['g_adv']}): the check would "
          f"not read D's forward")
    for k, kind in kinds.items():
        check(rel["card"][k] <= STAGE1_TOL[kind],
              f"stage-1 step card vs CPU: {k} {out['card'][k]} vs {cpu[k]}, "
              f"|diff| / |cpu| {rel['card'][k]:.3g} > {STAGE1_TOL[kind]}")
    check(any(rel["card_tf32"][k] > STAGE1_TOL[kind] for k, kind in kinds.items()),
          "the same stage-1 step with TF32 on passes STAGE1_TOL: it does not "
          "tell fp32 from TF32")
    return {"rel_diff": rel["card"], "rel_diff_tf32": rel["card_tf32"],
            "tolerance": STAGE1_TOL, "card": out["card"], "cpu": cpu,
            "card_tf32": out["card_tf32"]}


STAGE1_CLI_FLAGS = [  # runs/stage1_flux_40k's recipe
    "--batch", "16", "--init-scheme", "he", "--res-init-gain", "0.1",
    "--out-init-gain", "0.1", "--r1-gamma", "1", "--d-noise", "0.2",
    "--noise-decay-steps", "10000", "--ema", "0.999", "--lambda-flux", "10",
    "--auto-mel-stats"]
STAGE2_CLI_FLAGS = [  # runs/stage2_istft_long's recipe
    "--batch", "16", "--segment", "8192", "--head", "istft",
    "--init-scheme", "he", "--bf16-gen", "--bf16-disc", "--dense-groups",
    "16", "--f-fold", "4", "--pallas-frontend", "--r1-gamma", "1",
    "--d-noise", "0.1", "--noise-decay-steps", "20000", "--g-warmup", "5000",
    "--ema", "0.999", "--reuse-real-feats", "--concat-disc",
    "--auto-mel-stats"]


def run_cli(module, argv: list[str]) -> list[str]:
    """``module.main(argv)`` in this process; its standard output is
    captured, printed with a prefix, and returned as lines."""
    buf = io.StringIO()
    name = module.__name__.rsplit(".", 1)[-1]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            module.main(argv)
    finally:  # shown also when the CLI fails
        lines = buf.getvalue().splitlines()
        for line in lines:
            log(f"[lifecycle] {name}: {line}")
    log(f"[lifecycle] {name} took {time.perf_counter() - t0:.1f} s")
    return lines


def phase_lifecycle(tmp: Path) -> dict:
    """train_stage1 -> export_zoo -> train_stage2 (and --resume) ->
    export_zoo -> SynthService, in the directory ``tmp`` (main path); the
    caller zeroes the launch counts before and reads them after. Returns
    the paths of the exported zoo, the stage-2 run and its corpus too, for
    phases 9 and 10."""
    from music_synthesis_tpu_torch.ops.logmel import logmel_launches
    from music_synthesis_tpu_torch.scripts import (export_zoo, train_stage1,
                                                   train_stage2)
    from music_synthesis_tpu_torch.serve import ServeConfig, SynthService

    card = card_name_and_power()
    out = {"loop": {}}
    run1, run2, zoo_root = tmp / "stage1", tmp / "stage2", tmp / "zoo"
    lines = run_cli(train_stage1, STAGE1_CLI_FLAGS + [
        "--steps", "4", "--log-every", "2", "--ckpt-every", "4",
        "--outdir", str(run1)])
    out["loop"]["train_stage1"] = next(x for x in lines if x.startswith("loop:"))
    check(logmel_launches.n_calls == 0, "stage 1 launched the kernel")
    corpus = run1 / "synthetic_corpus"
    check(len(list(corpus.glob("*.wav"))) == 8, "the CLI's corpus")
    run_cli(export_zoo, ["--run", str(run1), "--stage", "1", "--name",
                         "composer", "--root", str(zoo_root)])

    common = STAGE2_CLI_FLAGS + ["--corpus", str(corpus), "--log-every",
                                 "2", "--ckpt-every", "2",
                                 "--audio-every", "2", "--outdir", str(run2)]
    first = run_cli(train_stage2, common + ["--steps", "2"])
    resumed = run_cli(train_stage2, common + [
        "--steps", "4", "--resume", "--steps-per-dispatch", "2"])
    out["loop"]["train_stage2"] = next(x for x in first if x.startswith("loop:"))
    out["loop"]["train_stage2_resumed"] = next(
        x for x in resumed if x.startswith("loop:"))
    check("resumed from step 2" in resumed,
          "the resumed run did not start at the checkpoint's step")
    logged = [json.loads(x)["step"] for x in
              (run2 / "metrics.jsonl").read_text().splitlines()]
    check(logged == [1, 2, 4], f"stage-2 logged steps {logged}")
    dumps = sorted(p.name for p in run2.glob("vocoded_*.wav"))
    check(dumps == ["vocoded_0000002.wav", "vocoded_0000004.wav"],
          f"audio dumps {dumps}")
    stage2_launches = logmel_launches.n_calls
    check(stage2_launches == 4 + len(dumps),
          f"{stage2_launches} log-mel launches for 4 stage-2 steps and "
          f"{len(dumps)} audio dumps")
    run_cli(export_zoo, ["--run", str(run2), "--stage", "2", "--name",
                         "vocoder", "--root", str(zoo_root)])

    svc = SynthService(ServeConfig(composer=str(zoo_root / "composer"),
                                   vocoder=str(zoo_root / "vocoder")),
                       warmup=False)
    check(svc.device.type == "cuda", "service on the card")
    wav, meta = svc.synth(4.0, seed=3)
    n = svc.patches_for_seconds(4.0)
    want = min(int(round(4.0 * svc.cfg.frontend.sample_rate)),
               svc.out_samples(n))
    check(wav.shape == (1, want), f"served shape {wav.shape}")
    check(bool(np.isfinite(wav).all()), "served audio not finite")
    check(float(np.abs(wav).max()) > 0.0, "served audio is silent")
    log(f"[lifecycle] served 4 s from the exported pair: {wav.shape[1]} "
        f"samples, latency {meta['gen_ms']:.2f} ms")
    for name, line in out["loop"].items():
        log(f"[lifecycle] {name} {line} on {card}")
    out.update(stage2_launches=stage2_launches, audio_dumps=len(dumps),
               serve_latency_ms=meta["gen_ms"], card=card,
               zoo_root=str(zoo_root), run2=str(run2), corpus=str(corpus))
    return out


def http_call(httpd, method: str, path: str, body: dict | None = None):
    """One request to ``httpd`` (60 s timeout): ``(status, headers, body
    bytes, seconds)``."""
    import http.client

    conn = http.client.HTTPConnection(*httpd.server_address, timeout=60)
    t0 = time.perf_counter()
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body))
        r = conn.getresponse()
        data = r.read()
        return r.status, r, data, time.perf_counter() - t0
    finally:
        conn.close()


def decode_wav(data: bytes) -> np.ndarray:
    import scipy.io.wavfile

    return scipy.io.wavfile.read(io.BytesIO(data))[1].astype(np.float32) / 32767.0


def http_stream(httpd, seconds: float, seed: int):
    """POST /stream, read block by block: ``(status, meta, body bytes,
    seconds to the first PCM bytes, seconds in all)``."""
    import http.client

    conn = http.client.HTTPConnection(*httpd.server_address, timeout=60)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/stream",
                     body=json.dumps({"seconds": seconds, "seed": seed}))
        r = conn.getresponse()
        header = r.read(44)
        first = r.read1(1 << 16)
        t_first = time.perf_counter() - t0
        data = header + first + r.read()
        return (r.status, json.loads(r.getheader("X-Msynth-Meta")), data,
                t_first, time.perf_counter() - t0)
    finally:
        conn.close()


def phase_http(lifecycle: dict) -> dict:
    """The flagship pair served over HTTP (main path); the caller zeroes the
    launch counts before and reads them after."""
    from music_synthesis_tpu_torch.serve import (ServeConfig, SynthService,
                                                 make_server, wav_bytes)

    out = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svc = SynthService(ServeConfig(composer="specgan_flux",
                                   vocoder="vocoder_istft"))
    out["warm_s"] = time.perf_counter() - t0
    check(("stream", 1) in svc._warm, "warm_all did not warm the stream")
    out["service_peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[http] service loaded and warmed {svc._warm} in {out['warm_s']:.2f} "
        f"s, peak memory {out['service_peak_bytes']} B")
    sr = svc.cfg.frontend.sample_rate
    httpd = make_server(svc, host="127.0.0.1", port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True,
                              name="chip-smoke-http")
    server.start()
    extra = []  # services to close
    try:
        for path in ("/healthz", "/models", "/metrics"):
            status, _, data, _ = http_call(httpd, "GET", path)
            check(status == 200, f"GET {path}: {status}")
            out[path] = json.loads(data)
        check(out["/healthz"]["device"].startswith("cuda/"),
              f"health {out['/healthz']}")
        check(out["/models"]["vocoder"]["name"] == "vocoder_istft", "models")
        status, _, _, _ = http_call(httpd, "GET", "/nope")
        check(status == 404, "unknown route")

        # /generate: bytes equal to the in-process call's; latency over
        # HTTP against in process (median of 5 after the first).
        out["generate"] = {}
        for seconds, seed, n_clips in ((4.0, 3, 1), (8.0, 5, 4)):
            body = {"seconds": seconds, "seed": seed, "n_clips": n_clips}
            http_s, server_ms, proc_ms = [], [], []
            for _ in range(6):
                status, r, data, dt = http_call(httpd, "POST", "/generate", body)
                check(status == 200, f"POST /generate {body}: {status}")
                http_s.append(dt)
                server_ms.append(json.loads(r.getheader("X-Msynth-Meta"))
                                 ["gen_ms"])
                wav, meta = svc.synth(seconds, seed=seed, n_clips=n_clips)
                proc_ms.append(meta["gen_ms"])
            check(data == wav_bytes(sr, wav),
                  f"/generate {body} is not the in-process audio")
            want = min(int(round(seconds * sr)),
                       svc.out_samples(svc.patches_for_seconds(seconds)))
            check(len(data) == 44 + 2 * n_clips * want, "WAV length")
            check(bool(np.isfinite(wav).all()), "served audio not finite")
            key = f"{seconds:g}s_x{n_clips}"
            g = out["generate"][key] = {
                "http_ms_median": 1e3 * float(np.median(http_s[1:])),
                "server_ms_median": float(np.median(server_ms[1:])),
                "in_process_ms_median": float(np.median(proc_ms[1:])),
                "http_ms": [1e3 * x for x in http_s],
                "server_ms": server_ms, "in_process_ms": proc_ms}
            log(f"[http] /generate {key}: over HTTP {g['http_ms_median']:.2f} "
                f"ms (of it {g['server_ms_median']:.2f} ms in the server's "
                f"synth), in process {g['in_process_ms_median']:.2f} ms "
                f"(medians of 5 after the first), {len(data)} bytes")

        # /stream on the warm service as it serves (cuDNN's default TF32
        # convolutions): the exact length, and the time to its first PCM
        # block. Then a second stream against the raw audio of the same
        # seed and patch count, both in fp32 with cuDNN TF32 off.
        want, n = svc.stream_samples(8.0)
        status, meta, data, t_first, t_all = http_stream(httpd, 8.0, 7)
        check(status == 200 and meta["samples"] == want and meta["patches"] == n,
              f"/stream meta {meta}")
        check(len(data) == 44 + 2 * want, f"/stream {len(data)} bytes, want "
              f"{44 + 2 * want}")
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            _, _, data32, _, _ = http_stream(httpd, 8.0, 7)
            raw = svc._execute(n, svc._z_rows(7, 1, n))[0, :want]
        check(len(data32) == 44 + 2 * want, "/stream length with TF32 off")
        err = float(np.abs(decode_wav(data32) - np.clip(raw, -1, 1)).max())
        check(err <= FP32_TOL + 1.5 / 32767,
              f"/stream vs the raw audio: {err} > {FP32_TOL} + one step")
        out["stream"] = {"first_block_ms": 1e3 * t_first, "total_ms": 1e3 * t_all,
                         "patches": n, "samples": want, "max_abs_err": err}
        log(f"[http] /stream 8 s ({n} patches, {want} samples): first PCM block "
            f"after {1e3 * t_first:.2f} ms, all after {1e3 * t_all:.2f} ms; in "
            f"fp32, max abs err against the raw audio {err:.3g}")

        # Coalescing: 4 requests from 4 threads at once.
        co = SynthService(ServeConfig(composer="specgan_flux",
                                      vocoder="vocoder_istft",
                                      coalesce_window_ms=20.0), warmup=False)
        extra.append(co)
        results, errors = {}, []
        barrier = threading.Barrier(4)

        def hit(seed):
            try:
                barrier.wait(timeout=60)
                results[seed] = co.synth(4.0, seed=seed, target_rms=0.0)[0]
            except Exception as e:  # raised below
                errors.append(e)

        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            # cuDNN's set-up for the merged batch's shapes, then the burst.
            co.synth(4.0, seed=0, n_clips=4)
            calls0 = co.metrics()["device_calls"]
            threads = [threading.Thread(target=hit, args=(s,))
                       for s in (11, 12, 13, 14)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            co_s = time.perf_counter() - t0
            solo = {s: svc.synth(4.0, seed=s, target_rms=0.0)[0]
                    for s in results}
        check(not errors and len(results) == 4, f"coalesced requests {errors}")
        calls = co.metrics()["device_calls"] - calls0
        check(calls < 4, f"4 coalesced requests made {calls} device calls")
        err = max(float(np.abs(results[s] - solo[s]).max()) for s in results)
        check(err <= FP32_TOL, f"coalesced vs solo audio: {err} > {FP32_TOL}")
        out["coalesce"] = {"device_calls": calls, "wall_ms": 1e3 * co_s,
                           "max_abs_err": err}
        log(f"[http] coalescing (20 ms window): 4 requests in {calls} device "
            f"call(s), {1e3 * co_s:.2f} ms wall; max abs err against solo "
            f"{err:.3g}")

        # Griffin-Lim refinement of every clip.
        gl = SynthService(ServeConfig(composer="specgan_flux",
                                      vocoder="vocoder_istft", gl_refine=8),
                          warmup=False)
        extra.append(gl)
        gl.synth(4.0, seed=3)  # set-up
        gl_ms = []
        for _ in range(3):
            refined, meta = gl.synth(4.0, seed=3, target_rms=0.0)
            gl_ms.append(meta["gen_ms"])
        plain, meta0 = svc.synth(4.0, seed=3, target_rms=0.0)
        check(bool(np.isfinite(refined).all()), "refined audio not finite")
        check(refined.shape == plain.shape and not np.allclose(refined, plain),
              "gl_refine=8 did not change the audio")
        out["gl_refine"] = {"ms": gl_ms, "ms_median": float(np.median(gl_ms)),
                            "unrefined_ms": meta0["gen_ms"]}
        log(f"[http] gl_refine=8, 4 s: {np.median(gl_ms):.2f} ms (median of "
            f"3; unrefined {meta0['gen_ms']:.2f} ms)")

        # /metrics of the flagship service, before the reload.
        status, _, data, _ = http_call(httpd, "GET", "/metrics")
        out["metrics"] = json.loads(data)
        log(f"[http] /metrics: {out['metrics']}")
        check(out["metrics"]["errors"] == 0 and out["metrics"]["requests"] > 0,
              "metrics")

        # /reload: a missing entry first (400, the old service answers the
        # same bytes), then phase 8's exported pair by directory.
        body = {"seconds": 4.0, "seed": 3}
        _, _, before, _ = http_call(httpd, "POST", "/generate", body)
        status, _, _, _ = http_call(httpd, "POST", "/reload",
                               {"vocoder": str(Path(lifecycle["zoo_root"])
                                               / "missing")})
        check(status == 400 and httpd.service is svc, "failed reload")
        _, _, still, _ = http_call(httpd, "POST", "/generate", body)
        check(still == before, "the old service changed after a failed reload")
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        status, _, data, reload_s = http_call(httpd, "POST", "/reload", {
            "composer": str(Path(lifecycle["zoo_root"]) / "composer"),
            "vocoder": str(Path(lifecycle["zoo_root"]) / "vocoder")})
        peak = torch.cuda.max_memory_allocated()
        check(status == 200, f"reload onto the exported pair: {status} {data}")
        new = httpd.service
        extra.append(new)
        check(new is not svc and json.loads(data)["vocoder"] == "vocoder",
              f"reloaded health {data}")
        _, _, after, _ = http_call(httpd, "POST", "/generate", body)
        wav, _ = new.synth(4.0, seed=3)
        check(after == wav_bytes(sr, wav) and after != before,
              "/generate after the reload is not the new pair's audio")
        out["reload"] = {"seconds": reload_s, "bytes_before": held,
                         "peak_bytes": peak,
                         "bytes_after": torch.cuda.memory_allocated()}
        log(f"[http] /reload onto the exported pair: {reload_s:.2f} s; memory "
            f"{held} B before, peak {peak} B during, "
            f"{out['reload']['bytes_after']} B after")
        lat = out["metrics"]
        log(f"[http] p50 {lat['latency_p50_ms']} ms, p95 "
            f"{lat['latency_p95_ms']} ms over {lat['requests']} requests, on "
            f"{card_name_and_power()}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
        for s in extra + [svc]:
            s.close()
    return out


def phase_eval_and_clis(lifecycle: dict, tmp: Path) -> dict:
    """make_corpus, eval_checkpoint (zoo and run), vocode and generate
    through the CLIs, in ``tmp`` (main path); the caller zeroes the launch
    counts before and reads them after."""
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.ops.logmel import logmel_launches
    from music_synthesis_tpu_torch.scripts import (eval_checkpoint, generate,
                                                   make_corpus, vocode)
    from music_synthesis_tpu_torch.utils.wav import read_wav

    out = {}
    corpus = tmp / "corpus_rich"
    t0 = time.perf_counter()
    run_cli(make_corpus, ["--out", str(corpus), "--clips", "256", "--seconds",
                          "30", "--seed", "0"])
    out["make_corpus_s"] = time.perf_counter() - t0

    # The zoo flagship against the JAX package's CPU eval of this corpus.
    t0 = time.perf_counter()
    run_cli(eval_checkpoint, [
        "--zoo", "vocoder_istft", "--corpus", str(corpus), "--head", "istft",
        "--gl-anchor", "--gl-refine", "8", "--out", str(tmp / "eval_zoo")])
    eval_s = time.perf_counter() - t0
    ev = json.loads((tmp / "eval_zoo" / "eval.json").read_text())
    n_clips = ev["n_clips"]
    tpu = zoo.load_pretrained("vocoder_istft").card["metrics"]["per_clip"]
    card = card_name_and_power()
    gaps = {}
    for k, want in EVAL_JAX_CPU.items():
        got = ev["per_clip"][k]
        gaps[k] = [abs(a - b) for a, b in zip(got, want)]
        log(f"[eval] {k}: card " + ", ".join(f"{v:.4f}" for v in got))
        log(f"[eval] {k}: JAX CPU " + ", ".join(f"{v:.4f}" for v in want)
            + f"; max |card - JAX CPU| {max(gaps[k]):.4g} (tolerance "
            f"{EVAL_TOL[k]:.4g})")
        log(f"[eval] {k}: TPU (card.json) " + ", ".join(
            f"{v:.4f}" for v in tpu[k]) + "; max |card - TPU| "
            f"{max(abs(a - b) for a, b in zip(got, tpu[k])):.4g}")
    for k, g in gaps.items():
        check(len(g) == len(EVAL_JAX_CPU[k]) == n_clips, f"{k}: clip count")
        check(max(g) <= EVAL_TOL[k],
              f"eval {k} against the JAX CPU eval: {max(g)} > {EVAL_TOL[k]}")
    out["eval_zoo"] = {"per_clip": ev["per_clip"], "max_gap_jax_cpu": {
        k: max(g) for k, g in gaps.items()}, "seconds": eval_s,
        "seconds_per_clip": eval_s / n_clips, "means": {
            k: v for k, v in ev.items() if k != "per_clip"}}
    log(f"[eval] zoo vocoder_istft, 8 clips of 4 s with the GL anchor and 8 "
        f"refinement iterations: {eval_s:.2f} s ({eval_s / n_clips:.3f} s per "
        f"clip), on {card}; mean distance "
        f"{ev['copy_synthesis_multires_stft_distance_mean']:.4f}, GL anchor "
        f"{ev['griffin_lim_anchor_distance_mean']:.4f}, refined "
        f"{ev['gl_refined_distance_mean']:.4f}")

    # A run of the port's stage-2 CLI: one log-mel launch per clip.
    before = logmel_launches.n_calls
    t0 = time.perf_counter()
    run_cli(eval_checkpoint, ["--run", lifecycle["run2"], "--corpus",
                              lifecycle["corpus"], "--out",
                              str(tmp / "eval_run")])
    run_s = time.perf_counter() - t0
    ev_run = json.loads((tmp / "eval_run" / "eval.json").read_text())
    out["eval_run_launches"] = logmel_launches.n_calls - before
    check(out["eval_run_launches"] == ev_run["n_clips"],
          f"eval --run: {out['eval_run_launches']} log-mel launches for "
          f"{ev_run['n_clips']} clips")
    check(all(np.isfinite(v) for v in ev_run["per_clip"]["dist"]),
          "eval --run metrics")
    out["eval_run"] = {"seconds": run_s, "checkpoint_step":
                       ev_run["checkpoint_step"],
                       "distance_mean":
                       ev_run["copy_synthesis_multires_stft_distance_mean"]}
    log(f"[eval] --run (phase 8's stage-2 run, step "
        f"{ev_run['checkpoint_step']}): {run_s:.2f} s for {ev_run['n_clips']} "
        f"clips, {out['eval_run_launches']} log-mel launches")

    # vocode, neural and Griffin-Lim, on a corpus clip.
    clip = sorted(corpus.glob("*.wav"))[0]
    for name, flags in (("neural", ["--stage2", "vocoder_istft"]),
                        ("griffin_lim", ["--griffin-lim"])):
        dst = tmp / f"vocode_{name}.wav"
        lines = run_cli(vocode, [str(clip), *flags, "--out", str(dst)])
        sr, y = read_wav(dst)
        check(y.shape[0] > 0.9 * 30 * sr and np.isfinite(y).all()
              and np.abs(y).max() > 0.01, f"vocode {name} output")
        out[f"vocode_{name}"] = next(x for x in lines
                                     if x.startswith("resynthesized"))

    # generate from the zoo pair.
    pair = ["--stage1", "specgan_flux", "--stage2", "vocoder_istft"]
    for name, flags in (("gl_refine", ["--seconds", "8", "--gl-refine", "8"]),
                        ("interpolate", ["--seconds", "8", "--interpolate",
                                         "3:7", "--report"]),
                        ("walk", ["--seconds", "8", "--walk-step", "0.3",
                                  "--report"])):
        dst = tmp / f"generate_{name}"
        lines = run_cli(generate, pair + flags + ["--n", "2", "--out",
                                                  str(dst)])
        for i in range(2):
            sr, y = read_wav(dst / f"sample_{i:03d}.wav")
            check(abs(y.shape[0] - 8 * sr) < 2 * sr and np.isfinite(y).all()
                  and np.abs(y).max() > 0.0, f"generate {name} sample {i}")
        if "--report" in flags:
            check((dst / "report.html").stat().st_size > 0, "report written")
        out[f"generate_{name}"] = next(x for x in lines
                                       if x.startswith("generated"))
    return out



# ---------------------------------------------------------------------------
# Phase 12: data parallelism. The rank functions below run in processes that
# ``parallel.mesh.launch`` spawns (they import this file, whose main() is
# guarded); every other function runs in this process.

DP_RANKS = 2
DP_BATCH = 16  # the flagships' global batch, DP_BATCH // DP_RANKS per rank


def _dp_step(stage: int, dp: str, cfg):
    """The port's DP step of ``stage`` following ``dp`` over the default
    group."""
    from music_synthesis_tpu_torch.parallel import dp as dp_mod
    from music_synthesis_tpu_torch.parallel import shard_map_dp

    make = {(2, "jit"): dp_mod.make_dp_stage2_step,
            (2, "shard_map"): shard_map_dp.make_shardmap_stage2_step,
            (1, "jit"): dp_mod.make_dp_stage1_step,
            (1, "shard_map"): shard_map_dp.make_shardmap_stage1_step}
    return make[stage, dp](cfg)


def _rank_rows(n: int) -> slice:
    from music_synthesis_tpu_torch.parallel import mesh

    per = n // mesh.world_size()
    return slice(per * mesh.rank(), per * (mesh.rank() + 1))


def _params_err(state, single: dict) -> dict:
    return {part: max((getattr(state, f"{part}_params")[k].float()
                       - v.to(getattr(state, f"{part}_params")[k].device)
                       ).abs().max().item() for k, v in single[part].items())
            for part in ("g", "d")}


def _checksum(state) -> float:
    return float(sum(v.double().sum().item() for part in (state.g_params,
                                                          state.d_params)
                     for v in part.values()))


def _rank_check(job: dict) -> dict:
    """One fp32 step (TF32 off, the "exact" kernel) of a DP mode from the
    saved state on this rank's rows, with the injected draws; its metrics,
    the log-mel launches, and its parameters' distance to the
    single-process step's."""
    from music_synthesis_tpu_torch.ops.logmel import logmel_launches
    from music_synthesis_tpu_torch.train.checkpoint import restore_checkpoint

    dev = torch.device("cuda", torch.cuda.current_device())
    step = _dp_step(job["stage"], job["dp"], job["cfg"])
    state = restore_checkpoint(job["state"], dev)
    rows = _rank_rows(job["batch"].shape[0])
    batch = torch.from_numpy(job["batch"][rows]).to(dev)
    noise = [n[rows] for n in job["noise"]]
    kw = ({"noise": noise, "precision": "exact"} if job["stage"] == 2
          else {"noise": noise, "z": job["z"][rows]})
    before = logmel_launches.n_calls
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            state, m = step(state, batch, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    single = torch.load(job["single"], map_location="cpu")
    return {"metrics": m, "launches": logmel_launches.n_calls - before,
            "param_err": _params_err(state, single),
            "checksum": _checksum(state)}


def _rank_time(job: dict) -> dict:
    """The flagship's bf16 DP step (``--dp shard_map``, the "fast"
    kernel) on this rank's rows as it runs (one CUDA graph over NCCL,
    eager over gloo): one warm-up (a graph's build), then ``job["steps"]``
    steps timed with CUDA events; with ``job["plain"]`` the same DP step
    eager (``disable_graphs``) and the single-process step as it runs (its
    graph) on the same rows, timed the same way, and one more DP step
    under ``profile_launches`` (the device's activities and busy share);
    and the gradient all-reduce alone on tensors of G's and D's sizes."""
    from music_synthesis_tpu_torch._graphs import disable_graphs
    from music_synthesis_tpu_torch.ops.logmel import logmel_launches
    from music_synthesis_tpu_torch.parallel import mesh
    from music_synthesis_tpu_torch.parallel.shard_map_dp import (
        make_shardmap_stage2_step)
    from music_synthesis_tpu_torch.train import stage2
    from music_synthesis_tpu_torch.train.checkpoint import restore_checkpoint

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = job["cfg"]
    rows = _rank_rows(job["batch"].shape[0])
    wav = torch.from_numpy(job["batch"][rows]).to(dev)

    def timed(step_fn):
        state = restore_checkpoint(job["state"], dev)
        state, _ = step_fn(state, wav)  # warm-up
        out = []
        for _ in range(job["steps"]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step_fn(state, wav)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out, m

    before = logmel_launches.n_calls
    step = make_shardmap_stage2_step(cfg)
    dp_ms, m = timed(step)
    dp_eager_ms = plain_ms = prof = None
    if job["plain"]:
        holder = {"state": restore_checkpoint(job["state"], dev)}

        def one():
            holder["state"], _ = step(holder["state"], wav)

        prof = profile_launches(one, calls=1)
        with disable_graphs():
            dp_eager_ms = timed(step)[0]
        plain_ms = timed(lambda s, w: stage2.train_step(cfg, s, w))[0]
    launches = logmel_launches.n_calls - before
    state = restore_checkpoint(job["state"], dev)
    reduce_ms = {}
    for part in ("g", "d"):
        tensors = list(getattr(state, f"{part}_params").values())
        mesh.all_reduce_mean(tensors)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh.all_reduce_mean(tensors)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        reduce_ms[part] = float(np.median(times))
    return {"dp_ms": dp_ms, "dp_eager_ms": dp_eager_ms, "plain_ms": plain_ms,
            "profile": prof, "reduce_ms": reduce_ms, "launches": launches,
            "metrics": m,
            "n_params": {p: sum(v.numel() for v in getattr(
                state, f"{p}_params").values()) for p in ("g", "d")}}


def _state_tensors(state) -> list:
    """Every tensor of a training state, group by group, copied out."""
    from music_synthesis_tpu_torch.train.state import state_groups

    return [_outputs([g[k] for k in sorted(g)]) for g in state_groups(state)]


def _rank_graph(job: dict) -> dict:
    """The DP step of one stage and mode at the flagship's width and
    recipe (stage 2 in bf16, the "fast" kernel) on this rank's rows of
    ``job["batches"][0]``, from one saved state, with the draws its own:
    3 steps inside the warmup gate and 3 past it (stage 1: 6 steps) eager
    (``disable_graphs``) and as the step runs (one CUDA graph per rank
    over NCCL), every metric and state tensor compared bit for bit; the
    log-mel launches of each run and per replay; with ``job["many"]``
    ``train_step_many`` (K = 4) over this rank's rows of ``batches``
    against four steps, past the gate."""
    import torch.distributed as dist

    from music_synthesis_tpu_torch._graphs import disable_graphs, pool_bytes
    from music_synthesis_tpu_torch.ops.logmel import logmel_launches
    from music_synthesis_tpu_torch.parallel.shard_map_dp import (
        make_shardmap_stage2_many)
    from music_synthesis_tpu_torch.train import stage1, stage2
    from music_synthesis_tpu_torch.train.checkpoint import restore_checkpoint

    dev = torch.device("cuda", torch.cuda.current_device())
    stage, dp, cfg = job["stage"], job["dp"], job["cfg"]
    step = _dp_step(stage, dp, cfg)
    rows = _rank_rows(job["batches"].shape[1])
    batches = torch.from_numpy(np.ascontiguousarray(
        job["batches"][:, rows])).to(dev)
    gate = cfg.train.g_warmup_steps if stage == 2 else None

    def start(past: bool):
        st = restore_checkpoint(job["state"], dev)
        return dataclasses.replace(st, step=gate) if past else st

    def six(graphs: bool) -> tuple:
        st, metrics = start(False), []
        before = logmel_launches.n_calls
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(disable_graphs())
            for i in range(6):
                if i == 3 and gate is not None:
                    st = dataclasses.replace(st, step=gate)
                st, m = step(st, batches[0])
                metrics.append(m)
        return (metrics, _state_tensors(st), logmel_launches.n_calls - before,
                _checksum(st))

    t0 = time.perf_counter()
    eager_m, eager_s, eager_launches, _ = six(False)
    graphed_m, graphed_s, graphed_launches, checksum = six(True)
    if stage == 2:
        graphed = stage2.graphed_step(cfg, batches[0].shape, dev, "fast",
                                      dist.group.WORLD, dp)
    else:
        graphed = stage1.graphed_step(cfg, batches[0].shape, dev,
                                      dist.group.WORLD, dp)
    program = graphed.program
    out = {"stage": stage, "dp": dp, "metrics_bitwise": graphed_m == eager_m,
           "state_max_abs": {name: _gap(g, e) for name, g, e in zip(
               STAGE2_GRAPH_NAMES, graphed_s, eager_s)},
           "eager_launches": eager_launches,
           "graphed_launches": graphed_launches,
           "captured": program is not None and program.graph is not None,
           "launches_per_replay": program.counts_per_replay["logmel_kernel"],
           "pool_bytes": pool_bytes(program.pool, dev),
           "checksum": checksum, "last_metrics": graphed_m[-1]}
    if job["many"]:
        before = logmel_launches.n_calls
        st, m_many = make_shardmap_stage2_many(cfg)(start(True), batches)
        many_launches = logmel_launches.n_calls - before
        s_many = _state_tensors(st)
        st = start(True)
        before = logmel_launches.n_calls
        for w in batches:
            st, m_four = step(st, w)
        out["many"] = {"metrics_bitwise": m_many == m_four,
                       "state_max_abs": max(_gap(a, b) for a, b in zip(
                           s_many, _state_tensors(st))),
                       "launches": many_launches,
                       "four_launches": logmel_launches.n_calls - before}
    out["seconds"] = time.perf_counter() - t0
    return out


def dp_rank_jobs(jobs: list) -> list:
    """What each rank of phase 12 runs: ``jobs`` in order."""
    kinds = {"check": _rank_check, "time": _rank_time, "graph": _rank_graph}
    return [kinds[j["kind"]](j) for j in jobs]


def _single_step(stage: int, cfg, state, batch, z, noise) -> tuple:
    """The single-process fp32 step (TF32 off) on the whole batch."""
    from music_synthesis_tpu_torch.train import stage1, stage2

    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            if stage == 2:
                return stage2.train_step(cfg, state, batch, noise=noise,
                                         precision="exact")
            return stage1.train_step(cfg, state, batch, z=z, noise=noise)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def _dp_inputs(tmp: Path, seed: int) -> dict:
    """Both flagships' fp32 DP checks: the state (zoo G, ``he_gain_d``,
    ``warm_second_moment``; stage 2 past the warmup gate) saved for the
    ranks, the global batch and draws, and the single-process step's
    metrics and parameters."""
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.train.checkpoint import save_checkpoint
    from music_synthesis_tpu_torch.train.flagship import (
        flagship_config, stage1_flagship_config, zoo_train_state)

    rng = np.random.default_rng(seed)
    out = {}
    for stage in (2, 1):
        if stage == 2:
            entry = zoo.load_pretrained("vocoder_istft")
            cfg = flagship_config(entry)
            cfg = dataclasses.replace(
                cfg, vocoder=dataclasses.replace(cfg.vocoder,
                                                 compute_dtype="float32"),
                msd=dataclasses.replace(cfg.msd, compute_dtype="float32"),
                mrd=dataclasses.replace(cfg.mrd, compute_dtype="float32"))
            gains = TRAIN_D_OUT_GAIN
            batch = test_audio(rng, DP_BATCH, cfg.train.segment_length,
                               cfg.frontend.sample_rate)
            z = None
        else:
            entry = zoo.load_pretrained("specgan_flux")
            cfg = stage1_flagship_config(entry)
            gains = {"conv_out": STAGE1_D_OUT_GAIN}
            batch = stage1_patches(rng, cfg, "cpu").numpy()
            z = rng.standard_normal((DP_BATCH, cfg.specgan.latent_dim)).astype(
                np.float32)
        check(cfg.train.batch_size == DP_BATCH == batch.shape[0],
              f"stage {stage}: the flagship's batch is {DP_BATCH}")
        noise = [rng.standard_normal(batch.shape).astype(np.float32)
                 for _ in range(3)]
        state = zoo_train_state(cfg, entry, "cuda", seed=cfg.train.seed)
        state = dataclasses.replace(
            state, step=cfg.train.g_warmup_steps,
            d_params=he_gain_d(state.d_params, seed, gains),
            d_opt=warm_second_moment(state.d_opt))
        save_checkpoint(tmp / f"dp_state{stage}.pt", state)
        new, m = _single_step(stage, cfg, state, torch.from_numpy(batch).cuda(),
                              z, noise)
        torch.save({"g": {k: v.cpu() for k, v in new.g_params.items()},
                    "d": {k: v.cpu() for k, v in new.d_params.items()}},
                   tmp / f"dp_single{stage}.pt")
        out[stage] = {"cfg": cfg, "batch": batch, "z": z, "noise": noise,
                      "metrics": m, "state": str(tmp / f"dp_state{stage}.pt"),
                      "single": str(tmp / f"dp_single{stage}.pt")}
    return out


def _check_job(inputs: dict, stage: int, dp: str) -> dict:
    i = inputs[stage]
    return {"kind": "check", "stage": stage, "dp": dp, "cfg": i["cfg"],
            "state": i["state"], "single": i["single"], "batch": i["batch"],
            "z": i["z"], "noise": i["noise"]}


def _hold_to_single(label: str, res: list, want: dict, stage: int,
                    skip=()) -> dict:
    """Every rank's metrics against the single-process step's (``TRAIN_TOL``
    or ``STAGE1_TOL`` by metric kind), the ranks' states equal; returns the
    worst relative gap per metric."""
    tol = TRAIN_TOL if stage == 2 else STAGE1_TOL
    losses = TRAIN_LOSSES if stage == 2 else STAGE1_LOSSES
    kinds = {k: kind for names, kind in ((losses, "loss"),
                                         (TRAIN_GRAD_NORMS, "grad_norm"))
             for k in names if k not in skip}
    rel = {k: max(abs(r["metrics"][k] - want[k]) / abs(want[k]) for r in res)
           for k in kinds}
    log(f"[dp] {label} vs the single-process step on [{DP_BATCH}, ...] "
        f"(fp32, TF32 off): |diff| / |single| " + ", ".join(
            f"{k} {v:.3g}" for k, v in rel.items())
        + "; params max abs diff " + ", ".join(
            f"rank {n}: G {r['param_err']['g']:.3g} D {r['param_err']['d']:.3g}"
            for n, r in enumerate(res)) + f"; on {card_name_and_power()}")
    for k, kind in kinds.items():
        check(rel[k] <= tol[kind], f"{label}: {k} |diff| / |single| "
              f"{rel[k]:.3g} > {tol[kind]}")
    check(len({r["checksum"] for r in res}) == 1,
          f"{label}: the ranks' states differ")
    check(all(r["launches"] == (1 if stage == 2 else 0) for r in res),
          f"{label}: log-mel launches per rank {[r['launches'] for r in res]}")
    return rel


def _graph_jobs(tmp: Path, seed: int) -> list:
    """Phase 12's graph jobs (``_rank_graph``), each mode of each stage:
    the stage-2 flagship in bf16 (zoo G, seeded D) at step 0 on four
    global batches [16, 8192] (``train_step_many`` in ``shard_map``'s
    job), the stage-1 flagship at step 0 on one batch [16, 128, 128]."""
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.train.checkpoint import save_checkpoint
    from music_synthesis_tpu_torch.train.flagship import (
        flagship_config, stage1_flagship_config, zoo_train_state)

    rng = np.random.default_rng(seed + 1)
    jobs = []
    for stage, name in ((2, "vocoder_istft"), (1, "specgan_flux")):
        entry = zoo.load_pretrained(name)
        cfg = (flagship_config(entry) if stage == 2
               else stage1_flagship_config(entry))
        path = tmp / f"dp_graph_state{stage}.pt"
        save_checkpoint(path, zoo_train_state(cfg, entry, "cuda",
                                              seed=cfg.train.seed))
        if stage == 2:
            batches = np.stack([test_audio(
                rng, DP_BATCH, cfg.train.segment_length,
                cfg.frontend.sample_rate) for _ in range(4)])
        else:
            batches = stage1_patches(rng, cfg, "cpu").numpy()[None]
        check(batches.shape[1] == cfg.train.batch_size == DP_BATCH,
              f"stage {stage}: the flagship's batch is {DP_BATCH}")
        jobs += [{"kind": "graph", "stage": stage, "dp": dp, "cfg": cfg,
                  "state": str(path), "batches": batches,
                  "many": stage == 2 and dp == "shard_map"}
                 for dp in ("jit", "shard_map")]
    return jobs


def _hold_graphs(label: str, res: list) -> dict:
    """Every rank's graph job (``_rank_graph``): captured, graphed equal to
    eager bit for bit, one log-mel launch per replay in stage 2 and none
    in stage 1, ``train_step_many`` equal to four steps, the ranks'
    states equal."""
    r0 = res[0]
    per = 1 if r0["stage"] == 2 else 0
    log(f"[dp] {label}: graphed DP step against eager, "
        f"{'3 + 3 steps across the warmup gate' if per else '6 steps'}: "
        f"metrics equal bit for bit {[r['metrics_bitwise'] for r in res]}, "
        f"state max |graphed - eager| " + ", ".join(
            f"{k} {v:.3g}" for k, v in r0["state_max_abs"].items())
        + f"; log-mel launches eager {r0['eager_launches']}, graphed "
        f"{r0['graphed_launches']} ({r0['launches_per_replay']} per replay); "
        f"pool {r0['pool_bytes']} B; {r0['seconds']:.1f} s")
    for r in res:
        check(r["captured"], f"{label}: no graph was captured")
        check(r["metrics_bitwise"] and not any(r["state_max_abs"].values()),
              f"{label}: graphed differs from eager {r['state_max_abs']}")
        check(r["launches_per_replay"] == per
              and r["graphed_launches"] == r["eager_launches"] == 6 * per,
              f"{label}: log-mel launches {r['eager_launches']} eager, "
              f"{r['graphed_launches']} graphed, {r['launches_per_replay']} "
              "per replay")
        if "many" in r:
            many = r["many"]
            check(many["metrics_bitwise"] and many["state_max_abs"] == 0
                  and many["launches"] == many["four_launches"] == 4,
                  f"{label}: train_step_many K=4 against four steps {many}")
    if "many" in r0:
        log(f"[dp] {label}: train_step_many K=4 against four graphed steps: "
            f"metrics equal {r0['many']['metrics_bitwise']}, state max "
            f"|diff| {r0['many']['state_max_abs']:.3g}, log-mel launches "
            f"{r0['many']['launches']} and {r0['many']['four_launches']}")
    check(len({r["checksum"] for r in res}) == 1,
          f"{label}: the ranks' states differ")
    return r0


def _hold_nccl(label: str, key: str, jobs: list, ranks: list, inputs: dict,
               out: dict) -> None:
    """Phase 12's NCCL jobs (checks, graph jobs, timing) as ``ranks``
    returned them, held and logged; their log-mel launches added to
    ``out``."""
    card = out["card"]
    for n, job in enumerate(jobs):
        res = [r[n] for r in ranks]
        where = f"stage {job['stage']} --dp {job['dp']}, {label}" \
            if "stage" in job else label
        if job["kind"] == "check":
            skip = ("g_rms_ratio",) if job["dp"] == "shard_map" else ()
            out["gaps"][f"stage{job['stage']}_{job['dp']}_nccl_{key}"] = \
                _hold_to_single(where + " (graphed)", res,
                                inputs[job["stage"]]["metrics"], job["stage"],
                                skip)
        elif job["kind"] == "graph":
            out.setdefault(f"graphs_{key}", []).append(
                _hold_graphs(where, res))
            out["dp_graph_replays"] += sum(
                r["graphed_launches"] + r.get("many", {}).get("launches", 0)
                + r.get("many", {}).get("four_launches", 0) for r in res)
            out["dp_launches"] += sum(
                r["eager_launches"] + r["graphed_launches"]
                + r.get("many", {}).get("launches", 0)
                + r.get("many", {}).get("four_launches", 0) for r in res)
            continue
        out["dp_launches"] += sum(r["launches"] for r in res)
    t = ranks[0][-1]
    med = {k: float(np.median(t[k])) for k in ("dp_ms", "dp_eager_ms",
                                               "plain_ms")}
    out[f"nccl_{key}"] = [r[-1] for r in ranks]

    def ms(k):
        return ", ".join(f"{x:.2f}" for x in t[k]) + f" (median {med[k]:.2f})"

    log(f"[dp] {label}, flagship bf16 [{DP_BATCH // len(ranks)}, 8192] per "
        f"rank (CUDA events, each step with its metrics' read): DP step "
        f"graphed {ms('dp_ms')} ms, eager {ms('dp_eager_ms')} ms; "
        f"single-process step graphed {ms('plain_ms')} ms; graphed DP - "
        f"graphed single {med['dp_ms'] - med['plain_ms']:+.2f} ms; one "
        f"graphed DP step under the profiler: "
        f"{t['profile']['launches_per_call']:.0f} device activities, kernel "
        f"time {t['profile']['kernel_ms_per_call']:.2f} ms, busy (union) "
        f"{t['profile']['device_busy']:.3f} of "
        f"{t['profile']['profiled_wall_ms_per_call']:.2f} ms; "
        f"all-reduce G {t['reduce_ms']['g']:.3f} ms, D "
        f"{t['reduce_ms']['d']:.3f} ms; on {card}")


def phase_data_parallel(tmp: Path, seed: int = DEFAULT_PATH_SEED) -> dict:
    """Both training steps over ranks at the flagships' full width (main
    path), sequence-sharded vocoding and the serving split over a device
    list; the log-mel launches are counted in the ranks."""
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch._graphs import disable_graphs
    from music_synthesis_tpu_torch.parallel import mesh
    from music_synthesis_tpu_torch.parallel.seqshard import (
        make_seqshard_vocode, receptive_field_frames)
    from music_synthesis_tpu_torch.serve import ServeConfig, SynthService
    from music_synthesis_tpu_torch.train.flagship import (flagship_config,
                                                          zoo_train_state)
    from music_synthesis_tpu_torch.train.checkpoint import save_checkpoint

    card = card_name_and_power()
    out = {"card": card}
    inputs = _dp_inputs(tmp, seed)
    # The bf16 flagship for the timing (G from the zoo, D seeded, past the
    # gate: the recipe's adversarial step).
    entry = zoo.load_pretrained("vocoder_istft")
    cfg16 = flagship_config(entry)
    st16 = zoo_train_state(cfg16, entry, "cuda", seed=cfg16.train.seed)
    st16 = dataclasses.replace(st16, step=cfg16.train.g_warmup_steps)
    save_checkpoint(tmp / "dp_state_bf16.pt", st16)
    del st16
    time_job = {"kind": "time", "cfg": cfg16, "state": str(tmp / "dp_state_bf16.pt"),
                "batch": inputs[2]["batch"], "steps": 3, "plain": False}

    # Two gloo ranks on one card, eager (gloo's collectives run on the
    # host): both modes of both stages, then timing.
    jobs = ([_check_job(inputs, s, dp) for s in (2, 1)
             for dp in ("jit", "shard_map")] + [time_job])
    t0 = time.perf_counter()
    ranks = mesh.launch(dp_rank_jobs, DP_RANKS, (jobs,), backend="gloo",
                        devices=["cuda:0"] * DP_RANKS)
    out["gloo_s"] = time.perf_counter() - t0
    gaps = {}
    for n, job in enumerate(jobs[:-1]):
        label = f"stage {job['stage']} --dp {job['dp']}, 2 gloo ranks on cuda:0"
        skip = ("g_rms_ratio",) if job["dp"] == "shard_map" else ()
        gaps[f"stage{job['stage']}_{job['dp']}"] = _hold_to_single(
            label, [r[n] for r in ranks], inputs[job["stage"]]["metrics"],
            job["stage"], skip)
    out["gaps"] = gaps
    timing = [r[-1] for r in ranks]
    out["gloo_bf16"] = timing
    log(f"[dp] flagship bf16 step per rank, 2 gloo ranks sharing cuda:0 (not "
        f"a scaling number: both ranks run on one card): " + "; ".join(
            f"rank {n}: {', '.join(f'{x:.2f}' for x in t['dp_ms'])} ms"
            for n, t in enumerate(timing))
        + f"; gradient all-reduce through the host (gloo): G "
        f"{timing[0]['reduce_ms']['g']:.2f} ms ({timing[0]['n_params']['g']} "
        f"floats), D {timing[0]['reduce_ms']['d']:.2f} ms "
        f"({timing[0]['n_params']['d']} floats); on {card}")
    out["dp_launches"] = sum(r[n]["launches"] for r in ranks
                             for n in range(len(jobs)))
    out["dp_graph_replays"] = 0

    # NCCL: every check job (now one graph per rank), the graph jobs and
    # the timing, on one rank; on two cards when there are two.
    nccl_jobs = ([_check_job(inputs, s, dp) for s in (2, 1)
                  for dp in ("jit", "shard_map")]
                 + _graph_jobs(tmp, seed) + [{**time_job, "plain": True}])
    t0 = time.perf_counter()
    ranks = mesh.launch(dp_rank_jobs, 1, (nccl_jobs,), backend="nccl",
                        devices=["cuda:0"])
    out["nccl_s"] = time.perf_counter() - t0
    _hold_nccl("1 NCCL rank", "world1", nccl_jobs, ranks, inputs, out)
    if torch.cuda.device_count() >= 2:
        ranks = mesh.launch(dp_rank_jobs, 2, (nccl_jobs,), backend="nccl",
                            devices=["cuda:0", "cuda:1"])
        _hold_nccl("2 NCCL ranks on cuda:0/cuda:1", "2cards", nccl_jobs,
                   ranks, inputs, out)
    else:
        log(f"[dp] 2 NCCL ranks on two cards: not run ({torch.cuda.device_count()} "
            f"card visible; NCCL refuses two ranks on one device)")

    # Sequence-sharded vocoding over [cuda:0, cuda:0], fp32, TF32 off: one
    # graph per shard, against its eager run and against one device.
    voc = entry.model("cuda", "float32")
    t_frames = 344  # 4 s at hop 256
    mel = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, t_frames, voc.cfg.n_mels)).astype(np.float32)).cuda()
    fn = make_seqshard_vocode(voc, ["cuda:0", "cuda:0"])
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), \
            torch.inference_mode():
        with disable_graphs():
            eager = fn(mel).clone()
        sharded = [fn(mel).clone() for _ in range(2)]
        direct = voc(mel)
    programs = fn.programs[torch.device("cuda:0")]
    check(len(programs.programs) == 2, f"seqshard captured "
          f"{len(programs.programs)} graphs, not one per shard")
    graphed_gap = max(_gap([g], [eager]) for g in sharded)
    h = receptive_field_frames(voc.cfg) + 2
    mid = slice(h * voc.cfg.hop_length, -h * voc.cfg.hop_length)
    check(sharded[0].shape == direct.shape, f"seqshard {tuple(sharded[0].shape)}")
    err = (sharded[0][:, mid] - direct[:, mid]).abs().max().item()
    out["seqshard"] = {"graphed_vs_eager": graphed_gap, "err": err,
                       "pool_bytes": programs.pool_bytes()}
    log(f"[dp] seqshard vocode [2, {t_frames}] over [cuda:0, cuda:0] (halo "
        f"{h} frames, one graph per shard, pool {programs.pool_bytes()} B): "
        f"max |graphed - eager| {graphed_gap:.3g} over two calls (the first "
        f"shard's piece copied out before the second replay); interior vs "
        f"one device: max abs err {err:.3g} (FP32_TOL {FP32_TOL})")
    check(graphed_gap == 0, f"seqshard graphed vs eager: {graphed_gap}")
    check(err <= FP32_TOL, f"seqshard vocode: {err} > {FP32_TOL}")
    out["seqshard_err"] = err

    # The serving split/gather over [cuda:0, cuda:0] against one device.
    sc = ServeConfig(composer="specgan_flux", vocoder="vocoder_istft",
                     batch_buckets=(2, 4), patch_buckets=(1, 2))
    one = SynthService(sc, warmup=False)
    two = SynthService(dataclasses.replace(sc, mesh_devices=2),
                       devices=["cuda:0", "cuda:0"], warmup=False)
    try:
        check(two.health()["mesh_devices"] == 2, "health mesh_devices")
        rows = two._z_rows(7, 3, 2)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            a, b = two._execute(2, rows), one._execute(2, rows)
        err = float(np.abs(a - b).max())
        log(f"[dp] serving split over [cuda:0, cuda:0] vs one device (3 clips, "
            f"bucket 4, fp32, TF32 off): max abs err {err:.3g} (FP32_TOL)")
        check(err <= FP32_TOL and np.isfinite(a).all(), f"split serving {err}")
        out["serve_split_err"] = err
    finally:
        one.close()
        two.close()
    if torch.cuda.device_count() < 2:
        try:
            SynthService(dataclasses.replace(sc, mesh_devices=2), warmup=False)
        except RuntimeError as e:
            log(f"[dp] SynthService(mesh_devices=2) on one card raises: {e}")
            out["mesh2_refusal"] = str(e)
        else:
            raise AssertionError("mesh_devices=2 on one card did not raise")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the JAX package's last modules in the port: native WAV I/O, the
# extract_features / eval_stage1 / parity / average_ckpts CLIs, torch.export
# deployment and the steps' named regions.


def composer_float64(gen, z: torch.Tensor) -> torch.Tensor:
    """``SpectrogramGenerator.forward`` in float64 on a float64 copy of
    ``gen`` (the module's own forward casts to fp32): the exact answer the
    fp32 composer's output is compared with in ``eval_stage1_gaps``."""
    import copy

    import torch.nn.functional as F

    m = copy.deepcopy(gen).double()
    for mod in m.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    cfg = m.cfg
    x = m.latent_in(z.double()).reshape(z.shape[0], cfg.initial_frames,
                                        cfg.base_channels).transpose(1, 2)
    for i in range(len(cfg.upsample_factors)):
        x = F.leaky_relu(x, cfg.leaky_slope)
        x = getattr(m, f"upsample_{i}")(x)
        x = getattr(m, f"res_{i}")(x)
    x = m.conv_out(F.leaky_relu(x, cfg.leaky_slope))
    return torch.tanh(cfg.out_temperature * x).transpose(1, 2)


def eval_stage1_inputs(seed: int = DEFAULT_PATH_SEED):
    """``(cfg, entry, z)`` of phase 13's card-vs-CPU eval_stage1 check: the
    zoo composer's pipeline config as the CLI builds it, and 64 seeded
    latents."""
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.config import PipelineConfig

    e = zoo.load_pretrained("specgan_flux")
    cfg = dataclasses.replace(PipelineConfig(specgan=e.config),
                              frontend=e.frontend, mel_scaler=e.mel_scaler)
    z = np.random.default_rng(seed).standard_normal(
        (EVAL1_N, e.config.latent_dim)).astype(np.float32)
    return cfg, e, torch.from_numpy(z)


def eval_stage1_gaps(corpus: Path) -> dict:
    """|fp32 - float64| per eval_stage1 metric on the CPU, on ``corpus``
    (the rich corpus) and ``eval_stage1_inputs``' latents: the composer in
    fp32 against ``composer_float64``, the log-mel's plain version in fp32
    against float64 on the same padded audio, the statistics in numpy on
    each."""
    from music_synthesis_tpu_torch.data.dataset import AudioDataset
    from music_synthesis_tpu_torch.ops import logmel as L
    from music_synthesis_tpu_torch.scripts import eval_stage1 as E

    cfg, e, z = eval_stage1_inputs()
    gen = e.model("cpu")
    with torch.inference_mode():
        m32, _ = E.evaluate(cfg, gen, corpus, z, 0)
        fake64 = composer_float64(gen, z).numpy()
        seg = cfg.specgan.n_frames * cfg.frontend.hop_length
        ds = AudioDataset(corpus, sample_rate=cfg.frontend.sample_rate,
                          segment_length=seg)
        wav = torch.from_numpy(ds.sample_batch(2**28, EVAL1_N, seed=4321))
        padded, n = L.padded_input(wav, cfg.frontend, True)
        mel = L.log_mel_frames_plain(padded.double(), cfg.frontend, n)
        real64 = ((mel - cfg.mel_scaler.shift)
                  / cfg.mel_scaler.scale).numpy()
    m64 = E.score(fake64, real64, 0)
    return {k: abs(m32[k] - m64[k]) for k in EVAL1_METRICS}


def native_io_check(tmp: Path, rng: np.random.Generator) -> dict:
    """A 30 s 44.1 kHz stereo PCM16 clip decoded and resampled to 22.05 kHz
    by the C++ library against scipy: the interior within 2e-3
    (``tests/test_native.py``'s tolerance), host ms of each (median of 3)."""
    import scipy.io.wavfile

    from music_synthesis_tpu_torch.data import native
    from music_synthesis_tpu_torch.utils.wav import load_wav

    check(native.available(), "the native IO library is not available")
    sr = 44100
    stereo = np.stack([test_audio(rng, 1, 30 * sr, sr)[0] for _ in range(2)], 1)
    path = tmp / "native_30s_stereo.wav"
    scipy.io.wavfile.write(path, sr, (stereo * 32767.0).astype(np.int16))
    out, host_ms = {}, {}
    for name, use_native in (("native", True), ("scipy", False)):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out[name] = load_wav(path, 22050, use_native=use_native)
            times.append(1e3 * (time.perf_counter() - t0))
        host_ms[name] = float(np.median(times))
    check(out["native"].shape == out["scipy"].shape == (15 * sr,),
          f"decoded lengths {out['native'].shape} {out['scipy'].shape}")
    err = float(np.abs(out["native"][200:-200] - out["scipy"][200:-200]).max())
    check(err <= 2e-3, f"native vs scipy resampling: {err} > 2e-3")
    log(f"[native] 30 s 44.1 kHz stereo -> 22.05 kHz mono: native "
        f"{host_ms['native']:.1f} ms, scipy {host_ms['scipy']:.1f} ms (host "
        f"clock, median of 3); interior max abs diff {err:.3g}")
    return {"host_ms": host_ms, "max_abs_diff": err}


def kernel_at(wav: torch.Tensor, cfg, for_vocoder: bool) -> dict:
    """The kernel in "exact" precision at ``wav``'s shape against its plain
    version evaluated in float64 (``TOL["exact"]``), its times (both
    paths), the plain version's time and the bounds. Launches made here
    are comparisons, not a path's."""
    from music_synthesis_tpu_torch.ops import logmel as L

    padded, n_frames = L.padded_input(wav, cfg, for_vocoder)
    want = L.log_mel_frames_plain(padded.double(), cfg, n_frames)
    got = L.logmel_kernel(padded, cfg, n_frames, "exact")
    torch.cuda.synchronize()
    err = (got.double() - want).abs().max().item()
    shape = list(wav.shape)
    check(np.isfinite(err) and err <= TOL["exact"],
          f"log-mel kernel {shape} exact: max abs err {err} > {TOL['exact']}")
    row = {"shape": shape, "variant": "for_vocoder" if for_vocoder
           else "log_mel", "frames": n_frames, "max_abs_err": err,
           "ms": time_ms(lambda: L.logmel_kernel(padded, cfg, n_frames,
                                                 "exact")),
           "ms_fast": time_ms(lambda: L.logmel_kernel(padded, cfg, n_frames,
                                                      "fast")),
           "plain_ms": time_ms(lambda: L.log_mel_frames_plain(padded, cfg,
                                                              n_frames)),
           **logmel_bound_ms(shape[0], padded.shape[1], n_frames, cfg)}
    log(f"[kernel] logmel {shape} {row['variant']} ({n_frames} frames): exact "
        f"err {err:.3g}; exact (FFMA) {row['ms']:.4f} ms, fast (3xTF32) "
        f"{row['ms_fast']:.4f} ms, plain {row['plain_ms']:.4f} ms; FFMA bound "
        f"{row['ffma_ms']:.4f} ms ({row['ffma_by']}), 3xTF32 bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), on "
        f"{card_name_and_power()}")
    return row


def phase_extract_features(tmp: Path) -> dict:
    """``extract_features`` on a 4 s clip (main path: the launch count is
    set to 0 just before and read just after; one launch), then the kernel
    at its shape against float64."""
    from music_synthesis_tpu_torch.config import FRONTEND_CPU_CLIP
    from music_synthesis_tpu_torch.data.dataset import make_synthetic_corpus
    from music_synthesis_tpu_torch.ops import logmel as L
    from music_synthesis_tpu_torch.ops.logmel import logmel_launches
    from music_synthesis_tpu_torch.scripts import extract_features
    from music_synthesis_tpu_torch.utils.wav import load_wav

    cfg = FRONTEND_CPU_CLIP.frontend
    clip = make_synthetic_corpus(tmp / "clip_4s", n_clips=1, seconds=4.0)[0]
    logmel_launches.n_calls = 0
    lines = run_cli(extract_features, [str(clip), "--out",
                                       str(tmp / "mel.npy")])
    launches = logmel_launches.n_calls
    mel = np.load(tmp / "mel.npy")
    check(launches == 1, f"extract_features launched the kernel {launches} "
          "times")
    check(mel.shape == (341, 128) and np.isfinite(mel).all(),
          f"extract_features mel {mel.shape}")
    wav = torch.from_numpy(load_wav(clip, cfg.sample_rate))[None].cuda()
    check(tuple(wav.shape) == (1, 88200), f"clip {tuple(wav.shape)}")
    row = kernel_at(wav, cfg, for_vocoder=False)
    # What the CLI times: padding, one launch and a synchronise (host
    # clock, median of 21 calls).
    host = []
    for _ in range(21):
        t0 = time.perf_counter()
        L.fused_log_mel(wav, cfg, "exact")
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    row["cli_call_host_ms"] = float(np.median(host))
    log(f"[extract_features] the CLI's timed call (pad, launch, synchronise): "
        f"{row['cli_call_host_ms']:.4f} ms, host clock, median of 21")
    padded, n_frames = L.padded_input(wav, cfg, False)
    want = L.log_mel_frames_plain(padded.double(), cfg, n_frames)[0]
    cli_err = float(np.abs(mel - want.cpu().numpy()).max())
    check(cli_err <= TOL["exact"], f"extract_features' mel vs float64: "
          f"{cli_err} > {TOL['exact']}")
    return {"cli_line": lines[0], "launches": launches, "kernel": row,
            "cli_mel_err": cli_err}


EVAL1_N = 64
EVAL1_METRICS = ("bin_mean_l2", "bin_std_l2", "real_flux", "fake_flux",
                 "flux_ratio", "eig_log_l2", "fake_rms", "real_rms")
# eval_stage1 on the card (fp32, cuDNN TF32 off, the "exact" kernel)
# against the CPU (fp32) with the same latents, |card - cpu| per metric:
# the CPU's own |fp32 - float64| gap on the rich corpus (``eval_stage1_gaps``,
# `python3 chip_smoke.py --cpu-gaps` on the card machine's x86-64 CPU,
# PyTorch 2.11.0+cu128), times 10: the card and the CPU each round in fp32
# at other places (up to the gap each), and cuDNN may pick Winograd or FFT
# convolutions, whose fp32 rounding is several times a direct one's. (The
# real side: the kernel is within ~1e-6 of float64, so the card's real
# patches differ from the CPU's by the CPU's own gap.)
EVAL1_CPU_GAPS = {"bin_mean_l2": 1.3074991922767953e-06,
                  "bin_std_l2": 5.553381846046257e-08,
                  "real_flux": 8.263396356067432e-10,
                  "fake_flux": 2.3059532894276202e-09,
                  "flux_ratio": 2.0675396950053937e-08,
                  "eig_log_l2": 1.2087643774805201e-08,
                  "fake_rms": 3.516677615778008e-08,
                  "real_rms": 5.0883604663098936e-08}
EVAL1_GAP_FACTOR = 10.0


def eval1_tol() -> dict:
    return {k: EVAL1_GAP_FACTOR * v for k, v in EVAL1_CPU_GAPS.items()}


def phase_eval_stage1(tmp: Path) -> dict:
    """``eval_stage1 --zoo specgan_flux --n 64`` on phase 10's corpus (main
    path: the launch count is set to 0 just before and read just after; one
    launch), the kernel at [64, 32768] against float64, and the card's
    metrics against the CPU's."""
    from music_synthesis_tpu_torch.data.dataset import AudioDataset
    from music_synthesis_tpu_torch.ops.logmel import logmel_launches
    from music_synthesis_tpu_torch.scripts import eval_stage1

    corpus = tmp / "corpus_rich"
    logmel_launches.n_calls = 0
    t0 = time.perf_counter()
    metrics, anchors = eval_stage1.main([
        "--zoo", "specgan_flux", "--corpus", str(corpus), "--n",
        str(EVAL1_N), "--out", str(tmp / "eval_stage1")])
    seconds = time.perf_counter() - t0
    launches = logmel_launches.n_calls
    check(launches == 1, f"eval_stage1 launched the kernel {launches} times")
    check(all(np.isfinite(metrics[k]) for k in EVAL1_METRICS)
          and metrics["n_patches"] == EVAL1_N, f"eval_stage1 {metrics}")
    check(set(anchors) == {"random_weights", "white_noise"} and all(
        np.isfinite(v) for a in anchors.values() for v in a.values()),
        f"eval_stage1 anchors {anchors}")
    log(f"[eval_stage1] zoo specgan_flux, {EVAL1_N} patches: {seconds:.2f} s "
        f"on {card_name_and_power()}; " + ", ".join(
            f"{k} {metrics[k]:.5g}" for k in EVAL1_METRICS))

    cfg, e, z = eval_stage1_inputs()
    seg = cfg.specgan.n_frames * cfg.frontend.hop_length
    ds = AudioDataset(corpus, sample_rate=cfg.frontend.sample_rate,
                      segment_length=seg)
    wav = torch.from_numpy(ds.sample_batch(2**28, EVAL1_N, seed=4321)).cuda()
    check(tuple(wav.shape) == (64, 32768), f"patches {tuple(wav.shape)}")
    row = kernel_at(wav, cfg.frontend, for_vocoder=True)

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        card, _ = eval_stage1.evaluate(cfg, e.model("cuda"), corpus, z, 0)
    cpu, _ = eval_stage1.evaluate(cfg, e.model("cpu"), corpus, z, 0)
    tol = eval1_tol()
    gaps = {k: abs(card[k] - cpu[k]) for k in EVAL1_METRICS}
    for k in EVAL1_METRICS:
        log(f"[eval_stage1] {k}: card {card[k]:.7g} CPU {cpu[k]:.7g}, |gap| "
            f"{gaps[k]:.3g} (tolerance {tol[k]:.3g})")
        check(gaps[k] <= tol[k], f"eval_stage1 {k} card vs CPU: {gaps[k]} > "
              f"{tol[k]}")
    return {"seconds": seconds, "launches": launches, "metrics": metrics,
            "anchors": anchors, "kernel": row, "card_vs_cpu": gaps,
            "tolerance": tol}


def phase_parity(tmp: Path) -> dict:
    """``parity`` on phase 10's eval WAVs (eval_checkpoint writes the real,
    resynthesized and GL-refined clips, no GL-anchor WAV): real against
    itself is 0, against the resynthesis and the refinement > 0."""
    import shutil

    from music_synthesis_tpu_torch.scripts import parity

    src = tmp / "eval_zoo"
    dirs = {}
    for kind in ("real", "resynth", "refined"):
        d = dirs[kind] = tmp / f"parity_{kind}"
        d.mkdir()
        for f in sorted(src.glob(f"{kind}_*.wav")):
            shutil.copy(f, d / f.name.split("_", 1)[1])
    out = {}
    for a, b in (("real", "real"), ("real", "resynth"), ("real", "refined")):
        line = json.loads(run_cli(parity, [str(dirs[a]), str(dirs[b])])[-1])
        check(len(line["per_file"]) == 8, f"parity {a}/{b} pairs")
        out[f"{a}_vs_{b}"] = line["value"]
    check(out["real_vs_real"] == 0.0, f"parity(d, d) = {out['real_vs_real']}")
    check(out["real_vs_resynth"] > 0.0 and out["real_vs_refined"] > 0.0,
          f"parity against the vocoder's audio {out}")
    log(f"[parity] {out}")
    return out


def phase_average_ckpts(lifecycle: dict, tmp: Path) -> dict:
    """``average_ckpts`` over phase 8's stage-2 checkpoints, the averaged
    weights against the float64 mean (exact), ``eval_checkpoint --run`` on
    the averaged run."""
    from music_synthesis_tpu_torch.scripts import average_ckpts, eval_checkpoint
    from music_synthesis_tpu_torch.train.checkpoint import CheckpointManager

    run = Path(lifecycle["run2"])
    steps = CheckpointManager(run / "ckpt").all_steps()
    check(steps == [2, 4], f"phase 8's stage-2 checkpoints {steps}")
    out = tmp / "stage2_avg"
    run_cli(average_ckpts, ["--run", str(run), "--steps",
                            ",".join(map(str, steps)), "--out", str(out)])
    states = [CheckpointManager(run / "ckpt").restore(s) for s in steps]
    avg = CheckpointManager(out / "ckpt").restore()
    check(avg.g_ema is not None, "phase 8's stage-2 run keeps an EMA")
    for tree in ("g_params", "g_ema"):
        got = getattr(avg, tree)
        for name, t in got.items():
            mean = sum(getattr(s, tree)[name].double() for s in states) / 2
            check(torch.equal(t, mean.float()),
                  f"averaged {tree}.{name} is not the float64 mean")
    check((out / "STATUS").read_text().startswith("SWA average"), "STATUS")
    run_cli(eval_checkpoint, ["--run", str(out), "--corpus",
                              lifecycle["corpus"], "--out",
                              str(tmp / "eval_avg")])
    ev = json.loads((tmp / "eval_avg" / "eval.json").read_text())
    check(ev["checkpoint_step"] == 4 and all(
        np.isfinite(v) for v in ev["per_clip"]["dist"]), "eval of the average")
    log(f"[average_ckpts] steps {steps} -> {out}; eval --run distance "
        f"{ev['copy_synthesis_multires_stft_distance_mean']:.4f}")
    return {"steps": steps, "eval_distance":
            ev["copy_synthesis_multires_stft_distance_mean"]}


def phase_deploy(tmp: Path) -> dict:
    """Both artifacts for ``cuda,cpu`` from the zoo flagships (fp32),
    saved, read, loaded and run at batch 1 and 4 on the card against the
    live modules (``FP32_TOL``, cuDNN TF32 off), and once on the CPU; the
    file size and export seconds. On the card the artifact replays one
    CUDA graph per batch size: at batch 4 the graphed call bit for bit
    with the same artifact's eager call (``disable_graphs``) and within
    ``FP32_TOL`` of the live graphed module (the vocoder through a
    ``Programs``, the pipeline through ``GraphedPipeline``), TF32 off; a
    batch-1 result kept across a batch-4 call unchanged; the graphed,
    eager and live graphed ms at batch 4 (CUDA events) and the
    artifact's pool bytes."""
    from music_synthesis_tpu_torch import deploy, zoo
    from music_synthesis_tpu_torch._graphs import Programs
    from music_synthesis_tpu_torch.config import PipelineConfig
    from music_synthesis_tpu_torch.infer.generate import (GraphedPipeline,
                                                          generate)

    s1 = zoo.load_pretrained("specgan_flux")
    s2 = zoo.load_pretrained("vocoder_istft")
    voc_cfg = dataclasses.replace(s2.config, compute_dtype="float32")
    cfg = PipelineConfig(specgan=s1.config, vocoder=voc_cfg,
                         frontend=s2.frontend, mel_scaler=s2.mel_scaler)
    live = {"cuda": {}, "cpu": {}}
    for dev in live:
        comp = s1.model(dev)
        voc = s2.model(dev, "float32")
        live[dev]["vocoder"] = voc
        live[dev]["pipeline"] = lambda z, comp=comp, voc=voc: generate(
            cfg, comp, voc, z)
    comp, voc = s1.model("cuda"), live["cuda"]["vocoder"]
    voc_programs = Programs("cuda")
    pipe = GraphedPipeline(cfg, comp, voc)
    live_graphed = {"vocoder": lambda x: voc_programs("vocoder", voc, x),
                    "pipeline": lambda z: pipe(generate, z)}
    g = torch.Generator().manual_seed(DEFAULT_PATH_SEED)
    out = {}
    for kind in ("vocoder", "pipeline"):
        t0 = time.perf_counter()
        if kind == "vocoder":
            exported, meta = deploy.vocoder_artifact(
                s2.state_dict, voc_cfg, 64, batch=None,
                platforms=("cuda", "cpu"))
            shape = (64, voc_cfg.n_mels)
        else:
            exported, meta = deploy.pipeline_artifact(
                cfg, s1.state_dict, s2.state_dict, batch=None,
                platforms=("cuda", "cpu"))
            shape = (cfg.specgan.latent_dim,)
        export_s = time.perf_counter() - t0
        path = deploy.save_artifact(tmp / f"{kind}.msx", exported, meta)
        read = deploy.read_meta(path)
        check(read == json.loads(json.dumps(meta)) and read["platforms"] == [
            "cuda", "cpu"] and read["inputs"][0]["shape"][0] == "b",
            f"{kind} header {read}")
        row = {"file_mb": path.stat().st_size / 1e6, "export_s": export_s,
               "n_params_baked": read["n_params_baked"], "err": {}}
        for dev in ("cuda", "cpu"):
            art = deploy.load_artifact(path, device=dev)
            check(art.device.type == dev, f"{kind} program for {dev}")
            for b in ((1, 4) if dev == "cuda" else (1,)):
                x = torch.randn((b, *shape), generator=g).to(dev)
                with torch.inference_mode(), torch.backends.cudnn.flags(
                        enabled=True, allow_tf32=False):
                    got, want = art(x), live[dev][kind](x)
                check(got.device.type == dev and got.shape == want.shape,
                      f"{kind} on {dev}: {tuple(got.shape)}")
                err = (got.float() - want.float()).abs().max().item()
                row["err"][f"{dev}_b{b}"] = err
                check(err <= FP32_TOL, f"{kind} artifact on {dev} at batch "
                      f"{b} vs the live module: {err} > {FP32_TOL}")
            if dev == "cuda":
                row.update(graphed_artifact(kind, art, live_graphed[kind],
                                            shape, g))
        log(f"[deploy] {kind}: {row['file_mb']:.1f} MB, exported for cuda,cpu "
            f"in {export_s:.1f} s, {row['n_params_baked']:,} baked; max abs "
            f"err vs live {row['err']}; at batch 4 (CUDA events) the graphed "
            f"artifact {row['graphed_ms_b4']:.4f} ms, the eager artifact "
            f"{row['eager_ms_b4']:.4f} ms, the live graphed module "
            f"{row['live_graphed_ms_b4']:.4f} ms; graphed vs eager artifact "
            f"{row['graphed_vs_eager']:.3g}, vs the live graphed module "
            f"{row['graphed_vs_live']:.3g} (TF32 off); pool "
            f"{row['pool_bytes']} B; on {card_name_and_power()}")
        out[kind] = row
    return out


def graphed_artifact(kind: str, art, live_graphed, shape: tuple,
                     g: torch.Generator) -> dict:
    """Phase 13's checks and times of a loaded artifact's CUDA graphs."""
    from music_synthesis_tpu_torch._graphs import disable_graphs

    x1 = torch.randn((1, *shape), generator=g).cuda()
    x4 = torch.randn((4, *shape), generator=g).cuda()
    with torch.inference_mode():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            first = art(x1)
            kept = first.clone()
            graphed = art(x4)
            with disable_graphs():
                eager = art(x4)
            live = live_graphed(x4).clone()
            again = art(x4)
        torch.cuda.synchronize()
        check(torch.equal(first, kept), f"{kind}: the batch-1 result changed "
              "when the batch-4 graph replayed")
        check(torch.equal(graphed, eager) and torch.equal(again, eager),
              f"{kind}: graphed artifact not bit for bit with its eager call")
        vs_live = (graphed - live).abs().max().item()
        check(vs_live <= FP32_TOL, f"{kind}: graphed artifact vs the live "
              f"graphed module {vs_live} > {FP32_TOL}")
        ms = {"graphed_ms_b4": time_ms(lambda: art(x4), samples=11, reps=5,
                                       warmup=3)}
        with disable_graphs():
            ms["eager_ms_b4"] = time_ms(lambda: art(x4), samples=11, reps=5,
                                        warmup=3)
        ms["live_graphed_ms_b4"] = time_ms(lambda: live_graphed(x4),
                                           samples=11, reps=5, warmup=3)
    return {**ms, "graphed_vs_eager": (graphed - eager).abs().max().item(),
            "graphed_vs_live": vs_live,
            "graphed_over_live": ms["graphed_ms_b4"]
            / ms["live_graphed_ms_b4"],
            "programs": len(art.programs.programs),
            "pool_bytes": art.programs.pool_bytes()}


def phase_profiling(rng: np.random.Generator, tmp: Path) -> dict:
    """One flagship stage-2 step and one stage-1 step (after one warm-up
    each, and one traced step that ``region_split`` drops) under
    ``utils.profiling.trace``: every JAX region name the config's step
    opens is in the trace, and ``region_split``'s device ms per region."""
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch._graphs import disable_graphs
    from music_synthesis_tpu_torch.train import stage1, stage2
    from music_synthesis_tpu_torch.train.flagship import (
        flagship_config, stage1_flagship_config, zoo_train_state)
    from music_synthesis_tpu_torch.utils.profiling import (
        OUTSIDE, TRACE_FILE, region_split, step_regions, trace)

    entry = zoo.load_pretrained("vocoder_istft")
    cfg2 = flagship_config(entry)
    t = cfg2.train
    state2 = dataclasses.replace(
        zoo_train_state(cfg2, entry, "cuda", seed=t.seed),
        step=t.g_warmup_steps)
    wav = torch.from_numpy(test_audio(rng, t.batch_size, t.segment_length,
                                      cfg2.frontend.sample_rate)).cuda()
    entry1 = zoo.load_pretrained("specgan_flux")
    cfg1 = stage1_flagship_config(entry1)
    state1 = zoo_train_state(cfg1, entry1, "cuda", seed=cfg1.train.seed)
    mel = stage1_patches(rng, cfg1, "cuda")
    out = {}
    for stage, step in ((2, lambda: stage2.train_step(cfg2, state2, wav)),
                        (1, lambda: stage1.train_step(cfg1, state1, mel))):
        names = step_regions(cfg2 if stage == 2 else cfg1, stage)
        with disable_graphs():
            step()  # the eager warm-up (the trace runs eagerly)
        d = tmp / f"trace_stage{stage}"
        with trace(d):
            step()  # dropped by skip=1 (its first launches may lack records)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        split = region_split(d / TRACE_FILE, names, skip=1)
        missing = [n for n in names if not split[n]["found"]]
        check(not missing, f"stage-{stage} trace misses regions {missing}")
        check(split["d_step"]["device_ms"] > 0 and split["g_step"][
            "device_ms"] > 0, f"stage-{stage} split found no device work")
        log(f"[profile] stage-{stage} flagship step under the profiler: "
            f"{wall_ms:.1f} ms wall, on {card_name_and_power()}")
        log(f"[profile]   stage {stage}: {split[OUTSIDE]['no_launch_record']}"
            f" device launches without a host launch record in the trace")
        for name, row in split.items():
            log(f"[profile]   stage {stage} {name:16s} host "
                f"{row['host_ms']:8.2f} ms, device {row['device_ms']:8.3f} "
                f"ms, {row['launches']:6.0f} launches; top "
                + "; ".join(f"{k} {v:.3f}" for k, v in row["top"]))
        out[f"stage{stage}"] = {"wall_ms": wall_ms, "regions": split}
    return out


def phase_port_modules(rng: np.random.Generator, tmp: Path,
                       lifecycle: dict) -> dict:
    """Phase 13, in phases 8-12's directory (phase 10's corpus and eval
    WAVs, phase 8's stage-2 run)."""
    out = {"native": native_io_check(tmp, rng),
           "extract_features": phase_extract_features(tmp),
           "eval_stage1": phase_eval_stage1(tmp),
           "parity": phase_parity(tmp),
           "average_ckpts": phase_average_ckpts(lifecycle, tmp),
           "deploy": phase_deploy(tmp),
           "profiling": phase_profiling(rng, tmp)}
    return out


def captured(fn, *args) -> tuple:
    """``fn(*args)``'s result and its stdout lines (printed here too)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(line)
    return result, lines


def phase_benchmark(tmp: Path) -> dict:
    """Phase 14: the bench's every scenario at full width with a few calls
    each (``BENCH_SMOKE_ITERS``), the RTF batch sweep at batches 8 and 16,
    and the serving load test at 5 and 0 ms of coalescing, with their
    checks; returns the record, the sweep, the serving lines and the
    bench's kernel launches by scenario."""
    from music_synthesis_tpu_torch import bench
    from music_synthesis_tpu_torch.scripts import bench_rtf_batch, bench_serve

    out = tmp / "bench_torch_full.json"
    rc, lines = captured(bench.main, ["--out", str(out)], {
        name: {"n_iters": n} for name, n in BENCH_SMOKE_ITERS.items()})
    record = json.loads(out.read_text())
    check(rc == 0 and not record["failed"],
          f"bench exit {rc}, failed scenarios {record['failed']}")
    check(len(lines) == 1, f"bench printed {len(lines)} stdout lines")
    contract = json.loads(lines[-1])
    check(set(contract) == {"metric", "value", "unit", "device",
                            "power_limit_w"}, f"contract line {contract}")
    results = record["results"]
    check(contract["metric"] == "fused_two_stage_inference_rtf"
          and contract["value"] == results["fused_two_stage_inference_rtf"]
          and contract["device"] == torch.cuda.get_device_name(0),
          f"contract line {contract}")
    missing = [k for k in bench.RESULT_KEYS if k not in results]
    check(not missing, f"the bench's record misses {missing}")
    bad = {k: v for k, v in results.items()
           if not (isinstance(v, (int, float)) and np.isfinite(v) and v > 0)}
    check(not bad, f"bench keys not finite and positive: {bad}")
    mfu = {k: v for k, v in results.items() if k.endswith("_mfu")}
    check(len(mfu) == 2 and all(0 < v <= 1.05 for v in mfu.values()),
          f"MFU out of (0, 1.05]: {mfu}")
    launches = record["notes"]["logmel_launches"]
    check(launches["bench_stage2_step"] == results["stage2_steps_run"]
          and launches["bench_frontend_ab"] == results["frontend_kernel_calls"]
          and sum(launches.values()) == launches["bench_stage2_step"]
          + launches["bench_frontend_ab"],
          f"bench kernel launches {launches} against its steps and calls")
    log(f"[bench] {json.dumps(results)}")
    log(f"[bench] MFU precision {record['notes']} on {card_name_and_power()}")

    sweep, _ = captured(bench_rtf_batch.main, [
        "--batches", "8,16", "--calls", str(BENCH_SWEEP_CALLS)])
    check([r["batch"] for r in sweep["sweep"]] == [8, 16]
          and all(np.isfinite(r["rtf_per_chip"]) and r["rtf_per_chip"] > 0
                  for r in sweep["sweep"]), f"RTF sweep {sweep}")
    serving = {}
    for ms in (5.0, 0.0):
        line, _ = captured(bench_serve.main, [
            "--requests", "8", "--concurrency", "4", "--coalesce-ms", str(ms)])
        check(line["answered"] == line["service_requests"] == 8,
              f"serving at {ms} ms answered {line['answered']} of 8")
        check(line["merge_ratio"] == 1.0 if ms == 0 else
              line["merge_ratio"] >= 1.0,
              f"merge ratio {line['merge_ratio']} at {ms} ms")
        check(0 < line["latency_p50_ms"] <= line["latency_p95_ms"],
              f"serving latencies {line}")
        serving[f"{ms:g}ms"] = line
    return {"record": record, "sweep": sweep, "serving": serving,
            "launches": launches}


def _outputs(out) -> list:
    """A path's outputs (a tensor or a tuple), copied out as fp32."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [t.detach().float().clone() for t in outs]


def _gap(a: list, b: list) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def graphed_against_eager(label: str, call, pool_bytes) -> dict:
    """One path's program on fixed inputs (``call()``, no host read inside),
    eager (``disable_graphs``) and graphed: three eager outputs (the card's
    own run-to-run gap is the largest difference between two of them), two
    graphed ones (the first call builds the graph when it is not built
    yet), each held to the first eager one; ms per call (``time_ms``),
    launches per call and the device's busy share (``profile_launches``)
    under both; ``pool_bytes()`` after. max |graphed - eager| must not
    exceed the eager gap."""
    from music_synthesis_tpu_torch._graphs import disable_graphs

    with torch.inference_mode():
        with disable_graphs():
            eager = [_outputs(call()) for _ in range(3)]
            eager_ms = time_ms(call)
            eager_prof = profile_launches(call)
        graphed = [_outputs(call()) for _ in range(2)]
        graphed_ms = time_ms(call)
        graphed_prof = profile_launches(call)
    floor = max(_gap(eager[i], eager[j]) for i, j in ((0, 1), (0, 2), (1, 2)))
    gap = max(_gap(g, eager[0]) for g in graphed)
    out = {"eager_ms": eager_ms, "graphed_ms": graphed_ms,
           "launches_per_eager_call": eager_prof["launches_per_call"],
           "launches_per_graphed_call": graphed_prof["launches_per_call"],
           "busy_eager": eager_prof["device_busy"],
           "busy_graphed": graphed_prof["device_busy"],
           "pool_bytes": pool_bytes(),
           "max_graphed_vs_eager": gap, "max_eager_vs_eager": floor}
    log(f"[graphs] {label}: eager {eager_ms:.4f} ms, graphed "
        f"{graphed_ms:.4f} ms per call (CUDA events, median of 21); "
        f"{out['launches_per_eager_call']:.0f} launches per eager call "
        f"({out['launches_per_graphed_call']:.0f} traced per replay); busy "
        f"{out['busy_eager']:.3f} eager, {out['busy_graphed']:.3f} graphed; "
        f"pool {out['pool_bytes']} B; max |graphed - eager| {gap:.3g}, "
        f"max |eager - eager| {floor:.3g}")
    check(gap <= floor, f"{label}: graphed vs eager {gap} > the card's own "
          f"eager run-to-run gap {floor}")
    return out


# Phase 15, the stage-2 flagship step: graphed against eager, per metric
# kind, |graphed - eager| / |eager| may not exceed the larger of this and
# the gap between two eager runs of the same steps (the stage-1 graph's
# STAGE1_TOL: its metrics agreed bit for bit, its state within 3e-8).
STAGE2_GRAPH_TOL = STAGE1_TOL
# The MSD alone in bf16 at [16, 8192], dense_groups_max_g 16 against 0:
# each logit and tap within this share of its peak magnitude (the two paths
# sum each output in another order before it is rounded to bf16, whose
# step is 2^-8 of the value; the error grows through five layers).
MSD_DENSE_TOL = 3e-2
STAGE2_GRAPH_NAMES = ("G", "D", "G Adam mu", "G Adam nu", "D Adam mu",
                      "D Adam nu", "EMA")


def _msd_dense_against_grouped(cfg, d_params, wav: torch.Tensor) -> dict:
    """(d) The flagship's MSD alone in its bf16, ``dense_groups_max_g`` 16
    against 0, from one set of parameters (``d_params`` with He gains, so
    that the taps are of order one): every logit and tap within
    ``MSD_DENSE_TOL`` of its peak; ms (CUDA events) of the forward and of
    the forward plus R1's double backward to D's parameters."""
    from music_synthesis_tpu_torch.models.discriminators import (
        MultiScaleDiscriminator)

    params = {k.removeprefix("msd."): v for k, v in he_gain_d(
        d_params, DEFAULT_PATH_SEED, TRAIN_D_OUT_GAIN).items()
        if k.startswith("msd.")}
    out, outs = {}, {}
    for max_g in (16, 0):
        msd = MultiScaleDiscriminator(dataclasses.replace(
            cfg.msd, dense_groups_max_g=max_g)).cuda()
        msd.load_state_dict(params, strict=True)
        with torch.no_grad():
            logits, feats = msd(wav)
            outs[max_g] = [t.float() for t in logits + sum(feats, [])]
        x = wav.detach().clone().requires_grad_()
        leaves = list(msd.parameters())

        def fwd():
            with torch.no_grad():
                msd(wav)

        def fwd_r1():
            ls, _ = msd(x)
            (gx,) = torch.autograd.grad(sum(l.float().sum() for l in ls), x,
                                        create_graph=True)
            torch.autograd.grad(gx.float().square().sum(), leaves,
                                allow_unused=True)  # conv_out.b

        out[f"max_g{max_g}"] = {"fwd_ms": time_ms(fwd, samples=11, reps=2),
                                "fwd_r1_ms": time_ms(fwd_r1, samples=5,
                                                     reps=2, warmup=1)}
    worst = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(outs[16], outs[0]))
    out["max_rel_to_peak"] = worst
    log(f"[graphs] MSD alone [{wav.shape[0]}, {wav.shape[1]}] "
        f"{cfg.msd.compute_dtype}: dense_groups_max_g 16 forward "
        f"{out['max_g16']['fwd_ms']:.3f} ms, + R1 double backward "
        f"{out['max_g16']['fwd_r1_ms']:.3f} ms; grouped (0) "
        f"{out['max_g0']['fwd_ms']:.3f} / {out['max_g0']['fwd_r1_ms']:.3f} "
        f"ms (CUDA events); logits and taps max |dense - grouped| / peak "
        f"{worst:.3g} (tolerance {MSD_DENSE_TOL})")
    check(worst <= MSD_DENSE_TOL, f"MSD dense vs grouped {worst:.3g} of the "
          f"peak > {MSD_DENSE_TOL}")
    return out


def stage2_graphs(rng: np.random.Generator) -> dict:
    """Phase 15's stage-2 part, the flagship step at [16, 8192] (zoo G,
    seeded D, ``flagship_config``, bf16): (a) 3 steps inside the warmup
    gate and 3 past it, graphed against two eager runs from one state (the
    same draws: both take them from the state's generator), D and D's Adam
    frozen inside the gate; (b) ``train_step_many`` (K = 4) against four
    graphed steps; (c) one log-mel launch per replay, the graph pool's
    bytes; (d) the MSD alone, dense against grouped; (e) eager and graphed
    step ms with and without ``dense_groups``, launches and busy share
    (``torch.profiler``), and ``region_split``'s d_step / g_step (eager)."""
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch._graphs import disable_graphs, pool_bytes
    from music_synthesis_tpu_torch.ops.logmel import logmel_launches
    from music_synthesis_tpu_torch.train import stage2
    from music_synthesis_tpu_torch.train.flagship import (flagship_config,
                                                          zoo_train_state)
    from music_synthesis_tpu_torch.utils.profiling import (
        OUTSIDE, TRACE_FILE, device_busy, region_split, step_regions, trace)

    t_start = time.perf_counter()
    entry = zoo.load_pretrained("vocoder_istft")
    cfg = flagship_config(entry)
    t = cfg.train
    check(cfg.msd.dense_groups_max_g == 16 and t.g_warmup_steps > 0,
          "the flagship lowers its MSD's grouped convolutions and gates D")
    state0 = zoo_train_state(cfg, entry, "cuda", seed=t.seed)
    batches = torch.from_numpy(np.stack([test_audio(
        rng, t.batch_size, t.segment_length, cfg.frontend.sample_rate)
        for _ in range(4)])).cuda()
    wav = batches[0]
    out = {}

    # (a) 3 + 3 steps, both sides of the gate, one program.
    def six(graphs: bool) -> tuple:
        st, metrics, frozen = state0, [], None
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(disable_graphs())
            for i in range(6):
                if i == 3:
                    d = _state_tensors(st)
                    frozen = (_gap(d[1], _state_tensors(state0)[1]) == 0
                              and all(_gap(a, b) == 0 for a, b in zip(
                                  d[4:6], _state_tensors(state0)[4:6]))
                              and st.d_opt.count == 0)
                    st = dataclasses.replace(st, step=t.g_warmup_steps)
                st, m = stage2.train_step(cfg, st, wav)
                metrics.append(m)
        return metrics, _state_tensors(st), frozen, st.d_opt.count

    runs = [six(False), six(False), six(True)]
    (eager_a, sa, fa, ca), (eager_b, sb, fb, cb), (graphed, sg, fg, cg) = runs
    check(fa and fb and fg, "D or D's Adam moved inside the warmup gate "
          f"(eager {fa}, {fb}; graphed {fg})")
    check(ca == cb == cg == 3, f"D's Adam counts {ca}, {cb}, {cg} != 3")
    check(all(m["d_update_norm"] == 0 for run in (eager_a, graphed)
              for m in run[:3]), "a D update inside the gate")
    state_gaps = {name: {"graphed_vs_eager": _gap(g, a),
                         "eager_vs_eager": _gap(b, a)}
                  for name, a, b, g in zip(STAGE2_GRAPH_NAMES, sa, sb, sg)}
    log("[graphs] stage-2 flagship, the state after 3 + 3 steps, max "
        "|graphed - eager| (max |eager - eager|): " + ", ".join(
            f"{k} {v['graphed_vs_eager']:.3g} ({v['eager_vs_eager']:.3g})"
            for k, v in state_gaps.items()))
    kinds = {k: kind for names, kind in ((TRAIN_LOSSES, "loss"),
                                         (TRAIN_GRAD_NORMS, "grad_norm"))
             for k in names}

    def rel(a, b):
        return {k: max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                       for x, y in zip(a, b)) for k in kinds}

    rel_graphed, rel_eager = rel(graphed, eager_a), rel(eager_b, eager_a)
    bitwise = all(x == y for x, y in zip(graphed, eager_a))
    log("[graphs] stage-2 flagship, 3 + 3 steps, graphed vs eager |diff| / "
        f"|eager| (every metric equal bit for bit: {bitwise}): " + ", ".join(
            f"{k} {v:.3g}" for k, v in rel_graphed.items()))
    log("[graphs] stage-2 flagship, eager vs eager: " + ", ".join(
        f"{k} {v:.3g}" for k, v in rel_eager.items()))
    for k, kind in kinds.items():
        tol = max(STAGE2_GRAPH_TOL[kind], rel_eager[k])
        check(rel_graphed[k] <= tol, f"graphed stage-2 step: {k} "
              f"{rel_graphed[k]:.3g} from the eager step > {tol:.3g}")
    out["gate"] = {"metrics_bitwise": bitwise, "rel_graphed_vs_eager":
                   rel_graphed, "rel_eager_vs_eager": rel_eager,
                   "state_max_abs": state_gaps}

    # (b) train_step_many, K = 4, against four graphed steps; (c) one
    # launch per replay.
    past = dataclasses.replace(state0, step=t.g_warmup_steps)
    before = logmel_launches.n_calls
    st, m_many = stage2.train_step_many(cfg, past, batches)
    many_launches = logmel_launches.n_calls - before
    s_many = _state_tensors(st)
    st = past
    before = logmel_launches.n_calls
    for w in batches:
        st, m_four = stage2.train_step(cfg, st, w)
    four_launches = logmel_launches.n_calls - before
    s_four = _state_tensors(st)
    many_gap = {name: _gap(a, b)
                for name, a, b in zip(STAGE2_GRAPH_NAMES, s_many, s_four)}
    rel_many = rel([m_many], [m_four])
    log(f"[graphs] train_step_many K=4 against 4 graphed steps: metrics "
        f"equal {m_many == m_four} (|diff| / |steps| " + ", ".join(
            f"{k} {v:.3g}" for k, v in rel_many.items()) + "), state max "
        "|diff| " + ", ".join(f"{k} {v:.3g}" for k, v in many_gap.items())
        + f"; log-mel launches {many_launches} and {four_launches}")
    for k, kind in kinds.items():
        tol = max(STAGE2_GRAPH_TOL[kind], rel_eager[k])
        check(rel_many[k] <= tol, f"train_step_many: {k} {rel_many[k]:.3g} "
              f"from four steps > {tol:.3g}")
    check(many_launches == four_launches == 4,
          f"log-mel launches: {many_launches} in train_step_many, "
          f"{four_launches} in 4 steps (1 per replay)")
    step = stage2.graphed_step(cfg, wav.shape, wav.device)
    check(step.program.graph is not None and
          step.program.counts_per_replay["logmel_kernel"] == 1,
          "the stage-2 graph holds one log-mel launch")
    out["many"] = {"metrics_equal": m_many == m_four, "rel": rel_many,
                   "state_max_abs": many_gap, "launches": many_launches,
                   "pool_bytes": pool_bytes(step.program.pool, wav.device)}
    log(f"[graphs] the stage-2 flagship graph's pool holds "
        f"{out['many']['pool_bytes']} B")

    log(f"[graphs] stage-2 (a)-(c) took {time.perf_counter() - t_start:.1f} s")

    # (d) the MSD alone, dense against grouped.
    out["msd"] = _msd_dense_against_grouped(cfg, state0.d_params, wav)

    # (e) the step, eager and graphed, with and without dense_groups. The
    # eager launches and kernel ms come from the traced step that
    # region_split reads (its first traced step is dropped), the eager
    # busy share from the union of both traced steps' device intervals.
    grouped_cfg = dataclasses.replace(cfg, msd=dataclasses.replace(
        cfg.msd, dense_groups_max_g=0))
    top = [OUTSIDE, "frontend", "generator_fwd", "d_step", "g_step", "ema"]
    for label, c in (("dense16", cfg), ("grouped", grouped_cfg)):
        t_part = time.perf_counter()
        holder = {"state": past}

        def one(c=c):
            holder["state"], _ = stage2.train_step(c, holder["state"], wav)

        with disable_graphs():
            eager_ms = time_ms(one, samples=3, reps=1, warmup=1)
        t_trace = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="stage2_regions_") as d:
            torch.cuda.synchronize()
            with trace(d):
                t0 = time.perf_counter()
                one()  # dropped by skip=1
                one()
                torch.cuda.synchronize()
                traced_ms = 1e3 * (time.perf_counter() - t0)
            split = region_split(Path(d) / TRACE_FILE, step_regions(c, 2),
                                 skip=1)
            busy_eager = device_busy(Path(d) / TRACE_FILE, traced_ms / 1e3)
        t_trace = time.perf_counter() - t_trace
        graphed_ms = time_ms(one, samples=5, reps=2, warmup=2)
        graphed_prof = profile_launches(one, calls=1)
        eager_device = sum(split[n]["device_ms"] for n in top if n in split)
        row = {"eager_ms": eager_ms, "graphed_ms": graphed_ms,
               "launches_per_eager_call": sum(
                   split[n]["launches"] for n in top if n in split),
               "launches_per_graphed_call":
                   graphed_prof["launches_per_call"],
               "kernel_ms_eager": eager_device,
               "kernel_ms_graphed": graphed_prof["kernel_ms_per_call"],
               "busy_eager": busy_eager,
               "busy_graphed": graphed_prof["device_busy"],
               "d_step_device_ms": split["d_step"]["device_ms"],
               "g_step_device_ms": split["g_step"]["device_ms"],
               "r1_device_ms": split["r1_penalty"]["device_ms"],
               "seconds": time.perf_counter() - t_part,
               "trace_seconds": t_trace}
        log(f"[graphs] stage-2 step [16, 8192] bf16 ({label}): eager "
            f"{eager_ms:.3f} ms (median of 3 steps), graphed "
            f"{graphed_ms:.3f} ms (median of 5 samples of 2) per step (CUDA "
            f"events, with the metrics' host read); "
            f"{row['launches_per_eager_call']:.0f} kernel launches per "
            f"eager step (the trace's), "
            f"{row['launches_per_graphed_call']:.0f} device activities "
            f"(kernels, copies, sets) traced per replay; "
            f"kernel time {row['kernel_ms_eager']:.2f} / "
            f"{row['kernel_ms_graphed']:.2f} ms; busy (union of device "
            f"intervals) {row['busy_eager']:.3f} eager (two traced steps, "
            f"{traced_ms:.1f} ms), {row['busy_graphed']:.3f} graphed; "
            f"eager regions: d_step {row['d_step_device_ms']:.2f} ms "
            f"(r1_penalty {row['r1_device_ms']:.2f}), g_step "
            f"{row['g_step_device_ms']:.2f} ms of kernels; "
            f"{row['seconds']:.1f} s, {t_trace:.1f} of them tracing")
        out[f"step_{label}"] = row
    out["seconds"] = time.perf_counter() - t_start
    log(f"[graphs] stage-2 part: {out['seconds']:.1f} s, on "
        f"{card_name_and_power()}")
    return out


def phase_cuda_graphs(rng: np.random.Generator) -> dict:
    """Phase 15: each graphed path against its eager launches (main path;
    the caller zeroes the launch counts before and reads them after)."""
    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch._graphs import disable_graphs, pool_bytes
    from music_synthesis_tpu_torch.config import E2E_INFERENCE
    from music_synthesis_tpu_torch.infer.copy_synthesis import CopySynthesizer
    from music_synthesis_tpu_torch.infer.generate import (
        GraphedPipeline, generate, generate_long)
    from music_synthesis_tpu_torch.ops.logmel import logmel_launches
    from music_synthesis_tpu_torch.serve import ServeConfig, SynthService
    from music_synthesis_tpu_torch.train import stage1
    from music_synthesis_tpu_torch.train.flagship import (
        stage1_flagship_config, zoo_train_state)

    out = {}
    # Path 1: generate, the flagship pair (specgan_flux fp32, vocoder_istft
    # bf16) at batch 16.
    comp_e = zoo.load_pretrained("specgan_flux")
    voc_e = zoo.load_pretrained("vocoder_istft")
    cfg = dataclasses.replace(
        E2E_INFERENCE, specgan=comp_e.config,
        vocoder=dataclasses.replace(voc_e.config, compute_dtype="bfloat16"),
        mel_scaler=voc_e.mel_scaler or E2E_INFERENCE.mel_scaler,
        frontend=voc_e.frontend or E2E_INFERENCE.frontend)
    pipe = GraphedPipeline(cfg, comp_e.model("cuda", "float32"),
                           voc_e.model("cuda", "bfloat16"))
    z = torch.from_numpy(rng.standard_normal(
        (16, cfg.specgan.latent_dim)).astype(np.float32)).cuda()
    out["generate"] = graphed_against_eager(
        "generate [16, 128] (specgan_flux fp32, vocoder_istft bf16)",
        lambda: pipe(generate, z), pipe.programs.pool_bytes)

    # Paths 2-3: every serving bucket and both stream calls of the
    # flagship service (fp32), on its worker thread.
    t0 = time.perf_counter()
    svc = SynthService(ServeConfig(composer="specgan_flux",
                                   vocoder="vocoder_istft"))
    warm_s = time.perf_counter() - t0
    progs = svc.programs[svc.device]
    out["serving_warm_s"] = warm_s
    out["serving_pool_bytes"] = progs.pool_bytes()
    out["serving_graphs"] = len(progs.programs)
    log(f"[graphs] service loaded and captured {len(progs.programs)} graphs "
        f"in {warm_s:.2f} s; its pool holds {out['serving_pool_bytes']} B")
    try:
        for b in svc.serve_cfg.batch_buckets:
            for n in svc.serve_cfg.patch_buckets:
                zb = torch.from_numpy(rng.standard_normal(
                    (b, n, svc.cfg.specgan.latent_dim)).astype(
                        np.float32)).to(svc.device)
                out[f"serve_b{b}_p{n}"] = svc._on_device(
                    graphed_against_eager, f"serving bucket ({b}, {n})",
                    lambda zb=zb: svc._pipelines[0](
                        generate_long, zb, svc.serve_cfg.crossfade_frames),
                    progs.pool_bytes)
        ic = svc.cfg.infer
        z1 = torch.from_numpy(rng.standard_normal(
            (1, svc.cfg.specgan.latent_dim)).astype(np.float32)).cuda()
        with torch.inference_mode():
            mel = svc.composer(z1)[:, : ic.chunk_frames].float().clone()
        for name, module, x in (("stream patch", svc.composer, z1),
                                ("stream chunk", svc.vocoder, mel)):
            out[name.replace(" ", "_")] = svc._on_device(
                graphed_against_eager, f"{name} {list(x.shape)}",
                lambda m=module, x=x: progs((m,), m, x), progs.pool_bytes)
        out["serving_pool_bytes_after"] = progs.pool_bytes()
    finally:
        svc.close()

    # Path 4: copy-synthesis at [16, 8192] (vocoder_istft in the card's
    # bf16): the log-mel kernel inside the graph, one launch per replay.
    cs = CopySynthesizer("vocoder_istft")
    wav = torch.from_numpy(test_audio(rng, 16, 8192,
                                      cs.frontend.sample_rate)).cuda()
    out["copy_synthesis"] = graphed_against_eager(
        "copy-synthesis [16, 8192] (vocoder_istft bf16)",
        lambda: cs.programs(cs.precision, cs._body, wav),
        cs.programs.pool_bytes)
    before = logmel_launches.n_calls
    with torch.inference_mode():
        for _ in range(10):
            cs.programs(cs.precision, cs._body, wav)
    torch.cuda.synchronize()
    after = logmel_launches.n_calls
    out["copy_synthesis"]["kernel_launches_over_10_replays"] = after - before
    log(f"[graphs] logmel_launches.n_calls before and after 10 replays of "
        f"the copy-synthesis graph: {before} -> {after}")
    check(after - before == 10, "10 replays of the copy-synthesis graph did "
          "not count 10 launches of the log-mel kernel")

    # Path 5: the stage-1 flagship step at [16, 128, 128]: five graphed
    # steps from one state against five eager ones (STAGE1_TOL), beside the
    # gap between two eager runs of the same five steps.
    entry = zoo.load_pretrained("specgan_flux")
    cfg1 = stage1_flagship_config(entry)
    state0 = zoo_train_state(cfg1, entry, "cuda", seed=cfg1.train.seed)
    mel1 = stage1_patches(rng, cfg1, "cuda")

    def five(graphs: bool) -> tuple[list[dict], list]:
        st, metrics = state0, []
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(disable_graphs())
            for _ in range(5):
                st, m = stage1.train_step(cfg1, st, mel1)
                metrics.append(m)
        return metrics, _state_tensors(st)

    (eager_a, sa), (eager_b, sb), (graphed, sg) = (five(False), five(False),
                                                   five(True))
    names = ("G", "D", "G Adam mu", "G Adam nu", "D Adam mu", "D Adam nu",
             "EMA")
    state_gaps = {name: {"graphed_vs_eager": _gap(g, a),
                         "eager_vs_eager": _gap(b, a)}
                  for name, a, b, g in zip(names, sa, sb, sg)}
    log("[graphs] stage-1 flagship, the state after 5 steps, max |graphed "
        "- eager| (max |eager - eager|): " + ", ".join(
            f"{k} {v['graphed_vs_eager']:.3g} ({v['eager_vs_eager']:.3g})"
            for k, v in state_gaps.items()))
    kinds = {k: kind for names, kind in ((STAGE1_LOSSES, "loss"),
                                         (TRAIN_GRAD_NORMS, "grad_norm"))
             for k in names}

    def rel(a, b):
        return {k: max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                       for x, y in zip(a, b)) for k in kinds}

    rel_graphed, rel_eager = rel(graphed, eager_a), rel(eager_b, eager_a)
    log("[graphs] stage-1 flagship, 5 steps, graphed vs eager |diff| / "
        "|eager|: " + ", ".join(f"{k} {v:.3g}"
                                for k, v in rel_graphed.items()))
    log("[graphs] stage-1 flagship, 5 steps, eager vs eager: " + ", ".join(
        f"{k} {v:.3g}" for k, v in rel_eager.items()))
    for k, kind in kinds.items():
        check(rel_graphed[k] <= STAGE1_TOL[kind],
              f"graphed stage-1 step: {k} {rel_graphed[k]:.3g} from the "
              f"eager step > {STAGE1_TOL[kind]}")
    holder = {"state": state0}

    def step():
        holder["state"], _ = stage1.train_step(cfg1, holder["state"], mel1)

    with disable_graphs():
        eager_ms = time_ms(step, warmup=2)
        eager_prof = profile_launches(step)
    graphed_ms = time_ms(step, warmup=2)
    graphed_prof = profile_launches(step)
    program = stage1.graphed_step(cfg1, mel1.shape, mel1.device).program
    s1 = {"eager_ms": eager_ms, "graphed_ms": graphed_ms,
          "launches_per_eager_call": eager_prof["launches_per_call"],
          "launches_per_graphed_call": graphed_prof["launches_per_call"],
          "busy_eager": eager_prof["device_busy"],
          "busy_graphed": graphed_prof["device_busy"],
          "pool_bytes": pool_bytes(program.pool, mel1.device),
          "rel_graphed_vs_eager": rel_graphed,
          "rel_eager_vs_eager": rel_eager, "state_max_abs": state_gaps}
    log(f"[graphs] stage-1 step [16, 128, 128]: eager {eager_ms:.3f} ms, "
        f"graphed {graphed_ms:.3f} ms per step (CUDA events, median of 21, "
        f"with the metrics' host read); {s1['launches_per_eager_call']:.0f} "
        f"launches per eager step ({s1['launches_per_graphed_call']:.0f} "
        f"traced per replay); busy {s1['busy_eager']:.3f} eager, "
        f"{s1['busy_graphed']:.3f} graphed; pool {s1['pool_bytes']} B")
    out["stage1_step"] = s1

    # Path 6: the stage-2 flagship step (stage2_graphs).
    out["stage2_step"] = stage2_graphs(rng)
    log(f"[graphs] on {card_name_and_power()}")
    return out


NOTEBOOK = (Path(__file__).resolve().parent / "notebooks"
            / "generate_and_listen_torch.ipynb")


def phase_notebook() -> dict:
    """Phase 16: the demo notebook's code cells that are not tagged
    ``display``, in order, in one namespace, with the parameters cell's
    ``DEVICE = "cuda"``: its outputs' shapes, all finite, and its first
    clips ``wav`` bit for bit with the same ``generate`` run eagerly
    (``disable_graphs``); the seconds per cell and of the phase."""
    from music_synthesis_tpu_torch._graphs import disable_graphs
    from music_synthesis_tpu_torch.infer.generate import generate

    nb = json.loads(NOTEBOOK.read_text())
    cells = [c for c in nb["cells"] if c["cell_type"] == "code"
             and "display" not in c["metadata"].get("tags", [])]
    ns: dict = {"__name__": "__notebook__"}
    seconds, path = [], list(sys.path)
    t_phase = time.perf_counter()
    # In the notebook's directory, as Jupyter runs it: its
    # sys.path.insert(0, "..") then names this checkout's root.
    try:
        with contextlib.chdir(NOTEBOOK.parent):
            for i, cell in enumerate(cells):
                src = "".join(cell["source"])
                if "parameters" in cell["metadata"].get("tags", []):
                    src, n = re.subn(r"^DEVICE = None", 'DEVICE = "cuda"',
                                     src, flags=re.M)
                    check(n == 1,
                          "the parameters cell sets DEVICE = None once")
                t0 = time.perf_counter()
                exec(compile(src, f"{NOTEBOOK.name}, code cell {i}",
                             "exec"), ns)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
    finally:
        sys.path[:] = path  # the notebook's sys.path.insert(0, "..")
    total = time.perf_counter() - t_phase
    cfg = ns["cfg"]
    n_z, t, hop = cfg.specgan.latent_dim, cfg.specgan.n_frames, \
        cfg.vocoder.hop_length
    want = {"wav": (4, t * hop), "mel": (4, t, cfg.specgan.n_mels),
            "z_interp": (6, n_z), "wav_interp": (6, t * hop),
            "z_walk": (1, 8, n_z), "wav_drift": ns["long_wav"].shape}
    for key, shape in want.items():
        check(ns[key].shape == shape, f"notebook {key} {ns[key].shape}, "
              f"expected {shape}")
    check(ns["long_wav"].shape[0] == 1 and ns["long_wav"].shape[1] > t * hop,
          f"notebook long_wav {ns['long_wav'].shape}")
    for key in ("wav", "mel", "d", "long_wav", "z_interp", "wav_interp",
                "z_walk", "wav_drift"):
        check(bool(np.isfinite(ns[key]).all()), f"notebook {key} not finite")
    check(ns["d"] > 0, f"notebook STFT distance {ns['d']}")
    check(ns["device"].type == "cuda" and next(
        ns["vocoder"].parameters()).is_cuda, "the notebook ran off the card")
    with disable_graphs():
        eager = ns["pipe"](generate, torch.from_numpy(ns["z"]).cuda()
                           ).float().cpu().numpy()
    check(np.array_equal(ns["wav"], eager),
          "notebook wav (graphed) not bit for bit with generate run eagerly: "
          f"max |diff| {np.abs(ns['wav'] - eager).max()}")
    out = {"cell_s": seconds, "seconds": total,
           "programs": len(ns["pipe"].programs.programs),
           "pool_bytes": ns["pipe"].programs.pool_bytes(),
           "long_s": ns["long_wav"].shape[1] / cfg.frontend.sample_rate}
    card = card_name_and_power()
    log(f"[notebook] {len(cells)} code cells run (display cells skipped), "
        "seconds per cell "
        + ", ".join(f"{x:.2f}" for x in seconds)
        + f"; the phase {total:.1f} s; {out['programs']} graphs, pool "
        f"{out['pool_bytes']} B; wav bit for bit with eager; on {card}")
    return out


def cpu_gaps() -> dict:
    """The CPU's own max abs gaps between bf16 and fp32 at the default-path
    checks' inputs and weights: copy-synthesis (waveform and distance) and
    one 4 s serving request (seed 3); and eval_stage1's |fp32 - float64|
    per metric on the regenerated rich corpus (``eval_stage1_gaps``)."""
    from music_synthesis_tpu_torch.infer.copy_synthesis import CopySynthesizer
    from music_synthesis_tpu_torch.serve import ServeConfig, SynthService

    f32 = CopySynthesizer("vocoder_istft", device="cpu", compute_dtype="float32")
    b16 = CopySynthesizer("vocoder_istft", device="cpu", compute_dtype="bfloat16")
    wav = default_path_input(f32.frontend.sample_rate)
    y32, d32 = f32(wav)
    y16, d16 = b16(wav)
    s32 = SynthService(ServeConfig(), device="cpu", warmup=False)
    s16 = SynthService(ServeConfig(compute_dtype="bfloat16"), device="cpu",
                       warmup=False)
    n = s32.patches_for_seconds(4.0)
    z = s32._z_rows(3, 1, n)
    w32, w16 = s32._execute(n, z), s16._execute(n, z)
    with tempfile.TemporaryDirectory(prefix="cpu_gaps_") as tmp:
        from music_synthesis_tpu_torch.scripts import make_corpus

        corpus = Path(tmp) / "corpus_rich"
        make_corpus.main(["--out", str(corpus), "--clips", "256", "--seconds",
                          "30", "--seed", "0"])
        eval1 = eval_stage1_gaps(corpus)
    return {"copy_wav": (y16.float() - y32).abs().max().item(),
            "copy_distance": abs(d16 - d32),
            "serve_wav": float(np.abs(w16 - w32).max()),
            "eval_stage1": eval1,
            "torch": torch.__version__}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget", type=float, default=1200.0,
                    help="watchdog: dump stacks and exit after this many s")
    ap.add_argument("--cpu-gaps", action="store_true",
                    help="print the CPU's bf16-vs-fp32 gaps (CPU_GAPS) and exit")
    ap.add_argument("--kernel-times", action="store_true",
                    help="print the log-mel kernel's errors and times and "
                         "the anti-aliased SnakeBeta and grouped "
                         "convolution kernels' times (kernel_times) as one "
                         "JSON line and exit")
    ap.add_argument("--tree", type=Path, default=None,
                    help="with --kernel-times: the checkout whose package is "
                         "built and timed (default: this one)")
    args = ap.parse_args()
    if args.cpu_gaps:
        print(json.dumps(cpu_gaps()))
        return 0
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.kernel_times:
        if args.tree is not None:
            sys.path.insert(0, str(args.tree.resolve()))
        print(json.dumps(kernel_times(args.seed)))
        return 0
    faulthandler.dump_traceback_later(args.budget, exit=True)
    rng = np.random.default_rng(args.seed)

    def banner(title: str) -> None:
        log(f"== {title} (at {time.perf_counter() - t_start:.1f} s)")

    from music_synthesis_tpu_torch.ops.logmel import logmel_launches

    banner("phase 1: build and environment")
    build, build_native = phase_build()
    sass = check_sass(build.library, build.ptxas)
    banner("phase 2: kernel vs plain")
    kv = phase_kernel_vs_plain(rng)

    banner("phases 3-4: main path (copy-synthesis, serving)")
    logmel_launches.n_calls = 0
    copy = phase_copy_synthesis(rng)
    serving, svc = phase_serving()
    launches = {"logmel": logmel_launches.n_calls}
    log(f"[main] kernel launches on the main path: {launches}")
    check(launches["logmel"] > 0, "the main path never launched the log-mel kernel")

    banner("phase 5: checks against the CPU")
    copy_err = check_copy_synthesis_on_cpu()
    serve_err = check_serving_on_cpu(svc)

    banner("phase 6: training (main path), and against the CPU")
    logmel_launches.n_calls = 0
    training = phase_training(rng)
    launches["train"] = logmel_launches.n_calls
    log(f"[main] kernel launches in training: {launches['train']}")
    check(launches["train"] == training["steps"],
          "training did not launch the log-mel kernel once per step")
    train_err = check_training_on_cpu()
    log(f"[train] median adversarial step {training['median_step_ms']:.2f} ms, "
        f"peak memory {training['peak_memory_bytes'] / 2**30:.3f} GiB, on "
        f"{card_name_and_power()}")

    banner("phase 7: stage-1 training (main path), and against the CPU")
    logmel_launches.n_calls = 0
    stage1_train = phase_stage1_training(rng)
    launches["stage1_train"] = logmel_launches.n_calls
    check(launches["stage1_train"] == 0,
          "stage-1 training launched the log-mel kernel (the reference's "
          "stage 1 runs no kernel)")
    stage1_err = check_stage1_on_cpu()
    log(f"[stage1] median step {stage1_train['median_step_ms']:.3f} ms, peak "
        f"memory {stage1_train['peak_memory_bytes'] / 2**30:.3f} GiB, on "
        f"{card_name_and_power()}")

    with tempfile.TemporaryDirectory(prefix="lifecycle_") as tmp:
        banner("phase 8: train -> export -> serve through the CLIs (main path)")
        logmel_launches.n_calls = 0
        lifecycle = phase_lifecycle(Path(tmp))
        launches["lifecycle"] = logmel_launches.n_calls
        log(f"[main] kernel launches in the lifecycle: {launches['lifecycle']}")
        check(launches["lifecycle"] == lifecycle["stage2_launches"],
              "serving the exported pair launched the log-mel kernel")

        banner("phase 9: the HTTP server (main path)")
        logmel_launches.n_calls = 0
        http_out = phase_http(lifecycle)
        launches["http"] = logmel_launches.n_calls
        log(f"[main] kernel launches over HTTP: {launches['http']}")
        check(launches["http"] == 0, "serving launched the log-mel kernel "
              "(the reference's serving path runs none)")

        banner("phase 10: evaluation and the inference CLIs (main path)")
        logmel_launches.n_calls = 0
        evals = phase_eval_and_clis(lifecycle, Path(tmp))
        launches["eval_clis"] = logmel_launches.n_calls
        log(f"[main] kernel launches in evaluation and the CLIs: "
            f"{launches['eval_clis']} ({evals['eval_run_launches']} in "
            f"eval_checkpoint --run)")
        check(launches["eval_clis"] == evals["eval_run_launches"] > 0,
              "only eval_checkpoint --run conditions through the kernel here")

        banner("phase 12: data parallelism (main path, in spawned ranks)")
        logmel_launches.n_calls = 0
        dp = phase_data_parallel(Path(tmp))
        launches["dp_single"] = logmel_launches.n_calls
        check(launches["dp_single"] == 1,
              "in this process phase 12 launches the kernel once, in the "
              "single-process stage-2 step the ranks are held to")
        launches["dp_train"] = dp["dp_launches"]
        log(f"[main] kernel launches in the ranks' DP steps: "
            f"{launches['dp_train']} (1 per rank per stage-2 step), "
            f"{dp['dp_graph_replays']} of them in replays of the NCCL ranks' "
            f"graphed DP steps (1 per replay), and {launches['dp_single']} "
            f"in this process's single-process step")
        check(launches["dp_train"] > 0, "the DP steps never launched the kernel")
        check(dp["dp_graph_replays"] > 0,
              "no replay of a graphed DP step launched the kernel")

        banner("phase 13: native IO, extract_features, eval_stage1, parity, "
            "average_ckpts, deploy, named regions (main path)")
        modules = phase_port_modules(rng, Path(tmp), lifecycle)
        modules["native"]["build_s"] = build_native.seconds
        launches["extract_features"] = modules["extract_features"]["launches"]
        launches["eval_stage1"] = modules["eval_stage1"]["launches"]
        log(f"[main] kernel launches: extract_features "
            f"{launches['extract_features']}, eval_stage1 "
            f"{launches['eval_stage1']}")

        banner("phase 14: benchmark scripts (main path)")
        logmel_launches.n_calls = 0
        benchmark = phase_benchmark(Path(tmp))
        launches["benchmark"] = logmel_launches.n_calls
        by_scenario = benchmark["launches"]
        log(f"[main] kernel launches in the benchmark scripts: "
            f"{launches['benchmark']} ({by_scenario})")
        check(launches["benchmark"] == sum(by_scenario.values())
              and by_scenario["bench_stage2_step"] > 0
              and by_scenario["bench_frontend_ab"] > 0,
              "the benchmark scripts launch the kernel only in the stage-2 "
              "and kernel-vs-plain scenarios")

    banner("phase 15: CUDA graphs against eager launches (main path)")
    logmel_launches.n_calls = 0
    graphs = phase_cuda_graphs(rng)
    launches["cuda_graphs"] = logmel_launches.n_calls
    log(f"[main] kernel launches in phase 15: {launches['cuda_graphs']}")
    check(launches["cuda_graphs"] > 0,
          "phase 15 never launched the log-mel kernel")

    banner("phase 16: the demo notebook (main path)")
    logmel_launches.n_calls = 0
    notebook = phase_notebook()
    launches["notebook"] = logmel_launches.n_calls
    log(f"[main] kernel launches in the notebook: {launches['notebook']}")
    check(launches["notebook"] == 0, "the notebook launched the log-mel "
          "kernel (its path starts from latents)")

    banner("phase 17: the anti-aliased SnakeBeta kernel (main path)")
    aa = phase_aa_act(rng, args.seed)

    banner("phase 18: the grouped convolution kernels (main path)")
    grouped = phase_grouped_conv(rng, args.seed)

    banner("phase 11: kernels")
    main_row = next(r for r in kv["rows"] if r["shape"] == [16, 8192]
                    and r["variant"] == "for_vocoder" and r["power"] == 2.0
                    and r["n_mels"] == 128)
    eval_row = next(r for r in kv["rows"] if r["shape"] == [1, 88064])
    kernels = {"kernels": [{
        "name": "logmel",
        "route": "cuda",
        "source": "music_synthesis_tpu_torch/csrc/logmel.cu",
        "replaces": "music_synthesis_tpu/ops/pallas_frontend.py:207",
        "launches": sum(launches.values()),
        "max_abs_err": max(*kv["worst"].values(),
                           modules["extract_features"]["kernel"]["max_abs_err"],
                           modules["eval_stage1"]["kernel"]["max_abs_err"]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "ok": True,
        "path": "3xTF32 wgmma, TMA ring (precision 'fast', the main path's)",
        "ms_device": main_row["ms_device"],
        "plain_ms_device": main_row["plain_ms_device"],
        "split": main_row["split"],
        "ms_by_split": {str(k): v for k, v in main_row["split_ms"].items()},
        "split_by_shape": {str(r["shape"]): r["split"] for r in kv["rows"]
                           if r["split"] is not None},
        "sass": sass,
        "bound_kind": "three TF32 tensor-core passes of the rDFT and mel GEMMs",
        "ffma_bound_ms": main_row["ffma_ms"],
        "ms_exact_ffma": main_row["ms_exact"],
        "ms_exact_ffma_device": main_row["ms_exact_device"],
        "max_abs_err_exact": kv["worst"]["exact"],
        "max_abs_err_fast": kv["worst"]["fast"],
        "build_s": build.seconds,
        "shape": [16, 8192],
        "eval_clip": {key: eval_row[key] for key in (
            "shape", "ms", "ms_device", "ms_exact", "ms_exact_device",
            "plain_ms", "bound_ms", "bound_by", "ffma_ms", "ffma_by",
            "max_abs_err")},
        "extract_features_clip": modules["extract_features"]["kernel"],
        "eval_stage1_batch": modules["eval_stage1"]["kernel"],
        "launches_by_path": {"copy_synthesis_and_serving": launches["logmel"],
                             "train_step": launches["train"],
                             "stage1_train_step": launches["stage1_train"],
                             "lifecycle_clis": launches["lifecycle"],
                             "http_serving": launches["http"],
                             "eval_run": evals["eval_run_launches"],
                             "eval_and_inference_clis": launches["eval_clis"],
                             "dp_train_step": launches["dp_train"],
                             "dp_graph_replays": dp["dp_graph_replays"],
                             "dp_single_step": launches["dp_single"],
                             "extract_features": launches["extract_features"],
                             "eval_stage1": launches["eval_stage1"],
                             "bench_stage2_step":
                                 by_scenario["bench_stage2_step"],
                             "bench_frontend_ab":
                                 by_scenario["bench_frontend_ab"],
                             "cuda_graphs": launches["cuda_graphs"],
                             "notebook": launches["notebook"]},
    }, aa_act_kernel_entry(aa), grouped_conv_kernel_entry(grouped)]}
    summary = {"copy_synthesis": copy, "serving": serving,
               "copy_card_vs_cpu_err": copy_err,
               "serve_card_vs_cpu_err": serve_err,
               "train_step": training,
               "train_card_vs_cpu_err": train_err,
               "stage1_train_step": stage1_train,
               "stage1_card_vs_cpu_err": stage1_err,
               "lifecycle": lifecycle,
               "http": http_out,
               "eval_and_clis": evals,
               "data_parallel": dp,
               "port_modules": modules,
               "benchmark": benchmark,
               "cuda_graphs": graphs,
               "notebook": notebook,
               "aa_act": aa,
               "grouped_conv": grouped,
               "kernel_rows": kv["rows"],
               "total_s": time.perf_counter() - t_start}
    log("[summary] " + json.dumps(summary))
    faulthandler.cancel_dump_traceback_later()
    log(f"[total] {summary['total_s']:.1f} s")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
