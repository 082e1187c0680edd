#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed 0] [--budget 900]

Drives ``music_synthesis_tpu_torch`` through the entry points a user calls,
at the flagship's full width with the committed zoo weights, in phases:

1. build: ``csrc/logmel.cu`` with nvcc; prints the build seconds, ptxas'
   register and spill lines, and the card's name and power limit;
2. kernel vs plain: the log-mel kernel against its plain PyTorch version at
   [16, 8192], [16, 88064] and [4, 88064] (every shape the main path gives
   it, and the 4 s batch of 16), both precision modes, the vocoder and plain
   variants, power 2 and 1; max abs error <= 2e-4 ("exact"), <= 2e-2
   ("fast"); kernel and plain times (median of 21 CUDA-event samples of
   10 back-to-back calls, after warm-up) beside the bound;
3. copy-synthesis (main path): seeded harmonic test audio [16, 8192] and
   [4, 88064] through ``infer.copy_synthesis`` with ``zoo/vocoder_istft``;
   the kernel's launch count must rise; a small input is checked against
   the same modules on the CPU;
4. serving (main path): ``SynthService(specgan_flux, vocoder_istft)``
   answers three requests; shapes, finiteness, bucketed lengths and
   repeat-seed identity are checked, and one request against the CPU;
5. the ``kernels`` JSON line.

The launch counts are set to 0 just before phases 3-4 and read just after.
Any failed check raises, so the exit code is non-zero and no result line is
printed. The last line is ``{"ok": true, "device": {...}}``.
Needs a CUDA card; exits non-zero without one. Starts no server, no thread
and no process other than nvcc and nvidia-smi.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL = {"exact": 2e-4, "fast": 2e-2}


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


def logmel_bound_ms(batch: int, padded_len: int, n_frames: int, cfg) -> tuple[float, str]:
    """Least time for one fused log-mel call on an H100: the larger of its
    fp32 operations over the FFMA peak and its bytes over HBM bandwidth."""
    n_bins = cfg.n_fft // 2 + 1
    rows = batch * n_frames
    flops = (2 * rows * cfg.n_fft * 2 * n_bins      # frames @ [C | S]
             + 3 * rows * n_bins                     # re^2 + im^2
             + 2 * rows * n_bins * cfg.n_mels        # power @ mel
             + 2 * rows * cfg.n_mels)                # log(eps + .)
    nbytes = 4 * (batch * padded_len                  # wav, read once
                  + 2 * cfg.n_fft * n_bins            # bases
                  + n_bins * cfg.n_mels               # mel matrix
                  + rows * cfg.n_mels)                # output
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def phase_build():
    from music_synthesis_tpu_torch import _build

    result = _build.build("logmel")
    log(f"[build] {result.name}: {result.seconds:.2f} s -> {result.library}")
    for line in result.ptxas:
        log(f"[build]   {line}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "fp32 GEMMs must not run in TF32 (the plain versions assume it)")
    return result


def phase_kernel_vs_plain(rng: np.random.Generator) -> dict:
    from music_synthesis_tpu_torch.config import FrontendConfig
    from music_synthesis_tpu_torch.ops import logmel as L

    worst = {"exact": 0.0, "fast": 0.0}
    rows = []
    for shape in ((16, 8192), (16, 88064), (4, 88064)):
        wav = torch.from_numpy(test_audio(rng, *shape, 22050)).cuda()
        for power in (2.0, 1.0):
            cfg = FrontendConfig(power=power)
            for variant, fused, plain in (
                    ("for_vocoder", L.fused_log_mel_for_vocoder,
                     L.log_mel_for_vocoder_plain),
                    ("log_mel", L.fused_log_mel, L.log_mel_plain)):
                want = plain(wav, cfg)
                errs = {}
                for mode in ("exact", "fast"):
                    got = fused(wav, cfg, mode)
                    torch.cuda.synchronize()
                    check(got.shape == want.shape, f"shape {got.shape} vs {want.shape}")
                    err = (got - want).abs().max().item()
                    check(np.isfinite(err) and err <= TOL[mode],
                          f"log-mel kernel {shape} {variant} power={power} {mode}: "
                          f"max abs err {err} > {TOL[mode]}")
                    worst[mode] = max(worst[mode], err)
                    errs[mode] = err
                # Time the kernel and its plain version on the same padded
                # input (padding is outside both).
                padded, n_frames = L.padded_input(wav, cfg, variant == "for_vocoder")
                ms = time_ms(lambda: L.logmel_kernel(padded, cfg, n_frames))
                plain_ms = time_ms(lambda: L.log_mel_frames_plain(padded, cfg, n_frames))
                bound, by = logmel_bound_ms(shape[0], padded.shape[1], n_frames, cfg)
                rows.append(dict(shape=list(shape), variant=variant, power=power,
                                 max_abs_err=errs, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=by, bound_share=bound / ms))
                log(f"[kernel] logmel {list(shape)} {variant} power={power:g}: "
                    f"err exact {errs['exact']:.3g} fast {errs['fast']:.3g}; "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound:.4f} ms ({by}), share of bound {bound / ms:.3f}")
    return {"worst": worst, "rows": rows}


def phase_copy_synthesis(rng: np.random.Generator) -> dict:
    from music_synthesis_tpu_torch.infer.copy_synthesis import CopySynthesizer
    from music_synthesis_tpu_torch.ops.logmel import logmel_kernel

    cs = CopySynthesizer("vocoder_istft")  # card's own dtype, on cuda
    out = {}
    for shape in ((16, 8192), (4, 88064)):
        wav = test_audio(rng, *shape, cs.frontend.sample_rate)
        walls = []
        for _ in range(2):  # the first call includes cuDNN's set-up
            before = logmel_kernel.n_launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, dist = cs(wav)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(logmel_kernel.n_launches == before + 1,
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


def check_copy_synthesis_on_cpu(rng: np.random.Generator) -> float:
    """fp32 copy-synthesis of a small input on the card (cuDNN TF32 off)
    against the same modules on the CPU."""
    from music_synthesis_tpu_torch.infer.copy_synthesis import CopySynthesizer

    gpu = CopySynthesizer("vocoder_istft", compute_dtype="float32")
    cpu = CopySynthesizer("vocoder_istft", device="cpu", compute_dtype="float32")
    wav = test_audio(rng, 2, 8192, gpu.frontend.sample_rate)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y_gpu, d_gpu = gpu(wav)
    y_cpu, d_cpu = cpu(wav)
    err = (y_gpu.cpu() - y_cpu).abs().max().item()
    log(f"[copy] card vs CPU (fp32, [2, 8192]): max abs err {err:.3g}, "
        f"distance {d_gpu:.5f} vs {d_cpu:.5f}")
    check(err <= 2e-3, f"copy-synthesis card vs CPU: {err} > 2e-3")
    check(abs(d_gpu - d_cpu) <= 1e-3, "copy-synthesis distance card vs CPU")
    return err


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


def check_serving_on_cpu(svc) -> float:
    """One request's raw output on the card (fp32, cuDNN TF32 off) against
    the same zoo modules on the CPU."""
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
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget", type=float, default=900.0,
                    help="watchdog: dump stacks and exit after this many s")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(args.budget, exit=True)
    rng = np.random.default_rng(args.seed)

    from music_synthesis_tpu_torch.ops.logmel import logmel_kernel

    log("== phase 1: build and environment")
    build = phase_build()
    log("== phase 2: kernel vs plain")
    kv = phase_kernel_vs_plain(rng)

    log("== phases 3-4: main path (copy-synthesis, serving)")
    logmel_kernel.n_launches = 0
    copy = phase_copy_synthesis(rng)
    serving, svc = phase_serving()
    launches = {"logmel": logmel_kernel.n_launches}
    log(f"[main] kernel launches on the main path: {launches}")
    check(launches["logmel"] > 0, "the main path never launched the log-mel kernel")

    log("== checks against the CPU")
    copy_err = check_copy_synthesis_on_cpu(rng)
    serve_err = check_serving_on_cpu(svc)

    log("== phase 5: kernels")
    main_row = next(r for r in kv["rows"] if r["shape"] == [16, 8192]
                    and r["variant"] == "for_vocoder" and r["power"] == 2.0)
    kernels = {"kernels": [{
        "name": "logmel",
        "route": "cuda",
        "source": "music_synthesis_tpu_torch/csrc/logmel.cu",
        "replaces": "music_synthesis_tpu/ops/pallas_frontend.py:207",
        "launches": launches["logmel"],
        "max_abs_err": max(kv["worst"].values()),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "ok": True,
        "max_abs_err_exact": kv["worst"]["exact"],
        "max_abs_err_fast": kv["worst"]["fast"],
        "build_s": build.seconds,
        "shape": [16, 8192],
    }]}
    summary = {"copy_synthesis": copy, "serving": serving,
               "copy_card_vs_cpu_err": copy_err,
               "serve_card_vs_cpu_err": serve_err,
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
