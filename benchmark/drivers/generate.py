"""Window driver ``generate``: offline batch generation, back to back.

Set-up loads the configuration's zoo pair (``generate.composer`` and
``generate.vocoder``) through the program's ``zoo.load_pretrained``, wraps
them in ``infer.generate.GraphedPipeline`` and makes two calls of
``generate_long`` at the traffic's shape (the first captures the CUDA
graph). Each call of the window draws fresh latents ``[batch, patches,
latent_dim]`` on the card from the seed, runs ``generate_long`` and copies
the audio to the host as numpy. ``audio_s_per_s`` is the audio seconds
returned over the window's wall time.

Correctness: a reservoir sample, drawn from the seed, of ``check_calls``
calls of the window keeps their latents and the audio returned. Once the
window has closed and the program is freed, the plain reference
(``reference.synth.generate_long``, fp32 without TF32) runs those latents
clip by clip; ``wav_rel_err`` is the worst clip's ``|prog - ref| / |ref|``
(L2 norms). ``--control`` loads the pair with the program's own bf16 path
(``compute_dtype="bfloat16"``) in the program's place.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import flops
from harness.config import ROOT
from harness.core import Ctx, log, trace_device
from reference import synth
from reference.arith import conv_precision
from reference.model import strict_fp32


def run(ctx: Ctx) -> None:
    import dataclasses

    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.config import (
        InferConfig,
        PipelineConfig,
    )
    from music_synthesis_tpu_torch.infer import generate

    gcfg = ctx.cell.config["generate"]
    tr = ctx.traffic
    comp_e = zoo.load_pretrained(gcfg["composer"])
    voc_e = zoo.load_pretrained(gcfg["vocoder"])
    dtype = "bfloat16" if ctx.control else None
    cfg = dataclasses.replace(
        PipelineConfig(), specgan=comp_e.config, vocoder=voc_e.config,
        frontend=voc_e.frontend or comp_e.frontend,
        mel_scaler=voc_e.mel_scaler or comp_e.mel_scaler,
        infer=InferConfig(**ctx.cell.config["infer"]))
    composer = comp_e.model(ctx.device, dtype)
    vocoder = voc_e.model(ctx.device, dtype)
    pipe = generate.GraphedPipeline(cfg, composer, vocoder)
    shape = (tr.batch, tr.patches, cfg.specgan.latent_dim)
    cf = gcfg["crossfade_frames"]
    sr = cfg.frontend.sample_rate
    gen = ctx.generator(11)
    rng = np.random.default_rng(ctx.seed)

    def call() -> tuple[torch.Tensor, np.ndarray]:
        z = torch.randn(shape, generator=gen, device=ctx.device)
        wav = pipe(generate.generate_long, z, cf)
        return z, wav.cpu().numpy()

    for _ in range(2):
        _, wav = call()
    samples = wav.shape[-1]
    deadline = ctx.open_window()
    kept, calls = [], 0
    while True:
        z, wav = call()
        # Reservoir sample of the window's calls.
        if len(kept) < tr.check_calls:
            kept.append((z, wav))
        elif (j := rng.integers(0, calls + 1)) < tr.check_calls:
            kept[j] = (z, wav)
        calls += 1
        if time.perf_counter() >= deadline:
            break
    wall = time.perf_counter() - ctx.window_start
    ctx.attempted = calls
    ctx.failed = sum(int(not np.isfinite(w).all()) for _, w in kept)
    audio_s = calls * tr.batch * samples / sr
    ctx.e2e["audio_s_per_s"] = audio_s / wall
    log(f"[{ctx.cell.name}] {calls} calls of {tr.batch} x {samples} samples "
        f"in {wall:.3f} s: {audio_s / wall:.1f} audio-s/s")
    ctx.read_memory_peak()

    if ctx.trace and ctx.device.type == "cuda":
        n = tr.trace_calls
        trace = trace_device(ctx, call, lambda: [call() for _ in range(n)])
        dtypes = {cfg.specgan.compute_dtype, cfg.vocoder.compute_dtype}
        ctx.records.update(
            call_s=wall / calls, trace_union_s=trace.union_s(),
            trace_wall_s=trace.wall_s,
            peak_flops=ctx.peaks.get(conv_precision(
                dtypes, torch.backends.cudnn.allow_tf32)),
            call_flops=_call_flops(ctx, shape, cf))
    del pipe, composer, vocoder
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    worst = 0.0
    with strict_fp32():
        rc, _ = synth.load_entry(ROOT / "zoo" / gcfg["composer"], ctx.device)
        rv, _ = synth.load_entry(ROOT / "zoo" / gcfg["vocoder"], ctx.device)
        for z, wav in kept:
            for i in range(z.shape[0]):
                ref = synth.generate_long(rc, rv, z[i:i + 1], cf,
                                          ctx.cfg.infer)[0].cpu().numpy()
                err = (np.linalg.norm(wav[i] - ref)
                       / max(np.linalg.norm(ref), 1e-12))
                worst = max(worst, float(err))
    ctx.check("wav_rel_err", worst)


def _call_flops(ctx: Ctx, shape, crossfade: int) -> int:
    """Logical FLOPs of one call (``harness.flops``) on the reference."""
    gcfg = ctx.cell.config["generate"]

    def body():
        with torch.device("meta"):
            rc, _ = synth.load_entry(ROOT / "zoo" / gcfg["composer"], "meta")
            rv, _ = synth.load_entry(ROOT / "zoo" / gcfg["vocoder"], "meta")
            synth.generate_long(rc, rv, torch.empty(shape), crossfade,
                                ctx.cfg.infer)

    return flops.count(body)
