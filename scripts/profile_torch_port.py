#!/usr/bin/env python3
"""Where the port's time goes on the card: a torch.profiler breakdown.

    python3 scripts/profile_torch_port.py [--seed 0] [--steps 5]

Profiles, after a warm-up, ``--steps`` steady calls of each of the port's
entry points at full width with the committed zoo weights:

- copy-synthesis of [16, 8192] (``infer.copy_synthesis.CopySynthesizer``,
  the zoo vocoder in its card's bf16);
- one 4 s serving request (``serve.SynthService``, fp32);
- one stage-2 training step of the flagship at [16, 8192] in bf16
  (``train.stage2.train_step``; ``train.flagship.flagship_config``, G from
  the zoo, D seeded, past the warmup gate; each call starts from the same
  state);
- one stage-1 training step of the composer flagship at [16, 128, 128]
  (``train.stage1.train_step``; ``train.flagship.stage1_flagship_config``).

For each it prints the wall time per call, the kernel time (the summed
time of the device's kernels, copies and sets, overlapping ones counted
each) and the kernel launches per call, the device-busy share of the
window (the union of those activities' intervals over the wall time,
``utils.profiling.device_busy``: overlapping kernels count once), and the
kernels that took the most device time.
For each training step it also prints the split by named region (the JAX
step's ``jax.named_scope`` names, ``utils/profiling.py``): per region the
host ms, the device ms and kernel launches of the work launched inside it,
and its top kernels, per step; regions nest as in the JAX step (``d_step``
holds ``disc_*`` and ``r1_penalty``, ``g_step`` the G side), so a parent's
numbers include its children's. The profiler adds host time to every
launch, so the wall time here is above the unprofiled one
(``chip_smoke.py`` times the step with CUDA events). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def profile(name: str, fn, steps: int, top: int = 12) -> None:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from music_synthesis_tpu_torch.utils.profiling import (device_busy,
                                                           device_events)

    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events) // steps
    print(f"[{name}] {steps} calls, wall {wall / steps * 1e3:.3f} ms per call, "
          f"kernel time {device_us / steps / 1e3:.3f} ms and {launches} "
          f"kernel launches per call, device busy "
          f"{device_busy(prof, wall):.3f} of the window")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[{name}]   {e.self_device_time_total / steps / 1e3:9.4f} ms/call "
              f"x{e.count // steps:<4d} {e.key[:90]}")


def print_regions(name: str, split: dict) -> None:
    """One line per region of ``region_split``'s table."""
    for region, row in split.items():
        top = "; ".join(f"{k} {v:.3f} ms" for k, v in row["top"])
        print(f"[{name}] {region:16s} host {row['host_ms']:9.3f} ms, device "
              f"{row['device_ms']:9.3f} ms, {row['launches']:8.1f} launches"
              f" | {top}")


def profile_regions(name: str, fn, names: list[str], steps: int) -> dict:
    """``region_split`` of ``steps`` calls of ``fn`` under ``trace``, after
    one traced call that it drops."""
    from music_synthesis_tpu_torch.utils.profiling import (TRACE_FILE,
                                                           region_split, trace)

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            for _ in range(steps + 1):
                fn()
        split = region_split(Path(tmp) / TRACE_FILE, names, calls=steps,
                             skip=1)
    print_regions(name, split)
    return split


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device available", file=sys.stderr)
        return 1
    from music_synthesis_tpu_torch.infer.copy_synthesis import CopySynthesizer
    from music_synthesis_tpu_torch.serve import ServeConfig, SynthService

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    rng = np.random.default_rng(args.seed)
    wav = (0.3 * np.tanh(rng.standard_normal((16, 8192)))).astype(np.float32)
    cs = CopySynthesizer("vocoder_istft")
    x = torch.from_numpy(wav).cuda()
    profile("copy [16, 8192]", lambda: cs(x), args.steps)
    svc = SynthService(ServeConfig(batch_buckets=(1,), patch_buckets=(4,)))
    profile("serve 4 s x 1", lambda: svc.synth(4.0, seed=3), args.steps)

    import dataclasses

    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.train import stage2
    from music_synthesis_tpu_torch.train.flagship import (flagship_config,
                                                          zoo_train_state)

    entry = zoo.load_pretrained("vocoder_istft")
    cfg = flagship_config(entry)
    state = zoo_train_state(cfg, entry)
    state = dataclasses.replace(state, step=cfg.train.g_warmup_steps)
    torch.cuda.reset_peak_memory_stats()
    profile("train step [16, 8192]",
            lambda: stage2.train_step(cfg, state, x), args.steps, top=20)
    print(f"[train step [16, 8192]] peak memory "
          f"{torch.cuda.max_memory_allocated()} B")

    from music_synthesis_tpu_torch.train import stage1
    from music_synthesis_tpu_torch.train.flagship import stage1_flagship_config
    from music_synthesis_tpu_torch.utils.profiling import step_regions

    profile_regions("train step [16, 8192] by region",
                    lambda: stage2.train_step(cfg, state, x),
                    step_regions(cfg, 2), args.steps)
    entry1 = zoo.load_pretrained("specgan_flux")
    cfg1 = stage1_flagship_config(entry1)
    state1 = zoo_train_state(cfg1, entry1)
    s1 = cfg1.specgan
    mel = torch.from_numpy(rng.standard_normal(
        (cfg1.train.batch_size, s1.n_frames, s1.n_mels)).astype(
            np.float32)).cuda()
    profile(f"stage-1 step [{cfg1.train.batch_size}, {s1.n_frames}, "
            f"{s1.n_mels}]", lambda: stage1.train_step(cfg1, state1, mel),
            args.steps)
    profile_regions("stage-1 step by region",
                    lambda: stage1.train_step(cfg1, state1, mel),
                    step_regions(cfg1, 1), args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
