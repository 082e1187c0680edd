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

    python3 scripts/profile_torch_port.py --layers [--batches 16 32 64]
        [--config flagship]

prints instead the MSD's per-layer table (the MSD of the benchmark's
configuration ``--config``, built as the model builds it, each layer's
input shape read by a forward hook; bf16): for every layer (``conv_in``,
``down_0`` .. ``down_3``, ``conv_post``, ``conv_out``) at each scale, the
eager device time of each call, with the kernels it launched and their
times. A grouped layer over ``dense_groups_max_g`` (64 and 256 in the
flagship, 256 in rich and BigVGAN), at each of ``--batches``, is timed
call by call on the port's kernels (``csrc/grouped_conv.cu``) and on
cuDNN's (``F.conv1d`` and aten's ``convolution_backward`` at the same
shapes): the forward, the input gradient, the weight and bias gradients,
and the double backward's two terms (the forward of the input gradient's
gradient without bias, the weight term). Every other layer, at batch 32,
is timed pass by pass through autograd: its forward, its first-order
backward (input, kernel and bias gradients), R1's input gradient
(``create_graph``) and R1's double backward (the second-order gradients
into its parameters).
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


def _device_kernels(fn, calls: int) -> tuple[float, list]:
    """Device ms per call of ``fn`` (the sum of its kernels' device time
    under the profiler, ``calls`` calls after two) and its kernels, [(name,
    ms per call, launches per call)], heaviest first."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from music_synthesis_tpu_torch.utils.profiling import device_events

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    for _ in range(2):
        fn()
    sync()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    events = sorted(device_events(prof),
                    key=lambda e: -e.self_device_time_total)
    rows = [(e.key, e.self_device_time_total / calls / 1e3, e.count / calls)
            for e in events if e.self_device_time_total > 0]
    return sum(r[1] for r in rows), rows


def _msd_layer_inputs(msd, segment: int, device: str) -> list:
    """``(scale, name, layer, input [C, L], dtype)`` of every convolution
    of ``MultiScaleDiscriminator(msd)`` at each scale, in the order it runs
    them, read by forward hooks in one pass of a one-row batch."""
    from music_synthesis_tpu_torch.models.discriminators import (
        MultiScaleDiscriminator)
    from music_synthesis_tpu_torch.ops.conv import WNConv

    model = MultiScaleDiscriminator(msd).to(device)
    seen, hooks = [], []
    for scale in range(msd.n_scales):
        for name, layer in getattr(model, f"scale_{scale}").named_children():
            if isinstance(layer, WNConv):
                hooks.append(layer.register_forward_hook(
                    lambda mod, args, out, scale=scale, name=name: seen.append(
                        (scale, name, mod, tuple(args[0].shape[1:]),
                         args[0].dtype))))
    with torch.no_grad():
        model(torch.zeros(1, segment, device=device))
    for hook in hooks:
        hook.remove()
    return seen


def _grouped_calls(layer, x: torch.Tensor, gen) -> dict:
    """``{path: {call: fn}}`` of one grouped layer on input ``x`` (before
    its padding): the port's kernels and cuDNN's at the same shapes."""
    import torch.nn.functional as F

    from music_synthesis_tpu_torch.ops import grouped_conv as gc

    cdt = layer.compute_dtype
    xp = F.pad(x, layer.pads, mode="reflect" if layer.padding == "reflect"
               else "constant").to(cdt)
    with torch.no_grad():
        k = layer.kernel()
        w = k.permute(2, 1, 0).to(cdt)
        b = layer._bias()
    (s,), groups = layer.stride, layer.groups
    args = ([s], list(layer.dilation), groups)
    y = F.conv1d(xp, w, b, stride=s, groups=groups)
    gy = torch.randn(y.shape, device=x.device, generator=gen).to(cdt)
    ggx = torch.randn(xp.shape, device=x.device, generator=gen).to(cdt)
    bwd = torch.ops.aten.convolution_backward

    def library_grad(g, inp, bias_sizes, mask):
        return bwd(g, inp, w, bias_sizes, [s], [0], [1], False, [0], groups,
                   mask)

    return {
        "kernel": {
            "fwd": lambda: gc.forward(xp, w, b, *args),
            "input_grad": lambda: gc.input_grad(gy, w, xp.shape[-1], *args),
            "weight_and_bias_grad": lambda: gc.weight_grad(
                gy, xp, w.shape, *args, True, True),
            "double_bwd_ggy": lambda: gc.forward(ggx, w, None, *args),
            "double_bwd_wgrad": lambda: gc.weight_grad(
                gy, ggx, w.shape, *args, True, False)},
        "cudnn": {
            "fwd": lambda: F.conv1d(xp, w, b, stride=s, groups=groups),
            "input_grad": lambda: library_grad(gy, xp, None,
                                               [True, False, False]),
            "weight_and_bias_grad": lambda: library_grad(
                gy, xp, [w.shape[0]], [False, True, True]),
            "double_bwd_ggy": lambda: F.conv1d(ggx, w, None, stride=s,
                                               groups=groups),
            "double_bwd_wgrad": lambda: library_grad(
                gy, ggx, None, [False, True, False])}}


def _layer_passes(layer, x: torch.Tensor, gen) -> dict:
    """``{"cudnn": {pass: fn}}`` of one layer through autograd on input
    ``x``; each pass's time includes the forward it differentiates."""
    x = x.requires_grad_()
    params = list(layer.parameters())
    y = layer(x)
    gy = torch.randn(y.shape, device=x.device, generator=gen).to(y.dtype)
    (gx,) = torch.autograd.grad(layer(x), x, gy, create_graph=True)
    ggx = torch.randn(gx.shape, device=x.device, generator=gen).to(gx.dtype)

    def fwd():
        with torch.no_grad():
            return layer(x)

    def r1_bwd():
        (g2,) = torch.autograd.grad(layer(x), x, gy, create_graph=True)
        return torch.autograd.grad(g2, params, ggx, allow_unused=True)

    return {"cudnn": {
        "fwd": fwd,
        "bwd": lambda: torch.autograd.grad(layer(x), [x, *params], gy),
        "r1_gx": lambda: torch.autograd.grad(layer(x), x, gy,
                                             create_graph=True),
        "r1_fwd_gx_and_double_bwd": r1_bwd}}


def layer_table(batches: tuple[int, ...], calls: int = 5,
                device: str = "cuda", name: str = "flagship") -> list[dict]:
    """The MSD's per-layer table of ``benchmark/configs/<name>.json`` (the
    module's docstring), one row per layer, scale, batch, call and path,
    printed as it goes."""
    import json

    from music_synthesis_tpu_torch import config as config_mod

    root = Path(__file__).resolve().parents[1]
    raw = json.loads((root / "benchmark" / "configs" / f"{name}.json"
                      ).read_text())
    msd = config_mod.config_from_dict(raw["train"]).msd
    segment = raw["train"]["train"]["segment_length"]
    rows = []
    for scale, layer_name, layer, (cin, length), dtype in _msd_layer_inputs(
            msd, segment, device):
        grouped = layer.groups > 1 and not layer.dense_groups
        for batch in (batches if grouped else (32,)):
            gen = torch.Generator(device=device).manual_seed(batch)
            x = torch.randn(batch, cin, length, device=device,
                            generator=gen).to(dtype)
            paths = (_grouped_calls if grouped else _layer_passes)(
                layer, x, gen)
            for path, passes in paths.items():
                for pass_name, fn in passes.items():
                    ms, kernels = _device_kernels(fn, calls)
                    row = dict(scale=scale, layer=layer_name, batch=batch,
                               groups=layer.groups,
                               dense=layer.dense_groups,
                               x=[batch, cin, length], pass_=pass_name,
                               path=path, ms=ms, kernels=kernels[:6])
                    rows.append(row)
                    top = "; ".join(f"{k[:60]} {v:.4f} ms x{n:g}"
                                    for k, v, n in kernels[:4])
                    print(f"[layers] scale {scale} {layer_name:9s} g "
                          f"{row['groups']:3d}{' dense' if row['dense'] else ''}"
                          f" {row['x']} {pass_name:24s} {path:6s} "
                          f"{ms:8.4f} ms | {top}", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--layers", action="store_true",
                    help="print the MSD's per-layer table and exit")
    ap.add_argument("--batches", type=int, nargs="+", default=[16, 32, 64],
                    help="with --layers: the grouped layers' batches")
    ap.add_argument("--config", default="flagship",
                    help="with --layers: the benchmark configuration whose "
                         "MSD is tabled")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device available", file=sys.stderr)
        return 1
    if args.layers:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip())
        layer_table(tuple(args.batches), name=args.config)
        return 0
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
