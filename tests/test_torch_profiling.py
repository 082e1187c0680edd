"""Named regions of the port's training steps (``utils/profiling.py``,
``train/stage1.py``, ``train/stage2.py``) on the CPU at TINY's size.

- The regions the port's steps can open are exactly the JAX steps'
  ``jax.named_scope`` names (read from the JAX package's source), and
  ``step_regions`` names, for each config, those the JAX step traces.
- One TINY step of each stage under ``trace`` writes a Chrome trace that
  holds every region of ``step_regions`` (``region_split`` finds each),
  for stage 2 with D on the concatenated batch (``disc_both``) and on two
  batches, with and without instance noise; and the step's outputs are
  the unprofiled step's, bit for bit: the regions change no arithmetic.
- ``time_fn`` returns a mean time per call.
- ``device_busy`` is the union of a trace's device intervals (kernels,
  copies, sets) over the window: on synthetic traces with overlapping,
  nested and disjoint intervals it counts each instant once, ignores the
  host's events and the device-side region spans, never exceeds 1 (a
  window shorter than the intervals' span is taken as that span), and
  reads a ``torch.profiler`` run with no device work as 0.
"""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from music_synthesis_tpu_torch.config import TINY
from music_synthesis_tpu_torch.train import stage1, stage2
from music_synthesis_tpu_torch.utils import profiling

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _jax_scopes(stage: int) -> set:
    src = (REPO / "music_synthesis_tpu" / "train" / f"stage{stage}.py"
           ).read_text()
    return set(re.findall(r'jax\.named_scope\("(\w+)"\)', src))


def _cfg(**train):
    return dataclasses.replace(TINY, train=dataclasses.replace(
        TINY.train, batch_size=2, segment_length=2048, **train))


CONFIGS = {
    "concat_noise": dict(concat_disc_batch=True, d_input_noise=0.1,
                         r1_gamma=1.0, ema_decay=0.999),
    "split_reuse": dict(reuse_real_features=True, r1_gamma=1.0,
                        ema_decay=0.999),
}


def test_region_names_are_the_jax_scopes():
    for stage in (1, 2):
        names = set()
        for train in CONFIGS.values():
            names |= set(profiling.step_regions(_cfg(**train), stage))
        if stage == 1:
            names |= set(profiling.step_regions(_cfg(d_input_noise=0.1,
                                                     r1_gamma=1.0), 1))
        assert names == _jax_scopes(stage), stage
    assert set(profiling.REGIONS) == _jax_scopes(1) | _jax_scopes(2)
    regions = profiling.step_regions(_cfg(**CONFIGS["concat_noise"]), 2)
    assert "disc_both" in regions and "disc_real" not in regions
    assert {"disc_real_g", "r1_penalty", "ema"} <= set(regions)
    regions = profiling.step_regions(_cfg(**CONFIGS["split_reuse"]), 2)
    assert {"disc_real", "disc_fake"} <= set(regions)
    assert "disc_real_g" not in regions


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _profiled(step, names, tmp_path):
    with profiling.trace(tmp_path) as prof:
        out = step()
    trace_file = tmp_path / profiling.TRACE_FILE
    events = json.loads(trace_file.read_text())["traceEvents"]
    seen = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    split = profiling.region_split(trace_file, names)
    assert prof is not None
    assert split[profiling.OUTSIDE]["no_launch_record"] == 0  # no card
    return out, seen, split


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stage2_step_regions(name, tmp_path):
    cfg = _cfg(**CONFIGS[name])
    state = stage2.make_train_state(cfg, seed=0, device="cpu")
    wav = 0.3 * np.tanh(np.random.default_rng(0).standard_normal(
        (2, 2048))).astype(np.float32)
    names = profiling.step_regions(cfg, 2)
    want_state, want = stage2.train_step(cfg, state, wav)
    (got_state, got), seen, split = _profiled(
        lambda: stage2.train_step(cfg, state, wav), names, tmp_path)
    assert set(names) <= seen, set(names) - seen
    assert all(split[n]["found"] and split[n]["host_ms"] > 0 for n in names)
    assert got == want
    assert _same(got_state.g_params, want_state.g_params)
    assert _same(got_state.d_params, want_state.d_params)
    assert _same(got_state.g_ema, want_state.g_ema)


def test_stage1_step_regions(tmp_path):
    cfg = _cfg(d_input_noise=0.2, r1_gamma=1.0, ema_decay=0.999,
               lambda_flux=10.0)
    state = stage1.make_train_state(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    s = cfg.specgan
    mel = rng.standard_normal((2, s.n_frames, s.n_mels)).astype(np.float32)
    z = rng.standard_normal((2, s.latent_dim)).astype(np.float32)
    names = profiling.step_regions(cfg, 1)
    assert "frontend" not in names and "disc_real_g" in names
    want_state, want = stage1.train_step(cfg, state, mel, z=z)
    (got_state, got), seen, split = _profiled(
        lambda: stage1.train_step(cfg, state, mel, z=z), names, tmp_path)
    assert set(names) <= seen, set(names) - seen
    assert all(split[n]["found"] for n in names)
    assert got == want
    assert _same(got_state.g_params, want_state.g_params)
    assert _same(got_state.d_params, want_state.d_params)


def test_region_split_skips_the_first_calls(tmp_path):
    cfg = _cfg(**CONFIGS["split_reuse"])
    state = stage2.make_train_state(cfg, seed=0, device="cpu")
    wav = np.zeros((2, 2048), np.float32)
    names = profiling.step_regions(cfg, 2)
    with profiling.trace(tmp_path):
        for _ in range(3):
            stage2.train_step(cfg, state, wav)
    trace_file = tmp_path / profiling.TRACE_FILE
    every = profiling.region_split(trace_file, names, calls=3)
    last2 = profiling.region_split(trace_file, names, calls=2, skip=1)
    for n in names:
        assert every[n]["found"] and last2[n]["found"]
    # Three d_step spans in all; two after the first step.
    spans = [e for e in json.loads(trace_file.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation" and e["name"] == "d_step"]
    assert len(spans) == 3
    first = min(spans, key=lambda e: e["ts"])
    rest_ms = sum(e["dur"] for e in spans if e is not first) / 1e3 / 2
    assert last2["d_step"]["host_ms"] == pytest.approx(rest_ms)


def test_time_fn():
    calls = []
    seconds = profiling.time_fn(lambda x: calls.append(x), 1, warmup=2,
                                iters=5)
    assert len(calls) == 7 and seconds >= 0.0


def _trace(tmp_path, spans, extra=()):
    """A Chrome trace of device activities ``(cat, ts, dur)`` in µs, with
    ``extra`` events besides."""
    events = [{"ph": "X", "cat": cat, "name": f"k{i}", "ts": ts, "dur": dur,
               "pid": 0, "tid": 7} for i, (cat, ts, dur) in enumerate(spans)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events + list(extra)}))
    return path


@pytest.mark.parametrize("spans, union_us", [
    # disjoint
    ([("kernel", 0, 10), ("gpu_memcpy", 20, 5), ("gpu_memset", 40, 10)], 25),
    # overlapping (a chain, as programmatic dependent launch leaves them)
    ([("kernel", 0, 10), ("kernel", 5, 10), ("kernel", 12, 8)], 20),
    # nested, given out of order
    ([("kernel", 10, 2), ("kernel", 0, 30), ("gpu_memcpy", 5, 5)], 30),
    # touching ends, and a zero-length set
    ([("kernel", 0, 10), ("kernel", 10, 10), ("gpu_memset", 50, 0)], 20),
])
def test_device_busy_is_the_union_of_device_intervals(tmp_path, spans,
                                                      union_us):
    host = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
             "dur": 100, "pid": 0, "tid": 1},
            {"ph": "X", "cat": "gpu_user_annotation", "name": "d_step",
             "ts": 0, "dur": 100, "pid": 0, "tid": 7},
            {"ph": "i", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": 3, "pid": 0, "tid": 1}]
    path = _trace(tmp_path, spans, host)
    summed = sum(dur for _, _, dur in spans)
    assert profiling.device_busy(path, 100e-6) == pytest.approx(
        union_us / 100)
    assert profiling.device_busy(str(path), 1.0) == pytest.approx(
        union_us / 1e6)
    assert union_us <= summed
    # A window shorter than the span is the span: the share stays <= 1.
    span = max(ts + dur for _, ts, dur in spans) - min(ts for _, ts, _ in
                                                       spans)
    share = profiling.device_busy(path, 1e-6)
    assert share == pytest.approx(union_us / span) and share <= 1.0


def test_device_busy_of_a_run_without_device_work_is_0(tmp_path):
    assert profiling.device_busy(_trace(tmp_path, []), 1e-3) == 0.0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(8) @ torch.ones(8)
    assert profiling.device_busy(prof, 1e-3) == 0.0
