"""Serving load benchmark: latency and throughput of concurrent requests
(counterpart of ``scripts/bench_serve.py``).

    python -m music_synthesis_tpu_torch.scripts.bench_serve \\
        --requests 32 --concurrency 8 --coalesce-ms 5 --seconds 4 \\
        [--device cpu]

Measures the in-process ``serve.SynthService`` (no HTTP): ``--requests``
threads each ask for one clip of ``--seconds`` audio (seed = the request's
index, raw model level), at most ``--concurrency`` at a time, a closed
loop. Prints, as the JAX script does, the wall time and throughput in
audio seconds per second, the request latency's p50 and p95 (over every
request, client side), and the device calls the service made for them
(the coalescer's merge ratio, requests per device call); then one JSON
line of the same numbers with the card's name and power limit. Run with
``--coalesce-ms 0`` for the baseline: the difference is what request
merging buys on one card. The service runs its device work on one worker
thread, so without coalescing requests queue behind each other. On a card
its bucket programs replay CUDA graphs (captured at warm-up); the same
load with the graphs disabled follows, its numbers on a stderr line. Runs
on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from music_synthesis_tpu_torch._graphs import disable_graphs
from music_synthesis_tpu_torch.bench import card_record
from music_synthesis_tpu_torch.scripts._run import cli_device
from music_synthesis_tpu_torch.serve import ServeConfig, SynthService

_JOIN_S = 600.0  # a request that takes longer than this fails the run


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bench_serve",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--composer", default="specgan_rich")
    ap.add_argument("--vocoder", default="vocoder_rich")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--coalesce-ms", type=float, default=5.0)
    ap.add_argument("--batch-buckets", default="1,4,8")
    ap.add_argument("--patch-buckets", default="4")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default=None, help="cuda unless given")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Returns the JSON line's object."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.requests < 1 or args.concurrency < 1:
        ap.error("--requests and --concurrency must be >= 1")
    dev = cli_device(ap, args.device)
    sc = ServeConfig(
        composer=args.composer,
        vocoder=args.vocoder,
        batch_buckets=tuple(int(x) for x in args.batch_buckets.split(",")),
        patch_buckets=tuple(int(x) for x in args.patch_buckets.split(",")),
        coalesce_window_ms=args.coalesce_ms,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        target_rms=0.0,
    )
    print(f"warming {len(sc.batch_buckets) * len(sc.patch_buckets)} buckets "
          f"(+stream) ...", flush=True)
    svc = SynthService(sc, device=dev)
    card = card_record(svc.device)
    print(f"device: {svc.health()['device']} ({card['card']})", flush=True)

    try:
        wall, lat, m = _load(svc, args)
        if svc.device.type == "cuda":
            # The same load with the graphs disabled, for the stderr line.
            with disable_graphs():
                e_wall, e_lat, _ = _load(svc, args)
    finally:
        svc.close()

    n = len(lat)
    audio_s = args.requests * args.seconds
    p50, p95 = _percentiles(lat)
    merge = m["requests"] / max(1, m["device_calls"])
    print(f"requests: {args.requests} @ concurrency {args.concurrency}, "
          f"coalesce {args.coalesce_ms} ms")
    print(f"wall: {wall:.3f}s  throughput: {audio_s / wall:.1f} "
          f"audio-sec/sec  (serving RTF {audio_s / wall:.1f}x)")
    print(f"latency p50: {p50 * 1e3:.2f} ms  p95: {p95 * 1e3:.2f} ms")
    print(f"device_calls: {m['device_calls']} for {m['requests']} requests "
          f"(merge ratio {merge:.2f}x)")
    line = {"requests": args.requests, "answered": n,
            "concurrency": args.concurrency,
            "coalesce_ms": args.coalesce_ms, "seconds": args.seconds,
            "composer": svc.composer_name, "vocoder": svc.vocoder_name,
            "compute_dtype": sc.compute_dtype, "wall_s": wall,
            "throughput_audio_s_per_s": audio_s / wall,
            "latency_p50_ms": p50 * 1e3, "latency_p95_ms": p95 * 1e3,
            "device_calls": m["device_calls"],
            "service_requests": m["requests"], "merge_ratio": merge,
            **card}
    if svc.device.type == "cuda":
        e_p50, e_p95 = _percentiles(e_lat)
        print(f"eager (graphs disabled): wall {e_wall:.3f}s, throughput "
              f"{audio_s / e_wall:.1f} audio-sec/sec, latency p50 "
              f"{e_p50 * 1e3:.2f} ms, p95 {e_p95 * 1e3:.2f} ms; graphed "
              f"p50 {p50 * 1e3:.2f} ms, p95 {p95 * 1e3:.2f} ms on "
              f"{card['card']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return line


def _percentiles(lat: list[float]) -> tuple[float, float]:
    """p50 and p95 of ``lat`` (sorted in place)."""
    lat.sort()
    n = len(lat)
    return lat[n // 2], lat[min(n - 1, int(n * 0.95))]


def _load(svc: SynthService, args) -> tuple[float, list[float], dict]:
    """One closed-loop run of ``args.requests`` requests: ``(wall s,
    latencies s, the service's metrics counted over the run)``; raises
    when a request failed."""
    lat: list[float] = []
    failed: list[str] = []
    lock = threading.Lock()
    sem = threading.Semaphore(args.concurrency)
    m0 = svc.metrics()

    def worker(i: int) -> None:
        with sem:
            t0 = time.perf_counter()
            try:
                wav, _ = svc.synth(seconds=args.seconds, seed=i,
                                   target_rms=0.0)
                error = (None if np.isfinite(wav).all()
                         else "non-finite audio")
            except Exception as e:  # noqa: BLE001 -- counted as failed
                error = repr(e)
            dt = time.perf_counter() - t0
        with lock:
            if error is None:
                lat.append(dt)
            else:
                failed.append(f"request {i}: {error}")

    t_start = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(args.requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=_JOIN_S)
    wall = time.perf_counter() - t_start
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"requests still running after {_JOIN_S} s")
    if failed:
        raise RuntimeError(f"{len(failed)} of {args.requests} requests "
                           f"failed: {failed[:3]}")
    m = svc.metrics()
    return wall, lat, {k: m[k] - m0[k] for k in ("requests", "device_calls")}


if __name__ == "__main__":
    main()
