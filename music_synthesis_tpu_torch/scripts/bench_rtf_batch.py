"""Batch-size sweep of the two-stage inference real-time factor (counterpart
of ``scripts/bench_rtf_batch.py``).

    python -m music_synthesis_tpu_torch.scripts.bench_rtf_batch \\
        [--batches 8,16,32,64,128 --repeats 3 --calls 192 \\
         --preset fast|tiny --device cpu]

``music_synthesis_tpu_torch.bench`` pins the headline at batch 16; this
sweep measures where the card's throughput saturates. The method is the
bench's (``bench.graphed_and_eager_s``): n ``generate`` calls on fresh
latents drawn on the device (on a card each the replay of one CUDA graph
per batch, the eager time on stderr), one checksum read per run, the
per-call time from the difference of a 1-call and an n-call run, the least
over the repeats with the per > 0 filter. n is ``--calls`` at batch 16, scaled inversely
with the batch so that each timed run does about the same work. Seeded
random weights (the real-time factor does not depend on them); ``tiny``
is a check of the harness on the CPU. Prints one JSON line,
``{"sweep": [...], "best": {...}}`` with the card's name and power limit;
everything else goes to stderr. Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import torch

from music_synthesis_tpu_torch.bench import (
    Env,
    generate_checksum,
    graphed_and_eager_s,
    inference_models,
    log,
)
from music_synthesis_tpu_torch.config import E2E_INFERENCE_FAST, TINY
from music_synthesis_tpu_torch.infer.generate import GraphedPipeline
from music_synthesis_tpu_torch.scripts._run import cli_device

PRESETS = {"fast": E2E_INFERENCE_FAST, "tiny": TINY}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bench_rtf_batch",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="8,16,32,64,128")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--calls", type=int, default=192,
                    help="generate() calls of a timed run at batch 16; "
                         "scaled inversely with the batch")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="fast",
                    help="tiny = a check of the harness itself")
    ap.add_argument("--device", default=None, help="cuda unless given")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Returns the JSON line's object."""
    ap = parser()
    args = ap.parse_args(argv)
    env = Env(cli_device(ap, args.device))
    cfg = PRESETS[args.preset]
    composer, vocoder = inference_models(cfg, env)
    pipe = GraphedPipeline(cfg, composer, vocoder)
    log(f"[bench_rtf_batch] {env.card['card']}, preset {args.preset}")
    rows = []
    for batch in (int(b) for b in args.batches.split(",")):
        samples = batch * cfg.specgan.n_frames * cfg.vocoder.hop_length
        audio_sec = samples / cfg.frontend.sample_rate

        def many(n: int, gen: torch.Generator, _b=batch) -> torch.Tensor:
            total = torch.zeros((), device=env.device)
            for _ in range(n):
                z = torch.randn((_b, cfg.specgan.latent_dim), generator=gen,
                                device=env.device)
                total = total + generate_checksum(cfg, composer, vocoder, z,
                                                  pipe=pipe)
            return total

        n_iters = max(5, (args.calls * 16) // batch + 1)
        best = graphed_and_eager_s(f"batch {batch}", env, many, n_iters,
                                   args.repeats, positive=True)
        rows.append({"batch": batch, "calls": n_iters,
                     "ms_per_call": best * 1e3,
                     "audio_sec_per_call": audio_sec,
                     "rtf_per_chip": audio_sec / best})
        log(f"batch {batch:4d}: {best * 1e3:9.4f} ms/call -> "
            f"{audio_sec / best:10.1f}x real time")
    line = {"sweep": rows, "best": max(rows, key=lambda r: r["rtf_per_chip"]),
            **env.card}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
