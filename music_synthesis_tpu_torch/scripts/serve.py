"""Serve zoo models over HTTP (counterpart of ``scripts/serve.py``).

    python -m music_synthesis_tpu_torch.scripts.serve --port 8000
    curl -s localhost:8000/healthz
    curl -s -X POST localhost:8000/generate \\
        -d '{"seconds": 8, "seed": 3}' -o out.wav

Every (batch, patches) bucket and the streaming calls run once at start-up
(``serve.SynthService.warm_all``); the routes are ``serve.py``'s. Runs on
``cuda`` unless ``--device cpu`` is given. ``--mesh N`` shards each
bucket's batch over ``cuda:0`` .. ``cuda:N-1`` (N replicas on the CPU
with ``--device cpu``); every batch bucket must divide by N.
"""

from __future__ import annotations

import argparse

from music_synthesis_tpu_torch.scripts._run import cli_device
from music_synthesis_tpu_torch.serve import ServeConfig, SynthService, make_server


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="serve",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--composer", default="specgan_flux")
    ap.add_argument("--vocoder", default="vocoder_istft")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch-buckets", default="1,4")
    ap.add_argument("--patch-buckets", default="1,2,4,8")
    ap.add_argument("--crossfade-frames", type=int, default=8)
    ap.add_argument("--target-rms", type=float, default=0.1,
                    help="default loudness calibration; 0 = raw model level")
    ap.add_argument("--mesh", type=int, default=1,
                    help="devices to shard each bucket's batch over")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 activations in both generators")
    ap.add_argument("--coalesce-ms", type=float, default=0.0,
                    help="merge concurrent requests into one device call "
                         "within this window (0 = off)")
    ap.add_argument("--gl-refine", type=int, default=0,
                    help="warm-started Griffin-Lim iterations per served "
                         "clip (0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' for smoke runs)")
    return ap


def serve_config(args: argparse.Namespace) -> ServeConfig:
    """The deployment the flags describe."""
    return ServeConfig(
        composer=args.composer,
        vocoder=args.vocoder,
        batch_buckets=tuple(int(x) for x in args.batch_buckets.split(",")),
        patch_buckets=tuple(int(x) for x in args.patch_buckets.split(",")),
        crossfade_frames=args.crossfade_frames,
        target_rms=args.target_rms,
        mesh_devices=args.mesh,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        coalesce_window_ms=args.coalesce_ms,
        gl_refine=args.gl_refine,
    )


def main(argv: list[str] | None = None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    sc = serve_config(args)
    dev = cli_device(ap, args.device)
    print(f"loading {args.composer} + {args.vocoder}; warming "
          f"{len(sc.batch_buckets) * len(sc.patch_buckets)} shape buckets...",
          flush=True)
    svc = SynthService(sc, device=dev)
    print(f"warm: {svc.health()}", flush=True)
    httpd = make_server(svc, host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{httpd.server_address[1]}",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        httpd.service.close()


if __name__ == "__main__":
    main()
