"""Write the synthetic rich corpus (counterpart of ``scripts/make_corpus.py``).

    python -m music_synthesis_tpu_torch.scripts.make_corpus --out DIR
        [--clips 256 --seconds 30 --seed 0]     # 2.1 h; 1920 clips = 16 h

``data.dataset.make_rich_corpus``: the same files, byte for byte, as the
JAX package writes for the same flags (one seed per clip), so the two
packages evaluate on the same held-out clips.
"""

from __future__ import annotations

import argparse
import time

from music_synthesis_tpu_torch.data.dataset import make_rich_corpus


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="make_corpus",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--clips", type=int, default=256,
                    help="256 x 30 s = 2.1 h; 1920 = 16 h")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    t0 = time.time()
    paths = make_rich_corpus(args.out, n_clips=args.clips,
                             seconds=args.seconds, seed=args.seed)
    print(f"done: {len(paths)} clips "
          f"({len(paths) * args.seconds / 3600:.1f} h) "
          f"in {time.time() - t0:.0f}s -> {args.out}")


if __name__ == "__main__":
    main()
