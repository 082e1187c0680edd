"""The benchmark of ``music_synthesis_tpu_torch`` on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: its
window driver (``benchmark/drivers/<kind>.py``, the traffic file's
``kind``) sets the program up, measures for ``--seconds``, and checks what
the timed path produced against the plain reference (``benchmark/
reference/``). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer ones with ``--trace 1``, each
read by ``benchmark/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit;
the same numbers are the last lines of standard error. ``--control 1``
runs the cell's control (a lower precision in the program's place), which
has to come out not correct.

Exits 2 without a card (or with fewer than the cell asks for), 3 where
the program is missing beside ``benchmark/``, and 4 where JAX, Flax or the
JAX package was imported; each prints no result. Build caches stay in the
checkout's ``build/`` (git-ignored).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Fixed cache directories inside the checkout, before torch is imported.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "music_synthesis_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="benchmark/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if not (ROOT / "music_synthesis_tpu_torch" / "__init__.py").exists():
        print("benchmark: the program music_synthesis_tpu_torch is not in "
              f"{ROOT}", file=sys.stderr)
        return 3
    from harness.config import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from harness.core import result_line, run_cell

    ctx = run_cell(cell, device="cuda", seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), t0=T0, control=bool(args.control))
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules were imported: {found}",
              file=sys.stderr)
        return 4
    line = result_line(ctx)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
