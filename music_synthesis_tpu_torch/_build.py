"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

A ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and is
compiled into ``build/kernels/lib<name>.so`` at the repository
root (git-ignored), which takes seconds. A library is rebuilt when it is
missing or older than its source. Builds happen at first use, inside the
process that launches the kernel, never at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "BuildResult", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    library: Path
    seconds: float  # 0.0 when an up-to-date library was reused
    ptxas: tuple[str, ...]  # nvcc's -Xptxas -v lines: registers, spills


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` into ``build/kernels/lib<name>.so`` unless
    the library is newer than its source. Raises with nvcc's output on any
    failure."""
    source = CSRC / f"{name}.cu"
    library = BUILD_DIR / f"lib{name}.so"
    if library.exists() and library.stat().st_mtime >= source.stat().st_mtime:
        return BuildResult(name, library, 0.0, ())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, library)
    ptxas = tuple(line.strip() for line in proc.stdout.splitlines()
                  if "ptxas" in line or "spill" in line)
    return BuildResult(name, library, seconds, ptxas)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``lib<name>.so``, building it first if needed."""
    return ctypes.CDLL(str(build(name).library))
