"""Builds the port's native sources and loads them with ctypes.

A ``csrc/<name>.cu`` (CUDA, compiled by nvcc) or ``csrc/<name>.cc`` (host
C++, compiled by g++ with the flags of ``scripts/build_native.sh`` less
``-march=native``) has a plain C interface (no PyTorch headers) and is
compiled into ``build/kernels/lib<name>.so`` at the repository root
(git-ignored), which takes seconds. A library is rebuilt when it is
missing or older than its source; concurrent builders each write their own
file and rename it into place. Builds happen at first use, inside the
process that calls the library, never at import.
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

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "HOST_FLAGS", "CompilerMissing",
           "BuildResult", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class CompilerMissing(RuntimeError):
    """The compiler a source needs is not installed."""


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
    raise CompilerMissing("nvcc not found: the CUDA kernels build only on a "
                          "machine with the CUDA toolkit")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise CompilerMissing("g++ not found: the host libraries need a C++ "
                          "compiler")


def _source(name: str) -> Path:
    for suffix in (".cu", ".cc"):
        if (CSRC / f"{name}{suffix}").exists():
            return CSRC / f"{name}{suffix}"
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cc")


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cc`` (g++) into
    ``build/kernels/lib<name>.so`` unless the library is newer than its
    source. Raises with the compiler's output on any failure, and
    ``CompilerMissing`` when there is no compiler."""
    source = _source(name)
    library = BUILD_DIR / f"lib{name}.so"
    if library.exists() and library.stat().st_mtime >= source.stat().st_mtime:
        return BuildResult(name, library, 0.0, ())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    t0 = time.perf_counter()
    compiler = ([_nvcc(), *NVCC_FLAGS] if source.suffix == ".cu"
                else [_gxx(), *HOST_FLAGS])
    proc = subprocess.run([*compiler, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(compiler[0]).name} failed for "
                           f"{source.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, library)
    ptxas = tuple(line.strip() for line in proc.stdout.splitlines()
                  if "ptxas" in line or "spill" in line)
    return BuildResult(name, library, seconds, ptxas)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``lib<name>.so``, building it first if needed."""
    return ctypes.CDLL(str(build(name).library))
