"""ctypes bindings of the host-side audio IO library (counterpart of
``data/native.py``).

WAV decoding (PCM 8/16/24/32-bit and IEEE float, downmixed to mono) and
polyphase windowed-sinc resampling in C++ (``csrc/msynth_io.cc``, a copy of
the JAX package's ``native/msynth_io.cc``), built with g++ into
``build/kernels/libmsynth_io.so`` at first use (``_build.py``).
``available()`` is False only when there is no g++ (and no library built
before): callers (``utils.wav.load_wav``) then take the scipy path.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from music_synthesis_tpu_torch import _build

__all__ = ["available", "decode_wav", "resample"]

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = _build.load("msynth_io")
    except _build.CompilerMissing:
        return None
    lib.msynth_decode_wav.restype = ctypes.c_int
    lib.msynth_decode_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.msynth_resample.restype = ctypes.c_int
    lib.msynth_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return lib


def available() -> bool:
    """True when the C++ IO library is built or can be (else scipy path)."""
    return _load() is not None


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native IO library needs g++ to build")
    return lib


def decode_wav(data: bytes) -> tuple[int, np.ndarray]:
    """RIFF/WAVE bytes -> (sample_rate, float32 mono waveform)."""
    lib = _lib_or_raise()
    n = ctypes.c_int64(0)
    rate = ctypes.c_int32(0)
    rc = lib.msynth_decode_wav(data, len(data), None, 0,
                               ctypes.byref(n), ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"msynth_decode_wav failed: {rc}")
    out = np.empty(n.value, np.float32)
    rc = lib.msynth_decode_wav(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n.value,
        ctypes.byref(n), ctypes.byref(rate),
    )
    if rc != 0:
        raise ValueError(f"msynth_decode_wav failed: {rc}")
    return rate.value, out


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Rational polyphase resampling, float32."""
    lib = _lib_or_raise()
    x = np.ascontiguousarray(x, np.float32)
    if sr_in == sr_out:
        return x
    g = math.gcd(sr_in, sr_out)
    n_out = -(-len(x) * (sr_out // g) // (sr_in // g))
    out = np.empty(n_out, np.float32)
    got = ctypes.c_int64(0)
    rc = lib.msynth_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        sr_in, sr_out,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_out,
        ctypes.byref(got),
    )
    if rc != 0:
        raise ValueError(f"msynth_resample failed: {rc}")
    return out[: got.value]
