"""WAV I/O and resampling on the host (counterpart of ``utils/wav.py``).

``scipy.io.wavfile`` and polyphase resampling
(``scipy.signal.resample_poly``); float32 numpy arrays at the target rate.
``load_wav`` prefers the C++ decoder and resampler (``data/native.py``)
and takes the scipy path when it cannot be built, as the JAX package does.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.io.wavfile
import scipy.signal

__all__ = ["read_wav", "write_wav", "resample", "load_wav"]

_INT_SCALES = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0}


def read_wav(path) -> tuple[int, np.ndarray]:
    """Read a WAV file -> (sample_rate, float32 mono waveform in [-1, 1])."""
    sr, data = scipy.io.wavfile.read(path)
    if data.dtype in _INT_SCALES:
        data = data.astype(np.float32) / _INT_SCALES[data.dtype]
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:  # downmix to mono
        data = data.mean(axis=1)
    return sr, data


def write_wav(path, sample_rate: int, data: np.ndarray) -> None:
    """Write a float waveform as 16-bit PCM WAV (clipped to [-1, 1])."""
    pcm = np.clip(np.asarray(data), -1.0, 1.0)
    scipy.io.wavfile.write(path, sample_rate, (pcm * 32767.0).astype(np.int16))


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling on the host."""
    if orig_sr == target_sr:
        return x.astype(np.float32)
    g = math.gcd(orig_sr, target_sr)
    out = scipy.signal.resample_poly(x, target_sr // g, orig_sr // g)
    return out.astype(np.float32)


def load_wav(path, target_sr: int = 22_050,
             use_native: bool = True) -> np.ndarray:
    """Read, downmix and resample to the front-end rate: with the native
    C++ decoder and resampler (``data/native.py``) when ``use_native`` and
    it is available, else with scipy."""
    if use_native:
        from music_synthesis_tpu_torch.data import native

        if native.available():
            with open(path, "rb") as fh:
                sr, data = native.decode_wav(fh.read())
            if sr == target_sr:
                return data
            return native.resample(data, sr, target_sr)
    sr, data = read_wav(path)
    return resample(data, sr, target_sr)
