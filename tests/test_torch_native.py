"""The port's native IO library (``data/native.py``, ``csrc/msynth_io.cc``
built with g++) against scipy and the JAX package's ``load_wav``.

The cases of ``tests/test_native.py`` (which skips here: the JAX package's
own library is not built), with its tolerances: PCM16 stereo decode within
1e-7 of scipy's downmix, float32 decode exact, garbage rejected, the
resampled tone within 5e-4 of ``scipy.signal.resample_poly`` away from
500 edge samples, the upsampled length, the native ``load_wav`` within
2e-3 of the scipy path away from 200 edge samples (the C++ resampler's own
Kaiser design), the prefetcher's order and error. Besides: the C++ source
is the JAX package's byte for byte; the port's ``use_native=False`` path
equals JAX's ``load_wav(use_native=False)`` exactly, and so does the
default path at the corpora's own rate (22.05 kHz PCM16, no resampling);
without g++ ``available()`` is False and ``load_wav`` takes the scipy path.
"""

import io
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile
import scipy.signal

from music_synthesis_tpu.utils import wav as jax_wav
from music_synthesis_tpu_torch import _build
from music_synthesis_tpu_torch.data import native
from music_synthesis_tpu_torch.data.prefetch import Prefetcher
from music_synthesis_tpu_torch.utils import wav

REPO = Path(__file__).resolve().parents[1]


def _wav_bytes(sr, data):
    buf = io.BytesIO()
    scipy.io.wavfile.write(buf, sr, data)
    return buf.getvalue()


def test_source_is_the_reference_copy():
    assert ((REPO / "music_synthesis_tpu_torch" / "csrc" / "msynth_io.cc")
            .read_bytes() == (REPO / "native" / "msynth_io.cc").read_bytes())
    assert native.available()


def test_decode_pcm16_stereo_matches_scipy(rng):
    stereo = (rng.standard_normal((4000, 2)) * 8000).astype(np.int16)
    sr, mono = native.decode_wav(_wav_bytes(44100, stereo))
    want = stereo.astype(np.float32).mean(axis=1) / 32768.0
    assert sr == 44100
    np.testing.assert_allclose(mono, want, atol=1e-7)


def test_decode_float32(rng):
    f32 = (rng.standard_normal(1000) * 0.5).astype(np.float32)
    sr, out = native.decode_wav(_wav_bytes(22050, f32))
    np.testing.assert_array_equal(out, f32)


def test_decode_rejects_garbage():
    with pytest.raises(ValueError):
        native.decode_wav(b"not a wav file at all")


def test_resample_matches_scipy_tone():
    t = np.arange(44100) / 44100
    tone = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    out = native.resample(tone, 44100, 22050)
    ref = scipy.signal.resample_poly(tone, 1, 2).astype(np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out[500:-500], ref[500:-500], atol=5e-4)


def test_resample_upsample_length():
    x = np.zeros(1000, np.float32)
    out = native.resample(x, 8000, 22050)
    assert len(out) == -(-1000 * 22050 // 8000)


def test_load_wav_native_path(tmp_path, rng):
    x = np.clip(rng.standard_normal(4000) * 0.3, -1, 1)
    wav.write_wav(tmp_path / "x.wav", 44100, x)
    nat = wav.load_wav(tmp_path / "x.wav", 22050, use_native=True)
    ref = wav.load_wav(tmp_path / "x.wav", 22050, use_native=False)
    assert nat.shape == ref.shape
    np.testing.assert_allclose(nat[200:-200], ref[200:-200], atol=2e-3)
    np.testing.assert_array_equal(
        ref, jax_wav.load_wav(tmp_path / "x.wav", 22050, use_native=False))
    # At the corpora's rate the native decode is the scipy one, exactly.
    wav.write_wav(tmp_path / "y.wav", 22050, x)
    np.testing.assert_array_equal(
        wav.load_wav(tmp_path / "y.wav", 22050),
        jax_wav.load_wav(tmp_path / "y.wav", 22050, use_native=False))


def test_without_a_compiler_load_wav_takes_scipy(tmp_path, rng, monkeypatch):
    x = np.clip(rng.standard_normal(4000) * 0.3, -1, 1)
    wav.write_wav(tmp_path / "x.wav", 44100, x)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_lib", None)
    _build.load.cache_clear()
    try:
        assert not native.available()
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            native.resample(np.zeros(8, np.float32), 2, 1)
        np.testing.assert_array_equal(
            wav.load_wav(tmp_path / "x.wav", 22050),
            jax_wav.load_wav(tmp_path / "x.wav", 22050, use_native=False))
    finally:
        _build.load.cache_clear()


def test_prefetcher_order_and_error():
    out = [(s, b) for s, b in Prefetcher(lambda s: s * 10, 3, 8, depth=2)]
    assert out == [(s, s * 10) for s in range(3, 8)]

    def boom(s):
        if s == 2:
            raise RuntimeError("boom")
        return s

    with pytest.raises(RuntimeError, match="boom"):
        list(Prefetcher(boom, 0, 5))
