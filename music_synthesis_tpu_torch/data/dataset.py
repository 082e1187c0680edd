"""Training data pipeline on the host (counterpart of ``data/dataset.py``).

Scan a directory of WAVs, resample to the front-end rate, and sample
fixed-length segments into fixed-shape batches. Sampling is step-seeded and
process-sharded, so data order is deterministic and resumable and each
process of a multi-process run reads a disjoint shard. The arrays, and the
WAV files the corpus generators write, equal the JAX package's bit for bit.

Also provides deterministic synthetic "music-like" corpora (harmonic notes
with envelopes; melodies, chords and percussion) so that training, tests
and benchmarks run without a downloaded dataset.
"""

from __future__ import annotations

import collections
import os
import threading
from pathlib import Path

import numpy as np

from music_synthesis_tpu_torch.utils.wav import load_wav, write_wav

__all__ = ["AudioDataset", "make_synthetic_corpus", "make_rich_corpus"]


class AudioDataset:
    """Corpus of mono waveforms at the target sample rate.

    Two residency modes (a MusicNet-class corpus is tens of GB, far past
    host RAM):

    * ``ram_budget_mb=None`` (default): fully decoded into RAM up front —
      zero per-step IO, right for small/medium corpora.
    * ``ram_budget_mb=N``: only (path, length) metadata is kept resident;
      decoded clips live in an LRU cache capped at N MB and are re-decoded
      on miss. Sampling stays step-seeded and deterministic either way (the
      sampling decisions depend only on the recorded lengths).

    The one-time init scan decodes each file once (one clip in flight) to
    record its resampled length; in budgeted mode the scan also warms the
    LRU, so small corpora behave identically in both modes.
    """

    def __init__(
        self,
        root: str | os.PathLike,
        sample_rate: int = 22_050,
        segment_length: int = 8192,
        min_length: int | None = None,
        process_index: int = 0,
        process_count: int = 1,
        ram_budget_mb: int | None = None,
        augment: bool = False,
    ):
        self.sample_rate = sample_rate
        self.segment_length = segment_length
        # Waveform-domain augmentation (host-side, per segment): random
        # gain in [0.6, 1.0] and polarity flip. Both are label-free
        # invariances of music audio; they multiply the effective corpus
        # without touching spectral content. Deterministic in (step, seed)
        # like the rest of the sampler.
        self.augment = augment
        min_length = min_length or segment_length
        paths = sorted(Path(root).rglob("*.wav"))
        # Shard files across hosts: each process loads a disjoint subset.
        paths = paths[process_index::process_count]
        if not paths:
            raise FileNotFoundError(f"no .wav files under {root}")
        self.paths: list[Path] = []
        self.lengths: list[int] = []
        self._budget = (
            None if ram_budget_mb is None else ram_budget_mb * (1 << 20)
        )
        self._cache: collections.OrderedDict[int, np.ndarray] = (
            collections.OrderedDict()
        )
        self._cache_bytes = 0
        # Single lock around the LRU: the prefetcher thread and the main
        # thread (audio dumps, parity evals) may sample concurrently.
        self._lock = threading.Lock()
        self.clips: list[np.ndarray] | None = [] if self._budget is None else None
        for p in paths:
            wav = load_wav(p, sample_rate)
            if len(wav) < min_length:
                continue
            self.paths.append(p)
            self.lengths.append(len(wav))
            if self.clips is not None:
                self.clips.append(wav)
            else:
                self._cache_put(len(self.paths) - 1, wav)
        if not self.paths:
            raise ValueError(f"no clips of >= {min_length} samples under {root}")

    def __len__(self) -> int:
        return len(self.paths)

    def _cache_put(self, idx: int, wav: np.ndarray) -> None:
        self._cache[idx] = wav
        self._cache_bytes += wav.nbytes
        while self._cache_bytes > self._budget and len(self._cache) > 1:
            _, old = self._cache.popitem(last=False)
            self._cache_bytes -= old.nbytes

    def _get_clip(self, idx: int) -> np.ndarray:
        if self.clips is not None:
            return self.clips[idx]
        with self._lock:
            wav = self._cache.get(idx)
            if wav is not None:
                self._cache.move_to_end(idx)
                return wav
        wav = load_wav(self.paths[idx], self.sample_rate)
        with self._lock:
            if idx not in self._cache:
                self._cache_put(idx, wav)
        return wav

    def sample_batch(self, step: int, batch_size: int, seed: int = 0) -> np.ndarray:
        """Step-seeded segment batch ``[B, segment_length]`` float32.

        Deterministic in (step, seed): restoring a checkpoint and replaying
        from the same step reproduces the exact data order.
        """
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        out = np.empty((batch_size, self.segment_length), np.float32)
        clip_idx = rng.integers(0, len(self.paths), size=batch_size)
        for i, ci in enumerate(clip_idx):
            start = rng.integers(0, self.lengths[ci] - self.segment_length + 1)
            clip = self._get_clip(ci)
            out[i] = clip[start : start + self.segment_length]
        if self.augment:
            gain = rng.uniform(0.6, 1.0, size=(batch_size, 1)).astype(
                np.float32)
            sign = rng.choice(
                np.float32([-1.0, 1.0]), size=(batch_size, 1))
            out *= gain * sign
        return out


def make_synthetic_corpus(
    root: str | os.PathLike,
    n_clips: int = 8,
    seconds: float = 4.0,
    sample_rate: int = 22_050,
    seed: int = 0,
) -> list[Path]:
    """Write deterministic harmonic clips (notes + envelopes) as WAVs."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate
    paths = []
    scale = 220.0 * 2.0 ** (np.arange(15) / 12.0)  # A3 chromatic-ish
    for c in range(n_clips):
        wav = np.zeros(n, np.float64)
        n_notes = rng.integers(4, 10)
        for _ in range(n_notes):
            f0 = rng.choice(scale)
            onset = rng.uniform(0, seconds * 0.8)
            dur = rng.uniform(0.3, 1.5)
            amp = rng.uniform(0.05, 0.2)
            env = np.clip((t - onset) / 0.02, 0, 1) * np.exp(
                -np.maximum(t - onset, 0) / (dur / 3)
            ) * (t >= onset)
            for h, ha in enumerate((1.0, 0.5, 0.33, 0.25)):
                wav += amp * ha * env * np.sin(2 * np.pi * f0 * (h + 1) * t)
        peak = np.abs(wav).max()
        if peak > 0:
            wav = 0.7 * wav / peak
        p = root / f"clip_{c:03d}.wav"
        write_wav(p, sample_rate, wav)
        paths.append(p)
    return paths


# Just-intonation-ish chord shapes over a root, in semitones.
_CHORDS = ((0, 4, 7), (0, 3, 7), (0, 5, 9), (0, 4, 7, 11), (0, 3, 7, 10))
_SCALE = (0, 2, 4, 5, 7, 9, 11)  # major scale degrees


def _render_note(
    t: np.ndarray, f0: float, timbre: dict, rng: np.random.Generator
) -> np.ndarray:
    """One note on [0, len(t)) with the given instrument timbre."""
    n = len(t)
    harm = timbre["harmonics"]
    bright = timbre["brightness"] * rng.uniform(0.7, 1.3)
    # Attack/decay envelope; organ-like timbres sustain, plucks decay fast.
    attack = timbre["attack"] * rng.uniform(0.5, 1.5)
    decay = timbre["decay"] * rng.uniform(0.6, 1.6)
    env = np.minimum(t / max(attack, 1e-4), 1.0)
    if timbre["sustain"] < 1.0:
        env = env * np.exp(-t / decay)
    else:
        release = 0.05
        env = env * np.clip((t[-1] - t) / release, 0.0, 1.0)
    vib = timbre["vibrato"] * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * t)
    phase = 2 * np.pi * f0 * (t + vib)
    out = np.zeros(n)
    for h in range(1, harm + 1):
        amp = bright ** (h - 1) / h
        # Per-harmonic decay: high partials die faster (physical strings).
        henv = env * np.exp(-t * timbre["hf_damp"] * (h - 1))
        out += amp * henv * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
    return out


def make_rich_corpus(
    root: str | os.PathLike,
    n_clips: int = 256,
    seconds: float = 30.0,
    sample_rate: int = 22_050,
    seed: int = 0,
) -> list[Path]:
    """Deterministic polyphonic corpus: melodies + chords + percussion over
    several instrument timbres (pluck / organ / brass-ish / bell), per-clip
    key and tempo. Default size ~2.1 hours, the scale of the long training
    runs when no real corpus is at hand.
    """
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    timbres = [
        # harmonics, brightness (partial rolloff), attack s, decay s,
        # sustain flag, vibrato depth s, high-frequency damping
        dict(harmonics=8, brightness=0.75, attack=0.004, decay=0.5,
             sustain=0.0, vibrato=0.0, hf_damp=3.0),      # pluck
        dict(harmonics=6, brightness=0.5, attack=0.05, decay=2.0,
             sustain=1.0, vibrato=0.0005, hf_damp=0.2),   # organ
        dict(harmonics=10, brightness=0.85, attack=0.03, decay=1.0,
             sustain=0.0, vibrato=0.001, hf_damp=1.0),    # brass-ish
        dict(harmonics=5, brightness=0.4, attack=0.002, decay=1.8,
             sustain=0.0, vibrato=0.0, hf_damp=0.5),      # bell/keys
    ]
    n = int(seconds * sample_rate)
    paths = []
    for c in range(n_clips):
        rng = np.random.default_rng(np.random.SeedSequence([seed, 7919, c]))
        wav = np.zeros(n, np.float64)
        key_hz = 110.0 * 2.0 ** (rng.integers(0, 12) / 12.0)
        bpm = rng.uniform(60, 150)
        beat = 60.0 / bpm
        melody_timbre = timbres[rng.integers(0, len(timbres))]
        chord_timbre = timbres[rng.integers(0, len(timbres))]

        # Chord pads every 2-4 beats.
        tc = 0.0
        while tc < seconds - 1.0:
            dur = beat * rng.integers(2, 5)
            shape = _CHORDS[rng.integers(0, len(_CHORDS))]
            base = key_hz * 2.0 ** (rng.choice(_SCALE) / 12.0)
            i0 = int(tc * sample_rate)
            i1 = min(int((tc + dur) * sample_rate), n)
            tt = np.arange(i1 - i0) / sample_rate
            for semi in shape:
                f = base * 2.0 ** (semi / 12.0)
                wav[i0:i1] += 0.12 * _render_note(tt, f, chord_timbre, rng)
            tc += dur

        # Melody: scale steps on eighth/quarter notes, two octaves up.
        tm = 0.0
        degree = int(rng.integers(0, 7))
        while tm < seconds - 0.5:
            dur = beat * rng.choice((0.5, 0.5, 1.0, 1.0, 2.0))
            degree = int(np.clip(degree + rng.integers(-2, 3), 0, 6))
            octave = 2 + int(rng.integers(0, 2))
            f = key_hz * (2.0 ** octave) * 2.0 ** (_SCALE[degree] / 12.0)
            i0 = int(tm * sample_rate)
            i1 = min(int((tm + dur * rng.uniform(0.8, 1.0)) * sample_rate), n)
            tt = np.arange(i1 - i0) / sample_rate
            wav[i0:i1] += 0.25 * _render_note(tt, f, melody_timbre, rng)
            tm += dur

        # Percussion: short filtered-noise hits on the beat grid.
        tp = 0.0
        while tp < seconds - 0.2:
            if rng.uniform() < 0.7:
                i0 = int(tp * sample_rate)
                hit_len = int(rng.uniform(0.01, 0.06) * sample_rate)
                i1 = min(i0 + hit_len, n)
                noise = rng.normal(0, 1, i1 - i0)
                noise = np.diff(noise, prepend=0.0)  # high-pass-ish
                envp = np.exp(-np.arange(i1 - i0) / (0.25 * hit_len + 1))
                wav[i0:i1] += 0.08 * noise * envp
            tp += beat / 2
        peak = np.abs(wav).max()
        if peak > 0:
            wav = 0.6 * wav / peak
        p = root / f"rich_{c:04d}.wav"
        write_wav(p, sample_rate, wav)
        paths.append(p)
    return paths
