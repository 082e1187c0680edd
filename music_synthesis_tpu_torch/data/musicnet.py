"""MusicNet-layout corpus loader (counterpart of ``data/musicnet.py``).

MusicNet (Thickstun et al.) ships as::

    root/
      train_data/   1727.wav ...     (44.1 kHz PCM)
      train_labels/ 1727.csv ...     (note annotations:
          start_time,end_time,instrument,note,start_beat,end_beat,note_value
          — times in SAMPLES at the 44.1 kHz rate)
      test_data/ test_labels/        (same layout)

Audio goes through the port's ``AudioDataset`` (resampling and the
step-seeded segment sampler), so the training CLIs take a MusicNet root
through ``--corpus ROOT/train_data`` unchanged; this module adds the label
side: per-clip note annotations and per-segment note queries. No dataset is
fetched: the tests build a miniature fixture with the exact layout.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from pathlib import Path

import numpy as np

from music_synthesis_tpu_torch.data.dataset import AudioDataset

__all__ = ["MusicNetNote", "MusicNetDataset", "MUSICNET_SR"]

MUSICNET_SR = 44_100  # label timestamps are samples at this rate


@dataclasses.dataclass(frozen=True)
class MusicNetNote:
    start_time: int      # samples @ 44.1 kHz
    end_time: int
    instrument: int      # MIDI program number
    note: int            # MIDI note number
    start_beat: float
    end_beat: float
    note_value: str


class MusicNetDataset:
    """Audio (via AudioDataset) + note labels for a MusicNet-layout root."""

    def __init__(
        self,
        root: str | os.PathLike,
        split: str = "train",
        sample_rate: int = 22_050,
        segment_length: int = 8192,
        **audio_kwargs,
    ):
        root = Path(root)
        data_dir = root / f"{split}_data"
        if not data_dir.is_dir():
            raise FileNotFoundError(
                f"{data_dir} missing — expected MusicNet layout "
                "(train_data/, train_labels/, ...)")
        self.sample_rate = sample_rate
        self.audio = AudioDataset(
            data_dir, sample_rate=sample_rate,
            segment_length=segment_length, **audio_kwargs)
        self._labels_dir = root / f"{split}_labels"
        self._labels: dict[str, list[MusicNetNote]] = {}

    @property
    def ids(self) -> list[str]:
        return [p.stem for p in self.audio.paths]

    def labels_for(self, clip_id: str) -> list[MusicNetNote]:
        """Parsed, cached note list for one recording (empty if the split
        ships without labels)."""
        if clip_id in self._labels:
            return self._labels[clip_id]
        f = self._labels_dir / f"{clip_id}.csv"
        notes: list[MusicNetNote] = []
        if f.exists():
            with open(f, newline="") as fh:
                for row in csv.DictReader(fh):
                    notes.append(MusicNetNote(
                        start_time=int(row["start_time"]),
                        end_time=int(row["end_time"]),
                        instrument=int(row["instrument"]),
                        note=int(row["note"]),
                        start_beat=float(row["start_beat"]),
                        end_beat=float(row["end_beat"]),
                        note_value=row["note_value"],
                    ))
            notes.sort(key=lambda n: n.start_time)
        self._labels[clip_id] = notes
        return notes

    def notes_in_segment(
        self, clip_id: str, start: int, length: int
    ) -> list[MusicNetNote]:
        """Notes sounding anywhere inside ``[start, start+length)``, given
        in THIS dataset's sample rate (converted to label timestamps)."""
        scale = MUSICNET_SR / self.sample_rate
        lo = int(start * scale)
        hi = int((start + length) * scale)
        return [n for n in self.labels_for(clip_id)
                if n.start_time < hi and n.end_time > lo]

    def instrument_histogram(self) -> dict[int, int]:
        """Corpus-level note counts per MIDI instrument (diagnostics)."""
        hist: dict[int, int] = {}
        for cid in self.ids:
            for n in self.labels_for(cid):
                hist[n.instrument] = hist.get(n.instrument, 0) + 1
        return hist

    def sample_batch(self, step: int, batch_size: int,
                     seed: int = 0) -> np.ndarray:
        """Step-seeded deterministic segment batch ``[B, segment_length]``."""
        return self.audio.sample_batch(step, batch_size, seed)
