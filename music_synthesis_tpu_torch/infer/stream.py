"""Streaming long-form synthesis (counterpart of ``infer/stream.py``).

``generate_long`` synthesizes N latent patches in one call: its cost grows
with N and no audio exists until the call ends. ``StreamingSynth`` runs two
fixed-shape calls instead, the composer on one patch and the vocoder on one
chunk, and every ``feed(z)`` returns the audio that became final.

The emitted stream is ``generate_long``'s audio for the same latents (to
float tolerance): both overlap-adds, the mel crossfade between patches and
the waveform taper between chunks, use the same windows and normalizers
(``ops/overlap_add.py``), kept incrementally as (accumulator, window sum)
pairs in numpy on the host:

- a mel frame is final once the next patch cannot reach it (patch i
  finalizes frames ``< (i+1) * (t - cf)``);
- a vocoder chunk runs once its ``chunk_frames`` are final;
- a sample is final once the next chunk cannot reach it.

The host holds only the unfinalized tails, whatever the stream's length.
"""

from __future__ import annotations

import numpy as np
import torch

from music_synthesis_tpu_torch._graphs import Programs
from music_synthesis_tpu_torch.config import PipelineConfig
from music_synthesis_tpu_torch.models.specgan import SpectrogramGenerator
from music_synthesis_tpu_torch.models.vocoder import Vocoder
from music_synthesis_tpu_torch.ops.overlap_add import ola_window

__all__ = ["StreamingSynth", "make_stream_fns"]


def make_stream_fns(cfg: PipelineConfig,
                    programs: Programs | None = None) -> tuple:
    """The two fixed-shape calls every stream makes:
    ``patch_fn(composer, z[B, Z]) -> mel`` and
    ``chunk_fn(vocoder, mel[B, chunk, M]) -> wav``, each the module's
    forward under ``torch.inference_mode`` on the module's device, taking
    and returning numpy. On a card each replays the CUDA graph of its
    (module, input shape) (the reference jits both), held in ``programs``
    if given (a ``_graphs.Programs`` on the modules' device), else in one
    of these functions' own per device; only the device forward is
    captured, the host copies go around it. ``cfg`` is the reference's
    signature: the modules carry their configs here."""
    del cfg
    own: dict[torch.device, Programs] = {}

    def forward(module: torch.nn.Module, x) -> np.ndarray:
        dev = next(module.parameters()).device
        progs = programs if programs is not None else own.setdefault(
            dev, Programs(dev))
        with torch.inference_mode():
            out = progs((module,), module,
                        torch.as_tensor(np.asarray(x, np.float32)).to(dev))
            return out.float().cpu().numpy()

    return forward, forward


class StreamingSynth:
    """Feed latents ``[B, Z]`` one patch at a time; receive final audio.

        s = StreamingSynth(cfg, composer, vocoder, crossfade_frames=8)
        for z in latent_patches:          # [B, latent_dim] each
            emit = s.feed(z)              # [B, n_new_samples] (may be 0)
        emit = s.finish()                 # the remaining tail
    """

    def __init__(self, cfg: PipelineConfig, composer: SpectrogramGenerator,
                 vocoder: Vocoder, crossfade_frames: int = 8,
                 fns: tuple | None = None):
        if crossfade_frames >= cfg.specgan.n_frames:
            raise ValueError("crossfade_frames must be < specgan.n_frames")
        self.cfg = cfg
        self.cf = crossfade_frames
        self.t = cfg.specgan.n_frames
        self.hop_t = self.t - self.cf
        ic = cfg.infer
        self.chunk_f, self.hop_f = ic.chunk_frames, ic.hop_frames
        self.ha = cfg.vocoder.hop_length
        self._composer = composer
        self._vocoder = vocoder
        self._patch_fn, self._chunk_fn = fns or make_stream_fns(cfg)

        # Host-side windows (generate_long's).
        self._w_mel = ola_window(self.t, self.hop_t).numpy()[:, None]  # [t, 1]
        self._w_wav = ola_window(self.chunk_f * self.ha,
                                 self.hop_f * self.ha).numpy()
        self._reset()

    def _reset(self) -> None:
        self._n_patches = 0
        # Mel OLA state: acc/wsum cover frames [mel_base, mel_base + len).
        self._mel_base = 0
        self._mel_acc: np.ndarray | None = None   # [B, L, M]
        self._mel_wsum: np.ndarray | None = None  # [L, 1]
        # Final (normalized) mel frames not yet consumed by every chunk
        # that needs them, from absolute frame _final_base.
        self._final_base = 0
        self._final_mel: np.ndarray | None = None
        self._next_chunk = 0
        # Waveform OLA state: acc/wsum cover samples [wav_base, ...).
        self._wav_base = 0
        self._wav_acc: np.ndarray | None = None
        self._wav_wsum: np.ndarray | None = None
        self._finished = False

    # -- internals -----------------------------------------------------------

    def _mel_append(self, mel: np.ndarray) -> None:
        """OLA the windowed patch into the (acc, wsum) pair."""
        b, t, m = mel.shape
        start = self._n_patches * self.hop_t
        end = start + t
        if self._mel_acc is None:
            self._mel_acc = np.zeros((b, 0, m), np.float32)
            self._mel_wsum = np.zeros((0, 1), np.float32)
        have = self._mel_base + self._mel_acc.shape[1]
        if end > have:
            grow = end - have
            self._mel_acc = np.concatenate(
                [self._mel_acc, np.zeros((b, grow, m), np.float32)], axis=1)
            self._mel_wsum = np.concatenate(
                [self._mel_wsum, np.zeros((grow, 1), np.float32)], axis=0)
        lo = start - self._mel_base
        self._mel_acc[:, lo:lo + t] += mel * self._w_mel
        self._mel_wsum[lo:lo + t] += self._w_mel
        self._n_patches += 1

    def _finalize_mel(self, upto: int) -> None:
        """Normalize frames ``[mel_base, upto)`` into the final queue."""
        cut = upto - self._mel_base
        if cut <= 0:
            return
        final = self._mel_acc[:, :cut] / np.maximum(self._mel_wsum[:cut], 1e-8)
        self._mel_acc = self._mel_acc[:, cut:]
        self._mel_wsum = self._mel_wsum[cut:]
        self._mel_base = upto
        if self._final_mel is None:
            self._final_base = upto - final.shape[1]
            self._final_mel = final
        else:
            self._final_mel = np.concatenate([self._final_mel, final], axis=1)

    def _vocode_ready(self, total_final: int) -> None:
        """Run every chunk whose frames are final; OLA into the wav pair."""
        while self._next_chunk * self.hop_f + self.chunk_f <= total_final:
            c = self._next_chunk
            lo = c * self.hop_f - self._final_base
            mel = self._final_mel[:, lo:lo + self.chunk_f]
            wav = self._chunk_fn(self._vocoder, mel) * self._w_wav
            b, wl = wav.shape
            start = c * self.hop_f * self.ha
            if self._wav_acc is None:
                self._wav_acc = np.zeros((b, 0), np.float32)
                self._wav_wsum = np.zeros((0,), np.float32)
            have = self._wav_base + self._wav_acc.shape[1]
            if start + wl > have:
                grow = start + wl - have
                self._wav_acc = np.concatenate(
                    [self._wav_acc, np.zeros((b, grow), np.float32)], axis=1)
                self._wav_wsum = np.concatenate(
                    [self._wav_wsum, np.zeros((grow,), np.float32)])
            w_lo = start - self._wav_base
            self._wav_acc[:, w_lo:w_lo + wl] += wav
            self._wav_wsum[w_lo:w_lo + wl] += self._w_wav
            self._next_chunk += 1
            # Frames below the next chunk's start are consumed for good.
            drop = self._next_chunk * self.hop_f - self._final_base
            if drop > 0:
                self._final_mel = self._final_mel[:, drop:]
                self._final_base += drop

    def _emit_wav(self, upto_samples: int) -> np.ndarray:
        cut = upto_samples - self._wav_base
        if self._wav_acc is None or cut <= 0:
            b = 1 if self._mel_acc is None else self._mel_acc.shape[0]
            return np.zeros((b, 0), np.float32)
        out = self._wav_acc[:, :cut] / np.maximum(self._wav_wsum[:cut], 1e-8)
        self._wav_acc = self._wav_acc[:, cut:]
        self._wav_wsum = self._wav_wsum[cut:]
        self._wav_base = upto_samples
        return out.astype(np.float32)

    # -- public API ----------------------------------------------------------

    def feed(self, z) -> np.ndarray:
        """One latent patch ``[B, Z]`` in; newly final audio ``[B, S]`` out."""
        assert not self._finished, "stream already finished"
        self._mel_append(self._patch_fn(self._composer, z))
        # Patch i finalizes mel frames < (i+1) * hop_t.
        self._finalize_mel(self._n_patches * self.hop_t)
        self._vocode_ready(self._final_base + (
            0 if self._final_mel is None else self._final_mel.shape[1]))
        # A sample is final once no later chunk can reach it.
        return self._emit_wav(self._next_chunk * self.hop_f * self.ha)

    def finish(self) -> np.ndarray:
        """Flush: the crossfade tail, trimmed as ``generate_long`` trims it
        (usable frames only), then the last chunks."""
        assert not self._finished, "stream already finished"
        self._finished = True
        t_long = self._n_patches * self.hop_t + self.cf
        usable = t_long - (t_long - self.chunk_f) % self.hop_f
        self._finalize_mel(min(usable, t_long))
        self._vocode_ready(usable)
        n_chunks = self._next_chunk
        total = ((n_chunks - 1) * self.hop_f * self.ha
                 + self.chunk_f * self.ha) if n_chunks else 0
        return self._emit_wav(total)
