"""Two-stage inference (counterpart of ``infer/generate.py``).

``z -> composer mel -> overlapping chunks -> vocoder -> windowed overlap-add
-> waveform``. Chunks fold into the batch axis, so the vocoder sees one
batch. The composer and vocoder are ``nn.Module``s built from the configs in
``cfg`` (``models/specgan.py``, ``models/vocoder.py``).

The functions run eagerly. ``GraphedPipeline`` is the counterpart of the
reference's ``generate_jit`` (and of the ``jax.jit`` of each variant in its
scripts): on a card, one CUDA graph per (function, static arguments, z's
shape).
"""

from __future__ import annotations

import torch

from music_synthesis_tpu_torch._graphs import Programs
from music_synthesis_tpu_torch.config import PipelineConfig
from music_synthesis_tpu_torch.models.specgan import SpectrogramGenerator
from music_synthesis_tpu_torch.models.vocoder import Vocoder
from music_synthesis_tpu_torch.ops.griffin_lim import refine_with_log_mel
from music_synthesis_tpu_torch.ops.overlap_add import (
    ola_normalizer,
    ola_window,
    overlap_add,
)
from music_synthesis_tpu_torch.utils.profiling import region

__all__ = [
    "GraphedPipeline",
    "chunk_frames",
    "vocode_chunked",
    "generate",
    "generate_direct",
    "generate_long",
    "generate_long_refined",
    "generate_refined",
    "stitch_long_mel",
]


def chunk_frames(mel: torch.Tensor, chunk: int, hop: int) -> torch.Tensor:
    """``[B, T, M] -> [B, N, chunk, M]`` overlapping frame chunks,
    N = 1 + (T - chunk) // hop; (T - chunk) must be a multiple of hop."""
    t = mel.shape[-2]
    if (t - chunk) % hop:
        raise ValueError(
            f"n_frames={t} incompatible with chunk={chunk}, hop={hop}")
    return mel.unfold(-2, chunk, hop).transpose(-1, -2)


def vocode_chunked(vocoder: Vocoder, mel: torch.Tensor,
                   cfg: PipelineConfig) -> torch.Tensor:
    """Chunked vocoding + windowed OLA: ``[B, T, M] -> [B, T * hop_audio]``."""
    ic = cfg.infer
    hop_audio = cfg.vocoder.hop_length
    chunks = chunk_frames(mel, ic.chunk_frames, ic.hop_frames)
    b, n, c, m = chunks.shape
    wav_chunks = vocoder(chunks.reshape(b * n, c, m)).reshape(b, n, c * hop_audio)
    step = ic.hop_frames * hop_audio
    window = ola_window(c * hop_audio, step, device=mel.device)
    out = overlap_add(wav_chunks * window, step)
    return out / ola_normalizer(window, n, step)


def generate(cfg: PipelineConfig, composer: SpectrogramGenerator,
             vocoder: Vocoder, z: torch.Tensor) -> torch.Tensor:
    """Latent ``[B, Z]`` -> waveform ``[B, L]`` through the chunked vocoder."""
    return vocode_chunked(vocoder, composer(z), cfg)


def generate_refined(cfg: PipelineConfig, composer: SpectrogramGenerator,
                     vocoder: Vocoder, z: torch.Tensor,
                     n_iter: int = 8) -> torch.Tensor:
    """``generate`` + warm-started Griffin-Lim refinement: the vocoded
    waveform's phase seeds ``n_iter`` STFT-consistency projections against
    the composer mel's own pseudo-inverse magnitude
    (``ops/griffin_lim.py::refine_with_log_mel``)."""
    mel = composer(z)
    wav = vocode_chunked(vocoder, mel, cfg)
    return _refine(cfg, wav, mel, n_iter)


def _refine(cfg: PipelineConfig, wav: torch.Tensor, mel: torch.Tensor,
            n_iter: int) -> torch.Tensor:
    # The composer's mel is in the GAN's normalized space; the
    # pseudo-inverse needs the raw log-mel (config.py MelScaler).
    logmel = mel.float() * cfg.mel_scaler.scale + cfg.mel_scaler.shift
    return refine_with_log_mel(wav.float(), logmel, cfg.frontend, n_iter=n_iter)


def generate_direct(cfg: PipelineConfig, composer: SpectrogramGenerator,
                    vocoder: Vocoder, z: torch.Tensor) -> torch.Tensor:
    """Unchunked variant: the whole mel vocoded at once."""
    return vocoder(composer(z))


def generate_long(cfg: PipelineConfig, composer: SpectrogramGenerator,
                  vocoder: Vocoder, z: torch.Tensor,
                  crossfade_frames: int = 8) -> torch.Tensor:
    """``z[B, N, Z] -> wav[B, L]``: N composer patches crossfaded into one
    long mel, then the chunked vocoder (the regions ``stitch_long_mel`` and
    ``vocode_chunked``, ``utils.profiling.region``)."""
    with region("stitch_long_mel"):
        mel_long = stitch_long_mel(cfg, composer, z, crossfade_frames)
    with region("vocode_chunked"):
        return vocode_chunked(vocoder, mel_long, cfg)


def stitch_long_mel(cfg: PipelineConfig, composer: SpectrogramGenerator,
                    z: torch.Tensor, crossfade_frames: int) -> torch.Tensor:
    """``z[B, N, Z] -> mel[B, T_long, M]``: patches overlap-added over the
    frame axis with hop ``n_frames - crossfade_frames``, trimmed so that
    ``(T_long - chunk_frames) % hop_frames == 0``."""
    b, n, zdim = z.shape
    t = cfg.specgan.n_frames
    hop_t = t - crossfade_frames
    mel = composer(z.reshape(b * n, zdim)).reshape(b, n, t, cfg.specgan.n_mels)
    if crossfade_frames > 0:
        window = ola_window(t, hop_t, device=z.device)
        stacked = (mel * window[:, None]).permute(0, 3, 1, 2)  # [B, M, N, T]
        stitched = overlap_add(stacked, hop_t)  # [B, M, T_long]
        norm = ola_normalizer(window, n, hop_t)
        mel_long = (stitched / norm).transpose(1, 2)
    else:
        mel_long = mel.reshape(b, n * t, cfg.specgan.n_mels)
    ic = cfg.infer
    t_long = mel_long.shape[1]
    usable = t_long - (t_long - ic.chunk_frames) % ic.hop_frames
    return mel_long[:, :usable]


def generate_long_refined(cfg: PipelineConfig, composer: SpectrogramGenerator,
                          vocoder: Vocoder, z: torch.Tensor,
                          crossfade_frames: int = 8,
                          n_iter: int = 8) -> torch.Tensor:
    """``generate_long`` + warm-started Griffin-Lim refinement (see
    ``generate_refined``)."""
    mel_long = stitch_long_mel(cfg, composer, z, crossfade_frames)
    wav = vocode_chunked(vocoder, mel_long, cfg)
    return _refine(cfg, wav, mel_long, n_iter)


class GraphedPipeline:
    """A composer and a vocoder with their graphed programs.

    ``pipe(fn, z, *static)`` returns ``fn(cfg, composer, vocoder, z,
    *static)`` for ``fn`` one of this module's functions (``static``: its
    ints, e.g. ``crossfade_frames``, ``n_iter``), under
    ``torch.inference_mode``: eagerly on the CPU; on a card by replaying the
    CUDA graph of (fn, static, z's shape), captured at its first call
    (``_graphs.Programs``, in ``programs`` if given, shared with other
    users of that pool) and timed by the tracer under ``fn``'s name. The result is then the graph's output buffer: use
    it or copy it before the next call of any program of the pool.
    """

    def __init__(self, cfg: PipelineConfig, composer: SpectrogramGenerator,
                 vocoder: Vocoder, programs: Programs | None = None):
        self.cfg, self.composer, self.vocoder = cfg, composer, vocoder
        self.programs = (Programs(next(vocoder.parameters()).device)
                         if programs is None else programs)

    def __call__(self, fn, z: torch.Tensor, *static) -> torch.Tensor:
        def body(latents):
            return fn(self.cfg, self.composer, self.vocoder, latents, *static)

        with torch.inference_mode():
            return self.programs(
                (self.cfg, self.composer, self.vocoder, fn, static), body, z,
                label=fn.__name__)
