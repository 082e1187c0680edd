"""Configuration dataclasses of the port.

A copy of the serving and vocoding subset of ``music_synthesis_tpu.config``
(the port imports nothing from the JAX package). Field names, order and
defaults are identical, so zoo cards and presets load unchanged. The
training-side sections (``MSDConfig``, ``MRDConfig``, ``TrainConfig``) come
with the training slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Audio feature front-end: framing -> STFT -> mel -> log."""

    sample_rate: int = 22_050
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    n_mels: int = 128
    fmin: float = 0.0
    fmax: float | None = None  # None -> sr / 2
    power: float = 2.0  # 2.0 = power spectrogram, 1.0 = magnitude
    log_epsilon: float = 1e-5
    center: bool = False
    pad_mode: str = "reflect"

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def fmax_resolved(self) -> float:
        return self.fmax if self.fmax is not None else self.sample_rate / 2.0


@dataclasses.dataclass(frozen=True)
class MelScaler:
    """normalize(x) = (x - shift) / scale; denormalize is the inverse."""

    shift: float = -5.0
    scale: float = 7.0


@dataclasses.dataclass(frozen=True)
class SpecGANConfig:
    """Stage-1 spectrogram generator (the "composer") and its critic."""

    latent_dim: int = 128
    n_mels: int = 128
    n_frames: int = 128
    base_channels: int = 512
    upsample_factors: Tuple[int, ...] = (4, 2, 2)
    initial_frames: int = 8
    res_dilations: Tuple[int, ...] = (1, 3)
    disc_channels: Tuple[int, ...] = (128, 256, 512, 512)
    disc_kernel: int = 5
    disc_strides: Tuple[int, ...] = (2, 2, 2, 2)
    leaky_slope: float = 0.2
    use_weight_norm: bool = True
    compute_dtype: str = "float32"
    out_init_gain: float = 1.0
    out_temperature: float = 1.0
    init_scheme: str = "dcgan"
    res_init_gain: float = 1.0


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """Stage-2 conditioned vocoder; total upsampling equals the hop."""

    n_mels: int = 128
    base_channels: int = 512
    upsample_factors: Tuple[int, ...] = (8, 8, 2, 2)
    res_dilations: Tuple[int, ...] = (1, 3, 9)
    input_kernel: int = 7
    output_kernel: int = 7
    res_kernel: int = 3
    leaky_slope: float = 0.2
    use_weight_norm: bool = True
    compute_dtype: str = "float32"
    init_scheme: str = "dcgan"
    out_init_gain: float = 1.0
    res_init_gain: float = 1.0
    upsample_mode: str = "transpose"  # "transpose" | "repeat"
    head: str = "waveform"  # "waveform" | "istft"
    istft_n_fft: int = 16
    istft_hop: int = 4

    @property
    def hop_length(self) -> int:
        out = 1
        for u in self.upsample_factors:
            out *= u
        if self.head == "istft":
            out *= self.istft_hop
        return out


@dataclasses.dataclass(frozen=True)
class STFTLossConfig:
    """Multi-resolution STFT distance, also the copy-synthesis metric."""

    resolutions: Tuple[Tuple[int, int, int], ...] = (
        (512, 128, 512),
        (1024, 256, 1024),
        (2048, 512, 2048),
    )
    eps: float = 1e-7


@dataclasses.dataclass(frozen=True)
class InferConfig:
    """Chunked inference: mel frames per vocoder chunk and chunk advance."""

    chunk_frames: int = 64
    hop_frames: int = 32


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The sections the serving and copy-synthesis paths read."""

    frontend: FrontendConfig = FrontendConfig()
    mel_scaler: MelScaler = MelScaler()
    specgan: SpecGANConfig = SpecGANConfig()
    vocoder: VocoderConfig = VocoderConfig()
    stft_loss: STFTLossConfig = STFTLossConfig()
    infer: InferConfig = InferConfig()


#: Two-stage end-to-end inference with overlap-add (reference-shaped vocoder).
E2E_INFERENCE = PipelineConfig()

#: Flagship fast-serving variant: iSTFT-head vocoder.
E2E_INFERENCE_FAST = PipelineConfig(
    vocoder=VocoderConfig(
        upsample_factors=(8, 8),
        head="istft",
        istft_n_fft=16,
        istft_hop=4,
    )
)

#: Tiny preset for unit tests (fast on one CPU core).
TINY = PipelineConfig(
    frontend=FrontendConfig(n_mels=32),
    specgan=SpecGANConfig(
        latent_dim=16,
        n_mels=32,
        n_frames=32,
        base_channels=32,
        upsample_factors=(2, 2),
        initial_frames=8,
        res_dilations=(1,),
        disc_channels=(16, 16),
        disc_strides=(2, 2),
    ),
    vocoder=VocoderConfig(
        n_mels=32,
        base_channels=32,
        upsample_factors=(8, 8, 2, 2),
        res_dilations=(1, 3),
    ),
    stft_loss=STFTLossConfig(resolutions=((256, 64, 256), (512, 128, 512))),
    infer=InferConfig(chunk_frames=16, hop_frames=8),
)


def config_from_dict(cls, d: dict):
    """Build ``cls`` from a JSON dict (lists become tuples).

    Rejects unknown fields: a card written by a newer version must not be
    silently truncated.
    """
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(
            f"config dict has fields {sorted(unknown)} not in {cls.__name__}")

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    return cls(**{k: tup(v) for k, v in d.items()})
