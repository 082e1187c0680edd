"""Configuration dataclasses of the port.

A copy of ``music_synthesis_tpu.config`` (the port imports nothing from the
JAX package). Field names, order and defaults are identical, so zoo cards,
run ``config.json`` files and presets load unchanged.
``MSDConfig.dense_groups_max_g`` lowers the MSD's grouped convolutions to
dense block-diagonal ones, as in the JAX package. Fields that only choose
a TPU relayout of the same math (``MRDConfig.f_fold``,
``TrainConfig.concat_disc_batch``, ``use_pallas_frontend``'s interpret
mode, ``mesh_*``) are kept so that those files load; the port computes
the logical layer whatever they say.
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
class MSDConfig:
    """Multi-scale raw-audio discriminators: K scales of strided convs."""

    n_scales: int = 3
    downsample_factor: int = 2  # avg-pool stride between scales
    channels: Tuple[int, ...] = (16, 64, 256, 1024, 1024)
    kernel: int = 41
    strides: Tuple[int, ...] = (4, 4, 4, 4)
    groups: Tuple[int, ...] = (4, 16, 64, 256)
    input_kernel: int = 15
    post_kernel: int = 5
    output_kernel: int = 3
    leaky_slope: float = 0.2
    use_weight_norm: bool = True
    compute_dtype: str = "float32"
    # Grouped convs with 1 < groups <= this run as one dense conv over a
    # block-diagonal kernel (same parameters and math; ops/conv.py).
    dense_groups_max_g: int = 0


@dataclasses.dataclass(frozen=True)
class MRDConfig:
    """Multi-resolution STFT discriminators: 2-D convs on the STFT."""

    resolutions: Tuple[Tuple[int, int, int], ...] = (
        (512, 128, 512),
        (1024, 256, 1024),
        (2048, 512, 2048),
    )  # (n_fft, hop, win_length)
    channels: int = 32
    leaky_slope: float = 0.2
    use_weight_norm: bool = True
    compute_dtype: str = "float32"
    f_fold: int = 0  # TPU relayout only; the logical conv here
    input_mode: str = "logmag"  # "logmag" | "complex"
    complex_compression: float = 0.3


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
class TrainConfig:
    """GAN training orchestration (``train/stage2.py`` reads these)."""

    batch_size: int = 16
    segment_length: int = 8192
    augment: bool = False
    g_lr: float = 1e-4
    d_lr: float = 1e-4
    adam_b1: float = 0.5
    adam_b2: float = 0.9
    # lr(t) = lr * lr_decay_rate ** (t / lr_decay_every), continuous.
    lr_decay_rate: float = 1.0
    lr_decay_every: int = 1000
    grad_clip_norm: float = 0.0  # global-norm clip, 0 = off
    remat_generator: bool = False  # recompute G's forward in its backward
    ema_decay: float = 0.0  # EMA of G's parameters, 0 = off
    # FM target from the D step's real taps (only when d_input_noise == 0).
    reuse_real_features: bool = False
    concat_disc_batch: bool = False  # TPU batching of D; same math here
    gan_loss: str = "hinge"  # "hinge" | "nonsat"
    # Instance noise on D's inputs, sigma(step) = d_input_noise *
    # max(0, 1 - step / d_noise_decay_steps) (constant when 0).
    d_input_noise: float = 0.0
    d_noise_decay_steps: int = 0
    r1_gamma: float = 0.0  # R1 penalty r1_gamma/2 * E||grad_x D(x)||^2
    lambda_feature_matching: float = 10.0
    lambda_stft: float = 2.5
    lambda_energy: float = 0.0  # frame-energy L1 (stage 2)
    lambda_flux: float = 0.0  # temporal-flux matching (stage 1)
    lambda_phase: float = 0.0  # anti-wrapping phase loss (stage 2)
    phase_n_fft: int = 1024
    phase_hop: int = 256
    # D frozen (update and Adam state) and G's adversarial terms off while
    # step < g_warmup_steps.
    g_warmup_steps: int = 0
    seed: int = 0
    checkpoint_every: int = 1000
    log_every: int = 50
    # Conditioning through the fused log-mel kernel (ops/logmel.py).
    use_pallas_frontend: bool = False
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)


@dataclasses.dataclass(frozen=True)
class InferConfig:
    """Chunked inference: mel frames per vocoder chunk and chunk advance."""

    chunk_frames: int = 64
    hop_frames: int = 32


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Everything bundled: one object describes a full experiment."""

    frontend: FrontendConfig = FrontendConfig()
    mel_scaler: MelScaler = MelScaler()
    specgan: SpecGANConfig = SpecGANConfig()
    vocoder: VocoderConfig = VocoderConfig()
    msd: MSDConfig = MSDConfig()
    mrd: MRDConfig = MRDConfig()
    stft_loss: STFTLossConfig = STFTLossConfig()
    train: TrainConfig = TrainConfig()
    infer: InferConfig = InferConfig()


#: Log-mel extraction of one 22.05 kHz clip.
FRONTEND_CPU_CLIP = PipelineConfig()

#: Stage-1 spectrogram generator forward and loss, one batch.
STAGE1_SINGLE_BATCH = PipelineConfig(train=TrainConfig(batch_size=16))

#: Stage-2 vocoder GAN training on one device.
STAGE2_VOCODER_TRAIN = PipelineConfig(train=TrainConfig(batch_size=16))

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

#: Data-parallel two-stage training over eight devices.
DP_V5E8_TRAIN = PipelineConfig(
    train=TrainConfig(batch_size=64, mesh_shape=(8,), mesh_axes=("data",))
)

# Section name -> its dataclass (each section's default is an instance).
_SECTIONS = {f.name: type(f.default)
             for f in dataclasses.fields(PipelineConfig)}


def config_to_dict(cfg: PipelineConfig) -> dict:
    """PipelineConfig -> JSON-safe nested dict (tuples become lists)."""

    def conv(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: conv(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)}
        if isinstance(obj, (tuple, list)):
            return [conv(x) for x in obj]
        return obj

    return conv(cfg)


def section_from_dict(cls, d: dict):
    """Build one section ``cls`` from a JSON dict (lists become tuples).

    Rejects unknown fields: a file written by a newer version must not be
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


def config_from_dict(d: dict) -> PipelineConfig:
    """Inverse of :func:`config_to_dict`; missing sections take defaults,
    unknown sections or fields raise."""
    extra = set(d) - set(_SECTIONS)
    if extra:
        raise ValueError(f"unknown PipelineConfig sections: {sorted(extra)}")
    return PipelineConfig(**{name: section_from_dict(_SECTIONS[name], sub)
                             for name, sub in d.items()})


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
    msd=MSDConfig(
        n_scales=2,
        channels=(4, 8, 8),
        kernel=11,
        strides=(4, 4),
        groups=(2, 2),
        input_kernel=7,
        post_kernel=5,
        output_kernel=3,
    ),
    mrd=MRDConfig(resolutions=((256, 64, 256),), channels=4),
    stft_loss=STFTLossConfig(resolutions=((256, 64, 256), (512, 128, 512))),
    train=TrainConfig(batch_size=2, segment_length=2048),
    infer=InferConfig(chunk_frames=16, hop_frames=8),
)

