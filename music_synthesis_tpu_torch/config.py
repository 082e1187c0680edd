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

The port has fields and sections the JAX package's config has not
(``PORT_ONLY``, ``PORT_ONLY_SECTIONS``): BigVGAN's generator, and DAC's
codec (the ``codec`` section, chosen by ``VocoderConfig.block="codec"``),
its multi-period D (``mpd``), its banded MRD and its objective (LSGAN,
summed feature matching, the multi-scale mel loss, the VQ losses, a clip
per player, AdamW's decay), none of which the JAX package builds. A
section is written (``config_to_dict``, zoo cards) without those fields
while they hold their defaults, and the new sections not at all, so every
config the JAX package can express is written as the JAX package writes
it.
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
    # BigVGAN's generator (arXiv:2206.04658) with block "amp": after each
    # upsampling the mean of AMP residual stacks, one per kernel of
    # ``mrf_kernels``, each over ``res_dilations``, every activation the
    # anti-aliased SnakeBeta (ops/alias_free.py), convolutions zero-padded.
    # Block "codec": G is DAC's codec of the ``codec`` section
    # (models/codec.py), which takes the waveform; the other fields here
    # are unused.
    block: str = "residual"  # "residual" | "amp" | "codec"
    mrf_kernels: Tuple[int, ...] = ()

    @property
    def hop_length(self) -> int:
        out = 1
        for u in self.upsample_factors:
            out *= u
        if self.head == "istft":
            out *= self.istft_hop
        return out


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """DAC's generator (Kumar et al., arXiv:2306.06546; descript-audio-codec's
    ``DAC``): a Snake encoder, a residual vector quantizer and a Snake
    decoder. The defaults are the published 44.1 kHz model."""

    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    latent_dim: int = 1024
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    # Share of a batch's rows (the first ones) that keep a uniform draw of
    # 1..n_codebooks stages in training; the others keep them all.
    quantizer_dropout: float = 0.5
    # The convolutions' (encoder, decoder); Snake and the VQ run in fp32.
    compute_dtype: str = "float32"

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.encoder_rates:
            out *= r
        return out


@dataclasses.dataclass(frozen=True)
class MPDConfig:
    """Multi-period discriminator (HiFi-GAN's, as DAC builds it): the
    waveform reflect-padded to a multiple of each period and folded to
    ``[B, 1, L/p, p]``, then weight-normed (5, 1) convs through
    ``channels`` (``models/discriminators.py`` fixes the rest); none while
    ``periods`` is empty."""

    periods: Tuple[int, ...] = ()
    channels: Tuple[int, ...] = (32, 128, 512, 1024, 1024)
    compute_dtype: str = "float32"


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
    # DAC's bands: each (lo, hi) share of the bins its own conv stack, the
    # stacks' outputs joined along frequency before ``conv_out``.
    bands: Tuple[Tuple[float, float], ...] = ()
    # "valid": frames of the unpadded signal; "match_stride": audiotools'
    # (DAC's) framing, L / hop frames.
    stft_padding: str = "valid"


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
    gan_loss: str = "hinge"  # "hinge" | "nonsat" | "lsgan"
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
    # Feature matching over D's taps: their "mean" or, as DAC, their "sum".
    feature_matching: str = "mean"
    # DAC's 7-scale mel L1 (losses/mel_loss.py). Where it is weighted it
    # is G's reported reconstruction term, and the multi-resolution STFT
    # term is computed only at lambda_stft > 0; without it the STFT term
    # is computed and reported at any weight.
    lambda_mel: float = 0.0
    lambda_commitment: float = 0.0  # the codec's VQ losses
    lambda_codebook: float = 0.0
    # Per-player global-norm clips in place of grad_clip_norm (0: that).
    g_grad_clip_norm: float = 0.0
    d_grad_clip_norm: float = 0.0
    weight_decay: float = 0.0  # AdamW's decoupled decay, both players
    # D's inputs centred and scaled to this peak (DAC), 0 = as they are.
    d_input_peak: float = 0.0


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
    codec: CodecConfig = CodecConfig()
    mpd: MPDConfig = MPDConfig()


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

#: BigVGAN's 22 kHz 80-band generator (arXiv:2206.04658; NVIDIA/BigVGAN's
#: ``configs/bigvgan_22khz_80band.json``; its upsampling kernels 8-8-4-4-4-4
#: are the port's twice the factor): 112.2M parameters, trained
#: against this repo's stage-2 D and losses (the port builds it; the JAX
#: package does not).
BIGVGAN_22K_80BAND = PipelineConfig(
    frontend=FrontendConfig(n_mels=80, fmax=8000.0, power=1.0),
    mel_scaler=MelScaler(shift=0.0, scale=1.0),
    vocoder=VocoderConfig(
        n_mels=80, base_channels=1536, upsample_factors=(4, 4, 2, 2, 2, 2),
        res_dilations=(1, 3, 5), mrf_kernels=(3, 7, 11), block="amp"),
    train=TrainConfig(batch_size=32, adam_b1=0.8, adam_b2=0.99),
)

#: DAC's 44.1 kHz codec (arXiv:2306.06546; descript-audio-codec's
#: ``conf/base.yml``): G 76.65M parameters, D the MPD of periods 2-11 and
#: the banded complex MRD, LSGAN, mel L1 x15, feature matching x2 (summed),
#: commitment x0.25, codebook x1, AdamW (0.8, 0.99) at 1e-4 decayed by
#: 0.999996 a step, clips 1e3 (G) and 10 (D), 72 excerpts of 0.38 s.
DAC_44K = PipelineConfig(
    frontend=FrontendConfig(sample_rate=44_100),
    vocoder=VocoderConfig(block="codec"),
    codec=CodecConfig(compute_dtype="bfloat16"),
    msd=MSDConfig(n_scales=0),
    mpd=MPDConfig(periods=(2, 3, 5, 7, 11), compute_dtype="bfloat16"),
    mrd=MRDConfig(
        resolutions=((2048, 512, 2048), (1024, 256, 1024), (512, 128, 512)),
        leaky_slope=0.1, compute_dtype="bfloat16", input_mode="complex",
        complex_compression=1.0, stft_padding="match_stride",
        bands=((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75),
               (0.75, 1.0))),
    train=TrainConfig(
        batch_size=72, segment_length=16_758, adam_b1=0.8, adam_b2=0.99,
        lr_decay_rate=0.999996, lr_decay_every=1, gan_loss="lsgan",
        lambda_feature_matching=2.0, feature_matching="sum", lambda_stft=0.0,
        lambda_mel=15.0, lambda_commitment=0.25, lambda_codebook=1.0,
        g_grad_clip_norm=1e3, d_grad_clip_norm=10.0, weight_decay=0.01,
        d_input_peak=0.8),
)

#: Data-parallel two-stage training over eight devices.
DP_V5E8_TRAIN = PipelineConfig(
    train=TrainConfig(batch_size=64, mesh_shape=(8,), mesh_axes=("data",))
)

# Section name -> its dataclass (each section's default is an instance).
_SECTIONS = {f.name: type(f.default)
             for f in dataclasses.fields(PipelineConfig)}


#: Fields the port's sections have and the JAX package's do not.
PORT_ONLY = {
    VocoderConfig: ("block", "mrf_kernels"),
    MRDConfig: ("bands", "stft_padding"),
    TrainConfig: ("feature_matching", "lambda_mel", "lambda_commitment",
                  "lambda_codebook", "g_grad_clip_norm", "d_grad_clip_norm",
                  "weight_decay", "d_input_peak"),
}
#: Sections the port has and the JAX package has not: written only where
#: they differ from their defaults.
PORT_ONLY_SECTIONS = ("codec", "mpd")


def _to_json(obj):
    if isinstance(obj, (tuple, list)):
        return [_to_json(x) for x in obj]
    return obj


def section_to_dict(section) -> dict:
    """One section -> JSON-safe dict (tuples become lists), without the
    ``PORT_ONLY`` fields that hold their defaults."""
    own = PORT_ONLY.get(type(section), ())
    return {f.name: _to_json(getattr(section, f.name))
            for f in dataclasses.fields(section)
            if f.name not in own or getattr(section, f.name) != f.default}


def config_to_dict(cfg: PipelineConfig) -> dict:
    """PipelineConfig -> JSON-safe nested dict (``section_to_dict`` per
    section; a ``PORT_ONLY_SECTIONS`` section only where it is not at its
    default)."""
    return {f.name: section_to_dict(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)
            if f.name not in PORT_ONLY_SECTIONS
            or getattr(cfg, f.name) != f.default}


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

#: TINY with a BigVGAN generator of BIGVGAN_22K_80BAND's structure (unit
#: tests).
TINY_BIGVGAN = dataclasses.replace(
    TINY,
    frontend=dataclasses.replace(BIGVGAN_22K_80BAND.frontend, n_mels=32),
    mel_scaler=BIGVGAN_22K_80BAND.mel_scaler,
    vocoder=dataclasses.replace(
        BIGVGAN_22K_80BAND.vocoder, n_mels=32, base_channels=128,
        res_dilations=(1, 3), mrf_kernels=(3, 5)),
)


#: DAC_44K's structure at a size the CPU tests run in seconds.
TINY_DAC = dataclasses.replace(
    DAC_44K,
    codec=CodecConfig(encoder_dim=8, encoder_rates=(2, 4), latent_dim=32,
                      decoder_dim=32, decoder_rates=(4, 2), n_codebooks=3,
                      codebook_size=16, codebook_dim=4),
    mpd=dataclasses.replace(DAC_44K.mpd, periods=(2, 3),
                            channels=(4, 8, 8, 8, 8), compute_dtype="float32"),
    mrd=dataclasses.replace(DAC_44K.mrd,
                            resolutions=((128, 32, 128), (64, 16, 64)),
                            channels=4, compute_dtype="float32"),
    train=dataclasses.replace(DAC_44K.train, batch_size=2,
                              segment_length=2051),
)
