"""Stage-2 discriminators (counterpart of ``models/discriminators.py``).

- ``MultiScaleDiscriminator`` (MSD): identical raw-audio heads on the
  waveform average-pooled by 1x, 2x, 4x; grouped strided 1-D convs.
- ``MultiResSTFTDiscriminator`` (MRD): 2-D convs over the log-magnitude
  (or power-compressed complex) STFT at several resolutions.
- ``PeriodDiscriminator`` / ``MultiPeriodDiscriminator`` (MPD; DAC's,
  after HiFi-GAN): the waveform reflect-padded by ``p - L % p`` and
  folded to ``[B, 1, L/p, p]``, then (k, 1) convs.
- ``CombinedDiscriminator``: MSD, MPD and MRD, each where its config has
  heads, under one parameter tree, the stage-2 D.

DAC's MRD (``MRDConfig.bands``) gives each band of the STFT's bins its own
conv stack (``band_{j}.conv_{i}``) and joins the stacks' outputs along
frequency before ``conv_out``; with ``stft_padding="match_stride"`` it
frames as audiotools' ``match_stride`` STFT (reflect padding by 3/8 of
the window and up to a whole hop, a centred STFT, two frames dropped at
each end: ``L / hop`` frames), and at ``complex_compression`` 1 its input
is the STFT's real and imaginary parts.

Each head returns ``(logit, features)``, the wrappers lists of them, in the
JAX order (MSD scales, then MRD resolutions). Layouts are PyTorch's: the
MSD's ``[B, C, L]``, the MRD's ``[B, C, T, F]`` (JAX's ``[B, L, C]`` and
``[B, T, F, C]``). Submodule names follow the Flax tree (``msd.scale_0.
conv_in``, ``mrd.res_512.conv_0``, ...), so ``convert.to_state_dict`` of
JAX's parameters loads as it is. ``MSDConfig.dense_groups_max_g`` runs the
MSD's grouped convolutions of ``1 < groups <= dense_groups_max_g`` as
dense ones over block-diagonal kernels, as the JAX package does
(``ops/conv.py``); the JAX package's MRD relayout ``f_fold`` is not
ported (the logical layer here computes what it equals). Both share the
logical layers' parameters.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from music_synthesis_tpu_torch.config import MPDConfig, MRDConfig, MSDConfig
from music_synthesis_tpu_torch.ops.conv import WNConv, avg_pool1d
from music_synthesis_tpu_torch.ops.frontend import magnitude_stft, stft

__all__ = [
    "ScaleDiscriminator",
    "MultiScaleDiscriminator",
    "STFTDiscriminator",
    "MultiResSTFTDiscriminator",
    "PeriodDiscriminator",
    "MultiPeriodDiscriminator",
    "CombinedDiscriminator",
    "band_bins",
    "match_stride_stft",
    "peak_normalize",
]


class ScaleDiscriminator(nn.Module):
    """One raw-audio head: wav ``[B, L]`` -> (logit ``[B, 1, L']``,
    features)."""

    def __init__(self, cfg: MSDConfig = MSDConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.slope = cfg.leaky_slope
        common = dict(use_weight_norm=cfg.use_weight_norm,
                      compute_dtype=cfg.compute_dtype, generator=generator)
        self.conv_in = WNConv(1, cfg.channels[0], cfg.input_kernel,
                              padding="reflect", **common)
        self.n_down = len(cfg.strides)
        for i, (cin, ch, s, grp) in enumerate(zip(
                cfg.channels, cfg.channels[1:], cfg.strides, cfg.groups)):
            g = min(grp, cin)
            self.add_module(f"down_{i}", WNConv(
                cin, ch, cfg.kernel, stride=s, groups=g,
                dense_groups=1 < g <= cfg.dense_groups_max_g, **common))
        self.conv_post = WNConv(cfg.channels[len(cfg.strides)],
                                cfg.channels[-1], cfg.post_kernel, **common)
        self.conv_out = WNConv(cfg.channels[-1], 1, cfg.output_kernel,
                               **common)

    def forward(self, wav: torch.Tensor):
        x = F.leaky_relu(self.conv_in(wav[:, None]), self.slope)
        feats = [x]
        for i in range(self.n_down):
            x = F.leaky_relu(getattr(self, f"down_{i}")(x), self.slope)
            feats.append(x)
        x = F.leaky_relu(self.conv_post(x), self.slope)
        feats.append(x)
        return self.conv_out(x), feats


class MultiScaleDiscriminator(nn.Module):
    """``n_scales`` heads on progressively average-pooled audio."""

    def __init__(self, cfg: MSDConfig = MSDConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        for s in range(cfg.n_scales):
            self.add_module(f"scale_{s}", ScaleDiscriminator(cfg, generator))

    def forward(self, wav: torch.Tensor):
        logits, features = [], []
        x = wav
        for s in range(self.cfg.n_scales):
            logit, feats = getattr(self, f"scale_{s}")(x)
            logits.append(logit)
            features.append(feats)
            if s + 1 < self.cfg.n_scales:
                x = avg_pool1d(x[:, None], window=4,
                               stride=self.cfg.downsample_factor, pad=1)[:, 0]
        return logits, features


# (kernel (t, f), stride (t, f)) of the conv stack; conv_out is (3, 3).
_MRD_LAYERS = (((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)),
               ((3, 9), (1, 2)), ((3, 3), (1, 1)))


def band_bins(n_fft: int, bands) -> list[tuple[int, int]]:
    """The bins ``[lo, hi)`` of each band of shares ``(lo, hi)`` of the
    ``n_fft // 2 + 1`` bins (DAC's ``int(share * bins)``)."""
    n = n_fft // 2 + 1
    return [(int(lo * n), int(hi * n)) for lo, hi in bands]


def match_stride_stft(wav: torch.Tensor, n_fft: int, hop: int,
                      win: int) -> torch.Tensor:
    """audiotools' STFT with ``match_stride`` (DAC's MRD): reflect-pad by
    ``(win - hop) // 2`` and on the right by up to a hop more, frame
    centred (reflect by ``n_fft // 2``), drop two frames at each end:
    ``[B, ceil(L / hop), bins]``."""
    length = wav.shape[-1]
    right = math.ceil(length / hop) * hop - length
    pad = (win - hop) // 2
    x = F.pad(wav[:, None], (pad, pad + right), mode="reflect")
    x = F.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    return stft(x, n_fft, hop, win)[:, 2:-2]


def peak_normalize(wav: torch.Tensor, peak: float) -> torch.Tensor:
    """DAC's D input: each row less its mean, scaled to ``peak``."""
    x = wav - wav.mean(-1, keepdim=True)
    return peak * x / (x.abs().amax(-1, keepdim=True) + 1e-9)


class _ConvStack(nn.Module):
    """``_MRD_LAYERS``' convs ``conv_{i}``, leaky ReLU after each."""

    def __init__(self, cin: int, channels: int, slope: float, common: dict):
        super().__init__()
        self.slope = slope
        for i, (k, st) in enumerate(_MRD_LAYERS):
            self.add_module(f"conv_{i}", WNConv(cin, channels, k, stride=st,
                                                **common))
            cin = channels

    def forward(self, x: torch.Tensor, feats: list) -> torch.Tensor:
        for i in range(len(_MRD_LAYERS)):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), self.slope)
            feats.append(x)
        return x


class STFTDiscriminator(nn.Module):
    """One spectral head: wav ``[B, L]`` -> 2-D convs over the STFT
    ``[B, C, T, F]``: ``log|S|`` (``input_mode="logmag"``, one channel) or
    ``[Re, Im]`` of ``|S|^p e^{i phase}`` (``"complex"``, two channels);
    with ``bands`` one conv stack per band (the module's docstring)."""

    def __init__(self, n_fft: int, hop: int, win: int, channels: int = 32,
                 leaky_slope: float = 0.2, use_weight_norm: bool = True,
                 compute_dtype: str = "float32", input_mode: str = "logmag",
                 compression: float = 0.3,
                 generator: torch.Generator | None = None,
                 bands=(), stft_padding: str = "valid"):
        super().__init__()
        if input_mode not in ("logmag", "complex"):
            raise ValueError(f"unknown input_mode {input_mode!r}")
        if stft_padding not in ("valid", "match_stride"):
            raise ValueError(f"unknown stft_padding {stft_padding!r}")
        self.n_fft, self.hop, self.win = n_fft, hop, win
        self.slope, self.input_mode = leaky_slope, input_mode
        self.compression = compression
        self.stft_padding = stft_padding
        self.bins = band_bins(n_fft, bands)
        common = dict(padding="same", use_weight_norm=use_weight_norm,
                      compute_dtype=compute_dtype, generator=generator)
        cin = 2 if input_mode == "complex" else 1
        if self.bins:
            for j in range(len(self.bins)):
                self.add_module(f"band_{j}", _ConvStack(cin, channels,
                                                        leaky_slope, common))
        else:
            for i, (k, st) in enumerate(_MRD_LAYERS):
                self.add_module(f"conv_{i}", WNConv(cin, channels, k,
                                                    stride=st, **common))
                cin = channels
        self.conv_out = WNConv(channels, 1, (3, 3), **common)

    def _stft(self, wav: torch.Tensor) -> torch.Tensor:
        if self.stft_padding == "match_stride":
            return match_stride_stft(wav, self.n_fft, self.hop, self.win)
        return stft(wav, self.n_fft, self.hop, self.win)

    def forward(self, wav: torch.Tensor):
        if self.input_mode == "complex":
            # S * |S|^(p-1): the smooth floor in |S| bounds the factor (1
            # at DAC's p = 1, which reads S itself).
            s = self._stft(wav)
            mag = torch.sqrt(s.real ** 2 + s.imag ** 2 + 1e-7)
            scale = mag ** (self.compression - 1.0)
            x = torch.stack([s.real * scale, s.imag * scale], dim=1)
        else:
            x = torch.log(magnitude_stft(wav, self.n_fft, self.hop,
                                         self.win))[:, None]
        feats = []
        if self.bins:
            x = torch.cat([getattr(self, f"band_{j}")(x[..., lo:hi], feats)
                           for j, (lo, hi) in enumerate(self.bins)], -1)
            return self.conv_out(x), feats
        for i in range(len(_MRD_LAYERS)):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), self.slope)
            feats.append(x)
        return self.conv_out(x), feats


class MultiResSTFTDiscriminator(nn.Module):
    """One ``STFTDiscriminator`` per resolution, named ``res_{n_fft}``."""

    def __init__(self, cfg: MRDConfig = MRDConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.names = [f"res_{n_fft}" for n_fft, _, _ in cfg.resolutions]
        for name, (n_fft, hop, win) in zip(self.names, cfg.resolutions):
            self.add_module(name, STFTDiscriminator(
                n_fft, hop, win, cfg.channels, cfg.leaky_slope,
                cfg.use_weight_norm, cfg.compute_dtype, cfg.input_mode,
                cfg.complex_compression, generator, cfg.bands,
                cfg.stft_padding))

    def forward(self, wav: torch.Tensor):
        logits, features = [], []
        for name in self.names:
            logit, feats = getattr(self, name)(wav)
            logits.append(logit)
            features.append(feats)
        return logits, features


# The period heads' fixed architecture (HiFi-GAN's, as DAC builds it): one
# weight-normed (5, 1) conv per entry of ``MPDConfig.channels`` at these
# strides along time, a (3, 1) post conv, leaky ReLU 0.1.
MPD_STRIDES = (3, 3, 3, 3, 1)
MPD_KERNEL = 5
MPD_POST_KERNEL = 3
MPD_SLOPE = 0.1


class PeriodDiscriminator(nn.Module):
    """One period's head: wav ``[B, L]`` -> (logit ``[B, 1, L', p]``,
    features)."""

    def __init__(self, period: int, cfg: MPDConfig = MPDConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.period = period
        common = dict(padding="same", compute_dtype=cfg.compute_dtype,
                      generator=generator)
        cin = 1
        self.n_convs = len(cfg.channels)
        if self.n_convs != len(MPD_STRIDES):
            raise ValueError(f"the MPD has {len(MPD_STRIDES)} convs, not "
                             f"{self.n_convs}")
        for i, (ch, st) in enumerate(zip(cfg.channels, MPD_STRIDES)):
            self.add_module(f"conv_{i}", WNConv(cin, ch, (MPD_KERNEL, 1),
                                                stride=(st, 1), **common))
            cin = ch
        self.conv_out = WNConv(cin, 1, (MPD_POST_KERNEL, 1), **common)

    def forward(self, wav: torch.Tensor):
        p = self.period
        x = F.pad(wav[:, None], (0, p - wav.shape[-1] % p), mode="reflect")
        x = x.view(x.shape[0], 1, x.shape[-1] // p, p)
        feats = []
        for i in range(self.n_convs):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), MPD_SLOPE)
            feats.append(x)
        return self.conv_out(x), feats


class MultiPeriodDiscriminator(nn.Module):
    """One ``PeriodDiscriminator`` per period, named ``period_{p}``."""

    def __init__(self, cfg: MPDConfig = MPDConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.names = [f"period_{p}" for p in cfg.periods]
        for name, p in zip(self.names, cfg.periods):
            self.add_module(name, PeriodDiscriminator(p, cfg, generator))

    def forward(self, wav: torch.Tensor):
        logits, features = [], []
        for name in self.names:
            logit, feats = getattr(self, name)(wav)
            logits.append(logit)
            features.append(feats)
        return logits, features


class CombinedDiscriminator(nn.Module):
    """The full stage-2 D: wav ``[B, L]`` -> (logits, features), the MSD's
    heads (where ``msd.n_scales > 0``), the MPD's (where ``mpd`` has
    periods), then the MRD's; with ``input_peak`` > 0 every head sees
    ``peak_normalize(wav, input_peak)``."""

    def __init__(self, msd: MSDConfig = MSDConfig(),
                 mrd: MRDConfig = MRDConfig(),
                 generator: torch.Generator | None = None,
                 mpd: MPDConfig = MPDConfig(), input_peak: float = 0.0):
        super().__init__()
        self.input_peak = input_peak
        self.parts = []
        if msd.n_scales > 0:
            self.msd = MultiScaleDiscriminator(msd, generator)
            self.parts.append("msd")
        if mpd.periods:
            self.mpd = MultiPeriodDiscriminator(mpd, generator)
            self.parts.append("mpd")
        self.mrd = MultiResSTFTDiscriminator(mrd, generator)
        self.parts.append("mrd")

    def forward(self, wav: torch.Tensor):
        if self.input_peak > 0:
            wav = peak_normalize(wav, self.input_peak)
        logits, features = [], []
        for part in self.parts:
            part_logits, part_feats = getattr(self, part)(wav)
            logits += part_logits
            features += part_feats
        return logits, features
