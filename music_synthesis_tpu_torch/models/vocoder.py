"""Stage-2 conditioned vocoder (counterpart of ``models/vocoder.py``).

mel ``[B, T, M]`` -> waveform ``[B, T * hop]``: an input conv, transposed-conv
upsampling stages each followed by a dilated residual stack, and either a
waveform head (conv to one channel, tanh) or an iSTFT head (log-magnitude
and phase, ``exp(2 tanh)`` magnitude, irDFT + overlap-add, tanh).
Submodule names equal the Flax module names, so the zoo's parameter trees
load by flattening (``convert.py``).

With ``block="amp"`` the generator is BigVGAN's (Lee et al.,
arXiv:2206.04658; upstream ``bigvgan.py``), which the JAX package does
not build: no activation before an upsampling, each upsampling followed by
the mean of ``AMPBlock`` stacks (one per kernel of ``mrf_kernels``, the
multi-receptive-field fusion), every activation the anti-aliased
SnakeBeta (``ops/alias_free.py``), then one more activation, the output
convolution and tanh. Its convolutions pad with zeros ("same") and its
upsamplings carry one weight-norm gain per input channel, as upstream's
``weight_norm`` has them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from music_synthesis_tpu_torch.config import VocoderConfig
from music_synthesis_tpu_torch.ops.alias_free import aa_snake_beta
from music_synthesis_tpu_torch.ops.conv import WNConv, WNConvTranspose1d
from music_synthesis_tpu_torch.ops.istft import istft_synthesis

__all__ = ["ResidualBlock", "ResidualStack", "SnakeBeta", "AMPBlock", "MRF",
           "Vocoder"]

#: Upstream's ``init_weights`` std of BigVGAN's convolutions ("dcgan").
AMP_INIT_SCALE = 0.01


class ResidualBlock(nn.Module):
    """leaky -> dilated conv -> leaky -> 1x conv, plus a 1x-conv shortcut."""

    def __init__(self, channels: int, dilation: int, kernel: int = 3,
                 leaky_slope: float = 0.2, use_weight_norm: bool = True,
                 compute_dtype: str = "float32", init_scheme: str = "dcgan",
                 res_init_gain: float = 1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        common = dict(use_weight_norm=use_weight_norm,
                      compute_dtype=compute_dtype, init_scheme=init_scheme,
                      generator=generator)
        self.leaky_slope = leaky_slope
        self.dilated = WNConv(channels, channels, kernel, dilation=dilation,
                              padding="reflect", **common)
        self.pointwise = WNConv(channels, channels, 1,
                                init_gain=res_init_gain, **common)
        self.shortcut = WNConv(channels, channels, 1, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dilated(F.leaky_relu(x, self.leaky_slope))
        y = self.pointwise(F.leaky_relu(y, self.leaky_slope))
        return self.shortcut(x) + y


class ResidualStack(nn.Module):
    """Residual blocks with increasing dilation, named ``block_d{d}``."""

    def __init__(self, channels: int, dilations=(1, 3, 9), kernel: int = 3,
                 leaky_slope: float = 0.2, use_weight_norm: bool = True,
                 compute_dtype: str = "float32", init_scheme: str = "dcgan",
                 res_init_gain: float = 1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.names = [f"block_d{d}" for d in dilations]
        for name, d in zip(self.names, dilations):
            self.add_module(name, ResidualBlock(
                channels, d, kernel, leaky_slope, use_weight_norm,
                compute_dtype, init_scheme, res_init_gain, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class SnakeBeta(nn.Module):
    """Anti-aliased SnakeBeta over ``channels`` (``ops.alias_free``), its
    log-scale ``alpha`` and ``beta`` per channel (upstream's init: 0)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return aa_snake_beta(x, self.alpha, self.beta)


class AMPBlock(nn.Module):
    """BigVGAN's AMPBlock1: for each dilation ``d``, ``x = x +
    c2_d(act2_d(c1_d(act1_d(x))))``, ``c1_d`` of dilation ``d`` and ``c2_d``
    of dilation 1, both of ``kernel`` with zero "same" padding; ``c2_d``
    drawn at ``res_init_gain``."""

    def __init__(self, channels: int, kernel: int, dilations,
                 res_init_gain: float = 1.0, **common):
        super().__init__()
        self.dilations = tuple(dilations)
        for d in self.dilations:
            self.add_module(f"act1_d{d}", SnakeBeta(channels))
            self.add_module(f"c1_d{d}", WNConv(channels, channels, kernel,
                                               dilation=d, padding="same",
                                               **common))
            self.add_module(f"act2_d{d}", SnakeBeta(channels))
            self.add_module(f"c2_d{d}", WNConv(channels, channels, kernel,
                                               padding="same",
                                               init_gain=res_init_gain,
                                               **common))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for d in self.dilations:
            y = getattr(self, f"c1_d{d}")(getattr(self, f"act1_d{d}")(x))
            x = x + getattr(self, f"c2_d{d}")(getattr(self, f"act2_d{d}")(y))
        return x


class MRF(nn.Module):
    """The mean of one ``AMPBlock`` per kernel (``amp_k{k}``), summed in
    order and divided by their number, as upstream does."""

    def __init__(self, channels: int, kernels, dilations,
                 res_init_gain: float = 1.0, **common):
        super().__init__()
        self.names = [f"amp_k{k}" for k in kernels]
        for name, k in zip(self.names, kernels):
            self.add_module(name, AMPBlock(channels, k, dilations,
                                           res_init_gain, **common))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = None
        for name in self.names:
            y = getattr(self, name)(x)
            out = y if out is None else out + y
        return out / len(self.names)


def _check(cfg: VocoderConfig) -> None:
    if cfg.block not in ("residual", "amp"):
        raise ValueError(f"unknown block {cfg.block!r}")
    if cfg.block == "amp" and (not cfg.mrf_kernels or cfg.head != "waveform"
                               or cfg.upsample_mode != "transpose"):
        raise ValueError("the amp block needs mrf_kernels, the waveform "
                         "head and transposed-conv upsampling")


class Vocoder(nn.Module):
    """mel ``[B, T, n_mels]`` -> waveform ``[B, T * cfg.hop_length]`` float32."""

    def __init__(self, cfg: VocoderConfig = VocoderConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        _check(cfg)
        self.cfg = cfg
        amp = cfg.block == "amp"
        common = dict(use_weight_norm=cfg.use_weight_norm,
                      compute_dtype=cfg.compute_dtype,
                      init_scheme=cfg.init_scheme, generator=generator)
        if amp:
            common["init_scale"] = AMP_INIT_SCALE
        padding = "same" if amp else "reflect"
        self.conv_in = WNConv(cfg.n_mels, cfg.base_channels, cfg.input_kernel,
                              padding=padding, **common)
        channels = cfg.base_channels
        for i, u in enumerate(cfg.upsample_factors):
            cin, channels = channels, channels // 2
            if cfg.upsample_mode == "transpose":
                up = WNConvTranspose1d(cin, channels, 2 * u, u,
                                       gain_per_input=amp, **common)
            elif cfg.upsample_mode == "repeat":
                up = WNConv(cin, channels, 2 * u + 1, padding="reflect",
                            **common)
            else:
                raise ValueError(f"unknown upsample_mode {cfg.upsample_mode}")
            self.add_module(f"upsample_{i}", up)
            self.add_module(f"res_{i}", MRF(
                channels, cfg.mrf_kernels, cfg.res_dilations,
                cfg.res_init_gain, **common)
                if amp else ResidualStack(
                channels, cfg.res_dilations, cfg.res_kernel, cfg.leaky_slope,
                cfg.use_weight_norm, cfg.compute_dtype, cfg.init_scheme,
                cfg.res_init_gain, generator))
        if cfg.head == "istft":
            out_ch = 2 * (cfg.istft_n_fft // 2 + 1)
        elif cfg.head == "waveform":
            out_ch = 1
        else:
            raise ValueError(f"unknown head {cfg.head!r}")
        if amp:
            self.act_out = SnakeBeta(channels)
        self.conv_out = WNConv(channels, out_ch, cfg.output_kernel,
                               padding=padding, init_gain=cfg.out_init_gain,
                               **common)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        amp = cfg.block == "amp"
        x = self.conv_in(mel.transpose(1, 2))
        for i, u in enumerate(cfg.upsample_factors):
            if not amp:  # BigVGAN's G has no activation before upsampling
                x = F.leaky_relu(x, cfg.leaky_slope)
            if cfg.upsample_mode == "repeat":
                x = x.repeat_interleave(u, dim=-1)
            x = getattr(self, f"upsample_{i}")(x)
            x = getattr(self, f"res_{i}")(x)
        x = self.act_out(x) if amp else F.leaky_relu(x, cfg.leaky_slope)
        x = self.conv_out(x).float()
        if cfg.head == "istft":
            n_bins = cfg.istft_n_fft // 2 + 1
            spec = x.transpose(1, 2)  # [B, T', 2 * n_bins]
            log_mag, phase = spec[..., :n_bins], spec[..., n_bins:]
            mag = torch.exp(2.0 * torch.tanh(log_mag))
            wav = istft_synthesis(mag * torch.cos(phase), mag * torch.sin(phase),
                                  cfg.istft_n_fft, cfg.istft_hop)
            return torch.tanh(wav)
        return torch.tanh(x)[:, 0]
