"""Stage-2 conditioned vocoder (counterpart of ``models/vocoder.py``).

mel ``[B, T, M]`` -> waveform ``[B, T * hop]``: an input conv, transposed-conv
upsampling stages each followed by a dilated residual stack, and either a
waveform head (conv to one channel, tanh) or an iSTFT head (log-magnitude
and phase, ``exp(2 tanh)`` magnitude, irDFT + overlap-add, tanh).
Submodule names equal the Flax module names, so the zoo's parameter trees
load by flattening (``convert.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from music_synthesis_tpu_torch.config import VocoderConfig
from music_synthesis_tpu_torch.ops.conv import WNConv, WNConvTranspose1d
from music_synthesis_tpu_torch.ops.istft import istft_synthesis

__all__ = ["ResidualBlock", "ResidualStack", "Vocoder"]


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


class Vocoder(nn.Module):
    """mel ``[B, T, n_mels]`` -> waveform ``[B, T * cfg.hop_length]`` float32."""

    def __init__(self, cfg: VocoderConfig = VocoderConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        common = dict(use_weight_norm=cfg.use_weight_norm,
                      compute_dtype=cfg.compute_dtype,
                      init_scheme=cfg.init_scheme, generator=generator)
        self.conv_in = WNConv(cfg.n_mels, cfg.base_channels, cfg.input_kernel,
                              padding="reflect", **common)
        channels = cfg.base_channels
        for i, u in enumerate(cfg.upsample_factors):
            cin, channels = channels, channels // 2
            if cfg.upsample_mode == "transpose":
                up = WNConvTranspose1d(cin, channels, 2 * u, u, **common)
            elif cfg.upsample_mode == "repeat":
                up = WNConv(cin, channels, 2 * u + 1, padding="reflect",
                            **common)
            else:
                raise ValueError(f"unknown upsample_mode {cfg.upsample_mode}")
            self.add_module(f"upsample_{i}", up)
            self.add_module(f"res_{i}", ResidualStack(
                channels, cfg.res_dilations, cfg.res_kernel, cfg.leaky_slope,
                cfg.use_weight_norm, cfg.compute_dtype, cfg.init_scheme,
                cfg.res_init_gain, generator))
        if cfg.head == "istft":
            out_ch = 2 * (cfg.istft_n_fft // 2 + 1)
        elif cfg.head == "waveform":
            out_ch = 1
        else:
            raise ValueError(f"unknown head {cfg.head!r}")
        self.conv_out = WNConv(channels, out_ch, cfg.output_kernel,
                               padding="reflect", init_gain=cfg.out_init_gain,
                               **common)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.conv_in(mel.transpose(1, 2))
        for i, u in enumerate(cfg.upsample_factors):
            x = F.leaky_relu(x, cfg.leaky_slope)
            if cfg.upsample_mode == "repeat":
                x = x.repeat_interleave(u, dim=-1)
            x = getattr(self, f"upsample_{i}")(x)
            x = getattr(self, f"res_{i}")(x)
        x = self.conv_out(F.leaky_relu(x, cfg.leaky_slope)).float()
        if cfg.head == "istft":
            n_bins = cfg.istft_n_fft // 2 + 1
            spec = x.transpose(1, 2)  # [B, T', 2 * n_bins]
            log_mag, phase = spec[..., :n_bins], spec[..., n_bins:]
            mag = torch.exp(2.0 * torch.tanh(log_mag))
            wav = istft_synthesis(mag * torch.cos(phase), mag * torch.sin(phase),
                                  cfg.istft_n_fft, cfg.istft_hop)
            return torch.tanh(wav)
        return torch.tanh(x)[:, 0]
