"""Stage-1 spectrogram GAN, the "composer" (counterpart of
``models/specgan.py``).

``SpectrogramGenerator``: z ``[B, latent_dim]`` -> normalized log-mel
``[B, n_frames, n_mels]`` in [-1, 1]. Flax's ``nn.Dense`` kernel ``[Z, F]``
is ``nn.Linear``'s weight ``[F, Z]`` transposed; ``convert.py`` does that.

``SpectrogramDiscriminator``: normalized log-mel ``[B, T, M]`` -> (logit
``[B, 1, T']`` in fp32, features ``[B, C, T_i]`` after each strided layer).
The JAX module returns the same values channel-last (``[B, T', 1]``,
``[B, T_i, C]``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from music_synthesis_tpu_torch.config import SpecGANConfig
from music_synthesis_tpu_torch.models.vocoder import ResidualStack
from music_synthesis_tpu_torch.ops.conv import WNConv, WNConvTranspose1d

__all__ = ["SpectrogramGenerator", "SpectrogramDiscriminator"]


class SpectrogramGenerator(nn.Module):
    def __init__(self, cfg: SpecGANConfig = SpecGANConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        up_total = 1
        for u in cfg.upsample_factors:
            up_total *= u
        if cfg.initial_frames * up_total != cfg.n_frames:
            raise ValueError(
                "initial_frames * prod(upsample_factors) must equal n_frames")
        self.cfg = cfg
        common = dict(use_weight_norm=cfg.use_weight_norm,
                      compute_dtype=cfg.compute_dtype,
                      init_scheme=cfg.init_scheme, generator=generator)
        self.latent_in = nn.Linear(cfg.latent_dim,
                                   cfg.initial_frames * cfg.base_channels)
        std = ((2.0 / cfg.latent_dim) ** 0.5 if cfg.init_scheme == "he"
               else 0.02)
        with torch.no_grad():
            self.latent_in.weight.normal_(0.0, std, generator=generator)
            self.latent_in.bias.zero_()
        channels = cfg.base_channels
        for i, u in enumerate(cfg.upsample_factors):
            cin, channels = channels, max(channels // 2, cfg.n_mels)
            self.add_module(f"upsample_{i}",
                            WNConvTranspose1d(cin, channels, 2 * u, u, **common))
            self.add_module(f"res_{i}", ResidualStack(
                channels, cfg.res_dilations, leaky_slope=cfg.leaky_slope,
                use_weight_norm=cfg.use_weight_norm,
                compute_dtype=cfg.compute_dtype, init_scheme=cfg.init_scheme,
                res_init_gain=cfg.res_init_gain, generator=generator))
        self.conv_out = WNConv(channels, cfg.n_mels, 7, padding="reflect",
                               init_gain=cfg.out_init_gain, **common)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.latent_in(z.float())
        x = x.reshape(z.shape[0], cfg.initial_frames, cfg.base_channels)
        x = x.transpose(1, 2)  # [B, C, T0]
        for i in range(len(cfg.upsample_factors)):
            x = F.leaky_relu(x, cfg.leaky_slope)
            x = getattr(self, f"upsample_{i}")(x)
            x = getattr(self, f"res_{i}")(x)
        x = self.conv_out(F.leaky_relu(x, cfg.leaky_slope))
        return torch.tanh(cfg.out_temperature * x.float()).transpose(1, 2)


class SpectrogramDiscriminator(nn.Module):
    """Strided ``"same"``-padded convolutions over frames (the mel bins are
    the input channels), each followed by a leaky ReLU and tapped for
    feature matching, then a 3-tap ``conv_out`` to one logit channel."""

    def __init__(self, cfg: SpecGANConfig = SpecGANConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.slope = cfg.leaky_slope
        common = dict(use_weight_norm=cfg.use_weight_norm,
                      compute_dtype=cfg.compute_dtype,
                      init_scheme=cfg.init_scheme, generator=generator)
        self.n_down = len(cfg.disc_channels)
        cin = cfg.n_mels
        for i, (ch, s) in enumerate(zip(cfg.disc_channels, cfg.disc_strides)):
            self.add_module(f"down_{i}", WNConv(cin, ch, cfg.disc_kernel,
                                                stride=s, **common))
            cin = ch
        self.conv_out = WNConv(cin, 1, 3, **common)

    def forward(self, mel: torch.Tensor):
        x = mel.transpose(1, 2)  # [B, M, T]
        feats = []
        for i in range(self.n_down):
            x = F.leaky_relu(getattr(self, f"down_{i}")(x), self.slope)
            feats.append(x)
        return self.conv_out(x).float(), feats
