"""Stage-2 discriminators (counterpart of ``models/discriminators.py``).

- ``MultiScaleDiscriminator`` (MSD): identical raw-audio heads on the
  waveform average-pooled by 1x, 2x, 4x; grouped strided 1-D convs.
- ``MultiResSTFTDiscriminator`` (MRD): 2-D convs over the log-magnitude
  (or power-compressed complex) STFT at several resolutions.
- ``CombinedDiscriminator``: both under one parameter tree, the stage-2 D.

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

import torch
import torch.nn.functional as F
from torch import nn

from music_synthesis_tpu_torch.config import MRDConfig, MSDConfig
from music_synthesis_tpu_torch.ops.conv import WNConv, avg_pool1d
from music_synthesis_tpu_torch.ops.frontend import magnitude_stft, stft

__all__ = [
    "ScaleDiscriminator",
    "MultiScaleDiscriminator",
    "STFTDiscriminator",
    "MultiResSTFTDiscriminator",
    "CombinedDiscriminator",
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


class STFTDiscriminator(nn.Module):
    """One spectral head: wav ``[B, L]`` -> 2-D convs over the STFT
    ``[B, C, T, F]``: ``log|S|`` (``input_mode="logmag"``, one channel) or
    ``[Re, Im]`` of ``|S|^p e^{i phase}`` (``"complex"``, two channels)."""

    def __init__(self, n_fft: int, hop: int, win: int, channels: int = 32,
                 leaky_slope: float = 0.2, use_weight_norm: bool = True,
                 compute_dtype: str = "float32", input_mode: str = "logmag",
                 compression: float = 0.3,
                 generator: torch.Generator | None = None):
        super().__init__()
        if input_mode not in ("logmag", "complex"):
            raise ValueError(f"unknown input_mode {input_mode!r}")
        self.n_fft, self.hop, self.win = n_fft, hop, win
        self.slope, self.input_mode = leaky_slope, input_mode
        self.compression = compression
        common = dict(padding="same", use_weight_norm=use_weight_norm,
                      compute_dtype=compute_dtype, generator=generator)
        cin = 2 if input_mode == "complex" else 1
        for i, (k, st) in enumerate(_MRD_LAYERS):
            self.add_module(f"conv_{i}", WNConv(cin, channels, k, stride=st,
                                                **common))
            cin = channels
        self.conv_out = WNConv(channels, 1, (3, 3), **common)

    def forward(self, wav: torch.Tensor):
        if self.input_mode == "complex":
            # S * |S|^(p-1): the smooth floor in |S| bounds the factor.
            s = stft(wav, self.n_fft, self.hop, self.win)
            mag = torch.sqrt(s.real ** 2 + s.imag ** 2 + 1e-7)
            scale = mag ** (self.compression - 1.0)
            x = torch.stack([s.real * scale, s.imag * scale], dim=1)
        else:
            x = torch.log(magnitude_stft(wav, self.n_fft, self.hop,
                                         self.win))[:, None]
        feats = []
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
                cfg.complex_compression, generator))

    def forward(self, wav: torch.Tensor):
        logits, features = [], []
        for name in self.names:
            logit, feats = getattr(self, name)(wav)
            logits.append(logit)
            features.append(feats)
        return logits, features


class CombinedDiscriminator(nn.Module):
    """MSD + MRD, the full stage-2 D: wav ``[B, L]`` -> (logits, features)."""

    def __init__(self, msd: MSDConfig = MSDConfig(),
                 mrd: MRDConfig = MRDConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.msd = MultiScaleDiscriminator(msd, generator)
        self.mrd = MultiResSTFTDiscriminator(mrd, generator)

    def forward(self, wav: torch.Tensor):
        msd_logits, msd_feats = self.msd(wav)
        mrd_logits, mrd_feats = self.mrd(wav)
        return msd_logits + mrd_logits, msd_feats + mrd_feats
