"""The plain reference of the models: composer, vocoder, MSD and MRD.

A frozen copy, in plain PyTorch, of the port's modules at commit 29bca4e
(``music_synthesis_tpu_torch/ops/conv.py``, ``models/vocoder.py``,
``models/specgan.py``, ``models/discriminators.py``), which are themselves
ports of the published layers (HiFi-GAN's MSD and residual stacks,
iSTFTNet's head, the multi-resolution STFT discriminator). Parameter names
and layouts are the port's, so the same tensors load into both sides.
Departures from the port, on purpose:

- a grouped convolution always runs as a grouped one (the port may lower
  it to a dense block-diagonal one, ``dense_groups_max_g``: the same
  function, which the comparison checks);
- nothing is cached or graphed, and no kernel of the port is imported;
- ``lower="fp8"`` (the control of a bf16 configuration) rounds every
  convolution's input and kernel to float8 e4m3 with a per-tensor scale
  (amax / 448, as fp8 training recipes scale) before the bf16 convolution,
  the gradient passing straight through the rounding.

Configurations are attribute namespaces (``harness.config.ns``) with the
port's field names.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["WNConv", "WNConvTranspose1d", "Vocoder", "SpectrogramGenerator",
           "CombinedDiscriminator", "stft", "magnitude_stft", "hann_window",
           "overlap_add", "ola_window", "ola_normalizer", "istft_synthesis",
           "strict_fp32"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FP8_MAX = 448.0


@contextlib.contextmanager
def strict_fp32():
    """fp32 matrix products and convolutions in full fp32 (no TF32) within
    the block, as the reference computes its fp32 parts."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 with a per-tensor scale; straight-through."""
    scale = (x.detach().abs().amax().float() / _FP8_MAX).clamp(min=1e-30)
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def _cast(x: torch.Tensor, dtype: torch.dtype, lower: str | None):
    x = x.to(dtype)
    return _fp8(x) if lower == "fp8" else x


class _WN(nn.Module):
    """``v`` ``[*K, Cin/groups, Cout]``, ``g`` and ``b`` ``[Cout]``; the
    kernel is ``g * v / sqrt(sum(v^2) + 1e-12)`` over all axes but Cout."""

    def __init__(self, kshape, use_weight_norm: bool, compute_dtype: str,
                 lower: str | None):
        super().__init__()
        self.v = nn.Parameter(torch.empty(kshape))
        self.use_weight_norm = use_weight_norm
        if use_weight_norm:
            self.g = nn.Parameter(torch.empty(kshape[-1]))
        self.b = nn.Parameter(torch.empty(kshape[-1]))
        self.dtype = _DTYPES[compute_dtype]
        self.lower = lower

    def kernel(self) -> torch.Tensor:
        if not self.use_weight_norm:
            return self.v
        dims = tuple(range(self.v.ndim - 1))
        norm = torch.sqrt(torch.sum(self.v * self.v, dim=dims) + 1e-12)
        return self.v * (self.g / norm)


class WNConv(_WN):
    """1-D ``[B, C, L]`` or 2-D ``[B, C, T, F]`` convolution; padding
    'same' (zeros, ``d*(k-1)`` per axis, the extra sample at the end),
    'reflect' (the same amounts reflected) or 'valid'."""

    def __init__(self, cin: int, cout: int, kernel, *, stride=1, dilation=1,
                 groups: int = 1, padding: str = "same",
                 use_weight_norm: bool = True, compute_dtype: str = "float32",
                 lower: str | None = None):
        kernel = (kernel,) if isinstance(kernel, int) else tuple(kernel)
        nd = len(kernel)

        def axes(v):
            return (v,) * nd if isinstance(v, int) else tuple(v)

        super().__init__((*kernel, cin // groups, cout), use_weight_norm,
                         compute_dtype, lower)
        self.stride, self.dilation = axes(stride), axes(dilation)
        self.groups, self.padding = groups, padding
        pads = []
        for k, d in zip(reversed(kernel), reversed(self.dilation)):
            total = 0 if padding == "valid" else d * (k - 1)
            pads += [total // 2, total - total // 2]
        self.pads = tuple(pads)
        self.conv = F.conv1d if nd == 1 else F.conv2d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if any(self.pads):
            x = F.pad(x, self.pads, mode="reflect" if self.padding == "reflect"
                      else "constant")
        k = self.kernel()
        w = k.permute(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))
        return self.conv(_cast(x, self.dtype, self.lower),
                         _cast(w, self.dtype, self.lower),
                         self.b.to(self.dtype), stride=self.stride,
                         dilation=self.dilation, groups=self.groups)


class WNConvTranspose1d(_WN):
    """``[B, Cin, L] -> [B, Cout, L*stride]``, JAX's ``conv_transpose``
    with 'SAME' padding and an HIO kernel (the kernel flipped)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, *,
                 use_weight_norm: bool = True, compute_dtype: str = "float32",
                 lower: str | None = None):
        super().__init__((kernel, cin, cout), use_weight_norm, compute_dtype,
                         lower)
        pad_len = kernel + stride - 2
        pad_a = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
        self.stride, self.padding = stride, kernel - 1 - pad_a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel().flip(0).permute(1, 2, 0)
        out = F.conv_transpose1d(_cast(x, self.dtype, self.lower),
                                 _cast(w, self.dtype, self.lower),
                                 self.b.to(self.dtype), stride=self.stride,
                                 padding=self.padding)
        return out[..., : x.shape[-1] * self.stride]


class _ResBlock(nn.Module):
    def __init__(self, ch: int, dilation: int, kernel: int, slope: float,
                 common: dict):
        super().__init__()
        self.slope = slope
        self.dilated = WNConv(ch, ch, kernel, dilation=dilation,
                              padding="reflect", **common)
        self.pointwise = WNConv(ch, ch, 1, **common)
        self.shortcut = WNConv(ch, ch, 1, **common)

    def forward(self, x):
        y = self.dilated(F.leaky_relu(x, self.slope))
        y = self.pointwise(F.leaky_relu(y, self.slope))
        return self.shortcut(x) + y


class _ResStack(nn.Module):
    def __init__(self, ch: int, dilations, kernel: int, slope: float,
                 common: dict):
        super().__init__()
        self.names = [f"block_d{d}" for d in dilations]
        for name, d in zip(self.names, dilations):
            self.add_module(name, _ResBlock(ch, d, kernel, slope, common))

    def forward(self, x):
        for name in self.names:
            x = getattr(self, name)(x)
        return x


# -- signal helpers (ops/frontend.py, ops/overlap_add.py, ops/istft.py) --


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window."""
    i = torch.arange(n, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * torch.pi * i / n)


def stft(x: torch.Tensor, n_fft: int, hop: int, win: int | None = None):
    """Hann-windowed real STFT ``[..., L] -> [..., T, n_fft//2+1]``."""
    win = win or n_fft
    frames = x.unfold(-1, win, hop) * hann_window(win, x.dtype, x.device)
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def magnitude_stft(x, n_fft, hop, win=None, eps: float = 1e-7):
    s = stft(x, n_fft, hop, win)
    return torch.sqrt(s.real ** 2 + s.imag ** 2 + eps)


def overlap_add(chunks: torch.Tensor, hop: int) -> torch.Tensor:
    """``[..., N, C] -> [..., (N-1)*hop + C]``, chunk n at sample n*hop."""
    *lead, n, c = chunks.shape
    length = (n - 1) * hop + c
    cols = chunks.reshape(-1, n, c).transpose(1, 2)
    out = F.fold(cols, (1, length), (1, c), stride=(1, hop))
    return out.reshape(*lead, length)


def ola_window(c: int, hop: int, device=None) -> torch.Tensor:
    """Raised-cosine ramps of ``c - hop`` samples and a flat middle."""
    overlap = c - hop
    if overlap <= 0:
        return torch.ones(c, device=device)
    i = torch.arange(overlap, dtype=torch.float32, device=device)
    ramp = 0.5 - 0.5 * torch.cos(torch.pi * (i + 0.5) / overlap)
    return torch.cat([ramp, torch.ones(c - 2 * overlap, device=device),
                      ramp.flip(0)])


def ola_normalizer(window: torch.Tensor, n: int, hop: int) -> torch.Tensor:
    return torch.clamp(overlap_add(window.expand(n, window.shape[0]), hop),
                       min=1e-8)


def istft_synthesis(re, im, n_fft: int, hop: int) -> torch.Tensor:
    """``[B, T, n_fft//2+1]`` x2 -> ``[B, T*hop]``: irfft, Hann window,
    overlap-add, normalised, ``(n_fft - hop)//2`` trimmed each side."""
    frames = torch.fft.irfft(torch.complex(re.double(), im.double()),
                             n=n_fft, dim=-1).float()
    window = hann_window(n_fft, device=re.device)
    wav = overlap_add(frames * window, hop)
    n = frames.shape[-2]
    wav = wav / ola_normalizer(window, n, hop)
    trim = (n_fft - hop) // 2
    return wav[..., trim: trim + n * hop]


# -- the models ----------------------------------------------------------


class Vocoder(nn.Module):
    """mel ``[B, T, n_mels]`` -> waveform ``[B, T * hop]``."""

    def __init__(self, cfg, lower: str | None = None):
        super().__init__()
        self.cfg = cfg
        common = dict(use_weight_norm=cfg.use_weight_norm,
                      compute_dtype=cfg.compute_dtype, lower=lower)
        self.conv_in = WNConv(cfg.n_mels, cfg.base_channels, cfg.input_kernel,
                              padding="reflect", **common)
        ch = cfg.base_channels
        for i, u in enumerate(cfg.upsample_factors):
            cin, ch = ch, ch // 2
            if cfg.upsample_mode != "transpose":
                raise ValueError("the reference upsamples by transposed "
                                 "convolutions only")
            self.add_module(f"upsample_{i}",
                            WNConvTranspose1d(cin, ch, 2 * u, u, **common))
            self.add_module(f"res_{i}", _ResStack(
                ch, cfg.res_dilations, cfg.res_kernel, cfg.leaky_slope,
                common))
        out = 2 * (cfg.istft_n_fft // 2 + 1) if cfg.head == "istft" else 1
        self.conv_out = WNConv(ch, out, cfg.output_kernel, padding="reflect",
                               **common)

    def forward(self, mel):
        cfg = self.cfg
        x = self.conv_in(mel.transpose(1, 2))
        for i in range(len(cfg.upsample_factors)):
            x = F.leaky_relu(x, cfg.leaky_slope)
            x = getattr(self, f"upsample_{i}")(x)
            x = getattr(self, f"res_{i}")(x)
        x = self.conv_out(F.leaky_relu(x, cfg.leaky_slope)).float()
        if cfg.head == "istft":
            nb = cfg.istft_n_fft // 2 + 1
            spec = x.transpose(1, 2)
            mag = torch.exp(2.0 * torch.tanh(spec[..., :nb]))
            phase = spec[..., nb:]
            return torch.tanh(istft_synthesis(
                mag * torch.cos(phase), mag * torch.sin(phase),
                cfg.istft_n_fft, cfg.istft_hop))
        return torch.tanh(x)[:, 0]


class SpectrogramGenerator(nn.Module):
    """The composer: z ``[B, Z]`` -> normalised log-mel ``[B, T, M]``."""

    def __init__(self, cfg, lower: str | None = None):
        super().__init__()
        self.cfg = cfg
        common = dict(use_weight_norm=cfg.use_weight_norm,
                      compute_dtype=cfg.compute_dtype, lower=lower)
        self.latent_in = nn.Linear(cfg.latent_dim,
                                   cfg.initial_frames * cfg.base_channels)
        ch = cfg.base_channels
        for i, u in enumerate(cfg.upsample_factors):
            cin, ch = ch, max(ch // 2, cfg.n_mels)
            self.add_module(f"upsample_{i}",
                            WNConvTranspose1d(cin, ch, 2 * u, u, **common))
            self.add_module(f"res_{i}", _ResStack(
                ch, cfg.res_dilations, 3, cfg.leaky_slope, common))
        self.conv_out = WNConv(ch, cfg.n_mels, 7, padding="reflect", **common)

    def forward(self, z):
        cfg = self.cfg
        x = self.latent_in(z.float())
        x = x.reshape(z.shape[0], cfg.initial_frames,
                      cfg.base_channels).transpose(1, 2)
        for i in range(len(cfg.upsample_factors)):
            x = F.leaky_relu(x, cfg.leaky_slope)
            x = getattr(self, f"upsample_{i}")(x)
            x = getattr(self, f"res_{i}")(x)
        x = self.conv_out(F.leaky_relu(x, cfg.leaky_slope))
        return torch.tanh(cfg.out_temperature * x.float()).transpose(1, 2)


class _ScaleDisc(nn.Module):
    def __init__(self, cfg, lower):
        super().__init__()
        self.slope = cfg.leaky_slope
        common = dict(use_weight_norm=cfg.use_weight_norm,
                      compute_dtype=cfg.compute_dtype, lower=lower)
        self.conv_in = WNConv(1, cfg.channels[0], cfg.input_kernel,
                              padding="reflect", **common)
        self.n_down = len(cfg.strides)
        for i, (cin, ch, s, grp) in enumerate(zip(
                cfg.channels, cfg.channels[1:], cfg.strides, cfg.groups)):
            self.add_module(f"down_{i}", WNConv(
                cin, ch, cfg.kernel, stride=s, groups=min(grp, cin), **common))
        self.conv_post = WNConv(cfg.channels[self.n_down], cfg.channels[-1],
                                cfg.post_kernel, **common)
        self.conv_out = WNConv(cfg.channels[-1], 1, cfg.output_kernel,
                               **common)

    def forward(self, wav):
        x = F.leaky_relu(self.conv_in(wav[:, None]), self.slope)
        feats = [x]
        for i in range(self.n_down):
            x = F.leaky_relu(getattr(self, f"down_{i}")(x), self.slope)
            feats.append(x)
        x = F.leaky_relu(self.conv_post(x), self.slope)
        feats.append(x)
        return self.conv_out(x), feats


_MRD_LAYERS = (((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)),
               ((3, 9), (1, 2)), ((3, 3), (1, 1)))


class _STFTDisc(nn.Module):
    def __init__(self, n_fft, hop, win, cfg, lower):
        super().__init__()
        self.n_fft, self.hop, self.win = n_fft, hop, win
        if cfg.input_mode != "logmag":
            raise ValueError("the reference's MRD reads the log-magnitude "
                             "only")
        self.slope = cfg.leaky_slope
        common = dict(padding="same", use_weight_norm=cfg.use_weight_norm,
                      compute_dtype=cfg.compute_dtype, lower=lower)
        cin = 1
        for i, (k, st) in enumerate(_MRD_LAYERS):
            self.add_module(f"conv_{i}", WNConv(cin, cfg.channels, k,
                                                stride=st, **common))
            cin = cfg.channels
        self.conv_out = WNConv(cfg.channels, 1, (3, 3), **common)

    def forward(self, wav):
        x = torch.log(magnitude_stft(wav, self.n_fft, self.hop,
                                     self.win))[:, None]
        feats = []
        for i in range(len(_MRD_LAYERS)):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), self.slope)
            feats.append(x)
        return self.conv_out(x), feats


class _MSD(nn.Module):
    def __init__(self, cfg, lower):
        super().__init__()
        self.cfg = cfg
        for s in range(cfg.n_scales):
            self.add_module(f"scale_{s}", _ScaleDisc(cfg, lower))

    def forward(self, wav):
        logits, feats, x = [], [], wav
        for s in range(self.cfg.n_scales):
            logit, f = getattr(self, f"scale_{s}")(x)
            logits.append(logit)
            feats.append(f)
            if s + 1 < self.cfg.n_scales:
                x = F.avg_pool1d(x[:, None], 4, self.cfg.downsample_factor, 1,
                                 count_include_pad=False)[:, 0]
        return logits, feats


class _MRD(nn.Module):
    def __init__(self, cfg, lower):
        super().__init__()
        self.names = [f"res_{r[0]}" for r in cfg.resolutions]
        for name, (n_fft, hop, win) in zip(self.names, cfg.resolutions):
            self.add_module(name, _STFTDisc(n_fft, hop, win, cfg, lower))

    def forward(self, wav):
        logits, feats = [], []
        for name in self.names:
            logit, f = getattr(self, name)(wav)
            logits.append(logit)
            feats.append(f)
        return logits, feats


class CombinedDiscriminator(nn.Module):
    """MSD then MRD: wav ``[B, L]`` -> (logits, features per head)."""

    def __init__(self, msd, mrd, lower: str | None = None):
        super().__init__()
        self.msd = _MSD(msd, lower)
        self.mrd = _MRD(mrd, lower)

    def forward(self, wav):
        a, fa = self.msd(wav)
        b, fb = self.mrd(wav)
        return a + b, fa + fb

