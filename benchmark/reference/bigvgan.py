"""The plain reference of BigVGAN's generator (Lee et al., arXiv:2206.04658;
the 22 kHz 80-band settings of github.com/NVIDIA/BigVGAN), written from
its equations in plain PyTorch: nothing of the program, no JAX. The
tests hold the program to it too (``tests/test_torch_bigvgan.py``). The
equations:

- the filter ``h = kaiser_sinc(0.25, 0.3, 12)``: ``A = 2.285 (6 - 1) pi
  (4 * 0.3) + 7.95``; Kaiser's beta of ``A``; a Kaiser window of 12 taps
  (not periodic) times ``2 fc sinc(2 fc t)`` at ``t = -5.5 .. 5.5``,
  divided by its sum;
- up 2x: replicate-pad 5 per side, ``2 conv_transpose1d(x, h, stride 2)``
  per channel, 15 samples dropped from each end; down 2x: replicate-pad 5
  left and 6 right, ``conv1d(x, h, stride 2)`` per channel;
- SnakeBeta ``u + sin(exp(a) u)^2 / (exp(b) + 1e-9)``; ``Act(x) =
  down(snake(up(x)))``, in fp32;
- AMPBlock1 of kernel ``k``: for ``d`` in the dilations, ``x = x +
  c2(Act(c1_d(Act(x))))``, ``c1_d`` of dilation ``d`` and ``c2`` of 1, zero
  padding ``(k d - d) / 2``;
- G: ``conv_pre`` (k7, pad 3); per stage a transposed convolution of
  kernel ``k = 2 u`` (upstream's 8, 8, 4, 4, 4, 4 at the rates 4, 4, 2, 2,
  2, 2) and stride ``u`` (padding ``(k - u) / 2``), then the mean of
  the AMPBlock1s of the kernels; then ``Act``, ``conv_post`` (k7, pad 3),
  tanh.
- weight norm on every convolution: ``w = g v / ||v||``, the norm per
  output channel, and for a transposed convolution per input channel
  (``torch.nn.utils.weight_norm``'s dim 0).

Parameters carry the program's names and layouts, so one set of tensors
loads into both: ``v`` is ``[K, Cin, Cout]``, a convolution's weight is
``v`` permuted to ``[Cout, Cin, K]``, and a transposed convolution's is
``v`` flipped in time and permuted to ``[Cin, Cout, K]`` (the JAX layout the
program keeps); ``g`` is ``[Cout]`` (``[Cin]`` for the transposed ones), the
bias ``b`` ``[Cout]``; an activation's ``alpha`` and ``beta`` are the
log-scale ``a`` and ``b``. Configurations are attribute namespaces with the
program's field names. Convolutions run in ``compute_dtype`` (their input,
kernel and bias cast, as the configuration states); ``lower="fp8"`` (the
control) also rounds each convolution's input and kernel to float8 e4m3
with a per-tensor scale, the gradient passing straight through.

``magnitude_mel()`` lets the benchmark's plain step
(``reference.train_step``), whose log-mel is of the power spectrum, take
the magnitude one (``power`` 1) that BigVGAN's front end states.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["kaiser_sinc", "up2", "down2", "act", "BigVGAN",
           "magnitude_mel"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def kaiser_sinc(cutoff: float = 0.25, half_width: float = 0.3,
                taps: int = 12) -> torch.Tensor:
    half = taps // 2
    a = 2.285 * (half - 1) * math.pi * (4 * half_width) + 7.95
    if a > 50:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    else:
        beta = 0.0
    n = torch.arange(taps, dtype=torch.float64)
    # Kaiser's window from its definition: I0(beta sqrt(1 - r^2)) / I0(beta)
    r = (2 * n / (taps - 1)) - 1
    w = torch.special.i0(beta * torch.sqrt(1 - r * r)) / torch.special.i0(
        torch.tensor(beta, dtype=torch.float64))
    t = n - half + 0.5
    x = 2 * cutoff * t
    sinc = torch.where(x == 0, torch.ones_like(x),
                       torch.sin(math.pi * x) / (math.pi * x))
    h = 2 * cutoff * w * sinc
    return h / h.sum()


def up2(x: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    h = kaiser_sinc().float().to(x.device).repeat(c, 1, 1)
    y = 2 * F.conv_transpose1d(F.pad(x, (5, 5), mode="replicate"), h,
                               stride=2, groups=c)
    return y[..., 15:-15]


def down2(x: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    h = kaiser_sinc().float().to(x.device).repeat(c, 1, 1)
    return F.conv1d(F.pad(x, (5, 6), mode="replicate"), h, stride=2,
                    groups=c)


def act(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    u = up2(x.float())
    alpha, beta = torch.exp(a)[:, None], torch.exp(b)[:, None]
    return down2(u + torch.sin(alpha * u) ** 2 / (beta + 1e-9))


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = (x.detach().abs().amax().float() / 448.0).clamp(min=1e-30)
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


class _Conv(nn.Module):
    def __init__(self, cin, cout, k, *, dilation=1, stride=1,
                 transposed=False, dtype="float32", lower=None):
        super().__init__()
        self.v = nn.Parameter(torch.empty(k, cin, cout))
        self.g = nn.Parameter(torch.empty(cin if transposed else cout))
        self.b = nn.Parameter(torch.empty(cout))
        self.k, self.d, self.s, self.t = k, dilation, stride, transposed
        self.dtype, self.lower = _DTYPES[dtype], lower

    def _cast(self, x):
        x = x.to(self.dtype)
        return _fp8(x) if self.lower == "fp8" else x

    def forward(self, x):
        v = self.v
        if self.t:  # per input channel; [Cin, Cout, K], flipped in time
            w = self.g[None, :, None] * v / torch.sqrt(
                (v * v).sum((0, 2), keepdim=True) + 1e-12)
            w = w.flip(0).permute(1, 2, 0)
            return F.conv_transpose1d(
                self._cast(x), self._cast(w), self.b.to(self.dtype),
                stride=self.s, padding=(self.k - self.s) // 2)
        w = self.g * v / torch.sqrt((v * v).sum((0, 1)) + 1e-12)
        w = w.permute(2, 1, 0)  # [Cout, Cin, K]
        pad = (self.k * self.d - self.d) // 2
        return F.conv1d(self._cast(x), self._cast(w), self.b.to(self.dtype),
                        padding=pad, dilation=self.d)


class _Act(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(c))
        self.beta = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return act(x, self.alpha, self.beta)


class _AMP(nn.Module):
    def __init__(self, c, k, dilations, conv):
        super().__init__()
        self.ds = tuple(dilations)
        for d in self.ds:
            self.add_module(f"act1_d{d}", _Act(c))
            self.add_module(f"c1_d{d}", conv(c, c, k, dilation=d))
            self.add_module(f"act2_d{d}", _Act(c))
            self.add_module(f"c2_d{d}", conv(c, c, k))

    def forward(self, x):
        for d in self.ds:
            y = getattr(self, f"c1_d{d}")(getattr(self, f"act1_d{d}")(x))
            x = x + getattr(self, f"c2_d{d}")(getattr(self, f"act2_d{d}")(y))
        return x


class _MRF(nn.Module):
    def __init__(self, c, kernels, dilations, conv):
        super().__init__()
        self.names = [f"amp_k{k}" for k in kernels]
        for name, k in zip(self.names, kernels):
            self.add_module(name, _AMP(c, k, dilations, conv))

    def forward(self, x):
        return sum(getattr(self, n)(x) for n in self.names) / len(self.names)


class BigVGAN(nn.Module):
    """mel ``[B, T, n_mels]`` -> waveform ``[B, T * prod(upsample_factors)]``
    float32, from a vocoder configuration of block ``amp``."""

    def __init__(self, cfg, lower: str | None = None):
        super().__init__()
        self.ups = tuple(cfg.upsample_factors)

        def conv(cin, cout, k, **kw):
            return _Conv(cin, cout, k, dtype=cfg.compute_dtype, lower=lower,
                         **kw)

        c = cfg.base_channels
        self.conv_in = conv(cfg.n_mels, c, cfg.input_kernel)
        for i, u in enumerate(cfg.upsample_factors):
            self.add_module(f"upsample_{i}", conv(c, c // 2, 2 * u, stride=u,
                                                  transposed=True))
            c //= 2
            self.add_module(f"res_{i}", _MRF(c, cfg.mrf_kernels,
                                             cfg.res_dilations, conv))
        self.act_out = _Act(c)
        self.conv_out = conv(c, 1, cfg.output_kernel)

    def forward(self, mel):
        x = self.conv_in(mel.transpose(1, 2))
        for i in range(len(self.ups)):
            x = getattr(self, f"res_{i}")(getattr(self, f"upsample_{i}")(x))
        return torch.tanh(self.conv_out(self.act_out(x)).float())[:, 0]


def _log_mel(wav: torch.Tensor, fe) -> torch.Tensor:
    """``log(eps + |S|^p @ mel)`` at ``p = fe.power`` (1 or 2), framed as
    the benchmark's plain log-mel frames it."""
    from reference import audio
    from reference.model import stft

    pad = (fe.n_fft - fe.hop_length) // 2
    x = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    s = stft(x, fe.n_fft, fe.hop_length, fe.win_length)
    spec = s.real ** 2 + s.imag ** 2
    if fe.power == 1.0:
        spec = torch.sqrt(spec)
    elif fe.power != 2.0:
        raise ValueError("power 1 or 2")
    mel = torch.from_numpy(audio.mel_matrix(
        fe.sample_rate, fe.n_fft, fe.n_mels, fe.fmin, fe.fmax)).to(wav.device)
    return torch.log(fe.log_epsilon + spec @ mel)[
        :, : wav.shape[-1] // fe.hop_length]


@contextlib.contextmanager
def magnitude_mel():
    """Within the block the benchmark's ``reference.audio`` computes the
    conditioning log-mel at the front end's power, 1 or 2."""
    from reference import audio

    saved = audio.log_mel_for_vocoder
    audio.log_mel_for_vocoder = _log_mel
    try:
        yield
    finally:
        audio.log_mel_for_vocoder = saved
