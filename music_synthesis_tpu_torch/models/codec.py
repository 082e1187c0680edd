"""DAC, the Descript Audio Codec (Kumar et al., "High-Fidelity Audio
Compression with Improved RVQGAN", arXiv:2306.06546; upstream's
``dac/model/dac.py`` and ``dac/nn/quantize.py``), which the JAX package
does not build.

waveform ``[B, L]`` -> (waveform ``[B, L]``, commitment loss, codebook
loss): the input is zero-padded on the right to a multiple of the hop
(the product of the encoder's rates), encoded, quantized, decoded, and
cut back to ``L``.

- Encoder: a k7 conv to ``encoder_dim``; per rate ``r`` an
  ``EncoderBlock``: three ``ResidualUnit``s at dilations 1, 3, 9, Snake
  and a conv of kernel ``2r``, stride ``r`` and padding ``ceil(r / 2)``
  doubling the channels; then Snake and a k3 conv to ``latent_dim``.
- ``ResidualUnit``: ``x + conv1(snake(conv7_d(snake(x))))``, the k7 conv
  of dilation ``d`` and "same" padding.
- Residual VQ (``ResidualVQ``): ``n_codebooks`` stages, each projecting the
  residual to ``codebook_dim`` (a weight-normed k1 conv), choosing for each
  frame the code nearest by Euclidean distance between the l2-normalised
  latent and the l2-normalised codebook, looking the code up in the raw
  codebook, passing the gradient straight through, and projecting back;
  a stage's output is subtracted from the residual. In training a row
  keeps the first ``n_q`` stages (``n_q`` is G's second input, drawn by
  the step: quantizer dropout); the per-row commitment and codebook losses
  (mean squared errors of the projection and the code, each side
  detached in turn) of the kept stages are averaged over the rows and
  summed over the stages. The VQ runs in fp32.
- Decoder: a k7 conv to ``decoder_dim``; per rate ``r`` a
  ``DecoderBlock``: Snake, a transposed conv of kernel ``2r`` and stride
  ``r`` halving the channels (weight norm per input channel, as
  ``torch.nn.utils.weight_norm`` normalises a ``ConvTranspose1d``), three
  ``ResidualUnit``s; then Snake, a k7 conv to one channel and tanh.

Every conv is weight-normed (``ops/conv.py``) and runs in
``compute_dtype``; every activation is Snake (``ops/snake.py``, fp32
inside). The quantizer's nine stages are the tracer's region ``rvq``, and
``rvq_stage.n_calls`` counts the stages run.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from music_synthesis_tpu_torch.config import CodecConfig
from music_synthesis_tpu_torch.ops.conv import WNConv, WNConvTranspose1d
from music_synthesis_tpu_torch.ops.snake import snake
from music_synthesis_tpu_torch.utils.profiling import counter, region

__all__ = ["Snake", "ResidualUnit", "EncoderBlock", "DecoderBlock",
           "Encoder", "Decoder", "VQStage", "ResidualVQ", "Codec",
           "rvq_stage"]

#: Quantizer stages run (``ResidualVQ``), counted as ``snake`` is.
rvq_stage = counter("rvq_stage")

RES_DILATIONS, RES_KERNEL = (1, 3, 9), 7  # every ResidualUnit's, upstream's


class Snake(nn.Module):
    """Snake over ``channels``, its ``alpha`` per channel (init 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha)


class ResidualUnit(nn.Module):
    def __init__(self, channels: int, dilation: int, **common):
        super().__init__()
        self.act1 = Snake(channels)
        self.conv1 = WNConv(channels, channels, RES_KERNEL, dilation=dilation,
                            padding="same", **common)
        self.act2 = Snake(channels)
        self.conv2 = WNConv(channels, channels, 1, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(self.act2(self.conv1(self.act1(x))))


def _residual_units(module: nn.Module, channels: int,
                    common: dict) -> list[str]:
    names = [f"res_d{d}" for d in RES_DILATIONS]
    for name, d in zip(names, RES_DILATIONS):
        module.add_module(name, ResidualUnit(channels, d, **common))
    return names


class EncoderBlock(nn.Module):
    """Residual units at ``dim // 2``, Snake, a strided conv to ``dim``."""

    def __init__(self, dim: int, stride: int, **common):
        super().__init__()
        self.names = _residual_units(self, dim // 2, common)
        self.act = Snake(dim // 2)
        self.down = WNConv(dim // 2, dim, 2 * stride, stride=stride,
                           padding=math.ceil(stride / 2), **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x)
        return self.down(self.act(x))


class DecoderBlock(nn.Module):
    """Snake, a transposed conv from ``cin`` to ``cout``, residual units."""

    def __init__(self, cin: int, cout: int, stride: int, **common):
        super().__init__()
        self.act = Snake(cin)
        self.up = WNConvTranspose1d(cin, cout, 2 * stride, stride,
                                    gain_per_input=True, **common)
        self.names = _residual_units(self, cout, common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.up(self.act(x))
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: CodecConfig, **common):
        super().__init__()
        dim = cfg.encoder_dim
        self.conv_in = WNConv(1, dim, 7, padding="same", **common)
        self.n_blocks = len(cfg.encoder_rates)
        for i, r in enumerate(cfg.encoder_rates):
            dim *= 2
            self.add_module(f"block_{i}", EncoderBlock(dim, r, **common))
        self.act_out = Snake(dim)
        self.conv_out = WNConv(dim, cfg.latent_dim, 3, padding="same",
                               **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return self.conv_out(self.act_out(x))


class Decoder(nn.Module):
    def __init__(self, cfg: CodecConfig, **common):
        super().__init__()
        dim = cfg.decoder_dim
        self.conv_in = WNConv(cfg.latent_dim, dim, 7, padding="same",
                              **common)
        self.n_blocks = len(cfg.decoder_rates)
        for i, r in enumerate(cfg.decoder_rates):
            self.add_module(f"block_{i}", DecoderBlock(dim, dim // 2, r,
                                                       **common))
            dim //= 2
        self.act_out = Snake(dim)
        self.conv_out = WNConv(dim, 1, 7, padding="same", **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return torch.tanh(self.conv_out(self.act_out(x)).float())


class VQStage(nn.Module):
    """One quantizer stage on the residual ``[B, latent, T]`` (fp32):
    ``(z_q [B, latent, T], commitment [B], codebook [B], codes [B, T])``."""

    def __init__(self, latent: int, size: int, dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        common = dict(generator=generator)
        self.in_proj = WNConv(latent, dim, 1, **common)
        self.out_proj = WNConv(dim, latent, 1, **common)
        self.codebook = nn.Parameter(
            torch.empty(size, dim).normal_(0.0, 1.0, generator=generator))

    def forward(self, z: torch.Tensor):
        z_e = self.in_proj(z)  # [B, D, T]
        b, d, t = z_e.shape
        flat = F.normalize(z_e.transpose(1, 2).reshape(b * t, d))
        book = F.normalize(self.codebook)
        dist = (flat.square().sum(1, keepdim=True) - 2 * flat @ book.t()
                + book.square().sum(1, keepdim=True).t())
        codes = dist.neg().argmax(1).view(b, t)
        z_q = F.embedding(codes, self.codebook).transpose(1, 2)
        commitment = (z_e - z_q.detach()).square().mean((1, 2))
        codebook = (z_q - z_e.detach()).square().mean((1, 2))
        z_q = z_e + (z_q - z_e).detach()  # straight through
        return self.out_proj(z_q), commitment, codebook, codes


class ResidualVQ(nn.Module):
    """``n_codebooks`` ``VQStage``s on the residual; ``forward(z, n_q)`` ->
    ``(z_q, commitment, codebook, codes [B, n_codebooks, T])``, a row
    keeping the stages ``i < n_q[row]`` (all where ``n_q`` is None)."""

    def __init__(self, cfg: CodecConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n = cfg.n_codebooks
        for i in range(self.n):
            self.add_module(f"stage_{i}", VQStage(
                cfg.latent_dim, cfg.codebook_size, cfg.codebook_dim,
                generator))

    def forward(self, z: torch.Tensor, n_q: torch.Tensor | None = None):
        z_q = torch.zeros_like(z)
        residual = z
        commitment = codebook = 0.0
        codes = []
        with region("rvq"):
            for i in range(self.n):
                rvq_stage.n_calls += 1
                zq_i, c_i, b_i, k_i = getattr(self, f"stage_{i}")(residual)
                if n_q is None:
                    z_q = z_q + zq_i
                    commitment = commitment + c_i.mean()
                    codebook = codebook + b_i.mean()
                else:
                    keep = (i < n_q).to(z.dtype)
                    z_q = z_q + zq_i * keep[:, None, None]
                    commitment = commitment + (c_i * keep).mean()
                    codebook = codebook + (b_i * keep).mean()
                residual = residual - zq_i
                codes.append(k_i)
        return z_q, commitment, codebook, torch.stack(codes, 1)


class Codec(nn.Module):
    """DAC: ``forward(wav [B, L], n_q=None)`` -> ``(wav [B, L] float32,
    commitment, codebook)``; ``encode`` and ``decode`` split it."""

    def __init__(self, cfg: CodecConfig = CodecConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        if math.prod(cfg.decoder_rates) != cfg.hop_length:
            raise ValueError(f"decoder rates {cfg.decoder_rates} do not "
                             f"undo encoder rates {cfg.encoder_rates}")
        self.cfg = cfg
        common = dict(compute_dtype=cfg.compute_dtype, generator=generator)
        self.encoder = Encoder(cfg, **common)
        self.quantizer = ResidualVQ(cfg, generator)
        self.decoder = Decoder(cfg, **common)

    def encode(self, wav: torch.Tensor, n_q: torch.Tensor | None = None):
        """``(z_q [B, latent, T] fp32, commitment, codebook, codes)`` of
        ``wav [B, L]``, padded on the right to ``T`` hops."""
        hop = self.cfg.hop_length
        x = F.pad(wav[:, None], (0, -wav.shape[-1] % hop))
        z = self.encoder(x).float()
        return self.quantizer(z, n_q)

    def decode(self, z_q: torch.Tensor) -> torch.Tensor:
        return self.decoder(z_q)[:, 0]

    def forward(self, wav: torch.Tensor, n_q: torch.Tensor | None = None):
        z_q, commitment, codebook, _ = self.encode(wav, n_q)
        return self.decode(z_q)[:, : wav.shape[-1]], commitment, codebook
