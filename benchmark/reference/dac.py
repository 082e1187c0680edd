"""The plain reference of DAC, the Descript Audio Codec at 44.1 kHz (Kumar
et al., arXiv:2306.06546; github.com/descriptinc/descript-audio-codec:
``dac/model/dac.py``, ``dac/nn/quantize.py``, ``dac/model/discriminator.py``,
``dac/nn/loss.py``, ``scripts/train.py`` and ``conf/base.yml``), written
from its equations in plain PyTorch: nothing of the program, no JAX. The
tests hold the program to it too (``tests/test_torch_dac.py``). The
equations:

- Snake ``x + sin(alpha x)^2 / (alpha + 1e-9)``, ``alpha`` per channel;
- every conv weight-normed, ``w = g v / ||v||`` (the norm per output
  channel; per input channel for a transposed conv, as
  ``torch.nn.utils.weight_norm`` normalises a ``ConvTranspose1d``);
- encoder: k7 conv (pad 3) to 64; per rate r of [2, 4, 8, 8] three
  residual units ``x + conv1(snake(conv7_d(snake(x))))`` (d = 1, 3, 9,
  pad 3d) at half the block's width, Snake, a conv of kernel 2r, stride r,
  pad ceil(r/2) doubling the width; Snake, a k3 conv (pad 1) to 1024;
- quantizer: 9 stages; each projects the residual to 8 dimensions (k1
  conv), picks per frame the code of least Euclidean distance between the
  l2-normalised projection and the l2-normalised codebook (1024 x 8),
  takes that raw code, ``z_e + (z_q - z_e).detach()``, projects back;
  ``residual -= stage``; commitment ``mse(z_e, sg(z_q))`` and codebook
  ``mse(z_q, sg(z_e))`` per row; a row keeps the stages below its count,
  its losses masked the same, each averaged over the rows and summed over
  the stages;
- decoder: k7 conv to 1536; per rate r of [8, 8, 4, 2] Snake, a
  transposed conv of kernel 2r, stride r, pad ceil(r/2) halving the
  width, three residual units; Snake, a k7 conv to 1, tanh;
- G pads the input on the right to a multiple of 512 and cuts its output
  back to the input's length;
- D on ``0.8 (x - mean) / (max |x - mean| + 1e-9)`` per row: MPD of
  periods 2, 3, 5, 7, 11 (reflect-pad by ``p - L % p``, fold to ``[B, 1,
  L/p, p]``, (5, 1) convs of stride (3, 1) to 32, 128, 512, 1024, then 1024
  at stride 1, pad (2, 0), leaky ReLU 0.1, a (3, 1) post conv); MRD at
  windows 2048, 1024, 512 (audiotools' ``match_stride`` STFT at a quarter
  hop: reflect-pad ``(w - h) / 2`` and ``ceil(L / h) h - L`` more on the
  right, ``torch.stft`` centred, two frames dropped at each end; its real
  and imaginary parts as 2 channels; the bins cut into the bands [0, .1,
  .25, .5, .75, 1] of ``w / 2 + 1``; per band (3, 9) convs of strides
  (1, 1), (1, 2), (1, 2), (1, 2) and a (3, 3), 32 channels, leaky ReLU 0.1;
  the bands joined along frequency, a (3, 3) post conv);
- LSGAN: D ``sum mean(D(fake)^2) + mean((1 - D(real))^2)``, G ``sum
  mean((1 - D(fake))^2)``; feature matching the sum over heads and layers
  of the L1 means against the updated D's taps on the real batch;
- mel loss: for windows 32 .. 2048 with 5 .. 320 mels, ``torch.stft``
  centred (reflect), periodic Hann, hop a quarter, ``|S|``, librosa's
  Slaney filterbank to Nyquist, ``log10(clamp(., 1e-5))``, L1 mean, summed;
- G's loss ``15 mel + 2 fm + adv + 0.25 commitment + codebook``;
- both players: gradients clipped as ``clip_grad_norm_`` (coefficient
  ``max / (norm + 1e-6)`` where under 1; G at 1e3, D at 10), AdamW
  (0.8, 0.99), eps 1e-8, weight decay 0.01, ``lr = 1e-4 * 0.999996 **
  count`` (``ExponentialLR`` stepped once a step).

Departures from upstream, on purpose:

- convolutions run in the configuration's ``compute_dtype`` (bf16: their
  input, kernel and bias cast), each activation's output travelling in
  the dtype of its input, as the program's; Snake, the VQ, the mel loss
  and the GAN losses compute in fp32 (upstream trains in fp32);
- the quantizer-dropout draw is given (``keep``, the program's draw), as
  ``reference/train_step.py`` takes instance noise;
- parameters carry the program's names and layouts (``v`` ``[*K, Cin,
  Cout]``, flipped in time for a transposed conv; ``alpha`` ``[C]``;
  ``codebook`` ``[size, dim]``), so one set of tensors loads into both;
- ``lower="fp8"`` (the control) rounds each convolution's input and kernel
  to float8 e4m3 with a per-tensor scale, the gradient passing straight
  through, as ``reference/model.py`` does.

The configuration is an attribute namespace with the program's field
names (``harness.config.ns``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from reference import audio
from reference.model import _fp8, strict_fp32
from reference.train_step import RefState

__all__ = ["Codec", "Discriminator", "RefState", "models", "step",
           "mel_loss", "snake", "match_stride_stft", "clip_coefficient"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a = alpha.float()[:, None]
    y = x.float() + (a + 1e-9).reciprocal() * torch.sin(a * x.float()) ** 2
    return y.to(x.dtype)


class _Snake(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return snake(x, self.alpha)


class _Conv(nn.Module):
    """A weight-normed conv (1-D, or 2-D with tuple kernels) with explicit
    zero padding, or a transposed 1-D one."""

    def __init__(self, cin, cout, k, *, stride=1, dilation=1, padding=0,
                 transposed=False, dtype="float32", lower=None):
        super().__init__()
        ks = (k,) if isinstance(k, int) else tuple(k)
        self.v = nn.Parameter(torch.empty(*ks, cin, cout))
        self.g = nn.Parameter(torch.empty(cin if transposed else cout))
        self.b = nn.Parameter(torch.empty(cout))
        self.stride, self.dilation, self.padding = stride, dilation, padding
        self.t, self.dtype, self.lower = transposed, _DTYPES[dtype], lower

    def _cast(self, x):
        x = x.to(self.dtype)
        return _fp8(x) if self.lower == "fp8" else x

    def forward(self, x):
        v, n = self.v, self.v.ndim
        if self.t:
            w = self.g[None, :, None] * v / torch.sqrt(
                (v * v).sum((0, 2), keepdim=True) + 1e-12)
            w = w.flip(0).permute(1, 2, 0)  # [Cin, Cout, K]
            return F.conv_transpose1d(
                self._cast(x), self._cast(w), self.b.to(self.dtype),
                stride=self.stride, padding=self.padding)
        w = self.g * v / torch.sqrt((v * v).sum(tuple(range(n - 1))) + 1e-12)
        w = w.permute(n - 1, n - 2, *range(n - 2))  # [Cout, Cin, *K]
        conv = F.conv1d if n == 3 else F.conv2d
        return conv(self._cast(x), self._cast(w), self.b.to(self.dtype),
                    stride=self.stride, padding=self.padding,
                    dilation=self.dilation)


class _ResUnit(nn.Module):
    def __init__(self, c, d, conv):
        super().__init__()
        self.act1 = _Snake(c)
        self.conv1 = conv(c, c, 7, dilation=d, padding=3 * d)
        self.act2 = _Snake(c)
        self.conv2 = conv(c, c, 1)

    def forward(self, x):
        return x + self.conv2(self.act2(self.conv1(self.act1(x))))


class _EncBlock(nn.Module):
    def __init__(self, dim, r, conv):
        super().__init__()
        for d in (1, 3, 9):
            self.add_module(f"res_d{d}", _ResUnit(dim // 2, d, conv))
        self.act = _Snake(dim // 2)
        self.down = conv(dim // 2, dim, 2 * r, stride=r,
                         padding=math.ceil(r / 2))

    def forward(self, x):
        for d in (1, 3, 9):
            x = getattr(self, f"res_d{d}")(x)
        return self.down(self.act(x))


class _DecBlock(nn.Module):
    def __init__(self, cin, cout, r, conv):
        super().__init__()
        self.act = _Snake(cin)
        self.up = conv(cin, cout, 2 * r, stride=r, padding=math.ceil(r / 2),
                       transposed=True)
        for d in (1, 3, 9):
            self.add_module(f"res_d{d}", _ResUnit(cout, d, conv))

    def forward(self, x):
        x = self.up(self.act(x))
        for d in (1, 3, 9):
            x = getattr(self, f"res_d{d}")(x)
        return x


class _Encoder(nn.Module):
    def __init__(self, c, conv):
        super().__init__()
        dim = c.encoder_dim
        self.conv_in = conv(1, dim, 7, padding=3)
        self.rates = tuple(c.encoder_rates)
        for i, r in enumerate(self.rates):
            dim *= 2
            self.add_module(f"block_{i}", _EncBlock(dim, r, conv))
        self.act_out = _Snake(dim)
        self.conv_out = conv(dim, c.latent_dim, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for i in range(len(self.rates)):
            x = getattr(self, f"block_{i}")(x)
        return self.conv_out(self.act_out(x))


class _Decoder(nn.Module):
    def __init__(self, c, conv):
        super().__init__()
        dim = c.decoder_dim
        self.conv_in = conv(c.latent_dim, dim, 7, padding=3)
        self.rates = tuple(c.decoder_rates)
        for i, r in enumerate(self.rates):
            self.add_module(f"block_{i}", _DecBlock(dim, dim // 2, r, conv))
            dim //= 2
        self.act_out = _Snake(dim)
        self.conv_out = conv(dim, 1, 7, padding=3)

    def forward(self, x):
        x = self.conv_in(x)
        for i in range(len(self.rates)):
            x = getattr(self, f"block_{i}")(x)
        return torch.tanh(self.conv_out(self.act_out(x)).float())


class _VQ(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.in_proj = _Conv(c.latent_dim, c.codebook_dim, 1)
        self.out_proj = _Conv(c.codebook_dim, c.latent_dim, 1)
        self.codebook = nn.Parameter(torch.empty(c.codebook_size,
                                                 c.codebook_dim))

    def forward(self, z):
        z_e = self.in_proj(z)
        b, d, t = z_e.shape
        enc = F.normalize(z_e.transpose(1, 2).reshape(b * t, d))
        book = F.normalize(self.codebook)
        dist = (enc.pow(2).sum(1, keepdim=True) - 2 * enc @ book.t()
                + book.pow(2).sum(1, keepdim=True).t())
        idx = (-dist).max(1)[1].view(b, t)
        z_q = F.embedding(idx, self.codebook).transpose(1, 2)
        commit = F.mse_loss(z_e, z_q.detach(), reduction="none").mean([1, 2])
        book_loss = F.mse_loss(z_q, z_e.detach(),
                               reduction="none").mean([1, 2])
        z_q = z_e + (z_q - z_e).detach()
        return self.out_proj(z_q), commit, book_loss


class Codec(nn.Module):
    """``forward(wav [B, L], keep [B] or None)`` -> ``(wav [B, L] fp32,
    commitment, codebook)``."""

    def __init__(self, c, lower: str | None = None):
        super().__init__()

        def conv(cin, cout, k, **kw):
            return _Conv(cin, cout, k, dtype=c.compute_dtype, lower=lower,
                         **kw)

        self.hop = int(np.prod(c.encoder_rates))
        self.n = c.n_codebooks
        self.encoder = _Encoder(c, conv)
        self.quantizer = nn.Module()
        for i in range(self.n):
            self.quantizer.add_module(f"stage_{i}", _VQ(c))
        self.decoder = _Decoder(c, conv)

    def forward(self, wav, keep=None):
        length = wav.shape[-1]
        right = math.ceil(length / self.hop) * self.hop - length
        z = self.encoder(F.pad(wav[:, None], (0, right))).float()
        if keep is None:
            keep = torch.full((z.shape[0],), float(self.n), device=z.device)
        z_q, residual = 0, z
        commit = book = 0
        for i in range(self.n):
            zq_i, c_i, b_i = getattr(self.quantizer, f"stage_{i}")(residual)
            mask = (torch.full((z.shape[0],), i, device=z.device) < keep)
            z_q = z_q + zq_i * mask[:, None, None]
            residual = residual - zq_i
            commit = commit + (c_i * mask).mean()
            book = book + (b_i * mask).mean()
        return self.decoder(z_q)[:, 0, :length], commit, book


def match_stride_stft(x: torch.Tensor, w: int, hop: int) -> torch.Tensor:
    """audiotools' ``stft`` with ``match_stride``: ``[B, 2, T, F]`` real
    and imaginary parts."""
    length = x.shape[-1]
    right = math.ceil(length / hop) * hop - length
    pad = (w - hop) // 2
    x = F.pad(x[:, None], (pad, pad + right), mode="reflect")[:, 0]
    s = torch.stft(x, n_fft=w, hop_length=hop,
                   window=torch.hann_window(w, device=x.device),
                   center=True, pad_mode="reflect", return_complex=True)
    s = torch.view_as_real(s[..., 2:-2])  # [B, F, T, 2]
    return s.permute(0, 3, 2, 1)


class _MPD(nn.Module):
    def __init__(self, p, c, lower):
        super().__init__()
        self.p = p
        cin = 1
        for i, (ch, st) in enumerate(zip(c.channels, (3, 3, 3, 3, 1))):
            self.add_module(f"conv_{i}", _Conv(
                cin, ch, (5, 1), stride=(st, 1), padding=(2, 0),
                dtype=c.compute_dtype, lower=lower))
            cin = ch
        self.n = len(c.channels)
        self.conv_out = _Conv(cin, 1, (3, 1), padding=(1, 0),
                              dtype=c.compute_dtype, lower=lower)

    def forward(self, x):
        t = x.shape[-1]
        x = F.pad(x[:, None], (0, self.p - t % self.p), mode="reflect")
        x = x.view(x.shape[0], 1, -1, self.p)
        feats = []
        for i in range(self.n):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), 0.1)
            feats.append(x)
        return self.conv_out(x), feats


_MRD_LAYERS = (((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)),
               ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
               ((3, 3), (1, 1), (1, 1)))


class _MRD(nn.Module):
    def __init__(self, w, hop, c, lower):
        super().__init__()
        self.w, self.hop, self.slope = w, hop, c.leaky_slope
        n = w // 2 + 1
        self.bands = [(int(lo * n), int(hi * n)) for lo, hi in c.bands]
        common = dict(dtype=c.compute_dtype, lower=lower)
        for j in range(len(self.bands)):
            stack = nn.Module()
            cin = 2
            for i, (k, st, pad) in enumerate(_MRD_LAYERS):
                stack.add_module(f"conv_{i}", _Conv(
                    cin, c.channels, k, stride=st, padding=pad, **common))
                cin = c.channels
            self.add_module(f"band_{j}", stack)
        self.conv_out = _Conv(c.channels, 1, (3, 3), padding=(1, 1),
                              **common)

    def forward(self, x):
        s = match_stride_stft(x, self.w, self.hop)
        feats, outs = [], []
        for j, (lo, hi) in enumerate(self.bands):
            y = s[..., lo:hi]
            for i in range(len(_MRD_LAYERS)):
                y = F.leaky_relu(getattr(getattr(self, f"band_{j}"),
                                         f"conv_{i}")(y), self.slope)
                feats.append(y)
            outs.append(y)
        return self.conv_out(torch.cat(outs, -1)), feats


class Discriminator(nn.Module):
    """MPD then MRD on the peak-normalised input: wav ``[B, L]`` ->
    (logits, features per head)."""

    def __init__(self, mpd, mrd, peak: float, lower: str | None = None):
        super().__init__()
        self.peak = peak
        self.mpd = nn.Module()
        for p in mpd.periods:
            self.mpd.add_module(f"period_{p}", _MPD(p, mpd, lower))
        self.mrd = nn.Module()
        for w, hop, _ in mrd.resolutions:
            self.mrd.add_module(f"res_{w}", _MRD(w, hop, mrd, lower))

    def forward(self, y):
        y = y - y.mean(dim=-1, keepdim=True)
        y = self.peak * y / (y.abs().max(dim=-1, keepdim=True)[0] + 1e-9)
        logits, feats = [], []
        for part in (self.mpd, self.mrd):
            for head in part.children():
                logit, f = head(y)
                logits.append(logit)
                feats.append(f)
        return logits, feats


def mel_loss(x: torch.Tensor, y: torch.Tensor, sr: int) -> torch.Tensor:
    loss = 0.0
    for w, n in zip((32, 64, 128, 256, 512, 1024, 2048),
                    (5, 10, 20, 40, 80, 160, 320)):
        fb = torch.from_numpy(audio.mel_matrix(sr, w, n, 0.0, None)).to(
            x.device)

        def logmel(a):
            s = torch.stft(a.float(), n_fft=w, hop_length=w // 4,
                           window=torch.hann_window(w, device=a.device),
                           center=True, pad_mode="reflect",
                           return_complex=True)
            mel = s.abs().transpose(1, 2) @ fb
            return mel.clamp(1e-5).log10()

        loss = loss + F.l1_loss(logmel(x), logmel(y))
    return loss


def models(cfg, lower: str | None = None):
    """G and D of ``cfg`` without storage, called with parameter dicts."""
    with torch.device("meta"):
        return (Codec(cfg.codec, lower),
                Discriminator(cfg.mpd, cfg.mrd, cfg.train.d_input_peak,
                              lower))


def clip_coefficient(grads: dict, max_norm: float) -> torch.Tensor:
    """``clip_grad_norm_``'s factor: ``min(1, max / (norm + 1e-6))``."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def _adamw(params, grads, mu, nu, count: int, t, lr0: float, clip: float):
    coef = clip_coefficient(grads, clip)
    b1, b2 = t.adam_b1, t.adam_b2
    lr = lr0 * t.lr_decay_rate ** (count / t.lr_decay_every)
    bc1, bc2 = 1 - b1 ** (count + 1), 1 - b2 ** (count + 1)
    out_p, out_mu, out_nu = {}, {}, {}
    for k, g in grads.items():
        g = g * coef
        m = mu[k] * b1 + g * (1 - b1)
        v = nu[k] * b2 + g * g * (1 - b2)
        p = params[k] * (1 - lr * t.weight_decay)
        out_p[k] = p - lr * (m / bc1) / (v.sqrt() / math.sqrt(bc2) + 1e-8)
        out_mu[k], out_nu[k] = m, v
    return out_p, out_mu, out_nu


def step(cfg, s: RefState, wav: torch.Tensor, gen, disc, keep=None,
         keep_grads: bool = False) -> dict:
    """One D and one G update of ``s`` on ``wav [B, L]`` with the
    quantizer counts ``keep [B]`` (all stages where None), matrix products
    and convolutions in full fp32 (both TF32 switches off); returns the
    losses (``d_loss``, ``g_loss``, ``g_adv``, ``g_fm``, ``g_mel``,
    ``g_commitment``, ``g_codebook``) and with ``keep_grads`` both
    players' first gradients (before the clip)."""
    with strict_fp32():
        return _step(cfg, s, wav, gen, disc, keep, keep_grads)


def _step(cfg, s: RefState, wav, gen, disc, keep, keep_grads: bool) -> dict:
    t = cfg.train
    g_in = {k: v.detach().requires_grad_() for k, v in s.g.items()}
    d_in = {k: v.detach().requires_grad_() for k, v in s.d.items()}
    fake, commit, book = functional_call(gen, g_in, (wav, keep))

    d_fake, _ = functional_call(disc, d_in, (fake.detach(),))
    d_real, _ = functional_call(disc, d_in, (wav,))
    d_loss = 0
    for f, r in zip(d_fake, d_real):
        d_loss = d_loss + torch.mean(f.float() ** 2)
        d_loss = d_loss + torch.mean((1 - r.float()) ** 2)
    d_grads = dict(zip(d_in, torch.autograd.grad(d_loss,
                                                 list(d_in.values()))))
    s.d, s.d_mu, s.d_nu = _adamw(s.d, d_grads, s.d_mu, s.d_nu, s.d_count, t,
                                 t.d_lr, t.d_grad_clip_norm)
    s.d_count += 1

    g_fake, f_feats = functional_call(disc, s.d, (fake,))
    _, r_feats = functional_call(disc, s.d, (wav,))
    adv = 0
    for f in g_fake:
        adv = adv + torch.mean((1 - f.float()) ** 2)
    fm = 0
    for fh, rh in zip(f_feats, r_feats):
        for f, r in zip(fh, rh):
            fm = fm + F.l1_loss(f.float(), r.detach().float())
    mel = mel_loss(fake, wav, cfg.frontend.sample_rate)
    total = (t.lambda_mel * mel + t.lambda_feature_matching * fm + adv
             + t.lambda_commitment * commit + t.lambda_codebook * book)
    g_grads = dict(zip(g_in, torch.autograd.grad(total,
                                                 list(g_in.values()))))
    s.g, s.g_mu, s.g_nu = _adamw(s.g, g_grads, s.g_mu, s.g_nu, s.g_count, t,
                                 t.g_lr, t.g_grad_clip_norm)
    s.g_count += 1
    s.ema = dict(s.g)
    s.step += 1
    out = {"d_loss": d_loss.detach(), "g_loss": total.detach(),
           "g_adv": adv.detach(), "g_fm": fm.detach(), "g_mel": mel.detach(),
           "g_commitment": commit.detach(), "g_codebook": book.detach()}
    if keep_grads:
        out["g_grads"], out["d_grads"] = g_grads, d_grads
    return out
