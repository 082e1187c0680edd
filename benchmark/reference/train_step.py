"""The plain reference of the stage-2 GAN step.

Written after the port's ``train/stage2.py::_update`` and
``train/state.py::Adam`` at commit 29bca4e (optax's Adam, the hinge GAN
losses, feature matching, the multi-resolution STFT loss, R1 on D(real),
the EMA of G), one player's gradient at a time with ``torch.autograd``,
no graphs, no kernels, nothing in place. D sees the real and the fake
batch in two calls (the port may concatenate them). The instance noise is
supported only where its sigma is 0 (past ``d_noise_decay_steps``), which
is where the benchmark's state is; the D step's real taps then still come
from a separate forward of the updated D on the clean batch, as the
port's step takes them whenever ``d_input_noise > 0``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from reference import audio
from reference.model import CombinedDiscriminator, Vocoder

__all__ = ["RefState", "models", "step"]


class RefState:
    """Parameters, Adam moments and counts, EMA, and the step count."""

    def __init__(self, g, d, step_count: int, g_count: int, d_count: int):
        self.g, self.d = dict(g), dict(d)
        self.g_mu = {k: torch.zeros_like(v) for k, v in g.items()}
        self.g_nu = {k: torch.zeros_like(v) for k, v in g.items()}
        self.d_mu = {k: torch.zeros_like(v) for k, v in d.items()}
        self.d_nu = {k: torch.zeros_like(v) for k, v in d.items()}
        self.ema = {k: v.clone() for k, v in g.items()}
        self.step, self.g_count, self.d_count = step_count, g_count, d_count


def models(cfg, lower: str | None = None):
    """G and D of ``cfg`` without storage, called with parameter dicts."""
    with torch.device("meta"):
        return (Vocoder(cfg.vocoder, lower),
                CombinedDiscriminator(cfg.msd, cfg.mrd, lower))


def _adam(params, grads, mu, nu, count: int, t):
    """optax.adam's update of ``params`` in fp32 (eps outside the root)."""
    b1, b2 = np.float32(t.adam_b1), np.float32(t.adam_b2)
    n = np.float32(count + 1)
    bc1, bc2 = float(1 - b1 ** n), float(1 - b2 ** n)
    out_p, out_mu, out_nu = {}, {}, {}
    for k, g in grads.items():
        m = g * (1.0 - t.adam_b1) + mu[k] * t.adam_b1
        v = g * g * (1.0 - t.adam_b2) + nu[k] * t.adam_b2
        upd = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
        out_p[k] = params[k] + upd * -t.lr
        out_mu[k], out_nu[k] = m, v
    return out_p, out_mu, out_nu


def _hinge_d(real, fake):
    return sum(torch.mean(F.relu(1.0 - r)) + torch.mean(F.relu(1.0 + f))
               for r, f in zip(real, fake))


def _fm(real, fake):
    pairs = [(r, f) for rh, fh in zip(real, fake) for r, f in zip(rh, fh)]
    return sum(torch.mean(torch.abs(f - r.detach())) for r, f in pairs) / len(
        pairs)


def step(cfg, s: RefState, wav: torch.Tensor, gen, disc,
         keep_grads: bool = False) -> dict:
    """One D and one G update of ``s`` in place (new tensors bound to its
    dicts) on the batch ``wav [B, L]``; returns ``d_loss``, ``g_loss`` (and
    G's loss terms ``g_adv``, ``g_fm``, ``g_stft``, unweighted, and with
    ``keep_grads`` both players' gradients)."""
    t = cfg.train
    if t.gan_loss != "hinge" or t.lambda_energy or t.lambda_phase \
            or t.grad_clip_norm or t.lr_decay_rate < 1.0:
        raise NotImplementedError("the reference follows hinge, FM, STFT, "
                                  "R1, Adam and EMA only")
    sigma = 0.0
    if t.d_input_noise > 0:
        frac = np.float32(s.step) / np.float32(max(t.d_noise_decay_steps, 1))
        sigma = float(np.float32(t.d_input_noise)
                      * max(np.float32(0), np.float32(1) - frac))
        if t.d_noise_decay_steps <= 0 or sigma != 0.0:
            raise NotImplementedError("instance noise with sigma > 0")
    gate = t.g_warmup_steps <= 0 or s.step >= t.g_warmup_steps
    with torch.no_grad():
        mel = ((audio.log_mel_for_vocoder(wav, cfg.frontend)
                - cfg.mel_scaler.shift) / cfg.mel_scaler.scale)
    g_in = {k: v.detach().requires_grad_() for k, v in s.g.items()}
    d_in = {k: v.detach().requires_grad_() for k, v in s.d.items()}
    fake = functional_call(gen, g_in, (mel,))

    # D step, on the detached fake.
    real_logits, real_feats = functional_call(disc, d_in, (wav,))
    fake_logits, _ = functional_call(disc, d_in, (fake.detach(),))
    d_loss = _hinge_d(real_logits, fake_logits)
    if t.r1_gamma > 0:
        x = wav.detach().requires_grad_()
        ls, _ = functional_call(disc, d_in, (x,))
        (gx,) = torch.autograd.grad(sum(l.float().sum() for l in ls), x,
                                    create_graph=True)
        d_loss = d_loss + 0.5 * t.r1_gamma * gx.float().square().sum(
            dim=tuple(range(1, gx.ndim))).mean()
    d_grads = dict(zip(d_in, torch.autograd.grad(d_loss, list(d_in.values()))))
    if gate:
        tt = _Lr(t, t.d_lr)
        s.d, s.d_mu, s.d_nu = _adam(s.d, d_grads, s.d_mu, s.d_nu, s.d_count,
                                    tt)
        s.d_count += 1

    # G step, against the updated D.
    fake_logits, fake_feats = functional_call(disc, s.d, (fake,))
    if t.reuse_real_features and t.d_input_noise == 0:
        target = real_feats
    else:
        with torch.no_grad():
            _, target = functional_call(disc, s.d, (wav,))
    adv = -sum(torch.mean(f) for f in fake_logits)
    fm = _fm(target, fake_feats)
    stft = audio.multires_stft_loss(fake, wav, cfg.stft_loss)
    total = ((adv + t.lambda_feature_matching * fm) * (1.0 if gate else 0.0)
             + t.lambda_stft * stft)
    g_grads = dict(zip(g_in, torch.autograd.grad(total, list(g_in.values()))))
    s.g, s.g_mu, s.g_nu = _adam(s.g, g_grads, s.g_mu, s.g_nu, s.g_count,
                                _Lr(t, t.g_lr))
    s.g_count += 1
    s.ema = {k: s.ema[k] * t.ema_decay + s.g[k] * (1.0 - t.ema_decay)
             for k in s.g}
    s.step += 1
    out = {"d_loss": d_loss.detach(), "g_loss": total.detach(),
           "g_adv": adv.detach(), "g_fm": fm.detach(),
           "g_stft": stft.detach()}
    if keep_grads:
        out["g_grads"], out["d_grads"] = g_grads, d_grads
    return out


class _Lr:
    """The Adam settings of one player."""

    def __init__(self, t, lr: float):
        self.adam_b1, self.adam_b2, self.lr = t.adam_b1, t.adam_b2, lr
