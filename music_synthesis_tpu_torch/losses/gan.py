"""Hinge, non-saturating and least-squares GAN losses, and feature
matching (counterpart of ``losses/gan.py``; the least-squares pair and the
summed feature matching are DAC's, which the JAX package has not, and
compute in fp32).

Discriminators return ``(logits, features)``: a list of logit tensors (one
per head) and a list (heads) of lists (layers) of feature tensors. Every
loss is a mean over elements, so it does not depend on the layout
(``[B, C, ...]`` here, channel-last in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "hinge_d_loss",
    "hinge_g_loss",
    "nonsat_d_loss",
    "nonsat_g_loss",
    "lsgan_d_loss",
    "lsgan_g_loss",
    "d_loss_fn",
    "g_loss_fn",
    "feature_matching_loss",
]


def _heads(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def hinge_d_loss(real_logits, fake_logits) -> torch.Tensor:
    """Sum over heads of ``mean(relu(1 - D(x))) + mean(relu(1 + D(G(z))))``."""
    loss = 0.0
    for r, f in zip(_heads(real_logits), _heads(fake_logits)):
        loss = loss + torch.mean(F.relu(1.0 - r)) + torch.mean(F.relu(1.0 + f))
    return loss


def hinge_g_loss(fake_logits) -> torch.Tensor:
    """Sum over heads of ``-mean(D(G(z)))``."""
    loss = 0.0
    for f in _heads(fake_logits):
        loss = loss - torch.mean(f)
    return loss


def nonsat_d_loss(real_logits, fake_logits) -> torch.Tensor:
    """Sum over heads of ``mean(softplus(-D(x))) + mean(softplus(D(G(z))))``:
    the logistic loss, which has no flat region."""
    loss = 0.0
    for r, f in zip(_heads(real_logits), _heads(fake_logits)):
        loss = loss + torch.mean(F.softplus(-r)) + torch.mean(F.softplus(f))
    return loss


def nonsat_g_loss(fake_logits) -> torch.Tensor:
    """Sum over heads of ``mean(softplus(-D(G(z))))``."""
    loss = 0.0
    for f in _heads(fake_logits):
        loss = loss + torch.mean(F.softplus(-f))
    return loss


def lsgan_d_loss(real_logits, fake_logits) -> torch.Tensor:
    """Sum over heads of ``mean(D(G(z))^2) + mean((1 - D(x))^2)``."""
    loss = 0.0
    for r, f in zip(_heads(real_logits), _heads(fake_logits)):
        loss = (loss + torch.mean(torch.square(f.float()))
                + torch.mean(torch.square(1.0 - r.float())))
    return loss


def lsgan_g_loss(fake_logits) -> torch.Tensor:
    """Sum over heads of ``mean((1 - D(G(z)))^2)``."""
    loss = 0.0
    for f in _heads(fake_logits):
        loss = loss + torch.mean(torch.square(1.0 - f.float()))
    return loss


def d_loss_fn(kind: str):
    """'hinge', 'nonsat' or 'lsgan'."""
    return {"hinge": hinge_d_loss, "nonsat": nonsat_d_loss,
            "lsgan": lsgan_d_loss}[kind]


def g_loss_fn(kind: str):
    """The generator loss matching :func:`d_loss_fn`'s ``kind``."""
    return {"hinge": hinge_g_loss, "nonsat": nonsat_g_loss,
            "lsgan": lsgan_g_loss}[kind]


def feature_matching_loss(real_features, fake_features,
                          reduction: str = "mean") -> torch.Tensor:
    """Mean over layers and heads of ``mean |fake - real|``, the real taps
    detached, so that the loss trains only the generator; with
    ``reduction="sum"`` their sum, each term in fp32 (DAC's). Takes a list
    of heads of lists of tensors, or one list of tensors."""
    if real_features and not isinstance(real_features[0], (list, tuple)):
        real_features, fake_features = [real_features], [fake_features]
    if reduction == "sum":
        return sum(torch.mean(torch.abs(f.float() - r.detach().float()))
                   for r_head, f_head in zip(real_features, fake_features)
                   for r, f in zip(r_head, f_head))
    if reduction != "mean":
        raise ValueError(f"unknown reduction {reduction!r}")
    loss = 0.0
    n = 0
    for r_head, f_head in zip(real_features, fake_features):
        for r, f in zip(r_head, f_head):
            loss = loss + torch.mean(torch.abs(f - r.detach()))
            n += 1
    return loss / max(n, 1)
