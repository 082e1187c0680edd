"""GAN training state and optimizer (counterpart of ``train/state.py``).

``GANState`` holds both players' parameters (name -> tensor dicts in the
Flax tree's flattened names, as ``convert.to_state_dict`` gives them), both
Adam states, the step, the EMA of G and a ``torch.Generator`` for the
instance noise. The modules themselves are not in the state
(``stage2.make_models``), so the state is plain data: it checkpoints with
``torch.save`` and converts one to one from the JAX package's optax state.

``Adam`` reproduces ``optax.adam`` (with ``clip_by_global_norm`` first when
``grad_clip_norm > 0`` and ``exponential_decay`` when ``lr_decay_rate <
1``) operation for operation, in fp32, with ``torch._foreach_*``. The step
and Adam counts are host integers, so the warmup gate, the learning-rate
schedule and the bias corrections cost no device synchronisation; the
scalars they give are rounded to fp32 as optax computes them
(``Adam.scalars``), and a step captured as a CUDA graph reads them from 0-d
device tensors filled before each replay.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from music_synthesis_tpu_torch.config import TrainConfig

__all__ = ["AdamState", "GANState", "Adam", "make_optimizer", "global_norm"]


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: updates taken, first and second
    moments."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass
class GANState:
    step: int
    g_params: dict[str, torch.Tensor]
    d_params: dict[str, torch.Tensor]
    g_opt: AdamState
    d_opt: AdamState
    rng: torch.Generator
    # EMA of g_params when cfg.train.ema_decay > 0, else None.
    g_ema: dict[str, torch.Tensor] | None = None


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of every tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _f32(x) -> float:
    """``x`` rounded to fp32, as a Python float (exact in fp32)."""
    return float(np.float32(x))


class Adam:
    """``optax.adam(lr, b1, b2)`` (eps 1e-8 outside the square root), with
    the config's optional clip and continuous exponential lr decay."""

    eps = 1e-8

    def __init__(self, lr: float, cfg: TrainConfig):
        self.lr = lr
        self.b1, self.b2 = cfg.adam_b1, cfg.adam_b2
        self.decay_rate = cfg.lr_decay_rate
        self.decay_every = max(cfg.lr_decay_every, 1)
        self.clip = cfg.grad_clip_norm

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()})

    def learning_rate(self, count: int) -> float:
        """``exponential_decay(lr, every, rate)`` at the Adam count before
        this update (constant when ``lr_decay_rate >= 1``)."""
        if self.decay_rate >= 1.0 or count <= 0:
            return _f32(self.lr)
        p = np.float32(count) / np.float32(self.decay_every)
        return _f32(np.float32(self.lr)
                    * np.power(np.float32(self.decay_rate), p))

    def scalars(self, count: int) -> tuple[float, float, float]:
        """``(lr, bc1, bc2)`` of the update after ``count`` updates: the
        learning rate at ``count`` and both bias corrections at
        ``count + 1``, fp32 values as optax computes them."""
        b1, b2, t = np.float32(self.b1), np.float32(self.b2), np.float32(
            count + 1)
        return (self.learning_rate(count),
                _f32(np.float32(1.0) - b1 ** t),
                _f32(np.float32(1.0) - b2 ** t))

    def update(self, named_grads: dict[str, torch.Tensor], state: AdamState,
               scalars=None) -> tuple[list[torch.Tensor], AdamState]:
        """``(updates, new_state)``: the updates in ``named_grads``' order,
        already carrying ``-lr``. Nothing is changed in place. ``scalars``:
        ``self.scalars(state.count)``, as floats or 0-d fp32 tensors (a
        captured step reads them from the device), computed here if not
        given."""
        names = list(named_grads)
        grads = list(named_grads.values())
        if self.clip > 0:
            norm = global_norm(grads)
            keep = norm < self.clip
            grads = [torch.where(keep, g, g / norm * self.clip) for g in grads]
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(
            torch._foreach_mul(grads, 1.0 - b1),
            torch._foreach_mul([state.mu[k] for k in names], b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2),
            torch._foreach_mul([state.nu[k] for k in names], b2))
        lr, bc1, bc2 = (self.scalars(state.count) if scalars is None
                        else scalars)
        denom = torch._foreach_sqrt(_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(_div(mu, bc1), denom)
        torch._foreach_mul_(updates, -lr)
        return updates, AdamState(state.count + 1, dict(zip(names, mu)),
                                  dict(zip(names, nu)))


def _div(tensors: list[torch.Tensor], scalar) -> list[torch.Tensor]:
    """``tensors / scalar`` with the bits of eager PyTorch's division by a
    host float: on a card that is a multiply by the scalar's fp32
    reciprocal (how CUDA divides by a CPU scalar), on the CPU a division.
    A 0-d device tensor ``scalar`` (a captured step's) gets the same
    arithmetic, so the graph computes the eager step's bits."""
    if isinstance(scalar, torch.Tensor) and scalar.is_cuda:
        return torch._foreach_mul(tensors, torch.reciprocal(scalar))
    return torch._foreach_div(tensors, scalar)


def make_optimizer(lr: float, cfg: TrainConfig) -> Adam:
    """Adam with the GAN betas of ``cfg`` (0.5, 0.9 by default)."""
    return Adam(lr, cfg)
