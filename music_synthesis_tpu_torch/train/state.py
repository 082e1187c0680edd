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

``InPlaceStep`` is what both stages' ``GraphedStep`` share: the state
donated into buffers the step owns, updated in place by one CUDA graph on
a card, by the same arithmetic run eagerly on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from music_synthesis_tpu_torch._graphs import GraphedProgram
from music_synthesis_tpu_torch.config import TrainConfig

__all__ = ["AdamState", "GANState", "Adam", "make_optimizer", "global_norm",
           "state_groups", "assign", "next_state", "InPlaceStep",
           "cached_step", "drop_graphed_steps"]


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


def state_groups(state: GANState) -> list[dict[str, torch.Tensor]]:
    """The state's tensors by group: G, D, both Adam moments, the EMA."""
    groups = [state.g_params, state.d_params, state.g_opt.mu, state.g_opt.nu,
              state.d_opt.mu, state.d_opt.nu]
    return groups + ([state.g_ema] if state.g_ema is not None else [])


def assign(state: GANState, g_params, d_params, g_opt: AdamState,
           d_opt: AdamState, g_ema) -> None:
    """Copies a step's new tensors into ``state``'s, in place."""
    new = GANState(state.step, g_params, d_params, g_opt, d_opt, state.rng,
                   g_ema)
    olds, news = state_groups(state), state_groups(new)
    torch._foreach_copy_([t for old in olds for t in old.values()],
                         [nw[k] for old, nw in zip(olds, news) for k in old])


def _fresh(state: GANState) -> GANState:
    """A state of new, unfilled tensors laid out as ``state``'s."""
    def empty(d):
        return None if d is None else {k: torch.empty_like(v)
                                       for k, v in d.items()}

    return GANState(
        state.step, empty(state.g_params), empty(state.d_params),
        AdamState(state.g_opt.count, empty(state.g_opt.mu),
                  empty(state.g_opt.nu)),
        AdamState(state.d_opt.count, empty(state.d_opt.mu),
                  empty(state.d_opt.nu)),
        state.rng, empty(state.g_ema))


def next_state(state: GANState, rng: torch.Generator, d_count: int,
               g_params, d_params, g_opt: AdamState, d_opt: AdamState,
               g_ema) -> GANState:
    """The state after a step from ``state``: new tensors in the layouts of
    ``state``'s holding the step's results (which come in the layouts of
    their gradients: a weight norm's sum over a parameter rounds by the
    parameter's strides, so a state whose layouts drifted from step to step
    would not round as the in-place step's fixed buffers do), the step and
    G's Adam count one further, D's Adam count ``d_count``."""
    out = _fresh(state)
    assign(out, g_params, d_params, g_opt, d_opt, g_ema)
    out.step, out.rng = state.step + 1, rng
    out.g_opt.count, out.d_opt.count = state.g_opt.count + 1, d_count
    return out


class InPlaceStep:
    """A single-process training step in place, for one config and batch
    shape on one device: on a CUDA device one CUDA graph of ``body`` (the
    reference's ``jax.jit(train_step, donate_argnums=1)``), timed by the
    tracer under ``label`` (``utils.profiling``), on the CPU ``body`` run
    eagerly.

    ``body(buffers, *inputs)`` updates the state ``buffers`` in place and
    returns the metrics, tensors. The state's tensors live in buffers this
    object owns: ``load`` copies the given state into them, unless it is
    the state the last call returned. So, as with the reference's donated
    state, a state is no longer valid once a later step has run from it or
    from any state of the same buffers: copy what must outlive the step.
    On a card the inputs go to the device without a host synchronisation,
    so steps run back to back until their metrics are read.
    """

    def __init__(self, body, device: torch.device | str, label: str):
        self.body = body
        self.device = torch.device(device)
        self.label = label
        self.buffers: GANState | None = None
        self.program = None

    def _adopt(self, state: GANState) -> GANState:
        if self.buffers is None:
            self.buffers = _fresh(state)
        with torch.no_grad():
            for buf, given in zip(state_groups(self.buffers),
                                  state_groups(state)):
                if given is not buf:
                    torch._foreach_copy_(list(buf.values()),
                                         [given[k] for k in buf])
        return self.buffers

    def load(self, state: GANState, *inputs: torch.Tensor):
        """Adopts ``state`` into the buffers and ``inputs`` into the step;
        returns the call that runs ``body`` on them (the graph's replay on
        a card, whose metrics are the graph's buffers: read them before
        the next call)."""
        buffers = self._adopt(state)
        if self.device.type != "cuda":
            return functools.partial(self.body, buffers, *(
                a.to(self.device) for a in inputs))
        inputs = [a if a.is_cuda else
                  a.pin_memory().to(self.device, non_blocking=True)
                  for a in inputs]
        if self.program is None:
            self.program = GraphedProgram(
                functools.partial(self.body, buffers), self.device,
                mutates=[t for g in state_groups(buffers) for t in g.values()],
                label=self.label)
        self.program.load(*inputs)
        return self.program.replay

    def advanced(self, state: GANState, rng: torch.Generator,
                 d_count: int) -> GANState:
        """The buffers as the state after a step from ``state``: its step
        and G's Adam count one further, D's Adam count ``d_count``."""
        b = self.buffers
        return dataclasses.replace(
            b, step=state.step + 1, rng=rng,
            g_opt=AdamState(state.g_opt.count + 1, b.g_opt.mu, b.g_opt.nu),
            d_opt=AdamState(d_count, b.d_opt.mu, b.d_opt.nu))


#: Every cache of steps that ``cached_step`` has filled in this process.
_CACHES: list[dict] = []


def cached_step(steps: dict, key, make, limit: int = 4):
    """``steps[key]``, made by ``make()`` if missing; the oldest entries
    beyond ``limit`` are dropped (with their graphs and pools).

    A data-parallel step's graph holds its group's collectives, so the
    ranks must build (warm up and capture), replay and drop their graphs
    in the same order: each rank calls the same steps with the same keys
    in the same order, or the collectives of one rank's warm-up or replay
    pair with another's of another program and hang."""
    if not any(c is steps for c in _CACHES):
        _CACHES.append(steps)
    step = steps.pop(key, None) or make()
    steps[key] = step
    while len(steps) > limit:
        del steps[next(iter(steps))]
    return step


def drop_graphed_steps() -> None:
    """Drops every step that ``cached_step`` holds in this process, with
    its graph and pool (``parallel.mesh.leave`` calls it before the group
    is destroyed), after the card has run every replay it was given."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for steps in _CACHES:
        steps.clear()
