"""GAN training state, optimizer and the step engine of both GAN stages
(counterpart of ``train/state.py``).

``GANState`` holds both players' parameters (name -> tensor dicts in the
Flax tree's flattened names, as ``convert.to_state_dict`` gives them), both
Adam states, the step, the EMA of G and a ``torch.Generator`` for the
instance noise. The modules themselves are not in the state
(``stage2.make_models``), so the state is plain data: it checkpoints with
``torch.save`` and converts one to one from the JAX package's optax state.

``Adam`` reproduces ``optax.adam`` (with ``clip_by_global_norm`` first when
``grad_clip_norm > 0`` and ``exponential_decay`` when ``lr_decay_rate <
1``) operation for operation, in fp32, with ``torch._foreach_*``; with
``weight_decay > 0`` it is AdamW (``torch.optim.AdamW``'s decoupled decay,
``-lr * weight_decay * param`` added to each update), and a player's own
clip (``g_grad_clip_norm``, ``d_grad_clip_norm``) takes
``grad_clip_norm``'s place for it. The step
and Adam counts are host integers, so the warmup gate, the learning-rate
schedule and the bias corrections cost no device synchronisation; the
scalars they give are rounded to fp32 as optax computes them
(``Adam.scalars``), and a step captured as a CUDA graph reads them from 0-d
device tensors filled before each replay.

The step engine runs both stages' steps (``train/stage1.py``,
``train/stage2.py``), each given as a ``Stage``. ``run`` is the one
sequence of a step (draws, scalars, update, D's Adam count, next state),
functional or in place on an ``InPlaceStep``'s buffers (one CUDA graph on
a card); ``run_step`` chooses between the two and caches the in-place
steps (``step_for``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from music_synthesis_tpu_torch._device import resolve_device
# drop_graphed_steps is re-exported: the benchmark's drivers import it here.
from music_synthesis_tpu_torch._graphs import (
    GraphedProgram,
    cached_step,
    drop_graphed_steps,
    enabled,
    flags,
)
from music_synthesis_tpu_torch.config import PipelineConfig, TrainConfig
from music_synthesis_tpu_torch.parallel import mesh
from music_synthesis_tpu_torch.parallel.mesh import graphable, group_key
from music_synthesis_tpu_torch.utils.profiling import span

__all__ = ["AdamState", "GANState", "Adam", "make_optimizer", "global_norm",
           "state_groups", "assign", "noise_scale", "Draws",
           "reduce_metrics", "Stage", "new_state", "InPlaceStep", "run",
           "run_step", "step_for", "drop_graphed_steps"]

DP_MODES = ("jit", "shard_map")


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
    the config's optional clip (``clip`` in place of ``grad_clip_norm`` when
    given and positive), continuous exponential lr decay and decoupled
    weight decay."""

    eps = 1e-8

    def __init__(self, lr: float, cfg: TrainConfig, clip: float = 0.0):
        self.lr = lr
        self.b1, self.b2 = cfg.adam_b1, cfg.adam_b2
        self.decay_rate = cfg.lr_decay_rate
        self.decay_every = max(cfg.lr_decay_every, 1)
        self.clip = clip if clip > 0 else cfg.grad_clip_norm
        self.weight_decay = cfg.weight_decay

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
               scalars=None, params: dict[str, torch.Tensor] | None = None
               ) -> tuple[list[torch.Tensor], AdamState]:
        """``(updates, new_state)``: the updates in ``named_grads``' order,
        already carrying ``-lr``. Nothing is changed in place. ``scalars``:
        ``self.scalars(state.count)``, as floats or 0-d fp32 tensors (a
        captured step reads them from the device), computed here if not
        given. ``params``: the parameters the updates apply to, which the
        weight decay needs."""
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
        if self.weight_decay > 0:
            torch._foreach_add_(updates, torch._foreach_mul(
                [params[k] for k in names], self.weight_decay))
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


def make_optimizer(lr: float, cfg: TrainConfig, clip: float = 0.0) -> Adam:
    """Adam with the GAN betas of ``cfg`` (0.5, 0.9 by default); ``clip``,
    a player's own clip, in place of ``cfg.grad_clip_norm`` when
    positive."""
    return Adam(lr, cfg, clip)


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


def noise_scale(cfg: PipelineConfig, step: int) -> float:
    """Instance-noise sigma at ``step``, in fp32 as the JAX step computes it:
    ``d_input_noise * max(0, 1 - step / d_noise_decay_steps)``."""
    t = cfg.train
    s = np.float32(t.d_input_noise)
    if t.d_noise_decay_steps > 0:
        frac = np.float32(step) / np.float32(t.d_noise_decay_steps)
        s = s * np.maximum(np.float32(0.0), np.float32(1.0) - frac)
    return float(s)


def _copy_generator(rng: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=rng.device)
    out.set_state(rng.get_state())
    return out


class Draws:
    """The step's random draws, ``normal(shape)`` (standard normals) and
    ``uniform(shape)`` (in [0, 1)) for this rank's ``shape``: from ``rng``
    in a single process; under ``group`` with
    ``dp="jit"`` the global batch's rows from ``rng`` (the same on every
    rank), this rank's kept; with ``dp="shard_map"`` from a generator of
    this rank's own, seeded (at the first draw) from one draw of ``rng``
    and the rank. ``rng`` advances alike on every rank."""

    def __init__(self, rng: torch.Generator, group=None,
                 dp: str = "shard_map"):
        if dp not in DP_MODES:
            raise ValueError(f"dp must be one of {DP_MODES}, got {dp!r}")
        self.rng, self.group, self.dp = rng, group, dp
        self._own = None

    def normal(self, shape) -> torch.Tensor:
        return self._draw(torch.randn, shape)

    def uniform(self, shape) -> torch.Tensor:
        return self._draw(torch.rand, shape)

    def _draw(self, fn, shape) -> torch.Tensor:
        dev = self.rng.device
        if self.group is None:
            return fn(shape, generator=self.rng, device=dev)
        if self.dp == "jit":
            n = mesh.world_size(self.group)
            full = fn((shape[0] * n, *shape[1:]), generator=self.rng,
                      device=dev)
            return mesh.shard_batch(full, self.group)
        if self._own is None:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=self.rng,
                                     device=dev))
            r = mesh.rank(self.group) + 1
            self._own = torch.Generator(device=dev).manual_seed(
                (seed + 0x9E3779B97F4A7C15 * r) % 2 ** 63)
        return fn(shape, generator=self._own, device=dev)


def reduce_metrics(means: dict, fake2: torch.Tensor, real2: torch.Tensor,
                   group, dp: str) -> dict:
    """``means`` (the losses, each a mean over this rank's rows) and
    ``g_rms_ratio`` from the mean squares of the fake and real batches,
    averaged over the ranks of ``group``: the global batch's ratio for
    ``dp="jit"``, the mean of the shards' ratios for ``"shard_map"``."""
    def ratio(f2, r2):
        return torch.sqrt((f2 + 1e-12) / (r2 + 1e-12))

    if group is None:
        return {**means, "g_rms_ratio": ratio(fake2, real2)}
    keys = list(means)
    vals = list(means.values())
    if dp == "jit":
        *vals, fake2, real2 = mesh.all_reduce_mean(vals + [fake2, real2],
                                                   group)
        out = dict(zip(keys, vals))
        out["g_rms_ratio"] = ratio(fake2, real2)
        return out
    *vals, rms = mesh.all_reduce_mean(vals + [ratio(fake2, real2)], group)
    return {**dict(zip(keys, vals)), "g_rms_ratio": rms}


def _device(state: GANState) -> torch.device:
    return next(iter(state.g_params.values())).device


def _floats(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """Every metric as a Python float, with one device synchronisation
    (the ``step.read`` span)."""
    with span("step.read"):
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


@dataclasses.dataclass(frozen=True)
class Stage:
    """What one GAN stage gives the engine: its tracer ``label``;
    ``draws(cfg, state, dev, shape, group=, dp=, **given)`` -> ``(rng,
    draws)``, a copy of ``state.rng`` advanced past the draws, and the
    draws on ``dev`` (``given``: its ``train_step``'s keywords in place of
    any); ``scalars(cfg, state)``, the per-step fp32 scalars;
    ``update(cfg, state, batch, draws, scalars, *static, group=, dp=)`` ->
    ``(g_params, d_params, g_opt, d_opt, g_ema, metrics)``, new tensors
    and no host read, the scalars floats or 0-d tensors; ``d_updates(cfg,
    step)``, D's Adam updates in the step; ``static``, more of the
    update's arguments (stage 2's log-mel precision)."""

    label: str
    draws: Callable
    scalars: Callable
    update: Callable
    d_updates: Callable[[PipelineConfig, int], int]
    static: tuple = ()


def new_state(cfg: PipelineConfig, make_models, seed: int | None,
              device) -> GANState:
    """The state at step 0 of the players ``make_models(cfg, generator)``
    gives, seeded with ``seed`` (``cfg.train.seed`` if None), zeroed Adam
    states, on ``device`` (``cuda`` unless told otherwise); the state's
    generator is seeded with ``seed + 1``."""
    dev = resolve_device(device)
    seed = cfg.train.seed if seed is None else seed
    gen, disc = make_models(cfg, torch.Generator().manual_seed(seed))
    g_params = {k: v.detach().to(dev) for k, v in gen.named_parameters()}
    d_params = {k: v.detach().to(dev) for k, v in disc.named_parameters()}
    t = cfg.train
    return GANState(
        step=0, g_params=g_params, d_params=d_params,
        g_opt=make_optimizer(t.g_lr, t).init(g_params),
        d_opt=make_optimizer(t.d_lr, t).init(d_params),
        rng=torch.Generator(device=dev).manual_seed(seed + 1),
        g_ema=({k: v.clone() for k, v in g_params.items()}
               if t.ema_decay > 0 else None))


class InPlaceStep:
    """``stage``'s step in place, for one config and batch shape on one
    device, under ``group`` in mode ``dp`` as the stage's ``train_step``
    takes them: on a CUDA device one CUDA graph of the update (the
    reference's ``jax.jit(train_step, donate_argnums=1)``), timed by the
    tracer under ``stage.label``, its collectives captured (NCCL's; a
    card under gloo is refused); on the CPU the same arithmetic run
    eagerly. ``step(state, batch, **given)`` is ``run`` on the buffers.

    The state's tensors live in buffers this object owns: ``load`` copies
    the given state into them, unless it is the state the last call
    returned. So, as with the reference's donated state, a state is no
    longer valid once a later step has run from it or from any state of
    the same buffers: copy what must outlive the step. On a card the
    inputs go to the device without a host synchronisation, so steps run
    back to back until their metrics (the graph's buffers) are read.
    """

    def __init__(self, stage: Stage, cfg: PipelineConfig,
                 device: torch.device | str, group=None,
                 dp: str = "shard_map"):
        self.device = torch.device(device)
        _graphed(self.device, group, refuse=True)
        self.stage, self.cfg, self.group, self.dp = stage, cfg, group, dp
        self.buffers: GANState | None = None
        self.program = None

    def __call__(self, state: GANState, batch, **given
                 ) -> tuple[GANState, dict[str, torch.Tensor]]:
        return run(self.stage, self.cfg, state, batch, given, self.group,
                   self.dp, self)

    def _body(self, buffers: GANState, batch: torch.Tensor,
              scalars: torch.Tensor, *draws: torch.Tensor) -> dict:
        """The update on the 0-d tensors of ``scalars``, its new values
        written back into ``buffers``' tensors; returns the metrics (what
        the graph captures)."""
        *new, metrics = self.stage.update(
            self.cfg, buffers, batch, draws, scalars.unbind(),
            *self.stage.static, group=self.group, dp=self.dp)
        assign(buffers, *new)
        return metrics

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

    def load(self, state: GANState, batch: torch.Tensor, scalars,
             *draws: torch.Tensor):
        """Adopts ``state`` into the buffers, and ``batch``, the floats
        ``scalars`` and ``draws`` into the step; returns the call that
        runs the update on them (the graph's replay on a card, whose
        metrics are the graph's buffers: read them before the next
        call)."""
        buffers = self._adopt(state)
        inputs = [batch, torch.tensor(scalars, dtype=torch.float32), *draws]
        if self.device.type != "cuda":
            return functools.partial(self._body, buffers, *(
                a.to(self.device) for a in inputs))
        inputs = [a if a.is_cuda else
                  a.pin_memory().to(self.device, non_blocking=True)
                  for a in inputs]
        if self.program is None:
            self.program = GraphedProgram(
                functools.partial(self._body, buffers), self.device,
                mutates=[t for g in state_groups(buffers) for t in g.values()],
                label=self.stage.label)
        self.program.load(*inputs)
        return self.program.replay


def run(stage: Stage, cfg: PipelineConfig, state: GANState, batch,
        given: dict | None = None, group=None, dp: str = "shard_map",
        in_place: InPlaceStep | None = None
        ) -> tuple[GANState, dict[str, torch.Tensor]]:
    """One step of ``stage`` from ``state`` on ``batch``, its metrics left
    on the device: the draws (``given`` in place of any), the per-step
    scalars, the update, D's Adam count and the next state: the step and
    G's Adam count one further. Eagerly and functionally without
    ``in_place`` (``state`` is left as it was), else on its buffers."""
    dev = _device(state) if in_place is None else in_place.device
    batch = torch.as_tensor(batch, dtype=torch.float32,
                            device=dev if in_place is None else None)
    with span("step.draws"):
        rng, draws = stage.draws(cfg, state, dev, batch.shape, group=group,
                                 dp=dp, **(given or {}))
    with span("step.inputs"):
        scalars = stage.scalars(cfg, state)
        if in_place is not None:
            launch = in_place.load(state, batch, scalars, *draws)
    if in_place is None:
        *new, metrics = stage.update(cfg, state, batch, draws, scalars,
                                     *stage.static, group=group, dp=dp)
        # New tensors in the layouts of ``state``'s: the results come in
        # the layouts of their gradients, and a weight norm's sum over a
        # parameter rounds by the parameter's strides, so a state whose
        # layouts drifted from step to step would not round as the
        # in-place step's fixed buffers do.
        out = _fresh(state)
        assign(out, *new)
    else:
        out, metrics = in_place.buffers, launch()
    d_count = state.d_opt.count + stage.d_updates(cfg, state.step)
    return dataclasses.replace(
        out, step=state.step + 1, rng=rng,
        g_opt=AdamState(state.g_opt.count + 1, out.g_opt.mu, out.g_opt.nu),
        d_opt=AdamState(d_count, out.d_opt.mu, out.d_opt.nu)), metrics


def _graphed(device: torch.device, group, refuse: bool = False) -> bool:
    """Whether a step on ``device`` under ``group`` replays its CUDA
    graph: on a card (``_graphs.enabled``), alone or under NCCL
    (``parallel.mesh.graphable``: gloo's collectives run on the host, where
    no graph can hold them, so its steps run eagerly). With ``refuse``, a
    card under gloo raises."""
    ok = graphable(group)
    if refuse and not ok and device.type == "cuda":
        raise ValueError("a CUDA graph cannot capture the collectives of a "
                         f"{dist.get_backend(group)} group")
    return ok and enabled(device)


#: The in-place steps of this process: a ``_graphs.cached_step`` cache per
#: stage label, keyed by (stage, config, batch shape, device,
#: ``_graphs.flags()``, ``parallel.mesh.group_key``).
_STEPS: dict[str, dict[tuple, InPlaceStep]] = {}


def step_for(stage: Stage, cfg: PipelineConfig, shape,
             device: torch.device, group=None,
             dp: str = "shard_map") -> InPlaceStep:
    """The process's ``InPlaceStep`` of ``stage`` and ``cfg`` for batches
    of ``shape`` on ``device`` under the current ``_graphs.flags()``, and
    under ``group`` in mode ``dp``."""
    return cached_step(
        _STEPS.setdefault(stage.label, {}),
        (stage, cfg, tuple(shape), device, flags(), group_key(group, dp)),
        lambda: InPlaceStep(stage, cfg, device, group, dp))


def run_step(stage: Stage, cfg: PipelineConfig, state: GANState, batch,
             given: dict | None = None, group=None, dp: str = "shard_map"
             ) -> tuple[GANState, dict[str, torch.Tensor]]:
    """One step with its metrics left on the device: on a card, in a
    single process or under an NCCL group, the replay of ``step_for``'s
    graph (``state`` is donated to it); otherwise (the CPU, a gloo group,
    ``disable_graphs``) eagerly and functionally (``run``)."""
    dev = _device(state)
    if not _graphed(dev, group):
        return run(stage, cfg, state, batch, given, group, dp)
    batch = torch.as_tensor(batch, dtype=torch.float32)
    return run(stage, cfg, state, batch, given, group, dp,
               step_for(stage, cfg, batch.shape, dev, group, dp))
