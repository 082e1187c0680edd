"""Stage-1 spectrogram GAN training (counterpart of ``train/stage1.py``).

``train_step`` takes one D update on normalized log-mel patches ``[B, T, M]``
against the detached fake (hinge or logistic loss, optional R1 penalty and
instance noise), then one G update against the *updated* D (adversarial,
feature-matching and optional temporal-flux terms), then the EMA of G. It
returns a new ``GANState`` and the metrics of the JAX step, under the same
keys, as Python floats.

The structure is ``train/stage2.py``'s: eager PyTorch, modules without
storage called with the state's parameters (``functional_call``), one
``torch.autograd.grad`` per player, one G forward for both updates. Each
step draws the latents, then (with instance noise) three normals, from the
state's generator; ``z=`` and ``noise=`` replace those draws. The step's
phases are ``utils.profiling.region``s under the JAX step's
``jax.named_scope`` names, timed per replay under the label
``stage1_step``, with stage 2's host spans.

Data parallelism (``group``, ``dp``) is ``train/stage2.py``'s: gradients
and metrics averaged over the ranks, the draws of the global batch kept by
rows (``dp="jit"``) or drawn per rank (``"shard_map"``, latents and noise
from the rank's own generator, as the reference folds the axis index into
both keys). The flux profiles are averaged over the ranks before the L1
(``parallel.mesh.AllReduce``), so the flux term is the global batch's.
On a card the step replays its CUDA graph (``GraphedStep``) in a single
process and under an NCCL group; under a gloo group it runs eagerly.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.func import functional_call

from music_synthesis_tpu_torch._device import resolve_device
from music_synthesis_tpu_torch._graphs import enabled, flags
from music_synthesis_tpu_torch.config import PipelineConfig
from music_synthesis_tpu_torch.losses.gan import (
    d_loss_fn,
    feature_matching_loss,
    g_loss_fn,
    hinge_d_loss,
    hinge_g_loss,
)
from music_synthesis_tpu_torch.models.specgan import (
    SpectrogramDiscriminator,
    SpectrogramGenerator,
)
from music_synthesis_tpu_torch.parallel.mesh import (
    AllReduce,
    all_reduce_mean,
    graphable,
    group_key,
    world_size,
)
from music_synthesis_tpu_torch.train.stage2 import (
    Draws,
    _copy_generator,
    _device,
    _floats,
    noise_scale,
    reduce_metrics,
)
from music_synthesis_tpu_torch.train.state import (
    GANState,
    InPlaceStep,
    assign,
    cached_step,
    global_norm,
    make_optimizer,
    next_state,
)
from music_synthesis_tpu_torch.utils.profiling import region, span

__all__ = ["make_models", "make_train_state", "forward_losses",
           "forward_and_loss", "GraphedStep", "graphed_step", "train_step"]


def make_models(cfg: PipelineConfig,
                generator: torch.Generator | None = None):
    """The composer G and its spectrogram D of ``cfg.specgan``."""
    return (SpectrogramGenerator(cfg.specgan, generator),
            SpectrogramDiscriminator(cfg.specgan, generator))


@functools.lru_cache(maxsize=8)
def _modules(cfg: PipelineConfig):
    """G and D without storage, called with the state's parameters."""
    with torch.device("meta"):
        return make_models(cfg)


def make_train_state(cfg: PipelineConfig, seed: int | None = None,
                     device: str | torch.device | None = None) -> GANState:
    """Seeded G and D parameters, zeroed Adam states, step 0, on ``device``
    (``cuda`` unless told otherwise). ``seed`` defaults to
    ``cfg.train.seed``; the latent and noise generator is seeded with
    ``seed + 1``."""
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


def forward_losses(cfg: PipelineConfig, state: GANState, real_mel,
                   z) -> dict[str, torch.Tensor]:
    """``forward_and_loss`` with the losses left on the device."""
    gen, disc = _modules(cfg)
    dev = _device(state)
    with torch.no_grad():
        real = torch.as_tensor(real_mel, dtype=torch.float32, device=dev)
        z = torch.as_tensor(z, dtype=torch.float32, device=dev)
        fake = functional_call(gen, state.g_params, (z,))
        real_logit, _ = functional_call(disc, state.d_params, (real,))
        fake_logit, _ = functional_call(disc, state.d_params, (fake,))
        return {"d_loss": hinge_d_loss(real_logit, fake_logit),
                "g_loss": hinge_g_loss(fake_logit)}


def forward_and_loss(cfg: PipelineConfig, state: GANState, real_mel,
                     z) -> dict[str, float]:
    """G forward and the hinge losses on ``real_mel`` and ``G(z)``, with no
    update."""
    return _floats(forward_losses(cfg, state, real_mel, z))


def _flux_profile(x: torch.Tensor) -> torch.Tensor:
    """Mean absolute frame-to-frame change per mel bin, ``[M]``."""
    return torch.mean(torch.abs(torch.diff(x, dim=1)), dim=(0, 1))


def _draws(cfg: PipelineConfig, state: GANState, dev: torch.device, shape,
           z, noise, group=None, dp: str = "shard_map"):
    """``(rng, z, noise)``: the step's random inputs on ``dev``, drawn in
    the step's order from a copy of ``state.rng`` (returned, advanced)
    where not given: the latents ``[B, latent_dim]``, then with instance
    noise three normals of the batch's ``shape`` (``noise`` is ``()``
    without it)."""
    rng = _copy_generator(state.rng)
    draws = Draws(rng, group, dp)
    if z is None:
        z = draws.normal((shape[0], cfg.specgan.latent_dim))
    z = torch.as_tensor(z, dtype=torch.float32, device=dev)
    if cfg.train.d_input_noise <= 0:
        return rng, z, ()
    if noise is None:
        noise = [draws.normal(shape) for _ in range(3)]
    return rng, z, tuple(torch.as_tensor(n, dtype=torch.float32, device=dev)
                         for n in noise)


def _scalars(cfg: PipelineConfig, state: GANState) -> list[float]:
    """The step's per-step fp32 scalars: the instance-noise sigma, then
    ``(lr, bc1, bc2)`` of G's Adam and of D's (``Adam.scalars``)."""
    t = cfg.train
    return [noise_scale(cfg, state.step),
            *make_optimizer(t.g_lr, t).scalars(state.g_opt.count),
            *make_optimizer(t.d_lr, t).scalars(state.d_opt.count)]


def _step(cfg: PipelineConfig, state: GANState, real_mel, z, noise,
          group=None, dp: str = "shard_map"):
    """One D and one G update; the metrics stay tensors on the device."""
    dev = _device(state)
    real = torch.as_tensor(real_mel, dtype=torch.float32, device=dev)
    rng, z, noise = _draws(cfg, state, dev, real.shape, z, noise, group, dp)
    *new, metrics = _update(cfg, state, real, z, noise,
                            _scalars(cfg, state), group, dp)
    return next_state(state, rng, state.d_opt.count + 1, *new), metrics


def _update(cfg: PipelineConfig, state: GANState, real: torch.Tensor,
            z: torch.Tensor, noise: tuple, scalars, group=None,
            dp: str = "shard_map"):
    """The step's arithmetic on given draws and ``_scalars`` (floats, or
    0-d fp32 tensors): ``(g_params, d_params, g_opt, d_opt, g_ema,
    metrics)``, new tensors; nothing is changed in place."""
    t = cfg.train
    gen, disc = _modules(cfg)
    g_tx, d_tx = make_optimizer(t.g_lr, t), make_optimizer(t.d_lr, t)
    sigma, g_scalars, d_scalars = scalars[0], scalars[1:4], scalars[4:7]
    g_names = list(state.g_params)
    g_leaves = [p.detach().requires_grad_() for p in state.g_params.values()]
    with region("generator_fwd"):
        fake = functional_call(gen, dict(zip(g_names, g_leaves)), (z,))
    fake_sg = fake.detach()

    # Instance noise: three normals; the third is added (with gradients)
    # to the G step's fake, a fresh realisation, not the D step's.
    d_real_in, d_fake_in, g_noise = real, fake_sg, None
    if t.d_input_noise > 0:
        n1, n2, n3 = noise
        d_real_in, d_fake_in, g_noise = (real + sigma * n1,
                                         fake_sg + sigma * n2, sigma * n3)

    # --- D step, on the detached fake ---
    d_names = list(state.d_params)
    d_leaves = [p.detach().requires_grad_() for p in state.d_params.values()]
    d_in = dict(zip(d_names, d_leaves))
    metrics = {}
    with region("d_step"):
        with region("disc_real"):
            real_logit, real_feats = functional_call(disc, d_in, (d_real_in,))
        with region("disc_fake"):
            fake_logit, _ = functional_call(disc, d_in, (d_fake_in,))
        d_loss = d_loss_fn(t.gan_loss)(real_logit, fake_logit)
        if t.r1_gamma > 0:
            # R1 on D(noised real): the input gradient of the summed
            # logits, kept in the graph so D's gradient flows through it.
            with region("r1_penalty"):
                x = d_real_in.detach().requires_grad_()
                logit, _ = functional_call(disc, d_in, (x,))
                (gx,) = torch.autograd.grad(logit.float().sum(), x,
                                            create_graph=True)
                per_sample = gx.float().square().sum(
                    dim=tuple(range(1, gx.ndim)))
                r1 = 0.5 * t.r1_gamma * per_sample.mean()
            d_loss = d_loss + r1
            metrics["d_r1"] = r1.detach()
        d_grads = list(torch.autograd.grad(d_loss, d_leaves))
        if group is not None:
            d_grads = all_reduce_mean(d_grads, group)
        d_grad_norm = global_norm(d_grads)
        d_updates, d_opt = d_tx.update(dict(zip(d_names, d_grads)),
                                      state.d_opt, d_scalars)
        d_update_norm = global_norm(d_updates)
        d_params = dict(zip(d_names, torch._foreach_add(
            list(state.d_params.values()), d_updates)))

    # --- G step, against the updated D (which takes no gradient) ---
    with region("g_step"):
        # G's forward is generator_fwd's, whose graph G's gradient goes
        # back through: this region holds only the noise on its output.
        with region("generator_fwd_g"):
            fake_g_in = fake if g_noise is None else fake + g_noise
        with region("disc_fake_g"):
            fake_logit_g, fake_feats = functional_call(disc, d_params,
                                                       (fake_g_in,))
        if t.reuse_real_features and t.d_input_noise == 0:
            real_feats_g = [f.detach() for f in real_feats]
        else:
            # The FM target is D's taps of the clean real batch (with noise
            # on, the D step's taps saw the noised one).
            with region("disc_real_g"), torch.no_grad():
                _, real_feats_g = functional_call(disc, d_params, (real,))
        with region("losses"):
            adv = g_loss_fn(t.gan_loss)(fake_logit_g)
            fm = feature_matching_loss(real_feats_g, fake_feats)
            total = adv + t.lambda_feature_matching * fm
            aux = {"g_adv": adv, "g_fm": fm}
            if t.lambda_flux > 0:
                pf, pr = _flux_profile(fake), _flux_profile(real)
                if group is not None:
                    pf, pr = AllReduce.apply(torch.stack([pf, pr]), group,
                                             1.0 / world_size(group))
                flux = torch.mean(torch.abs(pf - pr))
                total = total + t.lambda_flux * flux
                aux["g_flux"] = flux
        g_grads = list(torch.autograd.grad(total, g_leaves))
        if group is not None:
            g_grads = all_reduce_mean(g_grads, group)
        g_grad_norm = global_norm(g_grads)
        g_updates, g_opt = g_tx.update(dict(zip(g_names, g_grads)),
                                       state.g_opt, g_scalars)
        g_update_norm = global_norm(g_updates)
        g_params = dict(zip(g_names, torch._foreach_add(
            list(state.g_params.values()), g_updates)))

    g_ema = state.g_ema
    if t.ema_decay > 0:
        with region("ema"):
            ema = torch._foreach_mul([state.g_ema[k] for k in g_names],
                                     t.ema_decay)
            torch._foreach_add_(ema, torch._foreach_mul(
                list(g_params.values()), 1.0 - t.ema_decay))
            g_ema = dict(zip(g_names, ema))

    # Amplitude health in the normalized mel space, on the D step's fake.
    means = reduce_metrics(
        {"d_loss": d_loss.detach(), "g_loss": total.detach(),
         **{k: v.detach() for k, v in aux.items()}, **metrics},
        torch.mean(torch.square(fake_sg)), torch.mean(torch.square(real)),
        group, dp)
    out = {"d_loss": means["d_loss"], "g_loss": means["g_loss"],
           "g_rms_ratio": means["g_rms_ratio"],
           **{k: means[k] for k in aux}, **{k: means[k] for k in metrics},
           "d_grad_norm": d_grad_norm, "g_grad_norm": g_grad_norm,
           "d_update_norm": d_update_norm, "g_update_norm": g_update_norm}
    return g_params, d_params, g_opt, d_opt, g_ema, out


def _update_in_place(cfg: PipelineConfig, state: GANState,
                     real: torch.Tensor, z: torch.Tensor,
                     scalars: torch.Tensor, *noise: torch.Tensor, group=None,
                     dp: str = "shard_map") -> dict:
    """``_update`` on the 0-d tensors of ``scalars`` [7], its new values
    written back into ``state``'s tensors; returns the metrics."""
    *new, metrics = _update(cfg, state, real, z, noise, scalars.unbind(),
                            group, dp)
    assign(state, *new)
    return metrics


class GraphedStep(InPlaceStep):
    """The step in place (``train.state.InPlaceStep``): on a CUDA device
    one CUDA graph, on the CPU the same arithmetic run eagerly. The draws
    (latents, instance noise) are made eagerly from the state's generator,
    in the functional step's order, and the per-step scalars (the noise
    sigma, each Adam's learning rate and bias corrections) are filled into
    0-d fp32 tensors before each call, so a call computes what ``_step``
    computes, draw for draw. ``group`` and ``dp``: the data-parallel step,
    as ``stage2.GraphedStep`` takes them (its collectives in the graph,
    NCCL's only; its draws eager).
    """

    def __init__(self, cfg: PipelineConfig, device: torch.device | str,
                 group=None, dp: str = "shard_map"):
        device = torch.device(device)
        if device.type == "cuda" and not graphable(group):
            raise ValueError("a CUDA graph cannot capture the collectives "
                             f"of a {dist.get_backend(group)} group")
        super().__init__(functools.partial(_update_in_place, cfg,
                                           group=group, dp=dp), device,
                         "stage1_step")
        self.cfg, self.group, self.dp = cfg, group, dp

    def __call__(self, state: GANState, real_mel, z=None, noise=None
                 ) -> tuple[GANState, dict[str, torch.Tensor]]:
        """One step from ``state`` on ``real_mel`` (``z``, ``noise`` as in
        ``train_step``); the metrics stay tensors (the graph's buffers on
        the card: read them before the next call)."""
        real = torch.as_tensor(real_mel, dtype=torch.float32)
        with span("step.draws"):
            rng, z, noise = _draws(self.cfg, state, self.device, real.shape,
                                   z, noise, self.group, self.dp)
        with span("step.inputs"):
            scalars = torch.tensor(_scalars(self.cfg, state),
                                   dtype=torch.float32)
            launch = self.load(state, real, z, scalars, *noise)
        metrics = launch()
        return self.advanced(state, rng, state.d_opt.count + 1), metrics


#: The graphed steps of this process, by (config, batch shape, device,
#: ``_graphs.flags()``, ``parallel.mesh.group_key``); the oldest beyond
#: ``cached_step``'s limit is dropped.
_STEPS: dict[tuple, GraphedStep] = {}


def graphed_step(cfg: PipelineConfig, shape, device: torch.device,
                 group=None, dp: str = "shard_map") -> GraphedStep:
    """The process's ``GraphedStep`` of ``cfg`` for batches of ``shape``
    on ``device`` under the current ``_graphs.flags()``, and under
    ``group`` in mode ``dp`` (every rank of the group must make the same
    calls in the same order: ``state.cached_step``)."""
    return cached_step(_STEPS, (cfg, tuple(shape), device, flags(),
                                group_key(group, dp)),
                       lambda: GraphedStep(cfg, device, group, dp))


def train_step(cfg: PipelineConfig, state: GANState, real_mel, z=None,
               noise=None, group=None, dp: str = "shard_map"
               ) -> tuple[GANState, dict[str, float]]:
    """One alternating D/G update on normalized log-mel ``[B, T, M]``.

    ``z``: the latents ``[B, latent_dim]``, in place of a draw from
    ``state.rng``. ``noise``: the three standard-normal ``[B, T, M]``
    instance-noise realisations, in place of draws from ``state.rng``;
    used only when ``cfg.train.d_input_noise > 0``. ``group``: the process
    group of a data-parallel step, whose rank holds ``real_mel`` (and
    ``z``, ``noise``) as its rows of the global batch; ``dp`` says which
    reference step it follows (``train/stage2.py``'s docstring).

    On a card the step replays the CUDA graph of ``graphed_step``, in a
    single process and under an NCCL ``group`` (its collectives captured):
    the returned state's tensors are that graph's buffers, and ``state``
    is donated to it (``GraphedStep``). On the CPU, and under a gloo
    group, the step runs eagerly and returns new tensors.
    """
    dev = _device(state)
    if enabled(dev) and graphable(group):
        real = torch.as_tensor(real_mel, dtype=torch.float32)
        new_state, metrics = graphed_step(cfg, real.shape, dev, group, dp)(
            state, real, z, noise)
    else:
        new_state, metrics = _step(cfg, state, real_mel, z, noise, group, dp)
    return new_state, _floats(metrics)
