"""Stage-2 vocoder GAN training (counterpart of ``train/stage2.py``).

``train_step`` takes one D update on the detached fake (hinge or logistic
loss, optional R1 penalty and instance noise), then one G update against
the *updated* D (adversarial, feature-matching and multi-resolution STFT
terms, optional frame-energy and phase terms), then the EMA of G. It
returns the new ``GANState`` and the metrics of the JAX step, under the
same keys, as Python floats.

On a card the step replays one CUDA graph per config and batch shape
(``GraphedStep``, the reference's jitted step, to which the state is
donated), in a single process and on the ranks of an NCCL group, whose
collectives the graph captures. Both sides of the warmup gate are one
program: the gate, the noise sigma and Adam's scalars are 0-d tensors
filled before each replay. ``train_step_many`` replays the graph K times
and reads the metrics once. On the CPU, and on the ranks of a gloo group
(whose collectives run on the host, where no graph can capture them), the
same arithmetic runs eagerly and the old state is left as it was. The
modules are fixed per config and called with the state's parameters
(``torch.func.functional_call``), so neither player's ``.grad`` is ever
written: each gradient is ``torch.autograd.grad`` of one loss with respect
to one player's parameters. The G forward of the D step and the G step is
one forward (G's parameters do not change in between, so the JAX step's
two forwards give the same tensor). The step's phases are
``utils.profiling.region``s under the JAX step's ``jax.named_scope``
names (``record_function`` regions, and in the graph timing events that
the tracer reads per replay under the label ``stage2_step``);
``generator_fwd_g`` holds only the instance noise added to that one
forward's output. The host's work around a replay is in the spans
``step.draws``, ``step.inputs``, ``graph.launch`` and ``step.read``.

The conditioning mel is computed inside the step, with no gradient: with
``cfg.train.use_pallas_frontend`` by the fused log-mel kernel
(``ops/logmel.py``; the kernel on the card, its plain version on the CPU),
otherwise by ``ops/frontend.log_mel_for_vocoder``.

Data parallelism (``group``, a process group; ``parallel/dp.py`` and
``parallel/shard_map_dp.py`` build the steps): each rank passes its own
rows of the global batch and holds the whole state. Both gradients are
averaged over the ranks between ``torch.autograd.grad`` and the Adam
update (``lax.pmean`` in the reference), so clipping, the warmup gate and
the EMA see the same gradient on every rank, and every rank ends with the
same state; the STFT and phase losses sum their norms over the ranks
(``losses/``). ``dp`` names the reference's step being followed:

- ``"jit"`` (``make_dp_stage2_step``): the step on the global batch. Each
  rank draws the whole global batch's instance noise from the shared
  generator and keeps its rows, and the metrics are the global batch's,
  so with the same batch the step equals the single-process step on the
  concatenated batch;
- ``"shard_map"`` (``make_shardmap_stage2_step``): the reference's
  per-device step. Each rank draws its own noise (a generator seeded from
  one draw of the shared one and the rank, as ``fold_in(key,
  axis_index)``), and the metrics are the ranks' means (``g_rms_ratio``
  the mean of the shards' ratios).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from music_synthesis_tpu_torch._device import resolve_device
from music_synthesis_tpu_torch._graphs import enabled, flags
from music_synthesis_tpu_torch.config import PipelineConfig
from music_synthesis_tpu_torch.losses.gan import (
    d_loss_fn,
    feature_matching_loss,
    g_loss_fn,
)
from music_synthesis_tpu_torch.losses.phase_loss import phase_coherence_loss
from music_synthesis_tpu_torch.losses.stft_loss import multires_stft_loss
from music_synthesis_tpu_torch.models.discriminators import (
    CombinedDiscriminator,
)
from music_synthesis_tpu_torch.models.vocoder import Vocoder
from music_synthesis_tpu_torch.ops.frontend import log_mel_for_vocoder
from music_synthesis_tpu_torch.ops.logmel import fused_log_mel_for_vocoder
from music_synthesis_tpu_torch.parallel import mesh
from music_synthesis_tpu_torch.train.state import (
    AdamState,
    GANState,
    InPlaceStep,
    assign,
    cached_step,
    global_norm,
    make_optimizer,
    next_state,
)
from music_synthesis_tpu_torch.utils.profiling import region, span

__all__ = ["make_models", "conditioning_mel", "make_train_state",
           "noise_scale", "Draws", "reduce_metrics", "GraphedStep",
           "graphed_step", "train_step", "train_step_many"]

DP_MODES = ("jit", "shard_map")


def make_models(cfg: PipelineConfig,
                generator: torch.Generator | None = None):
    """The vocoder G and the combined MSD+MRD D of ``cfg``."""
    return (Vocoder(cfg.vocoder, generator),
            CombinedDiscriminator(cfg.msd, cfg.mrd, generator))


@functools.lru_cache(maxsize=8)
def _modules(cfg: PipelineConfig):
    """G and D without storage, called with the state's parameters."""
    with torch.device("meta"):
        return make_models(cfg)


def conditioning_mel(wav: torch.Tensor, cfg: PipelineConfig,
                     precision: str = "fast") -> torch.Tensor:
    """Normalized log-mel conditioning ``[B, L // hop, n_mels]``, no
    gradient. ``precision`` is the fused kernel's mode."""
    with torch.no_grad():
        if cfg.train.use_pallas_frontend:
            mel = fused_log_mel_for_vocoder(wav, cfg.frontend, precision)
        else:
            mel = log_mel_for_vocoder(wav, cfg.frontend)
        return (mel - cfg.mel_scaler.shift) / cfg.mel_scaler.scale


def make_train_state(cfg: PipelineConfig, seed: int | None = None,
                     device: str | torch.device | None = None) -> GANState:
    """Seeded G and D parameters, zeroed Adam states, step 0, on ``device``
    (``cuda`` unless told otherwise). ``seed`` defaults to
    ``cfg.train.seed``; the instance-noise generator is seeded with
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
    """The step's random normals, ``normal(shape)`` for this rank's
    ``shape``: from ``rng`` in a single process; under ``group`` with
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
        dev = self.rng.device
        if self.group is None:
            return torch.randn(shape, generator=self.rng, device=dev)
        if self.dp == "jit":
            n = mesh.world_size(self.group)
            full = torch.randn((shape[0] * n, *shape[1:]),
                               generator=self.rng, device=dev)
            return mesh.shard_batch(full, self.group)
        if self._own is None:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=self.rng,
                                     device=dev))
            r = mesh.rank(self.group) + 1
            self._own = torch.Generator(device=dev).manual_seed(
                (seed + 0x9E3779B97F4A7C15 * r) % 2 ** 63)
        return torch.randn(shape, generator=self._own, device=dev)


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


def _frame_rms(x: torch.Tensor, hop: int) -> torch.Tensor:
    f = x[:, : (x.shape[1] // hop) * hop].reshape(x.shape[0], -1, hop)
    return torch.sqrt(torch.mean(torch.square(f), -1) + 1e-8)


def _device(state: GANState) -> torch.device:
    return next(iter(state.g_params.values())).device


def _gate_open(cfg: PipelineConfig, step: int) -> bool:
    """Whether the adversarial game is on at ``step`` (the warmup gate)."""
    t = cfg.train
    return t.g_warmup_steps <= 0 or step >= t.g_warmup_steps


def _draws(cfg: PipelineConfig, state: GANState, dev: torch.device, shape,
           noise, group=None, dp: str = "shard_map"):
    """``(rng, noise)``: with instance noise the step's three normals of
    the batch's ``shape`` on ``dev``, drawn from a copy of ``state.rng``
    (returned, advanced) where not given; ``noise`` is ``()`` without
    it."""
    rng = _copy_generator(state.rng)
    if cfg.train.d_input_noise <= 0:
        return rng, ()
    if noise is None:
        draws = Draws(rng, group, dp)
        noise = [draws.normal(shape) for _ in range(3)]
    return rng, tuple(torch.as_tensor(n, dtype=torch.float32, device=dev)
                      for n in noise)


def _scalars(cfg: PipelineConfig, state: GANState) -> list[float]:
    """The step's per-step fp32 scalars: the instance-noise sigma, the
    warmup gate (1.0 once the adversarial game is on, else 0.0), then
    ``(lr, bc1, bc2)`` of G's Adam and of D's (``Adam.scalars``)."""
    t = cfg.train
    return [noise_scale(cfg, state.step),
            float(_gate_open(cfg, state.step)),
            *make_optimizer(t.g_lr, t).scalars(state.g_opt.count),
            *make_optimizer(t.d_lr, t).scalars(state.d_opt.count)]


def _step(cfg: PipelineConfig, state: GANState, wav: torch.Tensor,
          noise, precision: str, group=None, dp: str = "shard_map"):
    """One D and one G update, eagerly; the metrics stay tensors on the
    device."""
    dev = _device(state)
    wav = torch.as_tensor(wav, dtype=torch.float32, device=dev)
    rng, noise = _draws(cfg, state, dev, wav.shape, noise, group, dp)
    *new, metrics = _update(cfg, state, wav, noise, _scalars(cfg, state),
                            precision, group, dp)
    d_count = state.d_opt.count + _gate_open(cfg, state.step)
    return next_state(state, rng, d_count, *new), metrics


def _update(cfg: PipelineConfig, state: GANState, wav: torch.Tensor,
            noise: tuple, scalars, precision: str, group=None,
            dp: str = "shard_map"):
    """The step's arithmetic on given draws and ``_scalars`` (floats, or
    0-d fp32 tensors): ``(g_params, d_params, g_opt, d_opt, g_ema,
    metrics)``, new tensors; nothing is changed in place. No value is read
    back to the host and nothing branches on the step, so both sides of
    the warmup gate are one program."""
    t = cfg.train
    gen, disc = _modules(cfg)
    g_tx, d_tx = make_optimizer(t.g_lr, t), make_optimizer(t.d_lr, t)
    sigma, gate = scalars[0], scalars[1]
    g_scalars, d_scalars = scalars[2:5], scalars[5:8]
    dev = wav.device
    b = wav.shape[0]

    with region("frontend"):
        mel = conditioning_mel(wav, cfg, precision)
    g_names = list(state.g_params)
    g_leaves = [p.detach().requires_grad_() for p in state.g_params.values()]
    g_in = dict(zip(g_names, g_leaves))

    def run_g(x):
        return functional_call(gen, g_in, (x,))

    with region("generator_fwd"):
        # G draws nothing, so the recomputation needs no RNG state (whose
        # stash a CUDA graph's capture would refuse).
        fake = (checkpoint(run_g, mel, use_reentrant=False,
                           preserve_rng_state=False)
                if t.remat_generator else run_g(mel))
    fake_sg = fake.detach()

    # Instance noise: three normals, the third reused (with gradients) on
    # the G side.
    d_real_in, d_fake_in, g_noise = wav, fake_sg, None
    if t.d_input_noise > 0:
        n1, n2, n3 = noise
        d_real_in, d_fake_in, g_noise = (wav + sigma * n1,
                                         fake_sg + sigma * n2, sigma * n3)

    # --- D step, on the detached fake ---
    d_names = list(state.d_params)
    d_leaves = [p.detach().requires_grad_() for p in state.d_params.values()]
    d_in = dict(zip(d_names, d_leaves))
    metrics = {}
    with region("d_step"):
        if t.concat_disc_batch:
            with region("disc_both"):
                logits, feats = functional_call(
                    disc, d_in, (torch.cat([d_real_in, d_fake_in]),))
            real_logits = [l[:b] for l in logits]
            fake_logits = [l[b:] for l in logits]
            real_feats = [[f[:b] for f in head] for head in feats]
        else:
            with region("disc_real"):
                real_logits, real_feats = functional_call(disc, d_in,
                                                          (d_real_in,))
            with region("disc_fake"):
                fake_logits, _ = functional_call(disc, d_in, (d_fake_in,))
        d_loss = d_loss_fn(t.gan_loss)(real_logits, fake_logits)
        if t.r1_gamma > 0:
            # R1 on D(real): the input gradient of the summed logits
            # (samples are independent), kept in the graph so D's gradient
            # flows through it.
            with region("r1_penalty"):
                x = d_real_in.detach().requires_grad_()
                ls, _ = functional_call(disc, d_in, (x,))
                (gx,) = torch.autograd.grad(sum(l.float().sum() for l in ls),
                                            x, create_graph=True)
                per_sample = gx.float().square().sum(
                    dim=tuple(range(1, gx.ndim)))
                r1 = 0.5 * t.r1_gamma * per_sample.mean()
            d_loss = d_loss + r1
            metrics["d_r1"] = r1.detach()
        d_grads = list(torch.autograd.grad(d_loss, d_leaves))
        if group is not None:
            d_grads = mesh.all_reduce_mean(d_grads, group)
        d_grad_norm = global_norm(d_grads)
        d_updates, d_opt = d_tx.update(dict(zip(d_names, d_grads)),
                                      state.d_opt, d_scalars)
        if t.g_warmup_steps > 0:
            # Warmup gate: D's update masked, its Adam moments kept.
            d_updates = torch._foreach_mul(d_updates, gate)
            on = torch.as_tensor(gate, device=dev) > 0
            d_opt = AdamState(d_opt.count, *(
                {k: torch.where(on, new[k], old[k]) for k in new}
                for new, old in ((d_opt.mu, state.d_opt.mu),
                                 (d_opt.nu, state.d_opt.nu))))
        d_update_norm = global_norm(d_updates)
        d_params = dict(zip(d_names, torch._foreach_add(
            list(state.d_params.values()), d_updates)))
    real_feats_d = [[f.detach() for f in head] for head in real_feats]

    # --- G step, against the updated D (which takes no gradient) ---
    with region("g_step"):
        # G's forward is generator_fwd's, whose graph G's gradient goes
        # back through: this region holds only the noise on its output.
        with region("generator_fwd_g"):
            fake_g_in = fake if g_noise is None else fake + g_noise
        with region("disc_fake_g"):
            fake_logits, fake_feats = functional_call(disc, d_params,
                                                      (fake_g_in,))
        if t.reuse_real_features and t.d_input_noise == 0:
            real_feats_g = real_feats_d
        else:
            # With instance noise the D step's taps saw the noised batch;
            # the FM target comes from the clean one.
            with region("disc_real_g"), torch.no_grad():
                _, real_feats_g = functional_call(disc, d_params, (wav,))
        with region("losses"):
            adv = g_loss_fn(t.gan_loss)(fake_logits)
            fm = feature_matching_loss(real_feats_g, fake_feats)
            stft = multires_stft_loss(fake, wav, cfg.stft_loss, group)
            adv_w = gate if t.g_warmup_steps > 0 else 1.0
            total = (adv_w * (adv + t.lambda_feature_matching * fm)
                     + t.lambda_stft * stft)
            aux = {"g_adv": adv, "g_fm": fm, "g_stft": stft}
            if t.lambda_energy > 0:
                hop = cfg.frontend.hop_length
                energy = torch.mean(torch.abs(_frame_rms(fake, hop)
                                              - _frame_rms(wav, hop)))
                total = total + t.lambda_energy * energy
                aux["g_energy"] = energy
            if t.lambda_phase > 0:
                ph = phase_coherence_loss(fake, wav, t.phase_n_fft,
                                          t.phase_hop, group=group)
                total = total + t.lambda_phase * ph
                aux["g_phase"] = ph
        g_grads = list(torch.autograd.grad(total, g_leaves))
        if group is not None:
            g_grads = mesh.all_reduce_mean(g_grads, group)
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

    means = reduce_metrics(
        {"d_loss": d_loss.detach(), "g_loss": total.detach(),
         **{k: v.detach() for k, v in aux.items()}, **metrics},
        torch.mean(torch.square(fake_sg)), torch.mean(torch.square(wav)),
        group, dp)
    out = {"d_loss": means["d_loss"], "g_loss": means["g_loss"],
           "g_rms_ratio": means["g_rms_ratio"],
           **{k: means[k] for k in aux}, **{k: means[k] for k in metrics},
           "d_grad_norm": d_grad_norm, "g_grad_norm": g_grad_norm,
           "d_update_norm": d_update_norm, "g_update_norm": g_update_norm}
    return g_params, d_params, g_opt, d_opt, g_ema, out


def _update_in_place(cfg: PipelineConfig, precision: str, state: GANState,
                     wav: torch.Tensor, scalars: torch.Tensor,
                     *noise: torch.Tensor, group=None,
                     dp: str = "shard_map") -> dict:
    """``_update`` on the 0-d tensors of ``scalars`` [8], its new values
    written back into ``state``'s tensors; returns the metrics."""
    *new, metrics = _update(cfg, state, wav, noise, scalars.unbind(),
                            precision, group, dp)
    assign(state, *new)
    return metrics


class GraphedStep(InPlaceStep):
    """The step in place (``train.state.InPlaceStep``), for one config,
    batch shape and log-mel ``precision``: on a CUDA device one CUDA graph
    (the reference's ``jax.jit(train_step, donate_argnums=1)``), R1's
    double backward and the log-mel kernel's launch inside it; on the CPU
    the same arithmetic run eagerly. The instance noise is drawn eagerly
    from the state's generator, in the functional step's order, and the
    per-step scalars (the noise sigma, the warmup gate, each Adam's
    learning rate and bias corrections) are filled into 0-d fp32 tensors
    before each call, so a call computes what ``_step`` computes, draw for
    draw, on both sides of the gate.

    ``group`` and ``dp``: the data-parallel step (the reference's
    ``make_dp_stage2_step`` / ``make_shardmap_stage2_step`` programs). Its
    draws, the shard_map seeding's host read among them, stay eager; the
    gradient all-reduces, the losses' cross-rank sums and the metrics'
    means are in the graph, which NCCL's collectives allow and gloo's,
    which run on the host, do not (``parallel.mesh.graphable``): a gloo
    group on a card is refused here. A capture that fails raises.
    """

    def __init__(self, cfg: PipelineConfig, device: torch.device | str,
                 precision: str = "fast", group=None, dp: str = "shard_map"):
        device = torch.device(device)
        if device.type == "cuda" and not mesh.graphable(group):
            raise ValueError("a CUDA graph cannot capture the collectives "
                             f"of a {dist.get_backend(group)} group")
        super().__init__(functools.partial(_update_in_place, cfg, precision,
                                           group=group, dp=dp), device,
                         "stage2_step")
        self.cfg, self.group, self.dp = cfg, group, dp

    def __call__(self, state: GANState, wav, noise=None
                 ) -> tuple[GANState, dict[str, torch.Tensor]]:
        """One step from ``state`` on ``wav`` (``noise`` as in
        ``train_step``); the metrics stay tensors (the graph's buffers on
        the card: read them before the next call)."""
        wav = torch.as_tensor(wav, dtype=torch.float32)
        with span("step.draws"):
            rng, noise = _draws(self.cfg, state, self.device, wav.shape,
                                noise, self.group, self.dp)
        with span("step.inputs"):
            scalars = torch.tensor(_scalars(self.cfg, state),
                                   dtype=torch.float32)
            launch = self.load(state, wav, scalars, *noise)
        metrics = launch()
        d_count = state.d_opt.count + _gate_open(self.cfg, state.step)
        return self.advanced(state, rng, d_count), metrics


#: The graphed steps of this process, by (config, batch shape, device,
#: log-mel precision, ``_graphs.flags()``, ``parallel.mesh.group_key``);
#: the oldest beyond ``cached_step``'s limit is dropped.
_STEPS: dict[tuple, GraphedStep] = {}


def graphed_step(cfg: PipelineConfig, shape, device: torch.device,
                 precision: str = "fast", group=None,
                 dp: str = "shard_map") -> GraphedStep:
    """The process's ``GraphedStep`` of ``cfg`` for batches of ``shape``
    on ``device`` under the current ``_graphs.flags()``, and under
    ``group`` in mode ``dp`` (every rank of the group must make the same
    calls in the same order: ``state.cached_step``)."""
    return cached_step(_STEPS, (cfg, tuple(shape), device, precision,
                                flags(), mesh.group_key(group, dp)),
                       lambda: GraphedStep(cfg, device, precision, group, dp))


def _run_step(cfg: PipelineConfig, state: GANState, wav, noise=None,
              precision: str = "fast", group=None, dp: str = "shard_map"):
    """One step with its metrics left on the device: on a card, in a
    single process or under an NCCL group, it replays ``graphed_step``'s
    graph (``state`` is donated to it); otherwise (the CPU, a gloo group)
    it runs eagerly (``_step``)."""
    dev = _device(state)
    if enabled(dev) and mesh.graphable(group):
        wav = torch.as_tensor(wav, dtype=torch.float32)
        return graphed_step(cfg, wav.shape, dev, precision, group, dp)(
            state, wav, noise)
    return _step(cfg, state, wav, noise, precision, group, dp)


def _floats(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """Every metric as a Python float, with one device synchronisation
    (the ``step.read`` span)."""
    with span("step.read"):
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


def train_step(cfg: PipelineConfig, state: GANState, wav,
               noise=None, precision: str = "fast", group=None,
               dp: str = "shard_map") -> tuple[GANState, dict[str, float]]:
    """One alternating D/G update on a waveform batch ``[B, L]``.

    ``noise``: the three standard-normal ``[B, L]`` realisations of the
    instance noise (tensors or arrays), in place of draws from
    ``state.rng``; used only when ``cfg.train.d_input_noise > 0``.
    ``precision``: the fused log-mel kernel's mode ("fast" or "exact").
    ``group``: the process group of a data-parallel step, whose rank holds
    ``wav`` (and ``noise``) as its rows of the global batch; ``dp`` says
    which reference step it follows (the module's docstring).

    On a card the step replays the CUDA graph of ``graphed_step``, in a
    single process and under an NCCL ``group`` (its collectives captured):
    the returned state's tensors are that graph's buffers, and ``state``
    is donated to it (``GraphedStep``). On the CPU, and under a gloo
    group, the step runs eagerly and returns new tensors.
    """
    new_state, metrics = _run_step(cfg, state, wav, noise, precision, group,
                                   dp)
    return new_state, _floats(metrics)


def train_step_many(cfg: PipelineConfig, state: GANState, wavs, noise=None,
                    group=None, dp: str = "shard_map"
                    ) -> tuple[GANState, dict[str, float]]:
    """``len(wavs)`` chained steps over ``wavs [K, B, L]``, the same as K
    ``train_step`` calls; returns the last step's metrics (the reference's
    ``lax.scan`` in one dispatch). ``noise``: ``[K, 3, B, L]``, each
    step's three instance-noise normals, in place of draws. On a card, in
    a single process and under an NCCL ``group`` (the reference's
    ``shard_map`` K-step scan), a call replays the step's graph K times
    back to back and reads the metrics once, after the last."""
    wavs = torch.as_tensor(wavs, dtype=torch.float32, device=_device(state))
    if len(wavs) == 0:
        raise ValueError("train_step_many needs at least one batch")
    for i, wav in enumerate(wavs):
        state, metrics = _run_step(
            cfg, state, wav, None if noise is None else noise[i],
            group=group, dp=dp)
    return state, _floats(metrics)
