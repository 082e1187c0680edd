"""Stage-2 vocoder GAN training (counterpart of ``train/stage2.py``).

``train_step`` takes one D update on the detached fake (hinge or logistic
loss, optional R1 penalty and instance noise), then one G update against
the *updated* D (adversarial, feature-matching and multi-resolution STFT
terms, optional frame-energy and phase terms), then the EMA of G. It
returns the new ``GANState`` and the metrics of the JAX step, under the
same keys, as Python floats.

The step runs on the engine of ``train/state.py`` (``stage``). On a card
it replays one CUDA graph per config and batch shape (``GraphedStep``,
the reference's jitted step, to which the state is donated), in a single
process and on the ranks of an NCCL group, whose collectives the graph
captures. Both sides of the warmup gate are one program: the gate, the
noise sigma and Adam's scalars are 0-d tensors filled before each
replay. ``train_step_many`` replays the graph K times
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
forward's output; under a group each gradient's all-reduce is the region
``grad_allreduce`` (two per step, D's and G's). The host's work around
a replay is in the engine's spans ``step.draws``, ``step.inputs`` and
``step.read``, and ``graph.launch``.

With ``cfg.vocoder.block == "codec"`` G is DAC's codec
(``models/codec.py``): it takes the waveform itself and the per-row count
of quantizer stages each row keeps (quantizer dropout, drawn with the
instance noise in ``_draws`` and handed to G as an input, so G draws
nothing), and its commitment and codebook losses join G's loss. DAC's
objective is the config's too: LSGAN, summed feature matching, the
multi-scale mel loss (``losses/mel_loss.py``, ``lambda_mel``), a clip per
player, AdamW. G's reported reconstruction term is the mel loss where
``lambda_mel`` weights it, and the multi-resolution STFT distance
otherwise, computed and reported then at any ``lambda_stft``; beside the
mel loss the STFT term is computed only at ``lambda_stft`` > 0.

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

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from music_synthesis_tpu_torch.config import PipelineConfig
from music_synthesis_tpu_torch.losses.gan import (
    d_loss_fn,
    feature_matching_loss,
    g_loss_fn,
)
from music_synthesis_tpu_torch.losses.mel_loss import multiscale_mel_loss
from music_synthesis_tpu_torch.losses.phase_loss import phase_coherence_loss
from music_synthesis_tpu_torch.losses.stft_loss import multires_stft_loss
from music_synthesis_tpu_torch.models.codec import Codec
from music_synthesis_tpu_torch.models.discriminators import (
    CombinedDiscriminator,
)
from music_synthesis_tpu_torch.models.vocoder import Vocoder
from music_synthesis_tpu_torch.ops.frontend import log_mel_for_vocoder
from music_synthesis_tpu_torch.ops.logmel import fused_log_mel_for_vocoder
from music_synthesis_tpu_torch.parallel import mesh
from music_synthesis_tpu_torch.train.state import (
    AdamState,
    Draws,
    GANState,
    InPlaceStep,
    Stage,
    _copy_generator,
    _device,
    _floats,
    global_norm,
    make_optimizer,
    new_state,
    noise_scale,
    reduce_metrics,
    run_step,
    step_for,
)
from music_synthesis_tpu_torch.utils.profiling import region

__all__ = ["make_models", "is_codec", "conditioning_mel", "generate",
           "make_train_state", "stage", "GraphedStep", "graphed_step",
           "train_step", "train_step_many"]


def is_codec(cfg: PipelineConfig) -> bool:
    """Whether G is DAC's codec (``vocoder.block == "codec"``)."""
    return cfg.vocoder.block == "codec"


def make_models(cfg: PipelineConfig,
                generator: torch.Generator | None = None):
    """G (the vocoder, or the codec of ``cfg.codec``) and the combined D
    of ``cfg``."""
    gen = (Codec(cfg.codec, generator) if is_codec(cfg)
           else Vocoder(cfg.vocoder, generator))
    return gen, CombinedDiscriminator(cfg.msd, cfg.mrd, generator, cfg.mpd,
                                      cfg.train.d_input_peak)


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


def generate(cfg: PipelineConfig, gen, params: dict, wav: torch.Tensor
             ) -> torch.Tensor:
    """G's waveform for the real batch ``wav [B, L]``, no gradient: the
    codec's resynthesis with every quantizer stage, or the vocoder's of
    the conditioning mel."""
    with torch.no_grad():
        if is_codec(cfg):
            return functional_call(gen, params, (wav,))[0]
        return functional_call(gen, params, (conditioning_mel(wav, cfg),))


def make_train_state(cfg: PipelineConfig, seed: int | None = None,
                     device: str | torch.device | None = None) -> GANState:
    """Seeded G and D parameters, zeroed Adam states, step 0, on ``device``
    (``cuda`` unless told otherwise). ``seed`` defaults to
    ``cfg.train.seed``; the instance-noise generator is seeded with
    ``seed + 1`` (``train.state.new_state``)."""
    return new_state(cfg, make_models, seed, device)


def _frame_rms(x: torch.Tensor, hop: int) -> torch.Tensor:
    f = x[:, : (x.shape[1] // hop) * hop].reshape(x.shape[0], -1, hop)
    return torch.sqrt(torch.mean(torch.square(f), -1) + 1e-8)


def _gate_open(cfg: PipelineConfig, step: int) -> bool:
    """Whether the adversarial game is on at ``step`` (the warmup gate)."""
    t = cfg.train
    return t.g_warmup_steps <= 0 or step >= t.g_warmup_steps


def _draws(cfg: PipelineConfig, state: GANState, dev: torch.device, shape,
           noise=None, keep=None, group=None, dp: str = "shard_map"):
    """``(rng, draws)``, drawn from a copy of ``state.rng`` (returned,
    advanced) where not given: with instance noise the step's three
    normals of the batch's ``shape`` on ``dev`` (or ``noise``); for a codec
    then the quantizer stages each row keeps, ``[B]`` fp32 (or ``keep``):
    the first ``int(B * quantizer_dropout)`` rows a uniform draw of 1 ..
    ``n_codebooks``, the others ``n_codebooks``."""
    rng = _copy_generator(state.rng)
    draws = Draws(rng, group, dp)
    out = ()
    if cfg.train.d_input_noise > 0:
        if noise is None:
            noise = [draws.normal(shape) for _ in range(3)]
        out = tuple(torch.as_tensor(n, dtype=torch.float32, device=dev)
                    for n in noise)
    if is_codec(cfg):
        if keep is None:
            n, b = cfg.codec.n_codebooks, shape[0]
            drop = torch.arange(b, device=dev) < int(
                b * cfg.codec.quantizer_dropout)
            drawn = 1.0 + torch.floor(draws.uniform((b,)) * n)
            keep = torch.where(drop, drawn, torch.full_like(drawn, n))
        out += (torch.as_tensor(keep, dtype=torch.float32, device=dev),)
    return rng, out


def _scalars(cfg: PipelineConfig, state: GANState) -> list[float]:
    """The step's per-step fp32 scalars: the instance-noise sigma, the
    warmup gate (1.0 once the adversarial game is on, else 0.0), then
    ``(lr, bc1, bc2)`` of G's Adam and of D's (``Adam.scalars``)."""
    t = cfg.train
    return [noise_scale(cfg, state.step),
            float(_gate_open(cfg, state.step)),
            *make_optimizer(t.g_lr, t).scalars(state.g_opt.count),
            *make_optimizer(t.d_lr, t).scalars(state.d_opt.count)]


def _update(cfg: PipelineConfig, state: GANState, wav: torch.Tensor,
            draws: tuple, scalars, precision: str, group=None,
            dp: str = "shard_map"):
    """The step's arithmetic on given draws (``_draws``') and ``_scalars``
    (floats, or 0-d fp32 tensors): ``(g_params, d_params, g_opt, d_opt,
    g_ema, metrics)``, new tensors; nothing is changed in place. No value
    is read back to the host and nothing branches on the step, so both
    sides of the warmup gate are one program."""
    t = cfg.train
    codec = is_codec(cfg)
    gen, disc = _modules(cfg)
    g_tx = make_optimizer(t.g_lr, t, t.g_grad_clip_norm)
    d_tx = make_optimizer(t.d_lr, t, t.d_grad_clip_norm)
    sigma, gate = scalars[0], scalars[1]
    g_scalars, d_scalars = scalars[2:5], scalars[5:8]
    dev = wav.device
    b = wav.shape[0]

    if codec:
        *noise, keep = draws
        g_args = (wav, keep)
    else:
        noise = draws
        with region("frontend"):
            g_args = (conditioning_mel(wav, cfg, precision),)
    g_names = list(state.g_params)
    g_leaves = [p.detach().requires_grad_() for p in state.g_params.values()]
    g_in = dict(zip(g_names, g_leaves))

    def run_g(*x):
        return functional_call(gen, g_in, x)

    with region("generator_fwd"):
        # G draws nothing, so the recomputation needs no RNG state (whose
        # stash a CUDA graph's capture would refuse).
        fake = (checkpoint(run_g, *g_args, use_reentrant=False,
                           preserve_rng_state=False)
                if t.remat_generator else run_g(*g_args))
    if codec:
        fake, commitment, codebook = fake
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
            with region("grad_allreduce"):
                d_grads = mesh.all_reduce_mean(d_grads, group)
        d_grad_norm = global_norm(d_grads)
        d_updates, d_opt = d_tx.update(dict(zip(d_names, d_grads)),
                                      state.d_opt, d_scalars, state.d_params)
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
            fm = feature_matching_loss(real_feats_g, fake_feats,
                                       t.feature_matching)
            adv_w = gate if t.g_warmup_steps > 0 else 1.0
            total = adv_w * (adv + t.lambda_feature_matching * fm)
            aux = {"g_adv": adv, "g_fm": fm}
            if t.lambda_stft > 0 or t.lambda_mel == 0:
                stft = multires_stft_loss(fake, wav, cfg.stft_loss, group)
                total = total + t.lambda_stft * stft
                aux["g_stft"] = stft
            if t.lambda_mel > 0:
                mel_l1 = multiscale_mel_loss(fake, wav,
                                             cfg.frontend.sample_rate)
                total = total + t.lambda_mel * mel_l1
                aux["g_mel"] = mel_l1
            if codec:
                total = (total + t.lambda_commitment * commitment
                         + t.lambda_codebook * codebook)
                aux["g_commitment"] = commitment
                aux["g_codebook"] = codebook
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
            with region("grad_allreduce"):
                g_grads = mesh.all_reduce_mean(g_grads, group)
        g_grad_norm = global_norm(g_grads)
        g_updates, g_opt = g_tx.update(dict(zip(g_names, g_grads)),
                                       state.g_opt, g_scalars, state.g_params)
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


def stage(precision: str = "fast") -> Stage:
    """The stage-2 step as the engine runs it (``train.state.Stage``), its
    conditioning mel in the log-mel kernel's mode ``precision``: D's Adam
    count moves only once the warmup gate is open."""
    return Stage("stage2_step", _draws, _scalars, _update, _gate_open,
                 (precision,))


def GraphedStep(cfg: PipelineConfig, device: torch.device | str,
                precision: str = "fast", group=None,
                dp: str = "shard_map") -> InPlaceStep:
    """The step in place (``train.state.InPlaceStep``), for one config,
    batch shape and log-mel ``precision``: on a CUDA device one CUDA graph
    (the reference's ``jax.jit(train_step, donate_argnums=1)``), R1's
    double backward and the log-mel kernel's launch inside it, both sides
    of the warmup gate in one program (the gate is one of its per-step
    scalars); on the CPU the same arithmetic run eagerly. A call is
    ``step(state, wav, noise=None)``.

    ``group`` and ``dp``: the data-parallel step (the reference's
    ``make_dp_stage2_step`` / ``make_shardmap_stage2_step`` programs). Its
    draws, the shard_map seeding's host read among them, stay eager; the
    gradient all-reduces, the losses' cross-rank sums and the metrics'
    means are in the graph.
    """
    return InPlaceStep(stage(precision), cfg, device, group, dp)


def graphed_step(cfg: PipelineConfig, shape, device: torch.device,
                 precision: str = "fast", group=None,
                 dp: str = "shard_map") -> InPlaceStep:
    """The process's ``GraphedStep`` of ``cfg`` for batches of ``shape``
    on ``device`` (``train.state.step_for``)."""
    return step_for(stage(precision), cfg, shape, device, group, dp)


def train_step(cfg: PipelineConfig, state: GANState, wav,
               noise=None, precision: str = "fast", group=None,
               dp: str = "shard_map", keep=None
               ) -> tuple[GANState, dict[str, float]]:
    """One alternating D/G update on a waveform batch ``[B, L]``.

    ``noise``: the three standard-normal ``[B, L]`` realisations of the
    instance noise (tensors or arrays), in place of draws from
    ``state.rng``; used only when ``cfg.train.d_input_noise > 0``.
    ``keep``: for a codec, the quantizer stages each row keeps ``[B]``, in
    place of the quantizer-dropout draw.
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
    new_state, metrics = run_step(stage(precision), cfg, state, wav,
                                  {"noise": noise, "keep": keep}, group, dp)
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
        state, metrics = run_step(
            stage(), cfg, state, wav,
            {"noise": None if noise is None else noise[i]}, group, dp)
    return state, _floats(metrics)
