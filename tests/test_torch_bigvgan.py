"""BigVGAN's generator in the port (``models/vocoder.py`` with block
``amp``, ``ops/alias_free.py``) against its plain reference
(``benchmark/reference/bigvgan.py``, written from the published
equations), at ``config.TINY_BIGVGAN`` on the CPU; and the port's other vocoders against
the benchmark's frozen copy of them, output for output.

Tolerances: the op and G in fp32 against the reference's fp32 differ by
the order of the same operations (the weight norm's product, the port's
cached filter) only: 1e-6 relative on outputs, 1e-4 on each parameter's
gradient norm (sums over a batch in fp32). The training steps run the
port's full step (log-mel, G, MSD+MRD, losses, Adam) and the benchmark's
plain step on the same tensors: 1e-4 relative on the losses, 1e-3 on each
leaf's first-gradient norm, as ``tests/torch_train_ref.py`` holds the
port to JAX.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "benchmark") not in sys.path:
    sys.path.append(str(ROOT / "benchmark"))

from music_synthesis_tpu_torch import config, zoo  # noqa: E402
from music_synthesis_tpu_torch.models.vocoder import Vocoder  # noqa: E402
from music_synthesis_tpu_torch.ops import alias_free  # noqa: E402
from music_synthesis_tpu_torch.train import stage2  # noqa: E402
from music_synthesis_tpu_torch.train.state import AdamState  # noqa: E402
from reference import bigvgan as ref  # noqa: E402

CFG = config.TINY_BIGVGAN
# 6 stages x 2 kernels x 2 dilations x 2 activations, and the last one.
TINY_ACTS = 6 * 2 * 2 * 2 + 1


def _params(cfg=CFG.vocoder, seed=0) -> dict:
    """The port's own init, with biases and every activation's log-scale
    ``alpha``, ``beta`` drawn N(0, 0.3^2) so that a swap of the two shows."""
    g = Vocoder(cfg, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    out = {}
    for k, v in g.state_dict().items():
        if k.endswith((".alpha", ".beta")):
            v = 0.3 * torch.randn(v.shape, generator=gen)
        elif k.endswith(".b"):
            v = 0.05 * torch.randn(v.shape, generator=gen)
        out[k] = v.detach().clone()
    return out


def _models(sd, cfg=CFG.vocoder):
    port, plain = Vocoder(cfg), ref.BigVGAN(cfg)
    port.load_state_dict(sd)
    plain.load_state_dict(sd)
    return port, plain


def test_filter_taps():
    h = alias_free.kaiser_sinc()
    assert h.shape == (12,) and h.dtype == torch.float64
    assert abs(float(h.sum()) - 1.0) < 1e-15
    torch.testing.assert_close(h, h.flip(0), rtol=0, atol=1e-17)
    # Kaiser's beta of A = 2.285 * 5 * pi * 1.2 + 7.95 = 51.02 (> 50).
    a = 2.285 * 5 * math.pi * 1.2 + 7.95
    assert a > 50
    beta = 0.1102 * (a - 8.7)
    n = np.arange(12)
    w = np.i0(beta * np.sqrt(1 - (2 * n / 11 - 1) ** 2)) / np.i0(beta)
    t = n - 6 + 0.5
    want = 0.5 * w * np.sinc(0.5 * t)
    np.testing.assert_allclose(h.numpy(), want / want.sum(), rtol=1e-12)
    torch.testing.assert_close(h, ref.kaiser_sinc(), rtol=1e-13, atol=0)


@pytest.mark.parametrize("length", [1, 2, 7, 64])
def test_resampling_keeps_lengths(length):
    x = torch.randn(2, 3, length)
    h = alias_free._filter(3, x.device, torch.float32)
    up = alias_free.upsample2(x, h)
    assert up.shape == (2, 3, 2 * length)
    assert alias_free.downsample2(up, h).shape == (2, 3, length)
    torch.testing.assert_close(up, ref.up2(x), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(alias_free.downsample2(up, h), ref.down2(up),
                               rtol=1e-6, atol=1e-6)


def test_op_forward_matches_the_reference():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 40, generator=gen)
    a, b = (0.3 * torch.randn(5, generator=gen) for _ in range(2))
    torch.testing.assert_close(alias_free.aa_snake_beta(x, a, b),
                               ref.act(x, a, b), rtol=1e-6, atol=1e-6)
    y = alias_free.aa_snake_beta(x.bfloat16(), a, b)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), ref.act(x.bfloat16(), a, b),
                               rtol=1e-2, atol=1e-2)


def test_op_gradients_gradcheck_in_float64():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, 9, dtype=torch.float64, generator=gen)
    a, b = (0.3 * torch.randn(3, dtype=torch.float64, generator=gen)
            for _ in range(2))
    args = [t.requires_grad_() for t in (x, a, b)]
    assert torch.autograd.gradcheck(alias_free.aa_snake_beta, args)
    # and each gradient alone (the backward returns only what is asked)
    for i in range(3):
        part = [t.detach().requires_grad_(j == i) for j, t in
                enumerate(args)]
        assert torch.autograd.gradcheck(alias_free.aa_snake_beta, part)


def test_op_saves_only_its_inputs():
    x = torch.randn(2, 4, 16, requires_grad=True)
    a, b = torch.zeros(4, requires_grad=True), torch.zeros(4,
                                                           requires_grad=True)
    y = alias_free.aa_snake_beta(x, a, b)
    saved = y.grad_fn.saved_tensors
    assert [t.shape for t in saved] == [x.shape, a.shape, b.shape]
    with pytest.raises(RuntimeError):  # once differentiable
        (gx,) = torch.autograd.grad(y.sum(), x, create_graph=True)
        gx.sum().backward()


#: BigVGAN's six activation shapes at the benchmark's batch of 32.
BIGVGAN_SHAPES = [(32, 768, 128), (32, 384, 512), (32, 192, 1024),
                  (32, 96, 2048), (32, 48, 4096), (32, 24, 8192)]
H100_SMS = 132


@pytest.mark.parametrize("shape", BIGVGAN_SHAPES + [
    (2, 3, 1), (2, 3, 2), (2, 3, 7), (2, 3, 129)])
def test_kernel_tiling_covers_every_output_once(monkeypatch, shape):
    """The CUDA kernel's grid (``alias_free.tiling``, which the wrapper
    hands the kernel: ``n_col`` and ``blocks``, the blocks' own arithmetic
    in ``Tiling.block``) writes every output sample of every row exactly
    once, from blocks that each hold at least one, and each (row, span)
    pair of the backward's parameter partials once; its spans are whole
    groups of 8 and its rows fit the shared memory budget; at batch 32
    each shape gives every SM of an H100 at least 4 blocks."""
    batch, channels, length = shape
    rows = batch * channels
    t = alias_free.tiling(rows, length, H100_SMS)
    assert t.span % 8 == 0 and t.span >= 8 and t.rows_per_block >= 1
    assert t.rows_per_block * (t.span + alias_free._HALO) \
        <= alias_free._TILE_WORDS
    seen = np.zeros((rows, length), np.int32)
    partial = np.zeros((rows, t.n_col), np.int32)
    for i in range(t.blocks):
        r0, nr, t0, tn = t.block(i)
        assert nr >= 1 and tn >= 1 and nr <= t.rows_per_block \
            and tn <= t.span and t0 % t.span == 0
        seen[r0:r0 + nr, t0:t0 + tn] += 1
        partial[r0:r0 + nr, t0 // t.span] += 1
    assert (seen == 1).all() and (partial == 1).all()
    assert t.partial_words == 2 * partial.size
    monkeypatch.setattr(alias_free, "_n_sm", lambda device: H100_SMS)
    got, args = alias_free._launch_args(torch.empty(shape,
                                                    dtype=torch.bfloat16))
    assert got == t
    assert args[1:8] == (batch, channels, length, t.rows_per_block, t.span,
                         t.n_col, t.blocks)
    if batch == 32:
        assert t.blocks >= 4 * H100_SMS
        assert 1024 <= t.rows_per_block * min(t.span, length) <= 2048


def test_generator_output_and_every_gradient():
    sd = _params()
    port, plain = _models(sd)
    mel = 0.5 * torch.randn(2, 8, CFG.vocoder.n_mels,
                            generator=torch.Generator().manual_seed(5))
    before = alias_free.aa_act.n_calls
    y = port(mel)
    assert alias_free.aa_act.n_calls - before == TINY_ACTS
    yr = plain(mel)
    assert y.shape == yr.shape == (2, 8 * 256)
    torch.testing.assert_close(y, yr, rtol=1e-6, atol=1e-6)
    w = torch.linspace(-1, 1, y.shape[-1])
    gp = torch.autograd.grad((y * w).sum(), list(port.parameters()))
    gr = torch.autograd.grad((yr * w).sum(), list(plain.parameters()))
    names = [k for k, _ in port.named_parameters()]
    assert names == [k for k, _ in plain.named_parameters()]
    for k, a, b in zip(names, gp, gr):
        assert a.norm() > 0, k
        assert float((a - b).norm() / b.norm()) < 1e-4, k


def test_published_widths_count_112_2m_and_109_activations():
    cfg = config.BIGVGAN_22K_80BAND.vocoder
    with torch.device("meta"):
        g = Vocoder(cfg)
        plain = ref.BigVGAN(cfg)
    n = sum(p.numel() for p in g.parameters())
    assert n == 112_231_250
    assert {k: p.shape for k, p in g.named_parameters()} == {
        k: p.shape for k, p in plain.named_parameters()}
    assert sum(k.endswith(".alpha") for k, _ in g.named_parameters()) == 109
    assert g.upsample_0.g.shape == (1536,)  # per input channel
    # upstream's upsampling kernels, twice each rate
    assert [getattr(g, f"upsample_{i}").v.shape[0] for i in range(6)] == [
        8, 8, 4, 4, 4, 4]


@pytest.mark.parametrize("change", [
    {"mrf_kernels": ()}, {"head": "istft"}, {"upsample_mode": "repeat"},
    {"block": "no_such_block"}])
def test_vocoder_refuses_what_the_amp_block_cannot_build(change):
    with pytest.raises(ValueError):
        Vocoder(dataclasses.replace(CFG.vocoder, **change))


def _step_state(cfg, sd_g, seed=6):
    """The port's training state with G's tensors ``sd_g`` and a seeded D
    (the port's init), Adam at zero, and its copy for the reference."""
    st = stage2.make_train_state(cfg, seed, "cpu")
    st = dataclasses.replace(st, g_params={k: v.clone() for k, v in
                                           sd_g.items()},
                             g_opt=AdamState(0, *({k: torch.zeros_like(v)
                                                   for k, v in sd_g.items()}
                                                  for _ in range(2))))
    return st


def test_two_train_steps_match_the_plain_step():
    from harness.config import ns
    from reference import train_step as plain_step
    from reference.model import CombinedDiscriminator, strict_fp32

    cfg = dataclasses.replace(CFG, train=dataclasses.replace(
        CFG.train, adam_b1=0.8, adam_b2=0.99, lambda_stft=10.0))
    st = _step_state(cfg, _params())
    p0 = {"g": {k: v.clone() for k, v in st.g_params.items()},
          "d": {k: v.clone() for k, v in st.d_params.items()}}
    rng = np.random.default_rng(7)
    wavs = [torch.from_numpy((0.5 * np.tanh(rng.standard_normal(
        (2, 2048)))).astype(np.float32)) for _ in range(2)]
    got = []
    for wav in wavs:
        st, m = stage2.train_step(cfg, st, wav)
        got.append(m)
        if len(got) == 1:
            g1 = {k: v / (1 - cfg.train.adam_b1) for k, v in
                  st.g_opt.mu.items()}

    rcfg = ns(config.config_to_dict(cfg))
    with torch.device("meta"):
        gen, disc = ref.BigVGAN(rcfg.vocoder), CombinedDiscriminator(
            rcfg.msd, rcfg.mrd)
    s = plain_step.RefState(p0["g"], p0["d"], 0, 0, 0)
    want = []
    with strict_fp32(), ref.magnitude_mel():
        for i, wav in enumerate(wavs):
            out = plain_step.step(rcfg, s, wav, gen, disc,
                                  keep_grads=i == 0)
            want.append(out)
    for m, w in zip(got, want):
        for k in ("d_loss", "g_loss", "g_adv", "g_fm", "g_stft"):
            assert abs(m[k] - float(w[k])) <= 1e-4 * abs(float(w[k])), k
    for k, v in want[0]["g_grads"].items():
        gap = float((g1[k].norm() - v.norm()).abs() / v.norm().clamp(
            min=1e-12))
        assert gap < 1e-3, k
    for k in s.g:
        torch.testing.assert_close(st.g_params[k], s.g[k], rtol=0,
                                   atol=2e-5)


def test_zoo_round_trip(tmp_path):
    sd = _params()
    zoo.save_pretrained("bigvgan_tiny", "vocoder", sd, CFG.vocoder,
                        frontend=CFG.frontend, mel_scaler=CFG.mel_scaler,
                        root=tmp_path)
    entry = zoo.load_pretrained(tmp_path / "bigvgan_tiny")
    assert entry.config == CFG.vocoder
    assert entry.card["config"]["block"] == "amp"
    mel = torch.randn(1, 4, CFG.vocoder.n_mels)
    port, _ = _models(sd)
    torch.testing.assert_close(entry.model("cpu")(mel), port(mel), rtol=0,
                               atol=0)


def test_cli_trains_two_steps(tmp_path):
    from music_synthesis_tpu_torch.scripts import train_stage2

    out = tmp_path / "run"
    train_stage2.main(["--device", "cpu", "--preset", "tiny-bigvgan",
                       "--batch", "2", "--segment", "2048", "--steps", "2",
                       "--log-every", "1", "--ckpt-every", "2",
                       "--audio-every", "2", "--outdir", str(out)])
    run_cfg = config.config_from_dict(__import__("json").loads(
        (out / "config.json").read_text()))
    assert run_cfg.vocoder == CFG.vocoder
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2


@pytest.mark.parametrize("which", ["waveform", "istft"])
def test_other_vocoders_compute_what_they_computed(which, monkeypatch):
    """The rich (waveform) and flagship (iSTFT) vocoders at TINY against
    the benchmark's plain copy of the port's vocoder before BigVGAN came
    in, bit for bit. The iSTFT head's synthesis (unchanged, and in float64
    in the copy) is left out: both hand back its real and imaginary
    inputs."""
    import reference.model
    from harness.config import ns
    from music_synthesis_tpu_torch.models import vocoder as port_vocoder
    from reference.model import Vocoder as FrozenVocoder

    def spectrum(re, im, n_fft, hop):
        return torch.cat([re, im], -1)

    for module in (port_vocoder, reference.model):
        monkeypatch.setattr(module, "istft_synthesis", spectrum)

    vcfg = config.TINY.vocoder
    if which == "istft":
        vcfg = dataclasses.replace(vcfg, head="istft", upsample_factors=(8, 8))
    port = Vocoder(vcfg, torch.Generator().manual_seed(8))
    frozen = FrozenVocoder(ns(config.section_to_dict(vcfg)))
    frozen.load_state_dict(port.state_dict())
    mel = torch.randn(2, 6, vcfg.n_mels,
                      generator=torch.Generator().manual_seed(9))
    before = alias_free.aa_act.n_calls
    with torch.no_grad():
        assert torch.equal(port(mel), frozen(mel))
    assert alias_free.aa_act.n_calls == before


# -- the stage-2 objective and Adam as they were before DAC's codec came
# in (the port's losses/gan.py and train/state.py::Adam.update), frozen:
# the other configurations' D, losses and updates must stay bit for bit.

def _frozen_d_loss(kind, real, fake):
    loss = 0.0
    for r, f in zip(real, fake):
        if kind == "hinge":
            loss = (loss + torch.mean(torch.nn.functional.relu(1.0 - r))
                    + torch.mean(torch.nn.functional.relu(1.0 + f)))
        else:
            loss = (loss + torch.mean(torch.nn.functional.softplus(-r))
                    + torch.mean(torch.nn.functional.softplus(f)))
    return loss


def _frozen_g_loss(kind, fake):
    loss = 0.0
    for f in fake:
        loss = (loss - torch.mean(f) if kind == "hinge" else
                loss + torch.mean(torch.nn.functional.softplus(-f)))
    return loss


def _frozen_fm(real, fake):
    loss, n = 0.0, 0
    for r_head, f_head in zip(real, fake):
        for r, f in zip(r_head, f_head):
            loss = loss + torch.mean(torch.abs(f - r.detach()))
            n += 1
    return loss / max(n, 1)


def _frozen_adam(opt, named_grads, state, scalars):
    names, grads = list(named_grads), list(named_grads.values())
    if opt.clip > 0:
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        keep = norm < opt.clip
        grads = [torch.where(keep, g, g / norm * opt.clip) for g in grads]
    b1, b2 = opt.b1, opt.b2
    mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1),
                            torch._foreach_mul([state.mu[k] for k in names],
                                               b1))
    nu = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2),
        torch._foreach_mul([state.nu[k] for k in names], b2))
    lr, bc1, bc2 = scalars
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, opt.eps)
    updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    torch._foreach_mul_(updates, -lr)
    return updates, mu, nu


def _recipe(name: str):
    """``name``'s benchmark recipe (its train section, its D and G
    settings) at TINY's widths, grouped convolutions run as grouped (the
    frozen D has no dense lowering)."""
    import json

    src = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                     .read_text())["train"]
    base = config.TINY_BIGVGAN if name == "bigvgan" else config.TINY
    voc = dataclasses.replace(base.vocoder, **{
        k: src["vocoder"][k] for k in ("head", "init_scheme",
                                       "res_init_gain", "out_init_gain")})
    if voc.head == "istft":
        voc = dataclasses.replace(voc, upsample_factors=(8, 8))
    train = config.section_from_dict(config.TrainConfig, {
        **src["train"], "batch_size": 2, "segment_length": 2048})
    return dataclasses.replace(
        base, vocoder=voc, train=train,
        msd=dataclasses.replace(base.msd, dense_groups_max_g=0),
        mrd=dataclasses.replace(base.mrd,
                                input_mode=src["mrd"]["input_mode"]))


@pytest.mark.parametrize("name", ["flagship", "rich", "bigvgan"])
def test_other_configurations_keep_their_d_losses_and_adam(name):
    """flagship's, rich's and BigVGAN's recipes at TINY's widths: their G
    and D keep the parameter names of the benchmark's frozen models (so
    zoo cards and states load), and D's logits and features, the step's
    losses (D's, G's adversarial term, feature matching) and Adam's
    update of both players (the updated parameters and moments) are bit
    for bit those of the objective and Adam before the codec came in."""
    from harness.config import ns
    from music_synthesis_tpu_torch.losses import gan
    from music_synthesis_tpu_torch.train.state import make_optimizer
    from reference.model import CombinedDiscriminator as FrozenD
    from reference.model import Vocoder as FrozenG

    cfg = _recipe(name)
    t = cfg.train
    rc = ns(config.config_to_dict(cfg))
    g, d = stage2.make_models(cfg, torch.Generator().manual_seed(11))
    frozen_g = (ref.BigVGAN(rc.vocoder) if name == "bigvgan"
                else FrozenG(rc.vocoder))
    frozen_d = FrozenD(rc.msd, rc.mrd)
    assert [k for k, _ in g.named_parameters()] == [
        k for k, _ in frozen_g.named_parameters()]
    assert [k for k, _ in d.named_parameters()] == [
        k for k, _ in frozen_d.named_parameters()]
    frozen_d.load_state_dict(d.state_dict())
    gen = torch.Generator().manual_seed(12)
    real, fake = (0.5 * torch.tanh(torch.randn(2, 2048, generator=gen))
                  for _ in range(2))
    outs = {}
    for side, disc in (("port", d), ("frozen", frozen_d)):
        rl, rf = disc(real)
        fl, ff = disc(fake)
        outs[side] = rl, rf, fl, ff
    for a, b in zip(outs["port"], outs["frozen"]):
        for x, y in zip(a, b):
            for u, v in (zip(x, y) if isinstance(x, list) else [(x, y)]):
                assert torch.equal(u, v)
    rl, rf, fl, ff = outs["port"]
    d_loss = gan.d_loss_fn(t.gan_loss)(rl, fl)
    assert torch.equal(d_loss, _frozen_d_loss(t.gan_loss, rl, fl))
    assert torch.equal(gan.g_loss_fn(t.gan_loss)(fl),
                       _frozen_g_loss(t.gan_loss, fl))
    fm = gan.feature_matching_loss(rf, ff, t.feature_matching)
    assert torch.equal(fm, _frozen_fm(rf, ff))
    fl_g, ff_g = d(g(stage2.conditioning_mel(real, cfg)))
    g_loss = (gan.g_loss_fn(t.gan_loss)(fl_g)
              + gan.feature_matching_loss(rf, ff_g, t.feature_matching))
    for player, module, lr, loss in (("d", d, t.d_lr, d_loss),
                                     ("g", g, t.g_lr, g_loss)):
        params = dict(module.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), retain_graph=True)))
        opt = make_optimizer(lr, t, getattr(t, f"{player}_grad_clip_norm"))
        state = AdamState(7, *({k: 0.01 * torch.randn(
            v.shape, generator=gen) ** 2 for k, v in params.items()}
            for _ in range(2)))
        scalars = opt.scalars(state.count)
        updates, new = opt.update(grads, state, scalars, params)
        want, mu, nu = _frozen_adam(opt, grads, state, scalars)
        for k, a, b in zip(params, updates, want):
            assert torch.equal(a, b), k
            assert torch.equal(new.mu[k], mu[list(params).index(k)])
            assert torch.equal(new.nu[k], nu[list(params).index(k)])
