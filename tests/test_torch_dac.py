"""DAC's codec in the port (``models/codec.py``, ``ops/snake.py``, the MPD
and the banded MRD of ``models/discriminators.py``, the mel loss of
``losses/mel_loss.py``, LSGAN, AdamW) against its plain reference
(``benchmark/reference/dac.py``, written from the published equations), at
``config.TINY_DAC`` on the CPU, with seeded weights.

Tolerances: G and D in fp32 against the reference's fp32 differ by the
order of the same operations (the weight norm's product, the STFT as a
framed rFFT against ``torch.stft``): 1e-5 relative on outputs and losses.
The training steps run the port's full step (codec, MPD+MRD, LSGAN, mel
and VQ losses, the clips, AdamW) and the reference's on the same tensors
and the same quantizer draws: 1e-4 relative on the losses, 1e-3 on each
leaf's first-gradient norm, 2e-5 on the parameters after two steps, as
``tests/test_torch_bigvgan.py`` holds BigVGAN.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.func import functional_call

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "benchmark") not in sys.path:
    sys.path.append(str(ROOT / "benchmark"))

from music_synthesis_tpu_torch import config, zoo  # noqa: E402
from music_synthesis_tpu_torch.losses.gan import (  # noqa: E402
    lsgan_d_loss,
    lsgan_g_loss,
)
from music_synthesis_tpu_torch.losses.mel_loss import (  # noqa: E402
    multiscale_mel_loss,
)
from music_synthesis_tpu_torch.models import discriminators  # noqa: E402
from music_synthesis_tpu_torch.models.codec import (  # noqa: E402
    Codec,
    rvq_stage,
)
from music_synthesis_tpu_torch.ops import snake as snake_op  # noqa: E402
from music_synthesis_tpu_torch.train import stage2  # noqa: E402
from music_synthesis_tpu_torch.train.state import AdamState  # noqa: E402
from reference import dac as ref  # noqa: E402

#: TINY_DAC: an excerpt of 2051 samples, not a whole number of hops (8).
CFG = config.TINY_DAC
SEG = CFG.train.segment_length
# 2 encoder blocks x 7, 2 decoder blocks x 7, and the two last ones.
TINY_SNAKES = 2 * 7 + 2 * 7 + 2


def _rcfg(cfg=CFG):
    from harness.config import ns

    return ns(config.config_to_dict(cfg))


def _params(cfg=CFG, seed=0) -> tuple[dict, dict]:
    """G's and D's tensors: the port's init with every Snake ``alpha``
    drawn ``exp(N(0, 0.3^2))``, biases N(0, 0.05^2), and G's gains scaled
    from the port's 0.02 to PyTorch's default conv std ``1 / sqrt(3
    fan_in)`` (upstream's scale, as the benchmark draws it), so that every
    leaf of G, the encoder's first too, takes a gradient well above fp32's
    rounding of the others'."""
    g, d = stage2.make_models(cfg, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    sd = g.state_dict()
    out_g = {}
    for k, v in sd.items():
        if k.endswith(".alpha"):
            v = torch.exp(0.3 * torch.randn(v.shape, generator=gen))
        elif k.endswith(".b"):
            v = 0.05 * torch.randn(v.shape, generator=gen)
        elif k.endswith(".g"):
            fan_in = math.prod(sd[k[:-2] + ".v"].shape[:-1])
            v = v / (0.02 * math.sqrt(3 * fan_in))
        out_g[k] = v.detach().clone()
    out_d = {k: v.detach().clone() for k, v in d.state_dict().items()}
    return out_g, out_d


def _wav(rows=2, length=SEG, seed=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((0.5 * np.tanh(rng.standard_normal(
        (rows, length)))).astype(np.float32))


def _rel(a, b) -> float:
    return float((a - b).detach().norm() / b.detach().norm().clamp(min=1e-30))


def test_snake_gradcheck_in_float64_and_saves_only_x_and_alpha():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 9, dtype=torch.float64, generator=gen)
    a = torch.exp(0.3 * torch.randn(3, dtype=torch.float64, generator=gen))
    args = [t.requires_grad_() for t in (x, a)]
    assert torch.autograd.gradcheck(snake_op.snake, args)
    for i in range(2):  # each gradient alone
        part = [t.detach().requires_grad_(j == i) for j, t in
                enumerate(args)]
        assert torch.autograd.gradcheck(snake_op.snake, part)
    torch.testing.assert_close(snake_op.snake(x.float(), a.float()),
                               ref.snake(x.float(), a.float()), rtol=1e-6,
                               atol=1e-6)
    y = snake_op.snake(x.float().bfloat16(), a.float())
    assert y.dtype == torch.bfloat16
    saved = snake_op.snake(*args).grad_fn.saved_tensors
    assert [t.shape for t in saved] == [x.shape, a.shape]


def test_generator_output_codes_and_vq_losses():
    sd, _ = _params()
    port, plain = Codec(CFG.codec), ref.Codec(_rcfg().codec)
    port.load_state_dict(sd)
    plain.load_state_dict(sd)
    wav = _wav()
    keep = torch.tensor([1.0, 3.0])
    before = snake_op.snake_calls.n_calls, rvq_stage.n_calls
    with torch.no_grad():
        y, commit, book = port(wav, keep)
    assert snake_op.snake_calls.n_calls - before[0] == TINY_SNAKES
    assert rvq_stage.n_calls - before[1] == CFG.codec.n_codebooks
    with torch.no_grad():
        yr, commit_r, book_r = plain(wav, keep)
    assert y.shape == yr.shape == wav.shape and y.dtype == torch.float32
    assert float(y.detach().abs().max()) > 1e-3
    assert _rel(y, yr) < 1e-5
    for a, b in ((commit, commit_r), (book, book_r)):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    # the codes: the stage's nearest l2-normalised code
    z_q, _, _, codes = port.encode(wav, keep)
    assert codes.shape == (2, CFG.codec.n_codebooks, math.ceil(SEG / 8))
    with torch.no_grad():
        hop = CFG.codec.hop_length
        z = port.encoder(torch.nn.functional.pad(
            wav[:, None], (0, -SEG % hop))).float()
        stage = port.quantizer.stage_0
        z_e = stage.in_proj(z)
        cos = torch.einsum("bdt,nd->btn", torch.nn.functional.normalize(
            z_e, dim=1), torch.nn.functional.normalize(stage.codebook))
        assert torch.equal(codes[:, 0], cos.argmax(-1))


def test_discriminator_logits_and_features():
    _, sd = _params()
    rc = _rcfg()
    port = discriminators.CombinedDiscriminator(
        CFG.msd, CFG.mrd, None, CFG.mpd, CFG.train.d_input_peak)
    plain = ref.Discriminator(rc.mpd, rc.mrd, rc.train.d_input_peak)
    assert [k for k, _ in port.named_parameters()] == [
        k for k, _ in plain.named_parameters()]
    port.load_state_dict(sd)
    plain.load_state_dict(sd)
    wav = _wav()
    la, fa = port(wav)
    lb, fb = plain(wav)
    # 2 periods then 2 resolutions; each MRD head 5 bands x 5 layers
    assert len(la) == len(lb) == 4
    assert [len(h) for h in fa] == [len(h) for h in fb] == [5, 5, 25, 25]
    for a, b in zip(la, lb):
        assert a.shape == b.shape and _rel(a, b) < 1e-5
    for ha, hb in zip(fa, fb):
        for a, b in zip(ha, hb):
            assert a.shape == b.shape and _rel(a, b) < 1e-5
    # the input is normalised per row: a gain leaves D's outputs as they are
    lg, _ = port(3.0 * wav)
    for a, b in zip(la, lg):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_vq_gradient_passes_straight_through():
    """The stage's output is ``out_proj(z_e + sg(z_q - z_e))``: its
    gradient reaches ``in_proj`` (and the encoder) as if the code were the
    projection itself, and the codebook only through the codebook loss."""
    torch.manual_seed(4)
    stage = Codec(CFG.codec).quantizer.stage_0
    z = torch.randn(2, CFG.codec.latent_dim, 5, requires_grad=True)
    out, commit, book, _ = stage(z)
    w = torch.randn_like(out)
    gz, gbook = torch.autograd.grad((out * w).sum(), [z, stage.codebook],
                                    allow_unused=True)
    assert gbook is None or float(gbook.abs().max()) == 0.0
    z2 = z.detach().requires_grad_()
    straight = stage.out_proj(stage.in_proj(z2))
    (gz2,) = torch.autograd.grad((straight * w).sum(), z2)
    torch.testing.assert_close(gz, gz2, rtol=1e-6, atol=1e-7)
    (gb,) = torch.autograd.grad(book.sum(), stage.codebook)
    assert float(gb.abs().sum()) > 0
    assert torch.autograd.grad(commit.sum(), stage.codebook,
                               allow_unused=True)[0] is None


def test_rows_beyond_the_dropout_share_keep_every_stage():
    cfg = dataclasses.replace(CFG, train=dataclasses.replace(
        CFG.train, batch_size=8))
    state = stage2.make_train_state(cfg, 0, "cpu")
    seen = set()
    for _ in range(20):
        state.rng.manual_seed(int(torch.randint(0, 2 ** 31, (1,))))
        _, (keep,) = stage2._draws(cfg, state, torch.device("cpu"), (8, 64))
        n = cfg.codec.n_codebooks
        assert torch.equal(keep[4:], torch.full((4,), float(n)))
        assert ((keep[:4] >= 1) & (keep[:4] <= n)).all()
        assert torch.equal(keep, keep.round())
        seen.update(keep[:4].tolist())
    assert seen == {1.0, 2.0, 3.0}
    # a row keeps the stages below its count: stage i's output is masked
    sd, _ = _params()
    port = Codec(CFG.codec)
    port.load_state_dict(sd)
    wav = _wav()
    full, *_ = port.encode(wav, torch.tensor([3.0, 3.0]))
    one, *_ = port.encode(wav, torch.tensor([1.0, 3.0]))
    torch.testing.assert_close(one[1], full[1], rtol=0, atol=0)
    assert not torch.equal(one[0], full[0])


@pytest.mark.parametrize("n_fft", [64, 128, 512, 1024, 2048])
def test_bands_cover_every_bin_once(n_fft):
    bins = discriminators.band_bins(n_fft, config.DAC_44K.mrd.bands)
    n = n_fft // 2 + 1
    seen = np.zeros(n, np.int32)
    for lo, hi in bins:
        assert hi > lo
        seen[lo:hi] += 1
    assert (seen == 1).all()


def test_match_stride_stft_frames_a_hop_each():
    wav = _wav()
    s = discriminators.match_stride_stft(wav, 128, 32, 128)
    assert s.shape == (2, math.ceil(SEG / 32), 65)
    r = ref.match_stride_stft(wav, 128, 32)
    torch.testing.assert_close(torch.stack([s.real, s.imag], 1), r,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("period", [2, 3, 5])
def test_mpd_fold_equals_a_loop_over_the_phases(period):
    """The fold ``[B, 1, L/p, p]`` under (k, 1) kernels: column ``j`` of each
    output is the head run on the phase ``x[j::p]`` of the padded input
    alone."""
    mpd = dataclasses.replace(CFG.mpd, periods=(period,))
    head = discriminators.PeriodDiscriminator(
        period, mpd, torch.Generator().manual_seed(5))
    wav = _wav()
    logit, feats = head(wav)
    x = torch.nn.functional.pad(wav[:, None], (0, period - SEG % period),
                                mode="reflect")[:, 0]
    for j in range(period):
        y = x[:, j::period][:, None, :, None]
        for i in range(head.n_convs):
            y = torch.nn.functional.leaky_relu(
                getattr(head, f"conv_{i}")(y), discriminators.MPD_SLOPE)
            torch.testing.assert_close(feats[i][..., j:j + 1], y, rtol=0,
                                       atol=1e-6)
        torch.testing.assert_close(logit[..., j:j + 1], head.conv_out(y),
                                   rtol=0, atol=1e-6)


def test_losses_match_the_reference_forms():
    gen = torch.Generator().manual_seed(6)
    real = [torch.randn(2, 1, 7, 3, generator=gen) for _ in range(3)]
    fake = [torch.randn(2, 1, 7, 3, generator=gen) for _ in range(3)]
    want_d = sum(torch.mean(f ** 2) + torch.mean((1 - r) ** 2)
                 for r, f in zip(real, fake))
    want_g = sum(torch.mean((1 - f) ** 2) for f in fake)
    torch.testing.assert_close(lsgan_d_loss(real, fake), want_d)
    torch.testing.assert_close(lsgan_g_loss(fake), want_g)
    x, y = _wav(seed=7), _wav(seed=8)
    got = multiscale_mel_loss(x, y, 44_100)
    want = ref.mel_loss(x, y, 44_100)
    assert abs(float(got) - float(want)) <= 1e-5 * float(want)
    assert float(multiscale_mel_loss(x, x, 44_100)) == 0.0


def test_two_train_steps_match_the_plain_step():
    sd_g, sd_d = _params()
    st = stage2.make_train_state(CFG, 6, "cpu")
    zeros = [{k: torch.zeros_like(v) for k, v in p.items()} for p in
             (sd_g, sd_g, sd_d, sd_d)]
    st = dataclasses.replace(
        st, g_params={k: v.clone() for k, v in sd_g.items()},
        d_params={k: v.clone() for k, v in sd_d.items()},
        g_opt=AdamState(0, zeros[0], zeros[1]),
        d_opt=AdamState(0, zeros[2], zeros[3]))
    wavs = [_wav(seed=9), _wav(seed=10)]
    keeps = [torch.tensor([2.0, 3.0]), torch.tensor([1.0, 3.0])]
    got = []
    for wav, keep in zip(wavs, keeps):
        st, m = stage2.train_step(CFG, st, wav, keep=keep)
        got.append(m)
        if len(got) == 1:
            g1 = {k: v / (1 - CFG.train.adam_b1) for k, v in
                  st.g_opt.mu.items()}
            d1 = {k: v / (1 - CFG.train.adam_b1) for k, v in
                  st.d_opt.mu.items()}

    rcfg = _rcfg()
    gen, disc = ref.models(rcfg)
    s = ref.RefState(sd_g, sd_d, 0, 0, 0)
    want = [ref.step(rcfg, s, wav, gen, disc, keep=keep, keep_grads=i == 0)
            for i, (wav, keep) in enumerate(zip(wavs, keeps))]
    for m, w in zip(got, want):
        for k in ("d_loss", "g_loss", "g_adv", "g_fm", "g_mel",
                  "g_commitment", "g_codebook"):
            assert abs(m[k] - float(w[k])) <= 1e-4 * abs(float(w[k])), k
    # the clip at 1e3 and 10 binds G and D in this step: their norms in the
    # clipped Adam's first moment
    for mine, theirs in ((g1, want[0]["g_grads"]), (d1, want[0]["d_grads"])):
        coef = float(ref.clip_coefficient(
            theirs, CFG.train.g_grad_clip_norm if mine is g1
            else CFG.train.d_grad_clip_norm))
        for k, v in theirs.items():
            gap = float((mine[k].norm() - coef * v.norm()).abs()
                        / (coef * v.norm()).clamp(min=1e-12))
            assert gap < 1e-3, k
    for part, ours, theirs in (("g", st.g_params, s.g),
                               ("d", st.d_params, s.d)):
        for k in theirs:
            torch.testing.assert_close(ours[k], theirs[k], rtol=0,
                                       atol=2e-5, msg=f"{part} {k}")


def test_zoo_round_trip(tmp_path):
    sd, _ = _params()
    zoo.save_pretrained("dac_tiny", "codec", sd, CFG.codec,
                        frontend=CFG.frontend, root=tmp_path)
    entry = zoo.load_pretrained(tmp_path / "dac_tiny")
    assert entry.config == CFG.codec
    wav = _wav()
    port = Codec(CFG.codec)
    port.load_state_dict(sd)
    torch.testing.assert_close(entry.model("cpu")(wav)[0], port(wav)[0],
                               rtol=0, atol=0)


def test_config_round_trip_writes_the_new_sections_only_for_a_codec():
    d = config.config_to_dict(config.DAC_44K)
    assert d["codec"]["decoder_dim"] == 1536 and d["mpd"]["periods"] == [
        2, 3, 5, 7, 11]
    assert config.config_from_dict(json.loads(json.dumps(d))) == \
        config.DAC_44K
    for other in (config.PipelineConfig(), config.TINY,
                  config.BIGVGAN_22K_80BAND):
        d = config.config_to_dict(other)
        assert "codec" not in d and "mpd" not in d
        assert "bands" not in d["mrd"] and "lambda_mel" not in d["train"]


def test_cli_trains_two_steps(tmp_path):
    from music_synthesis_tpu_torch.scripts import train_stage2

    out = tmp_path / "run"
    train_stage2.main(["--device", "cpu", "--preset", "tiny-dac44k",
                       "--batch", "2", "--segment", str(SEG), "--steps", "2",
                       "--log-every", "1", "--ckpt-every", "2",
                       "--audio-every", "2", "--outdir", str(out)])
    run_cfg = config.config_from_dict(json.loads(
        (out / "config.json").read_text()))
    assert run_cfg.codec == CFG.codec and run_cfg.mpd == CFG.mpd
    lines = [json.loads(x) for x in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 2 and "g_mel" in lines[-1]
    assert list(out.glob("vocoded_*.wav"))
    # the run's state exports to the zoo as a codec and loads back
    from music_synthesis_tpu_torch.scripts import export_zoo

    export_zoo.main(["--run", str(out), "--stage", "2", "--name", "dac_run",
                     "--root", str(tmp_path / "zoo"), "--device", "cpu"])
    entry = zoo.load_pretrained(tmp_path / "zoo" / "dac_run")
    assert entry.kind == "codec" and entry.config == CFG.codec
    y, _, _ = entry.model("cpu")(_wav())
    assert y.shape == (2, SEG) and bool(torch.isfinite(y).all())


def test_published_widths_count_76_65m_and_58_snakes():
    cfg = config.DAC_44K
    with torch.device("meta"):
        g, d = stage2.make_models(cfg)
        plain_g, plain_d = ref.models(_rcfg(cfg))
    parts = {p: sum(v.numel() for k, v in g.named_parameters()
                    if k.startswith(p))
             for p in ("encoder", "quantizer", "decoder")}
    assert parts == {"encoder": 22_307_968, "quantizer": 239_760,
                     "decoder": 54_104_162}
    assert sum(parts.values()) == 76_651_890
    d_parts = {p: sum(v.numel() for k, v in d.named_parameters()
                      if k.startswith(p)) for p in ("mpd", "mrd")}
    assert d_parts == {"mpd": 41_105_770, "mrd": 1_413_990}
    assert {k: v.shape for k, v in g.named_parameters()} == {
        k: v.shape for k, v in plain_g.named_parameters()}
    assert {k: v.shape for k, v in d.named_parameters()} == {
        k: v.shape for k, v in plain_d.named_parameters()}
    before = snake_op.snake_calls.n_calls, rvq_stage.n_calls
    with torch.device("meta"):
        y, _, _ = g(torch.empty(2, 16_758), torch.empty(2))
    assert y.shape == (2, 16_758)
    assert snake_op.snake_calls.n_calls - before[0] == 58
    assert rvq_stage.n_calls - before[1] == 9
