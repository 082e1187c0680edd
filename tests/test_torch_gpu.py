"""Card-only tests of the port: the CUDA log-mel kernel against its plain
version, and the entry points on the card against the CPU.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and skips
without one, so every process collects the same tests. This file imports
no JAX, so it runs on the card's machine, which has none:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances: 2e-4 absolute plus 2e-4 relative for the kernel against the
plain version, in both modes ("exact": fp32 FFMA in the cuBLAS GEMM's
summation order, ~1e-6 apart; "fast": 3xTF32 on the tensor cores, up to
~7e-4 apart in near-silent mel bins, within the relative term at log-mel
magnitudes of 5-12); 2e-3 for the fp32 vocoder on the card (cuDNN, TF32
off) against the CPU; for one TINY training step from a D whose logits
are well away from 0 and whose Adam second moment is 1 (so that the
update the G step runs against is continuous in the gradient), card
(fp32, TF32 off, the "exact" kernel) against the CPU, 5e-5 relative on
the losses and 3e-4 on the gradient norms, as ``chip_smoke.py``'s
``TRAIN_TOL``, which the same step with TF32 on must fail; for one TINY
stage-1 step from the same kind of state, 1e-6 relative on the losses and
1e-4 on the gradient norms, as ``chip_smoke.py``'s ``STAGE1_TOL``, which the
same step with TF32 on must fail; Griffin-Lim on the card bit-identical
with cuBLAS's TF32 switch on and off, and against the CPU as the CPU tests
hold it against JAX (2e-4 on the refinement, 3e-2 on cold GL's spectral
convergence); a stream on the card against ``generate_long`` on the card,
1e-4 relative and 1e-5 absolute; the TINY stage-2 DP step over two gloo
ranks sharing the card (``--dp jit``, 1 row each, fp32 with TF32 off, the
"exact" kernel) against the single-process step on both rows, 5e-5
relative on the losses and 3e-4 on the gradient norms (``TRAIN_TOL``);
sequence-sharded vocoding over ``[cuda, cuda]`` against one call on the
card, in the interior, 2e-3; a vocoder artifact's card program against the
live module on the card, 2e-3 (fp32 with cuDNN's default TF32
convolutions, which may pick other algorithms for the exported graph's
decomposed ops); ``extract_features`` on the card (the "exact" kernel,
one launch) against the plain version evaluated in float64, 2e-4.
"""

import numpy as np
import pytest
import torch

from music_synthesis_tpu_torch.config import FrontendConfig
from music_synthesis_tpu_torch.ops import logmel as L

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)

TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _signal(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (0.5 * np.tanh(rng.standard_normal(shape))).astype(np.float32))


@pytest.mark.parametrize("kw, shape", [
    ({}, (16, 8192)),
    ({"n_mels": 32}, (3, 4096)),
    ({"power": 1.0}, (2, 8192)),
    ({"center": True, "n_mels": 80}, (2, 5000)),
    ({"fmin": 30.0, "fmax": 8000.0}, (1, 1024 + 256 * 10)),
    ({"n_fft": 256, "win_length": 256, "hop_length": 256, "n_mels": 32},
     (2, 4096)),
    ({"n_fft": 512, "win_length": 512, "hop_length": 128, "n_mels": 64},
     (5, 3000)),
    ({"n_mels": 160}, (2, 8192)),
    ({"n_mels": 256}, (3, 6000)),
    ({}, (3, 4097)),            # rows not 16-byte aligned
    ({"n_mels": 96}, (2, 5001)),
])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_kernel_matches_plain(cuda, kw, shape, precision):
    cfg = FrontendConfig(**kw)
    wav = _signal(shape).to(cuda)
    before = L.logmel_kernel.n_launches
    for fused, plain in ((L.fused_log_mel, L.log_mel_plain),
                         (L.fused_log_mel_for_vocoder,
                          L.log_mel_for_vocoder_plain)):
        got = fused(wav, cfg, precision)
        torch.cuda.synchronize()
        want = plain(wav, cfg)
        assert got.shape == want.shape and got.is_cuda
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
        # The same function as the CPU's plain version.
        torch.testing.assert_close(got.cpu(), plain(wav.cpu(), cfg),
                                   rtol=TOL, atol=TOL)
    assert L.logmel_kernel.n_launches == before + 2


@pytest.mark.parametrize("tile", [64, 48, 32])
@pytest.mark.parametrize("kw, shape", [({}, (3, 4097)), ({"n_mels": 160}, (5, 8192)),
                                       ({"n_mels": 32, "power": 1.0}, (2, 5001))])
def test_every_frame_tile_matches_plain(cuda, tile, kw, shape):
    """Each frame tile of the "fast" path, forced, on aligned and
    misaligned rows and ragged tiles."""
    cfg = FrontendConfig(**kw)
    wav = _signal(shape, seed=1).to(cuda)
    for for_vocoder in (True, False):
        padded, n_frames = L.padded_input(wav, cfg, for_vocoder)
        got = L.logmel_kernel(padded, cfg, n_frames, "fast", tile_frames=tile)
        torch.cuda.synchronize()
        want = L.log_mel_frames_plain(padded, cfg, n_frames)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_kernel_rejects_bad_input_on_the_card(cuda):
    wav = _signal((2, 4096)).to(cuda)
    with pytest.raises(TypeError):
        L.fused_log_mel(wav.double(), FrontendConfig())
    with pytest.raises(ValueError):
        L.fused_log_mel(wav[:, ::2], FrontendConfig())
    with pytest.raises(ValueError):
        L.fused_log_mel(wav[:, :512], FrontendConfig())


def test_copy_synthesis_on_the_card_matches_cpu(cuda):
    from music_synthesis_tpu_torch.infer.copy_synthesis import CopySynthesizer

    wav = 0.3 * np.sin(np.arange(2 * 8192) * 0.03).reshape(2, 8192)
    gpu = CopySynthesizer("vocoder_istft", compute_dtype="float32")
    cpu = CopySynthesizer("vocoder_istft", device="cpu",
                          compute_dtype="float32")
    before = L.logmel_kernel.n_launches
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y_gpu, d_gpu = gpu(wav)
    assert L.logmel_kernel.n_launches == before + 1
    y_cpu, d_cpu = cpu(wav)
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=2e-3, atol=2e-3)
    assert abs(d_gpu - d_cpu) < 1e-3


def test_service_on_the_card(cuda):
    from music_synthesis_tpu_torch.serve import ServeConfig, SynthService

    svc = SynthService(ServeConfig(batch_buckets=(1,), patch_buckets=(1,)),
                       warmup=False)
    assert svc.device.type == "cuda"
    wav, meta = svc.synth(1.0, seed=3)
    again, _ = svc.synth(1.0, seed=3)
    assert wav.shape == (1, meta["samples"]) and np.isfinite(wav).all()
    np.testing.assert_array_equal(wav, again)


def _he_gain_d(d_params, seed, out_gain):
    """D's gains at He's sqrt(2) (+-30%), small biases and the heads'
    output gains at ``out_gain`` (as ``chip_smoke.he_gain_d``): features
    of order 1 and logits well away from D's init, where they sit near 0;
    the output gains keep R1, which grows with the logits' scale, from
    burying the hinge terms."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in d_params.items():
        r = torch.randn(v.shape, generator=gen).to(v.device)
        names = k.split(".")
        gain = (out_gain[names[0]] if names[-2] == "conv_out" else 2 ** 0.5)
        out[k] = (gain * (1.0 + 0.3 * r) if k.endswith(".g")
                  else 0.05 * r if k.endswith(".b") else v)
    return out


def test_tiny_train_step_on_the_card_matches_cpu(cuda):
    import dataclasses

    from music_synthesis_tpu_torch.config import TINY
    from music_synthesis_tpu_torch.train import stage2

    cfg = dataclasses.replace(TINY, train=dataclasses.replace(
        TINY.train, use_pallas_frontend=True, d_input_noise=0.1,
        r1_gamma=1.0, ema_decay=0.999, concat_disc_batch=True))
    wav = _signal((2, 2048), seed=2)
    rng = np.random.default_rng(3)
    noise = [rng.standard_normal((2, 2048)).astype(np.float32)
             for _ in range(3)]

    def state(device):
        st = stage2.make_train_state(cfg, seed=0, device=device)
        # Adam's second moment at 1: D's update, which the G step runs
        # against, is then continuous in the gradient (a fresh Adam's is
        # about lr * sign(g)).
        d_opt = dataclasses.replace(st.d_opt, nu={
            k: torch.ones_like(v) for k, v in st.d_opt.nu.items()})
        return dataclasses.replace(st, d_params=_he_gain_d(
            st.d_params, 4, {"msd": 0.2, "mrd": 1e-3}), d_opt=d_opt)

    def card_step(tf32):
        matmul = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
                return stage2.train_step(cfg, state(cuda), wav, noise=noise,
                                         precision="exact")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul

    before = L.logmel_kernel.n_launches
    new, m_gpu = card_step(False)
    assert L.logmel_kernel.n_launches == before + 1
    assert new.step == 1 and new.g_params["conv_in.v"].is_cuda
    _, m_cpu = stage2.train_step(cfg, state("cpu"), wav, noise=noise)
    assert m_gpu.keys() == m_cpu.keys()
    assert abs(m_cpu["g_adv"]) > 1e-2, m_cpu  # D's logits away from 0
    tol = {k: 5e-5 for k in ("d_loss", "g_loss", "g_rms_ratio", "g_adv",
                             "g_fm", "g_stft", "d_r1")}
    tol.update(d_grad_norm=3e-4, g_grad_norm=3e-4)
    for k, rtol in tol.items():
        rel = abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
        assert rel <= rtol, (k, m_gpu[k], m_cpu[k], rel)
    # The tolerances tell fp32 from TF32: the same step with TF32 on fails.
    _, m_tf32 = card_step(True)
    assert any(abs(m_tf32[k] - m_cpu[k]) > rtol * abs(m_cpu[k])
               for k, rtol in tol.items()), m_tf32


def test_tiny_stage1_step_on_the_card_matches_cpu(cuda):
    import dataclasses

    from music_synthesis_tpu_torch.config import TINY
    from music_synthesis_tpu_torch.train import stage1

    cfg = dataclasses.replace(TINY, train=dataclasses.replace(
        TINY.train, d_input_noise=0.2, d_noise_decay_steps=10000,
        r1_gamma=1.0, lambda_flux=10.0, ema_decay=0.999))
    rng = np.random.default_rng(5)
    mel = (0.8 * np.tanh(rng.standard_normal((2, 32, 32)))).astype(np.float32)
    z = rng.standard_normal((2, 16)).astype(np.float32)
    noise = [rng.standard_normal(mel.shape).astype(np.float32)
             for _ in range(3)]

    def state(device):
        st = stage1.make_train_state(cfg, seed=0, device=device)
        d_opt = dataclasses.replace(st.d_opt, nu={
            k: torch.ones_like(v) for k, v in st.d_opt.nu.items()})
        return dataclasses.replace(st, d_params=_he_gain_d(
            st.d_params, 4, {"conv_out": 0.5}), d_opt=d_opt)

    def card_step(tf32):
        matmul = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
                return stage1.train_step(cfg, state(cuda), mel, z=z,
                                         noise=noise)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul

    before = L.logmel_kernel.n_launches
    new, m_gpu = card_step(False)
    assert L.logmel_kernel.n_launches == before  # stage 1 runs no kernel
    assert new.step == 1 and new.d_params["conv_out.v"].is_cuda
    _, m_cpu = stage1.train_step(cfg, state("cpu"), mel, z=z, noise=noise)
    assert m_gpu.keys() == m_cpu.keys()
    assert abs(m_cpu["g_adv"]) > 1e-2, m_cpu  # D's logits away from 0
    tol = {k: 1e-6 for k in ("d_loss", "g_loss", "g_rms_ratio", "g_adv",
                             "g_fm", "g_flux", "d_r1")}
    tol.update(d_grad_norm=1e-4, g_grad_norm=1e-4)
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in tol}
    print("stage-1 TINY card vs CPU, TF32 off:", rel)
    for k, rtol in tol.items():
        assert rel[k] <= rtol, (k, m_gpu[k], m_cpu[k], rel[k])
    _, m_tf32 = card_step(True)
    rel = {k: abs(m_tf32[k] - m_cpu[k]) / abs(m_cpu[k]) for k in tol}
    print("stage-1 TINY card vs CPU, TF32 on:", rel)
    assert any(rel[k] > rtol for k, rtol in tol.items()), m_tf32


def _tone_logmel(device):
    """Two 0.4 s tone clips and their vocoder-aligned log-mel (flagship
    front-end), on ``device``."""
    from music_synthesis_tpu_torch.ops.frontend import log_mel_for_vocoder

    sr, n = 22050, 8704
    t = np.arange(n) / sr
    x = np.stack([0.3 * np.sin(2 * np.pi * 440 * t)
                  + 0.15 * np.sin(2 * np.pi * 660 * t),
                  0.25 * np.sin(2 * np.pi * 330 * t) * np.exp(-2 * t)])
    x = torch.from_numpy(x.astype(np.float32)).to(device)
    return x, log_mel_for_vocoder(x, FrontendConfig())


def test_griffin_lim_on_the_card_ignores_tf32_and_matches_cpu(cuda):
    """Griffin-Lim on the card gives the same bits with cuBLAS's TF32 switch
    on as off (its GEMM runs in float64, its irDFT in cuFFT), and matches
    the CPU: the warm-started refinement to 2e-4 (the port-vs-JAX CPU gap's
    tolerance in tests/test_torch_griffin_lim.py), cold GL at 48 iterations
    by spectral convergence to 3e-2 relative (as there)."""
    from music_synthesis_tpu_torch.ops import griffin_lim as gl
    from music_synthesis_tpu_torch.ops.frontend import stft

    cfg = FrontendConfig()
    x, lm = _tone_logmel(cuda)
    flag = torch.backends.cuda.matmul.allow_tf32
    outs = {}
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            outs[tf32] = (gl.invert_log_mel(lm, cfg, 48),
                          gl.refine_with_log_mel(x, lm, cfg, 8))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a, b)
    cold, refined = (t.cpu() for t in outs[False])
    x_cpu, lm_cpu = x.cpu(), lm.cpu()
    torch.testing.assert_close(refined, gl.refine_with_log_mel(
        x_cpu, lm_cpu, cfg, 8), rtol=0, atol=2e-4)
    mag = gl.log_mel_to_magnitude(lm_cpu, cfg)

    def sc(y):
        s = stft(torch.nn.functional.pad(y, (384, 384)), 1024, 256).abs()
        return float(torch.linalg.norm(s - mag) / torch.linalg.norm(mag))

    np.testing.assert_allclose(sc(cold), sc(gl.invert_log_mel(lm_cpu, cfg, 48)),
                               rtol=3e-2)


def test_stream_on_the_card_matches_generate_long(cuda):
    """The zoo pair streamed on the card equals ``generate_long`` on the card
    on the same latents (fp32, cuDNN TF32 off: 1e-4 relative, 1e-5
    absolute, the CPU tests' tolerance)."""
    import dataclasses

    from music_synthesis_tpu_torch import zoo
    from music_synthesis_tpu_torch.config import E2E_INFERENCE
    from music_synthesis_tpu_torch.infer.generate import generate_long
    from music_synthesis_tpu_torch.infer.stream import StreamingSynth

    comp_e = zoo.load_pretrained("specgan_flux")
    voc_e = zoo.load_pretrained("vocoder_istft")
    cfg = dataclasses.replace(
        E2E_INFERENCE, specgan=comp_e.config,
        vocoder=dataclasses.replace(voc_e.config, compute_dtype="float32"))
    comp = comp_e.model(cuda, "float32")
    voc = voc_e.model(cuda, "float32")
    z = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 3, cfg.specgan.latent_dim)).astype(np.float32))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        with torch.inference_mode():
            want = generate_long(cfg, comp, voc, z.to(cuda), 8).cpu().numpy()
        s = StreamingSynth(cfg, comp, voc, crossfade_frames=8)
        parts = [s.feed(z[:, i]) for i in range(3)] + [s.finish()]
    got = np.concatenate(parts, axis=-1)
    assert got.shape == want.shape and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_dp_step_over_two_gloo_ranks_on_the_card(cuda, tmp_path):
    import dataclasses

    import torch_dp_ref
    from music_synthesis_tpu_torch.config import TINY
    from music_synthesis_tpu_torch.parallel import mesh
    from music_synthesis_tpu_torch.train import stage2
    from music_synthesis_tpu_torch.train.checkpoint import save_checkpoint

    cfg = dataclasses.replace(TINY, train=dataclasses.replace(
        TINY.train, use_pallas_frontend=True, d_input_noise=0.1,
        r1_gamma=1.0, ema_decay=0.999, concat_disc_batch=True))
    wav = _signal((2, 2048), seed=2).numpy()
    rng = np.random.default_rng(3)
    noise = [rng.standard_normal((2, 2048)).astype(np.float32)
             for _ in range(3)]
    st = stage2.make_train_state(cfg, seed=0, device=cuda)
    st = dataclasses.replace(st, d_params=_he_gain_d(
        st.d_params, 4, {"msd": 0.2, "mrd": 1e-3}), d_opt=dataclasses.replace(
        st.d_opt, nu={k: torch.ones_like(v) for k, v in st.d_opt.nu.items()}))
    save_checkpoint(tmp_path / "st.pt", st)
    data = [[(wav[r:r + 1], None, [n[r:r + 1] for n in noise])]
            for r in range(2)]
    ranks = mesh.launch(torch_dp_ref.run_jobs, 2, ([{
        "kind": "train", "args": dict(stage=2, cfg=cfg,
                                      state_path=str(tmp_path / "st.pt"),
                                      dp="jit", data=data,
                                      device="cuda:0")}],),
        backend="gloo", devices=["cuda:0", "cuda:0"])
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        _, want = stage2.train_step(cfg, st, wav, noise=noise,
                                    precision="exact")
    (a,), (b,) = ranks
    assert a["metrics"] == b["metrics"]
    tol = {k: 5e-5 for k in ("d_loss", "g_loss", "g_rms_ratio", "g_adv",
                             "g_fm", "g_stft", "d_r1")}
    tol.update(d_grad_norm=3e-4, g_grad_norm=3e-4)
    for k, rtol in tol.items():
        got = a["metrics"][0][k]
        assert abs(got - want[k]) <= rtol * abs(want[k]), (k, got, want[k])


def test_seqshard_vocode_on_the_card(cuda):
    from music_synthesis_tpu_torch.config import TINY
    from music_synthesis_tpu_torch.models.vocoder import Vocoder
    from music_synthesis_tpu_torch.parallel.seqshard import (
        make_seqshard_vocode, receptive_field_frames)

    voc = Vocoder(TINY.vocoder, torch.Generator().manual_seed(0)).to(cuda)
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 64, TINY.vocoder.n_mels)).astype(np.float32)).to(cuda)
    fn = make_seqshard_vocode(voc, [cuda, cuda])
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), \
            torch.inference_mode():
        got, want = fn(mel), voc(mel)
    assert got.is_cuda and got.shape == want.shape
    h = receptive_field_frames(voc.cfg) + 2
    mid = slice(h * voc.cfg.hop_length, -h * voc.cfg.hop_length)
    assert (got[:, mid] - want[:, mid]).abs().max().item() <= 2e-3


def test_vocoder_artifact_on_the_card_matches_live(cuda, tmp_path):
    import dataclasses

    from music_synthesis_tpu_torch import deploy
    from music_synthesis_tpu_torch.config import TINY
    from music_synthesis_tpu_torch.models.vocoder import Vocoder

    cfg = dataclasses.replace(TINY.vocoder, head="istft",
                              upsample_factors=(8, 8), istft_n_fft=16,
                              istft_hop=4, init_scheme="he", out_init_gain=0.1)
    voc = Vocoder(cfg, torch.Generator().manual_seed(0)).eval()
    voc.requires_grad_(False)
    exported, meta = deploy.vocoder_artifact(
        voc.state_dict(), cfg, n_frames=16, batch=None,
        platforms=("cuda", "cpu"))
    path = deploy.save_artifact(tmp_path / "voc.msx", exported, meta)
    assert deploy.read_meta(path)["platforms"] == ["cuda", "cpu"]
    art = deploy.load_artifact(path)
    assert art.device.type == "cuda"
    live = voc.to(cuda)
    for b in (1, 4):
        mel = _signal((b, 16, cfg.n_mels), seed=b).to(cuda)
        with torch.inference_mode():
            got, want = art(mel), live(mel)
        assert got.is_cuda and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=2e-3)


def test_extract_features_on_the_card_matches_plain(cuda, tmp_path):
    from music_synthesis_tpu_torch.config import FRONTEND_CPU_CLIP
    from music_synthesis_tpu_torch.data.dataset import make_synthetic_corpus
    from music_synthesis_tpu_torch.scripts import extract_features
    from music_synthesis_tpu_torch.utils.wav import load_wav

    clip = make_synthetic_corpus(tmp_path, n_clips=1, seconds=4.0)[0]
    before = L.logmel_kernel.n_launches
    got = extract_features.main([str(clip), "--out", str(tmp_path / "m.npy")])
    assert L.logmel_kernel.n_launches == before + 1
    cfg = FRONTEND_CPU_CLIP.frontend
    wav = torch.from_numpy(load_wav(clip, cfg.sample_rate))[None].to(cuda)
    padded, n_frames = L.padded_input(wav, cfg, False)
    want = L.log_mel_frames_plain(padded.double(), cfg, n_frames).cpu().numpy()
    assert got.shape == want.shape == (1, 341, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
