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
off) against the CPU.
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
