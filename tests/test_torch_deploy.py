"""Deployment artifacts of the port (``deploy.py``, ``scripts/export_deploy``)
on the CPU at TINY's size, with the iSTFT head (the flagship's).

The cases of ``tests/test_deploy.py``: export -> save -> load -> call
reproduces the live module within 1e-6 absolute (JAX's tolerance; on the
CPU the program runs the module's own kernels, and the gap reads 0) for the
vocoder at a fixed batch, with a symbolic batch at batch 1 and 3, and for
the two-stage pipeline against ``infer.generate.generate``; the header's
fields (kind, provenance, platforms, format and torch versions, input and
output specs, ``n_params_baked`` = the program's parameters and constants:
the modules' parameters plus the iSTFT bases); the bad magic and the batch
checks. Besides: the JAX package's ``.msx`` header read by the port's
``read_meta`` (its payload refused by ``load_artifact`` with the reason);
``cuda`` refused without a card; the CLI on TINY zoo entries; and the
iSTFT basis cache under ``torch.export`` (an export before any eager call,
in a fresh process, leaves the later eager calls and the program equal to
another process's eager call, bit for bit).
"""

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from music_synthesis_tpu import deploy as jax_deploy
from music_synthesis_tpu.config import TINY as JAX_TINY
from music_synthesis_tpu.train import stage2 as jax_stage2
from music_synthesis_tpu_torch import deploy, zoo
from music_synthesis_tpu_torch.config import TINY
from music_synthesis_tpu_torch.infer.generate import generate
from music_synthesis_tpu_torch.models.specgan import SpectrogramGenerator
from music_synthesis_tpu_torch.models.vocoder import Vocoder
from music_synthesis_tpu_torch.scripts import export_deploy

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-6
VOC = dataclasses.replace(TINY.vocoder, head="istft", upsample_factors=(8, 8),
                          istft_n_fft=16, istft_hop=4, init_scheme="he",
                          out_init_gain=0.1)
CFG = dataclasses.replace(TINY, vocoder=VOC)


@pytest.fixture(scope="module")
def modules():
    voc = Vocoder(VOC, torch.Generator().manual_seed(0)).eval()
    comp = SpectrogramGenerator(CFG.specgan,
                                torch.Generator().manual_seed(1)).eval()
    return comp.requires_grad_(False), voc.requires_grad_(False)


def _n_params(*modules):
    return sum(p.numel() for m in modules for p in m.parameters())


def _mel(b, frames=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, frames, VOC.n_mels, generator=g)


def test_vocoder_artifact_roundtrip(tmp_path, modules):
    _, voc = modules
    exported, meta = deploy.vocoder_artifact(
        voc.state_dict(), VOC, n_frames=16, batch=2, platforms=("cpu",),
        provenance={"run": "unit-test"})
    path = deploy.save_artifact(tmp_path / "voc.msx", exported, meta)
    art = deploy.load_artifact(path, device="cpu")
    mel = _mel(2)
    got, want = art(mel), voc(mel)
    assert float(want.abs().max()) > 0.05
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    assert art.meta["kind"] == "vocoder_copy_synthesis"
    assert art.meta["provenance"] == {"run": "unit-test"}
    assert art.meta["inputs"] == [{"shape": [2, 16, VOC.n_mels],
                                   "dtype": "float32"}]
    assert art.meta["outputs"] == [{"shape": [2, 16 * VOC.hop_length],
                                    "dtype": "float32"}]
    n_bases = 2 * (VOC.istft_n_fft // 2 + 1) * VOC.istft_n_fft
    assert art.meta["n_params_baked"] == _n_params(voc) + n_bases


def test_vocoder_artifact_symbolic_batch(tmp_path, modules):
    """batch=None exports a symbolic leading dim: one artifact, any batch."""
    _, voc = modules
    exported, meta = deploy.vocoder_artifact(
        voc.state_dict(), VOC, n_frames=8, batch=None, platforms=("cpu",))
    assert meta["inputs"][0]["shape"] == ["b", 8, VOC.n_mels]
    assert meta["outputs"][0]["shape"] == ["b", 8 * VOC.hop_length]
    art = deploy.load_artifact(
        deploy.save_artifact(tmp_path / "voc_poly.msx", exported, meta), "cpu")
    for b in (1, 3):
        mel = _mel(b, 8, seed=b)
        np.testing.assert_allclose(art(mel).numpy(), voc(mel).numpy(),
                                   atol=ATOL)


def test_pipeline_artifact_matches_generate(tmp_path, modules):
    comp, voc = modules
    exported, meta = deploy.pipeline_artifact(
        CFG, comp.state_dict(), voc.state_dict(), batch=2, platforms=("cpu",))
    art = deploy.load_artifact(
        deploy.save_artifact(tmp_path / "pipe.msx", exported, meta), "cpu")
    z = torch.randn(2, CFG.specgan.latent_dim,
                    generator=torch.Generator().manual_seed(2))
    got = art(z)
    with torch.no_grad():
        want = generate(CFG, comp, voc, z)
    assert got.shape == (2, CFG.specgan.n_frames * VOC.hop_length)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    # Both parameter sets are lifted in (and the iSTFT bases).
    n_bases = 2 * (VOC.istft_n_fft // 2 + 1) * VOC.istft_n_fft
    assert meta["n_params_baked"] == _n_params(comp, voc) + n_bases


def test_read_meta_without_deserialize(tmp_path, modules):
    _, voc = modules
    exported, meta = deploy.vocoder_artifact(
        voc.state_dict(), VOC, n_frames=8, batch=1, platforms=("cpu",))
    path = deploy.save_artifact(tmp_path / "a.msx", exported, meta)
    read = deploy.read_meta(path)
    assert read["platforms"] == ["cpu"]
    assert read["format_version"] == deploy.FORMAT_VERSION
    assert read["torch_version"] == torch.__version__
    # A device the artifact holds no program for.
    with pytest.raises(ValueError, match="no program for meta"):
        deploy.load_artifact(path, device="meta")


def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "junk.msx"
    p.write_bytes(b"NOTANARTIFACT")
    with pytest.raises(ValueError, match="bad magic"):
        deploy.read_meta(p)


def test_batch_validation(modules):
    _, voc = modules
    with pytest.raises(ValueError, match="batch"):
        deploy.vocoder_artifact(voc.state_dict(), VOC, n_frames=8, batch=0,
                                platforms=("cpu",))


def test_jax_artifact_header_reads_and_payload_is_refused(tmp_path):
    params = jax_stage2.make_train_state(JAX_TINY, jax.random.PRNGKey(0)
                                         ).g_params
    exported, meta = jax_deploy.vocoder_artifact(
        params, JAX_TINY.vocoder, n_frames=8, batch=None, platforms=("cpu",),
        provenance={"run": "unit-test"})
    path = jax_deploy.save_artifact(tmp_path / "jax.msx", exported, meta)
    read = deploy.read_meta(path)
    assert read == jax_deploy.read_meta(path)
    assert read["inputs"][0]["shape"] == ["b", 8, JAX_TINY.vocoder.n_mels]
    assert read["jax_version"] == jax.__version__
    with pytest.raises(ValueError, match="JAX package"):
        deploy.load_artifact(path, device="cpu")
    # The port's header carries the same fields, torch_version for
    # jax_version.
    voc = Vocoder(VOC)
    _, ours = deploy.vocoder_artifact(voc.state_dict(), VOC, n_frames=8,
                                      batch=None, platforms=("cpu",))
    assert (set(ours) - {"torch_version"}) == (set(read) - {"jax_version"})


def test_cuda_export_needs_a_card(modules, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, voc = modules
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deploy.vocoder_artifact(voc.state_dict(), VOC, n_frames=8,
                                platforms=("cuda", "cpu"))
    with pytest.raises(SystemExit):
        export_deploy.main(["--zoo", "vocoder_istft"])


def test_cli_on_tiny_entries(tmp_path, modules, capsys):
    _, voc = modules
    # The CLI's pipeline takes the default InferConfig (64-frame chunks), as
    # the JAX script does: a composer of 64 frames.
    spec = dataclasses.replace(CFG.specgan, n_frames=64,
                               upsample_factors=(2, 2, 2))
    comp = SpectrogramGenerator(spec, torch.Generator().manual_seed(1))
    zoo.save_pretrained("voc", "vocoder", voc.state_dict(), VOC,
                        frontend=CFG.frontend, mel_scaler=CFG.mel_scaler,
                        root=tmp_path)
    zoo.save_pretrained("comp", "specgan", comp.state_dict(), spec,
                        root=tmp_path)
    meta = export_deploy.main(["--zoo", str(tmp_path / "voc"), "--frames",
                               "16", "--platforms", "cpu", "--check",
                               "--out", str(tmp_path / "v.msx")])
    out = capsys.readouterr().out
    assert f"wrote {tmp_path / 'v.msx'}" in out
    assert "check OK: [2, 16, 32] -> [2, 4096]" in out
    assert meta["provenance"]["zoo"] == "voc"
    art = deploy.load_artifact(tmp_path / "v.msx", device="cpu")
    mel = _mel(3)
    np.testing.assert_allclose(art(mel).numpy(), voc(mel).numpy(), atol=ATOL)

    meta = export_deploy.main(["--pipeline", str(tmp_path / "comp"),
                               str(tmp_path / "voc"), "--batch", "2",
                               "--platforms", "cpu", "--out",
                               str(tmp_path / "p.msx")])
    assert meta["kind"] == "two_stage_generate"
    assert meta["inputs"][0]["shape"] == [2, spec.latent_dim]
    assert meta["outputs"][0]["shape"] == [2, 64 * VOC.hop_length]
    assert meta["provenance"] == {"specgan_zoo": "comp", "vocoder_zoo": "voc"}


# In a fresh process: export the TINY iSTFT vocoder before any eager call,
# then call it eagerly and through the program; print both outputs' bytes.
_EXPORT_FIRST = textwrap.dedent("""
    import dataclasses, sys, torch
    from music_synthesis_tpu_torch import deploy
    from music_synthesis_tpu_torch.config import TINY
    from music_synthesis_tpu_torch.models.vocoder import Vocoder

    torch.set_num_threads(1)
    voc_cfg = dataclasses.replace(
        TINY.vocoder, head="istft", upsample_factors=(8, 8), istft_n_fft=16,
        istft_hop=4, init_scheme="he", out_init_gain=0.1)
    voc = Vocoder(voc_cfg, torch.Generator().manual_seed(0)).eval()
    voc.requires_grad_(False)
    mel = torch.randn(3, 16, voc_cfg.n_mels,
                      generator=torch.Generator().manual_seed(5))
    if sys.argv[1] == "export_first":
        programs = deploy.export_callable(
            voc, [(("b", 16, voc_cfg.n_mels), torch.float32)],
            platforms=("cpu",))
        eager = voc(mel)
        program = programs["cpu"].module()(mel)
        assert type(eager) is torch.Tensor and type(program) is torch.Tensor
        print(eager.numpy().tobytes().hex())
        print(program.numpy().tobytes().hex())
    else:
        print(voc(mel).numpy().tobytes().hex())
""")


def test_export_before_any_eager_call_leaves_eager_calls_correct():
    def run(mode):
        out = subprocess.run([sys.executable, "-c", _EXPORT_FIRST, mode],
                             cwd=REPO, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr
        return out.stdout.split()

    eager, program = run("export_first")
    (reference,) = run("eager_only")
    assert eager == reference
    assert program == reference
