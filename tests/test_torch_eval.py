"""The port's evaluation surface against the JAX package, on the CPU: the
phase-jitter ratio (``ops/phase.py``), the MCD (``ops/cepstrum.py``), the
HTML report (``utils/report.py``), the copy-synthesis eval of
``scripts/eval_checkpoint.py``, and the ``vocode`` and ``generate`` CLIs.

Tolerances: jitter and cepstra 1e-4 relative (fp32 FFTs and the DCT in
another summation order; measured under 1e-5); the eval on a TINY iSTFT
vocoder (fp32) over a synthetic corpus, key for key: the vocoder's
metrics 1e-4 relative (the phase-jitter ratio 1e-6 absolute: a random
vocoder's output is steady, its ratio about 1e-4, measured 1.1e-7 apart),
the Griffin-Lim anchor's 3e-2 relative (48 iterations from
two magnitudes 1e-7 apart, as ``test_torch_griffin_lim.py`` measures), the
refined audio's 3e-2 (its random vocoder leaves near-silent bins under the
target, as there; measured up to 1.3e-2, on the refined audio's jitter);
the CLIs' audio 1e-4 of JAX's plus one 16-bit step.
"""

import argparse
import dataclasses
import importlib.util
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from music_synthesis_tpu import config as jax_config
from music_synthesis_tpu.data.dataset import make_synthetic_corpus
from music_synthesis_tpu.infer import generate as jax_generate
from music_synthesis_tpu.models.vocoder import Vocoder as JaxVocoder
from music_synthesis_tpu.ops import cepstrum as jax_cepstrum
from music_synthesis_tpu.ops import phase as jax_phase
from music_synthesis_tpu.train.stage2 import conditioning_mel
from music_synthesis_tpu.utils.report import write_report as jax_write_report
from music_synthesis_tpu_torch import config
from music_synthesis_tpu_torch.ops.cepstrum import mcd, mel_cepstra
from music_synthesis_tpu_torch.ops.phase import phase_jitter, phase_jitter_ratio
from music_synthesis_tpu_torch.scripts import eval_checkpoint, generate, vocode
from music_synthesis_tpu_torch.utils.report import write_report
from music_synthesis_tpu_torch.utils.wav import write_wav

from torch_tiny_ref import ISTFT, save_tiny_zoo, tiny_vocoder

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SR = 22050


def _music(n=8192, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = sum(a * np.sin(2 * np.pi * f * t + p) for a, f, p in
            [(0.4, 220, 0.1), (0.2, 440, 1.3), (0.1, 1330, 2.2)])
    return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)[None]


def test_phase_jitter_matches_jax():
    x, y = _music(), _music(seed=1) * 0.7
    for args in ((), (512, 128)):
        want = float(jax_phase.phase_jitter(jnp.asarray(x), *args))
        got = float(phase_jitter(torch.from_numpy(x), *args))
        np.testing.assert_allclose(got, want, rtol=1e-4)
    want = float(jax_phase.phase_jitter_ratio(jnp.asarray(y), jnp.asarray(x)))
    got = float(phase_jitter_ratio(torch.from_numpy(y), torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert float(phase_jitter_ratio(torch.from_numpy(x),
                                    torch.from_numpy(x))) == 1.0


@pytest.mark.parametrize("kw", [{}, {"n_mels": 32}])
def test_mcd_matches_jax(kw):
    x, y = _music(), _music(seed=2) * 0.5
    jcfg, cfg = jax_config.FrontendConfig(**kw), config.FrontendConfig(**kw)
    want = np.asarray(jax_cepstrum.mel_cepstra(jnp.asarray(x), jcfg))
    got = mel_cepstra(torch.from_numpy(x), cfg).numpy()
    assert got.shape == want.shape == (1, 8192 // 256, 13)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(mcd(torch.from_numpy(y),
                                         torch.from_numpy(x), cfg)),
                               float(jax_cepstrum.mcd(jnp.asarray(y),
                                                      jnp.asarray(x), jcfg)),
                               rtol=1e-4)
    assert float(mcd(torch.from_numpy(x), torch.from_numpy(x), cfg)) < 1e-3


def _no_timestamp(html: str) -> str:
    return re.sub(r"generated [0-9T:\-]+", "generated", html)


def test_write_report_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    clips = [(f"clip {i}", 0.2 * rng.standard_normal(2205)) for i in range(2)]
    mels = [rng.standard_normal((32, 16)) for _ in range(2)]
    metrics = {"g_loss": 1.25, "d_loss": 0.5, "per_clip": {"dist": [1.0]}}
    got = write_report(tmp_path / "port" / "report.html", "test run", clips,
                       SR, mels, metrics=metrics)
    want = jax_write_report(tmp_path / "jax.html", "test run", clips, SR,
                            mels, metrics=metrics)
    text = got.read_text()
    assert _no_timestamp(text) == _no_timestamp(want.read_text())
    assert text.count("data:audio/wav;base64,") == 2
    assert "g_loss" in text and "per_clip" not in text


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    make_synthetic_corpus(root, n_clips=4, seconds=1.0)
    return root


def _jax_eval_module():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_checkpoint", REPO / "scripts" / "eval_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VOCODER_TOL = 1e-4
GL_TOL = 3e-2
METRIC_TOL = {
    "copy_synthesis_multires_stft_distance_mean": VOCODER_TOL,
    "copy_synthesis_multires_stft_distance_std": 1e-3,
    "resynth_rms_over_real_rms_mean": VOCODER_TOL,
    "phase_jitter_ratio_mean": VOCODER_TOL,  # and JITTER_ATOL
    "mcd_db_mean": VOCODER_TOL,
    "gl_refined_distance_mean": GL_TOL,
    "gl_refined_phase_jitter_ratio_mean": GL_TOL,
    "griffin_lim_anchor_distance_mean": GL_TOL,
    "griffin_lim_phase_jitter_ratio_mean": GL_TOL,
    "griffin_lim_mcd_db_mean": GL_TOL,
}
JITTER_ATOL = 1e-6
PER_CLIP_TOL = {"dist": VOCODER_TOL, "jitter": VOCODER_TOL,
                "mcd_db": VOCODER_TOL, "rms_ratio": VOCODER_TOL,
                "gl_dist": GL_TOL, "gl_jitter": GL_TOL}


def test_eval_body_matches_jax(corpus, tmp_path):
    """Both packages' ``eval_body`` on one corpus, one TINY iSTFT vocoder,
    with the Griffin-Lim anchor and 2 refinement iterations: the same
    ``eval.json`` keys in the same order, and the same values."""
    _, params, port = tiny_vocoder(seed=3, **ISTFT)
    jcfg = dataclasses.replace(jax_config.TINY, vocoder=dataclasses.replace(
        jax_config.TINY.vocoder, **ISTFT))
    cfg = dataclasses.replace(config.TINY, vocoder=dataclasses.replace(
        config.TINY.vocoder, **ISTFT))
    args = argparse.Namespace(corpus=str(corpus), seconds=0.5, n_clips=2,
                              gl_anchor=True, gl_refine=2)
    (tmp_path / "jax").mkdir()
    _jax_eval_module().eval_body(args, jcfg, params, 7, "ema",
                                 tmp_path / "jax")
    got = eval_checkpoint.eval_body(args, cfg, port, 7, "ema",
                                    tmp_path / "port")
    want = json.loads((tmp_path / "jax" / "eval.json").read_text())
    assert json.loads((tmp_path / "port" / "eval.json").read_text()) == got
    assert list(got) == list(want)
    assert list(got["per_clip"]) == list(want["per_clip"])
    for k, v in want.items():
        if k == "per_clip":
            for name, values in v.items():
                np.testing.assert_allclose(
                    got[k][name], values, rtol=PER_CLIP_TOL[name],
                    atol=JITTER_ATOL if name == "jitter" else 0, err_msg=name)
        elif k in METRIC_TOL:
            np.testing.assert_allclose(
                got[k], v, rtol=METRIC_TOL[k],
                atol=JITTER_ATOL if k == "phase_jitter_ratio_mean" else 0,
                err_msg=k)
        else:
            assert got[k] == v, k
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())


def test_eval_cli_on_a_zoo_entry(corpus, tmp_path):
    """``--zoo`` on a saved entry directory, on the CPU."""
    root = save_tiny_zoo(tmp_path / "zoo")
    m = eval_checkpoint.main([
        "--zoo", str(root / "vocoder_t"), "--corpus", str(corpus),
        "--preset", "tiny", "--n-clips", "1", "--seconds", "0.5",
        "--out", str(tmp_path / "eval"), "--device", "cpu"])
    assert m["n_clips"] == 1 and np.isfinite(m["per_clip"]["dist"]).all()
    assert (tmp_path / "eval" / "report.html").exists()
    with pytest.raises(SystemExit):
        eval_checkpoint.main(["--corpus", str(corpus), "--device", "cpu"])


def _wav_file(path, seconds=0.5):
    n = int(seconds * SR)
    write_wav(path, SR, _music(n)[0])
    return path


def _read(path):
    sr, data = scipy.io.wavfile.read(path)
    return sr, data.astype(np.float32) / 32767.0


@pytest.fixture(scope="module")
def tiny_zoo(tmp_path_factory):
    return save_tiny_zoo(tmp_path_factory.mktemp("zoo"))


def test_vocode_cli_matches_jax(tiny_zoo, tmp_path):
    src = _wav_file(tmp_path / "in.wav")
    out = tmp_path / "out.wav"
    dist = vocode.main([str(src), "--stage2", str(tiny_zoo / "vocoder_t"),
                        "--out", str(out), "--device", "cpu"])
    sr, got = _read(out)
    _, x = _read(src)
    x = x[: len(x) // 256 * 256][None]
    jcfg = dataclasses.replace(
        jax_config.TINY,
        vocoder=dataclasses.replace(jax_config.TINY.vocoder, **ISTFT))
    from music_synthesis_tpu import zoo as jax_zoo

    entry = jax_zoo.load_pretrained(str(tiny_zoo / "vocoder_t"))
    want = np.asarray(JaxVocoder(jcfg.vocoder).apply(
        {"params": entry.params}, conditioning_mel(jnp.asarray(x), jcfg)))[0]
    assert sr == SR and got.shape == want.shape and np.isfinite(dist)
    np.testing.assert_allclose(got, np.clip(want, -1, 1), rtol=0,
                               atol=1e-4 + 1.5 / 32767)


def test_vocode_cli_griffin_lim(tmp_path):
    src = _wav_file(tmp_path / "in.wav")
    dist = vocode.main([str(src), "--griffin-lim", "--gl-iters", "4",
                        "--out", str(tmp_path / "gl.wav"), "--device", "cpu"])
    _, y = _read(tmp_path / "gl.wav")
    assert y.shape == (int(0.5 * SR) // 256 * 256,) and np.abs(y).max() > 0.05
    assert 0 < dist < 5


def test_vocode_cli_without_a_card_exits_nonzero(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        vocode.main([str(tmp_path / "missing.wav")])
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_generate_cli_matches_jax(tiny_zoo, tmp_path):
    """Long-form along a slerp path between two seeds, from zoo entry
    directories, against JAX's ``generate_long`` on the port's latents."""
    out = tmp_path / "gen"
    generate.main(["--stage1", str(tiny_zoo / "composer_t"),
                   "--stage2", str(tiny_zoo / "vocoder_t"), "--preset", "tiny",
                   "--n", "2", "--seconds", "1.0", "--crossfade-frames", "4",
                   "--interpolate", "3:7", "--out", str(out),
                   "--device", "cpu"])
    from music_synthesis_tpu import zoo as jax_zoo
    from music_synthesis_tpu_torch.infer.latent import latent_path

    gz = [torch.randn((2, 16), generator=torch.Generator().manual_seed(s))
          for s in (3, 7)]
    frames = int(1.0 * SR / 256)
    z = latent_path(*gz, max(2, -(-(frames - 4) // (32 - 4)))).numpy()
    c = jax_zoo.load_pretrained(str(tiny_zoo / "composer_t"))
    v = jax_zoo.load_pretrained(str(tiny_zoo / "vocoder_t"))
    jcfg = dataclasses.replace(jax_config.TINY, vocoder=v.config)
    want = np.asarray(jax_generate.generate_long(jcfg, c.params, v.params,
                                                 jnp.asarray(z), 4))
    for i in range(2):
        _, got = _read(out / f"sample_{i:03d}.wav")
        np.testing.assert_allclose(got, np.clip(want[i], -1, 1), rtol=0,
                                   atol=1e-4 + 1.5 / 32767)


def test_generate_cli_refined_walk_and_report(tiny_zoo, tmp_path):
    out = tmp_path / "gen"
    generate.main(["--stage1", str(tiny_zoo / "composer_t"),
                   "--stage2", str(tiny_zoo / "vocoder_t"), "--preset", "tiny",
                   "--n", "2", "--seconds", "1.0", "--walk-step", "0.3",
                   "--gl-refine", "2", "--target-rms", "0.1", "--report",
                   "--out", str(out), "--device", "cpu"])
    for i in range(2):
        _, y = _read(out / f"sample_{i:03d}.wav")
        assert np.isfinite(y).all()
        np.testing.assert_allclose(np.sqrt(np.mean(y ** 2)), 0.1, rtol=0.05)
    assert (out / "report.html").read_text().count("data:audio/wav") == 2
    # One patch and no sources: seeded random generators.
    generate.main(["--preset", "tiny", "--n", "1", "--out", str(out / "one"),
                   "--device", "cpu"])
    _, y = _read(out / "one" / "sample_000.wav")
    assert y.shape == (32 * 256,)
