"""The port's extract_features, parity, eval_stage1 and average_ckpts CLIs
on the CPU at TINY's size, against the JAX scripts run in this process
(``maybe_force_cpu`` patched, as ``tests/test_torch_cli.py`` does).

- ``extract_features``: the same clip gives the JAX script's lines (the
  shape; the printed range within 0.01) and a mel within 2e-4 of its
  ``--out`` (``tests/test_torch_logmel.py``'s tolerance for the plain
  log-mel against JAX's: fp32 GEMMs against an FFT).
- ``parity``: the same JSON line, the per-file distances within 1e-5
  relative (both print 6 decimals; ``multires_stft_loss`` in fp32 in two
  FFTs), identical pairs exactly 0; exit code 1 and the same error line
  when no name matches.
- ``eval_stage1``: on a TINY stage-1 run (JAX's orbax checkpoint and the
  same state converted by ``convert.train_state_from_jax``) and JAX's
  ``PRNGKey(seed)`` latents injected, every ``eval.json`` value within
  1e-4 relative (the composer's fp32 convolutions and the plain log-mel,
  each about 1e-6 off JAX's, move the statistics' low eigenvalues most;
  1e-4 is ``tests/test_torch_eval.py``'s metric tolerance) and the
  white-noise anchor within the same; the random-weights anchor is the
  port's own seeded init: present and finite. The CLI's run writes the
  JAX keys.
- ``average_ckpts``: JAX checkpoints of ``make_train_state(TINY)`` with
  perturbed generator weights (no training), converted for the port:
  the averaged ``g_params`` and ``g_ema`` equal JAX's exactly (both sum in
  float64 in the same order), the rest is the last step's, ``STATUS``
  reads the same, and the port's ``eval_checkpoint --run`` and
  ``export_zoo`` read the averaged run.
"""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from music_synthesis_tpu.config import TINY as JAX_TINY
from music_synthesis_tpu.config import config_to_dict
from music_synthesis_tpu.train import stage1 as jax_stage1
from music_synthesis_tpu.train import stage2 as jax_stage2
from music_synthesis_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from music_synthesis_tpu.train.checkpoint import abstract_state
from music_synthesis_tpu_torch import zoo
from music_synthesis_tpu_torch.config import config_from_dict
from music_synthesis_tpu_torch.convert import train_state_from_jax
from music_synthesis_tpu_torch.data.dataset import make_synthetic_corpus
from music_synthesis_tpu_torch.models.specgan import SpectrogramGenerator
from music_synthesis_tpu_torch.scripts import (
    average_ckpts,
    eval_checkpoint,
    eval_stage1,
    export_zoo,
    extract_features,
    parity,
)
from music_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from music_synthesis_tpu_torch.utils.wav import write_wav

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _jax_script(name, argv, monkeypatch):
    """Run ``scripts/<name>.py``'s ``main()`` in this process."""
    from music_synthesis_tpu.utils import env

    monkeypatch.setattr(env, "maybe_force_cpu", lambda: None)
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    return mod.main()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    make_synthetic_corpus(root, n_clips=3, seconds=2.0)
    return root


def _range(line: str) -> list[float]:
    return [float(v) for v in line.strip("range []").split(",")]


def test_extract_features(tmp_path, monkeypatch, capsys):
    clip = make_synthetic_corpus(tmp_path / "c", n_clips=1, seconds=4.0)[0]
    _jax_script("extract_features", [str(clip), "--out",
                                     str(tmp_path / "jax.npy")], monkeypatch)
    want_lines = capsys.readouterr().out.splitlines()
    got = extract_features.main([str(clip), "--device", "cpu", "--out",
                                 str(tmp_path / "port.npy")])
    got_lines = capsys.readouterr().out.splitlines()
    want = np.load(tmp_path / "jax.npy")
    assert got.shape == (1, 341, 128) and want.shape == got.shape[1:]
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), got[0])
    np.testing.assert_allclose(got[0], want, rtol=2e-4, atol=2e-4)
    assert got_lines[0].split(" in ")[0] == want_lines[0].split(" in ")[0]
    assert got_lines[0].endswith("on cpu")
    np.testing.assert_allclose(_range(got_lines[1]), _range(want_lines[1]),
                               atol=0.01)
    assert got_lines[2:] == [f"wrote {tmp_path / 'port.npy'}"]


def test_parity(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    ours.mkdir()
    ref.mkdir()
    x = 0.3 * np.sin(np.arange(22050) * 0.03)
    write_wav(ours / "same.wav", 22050, x)
    write_wav(ref / "same.wav", 22050, x)
    write_wav(ours / "diff.wav", 22050, x + 0.05 * rng.standard_normal(22050))
    write_wav(ref / "diff.wav", 22050, x[:20000])
    write_wav(ours / "only_ours.wav", 22050, x)
    _jax_script("parity", [str(ours), str(ref)], monkeypatch)
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    got = parity.main([str(ours), str(ref), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert printed == got
    assert got.keys() == want.keys() and got["metric"] == want["metric"]
    assert got["per_file"].keys() == want["per_file"].keys() == {
        "same.wav", "diff.wav"}
    assert got["per_file"]["same.wav"] == want["per_file"]["same.wav"] == 0.0
    assert got["per_file"]["diff.wav"] > 0.1
    np.testing.assert_allclose(got["per_file"]["diff.wav"],
                               want["per_file"]["diff.wav"], rtol=1e-5)
    np.testing.assert_allclose(got["value"], want["value"], rtol=1e-5)

    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit) as jax_exit:
        _jax_script("parity", [str(ours), str(empty)], monkeypatch)
    want_line = capsys.readouterr().out
    with pytest.raises(SystemExit) as port_exit:
        parity.main([str(ours), str(empty), "--device", "cpu"])
    assert port_exit.value.code == jax_exit.value.code == 1
    assert capsys.readouterr().out == want_line


STAGE1_STEP = 3


@pytest.fixture(scope="module")
def stage1_runs(tmp_path_factory):
    """The same TINY stage-1 state as a JAX run and as a port run."""
    root = tmp_path_factory.mktemp("stage1_runs")
    state = jax_stage1.make_train_state(JAX_TINY, jax.random.PRNGKey(7))
    state = dataclasses.replace(state, step=np.int32(STAGE1_STEP))
    cfg_json = json.dumps(config_to_dict(JAX_TINY))
    jax_run, port_run = root / "jax", root / "port"
    for run in (jax_run, port_run):
        run.mkdir()
        (run / "config.json").write_text(cfg_json)
    mgr = JaxCheckpointManager(jax_run / "ckpt")
    mgr.save(STAGE1_STEP, state, wait=True)
    mgr.close()
    CheckpointManager(port_run / "ckpt").save(STAGE1_STEP, train_state_from_jax(
        jax.tree.map(np.asarray, state), device="cpu"))
    return jax_run, port_run


def _anchors(lines):
    return {line.split("]")[0][len("anchor["):]: json.loads(
        line.split(": ", 1)[1]) for line in lines if line.startswith("anchor[")}


def test_eval_stage1(corpus, stage1_runs, tmp_path, monkeypatch, capsys):
    jax_run, port_run = stage1_runs
    n, seed = 8, 3
    _jax_script("eval_stage1", ["--run", str(jax_run), "--corpus", str(corpus),
                                "--n", str(n), "--seed", str(seed), "--out",
                                str(tmp_path / "jax")], monkeypatch)
    want_anchors = _anchors(capsys.readouterr().out.splitlines())
    want = json.loads((tmp_path / "jax" / "eval.json").read_text())

    cfg = config_from_dict(json.loads((port_run / "config.json").read_text()))
    st = CheckpointManager(port_run / "ckpt").restore(device="cpu")
    gen = SpectrogramGenerator(cfg.specgan)
    gen.load_state_dict(st.g_params)
    gen.eval()
    z = np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                     (n, cfg.specgan.latent_dim)))
    got, anchors = eval_stage1.evaluate(cfg, gen, corpus, torch.from_numpy(z),
                                        st.step)
    assert list(got) == list(want)
    assert got["checkpoint_step"] == want["checkpoint_step"] == STAGE1_STEP
    assert got["n_patches"] == want["n_patches"] == n
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    assert set(anchors) == set(want_anchors) == {"random_weights",
                                                 "white_noise"}
    for k, v in want_anchors["white_noise"].items():
        np.testing.assert_allclose(anchors["white_noise"][k], v, rtol=1e-4,
                                   err_msg=k)
    assert anchors["random_weights"].keys() == want_anchors[
        "random_weights"].keys()
    assert all(np.isfinite(v) for v in anchors["random_weights"].values())

    # The CLI (its own torch-drawn latents) writes the JAX keys.
    metrics, cli_anchors = eval_stage1.main([
        "--run", str(port_run), "--corpus", str(corpus), "--n", str(n),
        "--device", "cpu", "--out", str(tmp_path / "port")])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads((tmp_path / "port" / "eval.json").read_text()) == metrics
    assert list(metrics) == list(want)
    assert _anchors(lines) == cli_anchors
    assert metrics["real_flux"] == got["real_flux"]  # same real patches


CKPT_STEPS = (2, 4, 6)


def _jax_stage2_cfg():
    return dataclasses.replace(JAX_TINY, train=dataclasses.replace(
        JAX_TINY.train, ema_decay=0.999))


@pytest.fixture(scope="module")
def stage2_runs(tmp_path_factory):
    """Three TINY stage-2 checkpoints with perturbed generator weights, as
    a JAX run and, converted, as a port run."""
    root = tmp_path_factory.mktemp("stage2_runs")
    cfg = _jax_stage2_cfg()
    base = jax_stage2.make_train_state(cfg, jax.random.PRNGKey(0))
    jax_run, port_run = root / "jax", root / "port"
    for run in (jax_run, port_run):
        run.mkdir()
        (run / "config.json").write_text(json.dumps(config_to_dict(cfg)))
        (run / "mel_stats.json").write_text(json.dumps(
            {"shift": -4.0, "scale": 2.5}))
    jax_mgr = JaxCheckpointManager(jax_run / "ckpt")
    port_mgr = CheckpointManager(port_run / "ckpt")
    rng = np.random.default_rng(1)
    for k, step in enumerate(CKPT_STEPS):
        def perturb(tree, scale):
            return jax.tree.map(lambda x: np.asarray(
                x + scale * rng.standard_normal(x.shape), np.float32), tree)

        st = dataclasses.replace(
            base, step=np.int32(step),
            g_params=perturb(base.g_params, 0.01 * (k + 1)),
            g_ema=perturb(base.g_ema, 0.02 * (k + 1)))
        jax_mgr.save(step, st, wait=True)
        port_mgr.save(step, train_state_from_jax(jax.tree.map(np.asarray, st),
                                                 device="cpu"))
    jax_mgr.close()
    return jax_run, port_run


def test_average_ckpts(corpus, stage2_runs, tmp_path, monkeypatch,
                       capsys):
    jax_run, port_run = stage2_runs
    steps = ",".join(map(str, CKPT_STEPS))
    _jax_script("average_ckpts", ["--run", str(jax_run), "--steps", steps,
                                  "--out", str(tmp_path / "jax_avg")],
                monkeypatch)
    out = average_ckpts.main(["--run", str(port_run), "--steps", steps,
                              "--out", str(tmp_path / "port_avg"),
                              "--device", "cpu"])
    assert out == tmp_path / "port_avg"
    lines = capsys.readouterr().out.splitlines()
    assert [f"loaded step {s}" for s in CKPT_STEPS] == [
        x for x in lines if x.startswith("loaded")][-3:]

    mgr = JaxCheckpointManager(tmp_path / "jax_avg" / "ckpt")
    want = jax.tree.map(np.asarray, mgr.restore(
        abstract_state(_jax_stage2_cfg(), stage=2), step=max(CKPT_STEPS)))
    mgr.close()
    got = CheckpointManager(out / "ckpt").restore(max(CKPT_STEPS),
                                                  device="cpu")
    want_port = train_state_from_jax(want, device="cpu")
    assert got.step == want_port.step == CKPT_STEPS[-1]
    for tree in ("g_params", "g_ema", "d_params"):
        a, b = getattr(got, tree), getattr(want_port, tree)
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(a[name].numpy(), b[name].numpy(),
                                          err_msg=f"{tree}.{name}")
    for name in got.g_opt.mu:
        np.testing.assert_array_equal(got.g_opt.mu[name].numpy(),
                                      want_port.g_opt.mu[name].numpy())
    # The float64 mean, by hand.
    states = [CheckpointManager(port_run / "ckpt").restore(s, device="cpu")
              for s in CKPT_STEPS]
    name = next(iter(got.g_params))
    mean = sum(s.g_params[name].double() for s in states) / len(states)
    torch.testing.assert_close(got.g_params[name], mean.float(), rtol=0,
                               atol=0)
    for f in ("config.json", "mel_stats.json"):
        assert (out / f).read_text() == (port_run / f).read_text()
    assert ((out / "STATUS").read_text().replace(str(port_run), "RUN")
            == (tmp_path / "jax_avg" / "STATUS").read_text().replace(
                str(jax_run), "RUN"))

    # The averaged run is a run for the port's eval and export CLIs.
    metrics = eval_checkpoint.main([
        "--run", str(out), "--corpus", str(corpus), "--n-clips", "1",
        "--seconds", "0.5", "--device", "cpu", "--out", str(tmp_path / "ev")])
    assert metrics["checkpoint_step"] == CKPT_STEPS[-1]
    assert metrics["generator_weights"] == 1.0  # the averaged EMA
    assert np.isfinite(metrics["copy_synthesis_multires_stft_distance_mean"])
    export_zoo.main(["--run", str(out), "--stage", "2", "--name", "avg",
                     "--root", str(tmp_path / "zoo"), "--device", "cpu"])
    entry = zoo.load_pretrained("avg", root=tmp_path / "zoo")
    for name, t in entry.state_dict.items():
        np.testing.assert_array_equal(t.numpy(), got.g_ema[name].numpy())
