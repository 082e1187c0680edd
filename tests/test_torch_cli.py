"""The port's CLIs (train_stage1, train_stage2, export_zoo) on the CPU at TINY,
against the JAX scripts and the JAX package's zoo.

- The run files: ``config.json`` equal field for field and ``mel_stats.json``
  within 1e-5 of the JAX script's for the same flags and corpus (the JAX
  ``main()`` runs until its ``make_train_state``, which is made to stop
  it); ``metrics.jsonl`` with the keys, in order, of the committed
  flagship runs' lines (the flags are those recipes' at TINY's size).
- Resume: 4 steps in one run and 2 + ``--resume`` 2 give bit-identical
  states and metrics (stage 2's straight run with ``--steps-per-dispatch
  2``, its split one with 1; the straight runs with ``--guard``, the first
  half of the split ones with ``--debug-nans`` and no prefetch thread).
- Export: a port-exported entry loads in JAX's ``zoo.load_pretrained`` with
  the checkpoint's EMA weights, equal arrays, and JAX's generator on it
  matches the port's (1e-5 relative to the output's peak); the port's
  ``SynthService`` serves the exported pair.
- Without ``--device cpu`` and without a card each CLI exits non-zero.
- ``--mesh 2 --device cpu`` (two gloo ranks started by the CLI): the
  stage-1 CLI with ``--dp jit`` and the flagship's flags, and
  ``train_two_stage`` (both training CLIs with the default ``--dp
  shard_map``, then ``generate`` with a report), write the JAX scripts'
  run files for the same flags (``mesh_shape`` [2]; mel statistics within
  1e-5), the flagship's metric keys, and one checkpoint, from rank 0. The
  JAX scripts' refusals hold: a batch that does not divide by ``--mesh``,
  ``--pallas-frontend`` or ``--steps-per-dispatch`` with ``--dp jit``.
- Every module of the port imports with ``jax`` and ``music_synthesis_tpu``
  made unimportable.
"""

import dataclasses
import importlib.util
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_synthesis_tpu import zoo as jax_zoo
from music_synthesis_tpu.models.specgan import SpectrogramGenerator as JaxG
from music_synthesis_tpu.models.vocoder import Vocoder as JaxVocoder
from music_synthesis_tpu_torch import config, zoo
from music_synthesis_tpu_torch.convert import to_state_dict
from music_synthesis_tpu_torch.data.dataset import make_synthetic_corpus
from music_synthesis_tpu_torch.scripts import (
    export_zoo,
    train_stage1,
    train_stage2,
    train_two_stage,
)
from music_synthesis_tpu_torch.serve import ServeConfig, SynthService
from music_synthesis_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]

# The flagship recipes' flags (runs/stage1_flux_40k, runs/stage2_istft_long)
# at TINY's size; the stage-2 warmup gate cut to 2 steps so the runs cross it.
FLAGS = {
    1: ["--preset", "tiny", "--batch", "2", "--init-scheme", "he",
        "--res-init-gain", "0.1", "--out-init-gain", "0.1", "--r1-gamma", "1",
        "--d-noise", "0.2", "--noise-decay-steps", "10000", "--ema", "0.999",
        "--lambda-flux", "10", "--auto-mel-stats", "--log-every", "2",
        "--ckpt-every", "2"],
    2: ["--preset", "tiny", "--batch", "2", "--segment", "2048", "--head",
        "istft", "--init-scheme", "he", "--bf16-gen", "--bf16-disc",
        "--dense-groups", "16", "--f-fold", "4", "--pallas-frontend",
        "--r1-gamma", "1", "--d-noise", "0.1", "--noise-decay-steps", "20000",
        "--g-warmup", "2", "--ema", "0.999", "--reuse-real-feats",
        "--concat-disc", "--auto-mel-stats", "--log-every", "2",
        "--ckpt-every", "2", "--audio-every", "2"],
}
CLI = {1: train_stage1, 2: train_stage2}
FLAGSHIP_RUN = {1: "stage1_flux_40k", 2: "stage2_istft_long"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    make_synthetic_corpus(root, n_clips=3, seconds=2.0)
    return root


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """For each stage: a 4-step run, and a 2-step run resumed to 4."""
    out = {}
    for stage in (1, 2):
        base = tmp_path_factory.mktemp(f"stage{stage}")
        common = FLAGS[stage] + ["--corpus", str(corpus), "--device", "cpu"]
        straight, split = base / "straight", base / "split"
        k = ["--steps-per-dispatch", "2"] if stage == 2 else []
        CLI[stage].main(common + k + ["--steps", "4", "--outdir", str(straight),
                                      "--guard"])
        CLI[stage].main(common + ["--steps", "2", "--outdir", str(split),
                                  "--prefetch", "0", "--debug-nans"])
        CLI[stage].main(common + ["--steps", "4", "--outdir", str(split),
                                  "--resume"])
        out[stage] = {"straight": straight, "split": split}
    return out


def _jax_main(name, argv, monkeypatch):
    """Run a JAX script's ``main()`` until it asks for its train state."""
    from music_synthesis_tpu.train import stage1 as jax_stage1
    from music_synthesis_tpu.train import stage2 as jax_stage2
    from music_synthesis_tpu.utils import env

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    for mod in (jax_stage1, jax_stage2):
        monkeypatch.setattr(mod, "make_train_state", stop)
    monkeypatch.setattr(env, "maybe_force_cpu", lambda: None)
    monkeypatch.setattr(env, "enable_persistent_compile_cache",
                        lambda *a: None)
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    with pytest.raises(Stop):
        mod.main()


def _assert_run_files(port, want_dir, stage):
    """``port``'s config.json (and mel_stats.json) against the JAX script's
    in ``want_dir``, and its metrics.jsonl keys against the flagship run's
    (the JAX logger's order)."""
    want = json.loads((want_dir / "config.json").read_text())
    got = json.loads((port / "config.json").read_text())
    if (want_dir / "mel_stats.json").exists():
        want_stats = json.loads((want_dir / "mel_stats.json").read_text())
        got_stats = json.loads((port / "mel_stats.json").read_text())
        assert want.pop("mel_scaler") == want_stats
        assert got.pop("mel_scaler") == got_stats
        assert got_stats.keys() == want_stats.keys()
        for k in want_stats:
            assert abs(got_stats[k] - want_stats[k]) <= 1e-5, k
    assert got == want  # every other section, field for field
    line = (REPO / "runs" / FLAGSHIP_RUN[stage] / "metrics.jsonl").open().readline()
    keys = set(json.loads(line))
    lines = (port / "metrics.jsonl").read_text().splitlines()
    assert lines and all(set(json.loads(x)) <= keys for x in lines)
    return lines


@pytest.mark.parametrize("stage", [1, 2])
def test_run_files_match_the_jax_script(stage, runs, corpus, tmp_path,
                                        monkeypatch):
    _jax_main(f"train_stage{stage}", FLAGS[stage] + [
        "--corpus", str(corpus), "--steps", "4", "--outdir", str(tmp_path)],
        monkeypatch)
    _assert_run_files(runs[stage]["straight"], tmp_path, stage)
    # The flagship recipe's logged keys, in the JAX logger's order.
    line = (REPO / "runs" / FLAGSHIP_RUN[stage] / "metrics.jsonl").open().readline()
    keys = list(json.loads(line))
    for run in runs[stage].values():
        lines = (run / "metrics.jsonl").read_text().splitlines()
        assert lines and all(list(json.loads(x)) == keys for x in lines)


@pytest.fixture(scope="module")
def mesh_runs(corpus, tmp_path_factory):
    """The stage-1 CLI over two ranks with ``--dp jit``, and
    ``train_two_stage`` over two ranks."""
    base = tmp_path_factory.mktemp("mesh")
    stage1_argv = FLAGS[1] + ["--corpus", str(corpus), "--mesh", "2",
                              "--dp", "jit", "--steps", "2", "--log-every",
                              "1"]
    train_stage1.main(stage1_argv + ["--device", "cpu", "--outdir",
                                     str(base / "stage1_jit")])
    two_argv = ["--corpus", str(corpus), "--steps", "2", "--batch", "2",
                "--mesh", "2", "--preset", "tiny"]
    train_two_stage.main(two_argv + ["--device", "cpu", "--outdir",
                                     str(base / "two_stage")])
    return {"base": base, "stage1_argv": stage1_argv, "two_argv": two_argv}


def test_mesh_stage1_jit_run_matches_the_jax_script(mesh_runs, tmp_path,
                                                    monkeypatch):
    _jax_main("train_stage1", mesh_runs["stage1_argv"] + [
        "--outdir", str(tmp_path)], monkeypatch)
    run = mesh_runs["base"] / "stage1_jit"
    lines = _assert_run_files(run, tmp_path, 1)
    assert [json.loads(x)["step"] for x in lines] == [1, 2]
    assert json.loads((run / "config.json").read_text())["train"][
        "mesh_shape"] == [2]
    assert CheckpointManager(run / "ckpt").all_steps() == [2]
    assert _state(run).step == 2


@pytest.mark.parametrize("stage", [1, 2])
def test_train_two_stage_runs_match_the_jax_scripts(stage, mesh_runs,
                                                    tmp_path, monkeypatch):
    _jax_main(f"train_stage{stage}", mesh_runs["two_argv"] + [
        "--outdir", str(tmp_path)], monkeypatch)
    run = mesh_runs["base"] / "two_stage" / f"stage{stage}"
    _assert_run_files(run, tmp_path, stage)
    assert _state(run).step == 2


def test_train_two_stage_generates_from_both_runs(mesh_runs):
    samples = mesh_runs["base"] / "two_stage" / "samples"
    assert sorted(p.name for p in samples.iterdir()) == [
        "report.html"] + [f"sample_{i:03d}.wav" for i in range(4)]
    cmds = train_two_stage.commands(
        train_two_stage.parser().parse_args(mesh_runs["two_argv"]), "C")
    assert [c[2].rsplit(".", 1)[1] for c in cmds] == [
        "train_stage1", "train_stage2", "generate"]
    assert all(c[c.index("--mesh") + 1] == "2" for c in cmds[:2])


def _state(run):
    return CheckpointManager(run / "ckpt").restore(device="cpu")


@pytest.mark.parametrize("stage", [1, 2])
def test_resumed_run_equals_the_straight_run(stage, runs):
    a, b = _state(runs[stage]["straight"]), _state(runs[stage]["split"])
    assert a.step == b.step == 4
    assert CheckpointManager(runs[stage]["split"] / "ckpt").all_steps() == [2, 4]
    for x, y in ((a.g_params, b.g_params), (a.d_params, b.d_params),
                 (a.g_ema, b.g_ema), (a.g_opt.mu, b.g_opt.mu),
                 (a.d_opt.nu, b.d_opt.nu)):
        assert x.keys() == y.keys()
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert a.g_opt.count == b.g_opt.count and a.d_opt.count == b.d_opt.count
    assert torch.equal(a.rng.get_state(), b.rng.get_state())

    def lines(run):
        return {json.loads(x)["step"]: {k: v for k, v in json.loads(x).items()
                                        if k != "wall_s"}
                for x in (run / "metrics.jsonl").read_text().splitlines()}

    straight, split = lines(runs[stage]["straight"]), lines(runs[stage]["split"])
    assert straight[4] == split[4]
    if stage == 2:
        names = {p.name for p in runs[2]["straight"].glob("*.wav")}
        assert names == {"vocoded_0000002.wav", "real_0000002.wav",
                         "vocoded_0000004.wav", "real_0000004.wav"}


@pytest.fixture(scope="module")
def exported(runs, tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo")
    for stage, name in ((1, "comp"), (2, "voc")):
        export_zoo.main(["--run", str(runs[stage]["straight"]), "--stage",
                         str(stage), "--name", name, "--root", str(root),
                         "--device", "cpu"])
    return root


def test_exported_entries_load_in_jax(runs, exported):
    rng = np.random.default_rng(0)
    for stage, name in ((1, "comp"), (2, "voc")):
        want = _state(runs[stage]["straight"]).g_ema
        jentry = jax_zoo.load_pretrained(name, root=exported)
        entry = zoo.load_pretrained(name, root=exported)
        assert jentry.card == entry.card
        assert jentry.card["metrics"] == {"checkpoint_step": 4}
        assert jentry.mel_scaler == jax_zoo.MelScaler(
            **json.loads((runs[stage]["straight"] / "mel_stats.json").read_text()))
        jsd = to_state_dict(jentry.params)
        assert jsd.keys() == want.keys() == entry.state_dict.keys()
        assert all(torch.equal(jsd[k], want[k]) and
                   torch.equal(entry.state_dict[k], want[k]) for k in want)
        # JAX's generator on the exported weights against the port's, fp32.
        jcfg = dataclasses.replace(jentry.config, compute_dtype="float32")
        if stage == 1:
            x = rng.standard_normal((2, jcfg.latent_dim)).astype(np.float32)
            ref = JaxG(jcfg).apply({"params": jentry.params}, jnp.asarray(x))
        else:
            x = np.tanh(rng.standard_normal((2, 8, jcfg.n_mels))).astype(
                np.float32)
            ref = JaxVocoder(jcfg).apply({"params": jentry.params},
                                         jnp.asarray(x))
        with torch.no_grad():
            got = entry.model("cpu", "float32")(torch.from_numpy(x)).numpy()
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_service_serves_the_exported_pair(exported):
    svc = SynthService(ServeConfig(
        composer=str(exported / "comp"), vocoder=str(exported / "voc"),
        batch_buckets=(1,), patch_buckets=(1,), crossfade_frames=4),
        base_cfg=config.TINY, device="cpu")
    wav, meta = svc.synth(0.2, seed=1)
    sr = svc.cfg.frontend.sample_rate
    assert wav.shape == (1, int(round(0.2 * sr))) and np.isfinite(wav).all()
    assert np.abs(wav).max() > 0
    # The served normalization is the training run's.
    card = json.loads((exported / "voc" / "card.json").read_text())
    assert dataclasses.asdict(svc.cfg.mel_scaler) == card["mel_scaler"]


@pytest.mark.parametrize("cli", ["train_stage1", "train_stage2", "export_zoo"])
def test_cli_without_a_card_exits_nonzero(cli, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = {"train_stage1": train_stage1, "train_stage2": train_stage2,
           "export_zoo": export_zoo}[cli]
    argv = (["--run", str(tmp_path), "--stage", "1", "--name", "x", "--root",
             str(tmp_path)] if cli == "export_zoo" else
            ["--preset", "tiny", "--steps", "1", "--outdir", str(tmp_path)])
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


REFUSED = {
    "batch": (["--mesh", "2", "--batch", "3"], "must be divisible by --mesh"),
    "pallas_jit": (["--mesh", "2", "--dp", "jit", "--pallas-frontend"],
                   "requires --dp shard_map"),
    "dispatch_jit": (["--mesh", "2", "--dp", "jit", "--steps-per-dispatch",
                      "2", "--log-every", "2", "--ckpt-every", "2",
                      "--audio-every", "2"], "needs --dp shard_map"),
}


@pytest.mark.parametrize("cli, case", [
    (train_stage1, "batch"), (train_stage2, "batch"),
    (train_stage2, "pallas_jit"), (train_stage2, "dispatch_jit")])
def test_mesh_is_refused(cli, case, tmp_path, capsys):
    """The JAX scripts' refusals under ``--mesh``, before any rank starts
    or any file is written (stage 1 has no ``--pallas-frontend`` or
    ``--steps-per-dispatch``)."""
    argv, message = REFUSED[case]
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--device", "cpu", "--outdir", str(tmp_path)])
    assert e.value.code not in (0, None)
    assert message in capsys.readouterr().err + str(e.value.code)
    assert not list(tmp_path.iterdir())


def test_every_module_imports_without_jax():
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax",
                   "music_synthesis_tpu"}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is blocked")

        sys.meta_path.insert(0, Block())
        for name in BLOCKED:
            try:
                importlib.import_module(name)
            except ImportError:
                pass
            else:
                raise SystemExit(f"{name} imported")
        import music_synthesis_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print(" ".join(names) if not bad else "LOADED " + " ".join(bad))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for cli in ("train_stage1", "train_stage2", "export_zoo",
                "train_two_stage", "extract_features", "eval_stage1",
                "parity", "average_ckpts", "export_deploy",
                "bench_rtf_batch", "bench_serve"):
        assert f"music_synthesis_tpu_torch.scripts.{cli}" in names
    for mod in ("train.stage1", "data.dataset", "data.prefetch", "data.stats",
                "train.guard", "train.metrics", "utils.wav", "zoo",
                "parallel.mesh", "parallel.multihost", "parallel.dp",
                "parallel.shard_map_dp", "parallel.seqshard", "data.native",
                "data.musicnet", "utils.profiling", "deploy", "bench",
                "_graphs"):
        assert f"music_synthesis_tpu_torch.{mod}" in names
