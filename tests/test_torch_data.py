"""The port's host-side modules against the JAX package's, on the CPU.

- ``utils/wav``: the same arrays read, written and resampled;
- ``data/dataset``: the corpus generators write byte-identical WAVs, and
  ``AudioDataset.sample_batch`` gives identical arrays for the same
  (step, batch, seed) in both residency modes, with and without augment;
- ``data/stats``: ``compute_mel_stats`` within 1e-5 of JAX's;
- ``data/prefetch``: order, errors, and a worker that stops on close;
- ``train/guard``: the same decision at every logged line of the committed
  run histories ``tests/test_guard.py`` reads;
- ``train/metrics``: the same JSON lines, apart from their time field;
- ``train/checkpoint``: numbered checkpoints, ``max_to_keep``, restore;
- ``_msgpack`` and ``convert.from_state_dict``: Flax's bytes for the same
  tree, and the committed zoo files written back byte for byte.
"""

import dataclasses
import json
from pathlib import Path

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from music_synthesis_tpu.config import TINY as JAX_TINY
from music_synthesis_tpu.data import dataset as jax_dataset
from music_synthesis_tpu.data.stats import compute_mel_stats as jax_mel_stats
from music_synthesis_tpu.train import guard as jax_guard
from music_synthesis_tpu.train.metrics import MetricsLogger as JaxLogger
from music_synthesis_tpu.utils import wav as jax_wav
from music_synthesis_tpu_torch import _msgpack, config
from music_synthesis_tpu_torch.convert import from_state_dict, to_state_dict
from music_synthesis_tpu_torch.data import dataset
from music_synthesis_tpu_torch.data.prefetch import Prefetcher
from music_synthesis_tpu_torch.data.stats import compute_mel_stats
from music_synthesis_tpu_torch.train import guard, stage1
from music_synthesis_tpu_torch.train.checkpoint import CheckpointManager
from music_synthesis_tpu_torch.train.metrics import MetricsLogger
from music_synthesis_tpu_torch.utils import wav

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    dataset.make_synthetic_corpus(root / "port", n_clips=3, seconds=1.0)
    jax_dataset.make_synthetic_corpus(root / "jax", n_clips=3, seconds=1.0)
    dataset.make_rich_corpus(root / "port_rich", n_clips=1, seconds=2.0)
    jax_dataset.make_rich_corpus(root / "jax_rich", n_clips=1, seconds=2.0)
    return root


def test_corpus_generators_write_identical_wavs(corpus):
    for port, ref in (("port", "jax"), ("port_rich", "jax_rich")):
        files = sorted(p.name for p in (corpus / ref).glob("*.wav"))
        assert files and files == sorted(
            p.name for p in (corpus / port).glob("*.wav"))
        for name in files:
            assert ((corpus / port / name).read_bytes()
                    == (corpus / ref / name).read_bytes()), name


def test_wav_io_and_resampling_match(tmp_path):
    rng = np.random.default_rng(0)
    x = (0.5 * np.sin(np.arange(4410) * 0.05)
         + 0.01 * rng.standard_normal(4410)).astype(np.float32)
    wav.write_wav(tmp_path / "a.wav", 44100, x)
    jax_wav.write_wav(tmp_path / "b.wav", 44100, x)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    sr, got = wav.read_wav(tmp_path / "a.wav")
    assert sr == 44100 and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_wav.read_wav(tmp_path / "a.wav")[1])
    np.testing.assert_array_equal(
        wav.load_wav(tmp_path / "a.wav", 22050, use_native=False),
        jax_wav.load_wav(tmp_path / "a.wav", 22050, use_native=False))


@pytest.mark.parametrize("ram_budget_mb", [None, 1])
@pytest.mark.parametrize("augment", [False, True])
def test_sample_batch_matches(corpus, ram_budget_mb, augment):
    kw = dict(segment_length=4096, ram_budget_mb=ram_budget_mb,
              augment=augment)
    port = dataset.AudioDataset(corpus / "jax", **kw)
    ref = jax_dataset.AudioDataset(corpus / "jax", **kw)
    assert len(port) == len(ref) == 3
    for step, batch, seed in ((0, 4, 0), (7, 3, 1), (2**30, 2, 0)):
        got = port.sample_batch(step, batch, seed)
        assert got.dtype == np.float32 and got.shape == (batch, 4096)
        np.testing.assert_array_equal(got, ref.sample_batch(step, batch, seed))


def test_process_shards_match(corpus):
    for index in (0, 1):
        port = dataset.AudioDataset(corpus / "jax", segment_length=4096,
                                    process_index=index, process_count=2)
        ref = jax_dataset.AudioDataset(corpus / "jax", segment_length=4096,
                                       process_index=index, process_count=2)
        assert port.paths == ref.paths
        np.testing.assert_array_equal(port.sample_batch(3, 2),
                                      ref.sample_batch(3, 2))


def test_budgeted_dataset_under_concurrent_sampling(corpus):
    """The prefetch thread and the main thread (audio dumps) sample one
    dataset at once; with a zero budget every miss evicts, so the LRU's
    lock is exercised. Eight threads, a short switch interval: every batch
    equals the one-thread batch and the cache's byte count stays exact."""
    import sys
    import threading

    want = dataset.AudioDataset(corpus / "jax", segment_length=4096)
    ds = dataset.AudioDataset(corpus / "jax", segment_length=4096,
                              ram_budget_mb=0)
    errors = []

    def work(offset):
        try:
            for step in range(offset, offset + 20):
                np.testing.assert_array_equal(ds.sample_batch(step, 3),
                                              want.sample_batch(step, 3))
        except AssertionError as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(7 * i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert ds._cache_bytes == sum(w.nbytes for w in ds._cache.values())


def test_mel_stats_match(corpus):
    ds = dataset.AudioDataset(corpus / "jax", segment_length=8192)
    kw = dict(n_batches=4, batch_size=8, seed=3)
    got = compute_mel_stats(ds, config.TINY, device="cpu", **kw)
    want = jax_mel_stats(ds, JAX_TINY, **kw)
    assert abs(got.shift - want.shift) <= 1e-5
    assert abs(got.scale - want.scale) <= 1e-5


def test_prefetcher_order_errors_and_close():
    with Prefetcher(lambda s: s * s, 3, 9, depth=2) as p:
        assert list(p) == [(s, s * s) for s in range(3, 9)]

    def boom(s):
        if s == 2:
            raise ValueError("bad batch")
        return s

    with Prefetcher(boom, 0, 5) as p, pytest.raises(ValueError, match="bad"):
        list(p)

    made = []
    p = Prefetcher(lambda s: made.append(s) or s, 0, 10**6, depth=2)
    it = iter(p)
    assert next(it) == (0, 0)
    p.close()
    assert not p._thread.is_alive()
    assert len(made) < 10


def _guard_runs():
    return ["stage2_istft_50k", "stage2_istft_warm_50k", "stage1_30k",
            "stage1_tempered", "stage2_50k_fast", "stage2_50k_fp32",
            "stage2_energy_50k", "stage2_200k_decay", "stage1_composer_40k",
            "stage1_flux_40k"]


@pytest.mark.parametrize("run", _guard_runs())
def test_guard_decides_as_jax(run):
    assert (dataclasses.asdict(guard.GuardConfig())
            == dataclasses.asdict(jax_guard.GuardConfig()))
    port, ref = guard.CollapseGuard(), jax_guard.CollapseGuard()
    lines = (REPO / "runs" / run / "metrics.jsonl").read_text().splitlines()
    fired = 0
    for line in lines:
        m = json.loads(line)
        got, want = port.update(int(m["step"]), m), ref.update(int(m["step"]), m)
        assert got == want, (run, m["step"])
        fired += want is not None
    assert lines and (fired > 0) == run.startswith(
        ("stage2_istft", "stage1_30k", "stage1_tempered"))


def test_metrics_lines_match(tmp_path, capsys):
    metrics = {"d_loss": 1.25, "g_adv": np.float32(0.5),
               "g_fm": torch.tensor(3.0), "note": "x"}
    for cls, name in ((MetricsLogger, "port"), (JaxLogger, "jax")):
        logger = cls(str(tmp_path / f"{name}.jsonl"))
        logger.log(3, metrics)
        logger.log(4, {"d_loss": 2.0})
        logger.close()
    out = capsys.readouterr().out.splitlines()

    def strip(line):
        rec = json.loads(line)
        assert isinstance(rec.pop("wall_s"), float)
        return rec, list(rec)

    port = (tmp_path / "port.jsonl").read_text().splitlines()
    ref = (tmp_path / "jax.jsonl").read_text().splitlines()
    assert len(port) == len(ref) == 2
    assert [strip(a) for a in port] == [strip(b) for b in ref]
    assert [strip(a) for a in out[:2]] == [strip(b) for b in out[2:]]


def test_checkpoint_manager_keeps_the_newest_and_restores(tmp_path):
    cfg = config.TINY
    st = stage1.make_train_state(cfg, seed=1, device="cpu")
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=3)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(device="cpu")
    mel = np.zeros((2, 32, 32), np.float32)
    for step in range(1, 6):
        st, _ = stage1.train_step(cfg, st, mel)
        mgr.save(step, st)
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    back = mgr.restore(device="cpu")
    assert back.step == 5 and torch.equal(back.rng.get_state(),
                                          st.rng.get_state())
    a, ma = stage1.train_step(cfg, back, mel)
    b, mb = stage1.train_step(cfg, st, mel)
    assert ma == mb
    assert all(torch.equal(a.d_params[k], b.d_params[k]) for k in a.d_params)
    assert mgr.restore(step=3, device="cpu").step == 3
    assert not list((tmp_path / "ckpt").glob("*.tmp"))


def test_msgpack_writer_gives_flax_bytes():
    rng = np.random.default_rng(1)
    tree = {"latent_in": {"kernel": rng.standard_normal((16, 8)).astype(
        np.float32), "bias": np.zeros(8, np.float32)},
        "conv": {"v": rng.standard_normal((3, 4, 5)).astype(np.float32),
                 "g": np.ones(5, np.float32), "b": np.zeros(5, np.float32)},
        **{f"res_{i}": {"b": np.full(i + 1, i, np.float32)} for i in range(17)}}
    assert _msgpack.to_bytes(tree) == flax.serialization.to_bytes(tree)
    sd = to_state_dict(tree)
    assert sd["latent_in.weight"].shape == (8, 16)
    back = from_state_dict(sd)
    assert _msgpack.to_bytes(back) == flax.serialization.to_bytes(tree)
    restored = flax.serialization.msgpack_restore(_msgpack.to_bytes(back))
    jax.tree.map(np.testing.assert_array_equal, restored, tree)


@pytest.mark.parametrize("name", ["specgan_flux", "vocoder_istft"])
def test_committed_zoo_weights_write_back_byte_for_byte(name):
    data = (REPO / "zoo" / name / "params.msgpack").read_bytes()
    tree = from_state_dict(to_state_dict(_msgpack.restore(data)))
    assert _msgpack.to_bytes(tree) == data

