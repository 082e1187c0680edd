"""The port's MusicNet loader (``data/musicnet.py``) against the JAX
package's, on the fabricated miniature fixture of ``tests/test_musicnet.py``
(two 3 s clips at 44.1 kHz with note labels; no dataset is fetched).

Labels, segment queries (with the 44.1 kHz -> 22.05 kHz conversion), the
instrument histogram and the missing-root error equal JAX's. ``sample_batch``
audio equals JAX's exactly on the scipy path (the port's native library
made unavailable, since the JAX package's is not built here), and stays
within 2e-3 of it on the native path (``tests/test_native.py``'s tolerance
for the C++ resampler), clip by clip, away from each clip's first and last
200 samples.
"""

import numpy as np
import pytest

from music_synthesis_tpu.data import musicnet as jax_musicnet
from music_synthesis_tpu_torch.data import musicnet, native
from music_synthesis_tpu_torch.utils.wav import write_wav

HEADER = ("start_time,end_time,instrument,note,"
          "start_beat,end_beat,note_value\n")


@pytest.fixture()
def mini_musicnet(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "train_data").mkdir()
    (tmp_path / "train_labels").mkdir()
    for cid, notes in [
        ("1727", [(0, 44100, 1, 60), (22050, 88200, 41, 64)]),
        ("2303", [(44100, 132300, 7, 72)]),
    ]:
        wav = 0.2 * rng.standard_normal(musicnet.MUSICNET_SR * 3).astype(
            np.float32)
        write_wav(tmp_path / "train_data" / f"{cid}.wav",
                  musicnet.MUSICNET_SR, wav)
        rows = [f"{s},{e},{i},{n},{s / 44100:.2f},{e / 44100:.2f},Quarter"
                for s, e, i, n in notes]
        (tmp_path / "train_labels" / f"{cid}.csv").write_text(
            HEADER + "\n".join(rows) + "\n")
    return tmp_path


def _both(root, **kw):
    return (musicnet.MusicNetDataset(root, **kw),
            jax_musicnet.MusicNetDataset(root, **kw))


def test_labels_and_segment_queries_match(mini_musicnet):
    assert musicnet.MUSICNET_SR == jax_musicnet.MUSICNET_SR == 44_100
    port, ref = _both(mini_musicnet, sample_rate=22_050, segment_length=2048)
    assert port.ids == ref.ids and sorted(port.ids) == ["1727", "2303"]
    for cid in port.ids + ["nope"]:
        assert ([vars(n) for n in port.labels_for(cid)]
                == [vars(n) for n in ref.labels_for(cid)])
    assert port.labels_for("nope") == []
    notes = port.labels_for("1727")
    assert notes[0].instrument == 1 and notes[1].start_beat == 0.5
    for cid, start, length in (("1727", 0, 11025), ("1727", 0, 22050),
                               ("1727", 33000, 11050), ("2303", 20000, 30000),
                               ("2303", 0, 100)):
        got = [n.note for n in port.notes_in_segment(cid, start, length)]
        assert got == [n.note for n in ref.notes_in_segment(cid, start,
                                                            length)]
    assert [n.note for n in port.notes_in_segment("1727", 0, 11025)] == [60]
    assert [n.note for n in port.notes_in_segment("1727", 33000,
                                                  11050)] == [64]


def test_histogram_and_bad_root_match(mini_musicnet, tmp_path):
    port, ref = _both(mini_musicnet)
    assert port.instrument_histogram() == ref.instrument_histogram() == {
        1: 1, 41: 1, 7: 1}
    with pytest.raises(FileNotFoundError) as got:
        musicnet.MusicNetDataset(tmp_path / "empty")
    with pytest.raises(FileNotFoundError) as want:
        jax_musicnet.MusicNetDataset(tmp_path / "empty")
    assert str(got.value) == str(want.value)


def test_sample_batch_matches(mini_musicnet, monkeypatch):
    kw = dict(sample_rate=22_050, segment_length=2048)
    ref = jax_musicnet.MusicNetDataset(mini_musicnet, **kw)
    native_port = musicnet.MusicNetDataset(mini_musicnet, **kw)
    monkeypatch.setattr(native, "available", lambda: False)
    scipy_port = musicnet.MusicNetDataset(mini_musicnet, **kw)
    for step, batch, seed in ((0, 2, 0), (5, 3, 1)):
        want = ref.sample_batch(step, batch, seed)
        got = scipy_port.sample_batch(step, batch, seed)
        assert got.shape == (batch, 2048) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
    # The native path: whole clips resampled by the C++ library, the same
    # lengths (so the same segments are drawn).
    assert native_port.audio.lengths == ref.audio.lengths
    for got, want in zip(native_port.audio.clips, ref.audio.clips):
        np.testing.assert_allclose(got[200:-200], want[200:-200], atol=2e-3)
