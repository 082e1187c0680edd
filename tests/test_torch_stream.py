"""The port's streaming synthesis (``infer/stream.py``) and latent paths
(``infer/latent.py``), on the CPU.

The stream is held against the port's own ``generate_long`` on the same
latents (crossfade 4, 0 and 8, the last with 9 patches, more than the
serving grid's largest bucket) and against the JAX package's
``StreamingSynth``, on the TINY models of ``torch_tiny_ref`` with the same
latents: 1e-4 relative and
1e-5 absolute, the JAX package's own stream-vs-``generate_long``
tolerance (fp32 convolutions in another summation order). ``slerp`` and
``latent_path`` are held to JAX to 1e-5 (a few fp32 ulps through the
trigonometry); ``latent_walk`` to 1e-5 with JAX's draws injected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_synthesis_tpu.infer import latent as jax_latent
from music_synthesis_tpu.infer.stream import StreamingSynth as JaxStream
from music_synthesis_tpu_torch.infer.generate import generate_long
from music_synthesis_tpu_torch.infer.latent import latent_path, latent_walk, slerp
from music_synthesis_tpu_torch.infer.stream import StreamingSynth

from torch_tiny_ref import tiny_pair

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=21)


def _stream(s, z):
    parts = [s.feed(z[:, i]) for i in range(z.shape[1])]
    parts.append(s.finish())
    return parts, np.concatenate(parts, axis=-1)


@pytest.mark.parametrize("cf, n", [(4, 5), (0, 5), (8, 9)])
def test_stream_matches_generate_long(pair, cf, n):
    _, cfg, _, _, comp, voc = pair
    z = np.random.default_rng(9).standard_normal((2, n, 16)).astype(np.float32)
    with torch.no_grad():
        ref = generate_long(cfg, comp, voc, torch.from_numpy(z), cf).numpy()
    parts, out = _stream(StreamingSynth(cfg, comp, voc, crossfade_frames=cf), z)
    assert out.shape == ref.shape
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    # Audio arrives incrementally, not all in the flush.
    assert sum(p.shape[-1] for p in parts[:-1]) > 0.5 * ref.shape[-1]


@pytest.mark.parametrize("cf", [4, 0])
def test_stream_matches_jax_stream(pair, cf):
    jcfg, cfg, sp, vp, comp, voc = pair
    z = np.random.default_rng(10).standard_normal((1, 4, 16)).astype(np.float32)
    want_parts, want = _stream(JaxStream(jcfg, sp, vp, crossfade_frames=cf),
                               jnp.asarray(z))
    got_parts, got = _stream(StreamingSynth(cfg, comp, voc,
                                            crossfade_frames=cf), z)
    assert [p.shape for p in got_parts] == [p.shape for p in want_parts]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_stream_state_is_bounded(pair):
    """Host buffers stay O(patch + chunk) whatever the stream's length."""
    _, cfg, _, _, comp, voc = pair
    s = StreamingSynth(cfg, comp, voc, crossfade_frames=4)
    rng = np.random.default_rng(11)
    sizes = []
    for _ in range(12):
        s.feed(rng.standard_normal((1, 16)).astype(np.float32))
        sizes.append((s._mel_acc.shape[1],
                      0 if s._final_mel is None else s._final_mel.shape[1],
                      0 if s._wav_acc is None else s._wav_acc.shape[1]))
    assert sizes[-1] == sizes[-3], sizes[-4:]


def test_stream_rejects_bad_use(pair):
    _, cfg, _, _, comp, voc = pair
    with pytest.raises(ValueError):
        StreamingSynth(cfg, comp, voc, crossfade_frames=cfg.specgan.n_frames)
    s = StreamingSynth(cfg, comp, voc, crossfade_frames=4)
    s.feed(np.zeros((1, 16), np.float32))
    s.finish()
    with pytest.raises(AssertionError):
        s.feed(np.zeros((1, 16), np.float32))


def _ab(seed=5, shape=(3, 64)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("t", [0.0, 0.3, 0.5, 1.0])
def test_slerp_matches_jax(t):
    a, b = _ab()
    want = np.asarray(jax_latent.slerp(jnp.asarray(a), jnp.asarray(b), t))
    got = slerp(torch.from_numpy(a), torch.from_numpy(b), t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_slerp_parallel_falls_back_to_lerp():
    a, _ = _ab(shape=(2, 16))
    want = np.asarray(jax_latent.slerp(jnp.asarray(a), 2.0 * jnp.asarray(a),
                                       0.5))
    got = slerp(torch.from_numpy(a), 2.0 * torch.from_numpy(a), 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, 1.5 * a, rtol=1e-4, atol=1e-5)


def test_latent_path_matches_jax():
    a, b = _ab(shape=(2, 32))
    want = np.asarray(jax_latent.latent_path(jnp.asarray(a), jnp.asarray(b), 6))
    got = latent_path(torch.from_numpy(a), torch.from_numpy(b), 6).numpy()
    assert got.shape == (2, 6, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        latent_path(torch.from_numpy(a), torch.from_numpy(b), 1)


def test_latent_walk_matches_jax_with_its_draws():
    key = jax.random.PRNGKey(5)
    n, batch, dim = 8, 2, 64
    keys = jax.random.split(key, n)
    draws = np.stack([np.asarray(jax.random.normal(k, (batch, dim)))
                      for k in keys])
    want = np.asarray(jax_latent.latent_walk(key, batch, n, dim, step=0.3))
    got = latent_walk(0, batch, n, dim, step=0.3,
                      draws=torch.from_numpy(draws)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_latent_walk_is_seeded_smooth_and_on_shell():
    z = latent_walk(3, batch=2, n=8, latent_dim=64, step=0.3)
    assert torch.equal(z, latent_walk(torch.Generator().manual_seed(3), 2, 8,
                                      64, step=0.3))
    assert not torch.equal(z, latent_walk(4, 2, 8, 64, step=0.3))
    step_d = torch.linalg.norm(z.diff(dim=1), dim=-1)
    assert 0.5 < step_d.mean() < 0.7 * np.sqrt(2 * 64)
    assert 5.0 < torch.linalg.norm(z, dim=-1).mean() < 11.0
