"""The port's sequence-sharded vocoding (``parallel/seqshard.py``) on the CPU,
against the JAX package's ``parallel/seqshard.py``.

- ``receptive_field_frames`` equals JAX's for TINY's, the default and the
  iSTFT-head vocoder configs.
- ``make_seqshard_vocode`` over 2 CPU replicas, on TINY vocoders (both
  heads) with JAX-initialised, jittered weights (``torch_tiny_ref``),
  against JAX's seqshard vocode on a 2-device mesh (every sample), against
  JAX's direct vocoding and the port's own (the interior, one halo away
  from the two global edges): 2e-5 absolute, the JAX test's tolerance.
- The batch x sequence composition of ``tests/test_mesh2d.py``: a batch of
  4 split over 2 replicas, each shard's sequence over 2 more, against
  direct vocoding in the interior (2e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_synthesis_tpu import config as jax_config
from music_synthesis_tpu.parallel.mesh import make_mesh
from music_synthesis_tpu.parallel.seqshard import (
    make_seqshard_vocode as jax_seqshard,
    receptive_field_frames as jax_rf,
)
from music_synthesis_tpu_torch import config
from music_synthesis_tpu_torch.parallel.seqshard import (
    make_seqshard_vocode,
    receptive_field_frames,
)

from torch_tiny_ref import ISTFT, tiny_vocoder

torch.set_num_threads(1)
ATOL = 2e-5


@pytest.mark.parametrize("kw", [{}, ISTFT, {"upsample_factors": (4, 4, 4),
                                             "res_dilations": (1, 3, 9, 27)}])
@pytest.mark.parametrize("base", ["tiny", "default"])
def test_receptive_field_matches_jax(base, kw):
    jcfg = (jax_config.TINY if base == "tiny"
            else jax_config.PipelineConfig()).vocoder
    cfg = (config.TINY if base == "tiny" else config.PipelineConfig()).vocoder
    jcfg, cfg = (dataclasses.replace(c, **kw) for c in (jcfg, cfg))
    assert receptive_field_frames(cfg) == jax_rf(jcfg)


def _mel(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("head", ["waveform", "istft"])
def test_seqshard_vocode_matches_jax_and_direct(head):
    jvoc, params, voc = tiny_vocoder(seed=3, **(ISTFT if head == "istft"
                                                else {}))
    mel = _mel((2, 64, voc.cfg.n_mels))
    fn = make_seqshard_vocode(voc, ["cpu", "cpu"])
    got = fn(torch.from_numpy(mel)).numpy()
    mesh = make_mesh((2,), devices=jax.devices()[:2])
    want = np.asarray(jax_seqshard(jvoc, mesh)(params, jnp.asarray(mel)))
    assert got.shape == want.shape == (2, 64 * voc.cfg.hop_length)
    np.testing.assert_allclose(got, want, atol=ATOL)
    h = receptive_field_frames(voc.cfg) + 2
    mid = slice(h * voc.cfg.hop_length, -h * voc.cfg.hop_length)
    direct_jax = np.asarray(jvoc.apply({"params": params}, jnp.asarray(mel)))
    with torch.inference_mode():
        direct = voc(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got[:, mid], direct_jax[:, mid], atol=ATOL)
    np.testing.assert_allclose(got[:, mid], direct[:, mid], atol=ATOL)


def test_seqshard_refuses_what_does_not_split():
    _, _, voc = tiny_vocoder(seed=3)
    fn = make_seqshard_vocode(voc, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="do not split"):
        fn(torch.zeros((1, 63, voc.cfg.n_mels)))
    with pytest.raises(ValueError, match="halo"):
        fn(torch.zeros((1, 4, voc.cfg.n_mels)))


def test_batch_and_sequence_sharded_vocoding():
    """``tests/test_mesh2d.py``'s (2 batch x 2 sequence) layout."""
    _, _, voc = tiny_vocoder(seed=5)
    mel = torch.from_numpy(_mel((4, 64, voc.cfg.n_mels), seed=1))
    seq = [make_seqshard_vocode(voc, ["cpu", "cpu"]) for _ in range(2)]
    out = torch.cat([fn(part) for fn, part in zip(seq, mel.chunk(2))])
    with torch.inference_mode():
        direct = voc(mel)
    assert out.shape == direct.shape
    h = receptive_field_frames(voc.cfg) + 2
    mid = slice(h * voc.cfg.hop_length, -h * voc.cfg.hop_length)
    np.testing.assert_allclose(out[:, mid].numpy(), direct[:, mid].numpy(),
                               atol=ATOL)
