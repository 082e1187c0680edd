"""The port's serving latents, on the CPU.

A request's latent rows must be a prefix of any larger draw with the same
seed (the reference's ``serve.py::_z_rows`` documents it, and request
coalescing relies on it), at every latent width, and the committed cards'
width (128) must keep the draw it always had, so that their audio does not
change.
"""

import pytest
import torch

from music_synthesis_tpu_torch.serve import latent_rows


@pytest.mark.parametrize("latent_dim", [16, 20, 128])
@pytest.mark.parametrize("n", [1, 3])
def test_latent_rows_are_prefix_stable(latent_dim, n):
    full = latent_rows(7, 9, n, latent_dim)
    assert full.shape == (9, n, latent_dim) and full.dtype == torch.float32
    for n_clips in range(1, 9):
        rows = latent_rows(7, n_clips, n, latent_dim)
        assert torch.equal(rows, full[:n_clips]), n_clips
    assert not torch.equal(latent_rows(8, 1, n, latent_dim), full[:1])


@pytest.mark.parametrize("n_clips, n", [(1, 1), (3, 2), (4, 8)])
def test_committed_width_keeps_the_previous_draw(n_clips, n):
    """At latent_dim 128 the rows are ``torch.randn((n_clips, n, 128))``
    from the seeded CPU generator, bit for bit."""
    g = torch.Generator().manual_seed(7)
    want = torch.randn((n_clips, n, 128), generator=g)
    assert torch.equal(latent_rows(7, n_clips, n, 128), want)
