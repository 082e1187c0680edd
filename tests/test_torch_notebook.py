"""The port's demo notebook (``notebooks/generate_and_listen_torch.ipynb``)
on the CPU, held against the JAX package.

- The notebook runs through ``nbclient`` on Jupyter's ``python3`` kernel
  (``MPLBACKEND=Agg``, so its ``display`` cells draw without a screen),
  with the ``parameters`` cell's ``DEVICE = "cpu"``, and one appended cell
  saves what its compute cells made. Its outputs, on the committed zoo
  weights (``specgan_flux``, ``vocoder_istft``) and its numpy latents,
  against the JAX package on the same weights (its ``zoo.load_pretrained``)
  and the same latents: the clips ``wav`` against ``generate``, ``mel``
  against ``SpectrogramGenerator.apply``, ``d`` against JAX's
  ``multires_stft_loss`` of the port's two clips, ``long_wav`` and
  ``wav_drift`` against ``generate_long`` (one jitted program: their
  latents share a shape), ``z_interp`` against ``latent_path``, and
  ``z_walk`` against the walk rebuilt from the same draws with JAX's
  ``slerp`` (JAX's ``latent_walk`` draws from a key).
- The zoo's ``vocoder_istft`` computes in bfloat16 (its card). Both
  packages' vocoders run in float32 here (the parameters cell's
  ``VOCODER_DTYPE``, and the JAX config's ``compute_dtype``), as
  ``chip_smoke.py``'s deploy check runs them, so every compared output is
  fp32 arithmetic in both: the serving tests' tolerance, 1e-4 relative
  and 1e-5 absolute.
- The notebook's JSON: no cell imports ``jax``, ``flax``, ``optax`` or the
  JAX package; every ``IPython`` or ``matplotlib`` import is in a cell
  tagged ``display``; no cell holds outputs or an execution count.
"""

import dataclasses
import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import nbformat
import numpy as np
import pytest
from nbclient import NotebookClient

from music_synthesis_tpu import zoo as jax_zoo
from music_synthesis_tpu.config import E2E_INFERENCE as JAX_E2E
from music_synthesis_tpu.infer.generate import generate, generate_long
from music_synthesis_tpu.infer.latent import latent_path, slerp
from music_synthesis_tpu.losses.stft_loss import multires_stft_loss
from music_synthesis_tpu.models.specgan import SpectrogramGenerator

REPO = Path(__file__).resolve().parents[1]
NOTEBOOK = REPO / "notebooks" / "generate_and_listen_torch.ipynb"
RTOL, ATOL = 1e-4, 1e-5
SAVED = ("z", "z_seq", "a", "b", "draws", "wav", "mel", "d", "long_wav",
         "z_interp", "z_walk", "wav_drift")
WALK_STEP = 0.3


def _cells():
    return nbformat.read(NOTEBOOK, as_version=4).cells


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The notebook's saved outputs, run on the CPU in float32."""
    nb = nbformat.read(NOTEBOOK, as_version=4)
    (params,) = [c for c in nb.cells
                 if "parameters" in c.metadata.get("tags", [])]
    source = params.source
    for name, value in (("DEVICE", '"cpu"'), ("VOCODER_DTYPE", '"float32"')):
        source, n = re.subn(rf"^{name} = None", f"{name} = {value}", source,
                            flags=re.M)
        assert n == 1, f"the parameters cell sets {name} once"
    params.source = source
    out = tmp_path_factory.mktemp("notebook") / "outputs.npz"
    nb.cells.append(nbformat.v4.new_code_cell(
        f"np.savez({str(out)!r}, "
        + ", ".join(f"{k}={k}" for k in SAVED) + ")"))
    env = {**os.environ, "MPLBACKEND": "Agg", "OMP_NUM_THREADS": "1"}
    NotebookClient(nb, kernel_name="python3", timeout=600,
                   resources={"metadata": {"path": str(NOTEBOOK.parent)}}
                   ).execute(env=env)
    return dict(np.load(out))


@pytest.fixture(scope="module")
def jax_pair():
    s1 = jax_zoo.load_pretrained("specgan_flux")
    s2 = jax_zoo.load_pretrained("vocoder_istft")
    cfg = dataclasses.replace(JAX_E2E, specgan=s1.config,
                              vocoder=dataclasses.replace(
                                  s2.config, compute_dtype="float32"))
    return cfg, s1.params, s2.params


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_notebook_outputs_match_the_jax_package(ran, jax_pair):
    cfg, sp, vp = jax_pair
    z = cfg.specgan.latent_dim
    assert ran["z"].shape == (4, z) and ran["z_seq"].shape == (1, 8, z)
    assert ran["wav"].shape == (4, cfg.specgan.n_frames
                                * cfg.vocoder.hop_length)
    _close(ran["wav"], jax.jit(generate, static_argnums=0)(
        cfg, sp, vp, jnp.asarray(ran["z"])))
    _close(ran["mel"], SpectrogramGenerator(cfg.specgan).apply(
        {"params": sp}, jnp.asarray(ran["z"])))
    d = float(multires_stft_loss(jnp.asarray(ran["wav"][:1]),
                                 jnp.asarray(ran["wav"][1:2])))
    assert float(ran["d"]) > 0
    _close(ran["d"], d)

    # The walk from the notebook's draws, by JAX's slerp.
    draws = jnp.asarray(ran["draws"])
    walk = [draws[0]]
    for target in draws[1:]:
        walk.append(slerp(walk[-1], target, WALK_STEP))
    z_walk = jnp.stack(walk, axis=1)
    _close(ran["z_walk"], z_walk)
    _close(ran["z_interp"], latent_path(jnp.asarray(ran["a"]),
                                        jnp.asarray(ran["b"]), 6)[0])

    long_fn = jax.jit(generate_long, static_argnums=(0, 4))
    for key, zs in (("long_wav", jnp.asarray(ran["z_seq"])),
                    ("wav_drift", jnp.asarray(ran["z_walk"]))):
        want = long_fn(cfg, sp, vp, zs, 8)
        assert ran[key].shape == want.shape and want.shape[1] > ran[
            "wav"].shape[1], key
        _close(ran[key], want)
    for key in SAVED:
        assert np.isfinite(ran[key]).all(), key


_JAX_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|optax|music_synthesis_tpu)\b"
    r"(?!_torch)", re.M)
_DISPLAY_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:IPython|matplotlib)\b", re.M)


def test_notebook_imports_no_jax_keeps_display_apart_and_has_no_outputs():
    raw = json.loads(NOTEBOOK.read_text())
    code = [c for c in raw["cells"] if c["cell_type"] == "code"]
    assert code
    for cell in code:
        src = "".join(cell["source"])
        assert not _JAX_IMPORT.search(src), src
        if _DISPLAY_IMPORT.search(src):
            assert "display" in cell["metadata"].get("tags", []), src
        assert cell["outputs"] == [] and cell["execution_count"] is None
    tags = [c.metadata.get("tags", []) for c in _cells()]
    assert sum("parameters" in t for t in tags) == 1
    # The pattern itself: it finds what it must.
    assert _JAX_IMPORT.search("import jax.numpy as jnp")
    assert _JAX_IMPORT.search("from music_synthesis_tpu.zoo import x")
    assert not _JAX_IMPORT.search("from music_synthesis_tpu_torch import zoo")
