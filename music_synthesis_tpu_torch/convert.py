"""JAX/Flax parameter trees <-> the port's ``state_dict``.

The port's modules carry the Flax module names and the JAX parameter
layouts (``ops/conv.py``), so a tree converts by flattening its nested
dict with ``.`` separators. The one layout that differs is ``nn.Dense``:
Flax's ``kernel`` ``[in, out]`` becomes ``nn.Linear``'s ``weight``
``[out, in]``. The input is a nested dict of numpy arrays, as
``_msgpack.restore`` or ``jax.tree.map(np.asarray, params)`` gives it;
``from_state_dict`` is the inverse, for writing Flax files.

``train_state_from_jax`` carries a whole training state of either stage
across: parameters, optax's Adam moments and count, the EMA and the step.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["flatten_params", "to_state_dict", "from_state_dict",
           "train_state_from_jax"]


def flatten_params(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> ``{"a.b.c": array}`` in the tree's order."""
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_params(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def to_state_dict(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax params -> ``state_dict`` (fp32 tensors on the CPU, copied)."""
    sd: dict[str, torch.Tensor] = {}
    for key, arr in flatten_params(tree).items():
        t = torch.tensor(np.array(arr, dtype=np.float32))
        head, _, leaf = key.rpartition(".")
        if leaf == "kernel":  # nn.Dense
            sd[f"{head}.weight"] = t.T.contiguous()
        elif leaf in ("bias", "v", "g", "b"):
            sd[key] = t
        else:
            raise ValueError(f"unexpected parameter {key!r}")
    return sd


def from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse of :func:`to_state_dict`: the nested Flax tree of fp32
    numpy arrays, in ``sd``'s order."""
    tree: dict[str, Any] = {}
    for key, t in sd.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        *path, leaf = key.split(".")
        if leaf == "weight":  # nn.Linear -> nn.Dense
            leaf, arr = "kernel", arr.T
        elif leaf not in ("bias", "v", "g", "b"):
            raise ValueError(f"unexpected parameter {key!r}")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def _adam_state(opt_state):
    """The port's AdamState from an optax ``adam`` state (possibly inside a
    ``chain`` with ``clip_by_global_norm`` and a schedule), read by its
    fields: ``ScaleByAdamState`` has ``count``, ``mu`` and ``nu``;
    ``ScaleByScheduleState`` only ``count``."""
    from music_synthesis_tpu_torch.train.state import AdamState

    adam, counts = [], []

    def walk(node):
        fields = getattr(node, "_fields", None)
        if fields is not None and {"mu", "nu"} <= set(fields):
            adam.append(node)
        elif fields == ("count",):
            counts.append(int(np.asarray(node.count)))
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(opt_state)
    if len(adam) != 1:
        raise ValueError(f"expected one Adam state, found {len(adam)}")
    count = int(np.asarray(adam[0].count))
    if any(c != count for c in counts):
        raise ValueError(f"schedule counts {counts} differ from the Adam "
                         f"count {count}; the port keeps one count")
    return AdamState(count=count, mu=to_state_dict(adam[0].mu),
                     nu=to_state_dict(adam[0].nu))


def train_state_from_jax(jax_state, device: str | torch.device | None = None,
                         seed: int | None = None):
    """The JAX package's ``GANState`` (stage 1 or stage 2) -> the port's
    ``GANState``, on ``cuda`` unless ``device`` says otherwise.

    ``jax_state`` is read by attribute (``step``, ``g_params``,
    ``d_params``, ``g_opt``, ``d_opt``, ``g_ema``, ``rng``) with numpy
    leaves, as ``jax.tree.map(np.asarray, state)`` gives it. JAX's threefry
    key cannot be continued by a ``torch.Generator``: the port's generator
    is seeded with ``seed``, by default the key's bits.
    """
    from music_synthesis_tpu_torch._device import resolve_device
    from music_synthesis_tpu_torch.train.state import GANState

    device = resolve_device(device)

    def to(sd):
        return {k: v.to(device) for k, v in sd.items()}

    def adam(opt):
        st = _adam_state(opt)
        st.mu, st.nu = to(st.mu), to(st.nu)
        return st

    if seed is None:
        key = np.asarray(jax_state.rng).astype(np.uint32).ravel()
        seed = int.from_bytes(key.tobytes(), "little") % (1 << 63)
    ema = jax_state.g_ema
    return GANState(
        step=int(np.asarray(jax_state.step)),
        g_params=to(to_state_dict(jax_state.g_params)),
        d_params=to(to_state_dict(jax_state.d_params)),
        g_opt=adam(jax_state.g_opt), d_opt=adam(jax_state.d_opt),
        rng=torch.Generator(device=device).manual_seed(seed),
        g_ema=None if ema is None else to(to_state_dict(ema)))
