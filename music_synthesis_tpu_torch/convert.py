"""JAX/Flax parameter trees -> the port's ``state_dict``.

The port's modules carry the Flax module names and the JAX parameter
layouts (``ops/conv.py``), so a tree converts by flattening its nested
dict with ``.`` separators. The one layout that differs is ``nn.Dense``:
Flax's ``kernel`` ``[in, out]`` becomes ``nn.Linear``'s ``weight``
``[out, in]``. The input is a nested dict of numpy arrays, as
``_msgpack.restore`` or ``jax.tree.map(np.asarray, params)`` gives it.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["flatten_params", "to_state_dict"]


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
