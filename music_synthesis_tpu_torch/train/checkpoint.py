"""Save and restore a stage-2 training state (counterpart of
``train/checkpoint.py``, which uses orbax).

One ``torch.save`` file holds the step, both players' parameters, both Adam
states, the EMA and the instance-noise generator's state, so a restored
state takes the same next step, bit for bit, as the state that was saved.
"""

from __future__ import annotations

from pathlib import Path

import torch

from music_synthesis_tpu_torch._device import resolve_device
from music_synthesis_tpu_torch.train.state import AdamState, GANState

__all__ = ["save_checkpoint", "restore_checkpoint"]


def _opt(o: AdamState) -> dict:
    return {"count": o.count, "mu": o.mu, "nu": o.nu}


def save_checkpoint(path: str | Path, state: GANState) -> None:
    """Write ``state`` to ``path`` (parent directories are created)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"step": state.step, "g_params": state.g_params,
                "d_params": state.d_params, "g_opt": _opt(state.g_opt),
                "d_opt": _opt(state.d_opt), "g_ema": state.g_ema,
                "rng_device": state.rng.device.type,
                "rng_state": state.rng.get_state()}, path)


def restore_checkpoint(path: str | Path,
                       device: str | torch.device | None = None) -> GANState:
    """The state saved at ``path``, on ``device`` (``cuda`` unless told
    otherwise). The generator's state is tied to its device type, so the
    state must be restored on the device type it was saved from."""
    dev = resolve_device(device)
    ck = torch.load(path, map_location=dev, weights_only=True)
    if ck["rng_device"] != dev.type:
        raise ValueError(f"checkpoint's generator is a {ck['rng_device']} "
                         f"generator; restore it on {ck['rng_device']}")
    rng = torch.Generator(device=dev)
    rng.set_state(ck["rng_state"].cpu())
    return GANState(step=ck["step"], g_params=ck["g_params"],
                    d_params=ck["d_params"], g_opt=AdamState(**ck["g_opt"]),
                    d_opt=AdamState(**ck["d_opt"]), rng=rng,
                    g_ema=ck["g_ema"])
