"""Save and restore a training state (counterpart of
``train/checkpoint.py``, which uses orbax).

One ``torch.save`` file holds the step, both players' parameters, both Adam
states, the EMA and the latent/noise generator's state, so a restored state
takes the same next step, bit for bit, as the state that was saved. Stage 1
and stage 2 share the format. ``CheckpointManager`` keeps numbered step
checkpoints (``<step>.pt``) under one directory.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from music_synthesis_tpu_torch._device import resolve_device
from music_synthesis_tpu_torch.train.state import AdamState, GANState

__all__ = ["save_checkpoint", "restore_checkpoint", "CheckpointManager"]


def _opt(o: AdamState) -> dict:
    return {"count": o.count, "mu": o.mu, "nu": o.nu}


def save_checkpoint(path: str | Path, state: GANState) -> None:
    """Write ``state`` to ``path`` (parent directories are created). The
    file is written beside ``path`` and renamed onto it, so ``path`` never
    holds a partial checkpoint."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({"step": state.step, "g_params": state.g_params,
                "d_params": state.d_params, "g_opt": _opt(state.g_opt),
                "d_opt": _opt(state.d_opt), "g_ema": state.g_ema,
                "rng_device": state.rng.device.type,
                "rng_state": state.rng.get_state()}, tmp)
    os.replace(tmp, path)


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


class CheckpointManager:
    """Numbered step checkpoints ``<directory>/<step>.pt``; the newest
    ``max_to_keep`` are kept."""

    def __init__(self, directory: str | Path, max_to_keep: int = 5):
        self.directory = Path(directory)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        """Steps on disk, oldest first."""
        if not self.directory.is_dir():
            return []
        return sorted(int(p.stem) for p in self.directory.glob("*.pt")
                      if p.stem.isdigit())

    def latest_step(self) -> int | None:
        """Newest step on disk, or None if the directory holds none."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: GANState) -> None:
        """Write ``state`` as step ``step``, then drop the oldest steps
        beyond ``max_to_keep``."""
        save_checkpoint(self.directory / f"{step}.pt", state)
        for old in self.all_steps()[:-self.max_to_keep]:
            (self.directory / f"{old}.pt").unlink()

    def restore(self, step: int | None = None,
                device: str | torch.device | None = None) -> GANState:
        """The state saved as ``step`` (default: the newest), on ``device``
        (``cuda`` unless told otherwise; the device type it was saved
        from)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return restore_checkpoint(self.directory / f"{step}.pt", device)
