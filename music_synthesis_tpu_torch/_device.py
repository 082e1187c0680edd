"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (explicitly or by default) and there is
    no card: an entry point never moves to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a CUDA graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def refuse_capture(what: str) -> None:
    """Raises while a CUDA graph is captured. Called where a cache of device
    tensors fills: one filled during a capture would hold memory of the
    graph's pool, which later replays overwrite (``_graphs``' eager warm-up
    fills every such cache before it captures)."""
    if capturing():
        raise RuntimeError(f"{what}: cache of device tensors missed during "
                           "a CUDA graph capture")
