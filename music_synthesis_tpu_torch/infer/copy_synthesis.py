"""Copy-synthesis: wav -> log-mel -> vocoder -> wav, with its distance.

The standard vocoder check: resynthesize audio from its own mel features
and score the result against the input with the multi-resolution STFT
distance. Counterpart of ``train/stage2.py::conditioning_mel`` plus
``scripts/vocode.py``; the conditioning goes through the fused log-mel
kernel (``ops/logmel.py``) on the card, its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from music_synthesis_tpu_torch import zoo
from music_synthesis_tpu_torch._device import resolve_device
from music_synthesis_tpu_torch._graphs import Programs
from music_synthesis_tpu_torch.config import (
    FrontendConfig,
    MelScaler,
    STFTLossConfig,
)
from music_synthesis_tpu_torch.losses.stft_loss import multires_stft_loss
from music_synthesis_tpu_torch.models.vocoder import Vocoder
from music_synthesis_tpu_torch.ops.logmel import fused_log_mel_for_vocoder

__all__ = ["conditioning_mel", "copy_synthesis", "CopySynthesizer"]


def conditioning_mel(wav: torch.Tensor, frontend: FrontendConfig,
                     mel_scaler: MelScaler,
                     precision: str = "fast") -> torch.Tensor:
    """Normalized log-mel ``[B, L // hop, n_mels]``, one frame per hop."""
    mel = fused_log_mel_for_vocoder(wav, frontend, precision)
    return (mel - mel_scaler.shift) / mel_scaler.scale


@torch.inference_mode()
def copy_synthesis(vocoder: Vocoder, wav: torch.Tensor,
                   frontend: FrontendConfig, mel_scaler: MelScaler,
                   stft_loss: STFTLossConfig = STFTLossConfig(),
                   precision: str = "fast") -> tuple[torch.Tensor, torch.Tensor]:
    """``wav [B, L]`` (fp32, on the vocoder's device) -> ``(resynth [B, L'],
    distance)`` with ``L' = L // hop * hop``; the input is trimmed to a hop
    multiple first so the conditioning aligns exactly."""
    hop = frontend.hop_length
    x = wav[:, : wav.shape[-1] // hop * hop].contiguous()
    y = vocoder(conditioning_mel(x, frontend, mel_scaler, precision))
    return y, multires_stft_loss(y, x, stft_loss)


class CopySynthesizer:
    """A zoo vocoder resident on a device, for repeated copy-synthesis.

        cs = CopySynthesizer("vocoder_istft")          # on cuda
        resynth, distance = cs(wav)                    # wav [B, L] numpy/torch

    On a card each call replays the CUDA graph of its (hop-trimmed) input
    shape, captured at the first call of that shape: the log-mel kernel,
    the MelScaler, the vocoder and the STFT distance in one graph (the
    reference jits the same body). On the CPU it runs eagerly.
    """

    def __init__(self, vocoder: str = "vocoder_istft", *,
                 device: str | torch.device | None = None,
                 compute_dtype: str | None = None, precision: str = "fast",
                 zoo_root=None):
        self.device = resolve_device(device)
        entry = zoo.load_pretrained(vocoder, **({"root": zoo_root} if zoo_root else {}))
        if entry.kind != "vocoder":
            raise ValueError(f"zoo entry {vocoder!r} is a {entry.kind}")
        self.frontend = entry.frontend or FrontendConfig()
        self.mel_scaler = entry.mel_scaler or MelScaler()
        self.config = (entry.config if compute_dtype is None else
                       dataclasses.replace(entry.config,
                                           compute_dtype=compute_dtype))
        self.vocoder = entry.model(self.device, compute_dtype)
        self.precision = precision
        self.programs = Programs(self.device)

    def _body(self, x: torch.Tensor):
        return copy_synthesis(self.vocoder, x, self.frontend, self.mel_scaler,
                              precision=self.precision)

    def __call__(self, wav) -> tuple[torch.Tensor, float]:
        x = torch.as_tensor(np.asarray(wav, dtype=np.float32)
                            if not isinstance(wav, torch.Tensor) else wav)
        hop = self.frontend.hop_length
        x = x[:, : x.shape[-1] // hop * hop].to(self.device, torch.float32)
        with torch.inference_mode():
            y, dist = self.programs(self.precision, self._body,
                                    x.contiguous())
            # A copy: the next call's replay overwrites the graph's output.
            return y.clone(), float(dist)
