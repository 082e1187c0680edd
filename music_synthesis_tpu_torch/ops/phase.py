"""Phase-coherence metric (counterpart of ``ops/phase.py``).

For the complex STFT ``S[t, k]``, ``d1`` is the wrapped phase advance from
frame to frame and ``d2`` the wrapped change of that advance. A steady
partial advances by a constant per frame, so ``d2`` is 0 on it; a
phase-incoherent synthesis inflates ``|d2|``. ``phase_jitter`` is the
magnitude-weighted mean of ``|d2|``; ``phase_jitter_ratio`` divides a
resynthesis's jitter by the real clip's (about 1 is phase-healthy). An
eval metric only, magnitude-blind where the STFT distance is phase-blind.
"""

from __future__ import annotations

import torch

from music_synthesis_tpu_torch.ops.frontend import stft

__all__ = ["phase_jitter", "phase_jitter_ratio"]


def _wrap(theta: torch.Tensor) -> torch.Tensor:
    """Angles mapped to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def phase_jitter(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                 eps: float = 1e-8) -> torch.Tensor:
    """Magnitude-weighted mean ``|d2 phase|`` in radians, pooled over every
    leading axis of ``x [..., L]``. Needs at least 3 STFT frames."""
    s = stft(x.float(), n_fft=n_fft, hop_length=hop_length)
    phi = torch.angle(s)
    mag = torch.abs(s)
    d1 = _wrap(phi[..., 1:, :] - phi[..., :-1, :])
    d2 = _wrap(d1[..., 1:, :] - d1[..., :-1, :])
    # Each jitter cell is weighted by the magnitude at its centre frame:
    # quiet cells carry numerically meaningless phase.
    w = mag[..., 1:-1, :]
    return torch.sum(w * torch.abs(d2)) / torch.clamp(torch.sum(w), min=eps)


def phase_jitter_ratio(generated: torch.Tensor, real: torch.Tensor,
                       n_fft: int = 1024,
                       hop_length: int = 256) -> torch.Tensor:
    """jitter(generated) / jitter(real) for time-aligned pairs (about 1 is
    good)."""
    return phase_jitter(generated, n_fft, hop_length) / torch.clamp(
        phase_jitter(real, n_fft, hop_length), min=1e-8)
