"""Online GAN-collapse detection (counterpart of ``train/guard.py``).

The signature, read off the committed collapsed and healthy run histories
(``runs/stage2_istft_50k``, ``runs/stage2_istft_warm_50k`` against
``runs/stage2_50k_fast``):

    collapsed:  d_loss -> 0 (hinge D fully separates real from fake)
                while g_adv explodes (>40 and rising) and g_stft climbs
                away from its early minimum
    healthy:    d_loss stays in a contested band (~0.7-4),
                g_adv ~7-13, g_stft declines toward ~1.9-2.3

``CollapseGuard`` watches the logged metrics for that joint signature over
a trailing window of log entries (medians, so single-step spikes do not
trigger) and returns a reason string the training scripts act on: stop
early, stamp STATUS, keep the checkpoints. It reads the host-side metric
dict the training loop logs; it makes the same decisions as the JAX
package's guard.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from statistics import median

__all__ = ["GuardConfig", "CollapseGuard"]


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Thresholds for the collapse signature (see module docstring)."""

    window: int = 5          # trailing log entries per decision (medians)
    min_step: int = 3000     # ignore startup transients + G-warmup ramp
    d_floor: float = 0.05    # trailing median d_loss below this = D has won
    g_adv_ceiling: float = 30.0   # ...while G's adversarial loss explodes
    # Secondary signature: reconstruction quality diverging — trailing
    # median g_stft above blowup x its best trailing median.
    stft_blowup: float = 1.75


class CollapseGuard:
    """Feed per-log metric dicts; returns a reason string on collapse."""

    def __init__(self, cfg: GuardConfig = GuardConfig()):
        self.cfg = cfg
        self._d = deque(maxlen=cfg.window)
        self._adv = deque(maxlen=cfg.window)
        self._stft = deque(maxlen=cfg.window)
        self._best_stft: float | None = None

    def update(self, step: int, metrics: dict) -> str | None:
        """One logged entry. Returns a collapse reason, or None."""
        c = self.cfg
        self._d.append(float(metrics["d_loss"]))
        self._adv.append(float(metrics["g_adv"]))
        # g_stft is stage-2 only; stage 1 runs on the primary signature.
        if "g_stft" in metrics:
            self._stft.append(float(metrics["g_stft"]))
        if len(self._d) < c.window:
            return None
        stft_med = median(self._stft) if len(self._stft) == c.window else None
        # Track the best (lowest) trailing reconstruction the run reached;
        # windows BEFORE min_step seed it too — a run that collapses from
        # its very best early state must still compare against it.
        if stft_med is not None and (
                self._best_stft is None or stft_med < self._best_stft):
            self._best_stft = stft_med
        if step < c.min_step:
            return None
        d_med, adv_med = median(self._d), median(self._adv)
        if d_med < c.d_floor and adv_med > c.g_adv_ceiling:
            return (
                f"D/G separation collapse at step {step}: trailing-median "
                f"d_loss {d_med:.4f} < {c.d_floor} while g_adv "
                f"{adv_med:.2f} > {c.g_adv_ceiling}"
            )
        if (
            stft_med is not None
            and self._best_stft is not None
            and stft_med > c.stft_blowup * self._best_stft
            and d_med < c.d_floor
        ):
            return (
                f"reconstruction divergence at step {step}: trailing-median "
                f"g_stft {stft_med:.3f} > {c.stft_blowup}x best "
                f"({self._best_stft:.3f}) with d_loss {d_med:.4f} floored"
            )
        return None
