"""Inputs the benchmark makes from the seed: training weights on the
device, the pool of training batches on the host, latents."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["seeded_params", "tone_pool"]


def seeded_params(shapes: dict, gen: torch.Generator, device,
                  gains: dict | None = None) -> dict[str, torch.Tensor]:
    """fp32 parameters for ``{name: shape}``, in one draw on ``device``:
    each weight-norm direction ``.v`` ``[*K, Cin/groups, Cout]`` and each
    dense ``.weight`` ``[out, in]`` normal with He's std (fan-in: every
    axis but Cout, or ``in``) times its gain in ``gains`` (1 where it has
    none), each gain ``.g`` the norm of its ``v`` (so the kernel starts
    equal to ``v``), each bias zero."""
    gains = gains or {}
    drawn = [k for k in shapes if k.endswith((".v", ".weight"))]
    total = sum(math.prod(shapes[k]) for k in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for k in drawn:
        shape = tuple(shapes[k])
        n = math.prod(shape)
        fan_in = shape[1] if k.endswith(".weight") else math.prod(shape[:-1])
        out[k] = flat[off:off + n].view(shape) * (gains.get(k, 1.0)
                                                  * math.sqrt(2.0 / fan_in))
        off += n
    for k, shape in shapes.items():
        if k.endswith(".g"):
            v = out[k[:-2] + ".v"]
            out[k] = torch.sqrt(torch.sum(v * v, dim=tuple(range(v.ndim - 1)))
                                + 1e-12)
        elif k not in out:
            out[k] = torch.zeros(tuple(shape), device=device)
    return {k: out[k].contiguous() for k in shapes}


def tone_pool(rng: np.random.Generator, rows: int, length: int, sr: int,
              p: dict) -> np.ndarray:
    """``[rows, length]`` float32 audio, every row different: a harmonic
    tone (f0 log-uniform over ``p["f0_hz"]``, up to ``p["harmonics"]``
    partials below Nyquist with amplitudes ``k ** -rolloff``), under an
    attack-decay envelope starting at a random onset, plus white noise, at
    a peak level drawn from ``p["level"]``."""
    t = np.arange(length, dtype=np.float64) / sr
    lo, hi = np.log(p["f0_hz"][0]), np.log(p["f0_hz"][1])
    f0 = np.exp(rng.uniform(lo, hi, rows))
    rolloff = rng.uniform(*p["rolloff"], rows)
    wav = np.zeros((rows, length))
    for k in range(1, p["harmonics"] + 1):
        amp = k ** -rolloff * (k * f0 < sr / 2)
        phase = rng.uniform(0, 2 * np.pi, rows)
        wav += amp[:, None] * np.sin(2 * np.pi * k * f0[:, None] * t
                                     + phase[:, None])
    onset = rng.uniform(0, 0.5, rows)[:, None] * t[-1]
    decay = np.exp(rng.uniform(*np.log(p["decay_s"]), rows))[:, None]
    since = np.clip(t[None, :] - onset, 0, None)
    env = (1 - np.exp(-since / p["attack_s"])) * np.exp(-since / decay)
    wav = wav * env / np.maximum(np.abs(wav * env).max(-1, keepdims=True),
                                 1e-9)
    wav += rng.uniform(*p["noise"], rows)[:, None] * rng.standard_normal(
        (rows, length))
    level = rng.uniform(*p["level"], rows)[:, None]
    wav = level * wav / np.abs(wav).max(-1, keepdims=True)
    return wav.astype(np.float32)
