"""Latent-space paths for long-form composition (counterpart of
``infer/latent.py``).

``generate_long`` and ``StreamingSynth`` take any latent sequence
``[B, N, Z]``; these build useful ones:

- ``latent_path(a, b, n)``: spherical interpolation between two draws, so
  every waypoint stays near the radius-sqrt(Z) shell the composer saw;
- ``latent_walk(key, batch, n, Z, step)``: each patch a ``step``-sized
  slerp from the last toward a fresh draw, for audio that drifts.

``latent_walk`` draws with PyTorch's CPU generator (a seed or a
``torch.Generator`` in place of a JAX key), so a seed does not give the JAX
package's walk; ``draws=`` takes the normals to use instead.
"""

from __future__ import annotations

import torch

__all__ = ["slerp", "latent_path", "latent_walk"]


def slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation along the last axis; ``t`` a scalar or a
    broadcastable tensor in [0, 1]. The radius is interpolated linearly."""
    an = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    bn = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    dot = torch.clamp(torch.sum(an * bn, dim=-1, keepdim=True), -1.0, 1.0)
    omega = torch.arccos(dot)
    so = torch.sin(omega)
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)
    # Lerp where the endpoints are (anti)parallel.
    safe = torch.abs(so) > 1e-6
    so_safe = torch.where(safe, so, torch.ones_like(so))
    w_a = torch.where(safe, torch.sin((1.0 - t) * omega) / so_safe, 1.0 - t)
    w_b = torch.where(safe, torch.sin(t * omega) / so_safe, t)
    r_a = torch.linalg.norm(a, dim=-1, keepdim=True)
    r_b = torch.linalg.norm(b, dim=-1, keepdim=True)
    r = (1.0 - t) * r_a + t * r_b
    return (w_a * an + w_b * bn) * r


def latent_path(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """``[B, Z] x [B, Z] -> [B, n, Z]``: n slerp waypoints from a to b,
    both ends included."""
    if n < 2:
        raise ValueError("a path needs at least its two endpoints")
    ts = torch.linspace(0.0, 1.0, n, dtype=a.dtype, device=a.device)[None, :, None]
    return slerp(a[:, None, :], b[:, None, :], ts)


def latent_walk(key: int | torch.Generator, batch: int, n: int,
                latent_dim: int, step: float = 0.35,
                draws: torch.Tensor | None = None) -> torch.Tensor:
    """``[B, n, Z]`` smooth random walk: patch i+1 is a ``step``-sized slerp
    from patch i toward a fresh Gaussian draw (step 1 gives i.i.d. patches).

    ``draws`` (``[n, batch, latent_dim]``: the first patch, then one target
    per later patch) replaces the draws from ``key``.
    """
    if draws is None:
        g = (key if isinstance(key, torch.Generator)
             else torch.Generator().manual_seed(int(key)))
        draws = torch.randn((n, batch, latent_dim), generator=g)
    z = draws[0]
    out = [z]
    for target in draws[1:]:
        z = slerp(z, target, step)
        out.append(z)
    return torch.stack(out, dim=1)
