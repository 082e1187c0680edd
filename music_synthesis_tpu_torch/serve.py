"""In-process synthesis service over zoo models (counterpart of ``serve.py``).

``SynthService`` loads a composer and a vocoder from the zoo onto one
device and answers ``synth(seconds, seed, n_clips)`` calls through
``infer.generate.generate_long``. As in the reference, requests map onto a
small grid of (batch, patch) buckets, padded up and trimmed on the host, so
the device sees a fixed set of shapes; ``warm_all`` runs every bucket once.

Latents come from a ``torch.Generator`` seeded per request on the CPU, so a
seed gives the same audio on any device but not the JAX server's audio
(threefry and PyTorch's generator differ). The HTTP layer, request
coalescing, streaming, hot reload, the device mesh and Griffin-Lim
refinement come with later slices of the port.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from music_synthesis_tpu_torch import zoo
from music_synthesis_tpu_torch._device import resolve_device
from music_synthesis_tpu_torch.config import E2E_INFERENCE, PipelineConfig
from music_synthesis_tpu_torch.infer.generate import generate_long

__all__ = ["ServeConfig", "SynthService", "latent_rows"]


def latent_rows(seed: int, n_clips: int, n: int, latent_dim: int) -> torch.Tensor:
    """Latent rows ``[n_clips, n, latent_dim]`` (CPU, fp32) for a seed.

    The rows of ``n_clips = c`` are the first ``c`` of any larger draw with
    the same seed, as the reference's ``_z_rows`` documents. PyTorch's CPU
    normal sampler transforms its uniforms in blocks of 16, so a draw whose
    size is a multiple of 16 is a prefix of every longer one: this draws
    ``round_up(n_clips * n * latent_dim, 16)`` normals, then cuts and
    reshapes them. Where the count is already a multiple of 16 (every
    committed card: ``latent_dim`` 128) the rows equal
    ``torch.randn((n_clips, n, latent_dim))`` bit for bit.
    """
    count = n_clips * n * latent_dim
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn(-(-count // 16) * 16, generator=g)
    return flat[:count].reshape(n_clips, n, latent_dim)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Model selection and the bucket grid."""

    composer: str = "specgan_flux"      # zoo entry name or dir (specgan)
    vocoder: str = "vocoder_istft"      # zoo entry name or dir (vocoder)
    zoo_root: str | None = None         # default: the repository's zoo/
    batch_buckets: tuple[int, ...] = (1, 4)
    patch_buckets: tuple[int, ...] = (1, 2, 4, 8)
    crossfade_frames: int = 8
    # Output loudness calibration (RMS per clip); 0 disables.
    target_rms: float = 0.1
    max_clips_per_request: int = 16
    # Activation dtype of both generators ("float32" | "bfloat16").
    compute_dtype: str = "float32"


def _load_entry(name: str, kind: str, root) -> zoo.PretrainedEntry:
    e = zoo.load_pretrained(name, **({"root": root} if root else {}))
    if e.kind != kind:
        raise ValueError(f"zoo entry {name!r} is a {e.kind}, need {kind}")
    return e


class SynthService:
    """Loads zoo models onto ``device`` and serves synthesis calls."""

    def __init__(self, serve_cfg: ServeConfig = ServeConfig(),
                 base_cfg: PipelineConfig = E2E_INFERENCE, *,
                 device: str | torch.device | None = None,
                 warmup: bool = True):
        self.device = resolve_device(device)
        self.serve_cfg = serve_cfg
        root = serve_cfg.zoo_root
        composer = _load_entry(serve_cfg.composer, "specgan", root)
        vocoder = _load_entry(serve_cfg.vocoder, "vocoder", root)
        cfg = dataclasses.replace(
            base_cfg,
            specgan=dataclasses.replace(composer.config,
                                        compute_dtype=serve_cfg.compute_dtype),
            vocoder=dataclasses.replace(vocoder.config,
                                        compute_dtype=serve_cfg.compute_dtype),
        )
        # The vocoder card's scaler and front-end win, as in the reference.
        for e in (composer, vocoder):
            if e.mel_scaler is not None:
                cfg = dataclasses.replace(cfg, mel_scaler=e.mel_scaler)
            if e.frontend is not None:
                cfg = dataclasses.replace(cfg, frontend=e.frontend)
        if serve_cfg.crossfade_frames >= cfg.specgan.n_frames:
            raise ValueError(
                f"crossfade_frames ({serve_cfg.crossfade_frames}) must be < "
                f"specgan.n_frames ({cfg.specgan.n_frames})")
        self.cfg = cfg
        self.composer_name, self.vocoder_name = composer.name, vocoder.name
        self.composer = composer.model(self.device, serve_cfg.compute_dtype)
        self.vocoder = vocoder.model(self.device, serve_cfg.compute_dtype)
        self._dispatch = threading.Lock()
        self._m_lock = threading.Lock()
        self._requests = 0
        self._device_calls = 0
        self._latencies: list[float] = []  # seconds, last 512 kept
        self._warm: list[tuple[int, int]] = []
        if warmup:
            self.warm_all()

    # -- shape bucketing ---------------------------------------------------

    def out_samples(self, n_patches: int) -> int:
        """Exact output length of the (.., n_patches) program in samples."""
        c = self.cfg
        t = c.specgan.n_frames
        cf = self.serve_cfg.crossfade_frames
        t_long = n_patches * (t - cf) + cf
        usable = t_long - (t_long - c.infer.chunk_frames) % c.infer.hop_frames
        return usable * c.vocoder.hop_length

    def patches_for_seconds(self, seconds: float) -> int:
        """Smallest patch bucket whose output covers ``seconds`` (clamped
        to the largest bucket)."""
        want = int(round(seconds * self.cfg.frontend.sample_rate))
        for n in sorted(self.serve_cfg.patch_buckets):
            if self.out_samples(n) >= want:
                return n
        return max(self.serve_cfg.patch_buckets)

    def batch_bucket(self, n_clips: int) -> int:
        """Smallest batch bucket that fits ``n_clips``."""
        for b in sorted(self.serve_cfg.batch_buckets):
            if b >= n_clips:
                return b
        return max(self.serve_cfg.batch_buckets)

    # -- synthesis ---------------------------------------------------------

    @torch.inference_mode()
    def _run(self, z: torch.Tensor) -> torch.Tensor:
        with self._dispatch:
            wav = generate_long(self.cfg, self.composer, self.vocoder,
                                z.to(self.device),
                                self.serve_cfg.crossfade_frames)
            if wav.is_cuda:
                torch.cuda.synchronize(wav.device)
        return wav

    def _z_rows(self, seed: int, n_clips: int, n: int) -> torch.Tensor:
        """Per-request latent rows ``[n_clips, n, Z]`` (CPU, fp32)."""
        return latent_rows(seed, n_clips, n, self.cfg.specgan.latent_dim)

    def _execute(self, n: int, rows: torch.Tensor) -> np.ndarray:
        """Run ``[R, n, Z]`` rows in largest-bucket chunks, each padded with
        zero latents up to its bucket; returns exactly R clips."""
        max_b = max(self.serve_cfg.batch_buckets)
        outs = []
        for i in range(0, rows.shape[0], max_b):
            chunk = rows[i:i + max_b]
            r = chunk.shape[0]
            b = self.batch_bucket(r)
            if b > r:
                chunk = torch.cat([chunk, chunk.new_zeros((b - r,) + chunk.shape[1:])])
            out = self._run(chunk)
            with self._m_lock:
                self._device_calls += 1
            outs.append(out[:r].float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    def warm_all(self) -> list[tuple[int, int]]:
        """Run every configured (batch, patches) bucket once."""
        for b in self.serve_cfg.batch_buckets:
            for n in self.serve_cfg.patch_buckets:
                self._run(torch.zeros((b, n, self.cfg.specgan.latent_dim)))
                self._warm.append((b, n))
        return list(self._warm)

    def synth(self, seconds: float, seed: int = 0, n_clips: int = 1,
              target_rms: float | None = None) -> tuple[np.ndarray, dict]:
        """``n_clips`` clips of ``seconds`` audio: ``(wav [n_clips, samples]
        float32, meta)``. Padding clips and excess samples are trimmed."""
        sc = self.serve_cfg
        if not (0 < n_clips <= sc.max_clips_per_request):
            raise ValueError(
                f"n_clips must be in [1, {sc.max_clips_per_request}]")
        if seconds <= 0:
            raise ValueError("seconds must be > 0")
        n = self.patches_for_seconds(seconds)
        b = self.batch_bucket(n_clips)
        want = min(int(round(seconds * self.cfg.frontend.sample_rate)),
                   self.out_samples(n))

        t0 = time.perf_counter()
        wav = self._execute(n, self._z_rows(seed, n_clips, n))[:, :want]
        rms_target = sc.target_rms if target_rms is None else target_rms
        if rms_target > 0:
            rms = np.sqrt(np.mean(np.square(wav), axis=-1, keepdims=True))
            wav = np.clip(wav * (rms_target / np.maximum(rms, 1e-8)),
                          -1.0, 1.0)
        dt = time.perf_counter() - t0

        with self._m_lock:
            self._requests += 1
            self._latencies = (self._latencies + [dt])[-512:]
        meta = {
            "seed": seed,
            "patches": n,
            "batch_bucket": b,
            "n_clips": n_clips,
            "samples": int(want),
            "sample_rate": self.cfg.frontend.sample_rate,
            "gen_ms": dt * 1e3,
            "rtf": (want * n_clips / self.cfg.frontend.sample_rate)
                   / max(dt, 1e-9),
        }
        return wav.astype(np.float32), meta

    # -- introspection -----------------------------------------------------

    def metrics(self) -> dict:
        """Request and device-call counts, latency p50/p95."""
        with self._m_lock:
            lat = sorted(self._latencies)
            n = len(lat)
            return {
                "requests": self._requests,
                "device_calls": self._device_calls,
                "latency_p50_ms": lat[n // 2] * 1e3 if n else None,
                "latency_p95_ms": (lat[min(n - 1, int(n * 0.95))] * 1e3
                                   if n else None),
            }
