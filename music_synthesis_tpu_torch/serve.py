"""Synthesis serving over zoo models (counterpart of ``serve.py``).

``SynthService`` loads a composer and a vocoder from the zoo onto one
device and answers ``synth(seconds, seed, n_clips)`` through
``infer.generate.generate_long`` (``generate_long_refined`` with
``gl_refine``). As in the reference:

- requests map onto a small grid of (batch, patch) buckets, padded up and
  trimmed on the host, so the device sees a fixed set of shapes;
  ``warm_all`` runs every bucket once, and the two streaming calls;
- device work is serialized: it runs on the service's one worker thread,
  where the reference takes a lock. PyTorch keeps cuDNN's execution plans
  per thread, so work run on each HTTP request's own fresh thread would
  build them again on every request. With ``coalesce_window_ms``
  concurrent requests of one patch bucket merge into one device call
  (clips are batch-independent, so merged audio equals solo audio);
- ``stream_blocks`` streams unbounded durations through
  ``infer/stream.py``'s two fixed-shape calls;
- on a card every bucket program and both stream calls replay CUDA graphs
  (the reference compiles one program per bucket): ``warm_all`` captures
  them on the worker thread, which alone replays them, into one memory
  pool per device (``programs``, ``_graphs.Programs``); ``/reload``'s new
  service captures its own. On the CPU they run eagerly.

``make_server`` puts the stdlib ``http.server`` in front: ``GET /healthz``,
``/models``, ``/metrics``; ``POST /generate`` -> ``audio/wav``, ``POST
/stream`` -> a known-length WAV written block by block, and ``POST
/reload`` -> a blue/green swap onto other zoo entries.

    svc = SynthService(ServeConfig(composer="specgan_flux",
                                   vocoder="vocoder_istft"))   # on cuda
    httpd = make_server(svc, port=8000)
    httpd.serve_forever()

Latents come from a ``torch.Generator`` seeded per request on the CPU, so a
seed gives the same audio on any device but not the JAX server's audio
(threefry and PyTorch's generator differ).

Serving over several devices (``mesh_devices = N > 1``), as the reference
shards each bucket's batch over a mesh: every batch bucket must divide by
N; composer and vocoder are replicated once at load on ``cuda:0`` ..
``cuda:N-1`` (raising with the reason when fewer cards are visible; a
caller may name the devices, and may repeat one), or N times on the CPU;
each bucket's batch is split into N shards, each run on its device from
the worker thread, and the audio is gathered on the first device. Streams
run on the first device.
"""

from __future__ import annotations

import dataclasses
import io
import json
import queue
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from music_synthesis_tpu_torch import zoo
from music_synthesis_tpu_torch._device import resolve_device
from music_synthesis_tpu_torch._graphs import Programs
from music_synthesis_tpu_torch.config import E2E_INFERENCE, PipelineConfig
from music_synthesis_tpu_torch.infer.generate import (
    GraphedPipeline,
    generate_long,
    generate_long_refined,
)
from music_synthesis_tpu_torch.infer.stream import (
    StreamingSynth,
    make_stream_fns,
)
from music_synthesis_tpu_torch.parallel.mesh import device_list
from music_synthesis_tpu_torch.utils.wav import write_wav

__all__ = ["ServeConfig", "SynthService", "latent_rows", "make_server",
           "wav_bytes", "wav_header", "pcm16"]


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
    """Model selection, the bucket grid and the deployment's knobs."""

    composer: str = "specgan_flux"      # zoo entry name or dir (specgan)
    vocoder: str = "vocoder_istft"      # zoo entry name or dir (vocoder)
    zoo_root: str | None = None         # default: the repository's zoo/
    batch_buckets: tuple[int, ...] = (1, 4)
    patch_buckets: tuple[int, ...] = (1, 2, 4, 8)
    crossfade_frames: int = 8
    # Output loudness calibration (RMS per clip); 0 disables.
    target_rms: float = 0.1
    max_clips_per_request: int = 16
    # Devices to shard each bucket's batch over; every batch bucket must
    # divide by it.
    mesh_devices: int = 1
    # Activation dtype of both generators ("float32" | "bfloat16").
    compute_dtype: str = "float32"
    # Hold each device call open this long and merge the requests of one
    # patch bucket that arrive meanwhile; 0 dispatches each at once.
    coalesce_window_ms: float = 0.0
    # Ceiling of one POST /stream request.
    max_stream_seconds: float = 600.0
    # Warm-started Griffin-Lim iterations on every /generate clip (never on
    # /stream, whose blocks are made incrementally); 0 is off.
    gl_refine: int = 0


def _load_entry(name: str, kind: str, root) -> zoo.PretrainedEntry:
    e = zoo.load_pretrained(name, **({"root": root} if root else {}))
    if e.kind != kind:
        raise ValueError(f"zoo entry {name!r} is a {e.kind}, need {kind}")
    return e


class SynthService:
    """Loads zoo models onto ``device`` (or the ``mesh_devices`` devices,
    ``devices`` if given) and serves synthesis calls."""

    def __init__(self, serve_cfg: ServeConfig = ServeConfig(),
                 base_cfg: PipelineConfig = E2E_INFERENCE, *,
                 device: str | torch.device | None = None,
                 devices=None, warmup: bool = True):
        n_dev = serve_cfg.mesh_devices
        if n_dev > 1:
            bad = [b for b in serve_cfg.batch_buckets if b % n_dev]
            if bad:
                raise ValueError(f"batch buckets {bad} do not divide over "
                                 f"{n_dev} mesh devices")
        self.devices = (device_list(n_dev, devices=devices)
                        if devices is not None
                        else device_list(n_dev, resolve_device(device)))
        self.device = self.devices[0]
        self.serve_cfg = serve_cfg
        self.base_cfg = base_cfg  # kept for POST /reload
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
        self._cards = {"composer": composer.card, "vocoder": vocoder.card}
        # One replica of each model per device (the first serves streams),
        # and the graphed programs of each, in one pool per device.
        self._replicas = [(composer.model(d, serve_cfg.compute_dtype),
                           vocoder.model(d, serve_cfg.compute_dtype))
                          for d in self.devices]
        self.composer, self.vocoder = self._replicas[0]
        self.programs = {d: Programs(d) for d in self.devices}
        self._pipelines = [GraphedPipeline(cfg, c, v, self.programs[d])
                           for (c, v), d in zip(self._replicas, self.devices)]
        self._stream_fns = make_stream_fns(cfg, self.programs[self.device])
        self._worker = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="msynth-device")
        self._m_lock = threading.Lock()
        self._requests = 0
        self._errors = 0
        self._device_calls = 0
        self._latencies: list[float] = []  # seconds, last 512 kept
        self._warm: list[tuple] = []
        self._coalescer = (
            _Coalescer(self, serve_cfg.coalesce_window_ms / 1e3)
            if serve_cfg.coalesce_window_ms > 0 else None)
        if warmup:
            self.warm_all()

    def close(self) -> None:
        """Stop the coalescer's and the worker's threads (requests already
        queued are answered first); later requests raise."""
        if self._coalescer is not None:
            self._coalescer.close()
        self._worker.shutdown()

    def _on_device(self, fn, *args):
        """``fn(*args)`` on the worker thread, which runs all device work."""
        return self._worker.submit(fn, *args).result()

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

    def _run(self, z: torch.Tensor) -> np.ndarray:
        """The bucket program on latents ``z`` (on the worker thread):
        float32 audio on the host."""
        return self._on_device(self._generate, z)

    @torch.inference_mode()
    def _generate(self, z: torch.Tensor) -> np.ndarray:
        """The batch split evenly over the devices, each shard run on its
        replica (on a card, the replay of its bucket's graph), the audio
        gathered on the first device."""
        sc = self.serve_cfg
        outs = []
        for pipe, dev, zs in zip(self._pipelines, self.devices,
                                 z.chunk(len(self.devices))):
            zs = zs.to(dev)
            if sc.gl_refine > 0:
                wav = pipe(generate_long_refined, zs, sc.crossfade_frames,
                           sc.gl_refine)
            else:
                wav = pipe(generate_long, zs, sc.crossfade_frames)
            # A copy: the next replay of the device's pool overwrites wav.
            outs.append(wav.float().to(self.device, copy=True))
        return torch.cat(outs).cpu().numpy()

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
            outs.append(out[:r])
        return np.concatenate(outs, axis=0)

    def warm_all(self) -> list[tuple]:
        """Run every configured (batch, patches) bucket once, and the two
        streaming calls: on a card this captures their graphs."""
        for b in self.serve_cfg.batch_buckets:
            for n in self.serve_cfg.patch_buckets:
                self._run(torch.zeros((b, n, self.cfg.specgan.latent_dim)))
                self._warm.append((b, n))
        for _ in self.stream_blocks(seconds=1e-6, seed=0):
            pass
        self._warm.append(("stream", 1))
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
        rows = self._z_rows(seed, n_clips, n)
        if self._coalescer is not None:
            wav = self._coalescer.submit(n, rows)[:, :want]
        else:
            wav = self._execute(n, rows)[:, :want]
        rms_target = sc.target_rms if target_rms is None else target_rms
        if rms_target > 0:
            rms = np.sqrt(np.mean(np.square(wav), axis=-1, keepdims=True))
            wav = np.clip(wav * (rms_target / np.maximum(rms, 1e-8)),
                          -1.0, 1.0)
        dt = time.perf_counter() - t0

        self._record(dt)
        meta = {
            "seed": seed,
            "patches": n,
            "batch_bucket": b,
            "n_clips": n_clips,
            "samples": int(want),
            "sample_rate": self.cfg.frontend.sample_rate,
            "gen_ms": round(dt * 1e3, 3),
            "rtf": round((want * n_clips / self.cfg.frontend.sample_rate)
                         / max(dt, 1e-9), 1),
        }
        return wav.astype(np.float32), meta

    def _record(self, seconds: float) -> None:
        """Count one answered request and its latency."""
        with self._m_lock:
            self._requests += 1
            self._latencies = (self._latencies + [seconds])[-512:]

    # -- streaming -----------------------------------------------------------

    def stream_samples(self, seconds: float) -> tuple[int, int]:
        """(exact samples, patch count) a /stream request will produce."""
        sc = self.serve_cfg
        if not (0 < seconds <= sc.max_stream_seconds):
            raise ValueError(
                f"seconds must be in (0, {sc.max_stream_seconds}]")
        c = self.cfg
        t, cf = c.specgan.n_frames, sc.crossfade_frames
        want = max(1, int(round(seconds * c.frontend.sample_rate)))
        n = 1
        while True:
            t_long = n * (t - cf) + cf
            usable = t_long - (t_long - c.infer.chunk_frames) % c.infer.hop_frames
            if usable * c.vocoder.hop_length >= want or n > 1_000_000:
                return want, n
            n += 1

    def stream_blocks(self, seconds: float, seed: int = 0):
        """Yield float32 ``[samples]`` blocks as they become final, exactly
        ``stream_samples(seconds)[0]`` in all, at the model's raw level.
        The latents are ``latent_rows(seed, 1, n, Z)`` for the stream's
        patch count n: the stream is ``_execute(n, those rows)``'s raw
        audio, and its patches start with the latents of the same seed's
        one-clip ``/generate``."""
        want, n = self.stream_samples(seconds)
        s = StreamingSynth(self.cfg, self.composer, self.vocoder,
                           self.serve_cfg.crossfade_frames, self._stream_fns)
        z = self._z_rows(seed, 1, n)
        sent = 0
        for i in range(n):
            blk = self._on_device(s.feed, z[:, i])
            blk = blk[0, : max(0, want - sent)]
            sent += blk.shape[0]
            if blk.shape[0]:
                yield blk
            if sent >= want:
                return
        tail = self._on_device(s.finish)
        tail = tail[0, : max(0, want - sent)]
        if tail.shape[0]:
            yield tail

    # -- introspection -----------------------------------------------------

    def health(self) -> dict:
        """GET /healthz payload: device, warm buckets, loaded entries."""
        dev = self.device
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else dev.type)
        return {
            "status": "ok",
            "device": f"{dev.type}/{kind}",
            "mesh_devices": self.serve_cfg.mesh_devices,
            "warm_buckets": self._warm,
            "composer": self.composer_name,
            "vocoder": self.vocoder_name,
        }

    def models(self) -> dict:
        """GET /models payload: the loaded zoo entries' cards."""
        return dict(self._cards)

    def metrics(self) -> dict:
        """GET /metrics payload: request, error and device-call counts,
        latency p50/p95 in ms."""
        with self._m_lock:
            lat = sorted(self._latencies)
            n = len(lat)
            return {
                "requests": self._requests,
                "errors": self._errors,
                "device_calls": self._device_calls,
                "latency_p50_ms": round(lat[n // 2] * 1e3, 3) if n else None,
                "latency_p95_ms": (
                    round(lat[min(n - 1, int(n * 0.95))] * 1e3, 3)
                    if n else None),
            }

    def count_error(self) -> None:
        """Count one request answered with an error."""
        with self._m_lock:
            self._errors += 1


class _Coalescer:
    """Merges concurrent requests of one patch bucket into one device call.

    A worker thread drains a queue: the first waiting request opens a
    window, and everything that arrives within it joins the flush. Each
    flush groups requests by patch bucket, concatenates their latent rows,
    runs each group through ``_execute`` and hands each request its rows.
    """

    def __init__(self, svc: SynthService, window_s: float):
        self._svc = svc
        self._window = window_s
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="msynth-coalescer")
        self._thread.start()

    def submit(self, n: int, rows: torch.Tensor) -> np.ndarray:
        item = {"n": n, "rows": rows, "done": threading.Event(),
                "out": None, "exc": None}
        with self._lock:
            if self._closed:
                raise RuntimeError("the service is closed")
            self._q.put(item)
        item["done"].wait()
        if item["exc"] is not None:
            raise item["exc"]
        return item["out"]

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._thread.join()

    def _loop(self) -> None:
        while True:
            first = self._q.get()
            if first is None:
                return
            batch, stop = [first], False
            deadline = time.monotonic() + self._window
            while not stop:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                else:
                    batch.append(item)
            self._flush(batch)
            if stop:
                return

    def _flush(self, batch: list[dict]) -> None:
        groups: dict[int, list[dict]] = {}
        for it in batch:
            groups.setdefault(it["n"], []).append(it)
        for n, items in groups.items():
            try:
                out = self._svc._execute(
                    n, torch.cat([it["rows"] for it in items]))
                off = 0
                for it in items:
                    r = it["rows"].shape[0]
                    it["out"] = out[off:off + r]
                    off += r
            except Exception as e:  # every waiter gets the failure
                for it in items:
                    it["exc"] = e
            finally:
                for it in items:
                    it["done"].set()


def wav_bytes(sample_rate: int, wav: np.ndarray) -> bytes:
    """Multi-clip [N, L] -> one 16-bit PCM WAV payload (clips concatenated)."""
    buf = io.BytesIO()
    write_wav(buf, sample_rate, np.concatenate(list(wav), axis=-1))
    return buf.getvalue()


def wav_header(sample_rate: int, n_samples: int) -> bytes:
    """44-byte PCM16 mono WAV header for a known-length progressive body."""
    data = n_samples * 2
    return b"".join([
        b"RIFF", struct.pack("<I", 36 + data), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                             sample_rate * 2, 2, 16),
        b"data", struct.pack("<I", data),
    ])


def pcm16(block: np.ndarray) -> bytes:
    """Float [-1, 1] -> little-endian 16-bit PCM bytes (clipped)."""
    return (np.clip(block, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


_BAD_REQUEST = (ValueError, KeyError, TypeError, json.JSONDecodeError)


class _Handler(BaseHTTPRequestHandler):
    # make_server attaches the service to the server object.

    def _svc(self) -> SynthService:
        return self.server.service  # type: ignore[attr-defined]

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def _send_json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def do_GET(self):  # noqa: N802 (http.server API)
        svc = self._svc()
        routes = {"/healthz": svc.health, "/models": svc.models,
                  "/metrics": svc.metrics}
        fn = routes.get(self.path)
        if fn is None:
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        self._send_json(200, fn())

    def do_POST(self):  # noqa: N802
        svc = self._svc()
        if self.path == "/stream":
            self._do_stream(svc)
            return
        if self.path == "/reload":
            self._do_reload(svc)
            return
        if self.path != "/generate":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        try:
            req = self._body()
            wav, meta = svc.synth(
                seconds=float(req.get("seconds", 4.0)),
                seed=int(req.get("seed", 0)),
                n_clips=int(req.get("n_clips", 1)),
                target_rms=(float(req["target_rms"])
                            if "target_rms" in req else None),
            )
        except _BAD_REQUEST as e:
            svc.count_error()
            self._send_json(400, {"error": str(e)})
            return
        body = wav_bytes(meta["sample_rate"], wav)
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Msynth-Meta", json.dumps(meta))
        self.end_headers()
        self.wfile.write(body)

    def _do_reload(self, old: SynthService) -> None:
        """Blue/green swap: build and warm a new service for the requested
        zoo entries, then point the server at it. Requests in flight finish
        on the old service; any failure leaves the old one serving."""
        try:
            req = self._body()
            sc = dataclasses.replace(
                old.serve_cfg,
                composer=req.get("composer", old.serve_cfg.composer),
                vocoder=req.get("vocoder", old.serve_cfg.vocoder),
            )
            new = SynthService(sc, base_cfg=old.base_cfg, device=old.device,
                               devices=old.devices, warmup=True)
        except Exception as e:  # keep serving the old models on any failure
            old.count_error()
            self._send_json(400, {"error": str(e)})
            return
        self.server.service = new  # type: ignore[attr-defined]
        self._send_json(200, new.health())

    def _do_stream(self, svc: SynthService) -> None:
        """A known-length WAV whose PCM body is written block by block as
        audio becomes final (raw model level: loudness calibration needs
        the whole clip)."""
        try:
            req = self._body()
            seconds = float(req.get("seconds", 8.0))
            seed = int(req.get("seed", 0))
            want, n = svc.stream_samples(seconds)
        except _BAD_REQUEST as e:
            svc.count_error()
            self._send_json(400, {"error": str(e)})
            return
        sr = svc.cfg.frontend.sample_rate
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(44 + 2 * want))
        self.send_header("X-Msynth-Meta", json.dumps(
            {"seed": seed, "patches": n, "samples": want,
             "sample_rate": sr, "streamed": True}))
        self.end_headers()
        self.wfile.write(wav_header(sr, want))
        self.wfile.flush()
        t0 = time.perf_counter()
        for block in svc.stream_blocks(seconds=seconds, seed=seed):
            self.wfile.write(pcm16(block))
            self.wfile.flush()
        svc._record(time.perf_counter() - t0)


def make_server(service: SynthService, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """HTTP front for a SynthService: a thread per request; device work runs
    on the service's worker thread."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.service = service  # type: ignore[attr-defined]
    return httpd
