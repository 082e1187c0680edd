"""The port's serving layer (``serve.py``) on the CPU: latent rows, the HTTP
routes, request coalescing, streaming, hot reload, Griffin-Lim refinement,
and the introspection payloads against the JAX package's.

A request's latent rows must be a prefix of any larger draw with the same
seed (the reference's ``serve.py::_z_rows`` documents it, and request
coalescing relies on it), at every latent width, and the committed cards'
width (128) must keep the draw it always had, so that their audio does not
change.

The services serve the TINY composer and iSTFT vocoder of
``torch_tiny_ref`` saved as zoo entries. Tolerances: audio that two paths
compute in fp32 (coalesced against solo, with other batch paddings; the
stream against ``generate_long``) 1e-4 relative and 1e-5 absolute, plus one
16-bit step where it went through a WAV. Every HTTP call has a 60 s
timeout; servers bind port 0 and are shut down, and services closed, by
their fixtures.
"""

import dataclasses
import http.client
import io
import json
import threading

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from music_synthesis_tpu import config as jax_config
from music_synthesis_tpu.serve import ServeConfig as JaxServeConfig
from music_synthesis_tpu.serve import SynthService as JaxSynthService
from music_synthesis_tpu_torch import config
from music_synthesis_tpu_torch.infer.generate import (
    generate_long,
    generate_long_refined,
)
from music_synthesis_tpu_torch.scripts import serve as serve_cli
from music_synthesis_tpu_torch.serve import (
    ServeConfig,
    SynthService,
    latent_rows,
    make_server,
    wav_bytes,
)

from torch_tiny_ref import save_tiny_zoo

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
STEP = 1.5 / 32767  # one 16-bit step, and rounding


@pytest.mark.parametrize("latent_dim", [16, 20, 128])
@pytest.mark.parametrize("n", [1, 3])
def test_latent_rows_are_prefix_stable(latent_dim, n):
    full = latent_rows(7, 9, n, latent_dim)
    assert full.shape == (9, n, latent_dim) and full.dtype == torch.float32
    for n_clips in range(1, 9):
        rows = latent_rows(7, n_clips, n, latent_dim)
        assert torch.equal(rows, full[:n_clips]), n_clips
    assert not torch.equal(latent_rows(8, 1, n, latent_dim), full[:1])


@pytest.mark.parametrize("n_clips, n", [(1, 1), (3, 2), (4, 8)])
def test_committed_width_keeps_the_previous_draw(n_clips, n):
    """At latent_dim 128 the rows are ``torch.randn((n_clips, n, 128))``
    from the seeded CPU generator, bit for bit."""
    g = torch.Generator().manual_seed(7)
    want = torch.randn((n_clips, n, 128), generator=g)
    assert torch.equal(latent_rows(7, n_clips, n, 128), want)


SERVE = dict(composer="composer_t", vocoder="vocoder_t", batch_buckets=(1, 2),
             patch_buckets=(1, 2), crossfade_frames=4, target_rms=0.1,
             max_clips_per_request=4)


@pytest.fixture(scope="module")
def tiny_zoo(tmp_path_factory):
    root = save_tiny_zoo(tmp_path_factory.mktemp("zoo"))
    save_tiny_zoo(tmp_path_factory.mktemp("zoo2"), seed=31)
    return root


def _service(tiny_zoo, warmup=False, **kw):
    sc = ServeConfig(zoo_root=str(tiny_zoo), **{**SERVE, **kw})
    return SynthService(sc, base_cfg=config.TINY, device="cpu", warmup=warmup)


@pytest.fixture(scope="module")
def service(tiny_zoo):
    svc = _service(tiny_zoo, warmup=True)
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def http_server(service):
    httpd = make_server(service, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=60)


def _req(httpd, method, path, body=None):
    conn = http.client.HTTPConnection(*httpd.server_address, timeout=60)
    try:
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None)
        r = conn.getresponse()
        return r, r.read()
    finally:
        conn.close()


def _decode(data):
    sr, pcm = scipy.io.wavfile.read(io.BytesIO(data))
    return sr, pcm.astype(np.float32) / 32767.0


def test_metrics_keys_and_rounding_match_jax(tiny_zoo, service):
    """``metrics()`` has the reference's keys (with ``errors``), and
    ``gen_ms``, ``rtf`` and the percentiles are rounded as there."""
    jax_svc = JaxSynthService(JaxServeConfig(zoo_root=str(tiny_zoo), **SERVE),
                              base_cfg=jax_config.TINY, warmup=False)
    assert list(service.metrics()) == list(jax_svc.metrics())
    _, meta = service.synth(0.1, seed=1)
    assert meta["gen_ms"] == round(meta["gen_ms"], 3)
    assert meta["rtf"] == round(meta["rtf"], 1)
    m = service.metrics()
    assert m["latency_p50_ms"] == round(m["latency_p50_ms"], 3)
    assert m["latency_p95_ms"] == round(m["latency_p95_ms"], 3)
    assert list(service.health()) == list(jax_svc.health())
    assert list(service.models()) == ["composer", "vocoder"]


def test_device_work_runs_on_one_worker_thread(service):
    """Every device call runs on the service's one worker thread, whichever
    thread asks (PyTorch keeps cuDNN's execution plans per thread)."""
    seen = []
    threads = [threading.Thread(target=lambda: seen.append(
        service._on_device(threading.get_ident))) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    seen.append(service._on_device(threading.get_ident))
    assert len(seen) == 4 and len(set(seen)) == 1
    assert seen[0] not in {t.ident for t in threads} | {threading.get_ident()}


def test_warm_all_covers_the_grid_and_the_stream(service):
    assert service._warm == [(1, 1), (1, 2), (2, 1), (2, 2), ("stream", 1)]


def test_http_routes(http_server, service):
    r, data = _req(http_server, "GET", "/healthz")
    h = json.loads(data)
    assert r.status == 200 and h["status"] == "ok"
    assert h["device"] == "cpu/cpu" and h["vocoder"] == "vocoder_t"
    assert [1, 1] in h["warm_buckets"] and ["stream", 1] in h["warm_buckets"]

    r, data = _req(http_server, "GET", "/models")
    assert r.status == 200
    assert json.loads(data)["vocoder"]["kind"] == "vocoder"

    body = {"seconds": 0.2, "seed": 5, "n_clips": 2}
    r, data = _req(http_server, "POST", "/generate", body)
    assert r.status == 200 and r.getheader("Content-Type") == "audio/wav"
    meta = json.loads(r.getheader("X-Msynth-Meta"))
    sr = service.cfg.frontend.sample_rate
    assert meta["samples"] == int(round(0.2 * sr)) and meta["n_clips"] == 2
    # The in-process call's bytes: both ran on the service's worker thread.
    wav, _ = service.synth(0.2, seed=5, n_clips=2)
    assert data == wav_bytes(sr, wav)

    errors = service.metrics()["errors"]
    for bad in ({"seconds": -3}, {"n_clips": 99}, {"seconds": "x"}):
        r, _ = _req(http_server, "POST", "/generate", bad)
        assert r.status == 400
    r, data = _req(http_server, "GET", "/metrics")
    m = json.loads(data)
    assert m["errors"] == errors + 3 and m["requests"] >= 2
    assert m["latency_p50_ms"] > 0
    for method, path in (("GET", "/nope"), ("POST", "/nope")):
        r, _ = _req(http_server, method, path, {} if method == "POST" else None)
        assert r.status == 404


def test_http_stream_length_and_audio(http_server, service):
    sr = service.cfg.frontend.sample_rate
    seconds = 3.1 * service.out_samples(1) / sr
    want, n = service.stream_samples(seconds)
    assert n > max(service.serve_cfg.patch_buckets)
    r, data = _req(http_server, "POST", "/stream", {"seconds": seconds,
                                                    "seed": 6})
    assert r.status == 200
    assert int(r.getheader("Content-Length")) == len(data) == 44 + 2 * want
    meta = json.loads(r.getheader("X-Msynth-Meta"))
    assert meta["streamed"] and meta["samples"] == want and meta["patches"] == n
    rate, got = _decode(data)
    assert rate == sr and got.shape == (want,)
    raw = service._execute(n, service._z_rows(6, 1, n))[0, :want]
    np.testing.assert_allclose(got, np.clip(raw, -1, 1), rtol=RTOL,
                               atol=ATOL + STEP)
    r, _ = _req(http_server, "POST", "/stream", {"seconds": -1})
    assert r.status == 400


def test_stream_blocks_arrive_incrementally(service):
    sr = service.cfg.frontend.sample_rate
    seconds = 3.1 * service.out_samples(1) / sr
    want, n = service.stream_samples(seconds)
    blocks = list(service.stream_blocks(seconds, seed=4))
    assert len(blocks) > 1
    total = np.concatenate(blocks)
    assert total.shape == (want,) and np.isfinite(total).all()
    np.testing.assert_array_equal(
        total, np.concatenate(list(service.stream_blocks(seconds, seed=4))))
    # The first patches' latents are the one-clip /generate's.
    assert torch.equal(service._z_rows(4, 1, n)[:, :2],
                       service._z_rows(4, 1, 2))
    with pytest.raises(ValueError):
        service.stream_samples(service.serve_cfg.max_stream_seconds + 1)


def test_http_hot_reload(http_server, service, tiny_zoo):
    """POST /reload swaps the models blue/green (here by entry directory);
    a failed reload keeps the old service answering."""
    other = next(p for p in tiny_zoo.parent.iterdir()
                 if p.name.startswith("zoo2")) / "vocoder_t"
    body = {"seconds": 0.2, "seed": 5, "n_clips": 1, "target_rms": 0.0}
    _, before = _req(http_server, "POST", "/generate", body)
    errors = service.metrics()["errors"]
    r, data = _req(http_server, "POST", "/reload", {"vocoder": "nope"})
    assert r.status == 400 and "nope" in json.loads(data)["error"]
    assert http_server.service is service
    assert service.metrics()["errors"] == errors + 1
    r, still = _req(http_server, "POST", "/generate", body)
    assert r.status == 200 and still == before
    try:
        r, data = _req(http_server, "POST", "/reload", {"vocoder": str(other)})
        assert r.status == 200
        h = json.loads(data)
        assert h["vocoder"] == "vocoder_t" and ["stream", 1] in h["warm_buckets"]
        new = http_server.service
        assert new is not service and new.device == service.device
        r, after = _req(http_server, "POST", "/generate", body)
        assert r.status == 200 and after != before
        wav, _ = new.synth(0.2, seed=5, target_rms=0.0)
        assert after == wav_bytes(new.cfg.frontend.sample_rate, wav)
    finally:
        if http_server.service is not service:
            http_server.service.close()
        http_server.service = service


@pytest.fixture
def coalescing(tiny_zoo):
    svc = _service(tiny_zoo, batch_buckets=(1, 2, 4), patch_buckets=(1,),
                   target_rms=0.0, coalesce_window_ms=1000.0)
    yield svc
    svc.close()


def test_coalescer_merges_requests_and_keeps_each_clips_audio(coalescing,
                                                             service):
    sr = coalescing.cfg.frontend.sample_rate
    seconds = coalescing.out_samples(1) / sr * 0.9
    results, errors = {}, []

    def hit(seed):
        try:
            results[seed] = coalescing.synth(seconds, seed=seed)[0]
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=hit, args=(s,)) for s in (1, 2, 3, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and len(results) == 4
    m = coalescing.metrics()
    assert m["requests"] == 4 and m["device_calls"] < 4, m
    for seed in (1, 2, 3, 4):
        solo, _ = service.synth(seconds, seed=seed, target_rms=0.0)
        np.testing.assert_allclose(results[seed], solo, rtol=RTOL, atol=ATOL)


def test_closed_coalescer_refuses_and_its_thread_ends(tiny_zoo):
    svc = _service(tiny_zoo, coalesce_window_ms=5.0)
    wav, _ = svc.synth(0.1, seed=2)
    assert np.isfinite(wav).all()
    svc.close()
    assert not svc._coalescer._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        svc.synth(0.1, seed=2)
    with pytest.raises(RuntimeError):
        next(svc.stream_blocks(0.1))
    svc.close()  # idempotent


def test_gl_refined_service(tiny_zoo, service):
    svc = _service(tiny_zoo, gl_refine=2, target_rms=0.0)
    n = svc.patches_for_seconds(0.3)
    wav, meta = svc.synth(0.3, seed=11)
    svc.close()
    base, _ = service.synth(0.3, seed=11, target_rms=0.0)
    assert wav.shape == base.shape and np.isfinite(wav).all()
    assert not np.allclose(wav, base)
    z = svc._z_rows(11, 1, n)
    with torch.inference_mode():
        want = generate_long_refined(svc.cfg, svc.composer, svc.vocoder, z, 4,
                                     2)[:, : meta["samples"]].numpy()
        raw = generate_long(svc.cfg, svc.composer, svc.vocoder, z, 4)
    np.testing.assert_allclose(wav, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(base, raw[:, : meta["samples"]].numpy(),
                               rtol=RTOL, atol=ATOL)


def test_mesh_serving_is_refused(tiny_zoo):
    """What the reference refuses, the port refuses: a batch bucket that
    does not divide over the devices (JAX's ValueError text); and a device
    list the machine does not have, with the reason (no fallback)."""
    with pytest.raises(ValueError, match=r"batch buckets \[1\] do not divide "
                                         r"over 2 mesh devices"):
        _service(tiny_zoo, mesh_devices=2)
    with pytest.raises(ValueError, match="do not divide"):
        JaxSynthService(JaxServeConfig(zoo_root=str(tiny_zoo),
                                       **{**SERVE, "mesh_devices": 2}),
                        base_cfg=jax_config.TINY, warmup=False)
    if torch.cuda.device_count() < 2:
        sc = ServeConfig(zoo_root=str(tiny_zoo),
                         **{**SERVE, "batch_buckets": (2,),
                            "mesh_devices": 2})
        with pytest.raises(RuntimeError):
            SynthService(sc, base_cfg=config.TINY, device="cuda",
                         warmup=False)


MESH = dict(batch_buckets=(8,), patch_buckets=(1,), target_rms=0.0,
            max_clips_per_request=8, mesh_devices=8)


@pytest.fixture(scope="module")
def mesh_service(tiny_zoo):
    svc = _service(tiny_zoo, **MESH)
    yield svc
    svc.close()


def test_mesh_serving_matches_jax_and_one_device(mesh_service, service,
                                                 tiny_zoo):
    """``mesh_devices=8`` (8 CPU replicas) against the JAX service on its 8
    virtual devices with the same latent rows (``_execute``), and against
    the port's one-device service, clip by clip."""
    svc = mesh_service
    assert svc.health()["mesh_devices"] == 8 and len(svc.devices) == 8
    jax_svc = JaxSynthService(JaxServeConfig(zoo_root=str(tiny_zoo),
                                             **{**SERVE, **MESH}),
                              base_cfg=jax_config.TINY, warmup=False)
    rows = latent_rows(11, 3, 1, svc.cfg.specgan.latent_dim)
    got = svc._execute(1, rows)
    want = jax_svc._execute(1, rows.numpy())
    assert got.shape == want.shape and got.shape[0] == 3
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, service._execute(1, rows), rtol=RTOL,
                               atol=ATOL)
    sr = svc.cfg.frontend.sample_rate
    wav, meta = svc.synth(svc.out_samples(1) / sr * 0.9, seed=11, n_clips=3)
    assert meta["batch_bucket"] == 8 and wav.shape[0] == 3
    np.testing.assert_allclose(wav, got[:, :meta["samples"]], rtol=RTOL,
                               atol=ATOL)


def test_mesh_serving_composes_with_coalescing(tiny_zoo, service):
    """``tests/test_serve.py``'s composition: mesh-sharded buckets behind
    the coalescer give each clip its solo audio, in fewer device calls."""
    svc = _service(tiny_zoo, **MESH, coalesce_window_ms=1000.0)
    try:
        sr = svc.cfg.frontend.sample_rate
        seconds = svc.out_samples(1) / sr * 0.9
        results = {}

        def hit(seed):
            results[seed] = svc.synth(seconds, seed=seed)[0]

        threads = [threading.Thread(target=hit, args=(s,)) for s in (1, 2, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(results) == 3 and svc.metrics()["device_calls"] < 3
        for seed in (1, 2, 3):
            solo, _ = service.synth(seconds, seed=seed, target_rms=0.0)
            np.testing.assert_allclose(results[seed], solo, rtol=RTOL,
                                       atol=ATOL)
    finally:
        svc.close()


def test_serve_cli_starts_over_several_devices(tiny_zoo, monkeypatch,
                                               capsys):
    """``--mesh 2 --device cpu`` loads, warms and reaches the server (a
    stand-in that stops at once)."""
    started = {}

    class Server:
        server_address = ("127.0.0.1", 0)

        def __init__(self, svc, host, port):
            self.service = svc
            started["health"] = svc.health()

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            started["closed"] = True

    monkeypatch.setattr(serve_cli, "make_server", Server)
    monkeypatch.setattr(serve_cli, "SynthService",
                        lambda sc, device: SynthService(
                            sc, base_cfg=config.TINY, device=device))
    serve_cli.main(["--composer", str(tiny_zoo / "composer_t"),
                    "--vocoder", str(tiny_zoo / "vocoder_t"),
                    "--batch-buckets", "2", "--patch-buckets", "1",
                    "--crossfade-frames", "4", "--mesh", "2",
                    "--device", "cpu"])
    assert started["health"]["mesh_devices"] == 2 and started["closed"]
    assert "serving on" in capsys.readouterr().out


def test_serve_cli_flags():
    args = serve_cli.parser().parse_args([
        "--batch-buckets", "1,2,8", "--patch-buckets", "2,4", "--bf16",
        "--coalesce-ms", "5", "--gl-refine", "8", "--target-rms", "0"])
    sc = serve_cli.serve_config(args)
    assert dataclasses.asdict(sc) == dataclasses.asdict(ServeConfig(
        batch_buckets=(1, 2, 8), patch_buckets=(2, 4), target_rms=0.0,
        compute_dtype="bfloat16", coalesce_window_ms=5.0, gl_refine=8))
    assert [f.name for f in dataclasses.fields(ServeConfig)] == [
        f.name for f in dataclasses.fields(JaxServeConfig)]


def test_serve_cli_without_a_card_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        serve_cli.main([])
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err
