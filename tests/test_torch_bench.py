"""The port's benchmark harness (``music_synthesis_tpu_torch/bench.py`` and
``scripts/bench_{rtf_batch,serve}.py``) on the CPU at TINY, held against the
JAX build's ``bench.py`` and the JAX package.

- ``main()``: every scenario writes its keys under the JAX script's names,
  finite and positive (the MFU is null off the card; the kernel-vs-plain
  scenario skips on the CPU with a log line); the contract line is the
  last stdout line and one JSON object; the record goes to ``--out`` (its
  default is under the git-ignored ``build/``); a scenario that raises is
  recorded, the others still run, and the exit code is 1.
- One call of each timed loop equals the JAX one on the same weights
  (carried across by ``convert`` from a JAX init) and inputs (from numpy):
  ``sum |wav|`` of ``generate`` (iSTFT and waveform heads) within 1e-4
  relative; of ``generate_refined`` (8 Griffin-Lim projections) within
  5e-3: the TINY models leave bins near-silent where the composer's mel
  asks for energy, so the refinement's phase there is rounding noise in
  both packages (``test_torch_griffin_lim``'s docstring), and the sum's
  gap measured on an x86-64 CPU (PyTorch 2.13.0, jax 0.9.0) was 4.6e-6 to
  2.0e-3 over 1-8 projections and two latent seeds; ``d_loss + g_loss``
  of the stage-1 forward and loss within the stage-1 tests' 1e-4
  relative.
- The FLOP count against a walk of the JAX functions' jaxprs (2 per
  multiply-add of each ``conv_general_dilated`` over the taps that land on
  real input samples, and of each ``dot_general``): the discriminator's
  forward equal; the vocoder's within 1% (PyTorch's formula for a
  transposed convolution counts every input sample times every tap, so
  also the taps whose output the padding crops: +0.47% at TINY); the
  stage-2 step's matmuls equal and its convolutions within 5%. The step's
  gap is explained exactly: counted over real taps (``REAL_TAPS`` below),
  the port's step plus one more vocoder forward equals the walk, because
  the JAX step runs G's forward twice (for the D step, and inside the G
  step's ``value_and_grad``) and the port once (``train/stage2.py``).
"""

import contextlib
import dataclasses
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from music_synthesis_tpu import config as jax_config
from music_synthesis_tpu.infer import generate as jax_generate
from music_synthesis_tpu.models.discriminators import (
    CombinedDiscriminator as JaxDisc,
)
from music_synthesis_tpu.models.specgan import (
    SpectrogramGenerator as JaxGenerator,
)
from music_synthesis_tpu.models.vocoder import Vocoder as JaxVocoder
from music_synthesis_tpu.train import stage1 as jax_stage1
from music_synthesis_tpu.train import stage2 as jax_stage2
from music_synthesis_tpu_torch import bench, config
from music_synthesis_tpu_torch import zoo
from music_synthesis_tpu_torch.convert import (
    to_state_dict,
    train_state_from_jax,
)
from music_synthesis_tpu_torch.models.discriminators import (
    CombinedDiscriminator,
)
from music_synthesis_tpu_torch.models.specgan import SpectrogramGenerator
from music_synthesis_tpu_torch.models.vocoder import Vocoder
from music_synthesis_tpu_torch.scripts import bench_rtf_batch, bench_serve
from music_synthesis_tpu_torch.serve import SynthService
from music_synthesis_tpu_torch.train import stage2

from torch_tiny_ref import ISTFT, jitter

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-4
GL_RTOL = 5e-3  # the refined checksum (module docstring)
TINY_FAST = dataclasses.replace(config.TINY, vocoder=dataclasses.replace(
    config.TINY.vocoder, **ISTFT))
# Every scenario at TINY with the fewest calls the estimator takes.
OVERRIDES = {
    "bench_inference_rtf": dict(cfg=TINY_FAST, batch=2, n_iters=2),
    "bench_waveform_head": dict(cfg=config.TINY, batch=2, n_iters=2),
    "bench_refined_rtf": dict(cfg=TINY_FAST, batch=2, n_iters=2, n_gl=2),
    "bench_stage2_step": dict(variants=bench.stage2_variants(config.TINY),
                              n_iters=2),
    "bench_stage1_fwd_loss": dict(cfg=config.TINY, n_iters=2),
    "bench_frontend_cpu_clip": dict(n_iters=2, seconds=1.0),
    "bench_frontend_ab": dict(cfg=config.TINY, n_iters=2),
}
CPU_KEYS = [k for k in bench.RESULT_KEYS if not k.startswith("frontend_kernel")
            and k != "frontend_plain_ms"]


def run_main(capsys, argv, overrides=OVERRIDES):
    rc = bench.main(["--device", "cpu", *argv], overrides)
    out, err = capsys.readouterr()
    return rc, out.splitlines(), err


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """One ``main()`` over every scenario; its exit code, stdout lines,
    stderr and record."""
    out = tmp_path_factory.mktemp("bench") / "record.json"
    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(
            stderr):
        rc = bench.main(["--device", "cpu", "--out", str(out), "--seed", "3"],
                        OVERRIDES)
    return (rc, stdout.getvalue().splitlines(), stderr.getvalue(),
            json.loads(out.read_text()))


def test_every_scenario_writes_the_jax_keys(full_run):
    rc, _, err, record = full_run
    assert rc == 0 and record["failed"] == {}
    results = record["results"]
    assert set(results) == set(CPU_KEYS)
    for key, v in results.items():
        if key.endswith("_mfu"):
            assert v is None, key  # no peak off the card
        else:
            assert isinstance(v, (int, float)) and np.isfinite(v) and v > 0, (
                key, v)
    assert "[frontend_ab] skipped on the CPU" in err
    assert record["notes"]["stage2_gan_step_ms_mfu_precision"] == "fp32"
    assert record["notes"]["stage2_gan_step_fast_ms_mfu_precision"] == "bf16"
    assert record["notes"]["logmel_launches"] == {
        name: 0 for name in ("bench_inference_rtf", *bench.EXTRAS)}
    assert record["device"] == record["card"] == "cpu"


def test_dense_groups_recipe_reports_logical_flops(full_run):
    """The fast recipe lowers the MSD's grouped convolutions to dense
    block-diagonal ones, which execute zero blocks: its executed FLOPs
    exceed the logical ones (its twin without ``dense_groups_max_g``);
    the fp32 recipe executes none."""
    results = full_run[3]["results"]
    for name, dense in (("stage2_gan_step_ms", False),
                        ("stage2_gan_step_fast_ms", True)):
        inflation = results[f"{name}_executed_flop_inflation"]
        assert (inflation > 1.0) if dense else (inflation == 1.0), name
        assert results[f"{name}_tflops_per_s"] == pytest.approx(
            inflation * results[f"{name}_logical_tflops_per_s"], rel=1e-12)


def test_contract_line_is_the_last_stdout_line(full_run):
    _, lines, _, record = full_run
    assert len(lines) == 1
    line = json.loads(lines[-1])
    assert line == {"metric": "fused_two_stage_inference_rtf",
                    "value": record["results"][
                        "fused_two_stage_inference_rtf"],
                    "unit": "x_realtime_per_card", "device": "cpu",
                    "power_limit_w": "cpu"}


def test_record_goes_to_out_and_not_the_repo_root(tmp_path, capsys,
                                                  monkeypatch):
    """The stage-2 metric is measured first and named in the contract line;
    the record lands in ``--out``, the JAX script's ``BENCH_FULL.json`` is
    left as it is, and the default record is under ``build/``."""
    assert bench.DEFAULT_OUT.is_relative_to(REPO / "build")
    jax_record = (REPO / "BENCH_FULL.json").read_bytes()
    root_json = sorted(p.name for p in REPO.glob("*.json"))
    order = []
    for name in ("bench_inference_rtf", *bench.EXTRAS):
        monkeypatch.setattr(bench, name, _stub(name, order))
    out = tmp_path / "sub" / "rec.json"
    rc, lines, _ = run_main(capsys, ["--metric", "stage2_step", "--out",
                                     str(out)])
    assert rc == 0 and order[0] == "bench_stage2_step"
    assert sorted(order) == sorted(("bench_inference_rtf", *bench.EXTRAS))
    line = json.loads(lines[-1])
    assert (line["metric"], line["value"]) == ("stage2_gan_step_ms", 1.0)
    assert set(json.loads(out.read_text())["results"]) == {*order,
                                                           STAGE2_FAST}
    assert (REPO / "BENCH_FULL.json").read_bytes() == jax_record
    assert sorted(p.name for p in REPO.glob("*.json")) == root_json


STAGE2_FAST = "stage2_gan_step_fast_ms"


def _stub(name, order):
    def fn(results, env, **kw):
        order.append(name)
        results[name] = 1.0
        if name == "bench_stage2_step":
            results[STAGE2_FAST] = 1.0
    return fn


def test_a_failed_scenario_is_recorded_and_the_rest_run(tmp_path, capsys,
                                                        monkeypatch):
    def boom(results, env, **kw):
        raise RuntimeError("no room")

    monkeypatch.setattr(bench, "bench_waveform_head", boom)
    overrides = {k: v for k, v in OVERRIDES.items()
                 if k != "bench_stage2_step"}
    monkeypatch.setattr(bench, "bench_stage2_step", _stub("bench_stage2_step",
                                                          []))
    out = tmp_path / "rec.json"
    rc, lines, err = run_main(capsys, ["--out", str(out)], overrides)
    assert rc == 1
    record = json.loads(out.read_text())
    assert record["failed"] == {
        "bench_waveform_head": "RuntimeError('no room')"}
    for key in ("fused_two_stage_inference_rtf", "stage1_fwd_loss_ms",
                "frontend_cpu_clip_ms",
                "fused_two_stage_inference_rtf_gl_refined"):
        assert record["results"][key] > 0
    assert json.loads(lines[-1])["metric"] == "fused_two_stage_inference_rtf"
    assert "[bench_waveform_head] failed" in err


class _Clock:
    """``time`` for ``bench``: ``perf_counter`` reads the given values."""

    def __init__(self, values):
        self._values = iter(values)

    def perf_counter(self):
        return next(self._values)


def test_the_estimator_takes_the_best_positive_pair(monkeypatch):
    """``(t_n - t_1) / (n - 1)``, least over the repeats, negative pairs
    dropped; a run of only noise-dominated pairs raises, and so does a
    checksum that is not finite (or not positive when asked)."""
    env = bench.Env(torch.device("cpu"))
    many = lambda n, gen: torch.ones(())  # noqa: E731
    warm = [0.0, 0.0, 1.0, 1.0, 4.0, 5.0]  # the warm-up pair and its log
    monkeypatch.setattr(bench, "time", _Clock(
        warm + [0.0, 1.0, 1.0, 5.0,       # t_1 1, t_3 4: (4 - 1) / 2
                0.0, 1.0, 1.0, 1.5,       # t_3 0.5: negative, dropped
                0.0, 1.0, 1.0, 3.6]))     # t_3 2.6: (2.6 - 1) / 2
    assert bench.per_call_s("t", env, many, 3) == pytest.approx(0.8)
    monkeypatch.setattr(bench, "time", _Clock(warm + [0.0, 1.0, 1.0, 1.5] * 3))
    with pytest.raises(RuntimeError, match="noise-dominated"):
        bench.per_call_s("t", env, many, 3)
    monkeypatch.undo()
    with pytest.raises(FloatingPointError):
        bench.per_call_s("t", env, lambda n, g: torch.zeros(()), 3,
                         positive=True)
    with pytest.raises(FloatingPointError):
        bench.per_call_s("t", env, lambda n, g: torch.tensor(float("nan")), 3)


# -- one call of each timed loop against JAX ---------------------------------


def latents(cfg, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cfg.specgan.latent_dim)).astype(
        np.float32)


@pytest.fixture(scope="module")
def tiny_models():
    """``head -> (JAX cfg, port cfg, JAX composer and vocoder params, port
    composer and vocoder)``: TINY models initialised by JAX (jitted),
    jittered away from zero as ``torch_tiny_ref`` does, and converted."""
    key = jax.random.PRNGKey(4)
    jgen = JaxGenerator(jax_config.TINY.specgan)
    sp = jitter(jax.jit(jgen.init)(key, jnp.zeros((1, 16)))["params"], 5)
    comp = SpectrogramGenerator(config.TINY.specgan)
    comp.load_state_dict(to_state_dict(sp))
    out = {}
    for head, kw in (("istft", ISTFT), ("waveform", {})):
        jcfg = dataclasses.replace(
            jax_config.TINY,
            vocoder=dataclasses.replace(jax_config.TINY.vocoder, **kw))
        cfg = dataclasses.replace(config.TINY, vocoder=dataclasses.replace(
            config.TINY.vocoder, **kw))
        jvoc = JaxVocoder(jcfg.vocoder)
        vp = jitter(jax.jit(jvoc.init)(key, jnp.zeros((1, 8, 32)))["params"],
                    4)
        voc = Vocoder(cfg.vocoder)
        voc.load_state_dict(to_state_dict(vp))
        out[head] = (jcfg, cfg, sp, vp, comp.eval(), voc.eval())
    return out


@pytest.mark.parametrize("head, n_gl", [("istft", 0), ("waveform", 0),
                                        ("istft", 8)])
def test_generate_checksum_matches_jax(tiny_models, head, n_gl):
    jcfg, cfg, sp, vp, comp, voc = tiny_models[head]
    z = latents(cfg)
    wav = (jax.jit(jax_generate.generate_refined, static_argnums=(0, 4))(
        jcfg, sp, vp, jnp.asarray(z), n_gl) if n_gl
        else jax_generate.generate_jit(jcfg, sp, vp, jnp.asarray(z)))
    want = float(jnp.sum(jnp.abs(wav)))
    got = float(bench.generate_checksum(cfg, comp, voc, torch.from_numpy(z),
                                        n_gl))
    assert abs(got - want) <= (GL_RTOL if n_gl else RTOL) * abs(want), (
        got, want)


def test_stage1_checksum_matches_jax():
    jcfg = jax_config.TINY
    st = jax.jit(jax_stage1.make_train_state, static_argnums=0)(
        jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(1)
    real = rng.uniform(-1, 1, (2, 32, 32)).astype(np.float32)
    z = latents(config.TINY, seed=2)
    m = jax.jit(jax_stage1.forward_and_loss, static_argnums=0)(
        jcfg, st, jnp.asarray(real), jnp.asarray(z))
    want = float(m["d_loss"] + m["g_loss"])
    state = train_state_from_jax(jax.tree.map(np.asarray, st), device="cpu")
    got = float(bench.stage1_checksum(config.TINY, state,
                                      torch.from_numpy(real),
                                      torch.from_numpy(z)))
    assert abs(got - want) <= RTOL * abs(want), (got, want)


# -- the FLOP count against a walk of the JAX graphs -------------------------


def _real_pairs(l_in, k, stride, pad_lo, lhs_dil, rhs_dil, l_out):
    """(output position, tap) pairs of one spatial dim of an XLA conv whose
    tap lands on a real sample of the (lhs-dilated, padded) input."""
    p = (np.arange(l_out)[:, None] * stride
         + np.arange(k)[None, :] * rhs_dil - pad_lo)
    return int(((p >= 0) & (p <= (l_in - 1) * lhs_dil)
                & (p % lhs_dil == 0)).sum())


def jaxpr_flops(closed) -> dict:
    """2 per multiply-add of every ``conv_general_dilated`` (real taps
    only) and ``dot_general`` in a closed jaxpr, sub-jaxprs included."""
    acc = {"conv": 0, "dot": 0}

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            if name == "conv_general_dilated":
                lhs, rhs = (v.aval.shape for v in eqn.invars)
                out = eqn.outvars[0].aval.shape
                dn, prm = eqn.params["dimension_numbers"], eqn.params
                taps = 1
                for d in range(len(lhs) - 2):
                    taps *= _real_pairs(
                        lhs[dn.lhs_spec[2 + d]], rhs[dn.rhs_spec[2 + d]],
                        prm["window_strides"][d], prm["padding"][d][0],
                        prm["lhs_dilation"][d], prm["rhs_dilation"][d],
                        out[dn.out_spec[2 + d]])
                acc["conv"] += (2 * out[dn.out_spec[0]] * rhs[dn.rhs_spec[0]]
                                * rhs[dn.rhs_spec[1]] * taps)
            elif name == "dot_general":
                (contract, _), _ = eqn.params["dimension_numbers"]
                lhs = eqn.invars[0].aval.shape
                k = int(np.prod([lhs[i] for i in contract]))
                acc["dot"] += 2 * int(np.prod(eqn.outvars[0].aval.shape)) * k
            for value in eqn.params.values():
                for v in (value if isinstance(value, (tuple, list))
                          else [value]):
                    if hasattr(v, "jaxpr") and hasattr(v, "consts"):
                        walk(v.jaxpr)
                    elif type(v).__name__ == "Jaxpr":
                        walk(v)

    walk(closed.jaxpr)
    return acc


def _pairs_torch(l_in, k, stride, pad, dil, l_out, transposed):
    """(input sample, tap) pairs of one spatial dim that meet an output
    position, for a PyTorch convolution (transposed or not)."""
    if transposed:
        o = (np.arange(l_in)[:, None] * stride + np.arange(k)[None, :] * dil
             - pad)
        return int(((o >= 0) & (o < l_out)).sum())
    p = np.arange(l_out)[:, None] * stride + np.arange(k)[None, :] * dil - pad
    return int(((p >= 0) & (p < l_in)).sum())


def _real_macs(x, w, stride, padding, dilation, transposed, out):
    taps = 1
    for d in range(len(x) - 2):
        taps *= _pairs_torch(x[2 + d], w[2 + d], stride[d], padding[d],
                             dilation[d], out[2 + d], transposed)
    return x[0] * w[0] * w[1] * taps


def _conv_real(x, w, _b, stride, padding, dilation, transposed, *_,
               out_shape=None, **__):
    return 2 * _real_macs(x, w, stride, padding, dilation, transposed,
                          out_shape)


def _conv_backward_real(grad_out, x, w, _b, stride, padding, dilation,
                        transposed, _op, _groups, output_mask, out_shape,
                        **__):
    # Each gradient (input, weight) meets the forward's real taps once.
    return (2 * _real_macs(x, w, stride, padding, dilation, transposed,
                           grad_out) * (output_mask[0] + output_mask[1]))


#: FlopCounterMode formulas that count only the taps on real samples.
REAL_TAPS = {torch.ops.aten.convolution: _conv_real,
             torch.ops.aten.convolution_backward: _conv_backward_real}


def port_flops(fn, mapping=None) -> dict:
    with FlopCounterMode(display=False, custom_mapping=mapping) as fc:
        fn()
    return {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}


def _conv(counts: dict) -> int:
    return sum(v for k, v in counts.items() if "convolution" in k)


def abstract_init(module, *inputs):
    """A Flax module's parameters as shapes only (nothing is computed)."""
    return jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)


@pytest.fixture(scope="module")
def tiny_step():
    """The TINY stage-2 step's walk, the JAX vocoder forward's walk at the
    step's conditioning shape, and the port's inputs for the same step.
    The walks trace shapes only."""
    jcfg = jax_config.TINY
    t = jcfg.train
    wav = jax.ShapeDtypeStruct((t.batch_size, t.segment_length), jnp.float32)
    st = jax.eval_shape(lambda k: jax_stage2.make_train_state(jcfg, k),
                        jax.random.PRNGKey(0))
    walk = jaxpr_flops(jax.make_jaxpr(
        lambda s, w: jax_stage2.train_step_impl(jcfg, s, w))(st, wav))
    mel = jax.ShapeDtypeStruct(
        (t.batch_size, t.segment_length // jcfg.frontend.hop_length,
         jcfg.frontend.n_mels), jnp.float32)
    voc = JaxVocoder(jcfg.vocoder)
    g_walk = jaxpr_flops(jax.make_jaxpr(voc.apply)(abstract_init(voc, mel),
                                                   mel))
    audio = (0.5 * np.tanh(np.random.default_rng(0).standard_normal(
        wav.shape))).astype(np.float32)
    return {"wav": torch.from_numpy(audio), "walk": walk, "g_walk": g_walk,
            "state": stage2.make_train_state(config.TINY, 0, "cpu"),
            "mel_shape": mel.shape}


def test_discriminator_forward_flops_equal_the_jaxpr_walk():
    jcfg = jax_config.TINY
    wav = jax.ShapeDtypeStruct((2, jcfg.train.segment_length), jnp.float32)
    disc = JaxDisc(jcfg.msd, jcfg.mrd)
    walk = jaxpr_flops(jax.make_jaxpr(disc.apply)(abstract_init(disc, wav),
                                                  wav))
    port = CombinedDiscriminator(config.TINY.msd, config.TINY.mrd)
    with torch.no_grad():
        got = port_flops(lambda: port(torch.zeros(wav.shape)))
    assert _conv(got) == walk["conv"] == 9_153_216
    assert walk["dot"] == 0 and "aten.mm" not in got


def test_vocoder_forward_flops_within_one_percent(tiny_step):
    port = Vocoder(config.TINY.vocoder)
    with torch.no_grad():
        got = _conv(port_flops(lambda: port(torch.zeros(
            tiny_step["mel_shape"]))))
        real = _conv(port_flops(lambda: port(torch.zeros(
            tiny_step["mel_shape"])), REAL_TAPS))
    want = tiny_step["g_walk"]["conv"]
    assert real == want  # the same taps, counted alike
    assert want < got <= 1.01 * want  # PyTorch's formula adds cropped taps


def test_stage2_step_flops_against_the_jaxpr_walk(tiny_step):
    cfg, st, wav = config.TINY, tiny_step["state"], tiny_step["wav"]
    walk = tiny_step["walk"]
    got = bench.step_flops(cfg, st, wav)
    assert got["aten.mm"] == walk["dot"] == 525_312
    assert got["logmel_kernel"] == 0  # the CPU runs the plain version
    conv = _conv(got)
    assert abs(conv - walk["conv"]) <= 0.05 * walk["conv"], (conv, walk)
    # The gap, exactly: the same step over real taps, plus the JAX step's
    # second G forward.
    real = _conv(port_flops(lambda: stage2._step(cfg, st, wav, None, "fast"),
                            REAL_TAPS))
    assert real + tiny_step["g_walk"]["conv"] == walk["conv"]


def test_mfu_uses_the_peak_of_the_precision_that_ran():
    fp32, fast = bench.stage2_variants(config.TINY).values()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert bench.conv_precision(fast, cuda) == "bf16"
    assert bench.conv_precision(fp32, cpu) == "fp32"
    assert bench.conv_precision(fp32, cuda) == (
        "tf32" if torch.backends.cudnn.allow_tf32 else "fp32")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        assert bench.conv_precision(fp32, cuda) == "fp32"
    mixed = dataclasses.replace(fp32, msd=fast.msd)
    assert bench.conv_precision(mixed, cuda) == "mixed"
    assert fp32.train.use_pallas_frontend and fast.train.use_pallas_frontend
    assert fast.train.reuse_real_features
    assert not fp32.train.reuse_real_features


# -- the two scripts ----------------------------------------------------------


def test_rtf_batch_sweep_prints_one_line(capsys):
    line = bench_rtf_batch.main(["--preset", "tiny", "--device", "cpu",
                                 "--batches", "1,2", "--calls", "4"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert [r["batch"] for r in line["sweep"]] == [1, 2]
    assert line["best"] in line["sweep"]
    assert all(r["rtf_per_chip"] > 0 and r["ms_per_call"] > 0
               for r in line["sweep"])
    assert line["device"] == "cpu"


@pytest.fixture(scope="module")
def tiny_zoo(tmp_path_factory):
    """The port's seeded TINY composer and iSTFT vocoder as zoo entries."""
    root = tmp_path_factory.mktemp("zoo")
    t = config.TINY
    vcfg = dataclasses.replace(t.vocoder, **ISTFT)
    for name, kind, model, mcfg in (
            ("composer_t", "specgan", SpectrogramGenerator(
                t.specgan, torch.Generator().manual_seed(1)), t.specgan),
            ("vocoder_t", "vocoder", Vocoder(
                vcfg, torch.Generator().manual_seed(2)), vcfg)):
        zoo.save_pretrained(name, kind, model.state_dict(), mcfg,
                            frontend=t.frontend, mel_scaler=t.mel_scaler,
                            root=root)
    return root


@pytest.mark.parametrize("coalesce_ms", [0.0, 5.0])
def test_serving_load_answers_every_request(tiny_zoo, monkeypatch, capsys,
                                            coalesce_ms):
    monkeypatch.setattr(bench_serve, "SynthService",
                        lambda sc, device: SynthService(
                            sc, base_cfg=config.TINY, device=device))
    line = bench_serve.main([
        "--composer", str(tiny_zoo / "composer_t"),
        "--vocoder", str(tiny_zoo / "vocoder_t"), "--requests", "4",
        "--concurrency", "2", "--coalesce-ms", str(coalesce_ms),
        "--batch-buckets", "1,2", "--patch-buckets", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1]) == line
    assert any(s.startswith("latency p50:") for s in out)
    assert line["answered"] == line["service_requests"] == 4
    assert 0 < line["latency_p50_ms"] <= line["latency_p95_ms"]
    if coalesce_ms == 0:
        assert line["merge_ratio"] == 1.0 and line["device_calls"] == 4
    else:
        assert line["merge_ratio"] >= 1.0
    assert line["device"] == "cpu"
