"""Deployment artifacts through ``torch.export`` (counterpart of
``deploy.py``, which serializes ``jax.export`` StableHLO programs).

``torch.export`` traces the inference path once, with the trained
parameters lifted into the program, and ``torch.export.save`` serializes
it: the serving host needs PyTorch and the artifact, not this package, its
configs or its weight files. A symbolic batch dimension (``batch=None``)
lets one program serve any batch size.

A program is traced on one device, and the device is part of the graph
(the Hann windows and the iSTFT bases are made on it), so an artifact holds
one program per platform, each traced on that platform's device: exporting
for ``cuda`` needs a card.

File format (``.msx``), the JAX package's container::

    MAGIC(6) | u64 header_len | header JSON | payload

with the JAX header's fields (``torch_version`` in place of
``jax_version``). The payload is a table of programs, little-endian::

    u32 count | count x (u32 name_len | platform name | u64 size | torch.export.save bytes)

``read_meta`` reads the header of either package's artifacts; a JAX
artifact's payload cannot be run here, and ``load_artifact`` says so.

The log-mel kernel is a ctypes launch that ``torch.export`` cannot trace,
so artifacts take a mel or a latent, as the JAX package's do.

A loaded artifact runs its program as the JAX package's ``Exported.call``
runs a compiled one: on a card, one CUDA graph per input shape
(``_graphs.Programs``, built at the first call of each shape, so a
symbolic-batch artifact captures one graph per batch size it is called
at); on the CPU, under ``_graphs.disable_graphs()`` and while tracing,
op by op. Each call returns a tensor of its own, not the graph's buffer.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import struct
from pathlib import Path
from typing import Sequence

import torch
from torch import nn

from music_synthesis_tpu_torch._device import resolve_device
from music_synthesis_tpu_torch._graphs import Programs
from music_synthesis_tpu_torch.config import PipelineConfig, VocoderConfig
from music_synthesis_tpu_torch.infer.generate import generate
from music_synthesis_tpu_torch.models.specgan import SpectrogramGenerator
from music_synthesis_tpu_torch.models.vocoder import Vocoder

__all__ = [
    "MAGIC",
    "FORMAT_VERSION",
    "DeployArtifact",
    "export_callable",
    "vocoder_artifact",
    "pipeline_artifact",
    "save_artifact",
    "read_meta",
    "load_artifact",
]

MAGIC = b"MSXART"
FORMAT_VERSION = 1

# Name of the symbolic batch dimension used when batch=None, and the batch
# of the example input it is traced with (1 would be specialised).
_BATCH_SYM = "b"
_EXAMPLE_BATCH = 2


@dataclasses.dataclass(frozen=True)
class DeployArtifact:
    """A loaded deployment artifact: the program for one device + meta."""

    exported: torch.export.ExportedProgram
    meta: dict
    device: torch.device
    module: nn.Module  # exported.module(), made once
    programs: Programs  # its CUDA graphs on a card, one per input shape

    def __call__(self, *args) -> torch.Tensor:
        """Runs the program on ``self.device``; arrays or tensors in. On a
        card it replays the graph of the inputs' shapes, and the result is
        copied out of the graph's buffer, so a later call leaves it as it
        is."""
        inputs = [torch.as_tensor(a, dtype=torch.float32, device=self.device)
                  for a in args]
        return self.programs("program", self.module, *inputs, fresh=True)

    @property
    def platforms(self) -> tuple[str, ...]:
        return tuple(self.meta["platforms"])


def _batch_dim(batch: int | None):
    """Concrete batch size, or the symbolic dimension's name for None."""
    if batch is None:
        return _BATCH_SYM
    if batch < 1:
        raise ValueError(f"batch must be >= 1 or None (symbolic), got {batch}")
    return batch


def _render(shape) -> list:
    """JSON-safe shape: a symbolic size renders as the batch's name."""
    return [int(d) if isinstance(d, int) else _BATCH_SYM for d in shape]


def _spec_meta(values) -> list[dict]:
    return [{"shape": _render(v.shape),
             "dtype": str(v.dtype).removeprefix("torch.")} for v in values]


def export_callable(
    module: nn.Module,
    in_specs: Sequence[tuple[Sequence[int | str], torch.dtype]],
    *,
    platforms: Sequence[str] = ("cuda",),
) -> dict[str, torch.export.ExportedProgram]:
    """Trace ``module`` at ``in_specs`` (``(shape, dtype)`` pairs; the size
    ``"b"`` is the symbolic batch) once per platform, on that platform's
    device, with its parameters and buffers lifted into the program."""
    programs = {}
    for platform in platforms:
        dev = resolve_device(platform)
        mod = copy.deepcopy(module).to(dev).eval().requires_grad_(False)
        example, dynamic = [], []
        for shape, dtype in in_specs:
            concrete = [_EXAMPLE_BATCH if d == _BATCH_SYM else int(d)
                        for d in shape]
            example.append(torch.zeros(concrete, dtype=dtype, device=dev))
            dynamic.append({i: torch.export.Dim(_BATCH_SYM, min=1)
                            for i, d in enumerate(shape) if d == _BATCH_SYM}
                           or None)
        programs[dev.type] = torch.export.export(
            mod, tuple(example), dynamic_shapes=tuple(dynamic))
    return programs


class _Pipeline(nn.Module):
    """``infer.generate.generate`` as a module: latent -> waveform."""

    def __init__(self, cfg: PipelineConfig, composer: SpectrogramGenerator,
                 vocoder: Vocoder):
        super().__init__()
        self.cfg = cfg
        self.composer = composer
        self.vocoder = vocoder

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return generate(self.cfg, self.composer, self.vocoder, z)


def _loaded(module: nn.Module, params: dict[str, torch.Tensor]) -> nn.Module:
    module.load_state_dict(params, strict=True)
    return module.eval().requires_grad_(False)


def vocoder_artifact(
    params: dict[str, torch.Tensor],
    config: VocoderConfig,
    n_frames: int,
    *,
    batch: int | None = None,
    platforms: Sequence[str] = ("cuda",),
    provenance: dict | None = None,
) -> tuple[dict[str, torch.export.ExportedProgram], dict]:
    """Export copy-synthesis: normalized mel ``[B, T, M] -> wav [B, T*hop]``
    from a vocoder ``state_dict``. ``batch=None`` exports a symbolic batch
    dimension; ``n_frames`` stays concrete (serving buckets durations the
    same way ``serve.py`` does)."""
    b = _batch_dim(batch)
    voc = _loaded(Vocoder(config), params)
    programs = export_callable(
        voc, [((b, n_frames, config.n_mels), torch.float32)],
        platforms=platforms)
    return programs, _meta("vocoder_copy_synthesis", programs, provenance)


def pipeline_artifact(
    cfg: PipelineConfig,
    specgan_params: dict[str, torch.Tensor],
    vocoder_params: dict[str, torch.Tensor],
    *,
    batch: int | None = None,
    platforms: Sequence[str] = ("cuda",),
    provenance: dict | None = None,
) -> tuple[dict[str, torch.export.ExportedProgram], dict]:
    """Export the two-stage pipeline: latent ``[B, Z] -> wav [B, L]``, the
    program of ``infer.generate.generate`` (composer, mel chunking, batched
    vocoder, windowed OLA) with both parameter sets lifted in."""
    b = _batch_dim(batch)
    pipe = _Pipeline(cfg, _loaded(SpectrogramGenerator(cfg.specgan),
                                  specgan_params),
                     _loaded(Vocoder(cfg.vocoder), vocoder_params))
    programs = export_callable(
        pipe, [((b, cfg.specgan.latent_dim), torch.float32)],
        platforms=platforms)
    return programs, _meta("two_stage_generate", programs, provenance)


def _outputs(program: torch.export.ExportedProgram) -> list:
    node = next(n for n in program.graph.nodes if n.op == "output")
    return [a.meta["val"] for a in node.args[0]]


def _meta(kind: str, programs: dict, provenance: dict | None) -> dict:
    program = next(iter(programs.values()))
    inputs = [n.meta["val"] for n in program.graph.nodes
              if n.op == "placeholder"
              and n.name in program.graph_signature.user_inputs]
    baked = [*program.state_dict.values(), *program.constants.values()]
    return {
        "format_version": FORMAT_VERSION,
        "kind": kind,
        "platforms": list(programs),
        "inputs": _spec_meta(inputs),
        "outputs": _spec_meta(_outputs(program)),
        # Parameters and constants (the iSTFT bases among them).
        "n_params_baked": sum(int(t.numel()) for t in baked
                              if isinstance(t, torch.Tensor)),
        "torch_version": torch.__version__,
        "provenance": provenance or {},
    }


def save_artifact(path: Path | str,
                  exported: dict[str, torch.export.ExportedProgram],
                  meta: dict) -> Path:
    """Write the programs + ``meta`` as one self-contained ``.msx`` file."""
    payload = io.BytesIO()
    payload.write(struct.pack("<I", len(exported)))
    for platform, program in exported.items():
        buf = io.BytesIO()
        torch.export.save(program, buf)
        name = platform.encode("utf-8")
        payload.write(struct.pack("<I", len(name)) + name)
        payload.write(struct.pack("<Q", buf.getbuffer().nbytes))
        payload.write(buf.getbuffer())
    header = json.dumps(meta).encode("utf-8")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        f.write(payload.getbuffer())
    return path


def read_meta(path: Path | str) -> dict:
    """Read just the JSON header, of this package's artifacts or the JAX
    package's, without loading a program."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(
                f"{path}: not a deployment artifact (bad magic {magic!r})")
        (hlen,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(hlen).decode("utf-8"))
    if meta.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"{path}: format_version {meta['format_version']} is newer than "
            f"this package understands ({FORMAT_VERSION})")
    return meta


def _programs(payload: bytes) -> dict[str, bytes]:
    (count,) = struct.unpack_from("<I", payload, 0)
    off, out = 4, {}
    for _ in range(count):
        (n,) = struct.unpack_from("<I", payload, off)
        name = payload[off + 4: off + 4 + n].decode("utf-8")
        (size,) = struct.unpack_from("<Q", payload, off + 4 + n)
        off += 12 + n
        out[name] = payload[off: off + size]
        off += size
    return out


def load_artifact(path: Path | str,
                  device: str | torch.device | None = None) -> DeployArtifact:
    """Load the program of an ``.msx`` artifact for ``device`` (``cuda``
    unless told otherwise)."""
    meta = read_meta(path)
    if "torch_version" not in meta:
        raise ValueError(
            f"{path}: exported by the JAX package (jax_version "
            f"{meta.get('jax_version')}): its payload is a serialized "
            "jax.export program, which PyTorch cannot run; read_meta reads "
            "its header")
    dev = resolve_device(device)
    with open(path, "rb") as f:
        f.seek(len(MAGIC))
        (hlen,) = struct.unpack("<Q", f.read(8))
        f.seek(len(MAGIC) + 8 + hlen)
        programs = _programs(f.read())
    if dev.type not in programs:
        raise ValueError(f"{path}: no program for {dev.type}; the artifact "
                         f"holds {sorted(programs)}")
    exported = torch.export.load(io.BytesIO(programs[dev.type]))
    return DeployArtifact(exported=exported, meta=meta, device=dev,
                          module=exported.module(), programs=Programs(dev))
