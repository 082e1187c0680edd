"""Pretrained model zoo (counterpart of ``zoo.py``).

Each entry is a directory ``zoo/<name>/{card.json, params.msgpack}``: the
card rebuilds the exact model config, front-end and MelScaler; the weights
are a Flax msgpack tree, read and written by ``_msgpack.py`` and converted
by ``convert.py``. The JAX package's ``zoo.load_pretrained`` reads what
``save_pretrained`` writes, and ``load_pretrained`` reads the JAX
package's entries.

    entry = load_pretrained("vocoder_istft")
    vocoder = entry.model(device="cuda")
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import torch
from torch import nn

from music_synthesis_tpu_torch import _msgpack
from music_synthesis_tpu_torch.config import (
    FrontendConfig,
    MelScaler,
    SpecGANConfig,
    VocoderConfig,
    section_from_dict,
)
from music_synthesis_tpu_torch.convert import from_state_dict, to_state_dict

__all__ = ["ZOO_ROOT", "PretrainedEntry", "save_pretrained", "load_pretrained",
           "list_pretrained"]

ZOO_ROOT = Path(__file__).resolve().parents[1] / "zoo"

_KIND_TO_CONFIG = {"vocoder": VocoderConfig, "specgan": SpecGANConfig}


@dataclasses.dataclass(frozen=True)
class PretrainedEntry:
    name: str
    kind: str  # "vocoder" | "specgan"
    config: Any  # VocoderConfig | SpecGANConfig
    state_dict: dict[str, torch.Tensor]
    frontend: FrontendConfig | None
    mel_scaler: MelScaler | None
    card: dict

    def model(self, device: str | torch.device,
              compute_dtype: str | None = None) -> nn.Module:
        """The entry's module with its weights, on ``device``, in eval mode.
        ``compute_dtype`` overrides the card's activation dtype."""
        from music_synthesis_tpu_torch.models.specgan import SpectrogramGenerator
        from music_synthesis_tpu_torch.models.vocoder import Vocoder

        cfg = self.config
        if compute_dtype is not None:
            cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
        cls = Vocoder if self.kind == "vocoder" else SpectrogramGenerator
        module = cls(cfg)
        module.load_state_dict(self.state_dict, strict=True)
        return module.to(device).eval().requires_grad_(False)


def save_pretrained(name: str, kind: str, params: dict[str, torch.Tensor],
                    model_config: Any, *,
                    frontend: FrontendConfig | None = None,
                    mel_scaler: MelScaler | None = None,
                    metrics: dict | None = None, notes: str = "",
                    root: Path | str = ZOO_ROOT) -> Path:
    """Write a zoo entry under ``root``: ``params`` (a ``state_dict`` of the
    kind's module) as an fp32 Flax msgpack tree, and the JSON card."""
    if kind not in _KIND_TO_CONFIG:
        raise ValueError(f"kind must be one of {sorted(_KIND_TO_CONFIG)}")
    expected = _KIND_TO_CONFIG[kind]
    if not isinstance(model_config, expected):
        raise TypeError(f"model_config for kind={kind!r} must be "
                        f"{expected.__name__}, got {type(model_config).__name__}")
    out = Path(root) / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "params.msgpack").write_bytes(
        _msgpack.to_bytes(from_state_dict(params)))

    def asdict(c):
        return dataclasses.asdict(c) if c is not None else None

    card = {"name": name, "kind": kind,
            "n_params": sum(int(t.numel()) for t in params.values()),
            "config": asdict(model_config), "frontend": asdict(frontend),
            "mel_scaler": asdict(mel_scaler), "metrics": metrics or {},
            "notes": notes}
    (out / "card.json").write_text(json.dumps(card, indent=1))
    return out


def load_pretrained(name: str, root: Path | str = ZOO_ROOT) -> PretrainedEntry:
    """Load a zoo entry by name, or by path to an entry directory."""
    entry_dir = Path(name) if Path(name).is_dir() else Path(root) / name
    card_file = entry_dir / "card.json"
    if not card_file.exists():
        raise FileNotFoundError(
            f"no zoo entry at {entry_dir}; available: "
            f"{list_pretrained(root) or 'none'}")
    card = json.loads(card_file.read_text())
    cfg = section_from_dict(_KIND_TO_CONFIG[card["kind"]], card["config"])
    sd = to_state_dict(
        _msgpack.restore((entry_dir / "params.msgpack").read_bytes()))
    n = sum(t.numel() for t in sd.values())
    if n != card["n_params"]:
        raise ValueError(f"zoo entry {card['name']}: params.msgpack has {n} "
                         f"parameters but card says {card['n_params']}")
    fe = (section_from_dict(FrontendConfig, card["frontend"])
          if card.get("frontend") else None)
    ms = (section_from_dict(MelScaler, card["mel_scaler"])
          if card.get("mel_scaler") else None)
    return PretrainedEntry(name=card["name"], kind=card["kind"], config=cfg,
                           state_dict=sd, frontend=fe, mel_scaler=ms, card=card)


def list_pretrained(root: Path | str = ZOO_ROOT) -> list[str]:
    """Names of all zoo entries under ``root`` (sorted)."""
    root = Path(root)
    if not root.is_dir():
        return []
    return sorted(p.parent.name for p in root.glob("*/card.json"))
