"""The benchmark's files, found by name: ``BENCHMARK.json``, a cell's
configuration (``configs/<config>.json``), traffic mix
(``traffic/<traffic>.json``), limits (``limits/<cell>.json``), window
driver (``drivers/<kind>.py``) and per-layer readers
(``metrics/<metric>.py``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

__all__ = ["BENCH", "ROOT", "Cell", "ns", "load_cell", "load_module"]

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def ns(obj):
    """JSON data as nested attribute namespaces (lists as tuples)."""
    if isinstance(obj, dict):
        return SimpleNamespace(**{k: ns(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return tuple(ns(v) for v in obj)
    return obj


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its files' contents."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, bench_file: Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` and what its files hold."""
    spec = _read(bench_file or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read(ROOT / configs[w["config"]]["file"])
    traffic = _read(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = _read(BENCH / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in names
                              else [])]
    return Cell(name, w["chips"], config, traffic, limits, e2e, layer)


def load_module(path: Path, name: str):
    """A Python file of the benchmark, imported by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
