"""Scalar metrics logging (counterpart of ``train/metrics.py``).

One JSON object per logged step, ``{"step", "wall_s", **metrics}``, floats
only, appended to a JSONL file and echoed to stdout: the same lines as the
JAX package's logger.
"""

from __future__ import annotations

import json
import time
from typing import IO, Mapping

__all__ = ["MetricsLogger"]


class MetricsLogger:
    """Append-only JSONL scalar logger; also echoes each line to stdout."""

    def __init__(self, path: str | None = None, echo: bool = True):
        self._fh: IO | None = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.monotonic()

    def log(self, step: int, metrics: Mapping[str, object]) -> None:
        """Write one record: ``{"step": step, "wall_s": ..., **metrics}``."""
        rec = {"step": int(step),
               "wall_s": round(time.monotonic() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line)

    def close(self) -> None:
        """Close the JSONL file (no-op for echo-only loggers)."""
        if self._fh:
            self._fh.close()
