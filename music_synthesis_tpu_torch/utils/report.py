"""Experiment report pages with embedded audio (counterpart of
``utils/report.py``).

One self-contained HTML page per experiment: a metrics table, and each clip
as a base64 WAV data URI with, when matplotlib is installed, its log-mel as
an inline PNG (without matplotlib the images are left out).
"""

from __future__ import annotations

import base64
import datetime
import html
import io
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from music_synthesis_tpu_torch.utils.wav import write_wav

__all__ = ["write_report"]


def _wav_data_uri(wav: np.ndarray, sample_rate: int) -> str:
    buf = io.BytesIO()
    write_wav(buf, sample_rate, wav)
    b64 = base64.b64encode(buf.getvalue()).decode("ascii")
    return f"data:audio/wav;base64,{b64}"


def _mel_png_uri(mel: np.ndarray) -> str | None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return None
    fig, ax = plt.subplots(figsize=(6, 2.2), dpi=80)
    ax.imshow(mel.T, origin="lower", aspect="auto", cmap="magma")
    ax.set_xlabel("frames")
    ax.set_ylabel("mel")
    fig.tight_layout()
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    b64 = base64.b64encode(buf.getvalue()).decode("ascii")
    return f"data:image/png;base64,{b64}"


def write_report(
    path: str | Path,
    title: str,
    clips: Sequence[tuple[str, np.ndarray]],
    sample_rate: int = 22_050,
    mels: Sequence[np.ndarray] | None = None,
    metrics: Mapping[str, float] | None = None,
) -> Path:
    """Write a self-contained HTML report.

    clips: (caption, waveform) pairs; mels: optional matching log-mel arrays
    ``[T, M]``; metrics: scalar table rendered at the top.
    """
    path = Path(path)
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title>",
        "<style>body{font-family:sans-serif;max-width:900px;margin:2em auto}"
        "figure{margin:1.5em 0;padding:1em;border:1px solid #ddd;"
        "border-radius:8px}img{max-width:100%}table{border-collapse:collapse}"
        "td,th{border:1px solid #ccc;padding:4px 10px}</style></head><body>",
        f"<h1>{html.escape(title)}</h1>",
        f"<p>generated {datetime.datetime.now().isoformat(timespec='seconds')}"
        f" · {len(clips)} clips · {sample_rate} Hz</p>",
    ]
    if metrics:
        parts.append("<table><tr><th>metric</th><th>value</th></tr>")
        for k, v in metrics.items():
            # Scalars render numerically; structured values (e.g. the
            # per-clip arrays eval_checkpoint.py persists) are skipped —
            # the table is a summary, eval.json carries the full record.
            if isinstance(v, (int, float)):
                cell = f"{float(v):.6g}"
            else:
                continue
            parts.append(
                f"<tr><td>{html.escape(str(k))}</td><td>{cell}</td></tr>"
            )
        parts.append("</table>")
    for i, (caption, wav) in enumerate(clips):
        wav = np.asarray(wav)
        parts.append("<figure>")
        parts.append(f"<figcaption>{html.escape(caption)} "
                     f"({len(wav) / sample_rate:.2f}s)</figcaption>")
        parts.append(
            f"<audio controls src='{_wav_data_uri(wav, sample_rate)}'></audio>"
        )
        if mels is not None and i < len(mels):
            uri = _mel_png_uri(np.asarray(mels[i]))
            if uri:
                parts.append(f"<img src='{uri}' alt='mel spectrogram'>")
        parts.append("</figure>")
    parts.append("</body></html>")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(parts))
    return path
