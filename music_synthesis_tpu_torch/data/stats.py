"""Corpus-derived mel statistics (counterpart of ``data/stats.py``).

The GANs work in a normalized log-mel space; ``config.MelScaler`` is the
affine map between real log-mel units and [-1, 1]. ``compute_mel_stats``
fits it to a corpus: it samples batches, computes the log-mel of each with
``ops/frontend.log_mel_for_vocoder`` (the plain front-end, the
counterpart of the JAX package's XLA oracle) on the device, and maps the
robust range (the 0.5 and 99.5 percentiles, taken on the host with numpy)
onto [-1, 1]. Deterministic in (corpus, seed), so a resumed run derives
the same statistics.
"""

from __future__ import annotations

import numpy as np
import torch

from music_synthesis_tpu_torch._device import resolve_device
from music_synthesis_tpu_torch.config import MelScaler, PipelineConfig
from music_synthesis_tpu_torch.ops.frontend import log_mel_for_vocoder

__all__ = ["compute_mel_stats"]


def compute_mel_stats(ds, cfg: PipelineConfig, n_batches: int = 16,
                      batch_size: int = 32, seed: int = 0,
                      device: str | torch.device | None = None) -> MelScaler:
    """A MelScaler that maps the corpus's log-mel robustly onto [-1, 1].

    ``ds`` is any dataset with ``sample_batch(step, batch_size, seed)``;
    the batches use step indices ``2**30 + i``, which training never
    draws. The log-mel runs on ``device`` (``cuda`` unless told
    otherwise).
    """
    dev = resolve_device(device)
    lo_sum = hi_sum = 0.0
    for i in range(n_batches):
        wav = torch.from_numpy(ds.sample_batch(2**30 + i, batch_size, seed))
        with torch.no_grad():
            mel = log_mel_for_vocoder(wav.to(dev), cfg.frontend).cpu().numpy()
        lo_sum += float(np.percentile(mel, 0.5))
        hi_sum += float(np.percentile(mel, 99.5))
    lo = lo_sum / n_batches
    hi = hi_sum / n_batches
    return MelScaler(shift=0.5 * (lo + hi), scale=max(0.5 * (hi - lo), 1e-3))
