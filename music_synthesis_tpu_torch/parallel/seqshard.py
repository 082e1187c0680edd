"""Sequence-sharded vocoding with halos (counterpart of
``parallel/seqshard.py``).

When one mel sequence is too long for one device, its frame axis is split
over a list of devices: each shard is padded with ``h`` frames of each
neighbour (zeros at the two global ends), vocoded on its device by that
device's replica of the vocoder, trimmed by ``h * hop`` samples on each
side, and the pieces are gathered on the first device. The reference
exchanges the halos with ``ppermute`` inside one sharded program
(``jax.jit(shard_map(...))``); here one process slices them from the whole
mel, which it holds, and on a card each replica's forward on its shard is
one CUDA graph on its device (``_graphs.Programs``, one per device and
shard index), while the halo cut and the copies between devices stay
outside the graphs. The interior of the result equals vocoding the whole
mel on one device; only the two global edges see the taper any chunked
method has.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
from torch import nn

from music_synthesis_tpu_torch._graphs import Programs
from music_synthesis_tpu_torch.config import VocoderConfig

__all__ = ["receptive_field_frames", "make_seqshard_vocode"]


def receptive_field_frames(cfg: VocoderConfig) -> int:
    """One-sided receptive field of the vocoder in input mel frames (ceil).

    ``conv_in`` spans ``(k - 1) / 2`` frames; each upsampling stage's
    transposed conv reaches under 2 frames at its input rate, and its
    residual stack ``sum_d d (k_res - 1) / 2`` samples at its output rate;
    the output conv ``(k - 1) / 2`` samples at the final rate."""
    rf = (cfg.input_kernel - 1) / 2
    rate = 1.0  # output samples of this stage per mel frame
    for u in cfg.upsample_factors:
        rate *= u
        rf += 2.0 / (rate / u)
        stack = sum(d * (cfg.res_kernel - 1) // 2 for d in cfg.res_dilations)
        rf += stack / rate
    rf += (cfg.output_kernel - 1) / 2 / rate
    return int(-(-rf // 1))


def make_seqshard_vocode(vocoder: nn.Module,
                         devices: Sequence[str | torch.device],
                         halo: int | None = None):
    """``fn(mel [B, T, M]) -> wav [B, T * hop]`` on ``devices[0]``, with T
    split evenly over ``devices`` (which may repeat a device). ``vocoder``
    is copied once onto each device. ``halo`` defaults to the receptive
    field plus 2 frames, as in the reference.

    On a card each shard's forward replays its own graph, keyed by its
    index (two shards of one shape on one device are two programs), and
    each trimmed piece is copied into the result before the next replay,
    which may reuse the graph pool's memory. ``fn.programs`` maps each
    device to its ``Programs``; on the CPU the forwards run eagerly."""
    cfg = vocoder.cfg
    hop = cfg.hop_length
    h = halo if halo is not None else receptive_field_frames(cfg) + 2
    devices = [torch.device(d) for d in devices]
    replicas = [copy.deepcopy(vocoder).to(d).eval() for d in devices]
    programs = {d: Programs(d) for d in devices}
    n = len(devices)

    @torch.inference_mode()
    def fn(mel: torch.Tensor) -> torch.Tensor:
        b, t, m = mel.shape
        if t % n:
            raise ValueError(f"{t} frames do not split over {n} devices")
        t_loc = t // n
        if t_loc < h:
            raise ValueError(
                f"a shard of {t_loc} frames must cover the {h}-frame halo; "
                "use fewer devices or a shorter halo")
        padded = torch.cat([mel.new_zeros((b, h, m)), mel,
                            mel.new_zeros((b, h, m))], dim=1)
        out = None
        for i, (dev, voc) in enumerate(zip(devices, replicas)):
            shard = padded[:, i * t_loc:i * t_loc + t_loc + 2 * h]
            wav = programs[dev]((i,), voc, shard.to(dev, non_blocking=True))
            piece = wav[:, h * hop:-h * hop]
            if out is None:
                out = piece.new_empty((b, n * piece.shape[1]),
                                      device=devices[0])
            out[:, i * piece.shape[1]:(i + 1) * piece.shape[1]].copy_(piece)
        return out

    fn.programs = programs
    return fn
