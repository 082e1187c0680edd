"""Cells cut to what a CPU test can hold, each with the limits of the
benchmark cell it stands for (``limits/<cell>.json``).

- ``train_cell``: the flagship recipe (hinge, FM, STFT, R1, Adam, EMA, bf16
  G and D, dense MSD groups) on the port's ``TINY`` widths, batch 2 x 2048;
  ``rich`` takes the rich recipe (no R1, gate or noise) instead;
- ``generate_cell``: the rich zoo pair at its widths, 1 clip of 2 patches.
"""

import json

from harness.config import BENCH, Cell

_E2E = {"train": ("train_step_ms", "ms"), "generate": ("audio_s_per_s",
                                                        "audio-s/s")}


def _cell(name: str, limits_of: str, config: dict, traffic: dict) -> Cell:
    metric, unit = _E2E[traffic["kind"]]
    limits = json.loads((BENCH / "limits" / f"{limits_of}.json").read_text())
    return Cell(name, 1, config, traffic, limits,
                [{"name": "setup_s", "unit": "s"},
                 {"name": metric, "unit": unit}], [])


def _read(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def train_cell(rich: bool = False) -> Cell:
    from music_synthesis_tpu_torch.config import TINY, config_to_dict

    src = _read("configs", "rich" if rich else "flagship")
    tiny = config_to_dict(TINY)
    tiny["train"] = {**src["train"]["train"], "batch_size": 2,
                     "segment_length": 2048}
    for k in ("msd", "mrd", "vocoder"):
        tiny[k]["compute_dtype"] = "bfloat16"
    tiny["msd"]["dense_groups_max_g"] = src["train"]["msd"][
        "dense_groups_max_g"]
    for k in ("head", "init_scheme", "res_init_gain", "out_init_gain"):
        tiny["vocoder"][k] = src["train"]["vocoder"][k]
    if tiny["vocoder"]["head"] == "istft":
        tiny["vocoder"]["upsample_factors"] = [8, 8]
    traffic = {**_read("traffic", "stage2-step"), "pool_batches": 4}
    return _cell("tiny-train", "rich-train" if rich else "flagship-train",
                 {"train": tiny, "state_step": src["state_step"]}, traffic)


def generate_cell() -> Cell:
    traffic = {**_read("traffic", "batch16-long"), "batch": 1, "patches": 2,
               "check_calls": 2}
    return _cell("tiny-generate", "rich-generate", _read("configs", "rich"),
                 traffic)

