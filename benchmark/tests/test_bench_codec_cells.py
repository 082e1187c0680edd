"""The driver of ``dac44k-train`` (``drivers/train_codec.py``) on the CPU
at a size a test holds, under the cell's limits: DAC's codec at
``config.TINY_DAC``'s widths with the cell's recipe (batch 2 x 2051, fp32:
the CPU's bf16 2-D convolutions of one-bin-wide bands are not reliable).

A sound run comes out correct and the control (the reference with fp8
convolutions in the program's place) not; ``snake_bytes`` counts the
published widths' 49.76M elements a row."""

import json

from harness.config import BENCH, Cell, load_module
from harness.core import run_cell

SEED = 2 ** 31 + 4242


def _codec_cell() -> Cell:
    from music_synthesis_tpu_torch.config import TINY_DAC, config_to_dict

    t = config_to_dict(TINY_DAC)
    traffic = {**json.loads((BENCH / "traffic" / "dac44k-step.json")
                            .read_text()), "pool_batches": 4}
    limits = json.loads((BENCH / "limits" / "dac44k-train.json").read_text())
    return Cell("tiny-codec", 1, {"train": t, "state_step": 100000}, traffic,
                limits, [{"name": "setup_s", "unit": "s"},
                         {"name": "train_step_ms", "unit": "ms"}], [])


def test_codec_cell_is_correct_and_its_control_is_not():
    ctx = run_cell(_codec_cell(), device="cpu", seed=SEED, seconds=0.2,
                   trace=False)
    assert ctx.correct, ctx.checks
    assert ctx.e2e["train_step_ms"] > 0
    ctx = run_cell(_codec_cell(), device="cpu", seed=SEED, seconds=0.2,
                   trace=False, control=True)
    assert not ctx.correct, ctx.checks


def test_snake_bytes_of_the_published_widths():
    from music_synthesis_tpu_torch.config import DAC_44K

    drv = load_module(BENCH / "drivers" / "train_codec.py", "codec_drv")
    assert drv.snake_elements(DAC_44K.codec, 16_896) == 49_758_720
    assert drv.snake_bytes(DAC_44K.codec, 72, 16_758) == (
        5 * 2 * 72 * 49_758_720 + 3 * 4 * drv._snake_channels(DAC_44K.codec))
