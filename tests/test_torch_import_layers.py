"""The port's layers import downward only: the graph runtime knows no op,
the parallel layer no trainer, and the composer's trainer not the
vocoder's. Each case imports one module in a fresh interpreter and lists
the package's modules it loaded."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = "music_synthesis_tpu_torch"


@pytest.mark.parametrize("module, forbidden", [
    ("_graphs", "ops."),
    ("parallel.mesh", "train."),
    ("train.stage1", "train.stage2"),
])
def test_module_does_not_load_a_higher_layer(module, forbidden):
    code = (f"import json, sys; import {PKG}.{module}; "
            f"print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    loaded = json.loads(out.splitlines()[-1])
    assert f"{PKG}.{module}" in loaded
    bad = [m for m in loaded if m.startswith(f"{PKG}.{forbidden}")]
    assert not bad, f"importing {module} loads {bad}"
