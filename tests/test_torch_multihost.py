"""The port's multi-process initialisation (``parallel/multihost.py``) on
the CPU, against the JAX package's ``parallel/multihost.py`` contract.

- Without torchrun's variables, or with ``WORLD_SIZE`` 1, ``initialize``
  does nothing (the reference's single-process fallback), and
  ``local_batch_slice`` is the whole batch.
- Two subprocesses with torchrun's variables (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) join one gloo group:
  each feeds its ``local_batch_slice`` (JAX's rows for the same rank and
  count), an ``all_reduce`` sums over both, and the stage-1 CLI trains two
  steps with ``--mesh 2`` under those variables (its run files written once,
  by rank 0).
- A rank never moves to the CPU on its own: ``rank_device`` asks for
  ``cuda:LOCAL_RANK`` and raises without that card; a CLI under
  ``WORLD_SIZE`` other than ``--mesh`` exits with the reason.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from music_synthesis_tpu_torch.parallel import mesh, multihost
from music_synthesis_tpu_torch.scripts import train_stage1

REPO = Path(__file__).resolve().parents[1]
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")

WORKER = textwrap.dedent("""
    import json, os, sys
    import torch
    import torch.distributed as dist
    from music_synthesis_tpu_torch.parallel import mesh, multihost

    group = multihost.initialize(device="cpu")
    assert group is not None and dist.get_backend() == "gloo"
    sl = multihost.local_batch_slice(8)
    total = torch.tensor([float(mesh.rank() + 1)])
    dist.all_reduce(total)
    print("RESULT " + json.dumps({
        "rank": mesh.rank(), "world": mesh.world_size(),
        "slice": [sl.start, sl.stop], "sum": total.item(),
        "device": str(multihost.rank_device("cpu"))}), flush=True)
    dist.destroy_process_group()
    # The CLI joins a group of its own from the same variables (on a fresh
    # port) and leaves it at its end.
    os.environ["MASTER_PORT"] = os.environ["CLI_PORT"]
    from music_synthesis_tpu_torch.scripts import train_stage1
    train_stage1.main(sys.argv[1:])
    assert not dist.is_initialized()
""")


@pytest.fixture
def no_torchrun(monkeypatch):
    for k in TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_initialize_is_a_no_op_for_one_process(no_torchrun):
    assert multihost.initialize() is None
    assert not torch.distributed.is_initialized()
    assert multihost.local_batch_slice(8) == slice(0, 8)
    no_torchrun.setenv("WORLD_SIZE", "1")
    no_torchrun.setenv("RANK", "0")
    assert multihost.initialize() is None
    assert not torch.distributed.is_initialized()


def test_rank_device_never_falls_back_to_the_cpu(no_torchrun):
    no_torchrun.setenv("LOCAL_RANK", "1")
    assert multihost.rank_device("cpu") == torch.device("cpu")
    assert multihost.rank_device("cuda:3") == torch.device("cuda", 3)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="needs cuda:1"):
            multihost.rank_device()
    with pytest.raises(RuntimeError, match="CUDA devices asked for"):
        mesh.device_list(torch.cuda.device_count() + 1, "cuda")
    assert mesh.device_list(3, "cpu") == [torch.device("cpu")] * 3
    assert mesh.device_list(2, devices=["cpu", "cpu"]) == [
        torch.device("cpu")] * 2


def test_launch_without_devices_never_runs_on_the_cpu(monkeypatch):
    """``mesh.launch`` without ``devices`` takes ``cuda:0`` .. and, with no
    card, raises before it starts any rank; the CPU only when named (the
    gloo groups of ``test_torch_parallel`` launch that way)."""
    import torch.multiprocessing as mp

    def no_spawn(*args, **kwargs):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mp, "start_processes", no_spawn)
    with pytest.raises(RuntimeError, match="2 CUDA devices asked for, 0"):
        mesh.launch(print, 2, ())
    with pytest.raises(ValueError, match="1 devices given for 2"):
        mesh.launch(print, 2, (), devices=["cpu"])


def test_cli_under_another_world_size_exits(no_torchrun, tmp_path, capsys):
    no_torchrun.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        train_stage1.main(["--device", "cpu", "--preset", "tiny", "--batch",
                           "2", "--steps", "1", "--outdir", str(tmp_path)])
    assert e.value.code != 0
    assert "WORLD_SIZE 2 must equal --mesh 1" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_two_processes_with_torchrun_variables(tmp_path):
    """JAX's ``local_batch_slice`` for process i of 2 over a batch of 8 is
    ``slice(4 i, 4 i + 4)``; the port's ranks read the same."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port, cli_port = str(mesh.free_port()), str(mesh.free_port())
    run = tmp_path / "run"
    argv = ["--mesh", "2", "--device", "cpu", "--preset", "tiny", "--batch",
            "2", "--steps", "2", "--log-every", "1", "--prefetch", "0",
            "--outdir", str(run)]
    procs = []
    for r in range(2):
        env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r),
               "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": port, "CLI_PORT": cli_port,
               "PYTHONPATH": str(REPO),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, str(script), *argv], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    results = [json.loads(next(line for line in out.splitlines()
                               if line.startswith("RESULT "))[7:])
               for out in outs]
    for r, res in enumerate(results):
        assert res == {"rank": r, "world": 2, "slice": [4 * r, 4 * r + 4],
                       "sum": 3.0, "device": "cpu"}
    # The CLI: rank 0 alone printed and wrote the run directory.
    assert "done: 2 steps" in outs[0] and "done:" not in outs[1]
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2]
    assert json.loads((run / "config.json").read_text())["train"][
        "mesh_shape"] == [2]
    assert sorted(p.name for p in (run / "ckpt").iterdir()) == ["2.pt"]
