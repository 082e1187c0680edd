"""PyTorch/CUDA port of ``music_synthesis_tpu`` for NVIDIA Hopper (H100).

The JAX package is the reference; this package mirrors its module names so
each module's counterpart is easy to find, and imports nothing from it.
Entry points (``serve.SynthService`` and ``serve.make_server``,
``infer.copy_synthesis``, ``train.stage1`` / ``train.stage2``
``make_train_state`` and ``train_step``, and the CLIs ``python -m
music_synthesis_tpu_torch.scripts.{train_stage1, train_stage2,
train_two_stage, export_zoo, serve, generate, vocode, eval_checkpoint,
make_corpus, extract_features, eval_stage1, parity, average_ckpts,
export_deploy, bench_rtf_batch, bench_serve}`` and ``python -m
music_synthesis_tpu_torch.bench``, the benchmark harness) run on ``cuda``
unless the caller passes ``device="cpu"``
(``--device cpu``; ``make_corpus`` runs on the host only, and
``export_deploy`` traces on each device of ``--platforms``). Data
parallelism (``parallel/``) runs training over ``torch.distributed``
ranks and inference over a list of devices in one process; ``deploy``
exports the inference paths through ``torch.export``. On the card the
inference programs and the single-process steps of both stages replay one
CUDA graph per shape (``_graphs.py``), as the reference runs one compiled
program per shape; on the CPU they run eagerly.

The one TPU kernel of the reference, the fused log-mel front-end, is a
hand-written CUDA kernel here (``csrc/logmel.cu``, wrapped by
``ops/logmel.py``), built with ``nvcc`` at first use and bound with
``ctypes``; the host-side C++ IO library (``csrc/msynth_io.cc``,
``data/native.py``) is built the same way with ``g++``.
"""

__version__ = "0.1.0"
