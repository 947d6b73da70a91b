"""PyTorch/CUDA port of ``unicore_tpu`` for NVIDIA Hopper (H100).

The JAX package ``unicore_tpu`` is the reference; this package mirrors its
module paths and class names so each part has a findable counterpart.  It
imports ``torch``, numpy and the standard library only — never ``jax`` or
anything of ``unicore_tpu`` (``tests/test_torch_imports.py`` enforces it).

Every TPU (Pallas) kernel on a ported path has a hand-written CUDA C++
kernel for ``sm_90a`` under ``csrc/`` with a plain PyTorch version beside
its wrapper.  A wrapper runs the plain version only for a CPU tensor; for a
CUDA tensor it launches its kernel or raises.

Ported so far: BERT masked-LM serving, ``unicore-tpu-torch-serve``
(``python -m unicore_tpu_torch.cli.serve``); BERT masked-LM, Uni-Mol,
Evoformer masked-MSA and causal-LM training, ``unicore-tpu-torch-train``
(``python -m unicore_tpu_torch.cli.train``), with validation, an EMA, best
and interval checkpoints, resume and fine-tune, mixed precision, the fused
optimizer kernels, and the robustness plane (the health sentinel's rewind,
verified v2 checkpoints, emergency saves, the training fault kinds);
incremental-decode serving of the causal LM (``transformer_lm``: ``POST
/v1/generate``, a paged KV cache, step-level continuous batching) and
quantized BERT serving (``--serve-quantize int8|fp8``) through the same
serving entry point, with its control plane (hot reload, the event journal,
``/metrics``, the serving fault kinds); and the serving fleet: replicas
that ``--advertise`` heartbeat leases into a shared fleet KV directory,
behind ``unicore-tpu-torch-router`` (``python -m
unicore_tpu_torch.cli.router``: power-of-two-choices spread,
deadline-bounded retries, replica-loss verdicts, rolling reload).  Training
logs through the JAX progress bars and stat set (with a TensorBoard sink)
and has the JAX telemetry: the event journal, sampled step spans,
``--profile-steps`` windows on ``torch.profiler``, a trainer ``/metrics``
port, and ``unicore-tpu-torch-trace`` to merge the journals.
"""

__version__ = "0.0.1"
