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
(``python -m unicore_tpu_torch.cli.serve``), and BERT masked-LM training,
``unicore-tpu-torch-train`` (``python -m unicore_tpu_torch.cli.train``).
"""

__version__ = "0.0.1"
