"""Small helpers (counterpart of ``unicore_tpu/utils/__init__.py``; this
slice ports the activation table and ``str_to_bool``)."""

from typing import Callable

import torch
import torch.nn.functional as F


def get_activation_fn(activation: str) -> Callable:
    """Activation by name; ``gelu`` is the exact erf form, as in the JAX
    package (``jax.nn.gelu(approximate=False)``)."""
    if activation == "relu":
        return F.relu
    elif activation == "gelu":
        return F.gelu
    elif activation == "gelu_fast" or activation == "gelu_accurate":
        return lambda x: F.gelu(x, approximate="tanh")
    elif activation == "tanh":
        return torch.tanh
    elif activation == "linear":
        return lambda x: x
    elif activation == "swish" or activation == "silu":
        return F.silu
    else:
        raise RuntimeError(f"--activation-fn {activation} not supported")


def str_to_bool(x):
    if isinstance(x, bool):
        return x
    return str(x).lower() in ("yes", "true", "t", "1")
