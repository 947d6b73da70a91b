"""Checkpoints of the port (counterpart of ``unicore_tpu/checkpoint_utils.py``:
save/load and the JAX <-> port weight-name map).

A port checkpoint is ``torch.save({"args": Namespace, "model": state_dict,
...})`` written to a temporary name and ``os.replace``d into place.  The
trainer adds ``optimizer``, ``lr_scheduler``, ``num_updates`` and
``epoch_itr`` beside the weights; the server reads only ``args`` and
``model``.  It loads with ``torch.load(weights_only=True)``,
``argparse.Namespace`` being the one extra type allowed, so loading runs no
pickled code.  Checkpoints written by ``unicore-tpu-train`` may hold
objects of the JAX stack and are not read; :func:`from_jax_params` carries
weights across.
"""

import argparse
import os
import re
from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch


def save_checkpoint(path: str, args: argparse.Namespace,
                    state_dict: Mapping[str, torch.Tensor], **extra) -> None:
    """Write ``{"args", "model", **extra}`` atomically (temp name +
    ``os.replace``); tensors in ``extra`` are saved from the CPU too."""
    tmp = f"{path}.tmp-{os.getpid()}"
    state = {
        "args": args,
        "model": OrderedDict(
            (k, v.detach().cpu()) for k, v in state_dict.items()
        ),
        **{k: _to_cpu(v) for k, v in extra.items()},
    }
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def load_checkpoint_to_cpu(path: str) -> Dict[str, Any]:
    """Load a port checkpoint onto the CPU without running pickled code."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict):
        raise ValueError(f"not a checkpoint dict: {type(state).__name__}")
    return state


_LAYER = re.compile(r"^layers_(\d+)$")


def from_jax_params(variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """The port's ``state_dict`` for a JAX variables tree of numpy arrays
    (``jax.device_get(model.init(...))`` or a checkpoint's ``model``).

    - a dense ``kernel`` (in, out) becomes ``weight`` (out, in), transposed;
    - an embedding table ``embedding`` becomes ``weight``;
    - ``layers_{i}`` becomes ``layers.{i}``;
    - every other leaf (LayerNorm ``weight``/``bias``, dense ``bias``,
      ``lm_head.bias``) keeps its name.
    """
    params = variables["params"] if "params" in variables else variables
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(tree, prefix):
        for key in sorted(tree):
            val = tree[key]
            if isinstance(val, Mapping):
                m = _LAYER.match(key)
                walk(val, prefix + [f"layers.{m.group(1)}" if m else key])
                continue
            arr = np.asarray(val)
            if key == "kernel":
                if arr.ndim != 2:
                    raise ValueError(
                        f"{'.'.join(prefix)}.kernel has shape {arr.shape}; "
                        "only 2-D dense kernels are mapped"
                    )
                key, arr = "weight", arr.T
            elif key == "embedding":
                key = "weight"
            out[".".join(prefix + [key])] = torch.from_numpy(
                np.array(arr, dtype=np.float32)  # a writable copy
            )

    walk(params, [])
    return out


def jax_param_names(model: torch.nn.Module) -> Dict[str, str]:
    """Each parameter's Flax name (dotted path) in the JAX package: the
    inverse of :func:`from_jax_params` — ``layers.{i}`` is ``layers_{i}``,
    a Linear ``weight`` is ``kernel`` and an Embedding ``weight`` is
    ``embedding``."""
    modules = dict(model.named_modules())
    names = {}
    for name, _ in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        mod = modules[owner]
        if leaf == "weight" and isinstance(mod, torch.nn.Linear):
            leaf = "kernel"
        elif leaf == "weight" and isinstance(mod, torch.nn.Embedding):
            leaf = "embedding"
        path = re.sub(r"(^|\.)layers\.(\d+)(?=\.|$)", r"\1layers_\2", owner)
        names[name] = f"{path}.{leaf}" if path else leaf
    return names
