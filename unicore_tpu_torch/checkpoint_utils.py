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
      ``lm_head.bias``, Uni-Mol's ``gbf.means``/``gbf.stds``) keeps its
      name; Uni-Mol's ``gbf.mul``/``gbf.bias`` are embeddings (one column
      per edge type), so their ``embedding`` becomes ``weight``;
    - the Evoformer's ``block_{i}`` modules keep their names (the port
      names its blocks so), as do its ``nn.Embed`` tables' owners;
    - a quantized serving tree (``calibrate.prepare`` of the JAX package):
      ``kernel_q`` (K, N) becomes ``weight_q`` (N, K) in its own type (int8,
      or ``float8_e4m3fn`` carried as its bytes), ``kernel_scale`` becomes
      ``weight_scale``, and ``act_scale``/``out_scale`` keep their names;
    - ``transformer_lm``: ``embed_tokens``, ``embed_positions``,
      ``decoder.{emb_layer_norm, final_layer_norm, relative_attention_bias}``,
      ``decoder.layers_{i}.{self_attn, self_attn_layer_norm,
      final_layer_norm, fc1, fc2}`` and the top-level ``out_bias`` map by
      the rules above (a JAX ``transformer_lm`` has no cross-attention
      parameters, and the port's decoder layer creates none), so the
      result loads with ``load_state_dict(strict=True)``.
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
            if key == "kernel_q":
                out[".".join(prefix + ["weight_q"])] = _quantized_kernel(arr)
                continue
            if key == "kernel_scale":
                key = "weight_scale"
            elif key == "kernel":
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


def _quantized_kernel(arr: np.ndarray) -> torch.Tensor:
    """A prepared (K, N) ``kernel_q`` as the port's (N, K) ``weight_q``:
    int8 as is; float8 (an ``ml_dtypes`` array, which ``torch.from_numpy``
    does not take) through its bytes."""
    w = np.ascontiguousarray(arr.T)
    if w.dtype == np.int8:
        return torch.from_numpy(w)
    if w.dtype.name != "float8_e4m3fn":
        raise ValueError(f"kernel_q of type {w.dtype} is neither int8 nor float8_e4m3fn")
    return torch.from_numpy(w.view(np.uint8)).view(torch.float8_e4m3fn)


def flax_path(name: str) -> str:
    """A port module path as the JAX package's Flax path (dotted):
    ``layers.{i}`` is ``layers_{i}``."""
    return re.sub(r"(^|\.)layers\.(\d+)(?=\.|$)", r"\1layers_\2", name)


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
        path = flax_path(owner)
        names[name] = f"{path}.{leaf}" if path else leaf
    return names
