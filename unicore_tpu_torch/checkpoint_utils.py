"""Checkpoints of the port (counterpart of ``unicore_tpu/checkpoint_utils.py``):
the save-name matrix and retention, the best score, the restore decision,
save/load, and the JAX <-> port weight-name map.

A port checkpoint is ``torch.save({"args": Namespace, "model": state_dict,
...})`` written to a temporary name and ``os.replace``d into place.  The
trainer's checkpoint adds the JAX package's groups: ``optimizer_state``,
``optimizer_history`` (lr scheduler, update count), ``extra_state``
(iterator position, validation loss, best score, meters, training time)
and ``ema``; the server reads only ``args`` and ``model``.  It loads with
``torch.load(weights_only=True)``, ``argparse.Namespace`` being the one
extra type allowed, so loading runs no pickled code.  Checkpoints written
by ``unicore-tpu-train`` may hold objects of the JAX stack and are not
read; :func:`from_jax_params` carries weights across.

:func:`save_checkpoint` writes the checkpoint under its first name in
``--save-dir`` and copies it to the others synchronously, then prunes; the
JAX package's staging in ``--tmp-save-dir``, async copy pool, v2 format,
durable writes and corrupt-file fallback are not ported.
"""

import argparse
import ast
import logging
import os
import re
import shutil
from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def write_checkpoint(path: str, args: argparse.Namespace,
                     state_dict: Mapping[str, torch.Tensor], **extra) -> None:
    """Write ``{"args", "model", **extra}`` atomically (temp name +
    ``os.replace``); tensors in ``extra`` are saved from the CPU too, each
    in its own storage (a ``--fused-adam`` parameter is a view into a flat
    buffer, which ``torch.save`` would store whole)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    state = {
        "args": args,
        "model": OrderedDict(
            (k, _to_cpu(v)) for k, v in state_dict.items()
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
        t = tree.detach().cpu()
        if t.untyped_storage().nbytes() != t.numel() * t.element_size():
            t = t.clone()
        return t
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


def upgrade_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """A checkpoint of the earlier port layout (``optimizer``,
    ``lr_scheduler``, ``num_updates``, ``epoch_itr`` beside ``args`` and
    ``model``) in the current one; any other dict as it is."""
    if "num_updates" not in state or "optimizer_history" in state:
        return state
    return {
        "args": state["args"],
        "model": state["model"],
        "optimizer_state": state.get("optimizer"),
        "optimizer_history": [{"optimizer_name": None,
                               "lr_scheduler_state": state.get("lr_scheduler", {}),
                               "num_updates": state["num_updates"]}],
        "extra_state": ({"train_iterator": state["epoch_itr"]}
                        if "epoch_itr" in state else None),
    }


# ---------------------------------------------------------------------------
# best-metric tracking
# ---------------------------------------------------------------------------

_best_score: Optional[float] = None


def best_score() -> Optional[float]:
    return _best_score


def set_best_score(value: Optional[float]) -> None:
    global _best_score
    _best_score = value


def _track_best(args, val_loss) -> bool:
    """Fold a new validation score into the running best; True when it
    ties or beats the best so far (the checkpoint earns the 'best'
    name)."""
    global _best_score
    if val_loss is None:
        return False
    if args.maximize_best_checkpoint_metric:
        tied_or_better = _best_score is None or val_loss >= _best_score
    else:
        tied_or_better = _best_score is None or val_loss <= _best_score
    if tied_or_better:
        _best_score = val_loss
    return tied_or_better


# ---------------------------------------------------------------------------
# names, publish and retention
# ---------------------------------------------------------------------------

def checkpoint_paths(path, pattern=r"checkpoint(\d+)\.pt"):
    """Every file in ``path`` matching ``pattern``, sorted descending by
    the first regex group."""
    if not os.path.isdir(path):
        return []
    rx = re.compile(pattern)

    def rank(match, fallback):
        return float(match.group(1)) if match.groups() else fallback

    hits = [(rank(m, i), name) for i, name in enumerate(os.listdir(path))
            if (m := rx.fullmatch(name))]
    hits.sort(reverse=True)
    return [os.path.join(path, name) for _, name in hits]


def _remove_checkpoint(path):
    if os.path.lexists(path):
        os.remove(path)
        logger.info(f"removed {path}")


def _retention_rules(args, end_of_epoch):
    """The pruning policy as (pattern, how many to keep, best first?)
    rows.  Update-interval pruning waits at epoch boundaries, so an epoch
    save never evicts the freshest mid-epoch checkpoints."""
    rules = []
    if args.keep_interval_updates > 0 and not end_of_epoch:
        rules.append((r"checkpoint_\d+_(\d+)\.pt", args.keep_interval_updates, True))
    if args.keep_last_epochs >= 0:
        rules.append((r"checkpoint(\d+)\.pt", args.keep_last_epochs, True))
    if args.keep_best_checkpoints > 0:
        metric_pat = r"checkpoint\.best_{}_(-?\d+\.?\d*)(?:_\d+)?\.pt".format(
            args.best_checkpoint_metric)
        rules.append((metric_pat, args.keep_best_checkpoints,
                      args.maximize_best_checkpoint_metric))
    return rules


def ckp_copy_fun(src, checkpoints, end_of_epoch, args):
    """Copy the written checkpoint ``src`` to every other name in
    ``checkpoints`` (temp name + ``os.replace``), then prune by
    :func:`_retention_rules`."""
    for dst in checkpoints:
        if dst == src:
            continue
        tmp = f"{dst}.tmp-{os.getpid()}"
        shutil.copyfile(src, tmp)
        os.replace(tmp, dst)
        logger.info(f"copied {src} to {dst}")
    for pattern, keep, best_first in _retention_rules(args, end_of_epoch):
        ranked = checkpoint_paths(args.save_dir, pattern=pattern)
        if not best_first:
            ranked.reverse()
        for stale in ranked[keep:]:
            _remove_checkpoint(stale)


def _checkpoint_names(args, suffix, epoch, updates, end_of_epoch, val_loss,
                      is_new_best):
    """Every name the current checkpoint is published under; the first is
    the one written, the rest are copies."""
    names = []
    if (end_of_epoch and not args.no_epoch_checkpoints
            and epoch % args.save_interval == 0):
        names.append(f"checkpoint{epoch}{suffix}.pt")
    if (not end_of_epoch and args.save_interval_updates > 0
            and updates % args.save_interval_updates == 0):
        names.append(f"checkpoint_{epoch}_{updates}{suffix}.pt")
    if is_new_best:
        names.append(f"checkpoint_best{suffix}.pt")
        if args.keep_best_checkpoints > 0:
            names.append("checkpoint.best_{}_{:.2f}_{}.pt".format(
                args.best_checkpoint_metric, val_loss, updates))
    if not args.no_last_checkpoints:
        names.append(f"checkpoint_last{suffix}.pt")
    return names


def save_checkpoint(args, trainer, epoch_itr, val_loss):
    """Fold ``val_loss`` into the best score, write the checkpoint under
    the first of its names in ``--save-dir``, copy it to the others and
    prune.  Returns the paths written."""
    is_new_best = _track_best(args, val_loss)
    if args.no_save:
        return []
    os.makedirs(args.save_dir, exist_ok=True)
    epoch, updates = epoch_itr.epoch, trainer.get_num_updates()
    end_of_epoch = epoch_itr.end_of_epoch()
    names = _checkpoint_names(args, args.checkpoint_suffix, epoch, updates,
                              end_of_epoch, val_loss, is_new_best)
    if not names:
        return []
    extra_state = {"train_iterator": epoch_itr.state_dict(), "val_loss": val_loss}
    if _best_score is not None:
        extra_state["best"] = _best_score
    final = [os.path.join(args.save_dir, n) for n in names]
    trainer.save_checkpoint(final[0], extra_state)
    ckp_copy_fun(final[0], final, end_of_epoch, args)
    logger.info(f"saved checkpoint {names} (epoch {epoch} @ {updates} updates, "
                f"score {val_loss})")
    return final


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

_RESET_KINDS = ("optimizer", "lr_scheduler", "meters", "dataloader")


def _resolve_restore(args, suffix):
    """The file to restore from and which state groups to reset, as the
    JAX package decides: ``(path, {kind: reset?})``.

    * the default ``--restore-file`` resumes ``--save-dir``'s
      ``checkpoint_last``, or, with ``--finetune-from-model`` and no last
      checkpoint yet, starts from the pretrained file with every group
      reset;
    * an explicit ``--restore-file`` loads that file; it conflicts with
      ``--finetune-from-model``;
    * ``--reset-*`` flags conflict with ``--finetune-from-model``, which
      resets everything already."""
    resets = {kind: getattr(args, f"reset_{kind}") for kind in _RESET_KINDS}
    finetune = args.finetune_from_model
    if finetune is not None and any(resets.values()):
        raise ValueError(
            "finetune mode already resets optimizer/lr-scheduler/meters/"
            "dataloader state; drop the explicit --reset-* flags when "
            "using --finetune-from-model"
        )
    if args.restore_file != "checkpoint_last.pt":
        if finetune:
            raise ValueError(
                "a non-default --restore-file conflicts with "
                "--finetune-from-model; pick one starting point: " + str(args)
            )
        path = args.restore_file
        if suffix:
            path = path.replace(".pt", suffix + ".pt")
        return path, resets
    path = os.path.join(args.save_dir, f"checkpoint_last{suffix}.pt")
    if finetune is not None and not os.path.exists(path):
        if not os.path.exists(finetune):
            raise ValueError(
                f"pretrained checkpoint not found at --finetune-from-model "
                f"path: {finetune}"
            )
        path = finetune
        resets = {kind: True for kind in _RESET_KINDS}
        logger.info(f"finetune first launch: initializing weights from {path} with "
                    "fresh optimizer, lr-scheduler, meter, and dataloader state")
    return path, resets


def load_checkpoint(args, trainer):
    """Load the checkpoint :func:`_resolve_restore` names into ``trainer``
    and return its ``extra_state`` (None when there is none): the best
    score is restored unless the optimizer or the meters are reset, and
    the iterator position dropped with ``--reset-dataloader``."""
    path, resets = _resolve_restore(args, args.checkpoint_suffix)
    extra_state = trainer.load_checkpoint(
        path, resets["optimizer"], resets["lr_scheduler"], resets["dataloader"],
        ast.literal_eval(args.optimizer_overrides), reset_meters=resets["meters"])
    if extra_state is None:
        return None
    if "best" in extra_state and not (resets["optimizer"] or resets["meters"]):
        set_best_score(extra_state["best"])
    if resets["dataloader"]:
        extra_state.pop("train_iterator", None)
    return extra_state


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
      result loads with ``load_state_dict(strict=True)``;
    - float leaves keep their type where torch has it: a bf16 leaf (a JAX
      ``--bf16`` run's) is a bf16 tensor of the same bits, read without
      ``ml_dtypes``; fp16 stays fp16; the rest is fp32.
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
            out[".".join(prefix + [key])] = _float_tensor(arr)

    walk(params, [])
    return out


def _float_tensor(arr: np.ndarray) -> torch.Tensor:
    """A JAX float leaf as a torch tensor of its own type: bf16 (an
    ``ml_dtypes`` array, which ``torch.from_numpy`` does not take) through
    its 16-bit pattern, fp16 as is, anything else as fp32; always a copy."""
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    if arr.dtype == np.float16:
        return torch.from_numpy(np.array(arr, dtype=np.float16))
    return torch.from_numpy(np.array(arr, dtype=np.float32))


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
