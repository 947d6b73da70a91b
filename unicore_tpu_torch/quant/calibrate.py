"""Serve-startup calibration (counterpart of ``unicore_tpu/quant/calibrate.py``):
per-channel weight scales and per-site activation scales, persisted beside
the checkpoint.

1. **collect** -- :func:`collect_scales` runs deterministic held-out batches
   (one per bucket edge, token ids from a fixed-seed numpy stream) through a
   model's quantized twin inside
   :func:`~unicore_tpu_torch.quant.calibration_scope`: every ``QuantDense``
   site runs its fp32 path and records its input absmax (and its output
   absmax at ``quantize_output`` sites) as a running max.  Only the twin
   knows which sites quantize their output, so collection goes through it.
2. **prepare** -- :func:`prepare` turns an fp32 state dict into the
   quantized serving one: each site's ``weight`` (N, K) becomes ``weight_q``
   (int8 or fp8, symmetric per output channel) and ``weight_scale``, with
   the calibrated ``act_scale`` [+ ``out_scale``] beside them;
   :func:`load_prepared` loads it into the twin.
3. **persist** -- :func:`save_scales` writes the activation scales and a
   SHA-256 digest of the site weights to ``<checkpoint>.quant-scales.json``.
   Sites are named by their Flax paths (``sentence_encoder/layers_0/
   self_attn/in_proj``, ..., ``lm_head/dense``) and the digest hashes each
   kernel in the JAX layout, (K, N) C-contiguous fp32, so a sidecar written
   by either package is reused ("reused-verified") by the other when the
   weights match.
4. **drift** -- :func:`logit_drift` runs the same batches through both
   precisions and reports the max/mean absolute logit drift.

Hot reload re-runs this pass for each candidate (the serve CLI's
``preparer``): scales reused when the candidate's digest matches the
sidecar, re-derived otherwise.
"""

import hashlib
import json
import logging
import os
import re
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from unicore_tpu_torch import quant as _q
from unicore_tpu_torch.checkpoint_utils import flax_path
from unicore_tpu_torch.quant.dense import QuantDense, storage_dtype

logger = logging.getLogger(__name__)

SCALES_SUFFIX = ".quant-scales.json"
SCALES_VERSION = 1

#: scale floor: an all-zero calibration activation must quantize to
#: zeros, not divide by zero
SCALE_FLOOR = 1e-8


class CalibrationError(RuntimeError):
    """Calibration or scale verification failed."""


def scales_path(snapshot_path: str) -> str:
    return snapshot_path + SCALES_SUFFIX


def calibration_batches(vocab_size: int, pad_idx: int, bucket_edges: Sequence[int],
                        batch_size: int, n_batches: int = 1,
                        seed: int = 0) -> List[np.ndarray]:
    """One deterministic ``(batch_size, edge)`` int32 token batch per bucket
    edge (times ``n_batches`` rounds), the JAX package's stream exactly."""
    rng = np.random.RandomState(int(seed))
    lo = min(max(pad_idx + 1, 4), max(vocab_size - 1, 1))
    batches = []
    for _ in range(max(1, int(n_batches))):
        for edge in bucket_edges:
            batches.append(
                rng.randint(lo, vocab_size, size=(batch_size, int(edge))).astype(np.int32)
            )
    return batches


def quant_sites(model: torch.nn.Module) -> "OrderedDict[str, QuantDense]":
    """Every ``QuantDense`` of ``model`` by its Flax site path."""
    return OrderedDict(
        (flax_path(name).replace(".", "/"), m)
        for name, m in model.named_modules() if isinstance(m, QuantDense)
    )


def _site_prefix(site: str) -> str:
    """The port state-dict prefix of a Flax site path."""
    return re.sub(r"(^|/)layers_(\d+)(?=/|$)", r"\1layers/\2", site).replace("/", ".")


def _forward(model, tokens):
    dev = next(model.parameters()).device
    with torch.inference_mode():
        return model(torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev))


# ---------------------------------------------------------------------------
# collect
# ---------------------------------------------------------------------------

def collect_scales(model_q, batches: Sequence[np.ndarray]) -> Dict[str, Dict[str, float]]:
    """Run ``batches`` through the fp path of ``model_q`` (a quantized twin
    still holding its fp32 weights) with calibration on; return
    ``{site: {'act_absmax': .., ['out_absmax': ..]}}``, the running max over
    the batches."""
    sites_mod = quant_sites(model_q)
    sites: Dict[str, Dict[str, float]] = {}
    with _q.calibration_scope():
        for tokens in batches:
            for m in sites_mod.values():
                m.calib = {}
            _forward(model_q, tokens)
            for site, m in sites_mod.items():
                slot = sites.setdefault(site, {}) if m.calib else None
                for name, value in m.calib.items():
                    value = float(value)
                    if not np.isfinite(value):
                        raise CalibrationError(
                            f"calibration produced a non-finite {name} at site "
                            f"{site} (poisoned weights?)"
                        )
                    slot[name] = max(slot.get(name, 0.0), value)
    for m in sites_mod.values():
        m.calib = {}
    if not sites:
        raise CalibrationError(
            "calibration saw no QuantDense sites: the model was not built with a "
            "quantize mode (or has no wired dense layers)"
        )
    return sites


# ---------------------------------------------------------------------------
# prepare: fp32 state dict -> quantized serving state dict
# ---------------------------------------------------------------------------

def quantize_weight(weight: torch.Tensor, qmax: float, dtype):
    """Per-output-channel symmetric quantization of a Linear weight (N, K),
    the JAX ``_quantize_weight`` on its (K, N) kernel: fp32
    ``max(absmax / qmax, SCALE_FLOOR)`` per channel, ``weight / scale``
    clipped to +-qmax, rounded half to even (int8), cast."""
    w = weight.detach().float()
    w_scale = torch.clamp_min(w.abs().amax(dim=1) / qmax, SCALE_FLOOR)
    v = torch.clamp(w / w_scale[:, None], -qmax, qmax)
    if dtype == torch.int8:
        v = torch.round(v)
    return v.to(dtype), w_scale


def _act_scale(absmax: float, qmax: float) -> torch.Tensor:
    # in Python floats, then cast: the JAX ``np.float32(max(a / qmax, floor))``
    return torch.tensor(np.float32(max(absmax / qmax, SCALE_FLOOR)))


def prepare(state_dict: Mapping[str, torch.Tensor], sites: Dict[str, Dict[str, float]],
            mode: str) -> "OrderedDict[str, torch.Tensor]":
    """The quantized serving state dict from the fp32 ``state_dict`` and the
    calibrated ``sites``: per site, ``weight`` -> ``weight_q`` +
    ``weight_scale``, plus ``act_scale`` [+ ``out_scale``].  The input is
    left untouched."""
    mode = _q.check_mode(mode)
    out = OrderedDict(state_dict)
    if mode == "off":
        return out
    qmax, dtype = _q.QMAX[mode], storage_dtype(mode)
    for site, leaves in sorted(sites.items()):
        prefix = _site_prefix(site)
        if f"{prefix}.weight" not in out:
            raise CalibrationError(
                f"calibrated site {site!r} has no weight in the checkpoint "
                "(arch/config mismatch?)"
            )
        weight = out.pop(f"{prefix}.weight")
        w_q, w_scale = quantize_weight(weight, qmax, dtype)
        dev = weight.device
        out[f"{prefix}.weight_q"] = w_q
        out[f"{prefix}.weight_scale"] = w_scale
        out[f"{prefix}.act_scale"] = _act_scale(leaves.get("act_absmax", 0.0), qmax).to(dev)
        if "out_absmax" in leaves:
            out[f"{prefix}.out_scale"] = _act_scale(leaves["out_absmax"], qmax).to(dev)
    return out


def load_prepared(model_q: torch.nn.Module, prepared: Mapping[str, torch.Tensor]):
    """Switch every quantized ``QuantDense`` of ``model_q`` to its prepared
    layout and load ``prepared`` (strictly); returns ``model_q``."""
    for m in model_q.modules():
        if isinstance(m, QuantDense):
            m.to_quantized()
    model_q.load_state_dict(prepared, strict=True)
    return model_q


# ---------------------------------------------------------------------------
# persistence + re-verification
# ---------------------------------------------------------------------------

def _kernel_bytes(state_dict, prefix: str) -> bytes:
    """A site's kernel in the JAX layout, (K, N) C-contiguous: fp32 for an
    fp32 weight, the stored bytes for a prepared ``weight_q``."""
    if f"{prefix}.weight" in state_dict:
        w = state_dict[f"{prefix}.weight"].detach().float()
    else:
        w = state_dict[f"{prefix}.weight_q"].detach()
        if w.dtype != torch.int8:
            w = w.view(torch.uint8)
    return w.t().contiguous().cpu().numpy().tobytes()


def weights_digest(state_dict: Mapping[str, torch.Tensor],
                   sites: Dict[str, Dict[str, float]]) -> str:
    """SHA-256 over the site kernels in sorted site order, as the JAX package
    hashes them: it ties a persisted scale set to the exact weights."""
    h = hashlib.sha256()
    for site in sorted(sites):
        prefix = _site_prefix(site)
        if f"{prefix}.weight" not in state_dict and f"{prefix}.weight_q" not in state_dict:
            raise CalibrationError(f"calibrated site {site!r} not found in the "
                                   "checkpoint (arch/config mismatch?)")
        h.update(site.encode())
        h.update(_kernel_bytes(state_dict, prefix))
    return h.hexdigest()


def save_scales(path: str, mode: str, sites: Dict[str, Dict[str, float]], digest: str,
                drift: Optional[dict] = None) -> None:
    """Persist beside the checkpoint, atomically (stage + rename)."""
    doc = {
        "version": SCALES_VERSION,
        "mode": mode,
        "weights_digest": digest,
        "sites": {k: dict(sorted(v.items())) for k, v in sorted(sites.items())},
    }
    if drift is not None:
        doc["calibration_drift"] = drift
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_scales(path: str) -> Optional[dict]:
    """A persisted scale doc; None when absent, CalibrationError when
    unreadable or of another version."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as err:
        raise CalibrationError(f"unreadable scale file {path}: {err}")
    if not isinstance(doc, dict) or doc.get("version") != SCALES_VERSION \
            or "sites" not in doc:
        version = doc.get("version") if isinstance(doc, dict) else None
        raise CalibrationError(f"scale file {path} has unsupported version {version!r}")
    return doc


def digest_matches(doc: dict, state_dict: Mapping[str, torch.Tensor]) -> bool:
    return doc.get("weights_digest") == weights_digest(state_dict, doc.get("sites", {}))


# ---------------------------------------------------------------------------
# drift: the error bound
# ---------------------------------------------------------------------------

def logit_drift(model_q, model_f32, batches: Sequence[np.ndarray]) -> dict:
    """Max/mean absolute logit drift of the quantized model against the fp32
    one over ``batches``."""
    max_abs = mean_abs = ref_absmax = 0.0
    n = 0
    for tokens in batches:
        ref = _forward(model_f32, tokens).float()
        got = _forward(model_q, tokens).float()
        if not bool(torch.isfinite(got).all()):
            raise CalibrationError(
                "quantized forward produced non-finite logits on the calibration batch"
            )
        delta = (got - ref).abs()
        max_abs = max(max_abs, float(delta.max()))
        mean_abs += float(delta.mean())
        ref_absmax = max(ref_absmax, float(ref.abs().max()))
        n += 1
    return {
        "max_abs_logit_drift": max_abs,
        "mean_abs_logit_drift": mean_abs / max(n, 1),
        "ref_logit_absmax": ref_absmax,
        "rel_drift": max_abs / max(ref_absmax, 1e-8),
        "batches": n,
    }


# ---------------------------------------------------------------------------
# the one-call serve-startup entry
# ---------------------------------------------------------------------------

def calibrate_for_serving(
    model_q, model_f32, *,
    mode: str,
    snapshot_path: Optional[str],
    vocab_size: int,
    pad_idx: int,
    bucket_edges: Sequence[int],
    batch_size: int,
    n_batches: int = 1,
    persist: bool = True,
) -> Tuple[torch.nn.Module, dict]:
    """Calibrate (or reuse persisted, digest-verified scales), prepare and
    load the quantized weights into ``model_q`` (the twin
    ``model_f32.clone(quantize=mode)``, still holding fp32 weights), measure
    the drift, persist.  Returns ``(model_q, info)``; ``info`` carries the
    scale source, site count, digest, drift and scales path.  Raises
    :class:`CalibrationError` on any failure."""
    mode = _q.check_mode(mode)
    if mode == "off":
        return model_f32, {"mode": "off"}
    path = scales_path(snapshot_path) if snapshot_path else None
    batches = calibration_batches(vocab_size, pad_idx, bucket_edges, batch_size, n_batches)
    state = model_f32.state_dict()
    sites = None
    source = "calibrated"
    if path:
        # a bad sidecar must never block serving a good checkpoint:
        # re-deriving is always available
        try:
            doc = load_scales(path)
            reusable = (doc is not None and doc.get("mode") == mode
                        and digest_matches(doc, state))
        except CalibrationError as err:
            logger.warning(f"persisted quant scales at {path} are unusable ({err}) "
                           "-- re-calibrating")
            doc, reusable = None, False
        if reusable:
            sites = doc["sites"]
            source = "reused-verified"
        elif doc is not None and doc.get("mode") == mode:
            logger.warning(f"persisted quant scales at {path} were derived from "
                           "DIFFERENT weights (digest mismatch) -- re-calibrating")
    if sites is None:
        sites = collect_scales(model_q, batches)
    load_prepared(model_q, prepare(state, sites, mode))
    drift = logit_drift(model_q, model_f32, batches)
    digest = weights_digest(state, sites)
    if persist and path:
        try:
            save_scales(path, mode, sites, digest, drift)
        except OSError as err:
            logger.warning(f"could not persist quant scales to {path} ({err}); "
                           "serving continues, the next start re-calibrates")
            path = None
    info = {
        "mode": mode,
        "source": source,
        "sites": len(sites),
        "weights_digest": digest,
        "scales_path": path,
        **drift,
    }
    return model_q, info
