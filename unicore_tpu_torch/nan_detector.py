"""NaN/Inf localization (counterpart of ``unicore_tpu/nan_detector.py``).

Run after a non-finite gradient norm (``--nan-rerun``), off the hot path:
:meth:`NanDetector.check_forward` runs the forward with a forward hook on
every named submodule (the torch idiom for flax's
``capture_intermediates``) and names the first module, in the order the
modules finish, whose output holds a non-finite value;
:meth:`NanDetector.check_grads` names the first parameter whose gradient
does; :meth:`NanDetector.dump_grad_norms` logs every gradient's norm.
"""

import logging
from typing import Dict, Iterable, Optional

import torch

logger = logging.getLogger(__name__)


def _tensors(out) -> Iterable[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def _finite_range(t: torch.Tensor):
    t = t.detach().float()
    finite = t[torch.isfinite(t)]
    return (float(finite.min()), float(finite.max())) if finite.numel() else (0, 0)


class NanDetector:
    """Re-run diagnostics after a non-finite loss or gradient."""

    def __init__(self, model: torch.nn.Module):
        self.model = model

    @torch.no_grad()
    def check_forward(self, run_forward) -> Optional[str]:
        """Call ``run_forward()`` (a forward of the model, in eval mode as
        the JAX detector runs it) with a hook on every named submodule;
        returns the message naming the first module whose output is
        non-finite, or None."""
        hit: Dict[str, object] = {}

        def hook_for(name):
            def hook(_module, _inputs, out):
                if hit:
                    return
                for t in _tensors(out):
                    if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                        hit["name"], hit["range"] = name, _finite_range(t)
                        return
            return hook

        handles = [m.register_forward_hook(hook_for(name or type(self.model).__name__))
                   for name, m in self.model.named_modules()]
        was_training = self.model.training
        self.model.eval()
        try:
            run_forward()
        finally:
            for h in handles:
                h.remove()
            self.model.train(was_training)
        if not hit:
            return None
        msg = (f"NaN/Inf detected in forward output of {hit['name']}; "
               f"finite-range of tensor: {hit['range']}")
        logger.warning(msg)
        return msg

    def check_grads(self, grads: Dict[str, torch.Tensor]) -> Optional[str]:
        """The first parameter of ``grads`` (in its order) whose gradient
        is non-finite."""
        for name, g in grads.items():
            if not bool(torch.isfinite(g).all()):
                msg = f"NaN/Inf detected in gradient of parameter {name}"
                logger.warning(msg)
                return msg
        return None

    def dump_grad_norms(self, grads: Dict[str, torch.Tensor]) -> None:
        for name, g in grads.items():
            logger.info(f"grad-norm: {name} {float(torch.linalg.vector_norm(g.double())):.6g}")
