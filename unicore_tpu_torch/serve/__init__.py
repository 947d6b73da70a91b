"""The serving plane (counterpart of ``unicore_tpu/serve/``): bucketed
continuous batching, per-request deadlines enforced at admission, batch
formation and response, a bounded admission queue that sheds with named
reasons, and a SIGTERM drain under a deadline.

``unicore_tpu_torch/cli/serve.py`` (``unicore-tpu-torch-serve``) is the
operator entry point.
"""

from unicore_tpu_torch.serve.admission import AdmissionQueue
from unicore_tpu_torch.serve.engine import ServeEngine, build_infer_fn
from unicore_tpu_torch.serve.request import ServeRequest, ServeResponse

__all__ = [
    "AdmissionQueue",
    "ServeEngine",
    "ServeRequest",
    "ServeResponse",
    "build_infer_fn",
]
