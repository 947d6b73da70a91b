"""The serving plane (counterpart of ``unicore_tpu/serve/``): bucketed
continuous batching, per-request deadlines enforced at admission, batch
formation and response, a bounded admission queue that sheds with named
reasons, a SIGTERM drain under a deadline, and hot reload that verifies,
probes and swaps a new checkpoint on a batch boundary or rolls it back
(``reload.py``); and the incremental-decode plane (``decode.py``,
``kv_cache.py``): prefill, a paged KV cache and step-level continuous
batching behind ``POST /v1/generate``; and the replica tier (``fleet/``):
lease-registered replicas behind a shedding router.

``unicore_tpu_torch/cli/serve.py`` (``unicore-tpu-torch-serve``) and
``cli/router.py`` (``unicore-tpu-torch-router``) are the operator entry
points.
"""

from unicore_tpu_torch.serve.admission import AdmissionQueue
from unicore_tpu_torch.serve.decode import DecodeEngine
from unicore_tpu_torch.serve.engine import ServeEngine, build_infer_fn
from unicore_tpu_torch.serve.kv_cache import cache_bucket_edges
from unicore_tpu_torch.serve.reload import CheckpointWatcher, HotReloader, ReloadRunner
from unicore_tpu_torch.serve.request import ServeRequest, ServeResponse

__all__ = [
    "AdmissionQueue",
    "CheckpointWatcher",
    "DecodeEngine",
    "HotReloader",
    "ReloadRunner",
    "ServeEngine",
    "ServeRequest",
    "ServeResponse",
    "build_infer_fn",
    "cache_bucket_edges",
]
