"""Command-line options (counterpart of ``unicore_tpu/options.py``; this
slice ports the serving parser and ``add_model_args``)."""

import argparse


def get_serving_parser():
    """Parser for ``unicore-tpu-torch-serve``.

    The model architecture, task and dictionary all come from the
    checkpoint's saved args; the operator points at a checkpoint and tunes
    only the serving-plane knobs."""
    parser = argparse.ArgumentParser(
        description="unicore-tpu-torch-serve: continuous-batching inference "
        "server on an NVIDIA GPU (PyTorch/CUDA port of unicore-tpu-serve)",
        allow_abbrev=False,
    )
    add_serving_args(parser)
    return parser


def add_serving_args(parser):
    group = parser.add_argument_group("serving")
    group.add_argument("--path", metavar="FILE", required=True,
                       help="port checkpoint to serve "
                            "(torch.save({'args', 'model'}); the model/task "
                            "config is read from the saved args)")
    group.add_argument("--data", metavar="DIR", default=None,
                       help="override the data dir recorded in the "
                            "checkpoint (the task dictionary loads from "
                            "here)")
    group.add_argument("--host", default="127.0.0.1",
                       help="bind address for the HTTP plane")
    group.add_argument("--port", type=int, default=8693, metavar="N",
                       help="bind port (0 = pick an ephemeral port; the "
                            "chosen port is logged on the 'SERVE "
                            "listening' line)")
    group.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the model runs: 'cuda' (default) needs "
                            "a visible CUDA card and exits non-zero without "
                            "one; 'cpu' runs the kernels' plain versions")
    group.add_argument("--serve-batch-size", type=int, default=8,
                       metavar="N",
                       help="fixed micro-batch rows per dispatched batch "
                            "(short batches are padded with dummy rows)")
    group.add_argument("--serve-buckets", type=int, default=4, metavar="N",
                       help="number of padded sequence-length buckets "
                            "covering the model's --max-seq-len; admission "
                            "sheds requests longer than the largest bucket")
    group.add_argument("--admission-capacity", type=int, default=256,
                       metavar="N",
                       help="bounded admission queue depth; a full queue "
                            "sheds 'queue-full'")
    group.add_argument("--default-deadline-ms", type=float, default=1000.0,
                       metavar="MS",
                       help="per-request deadline when the request body "
                            "carries none; enforced at admission, batch "
                            "formation, and response")
    group.add_argument("--max-deadline-ms", type=float, default=60000.0,
                       metavar="MS",
                       help="ceiling clamped onto client-supplied deadlines")
    group.add_argument("--request-read-timeout", type=float, default=10.0,
                       metavar="SECS",
                       help="budget for reading one request body; a "
                            "client stalling past it gets 408 "
                            "('slow-client')")
    group.add_argument("--drain-deadline", type=float, default=30.0,
                       metavar="SECS",
                       help="SIGTERM graceful-drain budget: stop "
                            "admitting, flush in-flight batches, exit 0; "
                            "exceeding it exits 77")
    group.add_argument("--serve-max-seconds", type=float, default=0.0,
                       metavar="SECS",
                       help="auto-drain and exit after this long "
                            "(0 = serve until signalled)")
    group.add_argument("--seed", type=int, default=1, metavar="N",
                       help="accepted for script compatibility; serving "
                            "is deterministic and consumes no rng")
    group.add_argument("--fused-norm", default="auto",
                       choices=["auto", "on", "off"],
                       help="LayerNorm/RMSNorm path: 'auto' and 'on' run "
                            "the CUDA kernel for CUDA tensors (its plain "
                            "version on the CPU), 'off' the module's plain "
                            "composition")
    return group


def add_model_args(parser):
    group = parser.add_argument_group("Model configuration")
    from unicore_tpu_torch.models import ARCH_MODEL_REGISTRY

    group.add_argument("--arch", "-a", metavar="ARCH",
                       choices=ARCH_MODEL_REGISTRY.keys(),
                       help="model architecture")
    return group
