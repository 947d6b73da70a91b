"""Command-line options (counterpart of ``unicore_tpu/options.py``: the
serving parser, the training parser and its two-phase
``parse_args_and_arch``)."""

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


def _eval_str_list(x, type=float):
    if x is None:
        return None
    if isinstance(x, str):
        x = [v for v in x.strip("()[] ").split(",") if v.strip()]
    try:
        return [type(v) for v in x]
    except TypeError:
        return [type(x)]


def get_training_parser():
    """Parser for ``unicore-tpu-torch-train``: the JAX CLI's flag names for
    what the port's trainer does.  Task, loss, optimizer, lr-scheduler and
    architecture flags join in :func:`parse_args_and_arch`."""
    from unicore_tpu_torch.losses import LOSS_REGISTRY
    from unicore_tpu_torch.optim import OPTIMIZER_REGISTRY
    from unicore_tpu_torch.optim.lr_scheduler import LR_SCHEDULER_REGISTRY
    from unicore_tpu_torch.tasks import TASK_REGISTRY

    parser = argparse.ArgumentParser(
        description="unicore-tpu-torch-train: train a model on an NVIDIA GPU "
        "(PyTorch/CUDA port of unicore-tpu-train)",
        allow_abbrev=False,
    )
    parser.add_argument("--seed", type=int, default=1, metavar="N",
                        help="seed of the weights, the data order, the "
                             "masking and the dropout")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model trains: 'cuda' (default) needs "
                             "a visible CUDA card and exits non-zero without "
                             "one; 'cpu' runs the kernels' plain versions")
    parser.add_argument("--log-interval", type=int, default=100, metavar="N",
                        help="log progress every N updates")
    parser.add_argument("--log-format", default="simple", choices=["simple"],
                        help="log format")
    parser.add_argument("--task", default="bert", choices=TASK_REGISTRY.keys())
    parser.add_argument("--loss", default="masked_lm", choices=LOSS_REGISTRY.keys())
    parser.add_argument("--optimizer", default="adam",
                        choices=OPTIMIZER_REGISTRY.keys())
    parser.add_argument("--lr-scheduler", default="polynomial_decay",
                        choices=LR_SCHEDULER_REGISTRY.keys())

    group = parser.add_argument_group("dataset_data_loading")
    group.add_argument("--batch-size", "--max-sentences", type=int, metavar="N",
                       help="maximum number of sentences in a batch")
    group.add_argument("--num-workers", default=0, type=int, choices=[0],
                       help="data loader processes: batches load on the "
                            "training thread (only 0)")
    group.add_argument("--train-subset", default="train", metavar="SPLIT",
                       help="data subset to use for training")

    group = parser.add_argument_group("optimization")
    group.add_argument("--max-epoch", default=0, type=int, metavar="N",
                       help="force stop training at specified epoch")
    group.add_argument("--max-update", default=0, type=int, metavar="N",
                       help="force stop training at specified update")
    group.add_argument("--clip-norm", default=0.0, type=float, metavar="NORM",
                       help="clip threshold of gradients")
    group.add_argument("--update-freq", default="1",
                       type=lambda uf: _eval_str_list(uf, type=int),
                       metavar="N1,N2,...,N_K",
                       help="update parameters every N_i batches, when in epoch i")
    group.add_argument("--lr", default="0.25", type=_eval_str_list,
                       metavar="LR_1,LR_2,...,LR_N",
                       help="learning rate for the first N epochs")

    group = parser.add_argument_group("checkpoint")
    group.add_argument("--save-dir", metavar="DIR", default="checkpoints",
                       help="path to save checkpoints")
    group.add_argument("--tmp-save-dir", metavar="DIR", default="./",
                       help="accepted for the JAX CLI's scripts; each "
                            "checkpoint is written to a temporary name in "
                            "--save-dir and renamed into place")
    group.add_argument("--save-interval-updates", type=int, default=0,
                       metavar="N", help="save a checkpoint every N updates")
    group.add_argument("--keep-interval-updates", type=int, default=-1,
                       metavar="N", help="keep the last N interval checkpoints")

    add_model_args(parser)
    return parser


def parse_args_and_arch(parser, input_args=None):
    """Two-phase parse: the first finds the task, loss, optimizer,
    lr-scheduler and architecture; their flags join the parser; the second
    parses everything and the architecture fills its defaults."""
    from unicore_tpu_torch.losses import LOSS_REGISTRY
    from unicore_tpu_torch.models import ARCH_CONFIG_REGISTRY, ARCH_MODEL_REGISTRY
    from unicore_tpu_torch.optim import OPTIMIZER_REGISTRY
    from unicore_tpu_torch.optim.lr_scheduler import LR_SCHEDULER_REGISTRY
    from unicore_tpu_torch.tasks import TASK_REGISTRY

    args, _ = parser.parse_known_args(input_args)
    if getattr(args, "arch", None) is None:
        parser.error("--arch is required")
    ARCH_MODEL_REGISTRY[args.arch].add_args(
        parser.add_argument_group("Model-specific configuration",
                                  argument_default=argparse.SUPPRESS)
    )
    for registry, key in ((TASK_REGISTRY, args.task), (LOSS_REGISTRY, args.loss),
                          (OPTIMIZER_REGISTRY, args.optimizer),
                          (LR_SCHEDULER_REGISTRY, args.lr_scheduler)):
        registry[key].add_args(parser)
    args = parser.parse_args(input_args)
    ARCH_CONFIG_REGISTRY[args.arch](args)
    return args
