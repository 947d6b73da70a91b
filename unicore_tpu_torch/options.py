"""Command-line options (counterpart of ``unicore_tpu/options.py``: the
serving parser with its fleet group, the fleet router's parser, the
training parser and its two-phase ``parse_args_and_arch``)."""

import argparse

from unicore_tpu_torch.utils import str_to_bool


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
    group.add_argument("--reload-interval", type=float, default=0.0,
                       metavar="SECS",
                       help="hot checkpoint reload: poll --path's "
                            "publish signature this often and "
                            "verify-then-swap new checkpoints on a batch "
                            "boundary, rolling back (and continuing to "
                            "serve the old snapshot) if verification or "
                            "the probe batch fails (0 disables)")
    group.add_argument("--fault-inject", type=str, default=None,
                       metavar="KIND[:PARAM]@STEP",
                       help="serving chaos harness (distributed/chaos.py):"
                            " request-flood[:QPS] (synthetic overload, "
                            "proves named-reason shedding), "
                            "slow-client[:SECS] (one stalled body read, "
                            "proves the bounded read path), "
                            "corrupt-reload (bit rot on the next reload "
                            "candidate, proves verify-then-swap rollback), "
                            "replica-loss@STEP[@IDX] (a fleet replica "
                            "hard-exits 74), replica-stall[:SECS]@STEP[@IDX] "
                            "(its /v1/infer wedges while its lease beats; "
                            "IDX is --replica-index); STEP counts "
                            "dispatched serve batches")
    group.add_argument("--telemetry-dir", metavar="DIR", default=None,
                       help="per-process event journal for serve-plane "
                            "events (sheds, reload outcomes, drains); "
                            "default: the served checkpoint's directory + "
                            "/telemetry.  Merge with unicore-tpu-trace")
    group.add_argument("--seed", type=int, default=1, metavar="N",
                       help="accepted for script compatibility; serving "
                            "is deterministic and consumes no rng")
    group.add_argument("--serve-quantize", default="off",
                       choices=["off", "int8", "fp8"],
                       help="post-training quantized inference: a startup "
                            "calibration pass runs deterministic held-out "
                            "batches through every bucket geometry, captures "
                            "per-channel weight + per-site activation scales "
                            "(persisted beside the checkpoint, digest-tied to "
                            "its weights), and serves the int8 kernels (or "
                            "fp8-rounded weights and activations in plain "
                            "torch) with the dequant fused into the consuming "
                            "ops")
    group.add_argument("--calibration-batches", type=int, default=1,
                       metavar="N",
                       help="calibration rounds per bucket edge (more "
                            "rounds widen the observed activation range; "
                            "scales stay a pure function of the weights "
                            "and the fixed-seed stream)")
    group.add_argument("--quant-drift-sample", type=int, default=64,
                       metavar="N",
                       help="with --serve-quantize: every N-th dispatched "
                            "batch is re-run through the full-precision "
                            "model and the per-request max |logit drift| "
                            "lands in /stats (0 disables the shadow check "
                            "and frees the fp32 model after calibration)")
    group.add_argument("--fused-norm", default="auto",
                       choices=["auto", "on", "off"],
                       help="LayerNorm/RMSNorm path: 'auto' and 'on' run "
                            "the CUDA kernel for CUDA tensors (its plain "
                            "version on the CPU), 'off' the module's plain "
                            "composition")
    decode = parser.add_argument_group(
        "incremental decode (POST /v1/generate)"
    )
    decode.add_argument("--serve-decode", default="auto",
                        choices=["auto", "on", "off"],
                        help="serve autoregressive generation (POST "
                             "/v1/generate) through the paged-KV decode "
                             "engine: 'auto' enables it when the "
                             "checkpoint's model has a decode surface "
                             "(prefill/decode_step, e.g. transformer_lm), "
                             "'on' requires one, 'off' serves the plain "
                             "encoder path")
    decode.add_argument("--decode-batch-size", type=int, default=8,
                        metavar="N",
                        help="decode-step batch rows; sequences re-enter "
                             "the scheduler after EVERY step, so batches "
                             "re-form per step (continuous batching) and "
                             "a finished sequence frees its slot "
                             "mid-generation")
    decode.add_argument("--cache-pages", type=int, default=512, metavar="N",
                        help="paged KV-cache pool size: memory is bounded "
                             "by pages x page-size TOKENS in flight, not by "
                             "max-seq-len x batch; exhaustion preempts the "
                             "youngest generation (it re-prefills later) "
                             "and sheds 'cache-oom' at admission")
    decode.add_argument("--cache-page-size", type=int, default=32,
                        metavar="N",
                        help="rows per KV-cache page; every cache-length "
                             "bucket is a page multiple")
    decode.add_argument("--decode-kv", default="fp32",
                        choices=["fp32", "int8"],
                        help="KV-cache precision: int8 stores quantized "
                             "K/V against static per-(layer, head, "
                             "channel) scales from a startup calibration "
                             "prefill, with the dequant fused into the "
                             "attention read")
    decode.add_argument("--max-new-tokens", type=int, default=32,
                        metavar="N",
                        help="generation ceiling per request (clients may "
                             "ask for fewer via 'max_new_tokens'); "
                             "generation also stops at EOS or the top "
                             "cache bucket")
    decode.add_argument("--decode-sample-every", type=int, default=64,
                        metavar="N",
                        help="log every N-th decode step (bucket, live "
                             "rows, service ms, page occupancy; 0 "
                             "disables)")
    fleet = parser.add_argument_group("fleet membership")
    fleet.add_argument("--advertise", metavar="ADDR", default=None,
                       help="join a serving fleet: publish a heartbeat "
                            "lease (address, readiness, snapshot digest, "
                            "/stats admission estimate) to --fleet-kv "
                            "every --fleet-interval.  'auto' advertises "
                            "http://<--host>:<bound port>; otherwise give "
                            "the address the ROUTER should dial (e.g. "
                            "http://10.0.0.7:8693).  Also enables POST "
                            "/v1/reload for the router's rolling reload")
    fleet.add_argument("--fleet-kv", metavar="DIR", default=None,
                       help="fleet coordination KV root (a directory "
                            "shared with the router; required with "
                            "--advertise); an unusable root exits 78")
    fleet.add_argument("--replica-name", metavar="NAME", default=None,
                       help="stable replica identity in leases, verdicts "
                            "and journals ([A-Za-z0-9._-]+; default "
                            "r<replica-index>)")
    fleet.add_argument("--replica-index", type=int, default=0,
                       metavar="N",
                       help="this replica's index (default replica name, "
                            "journal rank, and the @IDX target of the "
                            "replica-loss/replica-stall chaos kinds)")
    fleet.add_argument("--fleet-interval", type=float, default=2.0,
                       metavar="SECS",
                       help="lease publish cadence; readiness flips also "
                            "publish immediately (the drain handshake "
                            "never waits out the interval)")
    return group


def get_router_parser():
    """Parser for ``unicore-tpu-torch-router`` (``cli/router.py``): the JAX
    router's flags and defaults."""
    parser = argparse.ArgumentParser(
        description="unicore-tpu-torch-router: shedding fleet router over "
        "lease-registered unicore-tpu-torch-serve replicas (PyTorch/CUDA "
        "port of unicore-tpu-router)",
        allow_abbrev=False,
    )
    add_router_args(parser)
    return parser


def add_router_args(parser):
    group = parser.add_argument_group("router")
    group.add_argument("--fleet-kv", metavar="DIR", required=True,
                       help="fleet coordination KV root (the directory "
                            "replicas --advertise into); unusable root "
                            "exits 78")
    group.add_argument("--host", default="127.0.0.1",
                       help="bind address for the router HTTP plane")
    group.add_argument("--port", type=int, default=8793, metavar="N",
                       help="bind port (0 = ephemeral, logged on the "
                            "'ROUTER listening' line)")
    group.add_argument("--fleet-interval", type=float, default=2.0,
                       metavar="SECS",
                       help="membership lease-round cadence")
    group.add_argument("--fleet-timeout", type=float, default=10.0,
                       metavar="SECS",
                       help="service-confirmed silence after which a "
                            "replica's lease expires into a named "
                            "replica-loss verdict (a KV outage FREEZES "
                            "these clocks — it never mints verdicts)")
    group.add_argument("--retry-budget", type=int, default=2, metavar="N",
                       help="re-route attempts per request on connect "
                            "failure / replica 5xx (never after the "
                            "request body streamed to a replica)")
    group.add_argument("--default-deadline-ms", type=float, default=1000.0,
                       metavar="MS",
                       help="per-request deadline when the body carries "
                            "none; carried end-to-end — proxy leg socket "
                            "timeout AND the downstream deadline_ms are "
                            "the remaining budget")
    group.add_argument("--max-deadline-ms", type=float, default=60000.0,
                       metavar="MS",
                       help="ceiling clamped onto client deadlines")
    group.add_argument("--request-read-timeout", type=float, default=10.0,
                       metavar="SECS",
                       help="budget for reading one request body (slow "
                            "clients get 408, never a wedged worker)")
    group.add_argument("--path", metavar="FILE", default=None,
                       help="with --reload-interval: the published "
                            "checkpoint to watch for ROLLING fleet "
                            "reload (one replica at a time, halt on "
                            "first RELOAD ROLLBACK)")
    group.add_argument("--reload-interval", type=float, default=0.0,
                       metavar="SECS",
                       help="poll --path's publish signature this often "
                            "and roll new candidates across the fleet "
                            "(0 disables)")
    group.add_argument("--reload-timeout", type=float, default=300.0,
                       metavar="SECS",
                       help="budget for ONE replica's verify→probe→swap "
                            "during a roll; outrunning it halts the "
                            "roll like a rollback")
    group.add_argument("--max-seconds", type=float, default=0.0,
                       metavar="SECS",
                       help="exit cleanly after this long (0 = run until "
                            "signalled)")
    group.add_argument("--telemetry-dir", metavar="DIR", default=None,
                       help="router event journal (fleet-verdict / "
                            "router-shed / router-retry / fleet-reload "
                            "kinds); default: <--fleet-kv>/telemetry — "
                            "point replicas at the same directory and the "
                            "JAX package's unicore-tpu-trace merges the "
                            "whole fleet")
    group.add_argument("--fault-inject", type=str, default=None,
                       metavar="KIND[:PARAM]@STEP",
                       help="chaos harness (the replica kinds arm on the "
                            "REPLICAS, not here; kv-outage, which proves "
                            "the membership freeze, waits for the rest "
                            "of the parallelism queue)")
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
    parser.add_argument("--cpu", action="store_true",
                        help="the JAX CLI's spelling of --device cpu")
    parser.add_argument("--no-progress-bar", action="store_true", help="disable progress bar")
    parser.add_argument("--log-interval", type=int, default=100, metavar="N",
                        help="log progress every N batches (when progress bar is disabled)")
    parser.add_argument("--log-format", default=None, help="log format to use",
                        choices=["json", "none", "simple", "tqdm"])
    parser.add_argument("--tensorboard-logdir", metavar="DIR", default="",
                        help="path to save logs for tensorboard")
    parser.add_argument("--wandb-project", metavar="WANDB", default="",
                        help="name of wandb project (empty = no wandb logging)")
    parser.add_argument("--wandb-name", metavar="WANDBNAME", default="",
                        help="wandb run name")
    parser.add_argument("--profile", action="store_true",
                        help="enable torch.profiler trace collection during training "
                             "(the whole run, into <save-dir>/torch_trace/)")
    parser.add_argument("--task", default="bert", choices=TASK_REGISTRY.keys())
    parser.add_argument("--loss", default="masked_lm", choices=LOSS_REGISTRY.keys())
    parser.add_argument("--optimizer", default="adam",
                        choices=OPTIMIZER_REGISTRY.keys())
    parser.add_argument("--lr-scheduler", default="fixed",
                        choices=LR_SCHEDULER_REGISTRY.keys())
    parser.add_argument("--ema-decay", default=-1.0, type=float,
                        help="enable moving average for model parameters")
    parser.add_argument("--validate-with-ema", action="store_true")
    parser.add_argument("--nan-rerun", action="store_true",
                        help="check for non-finite gradients after every "
                             "update (costs one host sync per step) and, on "
                             "detection, re-run the batch under the NaN "
                             "detector to name the first bad module before "
                             "aborting")

    group = parser.add_argument_group("precision")
    group.add_argument("--fp16", action="store_true",
                       help="parameters and activations in fp16, an fp32 master "
                            "copy in the optimizer, dynamic loss scaling")
    group.add_argument("--bf16", action="store_true",
                       help="parameters and activations in bf16, an fp32 master "
                            "copy in the optimizer (wins over --fp16)")
    group.add_argument("--bf16-sr", action="store_true",
                       help="use stochastic rounding on the fp32-master -> bf16 "
                            "param copy-back")
    group.add_argument("--allreduce-fp32-grad", action="store_true",
                       help="accumulate gradients in fp32 (always done: "
                            "accepted for the JAX CLI's scripts)")
    group.add_argument("--fp16-init-scale", default=2 ** 7, type=int,
                       help="default FP16 loss scale")
    group.add_argument("--fp16-scale-window", type=int, default=None,
                       help="number of updates before increasing loss scale "
                            "(default 2**14)")
    group.add_argument("--fp16-scale-tolerance", default=0.0, type=float,
                       help="pct of updates that can overflow before "
                            "decreasing the loss scale")
    group.add_argument("--min-loss-scale", default=1e-4, type=float, metavar="D",
                       help="minimum FP16 loss scale, after which training is "
                            "stopped")
    group.add_argument("--threshold-loss-scale", type=float,
                       help="threshold FP16 loss scale from below")

    group = parser.add_argument_group("dataset_data_loading")
    group.add_argument("--batch-size", "--max-sentences", type=int, metavar="N",
                       help="maximum number of sentences in a batch")
    group.add_argument("--num-workers", default=1, type=int, metavar="N",
                       help="how many threads load and collate batches (0: "
                            "the training thread)")
    group.add_argument("--data-buffer-size", default=10, type=int, metavar="N",
                       help="number of batches the host-side buffered loader "
                            "preloads (device read-ahead is --prefetch-depth)")
    group.add_argument("--prefetch-depth", default=2, type=int, metavar="N",
                       help="device read-ahead depth for --prefetch-to-device: "
                            "how many fully-prepared updates may sit in device "
                            "memory ahead of the consumer")
    group.add_argument("--prefetch-to-device", action="store_true",
                       help="double-buffered device prefetch "
                            "(data/prefetch.py): a producer thread collates "
                            "and counts update N+1's micro-batches and "
                            "issues the pinned host->device copy on a side "
                            "stream while update N computes.  The first "
                            "update of each epoch is synchronous")
    group.add_argument("--data-stall-timeout", default=0.0, type=float,
                       metavar="SECS",
                       help="escalate the data-pipeline starvation warning: "
                            "if the prefetch producer delivers nothing for "
                            "this many seconds, raise a diagnosable error "
                            "naming the dataset/epoch position instead of "
                            "warning forever (0 disables)")
    group.add_argument("--length-bucket", default=0, type=int, metavar="N",
                       help="pad each batch's sequence length up into a "
                            "fixed set of at most N lengths covering "
                            "--max-seq-len (evenly spaced, rounded to the "
                            "pad multiple; 0 disables)")
    group.add_argument("--train-subset", default="train", metavar="SPLIT",
                       help="data subset to use for training")
    group.add_argument("--valid-subset", default="valid", metavar="SPLIT",
                       help="comma separated list of data subsets to use for "
                            "validation; a subset with no data on disk is "
                            "skipped with a warning")
    group.add_argument("--validate-interval", type=int, default=1, metavar="N",
                       help="validate every N epochs")
    group.add_argument("--validate-interval-updates", type=int, default=0,
                       metavar="N", help="validate every N updates")
    group.add_argument("--validate-after-updates", type=int, default=0, metavar="N",
                       help="dont validate until reaching this many updates")
    group.add_argument("--disable-validation", action="store_true",
                       help="disable validation")
    group.add_argument("--batch-size-valid", type=int, metavar="N",
                       help="maximum number of sentences in a validation "
                            "batch (default: --batch-size)")
    group.add_argument("--max-valid-steps", "--nval", type=int, metavar="N",
                       help="How many batches to evaluate")
    group.add_argument("--curriculum", default=0, type=int, metavar="N",
                       help="don't shuffle batches for first N epochs")

    group = parser.add_argument_group("optimization")
    group.add_argument("--max-epoch", default=0, type=int, metavar="N",
                       help="force stop training at specified epoch")
    group.add_argument("--max-update", default=0, type=int, metavar="N",
                       help="force stop training at specified update")
    group.add_argument("--stop-time-hours", default=0, type=float, metavar="N",
                       help="force stop training after specified cumulative time")
    group.add_argument("--stop-min-lr", default=-1, type=float, metavar="LR",
                       help="stop training when the learning rate reaches "
                            "this minimum")
    group.add_argument("--clip-norm", default=0.0, type=float, metavar="NORM",
                       help="clip threshold of gradients")
    group.add_argument("--per-sample-clip-norm", default=0.0, type=float,
                       metavar="PNORM",
                       help="clip threshold of gradients, before gradient sync "
                            "over workers (each row of a micro-batch runs its "
                            "own batch-1 forward and backward)")
    group.add_argument("--grad-accum", default="buffer", choices=["buffer", "adama"],
                       help="gradient-accumulation strategy for --update-freq "
                            "> 1: 'buffer' carries a full fp32 gradient buffer "
                            "across the micro-batches; 'adama' (arXiv "
                            "2305.19982) folds each micro-batch's gradient "
                            "straight into Adam's moment accumulators.  "
                            "Overflow contract: a non-finite micro-batch skips "
                            "the update and leaves the moments as they were")
    group.add_argument("--update-freq", default="1",
                       type=lambda uf: _eval_str_list(uf, type=int),
                       metavar="N1,N2,...,N_K",
                       help="update parameters every N_i batches, when in epoch i")
    group.add_argument("--lr", default="0.25", type=_eval_str_list,
                       metavar="LR_1,LR_2,...,LR_N",
                       help="learning rate for the first N epochs")
    group.add_argument("--remat-policy", default=None,
                       choices=["none", "all", "dots", "save-anything-pjit"],
                       help="activation rematerialisation: accepted for the "
                            "JAX CLI's scripts; only 'none' is ported")

    add_distributed_training_args(parser)

    group = parser.add_argument_group("checkpoint")
    group.add_argument("--save-dir", metavar="DIR", default="checkpoints",
                       help="path to save checkpoints")
    group.add_argument("--tmp-save-dir", metavar="DIR", default=None,
                       help="fast local dir to write checkpoints in before "
                            "they are published to --save-dir (default: "
                            "--save-dir itself; the JAX CLI's ./ would stage "
                            "in the working directory, where runs collide)")
    group.add_argument("--restore-file", default="checkpoint_last.pt",
                       help="filename from which to load checkpoint")
    group.add_argument("--finetune-from-model", default=None, type=str,
                       help="finetune from a pretrained model; resets "
                            "optimizer, lr scheduler, meters and dataloader")
    group.add_argument("--load-from-ema", action="store_true",
                       help="initialize model params from the EMA state in "
                            "the checkpoint")
    group.add_argument("--reset-dataloader", action="store_true",
                       help="don't restore the dataloader position from the "
                            "checkpoint")
    group.add_argument("--reset-lr-scheduler", action="store_true",
                       help="don't restore lr scheduler state from the "
                            "checkpoint")
    group.add_argument("--reset-meters", action="store_true",
                       help="don't restore metrics meters from the checkpoint")
    group.add_argument("--reset-optimizer", action="store_true",
                       help="don't restore optimizer state from the checkpoint")
    group.add_argument("--optimizer-overrides", default="{}", type=str,
                       metavar="DICT",
                       help="a dictionary used to override optimizer args "
                            "when loading a checkpoint")
    group.add_argument("--save-interval", type=int, default=1, metavar="N",
                       help="save a checkpoint every N epochs")
    group.add_argument("--save-interval-updates", type=int, default=0,
                       metavar="N",
                       help="save a checkpoint (and validate) every N updates")
    group.add_argument("--keep-interval-updates", type=int, default=-1,
                       metavar="N",
                       help="keep the last N checkpoints saved with "
                            "--save-interval-updates")
    group.add_argument("--keep-last-epochs", type=int, default=-1, metavar="N",
                       help="keep last N epoch checkpoints")
    group.add_argument("--keep-best-checkpoints", type=int, default=-1,
                       metavar="N", help="keep best N checkpoints based on scores")
    group.add_argument("--no-save", action="store_true",
                       help="don't save models or checkpoints")
    group.add_argument("--no-epoch-checkpoints", action="store_true",
                       help="only store last and best checkpoints")
    group.add_argument("--no-last-checkpoints", action="store_true",
                       help="don't store last checkpoints")
    group.add_argument("--no-save-optimizer-state", action="store_true",
                       help="don't save optimizer-state as part of checkpoint")
    group.add_argument("--best-checkpoint-metric", type=str, default="loss",
                       help='metric to use for saving "best" checkpoints')
    group.add_argument("--maximize-best-checkpoint-metric", action="store_true",
                       help='select the largest metric value for saving "best" '
                            "checkpoints")
    group.add_argument("--patience", type=int, default=-1, metavar="N",
                       help="early stop training if valid performance doesn't "
                            "improve for N consecutive validation runs")
    group.add_argument("--checkpoint-suffix", type=str, default="",
                       help="suffix to add to the checkpoint file name")
    group.add_argument("--async-checkpoint", type=str_to_bool, default=True,
                       help="publish checkpoints under their other names (and "
                            "prune) on a background thread")
    group.add_argument("--checkpoint-format", default="pickle",
                       choices=["pickle", "orbax"],
                       help="pickle: one file per checkpoint (the port's "
                            "torch.save payload); orbax (the JAX package's "
                            "sharded tensorstore checkpoints) is not ported "
                            "and is refused")
    group.add_argument("--checkpoint-write-version", type=int, default=2,
                       choices=[1, 2],
                       help="on-disk envelope of checkpoint writes: 2 "
                            "(default) wraps the torch.save payload in a "
                            "header (step, suffix) and a chunked CRC32 "
                            "integrity manifest verified before any load "
                            "trusts the payload; 1 writes a bare torch.save "
                            "file.  Both versions always READ back")
    group.add_argument("--verify-checkpoint-writes", action="store_true",
                       help="re-open and CRC-verify every staged checkpoint "
                            "write against its integrity manifest before "
                            "publishing it — catches storage that "
                            "acknowledges writes it corrupted, at the cost "
                            "of one extra read pass per save")
    group.add_argument("--on-save-failure", choices=["warn", "abort"], default="warn",
                       help="escalation for a TERMINAL checkpoint-save "
                            "failure (retries exhausted, ENOSPC, failed "
                            "read-back verification): 'warn' logs and "
                            "trains on without a fresh checkpoint; 'abort' "
                            "raises CheckpointWriteError into the training "
                            "loop")
    group.add_argument("--preemption-save-deadline", type=float, default=0.0,
                       metavar="SECS",
                       help="time budget for the SIGTERM/SIGINT graceful-"
                            "stop checkpoint: when set, preemption writes a "
                            "MINIMAL fsync'd checkpoint_last straight into "
                            "--save-dir (no publish copies, no best-score "
                            "bookkeeping, no retention pruning, no retries, "
                            "no read-back verification) and warns loudly if "
                            "even that exceeded the budget (0 keeps the "
                            "full save path on preemption)")
    group.add_argument("--emergency-save-on-error", action="store_true",
                       help="on a fatal trainer exception, attempt a minimal "
                            "emergency save to a SEPARATE "
                            "checkpoint_emergency.pt before re-raising — "
                            "never clobbers checkpoint_last and is never "
                            "auto-resumed")
    group.add_argument("--fault-inject", type=str, default=None,
                       metavar="KIND[:PARAM]@STEP[@RANK]",
                       help="chaos harness (distributed/chaos.py), training "
                            "and checkpoint-storage kinds: "
                            "truncate-checkpoint, bit-flip-checkpoint[:N], "
                            "disk-full, slow-disk[:SECS] from STEP on; raise "
                            "at STEP; loss-spike[:MAGNITUDE] and "
                            "grad-explosion[:SCALE] at exactly STEP (once), "
                            "to prove the health sentinel detects, rewinds "
                            "and heals")

    add_training_health_args(parser)
    add_telemetry_args(parser)
    add_model_args(parser)
    return parser


def add_telemetry_args(parser):
    """The training telemetry plane (``telemetry/``, the JAX package's
    ``add_telemetry_args``): the per-process JSONL event journal, step-time
    spans, the Prometheus export and on-demand profiling."""
    group = parser.add_argument_group("telemetry")
    group.add_argument("--telemetry-dir", metavar="DIR", default=None,
                       help="where the per-process event journals "
                            "(events_rank<r>.jsonl) and profiler traces "
                            "land (default: <save-dir>/telemetry); merge "
                            "them with unicore-tpu-torch-trace")
    group.add_argument("--telemetry-sample-interval", type=int, default=0,
                       metavar="N",
                       help="sample step-time spans every N updates: the "
                            "sampled update journals its data_wait/"
                            "plan_exchange/h2d/dispatch spans and runs the "
                            "lag-1 device_busy probe (ONE synchronize on the "
                            "PREVIOUS sampled update's CUDA event -- unsampled "
                            "updates make zero sync calls; 0 disables the "
                            "probe, host spans still feed the host_blocked "
                            "metric)")
    group.add_argument("--metrics-port", type=int, default=0, metavar="N",
                       help="trainer-side Prometheus /metrics port "
                            "(text exposition refreshed once per "
                            "--log-interval; 0 disables).  The serve plane "
                            "always exposes /metrics on its own HTTP port")
    group.add_argument("--profile-steps", type=str, default=None,
                       metavar="START:END",
                       help="programmatic torch.profiler capture window: "
                            "each process traces updates START..END into "
                            "<telemetry-dir>/profile_rank<r>/ and journals "
                            "profile-start/profile-stop events (bounded "
                            "alternative to whole-run --profile)")
    return group


def add_distributed_training_args(parser):
    """Data-parallel training over ``torch.distributed`` (the JAX CLI's
    group, ``unicore_tpu/options.py`` ``add_distributed_training_args``):
    one process per rank, ``--batch-size`` per rank."""
    group = parser.add_argument_group("distributed_training")
    group.add_argument("--distributed-world-size", type=int, default=1, metavar="N",
                       help="data-parallel ranks, one process each; the train "
                            "CLI spawns them unless --distributed-no-spawn is "
                            "set or a launcher (torchrun) set RANK/WORLD_SIZE")
    group.add_argument("--distributed-rank", default=0, type=int,
                       help="rank of this process (set by the spawn or the "
                            "launcher)")
    group.add_argument("--distributed-backend", default="xla",
                       choices=["xla", "nccl", "gloo"],
                       help="collectives backend: 'nccl' (one card a rank) or "
                            "'gloo' (the CPU; also several ranks on one card, "
                            "staged through host memory); the JAX CLI's "
                            "default 'xla' means nccl with --device cuda and "
                            "gloo with --device cpu")
    group.add_argument("--distributed-init-method", default=None, type=str,
                       help="rendezvous address of the process group "
                            "(tcp://host:port); inferred from MASTER_ADDR / "
                            "MASTER_PORT or --distributed-port when unset.  "
                            "Given at world size 1, the run still forms a "
                            "one-rank group and reduces through it")
    group.add_argument("--distributed-port", default=-1, type=int,
                       help="rendezvous port on localhost (-1: a free one "
                            "when the CLI spawns the ranks)")
    group.add_argument("--device-id", "--local_rank", default=0, type=int,
                       help="process index on this host (set by the spawn or "
                            "from LOCAL_RANK)")
    group.add_argument("--distributed-no-spawn", action="store_true",
                       help="do not spawn --distributed-world-size processes: "
                            "this process is one rank of a group formed by "
                            "--distributed-init-method and --distributed-rank")
    group.add_argument("--ddp-backend", default="c10d", type=str,
                       choices=["c10d", "apex", "no_c10d", "legacy_ddp"],
                       help="accepted for the JAX CLI's scripts: the port "
                            "reduces the flat gradient buffers itself")
    group.add_argument("--data-parallel-size", type=int, default=-1, metavar="N",
                       help="in-pod data-parallel ranks (-1: every rank not "
                            "taken by --num-pods)")
    group.add_argument("--num-pods", type=int, default=1, metavar="N",
                       help="the outer (DCN) tier of the data-parallel ranks: "
                            "with N > 1 the gradient reduction is two-level, "
                            "a reduce-scatter inside each pod, the "
                            "--xpod-combine across pods on 1/pod_size of the "
                            "bytes, an all-gather inside the pod")
    group.add_argument("--xpod-combine", default="sum", choices=["sum", "adasum"],
                       help="cross-pod gradient combine when --num-pods > 1: "
                            "'sum' (bit-identical to the flat all-reduce at "
                            "pod_size 1) or 'adasum' (arXiv 2006.02924)")
    group.add_argument("--deterministic-reductions", action="store_true",
                       help="the two-level reduction gathers and folds in rank "
                            "order inside a pod and in pod-index order across "
                            "pods, instead of the backend's reduction order")
    group.add_argument("--zero-stage", type=int, default=0, choices=[0, 1, 2, 3],
                       metavar="N",
                       help="ZeRO optimizer-state sharding: only 0 is ported "
                            "(ROADMAP A.4)")
    group.add_argument("--zero-shard-optimizer", action="store_true",
                       help="alias for --zero-stage 1: not ported (ROADMAP A.4)")
    group.add_argument("--model-parallel-size", type=int, default=1, metavar="N",
                       help="tensor-parallel shards: accepted for the JAX "
                            "CLI's scripts; only 1 is ported")
    group.add_argument("--expert-parallel-size", type=int, default=1, metavar="N",
                       help="expert-parallel shards: accepted for the JAX "
                            "CLI's scripts; only 1 is ported")
    group.add_argument("--pipeline-parallel-size", type=int, default=1, metavar="N",
                       help="pipeline stages: accepted for the JAX CLI's "
                            "scripts; only 1 is ported")
    group.add_argument("--seq-parallel-size", type=int, default=1, metavar="N",
                       help="sequence-parallel shards: accepted for the JAX "
                            "CLI's scripts; only 1 is ported")
    return group


def add_training_health_args(parser):
    """The training-health sentinel (``health/``): loss-spike /
    grad-explosion / loss-scale-collapse detection with an in-memory rewind
    and a data skip-ahead (the JAX package's flags and defaults)."""
    group = parser.add_argument_group("training_health")
    group.add_argument("--sentinel-interval", type=int, default=0, metavar="N",
                       help="observe the per-update training metrics (loss, "
                            "grad norm, loss scale) every N updates and arm "
                            "the health sentinel's detect-rewind-skip "
                            "recovery ladder (0 disables the sentinel "
                            "entirely)")
    group.add_argument("--snapshot-interval", type=int, default=200, metavar="N",
                       help="updates between host-RAM rewind snapshots of "
                            "the full train state (params, optimizer, EMA, "
                            "scalars); each is one device->host copy on a "
                            "side stream (0 disables snapshots — an anomaly "
                            "then escalates straight to abort)")
    group.add_argument("--snapshot-keep", type=int, default=2, metavar="K",
                       help="host-RAM snapshot ring size (oldest evicted "
                            "first); pinned RAM cost is K x the train state")
    group.add_argument("--sentinel-warmup", type=int, default=50, metavar="N",
                       help="grace period: no anomaly is ever flagged in "
                            "the first N updates")
    group.add_argument("--loss-spike-zmax", type=float, default=6.0, metavar="Z",
                       help="flag a loss sitting more than Z standard "
                            "deviations above its EMA band as a spike")
    group.add_argument("--loss-spike-window", type=int, default=64, metavar="N",
                       help="EMA window (in observations) for the loss and "
                            "grad-norm streaming statistics")
    group.add_argument("--gnorm-explosion-factor", type=float, default=10.0,
                       metavar="F",
                       help="flag a pre-clip grad norm above F times its "
                            "EMA mean as an explosion")
    group.add_argument("--scale-collapse-halvings", type=int, default=8, metavar="N",
                       help="fp16 only: flag N consecutive downward loss-"
                            "scale rescales with no recovery in between as "
                            "a collapse")
    group.add_argument("--spike-skip-updates", type=int, default=2, metavar="N",
                       help="after a rewind, fast-forward the data iterator "
                            "N update chunks past the offending window (the "
                            "stall budget is relaxed x10 for the skip)")
    group.add_argument("--spike-cooldown-updates", type=int, default=100, metavar="N",
                       help="a repeat anomaly within N updates of the last "
                            "rewind escalates to rewind + lr cooldown for N "
                            "updates; a clean cooldown de-escalates the "
                            "ladder")
    group.add_argument("--spike-cooldown-factor", type=float, default=0.1, metavar="F",
                       help="lr multiplier applied during a post-rewind "
                            "cooldown window")
    group.add_argument("--max-rewinds", type=int, default=3, metavar="N",
                       help="abort with a diagnosis (detector, step, "
                            "statistic) once N rewinds have been spent "
                            "without the run stabilizing")
    return group


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
    if getattr(args, "checkpoint_format", "pickle") == "orbax":
        parser.error("--checkpoint-format orbax (the JAX package's sharded tensorstore "
                     "checkpoints) is not ported: unicore_tpu_torch writes one file "
                     "per checkpoint (--checkpoint-format pickle)")
    if getattr(args, "batch_size_valid", None) is None and hasattr(args, "batch_size"):
        args.batch_size_valid = args.batch_size
    if getattr(args, "memory_efficient_fp16", False):
        args.fp16 = True
    if getattr(args, "cpu", False):
        args.device = "cpu"
    ARCH_CONFIG_REGISTRY[args.arch](args)
    return args
