#!/usr/bin/env python3
"""``unicore-tpu-torch-serve``: the serving-plane entry point of the
PyTorch/CUDA port (counterpart of ``unicore_tpu_cli/serve.py``).

Boot sequence, each stage with the JAX server's failure exit code:

0. device: ``--device cuda`` (the default) needs a visible CUDA card; without
   one the server exits **76** naming the missing card — it never carries on
   on the CPU.  ``--device cpu`` is the explicit CPU run (the kernels' plain
   versions);
1. model load from ``--path`` (exit **76** on failure);
2. HTTP bind on ``--host:--port`` (exit **75** on failure) — probes go
   live immediately, readiness stays false;
3. bucket warm-up (the CUDA kernels build and load here); readiness flips
   true only after;
4. serve until signalled: SIGTERM/SIGINT drains — admission stops,
   in-flight batches flush under ``--drain-deadline``, exit **0**; a blown
   drain budget exits **77**; a second signal aborts (also 77).

Precision is fp32 end to end, as the JAX server runs at checkpoint
precision: TF32 is switched off for matmuls and convolutions.
"""

import logging
import os
import signal
import sys
import threading
import time

_LOG_FIELDS = ("asctime", "levelname", "name", "message")
logger = logging.getLogger("unicore_tpu_torch.cli.serve")

EXIT_OK = 0
EXIT_SERVE_BIND = 75            # HTTP bind/port failure at startup
EXIT_SERVE_MODEL_LOAD = 76      # device / model load / warm-up failure
EXIT_SERVE_DRAIN_DEADLINE = 77  # drain budget exceeded (or forced abort)

SERVE_EXIT_CODE_NAMES = {
    EXIT_OK: "ok",
    EXIT_SERVE_BIND: "serve-bind-failure",
    EXIT_SERVE_MODEL_LOAD: "serve-model-load-failure",
    EXIT_SERVE_DRAIN_DEADLINE: "serve-drain-deadline-exceeded",
}

# signal plumbing: first signal requests a drain, the second aborts
_drain_requested = threading.Event()
_signal_count = 0


def _handle_signal(signum, frame):
    global _signal_count
    _signal_count += 1
    name = signal.Signals(signum).name
    if _signal_count == 1:
        logger.warning(
            f"received {name}: graceful drain — admission stops, in-flight "
            "batches flush under --drain-deadline (second signal aborts)"
        )
        _drain_requested.set()
    else:
        logger.error(f"received second {name}: aborting without drain")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(EXIT_SERVE_DRAIN_DEADLINE)


def resolve_device(name: str):
    """The torch device for ``--device``; raises RuntimeError naming the
    missing card when ``cuda`` is asked for and none is visible."""
    import torch

    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: no CUDA card is visible to this process "
                "(torch.cuda.is_available() is false); serve on the CPU "
                "only by asking for it with --device cpu"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def load_serving_model(args, device):
    """Checkpoint load + model/task rebuild from the saved args.  Any
    failure here is exit 76 territory — there is nothing to serve."""
    from unicore_tpu_torch import checkpoint_utils, tasks

    state = checkpoint_utils.load_checkpoint_to_cpu(args.path)
    ckpt_args = state.get("args")
    if ckpt_args is None:
        raise ValueError(
            f"checkpoint {args.path} carries no saved args; cannot rebuild "
            "the model"
        )
    if args.data:
        ckpt_args.data = args.data
    weights = state.get("model")
    if weights is None:
        raise ValueError(f"checkpoint {args.path} holds no model weights")
    task = tasks.setup_task(ckpt_args)
    model = task.build_model(ckpt_args)
    model.load_state_dict(weights)
    model = model.to(device).eval()
    pad_idx = task.dictionary.pad()
    vocab_size = len(task.dictionary)
    max_seq_len = int(getattr(ckpt_args, "max_seq_len", 512) or 512)
    logger.info(
        f"serving model from {args.path} (task {type(task).__name__}, "
        f"arch {getattr(ckpt_args, 'arch', '?')}, max_seq_len {max_seq_len}, "
        f"vocab {vocab_size}, device {device})"
    )
    return model, pad_idx, max_seq_len, vocab_size


def serve_buckets(args, max_seq_len):
    from unicore_tpu_torch.data.data_utils import compute_length_buckets

    return compute_length_buckets(args.serve_buckets, max_seq_len) or (
        max_seq_len,
    )


def main(args) -> int:
    import torch

    from unicore_tpu_torch.checkpoint.emergency import Deadline, deadline_scope
    from unicore_tpu_torch.modules import configure_fused_norm
    from unicore_tpu_torch.serve import ServeEngine, build_infer_fn
    from unicore_tpu_torch.serve.http import bind_server

    # fp32 end to end: the JAX server runs at checkpoint precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    configure_fused_norm(args.fused_norm)
    logger.info(args)

    # 0. device ----------------------------------------------------------
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        logger.error(
            f"FATAL: {err} — exiting {EXIT_SERVE_MODEL_LOAD} "
            f"({SERVE_EXIT_CODE_NAMES[EXIT_SERVE_MODEL_LOAD]})"
        )
        return EXIT_SERVE_MODEL_LOAD

    # 1. model load ------------------------------------------------------
    try:
        model, pad_idx, max_seq_len, vocab_size = load_serving_model(
            args, device
        )
        engine = ServeEngine(
            model,
            build_infer_fn(device),
            bucket_edges=serve_buckets(args, max_seq_len),
            batch_size=args.serve_batch_size,
            pad_idx=pad_idx,
            vocab_size=vocab_size,
            admission_capacity=args.admission_capacity,
            device=(
                torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu"
            ),
        )
    except Exception as err:
        logger.error(
            f"FATAL: model load failed ({type(err).__name__}: {err}) — "
            f"exiting {EXIT_SERVE_MODEL_LOAD} "
            f"({SERVE_EXIT_CODE_NAMES[EXIT_SERVE_MODEL_LOAD]})",
            exc_info=True,
        )
        return EXIT_SERVE_MODEL_LOAD

    # 2. bind (probes live, readiness false) -----------------------------
    try:
        server = bind_server(
            args.host, args.port, engine,
            read_timeout_s=args.request_read_timeout,
            default_deadline_ms=args.default_deadline_ms,
            max_deadline_ms=args.max_deadline_ms,
        )
    except OSError as err:
        logger.error(
            f"FATAL: cannot bind {args.host}:{args.port} ({err}) — exiting "
            f"{EXIT_SERVE_BIND} ({SERVE_EXIT_CODE_NAMES[EXIT_SERVE_BIND]})"
        )
        return EXIT_SERVE_BIND
    server.start()

    # 3. warm-up (readiness flips true inside) ---------------------------
    try:
        engine.warmup()
    except Exception as err:
        logger.error(
            f"FATAL: warm-up failed ({type(err).__name__}: {err}) — exiting "
            f"{EXIT_SERVE_MODEL_LOAD} "
            f"({SERVE_EXIT_CODE_NAMES[EXIT_SERVE_MODEL_LOAD]})",
            exc_info=True,
        )
        server.shutdown()
        return EXIT_SERVE_MODEL_LOAD

    # 4. serve -----------------------------------------------------------
    engine.start()
    started = time.monotonic()
    while not _drain_requested.is_set():
        if not engine.healthy():
            logger.error(
                f"FATAL: serve engine loop died "
                f"({type(engine.fatal_error).__name__ if engine.fatal_error else 'thread exit'}: "
                f"{engine.fatal_error}) — exiting 1"
            )
            server.shutdown()
            return 1
        if (
            args.serve_max_seconds > 0
            and time.monotonic() - started >= args.serve_max_seconds
        ):
            logger.info(
                f"--serve-max-seconds ({args.serve_max_seconds:g}s) "
                "reached: starting the graceful drain"
            )
            break
        _drain_requested.wait(timeout=0.2)

    # 5. drain -----------------------------------------------------------
    deadline = Deadline(args.drain_deadline)
    with deadline_scope(deadline):
        drained = engine.drain(deadline)
    server.shutdown()
    logger.info(f"final serve stats: {engine.stats()}")
    if not drained:
        logger.error(
            f"exiting {EXIT_SERVE_DRAIN_DEADLINE} "
            f"({SERVE_EXIT_CODE_NAMES[EXIT_SERVE_DRAIN_DEADLINE]})"
        )
        return EXIT_SERVE_DRAIN_DEADLINE
    logger.info("serve shutdown clean: drained in-flight work, exiting 0")
    return EXIT_OK


def cli_main() -> None:
    logging.basicConfig(
        stream=sys.stdout,
        level=os.environ.get("LOGLEVEL", "INFO").upper(),
        format=" | ".join(f"%({f})s" for f in _LOG_FIELDS),
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    from unicore_tpu_torch import options

    args = options.get_serving_parser().parse_args()
    try:
        signal.signal(signal.SIGTERM, _handle_signal)
        signal.signal(signal.SIGINT, _handle_signal)
    except ValueError:
        logger.warning(
            "could not install signal handlers (not the main thread); "
            "graceful drain is unavailable"
        )
    sys.exit(main(args))


if __name__ == "__main__":
    cli_main()
