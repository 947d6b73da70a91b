"""Drive one package's train CLI (``jax`` or ``port``) through the telemetry
scenarios of ``tests/test_torch_train_telemetry.py``, in one process:

A. a fresh tiny-BERT run of 8 updates with ``--log-format json``, every
   update's spans sampled, an interval checkpoint at update 4, validation
   beside it, ``--metrics-port``, and ``--fault-inject loss-spike@6`` under
   the health sentinel (one rewind); the port's also with
   ``--tensorboard-logdir`` (the JAX wrapper is held against the port's in
   ``tests/test_torch_logging.py``);
B. ``checkpoint_last.pt`` cut in half, then the same run to update 10: the
   fallback to the newest retained checkpoint and its load.

Usage: ``python torch_telemetry_runs.py {jax|port} DATA OUT METRICS_PORT``.
The log of each run goes to ``OUT/<run>.log``; for the port, every
``/metrics`` scrape made right after a metrics flush goes to
``OUT/scrapes.json``.  The JAX side runs on one CPU device, so both packages
see the same batches.
"""

import json
import logging
import os
import sys

WHICH, DATA, OUT, METRICS_PORT = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
if WHICH == "jax":
    # one CPU device; the least XLA optimisation (the runs compare what is
    # logged and journaled, not the arithmetic's speed)
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=1 "
                               "--xla_backend_optimization_level=0 "
                               "--xla_llvm_disable_expensive_passes=true")
    # the JAX run writes no TensorBoard files: skip importing the writer
    sys.modules["tensorboardX"] = None
    import jax

    jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SENTINEL = ["--sentinel-interval", "1", "--snapshot-interval", "2", "--sentinel-warmup", "4",
            "--loss-spike-zmax", "4", "--loss-spike-window", "8"]


def argv(max_update, *extra):
    a = [DATA, "--task", "bert", "--loss", "masked_lm", "--arch", "bert_tiny",
         "--encoder-layers", "2", "--optimizer", "adam", "--lr", "1e-3", "--batch-size", "4",
         "--max-update", str(max_update), "--log-interval", "2", "--log-format", "json",
         "--save-dir", os.path.join(OUT, "ckpt"), "--num-workers", "0", "--seed", "1",
         "--seq-pad-multiple", "128", "--clip-norm", "1.0", "--save-interval-updates", "4",
         "--telemetry-sample-interval", "1", "--async-checkpoint", "false",
         "--metrics-port", str(METRICS_PORT), *SENTINEL, *extra]
    if WHICH == "jax":
        a += ["--jax-compilation-cache-dir", os.path.join(OUT, "jax_cache")]
    else:
        a += ["--device", "cpu"]
    return a


def run(name, args):
    handler = logging.FileHandler(os.path.join(OUT, f"{name}.log"))
    handler.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(name)s | "
                                           "%(message)s"))
    root = logging.getLogger()
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        if WHICH == "jax":
            from unicore_tpu import telemetry
            from unicore_tpu.modules import layer_norm
            from unicore_tpu_cli.train import cli_main

            # each run starts as a process of its own would: no journal,
            # spans or norm-path notes left from the previous run
            telemetry.reset()
            layer_norm._journaled.clear()
            sys.argv = ["unicore-tpu-train"] + args
            cli_main()
        else:
            from unicore_tpu_torch.cli.train import cli_main

            assert cli_main(args) == 0
    finally:
        root.removeHandler(handler)
        handler.close()


def main():
    os.makedirs(OUT, exist_ok=True)
    scrapes = []
    if WHICH == "port":
        import urllib.request

        from unicore_tpu_torch.trainer import Trainer

        flush = Trainer.flush_metrics

        def flush_and_scrape(self):
            flush(self)
            url = f"http://127.0.0.1:{METRICS_PORT}/metrics"
            with urllib.request.urlopen(url, timeout=10) as r:
                scrapes.append(r.read().decode())

        Trainer.flush_metrics = flush_and_scrape
    tb = ["--tensorboard-logdir", os.path.join(OUT, "tb")] if WHICH == "port" else []
    run("A", argv(8, "--fault-inject", "loss-spike@6", *tb))
    last = os.path.join(OUT, "ckpt", "checkpoint_last.pt")
    size = os.path.getsize(last)
    with open(last, "r+b") as f:  # a torn write
        f.truncate(size // 2)
    run("B", argv(10))
    with open(os.path.join(OUT, "scrapes.json"), "w") as f:
        json.dump(scrapes, f)


if __name__ == "__main__":
    main()
