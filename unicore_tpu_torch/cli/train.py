#!/usr/bin/env python3
"""``unicore-tpu-torch-train``: the training entry point of the PyTorch/CUDA
port (counterpart of ``unicore_tpu_cli/train.py``).

``main`` builds the task, the model (weights from ``--seed``), the loss and
the :class:`Trainer`, loads the train split and runs ``train_epoch`` until
``--max-update`` or ``--max-epoch``; every ``--log-interval`` updates it
logs loss, lr and gnorm.  It writes ``checkpoint_last.pt`` in
``--save-dir`` at the end (and ``checkpoint_{epoch}_{update}.pt`` every
``--save-interval-updates``), a checkpoint ``unicore-tpu-torch-serve``
loads.  The last line it prints is ``TRAIN stats {json}``: updates,
micro-batches and the padded length of each, per-update losses (the
summed loss over the summed sample size, in bits), step times, real
(non-pad) tokens/s (MSA tokens for the Evoformer), samples/s, peak device
memory and the launch count of every kernel.

``--device cuda`` (the default) needs a visible CUDA card and exits 76
naming the missing card; ``--device cpu`` is the explicit CPU run (the
kernels' plain versions).  Precision is fp32 with TF32 off, as the server.
Resuming from a checkpoint is not ported yet.
"""

import json
import logging
import math
import os
import sys
import time

_LOG_FIELDS = ("asctime", "levelname", "name", "message")
logger = logging.getLogger("unicore_tpu_torch.cli.train")

EXIT_NO_DEVICE = 76


def train_epoch(args, trainer, epoch_itr):
    """One epoch of updates; returns True when training should stop."""
    from unicore_tpu_torch.data import iterators
    from unicore_tpu_torch.logging import metrics

    epoch = epoch_itr.next_epoch_idx
    itr = epoch_itr.next_epoch_itr(shuffle=True)
    update_freq = args.update_freq[min(epoch, len(args.update_freq)) - 1]
    itr = iterators.GroupedIterator(itr, update_freq)
    trainer.begin_epoch(epoch)
    max_update = args.max_update or math.inf
    for samples in itr:
        gnorm = trainer.train_step(samples)
        num_updates = trainer.get_num_updates()
        if num_updates % args.log_interval == 0:
            stats = metrics.get_smoothed_values("train_inner")
            logger.info(
                f"epoch {epoch:03d} | update {num_updates} | loss "
                f"{stats['loss']:.3f} | lr {trainer.get_lr():.6g} | gnorm "
                f"{gnorm:.3f} | bsz {stats.get('bsz', 0):.0f} | step "
                f"{trainer.step_ms[-1]:.1f} ms"
            )
            metrics.reset_meters("train_inner")
        if (args.save_interval_updates > 0
                and num_updates % args.save_interval_updates == 0):
            save_interval_checkpoint(args, trainer, epoch_itr, epoch)
        if num_updates >= max_update:
            return True
    stats = metrics.get_smoothed_values("train")
    logger.info(f"end of epoch {epoch}: loss {stats.get('loss', float('nan')):.3f}")
    metrics.reset_meters("train")
    return False


def save_interval_checkpoint(args, trainer, epoch_itr, epoch):
    name = f"checkpoint_{epoch}_{trainer.get_num_updates()}.pt"
    trainer.save_checkpoint(os.path.join(args.save_dir, name), epoch_itr)
    if args.keep_interval_updates > 0:
        kept = sorted(
            (f for f in os.listdir(args.save_dir)
             if f.startswith("checkpoint_") and f != "checkpoint_last.pt"),
            key=lambda f: int(f[:-3].rsplit("_", 1)[1]),
        )
        for old in kept[:-args.keep_interval_updates]:
            os.unlink(os.path.join(args.save_dir, old))


def main(args, device) -> dict:
    import numpy as np
    import torch

    from unicore_tpu_torch import tasks
    from unicore_tpu_torch.logging import metrics
    from unicore_tpu_torch.ops import _kernels
    from unicore_tpu_torch.trainer import Trainer

    assert args.batch_size is not None, "Must specify --batch-size"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    np.random.seed(args.seed)
    metrics.reset()
    os.makedirs(args.save_dir, exist_ok=True)
    logger.info(args)

    task = tasks.setup_task(args)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    model = task.build_model(args, device=device, generator=generator)
    loss = task.build_loss(args)
    trainer = Trainer(args, task, model, loss, device)
    logger.info(
        f"task {type(task).__name__}, model {type(model).__name__} "
        f"({sum(p.numel() for p in model.parameters())} parameters), loss "
        f"{type(loss).__name__}, device {device}"
    )

    task.load_dataset(args.train_subset)
    epoch_itr = trainer.get_train_iterator(epoch=1)
    _kernels.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    started = time.time()
    last_epoch = args.max_epoch or math.inf
    while epoch_itr.next_epoch_idx <= last_epoch:
        if train_epoch(args, trainer, epoch_itr):
            break
        trainer.lr_step(epoch_itr.epoch)
        epoch_itr = trainer.get_train_iterator(epoch_itr.next_epoch_idx)
    wall = time.time() - started
    trainer.save_checkpoint(os.path.join(args.save_dir, "checkpoint_last.pt"),
                            epoch_itr)

    steady = trainer.step_ms[1:] or trainer.step_ms
    stats = {
        "updates": trainer.get_num_updates(),
        "micro_batches": trainer.micro_batches,
        "micro_batch_lengths": trainer.micro_batch_lengths,
        "loss_per_update": trainer.update_losses,
        "step_ms": trainer.step_ms,
        "median_step_ms": float(np.median(steady)),
        "tokens": trainer.tokens,
        "tokens_per_s": trainer.tokens / (sum(trainer.step_ms) / 1e3),
        "samples": trainer.samples,
        "samples_per_s": trainer.samples / (sum(trainer.step_ms) / 1e3),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "kernel_launches": _kernels.launch_counts(),
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "wall_s": wall,
    }
    logger.info(f"done training in {wall:.1f} seconds")
    print("TRAIN stats " + json.dumps(stats), flush=True)
    return stats


def cli_main(argv=None) -> int:
    from unicore_tpu_torch import options
    from unicore_tpu_torch.cli.serve import resolve_device

    logging.basicConfig(
        format=" | ".join(f"%({f})s" for f in _LOG_FIELDS),
        datefmt="%Y-%m-%d %H:%M:%S",
        level=logging.INFO,
        stream=sys.stdout,
    )
    parser = options.get_training_parser()
    args = options.parse_args_and_arch(parser, argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        logger.error(str(err))
        return EXIT_NO_DEVICE
    main(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(cli_main())
