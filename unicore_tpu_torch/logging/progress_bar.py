"""Training progress emitters (counterpart of
``unicore_tpu/logging/progress_bar.py``): tqdm / plain log lines / JSON
lines / silent, with an optional TensorBoard (and Weights & Biases) sink.

The ``progress_bar(...)`` factory and the ``log`` / ``print`` /
``update_config`` protocol the train CLI drives are the JAX package's, and
so is every line they write: the same stats give the same ``json`` and
``simple`` lines in both packages.  One emitter base owns the iteration
bookkeeping and the stat formatting; the text emitters differ only in their
render function; the external sinks live in a stacking wrapper.

The optional packages are imported at first use, never at import time:
``tqdm`` when a tqdm bar is built (off a TTY the factory demotes tqdm to
simple lines), the TensorBoard writer when a wrapper first writes.  The
writer is ``tensorboardX.SummaryWriter``, else
``torch.utils.tensorboard.SummaryWriter``: importing the latter loads
TensorFlow where it is installed (about 16 s on a CPU test worker, against
about 5 s for ``tensorboardX``), and the event files are the same format.
Without either the wrapper warns once, with the JAX package's text, and the
text emitter carries on alone; ``--wandb-project`` without ``wandb`` warns
as the JAX package does and adds no sink.
"""

import atexit
import json
import logging
import os
import sys
from collections import OrderedDict
from contextlib import contextmanager
from numbers import Number
from typing import Optional

from .meters import AverageMeter, StopwatchMeter, TimeMeter

logger = logging.getLogger(__name__)


def progress_bar(
    iterator,
    log_format: Optional[str] = None,
    log_interval: int = 100,
    epoch: Optional[int] = None,
    prefix: Optional[str] = None,
    tensorboard_logdir: Optional[str] = None,
    default_log_format: str = "tqdm",
    wandb_project: Optional[str] = None,
    wandb_name: Optional[str] = None,
):
    """Build the progress emitter the CLI asked for; non-TTY stderr demotes
    tqdm to plain log lines."""
    fmt = log_format or default_log_format
    if fmt == "tqdm" and not sys.stderr.isatty():
        fmt = "simple"
    try:
        cls = {
            "tqdm": TqdmProgressBar,
            "simple": SimpleProgressBar,
            "json": JsonProgressBar,
            "none": NoopProgressBar,
        }[fmt]
    except KeyError:
        raise ValueError(f"Unknown log format: {fmt}") from None
    bar = cls(iterator, epoch=epoch, prefix=prefix, log_interval=log_interval)
    if tensorboard_logdir:
        bar = TensorboardProgressBarWrapper(
            bar, tensorboard_logdir, wandb_project, wandb_name
        )
    return bar


def format_stat(stat):
    """Render one stat for text output; meters display their natural
    summary (average / rate / total seconds)."""
    if isinstance(stat, Number):
        return f"{stat:g}"
    if isinstance(stat, AverageMeter):
        return f"{stat.avg:.3f}"
    if isinstance(stat, TimeMeter):
        return f"{round(stat.avg):g}"
    if isinstance(stat, StopwatchMeter):
        return f"{round(stat.sum):g}"
    if hasattr(stat, "item"):
        return f"{stat.item():g}"
    return stat


@contextmanager
def rename_logger(logger, new_name):
    """Temporarily emit under a tag name (so log lines read 'train | ...')."""
    saved = logger.name
    if new_name is not None:
        logger.name = new_name
    try:
        yield logger
    finally:
        logger.name = saved


class BaseProgressBar:
    """Iteration bookkeeping + formatting shared by every emitter.

    Subclasses implement ``log`` (interval-gated mid-epoch stats) and
    ``print`` (end-of-epoch summary).  ``self.i`` tracks the current
    iteration (offset by a resumed iterator's position), ``self.size`` the
    epoch length.
    """

    def __init__(self, iterable, epoch=None, prefix=None, log_interval=None):
        self.iterable = iterable
        self.offset = getattr(iterable, "n", 0)
        self.epoch = epoch
        self.log_interval = log_interval
        self.i = None
        self.size = None
        pieces = []
        if epoch is not None:
            pieces.append(f"epoch {epoch:03d}")
        if prefix is not None:
            pieces.append(prefix)
        self.prefix = " | ".join(pieces)

    # kept name `n` for API parity with resumable iterators
    @property
    def n(self):
        return self.offset

    def __len__(self):
        return len(self.iterable)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __iter__(self):
        self.size = len(self.iterable)
        i = self.offset
        for obj in self.iterable:
            self.i = i
            yield obj
            i += 1

    def _at_interval(self, step):
        step = step or self.i or 0
        return (
            step > 0
            and self.log_interval is not None
            and step % self.log_interval == 0
        )

    def _render(self, stats):
        return OrderedDict((k, str(format_stat(v))) for k, v in stats.items())

    @staticmethod
    def _join(stats, kv_sep, item_sep):
        return item_sep.join(
            f"{k}{kv_sep}{v.strip()}" for k, v in stats.items()
        )

    def log(self, stats, tag=None, step=None):
        """Emit intermediate stats (rate-limited by log_interval)."""
        raise NotImplementedError

    def print(self, stats, tag=None, step=None):
        """Emit end-of-epoch stats."""
        raise NotImplementedError

    def update_config(self, config):
        """Forward run configuration to sinks that record it (wandb)."""
        pass

    def log_config(self, config):
        """Alias of :meth:`update_config`: the train CLI threads the
        telemetry run identity (run_id / attempt / journal path) through
        here, so a TensorBoard run is joinable with its journals."""
        self.update_config(config)


class NoopProgressBar(BaseProgressBar):
    """Silent: iterate only."""

    def log(self, stats, tag=None, step=None):
        pass

    def print(self, stats, tag=None, step=None):
        pass


class SimpleProgressBar(BaseProgressBar):
    """Plain log lines for non-TTY runs."""

    def log(self, stats, tag=None, step=None):
        if not self._at_interval(step):
            return
        body = self._join(self._render(stats), "=", ", ")
        with rename_logger(logger, tag):
            logger.info(f"{self.prefix}:  {self.i + 1:5d} / {self.size:d} {body}")

    def print(self, stats, tag=None, step=None):
        body = self._join(self._render(stats), " ", " | ")
        with rename_logger(logger, tag):
            logger.info(f"{self.prefix} | {body}")


class JsonProgressBar(BaseProgressBar):
    """One JSON object per log line (machine-readable sink)."""

    def _payload(self, stats, update=None):
        out = OrderedDict()
        if self.epoch is not None:
            out["epoch"] = self.epoch
        if update is not None:
            out["update"] = round(update, 3)
        for k, v in stats.items():
            out[k] = format_stat(v)
        return out

    def log(self, stats, tag=None, step=None):
        if not self._at_interval(step):
            return
        update = None
        if self.epoch is not None:
            # fractional epochs: 2.25 = a quarter through epoch 3
            update = self.epoch - 1 + (self.i + 1) / float(self.size)
        with rename_logger(logger, tag):
            logger.info(json.dumps(self._payload(stats, update=update)))

    def print(self, stats, tag=None, step=None):
        if tag is not None:
            stats = OrderedDict((f"{tag}_{k}", v) for k, v in stats.items())
        self.stats = stats
        with rename_logger(logger, tag):
            logger.info(json.dumps(self._payload(stats)))


class TqdmProgressBar(BaseProgressBar):
    """Interactive terminal bar."""

    def __init__(self, iterable, epoch=None, prefix=None, log_interval=None):
        super().__init__(iterable, epoch, prefix, log_interval)
        from tqdm import tqdm

        self.tqdm = tqdm(
            iterable,
            self.prefix,
            leave=False,
            disable=(logger.getEffectiveLevel() > logging.INFO),
        )

    def __iter__(self):
        return iter(self.tqdm)

    def log(self, stats, tag=None, step=None):
        self.tqdm.set_postfix(self._render(stats), refresh=False)

    def print(self, stats, tag=None, step=None):
        body = self._join(self._render(stats), " ", " | ")
        with rename_logger(logger, tag):
            logger.info(f"{self.prefix} | {body}")


# --------------------------------------------------------------------------
# external sinks (tensorboardX or torch.utils.tensorboard / wandb), imported
# at first use
# --------------------------------------------------------------------------

_tb_writers = {}
_writer_cls = []  # [class or None] once resolved
_tb_missing_warned = [False]


def _summary_writer_cls():
    """The TensorBoard writer class (resolved once), or None."""
    if not _writer_cls:
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
        _writer_cls.append(SummaryWriter)
    return _writer_cls[0]


def _import_wandb():
    try:
        import wandb
    except ImportError:
        return None
    return wandb


@atexit.register
def _close_tb_writers():
    for w in _tb_writers.values():
        w.close()
    _tb_writers.clear()


class TensorboardProgressBarWrapper(BaseProgressBar):
    """Stacks on any text emitter; mirrors numeric stats to TensorBoard and
    (when configured) a wandb run."""

    def __init__(self, wrapped_bar, tensorboard_logdir, wandb_project=None,
                 wandb_name=None):
        self.wrapped_bar = wrapped_bar
        self.tensorboard_logdir = tensorboard_logdir
        self.wandb_run = None
        if _summary_writer_cls() is None and not _tb_missing_warned[0]:
            _tb_missing_warned[0] = True
            logger.warning(
                "tensorboard not found, please install with: "
                "pip install tensorboardX"
            )
        if wandb_project:
            wandb = _import_wandb()
            if wandb is None:
                logger.warning("wandb not found, skipping wandb logging")
            else:
                self.wandb_run = wandb.init(
                    project=wandb_project, name=wandb_name or None,
                    resume="allow",
                )

    def _writer(self, key):
        SummaryWriter = _summary_writer_cls()
        if SummaryWriter is None:
            return None
        if key not in _tb_writers:
            w = SummaryWriter(os.path.join(self.tensorboard_logdir, key))
            w.add_text("sys.argv", " ".join(sys.argv))
            _tb_writers[key] = w
        return _tb_writers[key]

    def __len__(self):
        return len(self.wrapped_bar)

    def __iter__(self):
        return iter(self.wrapped_bar)

    def log(self, stats, tag=None, step=None):
        self._mirror(stats, tag, step)
        self.wrapped_bar.log(stats, tag=tag, step=step)

    def print(self, stats, tag=None, step=None):
        self._mirror(stats, tag, step)
        self.wrapped_bar.print(stats, tag=tag, step=step)

    def update_config(self, config):
        if self.wandb_run is not None:
            self.wandb_run.config.update(config, allow_val_change=True)
        # the run identity also lands as TensorBoard text, so a TB run is
        # joinable with its journals/checkpoints even without wandb
        writer = self._writer("")
        if writer is not None and config:
            writer.add_text(
                "run_config",
                ", ".join(f"{k}={v}" for k, v in sorted(config.items())),
            )
        self.wrapped_bar.update_config(config)

    def _mirror(self, stats, tag=None, step=None):
        writer = self._writer(tag or "")
        if writer is None and self.wandb_run is None:
            return
        if step is None:
            step = stats["num_updates"]
        to_wandb = {}
        for key, stat in stats.items():
            if key == "num_updates":
                continue
            if isinstance(stat, AverageMeter):
                val = stat.val
            elif isinstance(stat, Number):
                val = stat
            else:
                continue
            if writer is not None:
                writer.add_scalar(key, val, step)
            to_wandb[f"{tag}/{key}" if tag else key] = val
        if writer is not None:
            writer.flush()
        if self.wandb_run is not None:
            self.wandb_run.log(to_wandb, step=step)
