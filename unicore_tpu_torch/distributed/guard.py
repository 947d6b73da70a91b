"""The graceful stop (counterpart of the stop half of
``unicore_tpu/distributed/guard.py``): SIGTERM and SIGINT ask the train CLI
to finish the update in flight, save a checkpoint and exit 0, so a
preemption loses no work; a second SIGINT aborts at once.

``stop_requested_global`` is the decision every rank must share: called by
every rank after each update, it is a MAX all-reduce of the local flags
(the JAX guard's agreed stop), so a SIGTERM on any rank stops every rank
after the same update.  Without a process group it is the local flag.  The
consistency guard and the collective watchdog are not ported (ROADMAP queue
A item 4).
"""

import logging
import signal
import threading
from typing import Optional

logger = logging.getLogger(__name__)

_stop_event = threading.Event()
_stop_signal: Optional[str] = None
_previous_handlers = {}


def _handle_stop_signal(signum, frame) -> None:
    global _stop_signal
    name = signal.Signals(signum).name
    if signum == signal.SIGINT and _stop_signal == "SIGINT":
        # a second ^C: the operator wants out, not another checkpoint (a
        # SIGTERM then one ^C stays graceful)
        raise KeyboardInterrupt
    _stop_signal = name
    _stop_event.set()
    logger.warning(
        f"received {name}: graceful stop requested — will finish the in-flight "
        "update, save a checkpoint, and exit 0"
        + (" (send SIGINT again to abort immediately)" if signum == signal.SIGINT else ""))


def install_signal_handlers() -> bool:
    """SIGTERM/SIGINT request a graceful stop instead of killing the run
    mid-update, and a stop left by an earlier run in this process is
    cleared.  :func:`restore_signal_handlers` puts back the handlers
    replaced here.  Returns False when the handlers cannot be installed
    (not the main thread): the run goes on unguarded."""
    global _stop_signal
    _stop_event.clear()
    _stop_signal = None
    try:
        for signum in (signal.SIGTERM, signal.SIGINT):
            previous = signal.signal(signum, _handle_stop_signal)
            _previous_handlers.setdefault(signum, previous)
        return True
    except ValueError:  # not the main thread of the main interpreter
        logger.warning("could not install SIGTERM/SIGINT handlers (not the main "
                       "thread); preemption will not checkpoint")
        return False


def restore_signal_handlers() -> None:
    """The SIGTERM/SIGINT handlers that :func:`install_signal_handlers`
    replaced (the default action where the one replaced was not set from
    Python)."""
    while _previous_handlers:
        signum, handler = _previous_handlers.popitem()
        signal.signal(signum, signal.SIG_DFL if handler is None else handler)


def request_stop(reason: str) -> None:
    """A graceful stop asked for by the program (the same path as a
    SIGTERM, with ``reason`` in place of the signal's name)."""
    global _stop_signal
    _stop_signal = reason
    _stop_event.set()
    logger.warning(f"graceful stop requested ({reason}): will finish the in-flight "
                   "update and save a checkpoint")


def stop_requested() -> Optional[str]:
    """The signal's name (or the reason) once a graceful stop was
    requested, else None."""
    return _stop_signal if _stop_event.is_set() else None


#: the codes of the stop flag's all-reduce (the highest wins)
_STOP_CODES = {None: 0, "SIGTERM": 1, "SIGINT": 2}


def stop_requested_global() -> Optional[str]:
    """The stop decision every rank shares: a MAX all-reduce of each rank's
    flag (a collective: every rank calls it after the same update).  The
    signal's name, this rank's own reason when it has one, or "SIGTERM" /
    "SIGINT" / "stop requested on another rank" as the flag that won; None
    when no rank asked to stop.  Without a process group, the local flag."""
    from unicore_tpu_torch.distributed import utils as distributed_utils
    from unicore_tpu_torch.parallel import groups

    local = stop_requested()
    if not groups.active():
        return local
    code = _STOP_CODES.get(local, 3)
    agreed = int(distributed_utils.all_reduce([code], op="max")[0])
    if agreed == 0:
        return None
    if local is not None:
        return local
    names = {v: k for k, v in _STOP_CODES.items() if k is not None}
    return names.get(agreed, "stop requested on another rank")

