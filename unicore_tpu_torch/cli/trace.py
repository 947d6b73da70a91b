#!/usr/bin/env python3
"""``unicore-tpu-torch-trace``: merge the event journals of a run (training,
serving, the fleet router) into one timeline, a Chrome trace (``--out``) and
a post-mortem summary -- see :mod:`unicore_tpu_torch.telemetry.trace`.
Host-side file crunching only: no torch import, runs anywhere the journals
can be copied to::

    python -m unicore_tpu_torch.cli.trace <save-dir>/telemetry --out run.json
"""

import logging
import os
import sys

logging.basicConfig(
    stream=sys.stderr,
    level=os.environ.get("LOGLEVEL", "WARNING").upper(),
    format="%(levelname)s | %(name)s | %(message)s",
)


def main(argv=None) -> int:
    from unicore_tpu_torch.telemetry.trace import main as trace_main

    return trace_main(argv)


if __name__ == "__main__":
    sys.exit(main())
