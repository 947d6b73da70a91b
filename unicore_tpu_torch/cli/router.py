#!/usr/bin/env python3
"""``unicore-tpu-torch-router``: the serving fleet's entry point
(counterpart of ``unicore_tpu_cli/router.py``).

Boot sequence, with the JAX router's exit codes:

1. open the fleet KV root from ``--fleet-kv`` (exit **78** on an unusable
   root: there is no fleet to route);
2. HTTP bind on ``--host:--port`` (exit **75** on failure); readiness
   tracks "at least one routable replica";
3. start the membership lease rounds (replicas appear as they
   ``--advertise``; silence ripens into named replica-loss verdicts);
4. with ``--path`` and ``--reload-interval``, arm the ROLLING fleet reload:
   one replica at a time, halting on the first rollback;
5. route until signalled: SIGTERM/SIGINT stops accepting, logs the final
   stats and exits **0**.  The router holds no queue: in-flight proxy legs
   finish on their own deadlines.

The router loads no model and touches no card: replicas are the stateful
tier.  Its journal defaults to ``<--fleet-kv>/telemetry``
(``events_rank0_router.jsonl``), where the replicas' ``--telemetry-dir``
can point too, so the JAX package's ``unicore-tpu-trace`` merges the whole
fleet.
"""

import logging
import os
import signal
import sys
import threading
import time

_LOG_FIELDS = ("asctime", "levelname", "name", "message")
logger = logging.getLogger("unicore_tpu_torch.cli.router")

EXIT_OK = 0
EXIT_ROUTER_BIND = 75        # the serve CLI's bind failure, same meaning
EXIT_ROUTER_FLEET_KV = 78    # --fleet-kv root unusable at start-up

ROUTER_EXIT_CODE_NAMES = {
    EXIT_OK: "ok",
    EXIT_ROUTER_BIND: "router-bind-failure",
    EXIT_ROUTER_FLEET_KV: "router-fleet-kv-failure",
}

_stop_requested = threading.Event()


def _handle_signal(signum, frame):
    name = signal.Signals(signum).name
    logger.warning(
        f"received {name}: router stopping (in-flight proxy legs finish on "
        "their own deadlines; no queue to drain)"
    )
    _stop_requested.set()


def main(args) -> int:
    from unicore_tpu_torch import telemetry
    from unicore_tpu_torch.distributed import chaos
    from unicore_tpu_torch.serve import CheckpointWatcher
    from unicore_tpu_torch.serve.fleet import (
        FleetKVError,
        FleetView,
        MembershipRunner,
        RollingReload,
        RouterEngine,
        bind_router,
        open_fleet_kv,
    )

    try:
        chaos.configure(args)
    except (ValueError, NotImplementedError) as err:
        logger.error(f"FATAL: --fault-inject {args.fault_inject!r}: {err}")
        return 1
    logger.info(args)

    # the journal sits beside the fleet KV unless --telemetry-dir names a
    # place: replicas pointed there merge into one fleet timeline
    if not args.telemetry_dir:
        args.telemetry_dir = os.path.join(os.path.abspath(args.fleet_kv), "telemetry")
    telemetry.configure(args, rank=0, role="router")

    # 1. fleet KV --------------------------------------------------------
    try:
        client = open_fleet_kv(args.fleet_kv)
    except FleetKVError as err:
        logger.error(
            f"FATAL: {err} — exiting {EXIT_ROUTER_FLEET_KV} "
            f"({ROUTER_EXIT_CODE_NAMES[EXIT_ROUTER_FLEET_KV]})"
        )
        return EXIT_ROUTER_FLEET_KV
    view = FleetView(client, timeout=args.fleet_timeout)
    engine = RouterEngine(view, retry_budget=args.retry_budget)

    # 2. bind ------------------------------------------------------------
    try:
        server = bind_router(
            args.host, args.port, engine,
            read_timeout_s=args.request_read_timeout,
            default_deadline_ms=args.default_deadline_ms,
            max_deadline_ms=args.max_deadline_ms,
        )
    except OSError as err:
        logger.error(
            f"FATAL: cannot bind {args.host}:{args.port} ({err}) — exiting "
            f"{EXIT_ROUTER_BIND} ({ROUTER_EXIT_CODE_NAMES[EXIT_ROUTER_BIND]})"
        )
        return EXIT_ROUTER_BIND
    server.start()

    # 3. membership ------------------------------------------------------
    membership = MembershipRunner(view, args.fleet_interval).start()
    telemetry.emit("router-start", fleet_kv=os.path.abspath(args.fleet_kv),
                   fleet_timeout=float(args.fleet_timeout),
                   retry_budget=int(args.retry_budget))

    # 4. rolling reload --------------------------------------------------
    rolling = None
    if args.reload_interval > 0:
        if not args.path:
            logger.warning("--reload-interval without --path: nothing to watch; "
                           "rolling reload disarmed")
        else:
            rolling = RollingReload(
                CheckpointWatcher(args.path), view,
                interval_s=args.reload_interval,
                reload_timeout_s=args.reload_timeout,
            ).start()

    # 5. route -----------------------------------------------------------
    started = time.monotonic()
    while not _stop_requested.is_set():
        if args.max_seconds > 0 and time.monotonic() - started >= args.max_seconds:
            logger.info(f"--max-seconds ({args.max_seconds:g}s) reached: stopping")
            break
        _stop_requested.wait(timeout=0.2)

    if rolling is not None:
        rolling.stop()
    membership.stop()
    server.shutdown()
    logger.info(f"final router stats: {engine.stats()}")
    logger.info("router shutdown clean, exiting 0")
    return EXIT_OK


def cli_main() -> None:
    logging.basicConfig(
        stream=sys.stdout,
        level=os.environ.get("LOGLEVEL", "INFO").upper(),
        format=" | ".join(f"%({f})s" for f in _LOG_FIELDS),
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    from unicore_tpu_torch import options

    args = options.get_router_parser().parse_args()
    try:
        signal.signal(signal.SIGTERM, _handle_signal)
        signal.signal(signal.SIGINT, _handle_signal)
    except ValueError:
        logger.warning("could not install signal handlers (not the main thread)")
    sys.exit(main(args))


if __name__ == "__main__":
    cli_main()
