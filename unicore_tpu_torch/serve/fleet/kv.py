"""Fleet coordination KV (counterpart of ``unicore_tpu/serve/fleet/kv.py``):
the coordination client's four-method shape, backed by a shared directory.

Serve replicas are independent processes with no coordination service
between them, so :class:`FileKVClient` keeps one file per key, publishes by
``os.replace`` (readers see whole values or nothing), reports an absent key
as its own deadline expiring (as the coordination client reports "no key
yet") and an unreachable root as a connection failure, so
``utils/retry.kv_fetch`` classifies both without knowing the backend.  The
layout on disk is the JAX package's: a port replica and a JAX router (or
the other way round) can share one directory.
"""

import logging
import os
import re
import time
from typing import List, Tuple

logger = logging.getLogger(__name__)

#: serve-namespaced key prefix (training heartbeats live under
#: ``unicore_tpu/elastic/...``: a run and a fleet sharing a store never
#: collide)
FLEET_PREFIX = "unicore_tpu/serve/fleet"

_SAFE_COMPONENT = re.compile(r"^[A-Za-z0-9._-]+$")


class FleetKVError(RuntimeError):
    """The fleet KV root is unusable (missing, not a directory, or not
    writable): fatal at start-up for a registrar or a router, never
    mid-run (mid-run trouble classifies as UNREACHABLE)."""


def check_name(name: str) -> str:
    """A replica name is a KV key component and a file name: keep it to
    ``[A-Za-z0-9._-]+`` so neither layer needs escaping."""
    if not _SAFE_COMPONENT.match(name or ""):
        raise ValueError(
            f"replica name {name!r} must match [A-Za-z0-9._-]+ "
            "(it names a KV key and a journal field)"
        )
    return name


class FileKVClient:
    """Directory-backed KV: ``key_value_set`` / ``blocking_key_value_get``
    / ``key_value_delete`` / ``key_value_dir_get``.

    * key present -> its string value;
    * key absent -> ``TimeoutError('...deadline exceeded...')`` after the
      poll budget;
    * root missing -> ``ConnectionError`` (the service did not answer).
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def _path(self, key: str) -> str:
        parts = [p for p in str(key).split("/") if p and p != ".."]
        return os.path.join(self.root, *parts)

    def _check_root(self) -> None:
        if not os.path.isdir(self.root):
            raise ConnectionError(f"fleet KV root {self.root} is not a directory")

    def key_value_set(self, key: str, value: str,
                      allow_overwrite: bool = True) -> None:
        self._check_root()
        path = self._path(key)
        if not allow_overwrite and os.path.exists(path):
            raise ValueError(f"key {key} already set")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(str(value))
        os.replace(tmp, path)

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        self._check_root()
        deadline = time.monotonic() + max(1, int(timeout_ms)) / 1000.0
        path = self._path(key)
        while True:
            try:
                with open(path, "r", encoding="utf-8") as f:
                    return f.read()
            except FileNotFoundError:
                pass
            if time.monotonic() >= deadline:
                # worded like the coordination client, so kv_fetch reads it
                # as ABSENT
                raise TimeoutError(f"deadline exceeded waiting for key {key}")
            time.sleep(min(0.02, max(0.0, deadline - time.monotonic())))

    def key_value_delete(self, key: str) -> None:
        self._check_root()
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def key_value_dir_get(self, prefix: str) -> List[Tuple[str, str]]:
        """Every (key, value) under ``prefix``: the router's membership
        listing.  A file that vanishes mid-walk (a goodbye) is skipped."""
        self._check_root()
        base = self._path(prefix)
        out: List[Tuple[str, str]] = []
        if not os.path.isdir(base):
            return out
        for entry in sorted(os.listdir(base)):
            if entry.endswith(".tmp") or ".tmp." in entry:
                continue
            path = os.path.join(base, entry)
            if not os.path.isfile(path):
                continue
            try:
                with open(path, "r", encoding="utf-8") as f:
                    out.append((f"{prefix}/{entry}", f.read()))
            except OSError:
                continue
        return out


def open_fleet_kv(root: str, *, create: bool = True) -> FileKVClient:
    """``--fleet-kv DIR`` -> a client, creating the root when asked.
    Raises :class:`FleetKVError` on an unusable root (the CLIs exit 78)."""
    root = os.path.abspath(root)
    if create:
        try:
            os.makedirs(root, exist_ok=True)
        except OSError as err:
            raise FleetKVError(f"cannot create fleet KV root {root}: {err}") from err
    if not os.path.isdir(root):
        raise FleetKVError(f"fleet KV root {root} is not a directory")
    if not os.access(root, os.R_OK | os.W_OK | os.X_OK):
        raise FleetKVError(f"fleet KV root {root} is not read/writable")
    return FileKVClient(root)


def kv_list(client, prefix: str):
    """One classified membership listing: a list of (key, value) pairs, or
    ``retry.UNREACHABLE`` when the service did not answer.  An unanswered
    listing is evidence about the control plane and must freeze the
    membership clocks, never age a replica's lease.  (The JAX helper also
    darkens the listing under the ``kv-outage`` chaos kind, which waits for
    the rest of the parallelism queue.)"""
    from unicore_tpu_torch.utils import retry

    try:
        return list(client.key_value_dir_get(prefix))
    except Exception as err:
        logger.debug(f"fleet KV listing failed: {err}")
        return retry.UNREACHABLE
