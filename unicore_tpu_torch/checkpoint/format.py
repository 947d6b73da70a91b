"""Checkpoint format v2 (counterpart of ``unicore_tpu/checkpoint/format.py``):
a header and a chunked integrity manifest around the payload.

A bare ``torch.save`` file has the worst failure mode there is: a torn
tail usually breaks the zip reader, but a flipped byte inside a tensor's
bytes loads cleanly, and the run resumes from silently wrong weights.
v2 wraps the same ``torch.save`` stream in an envelope that can be
verified, byte for byte the JAX package's::

    [magic 8B] [u32 header_len] [header pickle]
    [payload: the torch.save stream of the checkpoint dict]
    [footer pickle] [u32 footer_len] [end-magic 8B]

* the **header** (plain Python values) carries the format version, the
  payload's kind (``"torch"``) and the writer's provenance (update count,
  checkpoint suffix), so a file can be inspected without loading it;
* the **footer** is the integrity manifest: one CRC32 per ``chunk_size``
  slice of the payload, computed while ``torch.save`` streams through
  :class:`_ChunkedCrcWriter` and checked by streaming the file back in
  chunk-sized reads, so neither direction holds more than a chunk beside
  the state itself;
* the **end-magic** catches a torn write before any CRC work.

The header and the footer lie outside the CRCs, so they are decoded by an
unpickler that refuses every global: they hold plain values only, and a
crafted file cannot run code through them.

:func:`read` checks every CRC first and only then hands ``torch.load`` a
seekable window over the payload (:class:`_PayloadWindow`: a 1.5 GB state
is not copied into a second buffer), with ``weights_only=True`` and
``argparse.Namespace`` as the one extra safe type.  Damage surfaces as
:class:`CorruptCheckpointError`, which the resume fallback of
``checkpoint_utils.load_checkpoint`` turns into a load of an older file.
The envelope is the JAX package's, so ``unicore_tpu.checkpoint.format``'s
``verify`` and ``read_header`` accept a file written here.
"""

import argparse
import io
import os
import pickle
import struct
import zlib
from typing import Any, Dict, Optional, Tuple

import torch

MAGIC = b"UCTPCKV2"
END_MAGIC = b"2VKCPTCU"
#: 4 MiB slices: a diagnosis names a useful region of a multi-GB file and
#: the manifest stays small (one entry per 4 MiB)
DEFAULT_CHUNK_SIZE = 4 << 20

_LEN = struct.Struct("<I")


class CorruptCheckpointError(RuntimeError):
    """The checkpoint FILE could not be read, decoded or verified: a torn
    write, bit rot or failing storage.  Raised for a manifest mismatch and
    for any failure to parse a file (a bit-flipped zip raises an open set
    of types), so the resume fallback keys on the file layer, while errors
    after a good parse (shape mismatches, unknown optimizers) keep their
    own types."""


class _ChunkedCrcWriter:
    """Write-through wrapper that CRC32s the stream in fixed
    ``chunk_size`` slices as ``torch.save`` produces it (its writes come in
    any size; the slices are re-aligned here)."""

    def __init__(self, f, chunk_size: int):
        self._f = f
        self._chunk_size = chunk_size
        self._crc = 0
        self._in_chunk = 0
        self.crcs = []
        self.nbytes = 0

    def write(self, data) -> int:
        mv = memoryview(data)
        if mv.format != "B" or mv.ndim != 1:
            # typed or shaped buffers count elements, not bytes
            try:
                mv = mv.cast("B")
            except TypeError:  # not contiguous: copy (rare, small)
                mv = memoryview(bytes(mv))
        self._f.write(mv)
        n = len(mv)
        self.nbytes += n
        while len(mv):
            take = min(self._chunk_size - self._in_chunk, len(mv))
            self._crc = zlib.crc32(mv[:take], self._crc)
            self._in_chunk += take
            if self._in_chunk == self._chunk_size:
                self.crcs.append(self._crc)
                self._crc = 0
                self._in_chunk = 0
            mv = mv[take:]
        return n

    def flush(self) -> None:
        self._f.flush()

    def finish(self) -> None:
        if self._in_chunk:
            self.crcs.append(self._crc)
            self._crc = 0
            self._in_chunk = 0


def write(obj, path: str, meta: Optional[Dict[str, Any]] = None,
          chunk_size: int = DEFAULT_CHUNK_SIZE, fsync: bool = True) -> None:
    """Write ``obj`` with ``torch.save`` to ``path`` in format v2; ``meta``
    joins the header.  The file is flushed and fsync'd before this returns,
    so the caller's rename publishes bytes that are on the disk."""
    header = {"format": "unicore-tpu-checkpoint", "version": 2,
              "chunk_size": int(chunk_size), "payload": "torch"}
    if meta:
        header.update(meta)
    with open(path, "wb") as f:
        f.write(MAGIC)
        hb = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
        f.write(_LEN.pack(len(hb)))
        f.write(hb)
        w = _ChunkedCrcWriter(f, chunk_size)
        torch.save(obj, w)
        w.finish()
        footer = {"algo": "crc32", "chunk_size": int(chunk_size),
                  "payload_size": w.nbytes, "chunks": w.crcs}
        fb = pickle.dumps(footer, protocol=pickle.HIGHEST_PROTOCOL)
        f.write(fb)
        f.write(_LEN.pack(len(fb)))
        f.write(END_MAGIC)
        f.flush()
        if fsync:
            os.fsync(f.fileno())


def is_v2(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) == MAGIC
    except OSError:
        return False


class _PlainUnpickler(pickle.Unpickler):
    """Decodes the header and the footer, which hold plain Python values
    only (dicts, lists, str, int, None): they are not covered by a CRC, so
    every global is refused and decoding them runs no code from the
    file."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f"global {module}.{name} refused in a checkpoint envelope")


def _plain_loads(data: bytes) -> Any:
    return _PlainUnpickler(io.BytesIO(data)).load()


def _corrupt(path: str, why: str) -> CorruptCheckpointError:
    return CorruptCheckpointError(f"checkpoint {path}: {why}")


def _layout(f, path: str) -> Tuple[Dict, int, Dict, int]:
    """Parse the envelope: (header, payload_start, footer, footer_start).
    Structural damage (torn tail, absurd lengths, an unreadable header or
    footer) raises :class:`CorruptCheckpointError`."""
    size = os.fstat(f.fileno()).st_size
    f.seek(0)
    if f.read(len(MAGIC)) != MAGIC:
        raise _corrupt(path, "not a v2 checkpoint (magic missing)")
    raw = f.read(_LEN.size)
    if len(raw) < _LEN.size:
        raise _corrupt(path, "truncated before the header length")
    (hlen,) = _LEN.unpack(raw)
    payload_start = len(MAGIC) + _LEN.size + hlen
    trailer = len(END_MAGIC) + _LEN.size
    if hlen <= 0 or payload_start + trailer > size:
        raise _corrupt(path, f"header length {hlen} exceeds the file")
    try:
        header = _plain_loads(f.read(hlen))
    except Exception as e:
        raise _corrupt(path, f"header undecodable ({type(e).__name__}: {e})")
    if not isinstance(header, dict):
        raise _corrupt(path, f"header is a {type(header).__name__}, not a dict")
    f.seek(size - trailer)
    (flen,) = _LEN.unpack(f.read(_LEN.size))
    if f.read(len(END_MAGIC)) != END_MAGIC:
        raise _corrupt(
            path,
            "trailer magic missing — the write was torn (file lost its "
            "tail) or the tail was overwritten",
        )
    footer_start = size - trailer - flen
    if flen <= 0 or footer_start < payload_start:
        raise _corrupt(path, f"footer length {flen} exceeds the file")
    f.seek(footer_start)
    try:
        footer = _plain_loads(f.read(flen))
    except Exception as e:
        raise _corrupt(path, f"integrity manifest undecodable ({type(e).__name__}: {e})")
    if not isinstance(footer, dict):
        raise _corrupt(path, f"integrity manifest is a {type(footer).__name__}, "
                             "not a dict")
    if footer.get("payload_size") != footer_start - payload_start:
        raise _corrupt(
            path,
            f"payload is {footer_start - payload_start} bytes but the "
            f"manifest recorded {footer.get('payload_size')} — torn or "
            "spliced write",
        )
    return header, payload_start, footer, footer_start


def _verify_open(f, path: str) -> Tuple[Dict, int, int]:
    """CRC pass over the payload: (header, payload_start, payload_end)."""
    header, payload_start, footer, footer_start = _layout(f, path)
    chunk_size = int(footer.get("chunk_size") or DEFAULT_CHUNK_SIZE)
    chunks = footer.get("chunks") or []
    expected = (footer_start - payload_start + chunk_size - 1) // chunk_size
    if len(chunks) != expected:
        raise _corrupt(path, f"integrity manifest has {len(chunks)} chunk digests "
                             f"for {expected} payload chunks")
    f.seek(payload_start)
    buf = bytearray(min(chunk_size, max(footer_start - payload_start, 1)))
    for i, want in enumerate(chunks):
        n = f.readinto(memoryview(buf)[:min(chunk_size, footer_start - f.tell())])
        got = zlib.crc32(memoryview(buf)[:n])
        if got != want:
            raise _corrupt(
                path,
                f"integrity manifest digest mismatch in payload chunk "
                f"{i + 1}/{len(chunks)} (crc32 {got:#010x} != recorded "
                f"{want:#010x}) — silent bit rot or a torn/overwritten "
                "region; the payload was NOT loaded",
            )
    return header, payload_start, footer_start


def verify(path: str) -> Dict[str, Any]:
    """Verify the manifest without loading the payload; returns the
    header.  Raises :class:`CorruptCheckpointError` on any damage."""
    with open(path, "rb") as f:
        header, _, _ = _verify_open(f, path)
    return header


def read_header(path: str) -> Dict[str, Any]:
    """The v2 header alone (no payload read, no CRC pass)."""
    with open(path, "rb") as f:
        header, _, _, _ = _layout(f, path)
    return header


def payload_bounds(path: str) -> Optional[Tuple[int, int]]:
    """(payload_start, payload_end) byte offsets of a v2 file, None for any
    other file (the fault injector lands its bit flips inside them)."""
    if not is_v2(path):
        return None
    with open(path, "rb") as f:
        _, payload_start, _, footer_start = _layout(f, path)
    return payload_start, footer_start


class _PayloadWindow(io.RawIOBase):
    """A read-only, seekable view of ``[lo, hi)`` of an open file:
    ``torch.load`` needs to seek, and a ``BytesIO`` copy would double the
    host memory of a multi-GB state."""

    def __init__(self, f, lo: int, hi: int):
        super().__init__()
        self._f, self._lo, self._size, self._pos = f, lo, hi - lo, 0

    def readable(self):
        return True

    def seekable(self):
        return True

    def tell(self):
        return self._pos

    def seek(self, offset, whence=io.SEEK_SET):
        base = {io.SEEK_SET: 0, io.SEEK_CUR: self._pos, io.SEEK_END: self._size}[whence]
        self._pos = max(0, base + offset)
        return self._pos

    def readinto(self, b):
        n = min(len(b), self._size - self._pos)
        if n <= 0:
            return 0
        self._f.seek(self._lo + self._pos)
        got = self._f.readinto(memoryview(b)[:n])
        self._pos += got
        return got


def load_payload(fileobj) -> Any:
    """``torch.load`` of a checkpoint stream onto the CPU, running no
    pickled code: ``weights_only`` with ``argparse.Namespace`` as the one
    extra type allowed."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(fileobj, map_location="cpu", weights_only=True)


def read(path: str, verify_payload: bool = True) -> Tuple[Dict, Any]:
    """Verified load: CRC-check every payload chunk, THEN load it.
    Returns ``(header, state)``.  ``verify_payload=False`` skips the CRC
    pass (the envelope checks still run), for a file just verified."""
    with open(path, "rb") as f:
        if verify_payload:
            header, lo, hi = _verify_open(f, path)
        else:
            header, lo, _, hi = _layout(f, path)
        try:
            state = load_payload(_PayloadWindow(f, lo, hi))
        except Exception as e:
            raise _corrupt(path, f"verified payload failed to load "
                                 f"({type(e).__name__}: {e})")
    return header, state
