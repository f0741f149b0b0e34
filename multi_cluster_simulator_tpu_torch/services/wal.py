"""Append-only staged-arrival write-ahead log for the serving tier.

The front door's 200-ack is a durability promise the process couldn't keep:
``kill -9`` between the ack and the dispatch silently lost every staged job
(only scheduler_host checkpoints; serving did not). This WAL closes that
hole: every ACCEPTED submit appends one record batch and ``fsync``s BEFORE
the handler answers 200, and restart = restore the latest atomic device
checkpoint (core/checkpoint.py) + replay the WAL suffix
(ServingScheduler._recover). tools/chaos.py kill-9s a live server at
random points and asserts zero acked-job loss and a recovered final state
bit-identical to an uninterrupted run over the same effective stream.

Format: an 8-byte magic + 16-byte random GENERATION id header, then
length-prefixed CRC-framed JSON records —
``<u32 len><u32 crc32(payload)><payload>`` — chosen for torn-tail safety,
not speed: a crash mid-append leaves at most one short/corrupt FINAL
record, which ``read_records`` detects (length short, or CRC mismatch) and
discards, reporting the last good byte offset so recovery can truncate the
tail before appending again. Double replay is idempotent by construction:
replay decides per record from the checkpoint's dispatch watermark, and a
second ``_recover`` call over the same files is a no-op
(tests/test_faults.py pins all three).

The log does NOT grow without bound: the serving checkpoint records the
byte offset of the first record the watermark has not fully covered, so
recovery SEEKS there instead of decoding the whole history, and the
checkpoint cadence COMPACTS the log once the dispatched prefix exceeds
``wal_rotate_bytes`` — ``rotate`` atomically rewrites the file as a fresh
generation holding only the live suffix (tmp + fsync + rename). The
generation id is the crash-safety net for both: a checkpoint whose stored
(generation, offset) doesn't match the current file falls back to the
full scan — offsets are purely an optimization; the replay filter is the
source of truth.

Record fields (compact keys — the log is on the ack path):
``c`` cluster, ``i`` job id, ``co`` cores, ``m`` mem, ``g`` gpu, ``du``
duration ms, ``dl`` delay-endpoint flag, ``t`` the arrival stamp (virtual
ms — identifies the destination staging tick), ``p`` 1 if the job parked
on the endpoint the policy never drains (applied at dispatch edges, so
recovery skips the first ``parked_applied`` parked records instead of
comparing ticks — and a WAL containing parked records disables the
offset/rotation optimizations wholesale: correctness first).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Optional

_HDR = struct.Struct("<II")
_MAGIC = b"MCSWAL1\0"
_GEN_LEN = 16
HEADER_LEN = len(_MAGIC) + _GEN_LEN


class WriteAheadLog:
    """Single-writer append log. ``append`` is called under the serving
    stage lock (WAL order == staging order, which is what makes replay
    reconstruct identical per-(tick, cluster) bucket order); ``fsync=True``
    is the durability contract — the 200-ack only goes out after the
    records are on disk."""

    def __init__(self, path: str, fsync: bool = True,
                 start_offset: Optional[int] = None):
        self.path = path
        self.fsync = fsync
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        if fresh:
            _write_atomic(path, _MAGIC + os.urandom(_GEN_LEN), fsync)
        elif start_offset is not None:
            # recovery truncates a torn tail before appending: a partial
            # final record followed by fresh appends would corrupt every
            # later read
            with open(path, "r+b") as f:
                f.truncate(max(start_offset, HEADER_LEN))
        with open(path, "rb") as f:
            hdr = f.read(HEADER_LEN)
        if hdr[:len(_MAGIC)] != _MAGIC:
            raise ValueError(f"{path}: not a serving WAL")
        self.generation = hdr[len(_MAGIC):].hex()
        self._f = open(path, "ab")
        self._offset = self._f.tell()

    def tell(self) -> int:
        """Current end-of-log byte offset (== the offset the NEXT record
        will start at). Callers snapshot it per staging tick so the
        checkpoint can record a seekable replay start."""
        return self._offset

    def append(self, records: list[dict]) -> None:
        if not records:
            return
        buf = bytearray()
        for rec in records:
            payload = json.dumps(rec, separators=(",", ":"),
                                 sort_keys=True).encode()
            buf += _HDR.pack(len(payload), zlib.crc32(payload))
            buf += payload
        self._f.write(bytes(buf))
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._offset += len(buf)

    def rotate(self, keep_from: int) -> int:
        """Compact: drop every record byte before ``keep_from`` (all
        covered by the durable checkpoint watermark), atomically rewriting
        the file as a FRESH generation holding only the live suffix.
        Returns the byte delta callers subtract from any offsets they
        hold (``old_offset - delta`` is the new position). Crash-safe:
        tmp + fsync + rename, and a checkpoint still pointing into the
        old generation falls back to the full scan (read_records)."""
        keep_from = max(keep_from, HEADER_LEN)
        with open(self.path, "rb") as f:
            f.seek(keep_from)
            suffix = f.read(self._offset - keep_from)
        self._f.close()
        gen = os.urandom(_GEN_LEN)
        _write_atomic(self.path, _MAGIC + gen + suffix, True)
        self.generation = gen.hex()
        self._f = open(self.path, "ab")
        self._offset = self._f.tell()
        return keep_from - HEADER_LEN

    def close(self) -> None:
        self._f.close()


def _write_atomic(path: str, blob: bytes, fsync: bool) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)


def read_header(path: str) -> Optional[str]:
    """The log's generation id (hex), or None for a missing/empty/alien
    file."""
    try:
        with open(path, "rb") as f:
            hdr = f.read(HEADER_LEN)
    except OSError:
        return None
    if len(hdr) < HEADER_LEN or hdr[:len(_MAGIC)] != _MAGIC:
        return None
    return hdr[len(_MAGIC):].hex()


def read_records(path: str, start: Optional[int] = None,
                 generation: Optional[str] = None
                 ) -> tuple[list[dict], list[int], int, bool]:
    """Read every intact record. Returns ``(records, offsets,
    good_offset, torn)``: ``offsets[i]`` is record i's starting byte (a
    recovering server reseeds its per-tick offset table from them),
    ``good_offset`` the byte offset after the last intact record (the
    truncation point for a recovering writer), ``torn`` whether a
    short/corrupt tail was discarded. A missing file is an empty log.

    ``start``/``generation`` enable the seek optimization: when the
    stored generation matches the file's and ``start`` is a plausible
    record boundary, decoding begins there — recovery cost scales with
    the live suffix, not the log's lifetime. Any mismatch falls back to
    the full scan (offsets are an optimization, never the truth)."""
    if not os.path.exists(path):
        return [], [], 0, False
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:len(_MAGIC)] != _MAGIC:
        # pre-header legacy/garbage file: nothing trustworthy
        return [], [], 0, len(blob) > 0
    off = HEADER_LEN
    if (start is not None and generation is not None
            and generation == read_header(path)
            and HEADER_LEN <= start <= len(blob)):
        off = start
    records: list[dict] = []
    offsets: list[int] = []
    while off + _HDR.size <= len(blob):
        ln, crc = _HDR.unpack_from(blob, off)
        begin = off + _HDR.size
        end = begin + ln
        if end > len(blob):
            break  # short final record (torn append)
        payload = blob[begin:end]
        if zlib.crc32(payload) != crc:
            break  # corrupt tail — nothing after it is trustworthy
        try:
            records.append(json.loads(payload))
        except ValueError:
            break
        offsets.append(off)
        off = end
    return records, offsets, off, off != len(blob)
