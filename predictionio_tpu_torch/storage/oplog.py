"""Durable, crash-safe operation log behind the storage changefeed.

Trimmed copy of ``predictionio_tpu/storage/oplog.py``: every mutating
storage op of a primary gets a monotonically increasing sequence number
and is appended here; the continuous loop's watcher tails the log over
``GET /replicate/changes`` (or in process through ``LocalFeed``).

Record format (little-endian), the JAX package's byte for byte, so a log
directory written by either package is read op for op by the other::

    u64 seq | u32 payload_len | u32 crc32(payload) | payload (JSON, utf-8)

Durability: an append is acknowledged once the record is in the OS page
cache; the file is fsync'd every ``sync_every`` appends, on :meth:`sync`
and on :meth:`close`. A process crash loses nothing appended; a power
loss can drop or tear the last few records, and on reopen the log is
scanned and any torn tail (short header, short payload, CRC mismatch) is
truncated, so the log reopens to a consistent prefix of what was
appended.

``oplog.meta.json`` holds the log's **generation** (a random id minted
at creation: a tailer that sees it change knows the primary's store was
replaced) and ``base_seq`` (the sequence number before the first
record). A partitioned primary's slot (``partition`` in the meta) is
ROADMAP.md queue 1 item 12's remainder: such a log is refused.
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import struct
import threading
import zlib
from typing import List, Optional, Tuple

from ..tools import not_ported
from ..utils.durability import atomic_write_bytes

logger = logging.getLogger(__name__)

_HEADER = struct.Struct("<QII")
#: a logged op is small (events, metadata) or bounded (a base64 model
#: blob); anything beyond this is treated as corruption
_MAX_PAYLOAD = 256 * 1024 * 1024
#: sparse offset index granularity (records between index entries)
_INDEX_EVERY = 64
#: fsync cadence, matching the native event log's
DEFAULT_SYNC_EVERY = 256

_LOG_NAME = "ops.log"
_META_NAME = "oplog.meta.json"

PARTITIONED_LOG = "a partitioned primary's oplog (partition=, adopt_slot)"


class OpLogGap(Exception):
    """``read_since`` asked for records older than this log holds: the
    caller must resync, incremental tailing cannot recover."""


class OpLog:
    """Append-only sequence-numbered op log in one directory."""

    def __init__(self, directory: str, sync_every: int = DEFAULT_SYNC_EVERY,
                 base_seq: int = 0, partition: Optional[Tuple[int, int]] = None):
        if partition is not None:
            raise not_ported(PARTITIONED_LOG, 12)
        self._dir = directory
        self._sync_every = max(1, int(sync_every))
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, _LOG_NAME)
        meta = self._load_or_init_meta(base_seq)
        self.generation: str = meta["generation"]
        self.base_seq: int = int(meta["base_seq"])
        #: sparse [(seq, byte offset of that record)] every _INDEX_EVERY
        self._index: List[Tuple[int, int]] = []
        self._records = 0
        self._unsynced = 0
        self._failed = False
        self._last_seq, self._size = self._recover()
        # unbuffered, so a completed append is visible at once to
        # concurrent read_since() calls through the page cache
        self._fh = open(self._path, "ab", buffering=0)

    # -- meta / recovery --------------------------------------------------
    def _load_or_init_meta(self, base_seq: int) -> dict:
        path = os.path.join(self._dir, _META_NAME)
        if os.path.exists(path):
            with open(path) as fh:
                meta = json.load(fh)
            if meta.get("partition") is not None:
                raise not_ported(f"{PARTITIONED_LOG} in {self._dir}", 12)
            if base_seq and int(meta["base_seq"]) != int(base_seq):
                # continuing numbering from base_seq over an older log
                # would mint already-issued seqs
                raise ValueError(
                    f"oplog {self._dir} starts at base_seq={meta['base_seq']}, "
                    f"caller requires {base_seq}: stale log directory, use a fresh one")
            return meta
        meta = {"generation": secrets.token_hex(8), "base_seq": int(base_seq)}
        atomic_write_bytes(path, json.dumps(meta).encode())
        return meta

    def _recover(self) -> Tuple[int, int]:
        """Scan the log, build the sparse index, truncate any torn tail.
        Returns (last_seq, valid_size)."""
        last_seq = self.base_seq
        offset = 0
        try:
            size = os.path.getsize(self._path)
        except OSError:
            return last_seq, 0
        with open(self._path, "rb") as fh:
            while offset + _HEADER.size <= size:
                header = fh.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    break
                seq, length, crc = _HEADER.unpack(header)
                if (length > _MAX_PAYLOAD or offset + _HEADER.size + length > size
                        or seq != last_seq + 1):
                    break
                payload = fh.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    break
                if self._records % _INDEX_EVERY == 0:
                    self._index.append((seq, offset))
                self._records += 1
                last_seq = seq
                offset += _HEADER.size + length
        if offset < size:
            logger.warning("oplog %s: truncating torn tail (%d -> %d bytes)",
                           self._path, size, offset)
            with open(self._path, "r+b") as fh:
                fh.truncate(offset)
                fh.flush()
                os.fsync(fh.fileno())
        return last_seq, offset

    # -- introspection ----------------------------------------------------
    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._last_seq

    @property
    def oldest_seq(self) -> int:
        """First sequence number this log can serve (base_seq + 1)."""
        return self.base_seq + 1

    @property
    def size_bytes(self) -> int:
        """Bytes of whole records in the log file."""
        with self._lock:
            return self._size

    def checkpoint(self) -> dict:
        """The ``/replicate/checkpoint`` identity triple."""
        with self._lock:
            return {"seq": self._last_seq, "generation": self.generation,
                    "oldestSeq": self.oldest_seq}

    # -- append -----------------------------------------------------------
    def append(self, op: dict) -> int:
        """Append one op, returning its sequence number. One ``write(2)``
        a record (header and payload in one buffer), so a torn append can
        only tear the tail record."""
        payload = json.dumps(op, separators=(",", ":")).encode("utf-8")
        with self._lock:
            if self._failed:
                raise OSError(f"oplog {self._path} is failed (an earlier torn append "
                              "could not be rolled back); restart to recover")
            seq = self._last_seq + 1
            record = _HEADER.pack(seq, len(payload), zlib.crc32(payload)) + payload
            view = memoryview(record)
            try:
                while view:  # raw (unbuffered) writes may be partial
                    view = view[self._fh.write(view):]
            except Exception:
                # a partial record would desync the file from _size and
                # _index: roll back to the last whole record, or poison
                # the log rather than corrupt it
                try:
                    os.ftruncate(self._fh.fileno(), self._size)
                except OSError:
                    self._failed = True
                raise
            if self._records % _INDEX_EVERY == 0:
                self._index.append((seq, self._size))
            self._records += 1
            self._last_seq = seq
            self._size += len(record)
            self._unsynced += 1
            if self._unsynced >= self._sync_every:
                # acks must not reorder against appends: the fsync is
                # the critical section
                os.fsync(self._fh.fileno())
                self._unsynced = 0
            return seq

    def sync(self) -> None:
        with self._lock:
            if self._fh is not None:
                os.fsync(self._fh.fileno())
                self._unsynced = 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None

    # -- read -------------------------------------------------------------
    def read_since(self, since: int, limit: int = 500) -> Tuple[List[Tuple[int, dict]], int]:
        """Up to ``limit`` records with seq > ``since``, and the log's
        current last seq. Raises :class:`OpLogGap` when ``since``
        predates this log's oldest record."""
        with self._lock:
            last_seq, committed = self._last_seq, self._size
            if since < self.base_seq:
                raise OpLogGap(f"oplog holds seq > {self.base_seq}, asked since={since}")
            # nearest index entry at or before the first wanted record
            offset = 0
            for seq, off in self._index:
                if seq <= since + 1:
                    offset = off
                else:
                    break
        out: List[Tuple[int, dict]] = []
        if since >= last_seq or limit <= 0:
            return out, last_seq
        with open(self._path, "rb") as fh:
            fh.seek(offset)
            while offset + _HEADER.size <= committed and len(out) < limit:
                seq, length, _crc = _HEADER.unpack(fh.read(_HEADER.size))
                payload = fh.read(length)
                offset += _HEADER.size + length
                if seq <= since:
                    continue
                out.append((seq, json.loads(payload)))
        return out, last_seq
