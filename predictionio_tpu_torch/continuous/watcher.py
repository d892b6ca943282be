"""Feed watcher: changefeed → rating delta, with a durable cursor.

Trimmed copy of ``predictionio_tpu/continuous/watcher.py`` for one feed:
the ingestion edge of the continuous loop. It tails a changefeed — the
in-process :class:`~..storage.oplog.OpLog` through :class:`LocalFeed`,
or a storage primary's ``GET /replicate/changes`` through
:class:`RemoteFeed` — keeps the rating/feedback ops of one app through
the engine's value rules (the training infeed's rate/buy rules), and
accumulates a :class:`DeltaBatch` with freshness accounting.

Cursor discipline: the watcher reads forward from an in-memory
*position* but advances the **durable cursor** (``continuous_cursor.json``,
written crash-safely) only when the controller commits a consumed batch,
after the delta became a live model. A restart re-reads the uncommitted
suffix; re-folding the same events converges, so no acked feedback is
skipped. A :class:`FeedGap` (the feed no longer holds the cursor, or its
generation changed: the primary's store was replaced) ends incremental
folding: the controller retrains fully, then :meth:`FeedWatcher.resync`
jumps the cursor to the feed's head.

Tailing a partitioned store (``PartitionedFeedWatcher``, per-partition
cursors, ``handoff_cursors``) and the pushed-invalidation
``ChangefeedSubscriber`` are ROADMAP.md queue 1 items 12 and 13:
:func:`make_watcher` refuses more than one feed.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
from typing import Dict, List, Optional

from ..storage.event import parse_event_time, to_millis
from ..storage.oplog import OpLog, OpLogGap
from ..tools import CONTINUOUS_LOOP, not_ported
from ..utils.durability import atomic_write_bytes

logger = logging.getLogger(__name__)

__all__ = ["CURSOR_NAME", "DeltaBatch", "DeltaEvent", "FeedGap", "FeedWatcher",
           "LocalFeed", "RemoteFeed", "make_watcher"]

CURSOR_NAME = "continuous_cursor.json"


class FeedGap(Exception):
    """Incremental tailing cannot go on (a seq gap or a generation
    change): the pending delta is incomplete — full retrain, then
    :meth:`FeedWatcher.resync`."""


class LocalFeed:
    """Changefeed source over an in-process :class:`OpLog`."""

    def __init__(self, oplog: OpLog):
        self._oplog = oplog

    def fetch(self, since: int, limit: int) -> dict:
        try:
            entries, last_seq = self._oplog.read_since(since, limit)
        except OpLogGap as exc:
            raise FeedGap(str(exc)) from exc
        return {"changes": [{"seq": s, "op": o} for s, o in entries], "lastSeq": last_seq,
                "generation": self._oplog.generation, "oldestSeq": self._oplog.oldest_seq}

    def checkpoint(self) -> dict:
        return self._oplog.checkpoint()


class RemoteFeed:
    """Changefeed source over a storage primary's ``GET
    /replicate/changes`` and ``/replicate/checkpoint``."""

    def __init__(self, primary_url: str, timeout: float = 10.0):
        from ..storage.remote import single_endpoint

        self._primary = single_endpoint(primary_url)
        self._timeout = timeout

    def fetch(self, since: int, limit: int) -> dict:
        from ..storage.remote import RemoteStorageError, _json, _request

        url = f"{self._primary}/replicate/changes?since={since}&limit={limit}"
        try:
            with _request(url, timeout=self._timeout) as resp:
                return _json(resp)
        except RemoteStorageError as exc:
            if exc.code == 410:  # the log no longer holds the cursor
                raise FeedGap(str(exc)) from exc
            raise

    def checkpoint(self) -> dict:
        from ..storage.remote import _json, _request

        with _request(f"{self._primary}/replicate/checkpoint", timeout=self._timeout) as resp:
            return _json(resp)


@dataclasses.dataclass(frozen=True)
class DeltaEvent:
    """One extracted rating/feedback interaction."""

    seq: int
    user: str
    item: str
    value: float
    event_time_ms: int


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """A consumed slice of the pending delta: commit ``upto_seq`` once,
    when the slice became a live model."""

    events: List[DeltaEvent]
    upto_seq: int
    oldest_event_ms: Optional[int]

    @property
    def user_ids(self) -> List[str]:
        return sorted({e.user for e in self.events})

    @property
    def item_ids(self) -> List[str]:
        return sorted({e.item for e in self.events})


class FeedWatcher:
    """Accumulates one app's rating delta off the changefeed.

    :meth:`poll` runs from one place at a time (the controller's tick);
    :meth:`feed_lag`, :meth:`pending_count` and :meth:`oldest_pending_ms`
    are safe from any thread (scrape-time gauges): shared state mutates
    under ``_lock``, and the fetch itself runs outside it."""

    def __init__(self, feed, app_id: int, event_values: Dict[str, object], state_dir: str,
                 batch_limit: int = 500, max_pending: int = 250_000):
        self._feed = feed
        self._app_id = int(app_id)
        self._event_values = dict(event_values)
        self._batch_limit = batch_limit
        self._max_pending = max_pending
        self._lock = threading.Lock()
        os.makedirs(state_dir, exist_ok=True)
        self._cursor_path = os.path.join(state_dir, CURSOR_NAME)
        self.cursor_seq = 0  # durable: the last COMMITTED seq
        self.generation: Optional[str] = None
        self._load_cursor()
        #: in-memory read position (>= cursor_seq), re-derived from the
        #: durable cursor on restart so an uncommitted suffix re-reads
        self.position = self.cursor_seq
        self.last_seq = self.cursor_seq  # the feed's head, as last seen
        self._pending: List[DeltaEvent] = []
        self.skipped_events = 0  # undecodable: counted, not fatal
        #: per-event tap called outside the lock for each accepted delta
        #: event (the controller joins it to the quality monitor's served
        #: lists); its exceptions are swallowed and counted
        self.on_event = None
        self.on_event_error = None
        #: stall-watchdog heartbeat, called once a poll
        self.heartbeat = None

    # -- durable cursor ---------------------------------------------------
    def _load_cursor(self) -> None:
        try:
            with open(self._cursor_path) as fh:
                state = json.load(fh)
            self.cursor_seq = int(state["seq"])
            self.generation = state.get("generation")
        except (OSError, ValueError, KeyError):
            self.cursor_seq = 0
            self.generation = None

    def _persist_cursor(self) -> None:
        atomic_write_bytes(self._cursor_path, json.dumps(
            {"seq": self.cursor_seq, "generation": self.generation}).encode())

    # -- op extraction ----------------------------------------------------
    def _extract(self, seq: int, op: dict, out: List[DeltaEvent]) -> None:
        kind = op.get("kind")
        if kind == "event_insert":
            if op.get("app") == self._app_id:
                self._extract_event(seq, op.get("event") or {}, out)
        elif kind == "event_write":
            if op.get("app") == self._app_id:
                for obj in op.get("events") or []:
                    self._extract_event(seq, obj, out)
        # deletes, metadata and models are invisible to fold-in: a deleted
        # rating leaves the model at the next full retrain

    def _extract_event(self, seq: int, obj: dict, out: List[DeltaEvent]) -> None:
        rule = self._event_values.get(obj.get("event"))
        if rule is None:
            return
        user = obj.get("entityId")
        item = obj.get("targetEntityId")
        if not user or not item:
            return
        try:
            if isinstance(rule, str):
                value = float((obj.get("properties") or {})[rule])
            else:
                value = float(rule)
            when = obj.get("eventTime")
            event_time_ms = to_millis(parse_event_time(when)) if when else 0
        except (KeyError, TypeError, ValueError):
            # a poison event must not wedge the loop; the full retrain
            # reads through the store's own validation
            self.skipped_events += 1
            logger.debug("continuous: skipping undecodable event at seq %d", seq)
            return
        out.append(DeltaEvent(seq=seq, user=str(user), item=str(item), value=value,
                              event_time_ms=event_time_ms))

    # -- tailing ----------------------------------------------------------
    def poll(self, max_rounds: int = 50) -> int:
        """Read the feed forward from ``position`` into the pending delta;
        returns how many delta events were added. Raises
        :class:`FeedGap` when incremental tailing is over."""
        added = 0
        if self.heartbeat is not None:
            self.heartbeat()
        for _ in range(max_rounds):
            with self._lock:
                since = self.position
                if len(self._pending) >= self._max_pending:
                    # bounded accumulation: feed_lag keeps growing, the
                    # signal that the loop is saturated
                    return added
            batch = self._feed.fetch(since, self._batch_limit)  # no lock held
            generation = batch.get("generation")
            changes = batch.get("changes", [])
            fresh: List[DeltaEvent] = []
            top = since
            for entry in changes:
                seq = int(entry["seq"])
                if seq <= since:
                    continue
                top = max(top, seq)
                self._extract(seq, entry.get("op") or {}, fresh)
            with self._lock:
                if self.generation is None:
                    self.generation = generation
                elif generation is not None and generation != self.generation:
                    if self._is_continuation(batch):
                        # a promoted standby continuing our numbering: the
                        # cursor stays meaningful, adopt the generation
                        logger.warning("continuous: feed generation %s -> %s is a "
                                       "continuation at seq %d; adopting",
                                       self.generation, generation, self.position)
                        self.generation = generation
                    else:
                        raise FeedGap(f"feed generation changed ({self.generation} -> "
                                      f"{generation}): primary store replaced")
                self._pending.extend(fresh)
                self.position = max(self.position, top)
                self.last_seq = max(self.position, int(batch.get("lastSeq", self.last_seq)))
                added += len(fresh)
                caught_up = not changes or self.position >= self.last_seq
            tap = self.on_event
            if tap is not None:
                for event in fresh:  # outside the lock: observer code
                    try:
                        tap(event)
                    except Exception:
                        if self.on_event_error is not None:
                            self.on_event_error()
                        logger.debug("continuous: on_event tap failed", exc_info=True)
            if caught_up:
                break
        return added

    def _is_continuation(self, batch: dict) -> bool:
        """A generation change that continues our history: the new log
        starts after seq 1 (it extends a predecessor), can serve our
        position and has not rewound behind it. A wiped store restarts
        at seq 1 and stays a :class:`FeedGap`. Caller holds ``_lock``."""
        oldest = batch.get("oldestSeq")
        try:
            last = int(batch.get("lastSeq", -1))
            oldest = int(oldest) if oldest is not None else None
        except (TypeError, ValueError):
            return False
        return (oldest is not None and oldest > 1 and oldest <= self.position + 1
                and last >= self.position)

    def refresh_head(self) -> int:
        """Learn the feed's head from its checkpoint without reading any
        op, so :meth:`feed_lag` keeps counting while the loop does not
        poll (a paused controller). Returns the lag."""
        ck = self._feed.checkpoint()
        with self._lock:
            self.last_seq = max(self.last_seq, int(ck.get("seq", 0)))
            return max(0, self.last_seq - self.position)

    # -- introspection (gauge-callback safe) ------------------------------
    def feed_lag(self) -> int:
        """Ops between the read position and the feed's head
        (``pio_continuous_feed_lag_ops``)."""
        with self._lock:
            return max(0, self.last_seq - self.position)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def oldest_pending_ms(self) -> Optional[int]:
        """Event time of the oldest unfolded delta event (model-live lag
        is measured from here)."""
        with self._lock:
            if not self._pending:
                return None
            return min(e.event_time_ms for e in self._pending)

    # -- consumption ------------------------------------------------------
    def take_batch(self) -> Optional[DeltaBatch]:
        """Snapshot the pending delta for one cycle. Not cleared:
        :meth:`commit` clears it once the batch went live, so a failed
        or rolled-back cycle re-folds."""
        with self._lock:
            if not self._pending:
                return None
            events = list(self._pending)
            return DeltaBatch(events=events, upto_seq=max(self.position, events[-1].seq),
                              oldest_event_ms=min(e.event_time_ms for e in events))

    def commit(self, upto_seq: int) -> None:
        """Durably advance the cursor through ``upto_seq`` and drop the
        consumed delta, exactly when the batch's model went live."""
        upto_seq = int(upto_seq)  # a JSON round trip may deliver a str
        with self._lock:
            self._pending = [e for e in self._pending if e.seq > upto_seq]
            self.cursor_seq = max(self.cursor_seq, upto_seq)
            self._persist_cursor()

    def resync(self) -> None:
        """After a gap: jump the cursor to the feed's head and drop the
        incomplete delta. Only after a full retrain covered the history."""
        ck = self._feed.checkpoint()
        with self._lock:
            self._pending = []
            self.cursor_seq = int(ck.get("seq", 0))
            self.position = self.cursor_seq
            self.last_seq = self.cursor_seq
            self.generation = ck.get("generation")
            self._persist_cursor()
        logger.warning("continuous: feed resynced to seq %d (generation %s)",
                       self.cursor_seq, self.generation)


def make_watcher(feeds, app_id: int, event_values: Dict[str, object], state_dir: str,
                 **kwargs) -> FeedWatcher:
    """One feed (or a list of one) → :class:`FeedWatcher`; a list of
    several partitions' feeds raises (ROADMAP.md queue 1 item 12)."""
    if isinstance(feeds, (list, tuple)):
        if len(feeds) != 1:
            raise not_ported(f"{CONTINUOUS_LOOP}: {len(feeds)} feeds", 12)
        feeds = feeds[0]
    return FeedWatcher(feeds, app_id, event_values, state_dir, **kwargs)
