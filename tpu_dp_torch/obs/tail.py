"""Shared incremental JSONL tailing — one byte-offset reader, many streams
(the port of `tpu_dp.obs.tail`).

Every live consumer in the obs stack has the same problem: a process is
appending JSON lines to a file (the metrics sink, a rank's heartbeat
stream, a serve replica's health stream) and a watcher wants each new
record exactly once without re-parsing the whole file every tick (which
costs quadratic IO over a long watch). `JsonlTail` is that reader —
hoisted out of ``obsctl watch``'s private ``_MetricsTail`` so the fleet
aggregator, watch, and tests share ONE audited copy of the tricky parts:

- a **partial trailing line** (the writer mid-append) is left in the file
  for the next tick — no torn half-record is ever parsed;
- a **shrunken file** (truncate/rotate) resets the offset to the top
  instead of silently reading garbage from beyond EOF;
- torn/garbage lines are skipped, same tolerance as forensic readers —
  a record written while the host died is expected, not an error.

`StreamTailer` stacks a poll thread on top for fleet-scale use: N
registered streams polled concurrently with the consumer, new records
buffered (bounded) until the consumer drains them. One lock guards the
registry and buffer; file IO happens OUTSIDE the lock so a slow/remote
filesystem can never wedge `add`/`drain` callers (dplint DP505). The
poll loop is ``while not stop.wait(interval)`` — interruptible at every
tick, no wall-clock arithmetic (DP402/DP403), and `stop()` joins the
thread so no daemon is left polling a dead run (DP504).
"""

from __future__ import annotations

import json
import threading
from collections import deque
from pathlib import Path
from typing import Any, Iterable


class JsonlTail:
    """Incremental reader over a live JSONL file: remembers the byte
    offset of the last COMPLETE line so each poll tick parses only what
    was appended since. A partial trailing line (the writer mid-append)
    is left for the next tick; a shrunken file (truncate/rotate) resets
    to the top. Same torn-line tolerance as the forensic readers."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self._offset = 0

    def poll(self) -> list[dict]:
        try:
            size = self.path.stat().st_size
        except OSError:
            return []
        if size < self._offset:
            self._offset = 0
        if size == self._offset:
            return []
        out: list[dict] = []
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            for line in f:
                if not line.endswith(b"\n"):
                    break
                self._offset += len(line)
                try:
                    rec = json.loads(line.decode("utf-8"))
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
        return out


class StreamTailer:
    """Poll many JSONL streams from one background thread.

    ``add(path, meta)`` registers a stream (idempotent per path); the
    thread polls every registered tail each tick and buffers
    ``(meta, record)`` pairs; ``drain()`` hands the consumer everything
    buffered since its last drain, in arrival order. The buffer is
    bounded (``max_buffer``) — when a consumer stalls, the OLDEST
    records drop and ``dropped`` counts them: a live pager wants the
    newest state, and an unbounded buffer would let one wedged consumer
    grow the watcher without limit.

    Synchronous use (replay, tests) needs no thread: ``poll_once()``
    runs one tick inline. `start`/`stop` manage the live thread;
    usable as a context manager.
    """

    def __init__(self, interval_s: float = 0.5, max_buffer: int = 65536):
        self.interval_s = max(0.05, float(interval_s))
        self._tails: dict[Path, tuple[JsonlTail, Any]] = {}
        self._buf: deque[tuple[Any, dict]] = deque(maxlen=int(max_buffer))
        self.dropped = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add(self, path: Path, meta: Any = None) -> bool:
        """Register a stream; returns False when already registered."""
        path = Path(path)
        with self._lock:
            if path in self._tails:
                return False
            self._tails[path] = (JsonlTail(path), meta)
            return True

    @property
    def paths(self) -> list[Path]:
        with self._lock:
            return list(self._tails)

    def poll_once(self) -> int:
        """One poll tick over every registered stream; returns the number
        of records buffered. File IO runs outside the lock — a slow
        filesystem must not block `add`/`drain` callers."""
        with self._lock:
            tails = list(self._tails.values())
        buffered = 0
        for tail, meta in tails:
            recs = tail.poll()
            if not recs:
                continue
            with self._lock:
                before = len(self._buf)
                self._buf.extend((meta, r) for r in recs)
                lost = before + len(recs) - len(self._buf)
                if lost > 0:
                    self.dropped += lost
            buffered += len(recs)
        return buffered

    def drain(self) -> list[tuple[Any, dict]]:
        """Everything buffered since the last drain, arrival order."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
        return out

    # -- thread lifecycle ----------------------------------------------

    def start(self) -> "StreamTailer":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="obs-stream-tailer", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        # Interruptible sleep between ticks; no deadline arithmetic —
        # the tailer runs until stopped, the CALLER owns any duration
        # budget (and keeps it monotonic there).
        while not self._stop.wait(self.interval_s):
            self.poll_once()

    def stop(self) -> None:
        """Stop and join the poll thread (no-op when never started)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "StreamTailer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def read_jsonl(path: Path) -> list[dict]:
    """Whole-file tolerant JSONL read (torn lines skipped) — the one-shot
    twin of `JsonlTail` for replay paths that never tail."""
    tail = JsonlTail(path)
    return tail.poll()


def iter_jsonl(paths: Iterable[Path]) -> Iterable[tuple[Path, dict]]:
    """(path, record) pairs across files, file order then line order."""
    for path in paths:
        for rec in read_jsonl(Path(path)):
            yield Path(path), rec
