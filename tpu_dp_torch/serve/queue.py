"""In-process request queue: bounded depth, deadlines, SLO classes,

Copy of the JAX package's module of the same name (host code); the
PyTorch port never imports the JAX package.
shed-with-reason.

The admission edge of the serving pipeline (docs/SERVING.md). A request is
a small batch of images (1..max_batch — "mixed-size" traffic); the queue
holds it until a dynamic batcher coalesces pending requests into one
padded bucket. Backpressure is explicit and typed, never silent:

- **bounded depth** — a queue deeper than the engine can drain within the
  SLO only converts future deadline misses into memory; past ``max_depth``
  requests, `submit` sheds with reason ``queue_full`` — **lowest SLO class
  first**: when the incoming request outranks a queued one (smaller
  ``slo_class`` number), the youngest queued request of the *worst*
  represented class is evicted instead, so burst overload degrades the
  bronze tier before it ever touches gold;
- **deadlines** — every request carries an absolute deadline (arrival +
  its SLO budget). A budget already below ``shed_headroom_ms`` at
  admission sheds immediately (reason ``deadline``: it cannot possibly be
  served in time, so rejecting it now is cheaper for everyone than
  serving it late), and a request that expires while queued is shed at
  batch-collect time with the same reason;
- **closed** — `submit` after `close()` sheds ``closed`` synchronously at
  admission (counters included), so a caller racing shutdown gets an
  immediate typed answer instead of depending on the dispatch loop to
  notice it;
- **shed accounting** — every admission and shed increments the
  process-wide `tpu_dp_torch.obs` counters (``serve.accepted``, ``serve.shed``,
  ``serve.shed.<reason>``, and the per-class twins
  ``serve.{accepted,completed,shed,deadline_missed}.c<k>``), which the
  load generator's ground truth must match *exactly*
  (`tests/test_serve.py`).

**SLO classes**: ``slo_class`` is a small non-negative integer priority, 0
highest ("gold"). Dispatch order is (class, arrival) — FIFO within a
class — and overload sheds the lowest class first (above). Classes are
accounting + ordering only; they never change *how* a request is served.

Thread-safe: producers call `submit` from any thread; replica dispatch
threads are concurrent consumers of `collect`/`await_work` (both take the
queue lock, so a formed batch is popped by exactly one consumer).
`requeue` is the failover edge: a dead replica's in-flight requests go
back in *without* re-counting admission, preserving the exactly-once
books (docs/SERVING.md "Failover").
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np

from tpu_dp_torch.obs.counters import Counters, counters as _global_counters

#: shed reasons (the `ShedError.reason` / `RequestHandle.shed_reason` values)
SHED_QUEUE_FULL = "queue_full"
SHED_DEADLINE = "deadline"
SHED_CLOSED = "closed"
#: a dead/wedged replica's in-flight request that exhausted its failover
#: retries (the JAX package's serve/router.py) — typed, never a silent drop.
SHED_REPLICA_FAILED = "replica_failed"


class ShedError(RuntimeError):
    """A request was rejected at admission; ``reason`` says why."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass
class Request:
    """One queued inference request: ``n`` images + its deadline."""

    req_id: int
    images: np.ndarray          # (n, H, W, C), host-side
    arrival: float              # time.perf_counter() — the latency clock
    arrival_ts: float           # time.time() — the obs wall-clock stamp
    deadline: float             # perf_counter seconds; absolute
    handle: "RequestHandle"
    slo_class: int = 0          # priority class, 0 = highest ("gold")
    retries: int = 0            # failover re-admissions so far

    @property
    def n(self) -> int:
        return int(self.images.shape[0])


class RequestHandle:
    """The caller's half of a request: blocks until served or shed.

    Resolved exactly once — the `_claim` guard makes a second resolution
    attempt a no-op, which is what keeps failover honest: a request
    retried off a replica presumed dead can never be double-answered if
    the original resolver turns out to be merely slow.
    ``predictions``/``confidence`` are per-image (shape ``(n,)``);
    ``shed_reason`` is None on success. ``model_version`` stamps which
    weights served it (hot swap, docs/SERVING.md); ``served_by`` is the
    replica sid.
    """

    def __init__(self, req_id: int, n: int, slo_class: int = 0):
        self.req_id = int(req_id)
        self.n = int(n)
        self.slo_class = int(slo_class)
        self._done = threading.Event()
        self._claim_lock = threading.Lock()
        self._claimed = False
        self.predictions: np.ndarray | None = None
        self.confidence: np.ndarray | None = None
        self.shed_reason: str | None = None
        self.latency_ms: float | None = None
        self.deadline_missed: bool = False
        self.spans: dict[str, float] = {}
        self.model_version: int | None = None
        self.served_by: int | None = None

    @property
    def ok(self) -> bool:
        return self._done.is_set() and self.shed_reason is None

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until resolved; False on timeout."""
        return self._done.wait(timeout)

    # -- engine-side resolution (exactly once) --------------------------

    def _claim(self) -> bool:
        """First resolver wins; every later attempt is discarded."""
        with self._claim_lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def _finish_resolve(self, predictions, confidence, latency_ms,
                        deadline_missed, spans) -> None:
        """Fill + wake an already-`_claim`ed handle (the replica claims
        the whole batch first, publishes counters, then finishes — a
        waiter that wakes must read books that already include it)."""
        self.predictions = predictions
        self.confidence = confidence
        self.latency_ms = float(latency_ms)
        self.deadline_missed = bool(deadline_missed)
        self.spans = dict(spans)
        self._done.set()

    def _resolve(self, predictions, confidence, latency_ms,
                 deadline_missed, spans) -> bool:
        if not self._claim():
            return False
        self._finish_resolve(predictions, confidence, latency_ms,
                             deadline_missed, spans)
        return True

    def _shed(self, reason: str) -> bool:
        if not self._claim():
            return False
        self.shed_reason = reason
        self._done.set()
        return True


def shed_counted(registry: Counters, handle: RequestHandle,
                 reason: str) -> bool:
    """Shed ``handle`` exactly once with exact books; False when it was
    already resolved (a lost failover race — nothing is counted twice).

    Counter order matters: the shed counters (total, per-reason, per-class)
    are published BEFORE the waiter wakes, so a caller whose handle just
    resolved always reads books that include it (the loadgen audit's
    invariant).
    """
    if not handle._claim():
        return False
    registry.inc("serve.shed")
    registry.inc(f"serve.shed.{reason}")
    registry.inc(f"serve.shed.c{handle.slo_class}")
    handle.shed_reason = reason
    handle._done.set()
    return True


class RequestQueue:
    """Bounded FIFO of pending requests with deadline-aware collection."""

    def __init__(
        self,
        max_depth: int = 256,
        default_slo_ms: float = 50.0,
        shed_headroom_ms: float = 0.0,
        image_shape: tuple[int, int, int] = (32, 32, 3),
        image_dtype=np.uint8,
        max_request: int | None = None,
        registry: Counters | None = None,
    ):
        if max_depth < 1:
            raise ValueError(f"max_depth must be positive, got {max_depth}")
        self.max_depth = int(max_depth)
        self.default_slo_ms = float(default_slo_ms)
        self.shed_headroom_ms = float(shed_headroom_ms)
        self.image_shape = tuple(image_shape)
        # One dtype per queue: the per-bucket programs are compiled for a
        # fixed input signature, and a request smuggling a different dtype
        # into a bucket would be a silent retrace (the exact cliff the
        # ladder exists to prevent).
        self.image_dtype = np.dtype(image_dtype)
        # A request larger than the biggest bucket could never be batched
        # and would wedge the FIFO head forever — a caller error, rejected
        # at submit (ValueError, not a shed: it is not a load condition).
        self.max_request = None if max_request is None else int(max_request)
        self._counters = _global_counters if registry is None else registry
        self._dq: deque[Request] = deque()
        self._cond = threading.Condition()
        self._images = 0          # total images pending (cheap occupancy)
        self._next_id = 0
        self._closed = False

    # -- producer side ---------------------------------------------------

    def submit(self, images: np.ndarray, slo_ms: float | None = None,
               now: float | None = None,
               slo_class: int = 0) -> RequestHandle:
        """Enqueue one request; raises `ShedError` when load-shed.

        ``images`` is ``(n, H, W, C)`` (a single ``(H, W, C)`` image is
        promoted to n=1). ``slo_ms`` is this request's latency budget
        (default: the queue's); the deadline is ``now + slo_ms``.
        ``slo_class`` is the request's priority class (0 = highest):
        dispatch prefers lower classes and overload sheds higher ones
        first (module docstring).
        """
        if slo_class < 0:
            raise ValueError(f"slo_class must be >= 0, got {slo_class}")
        images = np.asarray(images)
        if images.shape == self.image_shape:
            images = images[None]
        if images.ndim != 4 or images.shape[1:] != self.image_shape:
            raise ValueError(
                f"request images must be (n, {', '.join(map(str, self.image_shape))}), "
                f"got {images.shape}"
            )
        if images.dtype != self.image_dtype:
            raise ValueError(
                f"request images must be {self.image_dtype}, got "
                f"{images.dtype} (the bucket programs compile for one "
                f"fixed input dtype)"
            )
        if self.max_request is not None and images.shape[0] > self.max_request:
            raise ValueError(
                f"request carries {images.shape[0]} images, above the "
                f"largest batch bucket ({self.max_request}); split it"
            )
        budget_ms = self.default_slo_ms if slo_ms is None else float(slo_ms)
        now = time.perf_counter() if now is None else float(now)
        with self._cond:
            handle = RequestHandle(self._next_id, int(images.shape[0]),
                                   slo_class=slo_class)
            self._next_id += 1
            if self._closed:
                # Synchronous typed shed at admission: a caller racing
                # shutdown must not depend on a dispatch loop (possibly
                # already gone) to account for it — counters included, so
                # the loadgen audit stays exact through a close.
                shed_counted(self._counters, handle, SHED_CLOSED)
                raise ShedError(
                    SHED_CLOSED,
                    f"queue is closed; request {handle.req_id} shed",
                )
            # Headroom BEFORE the depth/eviction decision: a request that
            # cannot possibly be served in time must never evict a viable
            # queued request to make room for itself.
            if budget_ms < self.shed_headroom_ms:
                shed_counted(self._counters, handle, SHED_DEADLINE)
                raise ShedError(
                    SHED_DEADLINE,
                    f"deadline budget {budget_ms:.1f}ms below shed headroom "
                    f"{self.shed_headroom_ms:.1f}ms; request {handle.req_id} "
                    f"shed at admission",
                )
            if len(self._dq) >= self.max_depth:
                victim = self._full_queue_victim(slo_class)
                if victim is None:
                    shed_counted(self._counters, handle, SHED_QUEUE_FULL)
                    raise ShedError(
                        SHED_QUEUE_FULL,
                        f"queue depth {len(self._dq)} at max_depth "
                        f"{self.max_depth}; request {handle.req_id} shed",
                    )
                # Shed lowest class first: the incoming request outranks
                # the victim, which is evicted (typed, counted) to make
                # room — burst overload eats the bronze tier before gold.
                self._dq.remove(victim)
                self._images -= victim.n
                shed_counted(self._counters, victim.handle, SHED_QUEUE_FULL)
            req = Request(
                req_id=handle.req_id,
                images=images,
                arrival=now,
                arrival_ts=time.time(),
                deadline=now + budget_ms / 1e3,
                handle=handle,
                slo_class=int(slo_class),
            )
            self._dq.append(req)
            self._images += req.n
            self._counters.inc("serve.accepted")
            self._counters.inc(f"serve.accepted.c{req.slo_class}")
            self._cond.notify_all()
            return handle

    def _full_queue_victim(self, incoming_class: int) -> Request | None:
        """The queued request a full queue evicts for ``incoming_class``.

        The *youngest* request of the *worst* (numerically highest) class
        present, and only when that class is strictly worse than the
        incoming one — least invested work of the least important tier.
        None when the incoming request does not outrank anything (it is
        shed itself, exactly as before classes existed)."""
        worst: Request | None = None
        for req in self._dq:
            if req.slo_class <= incoming_class:
                continue
            if worst is None or req.slo_class > worst.slo_class or (
                req.slo_class == worst.slo_class
                and req.arrival >= worst.arrival
            ):
                worst = req
        return worst

    def requeue(self, requests: list[Request]) -> None:
        """Failover re-admission: a dead replica's in-flight requests go
        back to the queue head (original relative order, original arrival
        clocks and deadlines intact) WITHOUT re-counting admission — each
        was counted ``serve.accepted`` exactly once at submit, and the
        exactly-once audit depends on that staying true through a
        failover. Bypasses ``max_depth`` (these were already admitted)
        and works on a closed queue (a drain must still flush them)."""
        live = [r for r in requests if not r.handle.done()]
        if not live:
            return
        with self._cond:
            self._dq.extendleft(reversed(live))
            self._images += sum(r.n for r in live)
            self._cond.notify_all()

    def close(self) -> None:
        """Stop admitting; queued requests still drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- consumer side (single dispatch thread) --------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def __len__(self) -> int:
        with self._cond:
            return len(self._dq)

    def pending_images(self) -> int:
        with self._cond:
            return self._images

    def await_work(self, target_images: int, max_wait_s: float,
                   timeout_s: float) -> str:
        """Block until a batch should form; returns why it should.

        - ``"fill"``    — pending images reached ``target_images`` (the
          ladder's max bucket: no point waiting longer);
        - ``"wait"``    — the oldest pending request aged past
          ``max_wait_s`` (or the queue is closed and draining): dispatch
          what we have;
        - ``"timeout"`` — no batch became *due* within ``timeout_s``
          (work may still be pending, just younger than ``max_wait_s`` —
          the dispatch loop's chance to check its stop flag before
          waiting again; returning "wait" here instead would silently
          cap the configured max_wait at the caller's poll interval);
        - ``"closed"``  — closed AND empty: the drain is complete.
        """
        end = time.perf_counter() + timeout_s
        with self._cond:
            while True:
                now = time.perf_counter()
                if self._dq:
                    if self._images >= target_images:
                        return "fill"
                    oldest = self._dq[0].arrival
                    if self._closed or now - oldest >= max_wait_s:
                        return "wait"
                    if now >= end:
                        return "timeout"
                    wake = min(end, oldest + max_wait_s)
                else:
                    if self._closed:
                        return "closed"
                    if now >= end:
                        return "timeout"
                    wake = end
                self._cond.wait(max(wake - now, 1e-4))

    def collect(self, max_images: int, now: float | None = None
                ) -> tuple[list[Request], list[Request]]:
        """Pop (batch, expired): highest-class-first requests up to
        ``max_images``.

        Expired requests (deadline already passed — serving them would
        only produce a late answer nobody is waiting for) are removed
        wherever they sit in the queue, shed with reason ``deadline``,
        and returned so the engine can resolve their handles. The batch
        is then the (slo_class, arrival)-ordered prefix whose cumulative
        image count fits ``max_images`` — FIFO within a class (with one
        class, exactly the old FIFO), a request never split across
        batches, and the prefix stops at the first request that does not
        fit (no skip-ahead: a big gold request cannot be starved by small
        bronze ones slipping past it).
        """
        now = time.perf_counter() if now is None else float(now)
        with self._cond:
            live: list[Request] = []
            expired: list[Request] = []
            for req in self._dq:
                (expired if req.deadline <= now else live).append(req)
            ordered = sorted(live, key=lambda r: (r.slo_class, r.arrival))
            batch: list[Request] = []
            total = 0
            for req in ordered:
                if total + req.n > max_images:
                    break
                batch.append(req)
                total += req.n
            taken = {id(r) for r in batch}
            self._dq = deque(r for r in live if id(r) not in taken)
            self._images = sum(r.n for r in self._dq)
            for req in expired:
                shed_counted(self._counters, req.handle, SHED_DEADLINE)
            return batch, expired
