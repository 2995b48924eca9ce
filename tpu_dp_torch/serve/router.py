"""Replica fan-out: N serving replicas behind one admission queue (port of
`tpu_dp.serve.router`).

The self-healing serving tier: a `ServeCluster` runs one `ServeReplica`
dispatch worker per replica — each with its own copy of the model on its
own device (one card per replica by default; an explicit device list may
repeat a card, and replicas sharing it each run on their own CUDA
stream) — and fronts them all with a single SLO-class-aware
`RequestQueue`. Routing is pull-based — an idle replica takes the next
batch, so load balance is emergent and a slow replica naturally takes
less — with the router owning every policy decision the replicas
themselves must not make:

- **health** — per-replica health derives from the same heartbeat files
  the trainer's `HealthMonitor` watches (`<run_dir>/obs/heartbeat_r<sid>`,
  one beat per dispatched batch): a replica whose heartbeat has gone
  stale *while it holds an in-flight batch* is *quarantined* — the
  router stops feeding it — and restored the moment it beats again
  (slow ≠ dead; its in-flight batch completes normally, so the books
  stay exact). Without a ``run_dir`` the same rule runs off the
  in-process in-flight clock.
- **failover with exactly-once accounting** — a replica whose dispatch
  *raises* is dead: its in-flight requests are re-queued onto a survivor
  (``serve.failover.retried``; admission is never re-counted) up to
  ``max_retries``, then shed with the typed reason ``replica_failed``.
  The claim guard on `RequestHandle` makes a double-resolution race
  structurally impossible, so the caller-vs-counter audit holds exactly
  through the failure.
- **elastic drain/rejoin** — `drain(sid)` (or SIGTERM via
  `install_sigterm_drain`, or an injected ``leave:`` fault) means
  drain-then-leave: the replica stops pulling, finishes its in-flight
  batch, and its departure is published as a serving-flavored membership
  epoch (`tpu_dp_torch.resilience.elastic.ServeMembership`, the JAX
  package's ledger files, so ``obsctl timeline`` reconstructs it).
  Survivors absorb its share of the queue. `rejoin(sid)` restarts the
  worker on its captured programs and resident weights — no capture, no
  reload.
- **hot model swap** — `swap_model` / `swap_from_checkpoint` parks a new
  weight version on every replica; each applies it between batches, in
  place, so zero requests are dropped, no graph is captured again, and
  every response is stamped with the version that served it (flightrec
  ``model_swap``).

The cluster quacks like an `InferenceEngine` where it matters —
``submit`` / ``report`` / ``device_stats`` / ``queue`` / ``_counters`` —
so the load generator and its exactness audit drive both unchanged.
"""

from __future__ import annotations

import json
import signal
import threading
import time

import numpy as np
import torch

from tpu_dp_torch.data.cifar import IMAGE_SHAPE
from tpu_dp_torch.obs.counters import Counters, counters as _global_counters
from tpu_dp_torch.obs.spans import SpanRecorder
from tpu_dp_torch.serve.batcher import BucketLadder
from tpu_dp_torch.serve.engine import (
    _load_swap_checkpoint, _resolve_checkpoint, register_serve_costs,
)
from tpu_dp_torch.serve.queue import (
    SHED_CLOSED,
    SHED_REPLICA_FAILED,
    RequestHandle,
    RequestQueue,
    shed_counted,
)
from tpu_dp_torch.serve.replica import (
    LatencyBook, ServeReplica, serve_report_core,
)


def replica_devices(replicas: int, devices=None) -> list[torch.device]:
    """One device per replica. ``devices=None``: every visible CUDA card,
    one per replica (cards beyond the replicas stay unused); an explicit
    list may repeat a device (its replicas share it). Raises, with the JAX
    package's message, when there are fewer devices than replicas."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
    devices = [torch.device(d) for d in devices]
    if len(devices) < replicas:
        raise ValueError(
            f"{replicas} replicas need at least {replicas} devices, "
            f"have {len(devices)}"
        )
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d
            for d in devices[:replicas]]


class ServeCluster:
    """N `ServeReplica`s, one device each, behind one shared queue."""

    def __init__(
        self,
        model,
        replicas: int = 2,
        devices=None,
        buckets=None,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        slo_ms: float = 50.0,
        shed_headroom_ms: float = 0.0,
        run_dir: str | None = None,
        span_capacity: int = 4096,
        on_retrace: str = "raise",
        fault: str = "",
        registry: Counters | None = None,
        model_name: str = "",
        flops_per_image: float | None = None,
        peak_flops: float | None = None,
        stale_after_s: float = 2.0,
        max_retries: int = 1,
        health_every_s: float = 0.05,
        class_slo_ms: dict[int, float] | None = None,
    ):
        devices = replica_devices(int(replicas), devices)
        self.model = model
        self.n_replicas = int(replicas)
        self.ladder = BucketLadder(
            buckets if buckets is not None else BucketLadder().buckets
        )
        self.slo_ms = float(slo_ms)
        self.class_slo_ms = dict(class_slo_ms or {})
        self.stale_after_s = float(stale_after_s)
        self.max_retries = int(max_retries)
        self.health_every_s = float(health_every_s)
        self._counters = _global_counters if registry is None else registry
        self.queue = RequestQueue(
            max_depth=max_queue,
            default_slo_ms=slo_ms,
            shed_headroom_ms=shed_headroom_ms,
            image_shape=IMAGE_SHAPE,
            image_dtype=np.uint8,
            max_request=self.ladder.max_batch,
            registry=self._counters,
        )
        self.recorder = SpanRecorder(capacity=span_capacity)
        self.latency_book = LatencyBook(capacity=span_capacity)
        self._books_lock = threading.Lock()
        self._policy_lock = threading.Lock()  # failover/drain transitions
        self.model_version = 1
        self._errors: list[tuple[int, BaseException]] = []

        self.run_dir = None
        self.obs_dir = None
        self.membership = None
        self._monitor = None
        if run_dir:
            from pathlib import Path

            from tpu_dp_torch.obs.health import HealthMonitor
            from tpu_dp_torch.resilience.elastic import ServeMembership

            self.run_dir = Path(run_dir)
            self.obs_dir = self.run_dir / "obs"
            self.obs_dir.mkdir(parents=True, exist_ok=True)
            self.membership = ServeMembership(self.run_dir / "membership")
            self.membership.initial(range(self.n_replicas))
            self._monitor = HealthMonitor(
                self.obs_dir, world=self.n_replicas,
                stale_after_s=self.stale_after_s,
            )

        # One replica drives one device: world 1 per replica.
        bucket_flops = register_serve_costs(
            self.ladder, 1,
            model_name=model_name, flops_per_image=flops_per_image,
        )
        self.replicas: list[ServeReplica] = []
        for sid in range(self.n_replicas):
            hb = None
            if self.obs_dir is not None:
                from tpu_dp_torch.obs.health import HeartbeatWriter

                hb = HeartbeatWriter(self.obs_dir, rank=sid)
            self.replicas.append(ServeReplica(
                sid=sid,
                model=model,
                device=devices[sid],
                ladder=self.ladder,
                queue=self.queue,
                recorder=self.recorder,
                latency_book=self.latency_book,
                books_lock=self._books_lock,
                max_wait_ms=max_wait_ms,
                on_retrace=on_retrace,
                fault=fault,
                hb=hb,
                router=self,
                model_version=self.model_version,
                peak_flops=peak_flops,
                bucket_flops=bucket_flops,
                registry=self._counters,
            ))
        self.num_classes = self.replicas[0].num_classes
        #: the distinct devices that serve.
        self.world = len({str(d) for d in devices})

        # Fleet-stream registration (`tpu_dp_torch.obs.fleet`): the health
        # loop appends one router record + per-replica records per tick
        # so a fleet aggregator can derive queue depth / attainment /
        # replica status across the tier from the files alone. Append
        # handles are opened once (one writer per file, like heartbeats).
        self._router_stream = None
        self._replica_streams: dict[int, object] = {}
        if self.obs_dir is not None:
            self._router_stream = open(
                self.obs_dir / "serve_router.jsonl", "a", encoding="utf-8")
            for sid in range(self.n_replicas):
                self._replica_streams[sid] = open(
                    self.obs_dir / f"replica_r{sid:05d}.jsonl", "a",
                    encoding="utf-8")

        self._health_thread: threading.Thread | None = None
        self._health_stop = threading.Event()
        self._sigterm_drain: list[int | None] = []  # set by signal handler
        self._prev_sigterm = None

    # -- router policy (called from replica threads) ---------------------

    def may_dispatch(self, sid: int) -> bool:
        """The feed gate: quarantined/draining replicas pull nothing."""
        r = self.replicas[sid]
        return not r.quarantined and not r.draining

    def begin_drain(self, sid: int, reason: str) -> None:
        """Ask ``sid`` to drain-then-leave (SIGTERM / ``leave:`` fault /
        operator). Idempotent; the departure is published when the
        replica actually leaves (`on_replica_drained`)."""
        r = self.replicas[sid]
        if not r.draining and r.status == "running":
            from tpu_dp_torch.obs import flightrec

            flightrec.record("replica_drain_begin", replica=sid,
                             reason=reason)
            r.request_drain(reason)

    def on_replica_drained(self, sid: int, reason: str) -> None:
        """A draining replica finished its in-flight batch and left."""
        from tpu_dp_torch.obs import flightrec

        with self._policy_lock:
            flightrec.record("replica_drain", replica=sid, reason=reason)
            if self.membership is not None:
                self.membership.depart(sid, reason or "preempted (graceful)")
            self._publish_live_gauge()
            self._maybe_flush_orphaned_queue(reason=SHED_CLOSED)

    def on_replica_error(self, sid: int, exc: BaseException,
                         pending: list) -> None:
        """Failover: retry a dead replica's in-flight on a survivor, or
        shed it typed — every request accounted, none double-served."""
        from tpu_dp_torch.obs import flightrec

        with self._policy_lock:
            self._errors.append((sid, exc))
            flightrec.record("replica_failed", replica=sid,
                             error=f"{type(exc).__name__}: {exc}")
            if self.membership is not None:
                self.membership.depart(
                    sid, f"replica_failed: {type(exc).__name__}"
                )
            # A draining replica is not a survivor: it will never pull
            # again, so requeuing onto it would convert a replica failure
            # into a mislabelled `closed` shed at drain completion.
            # Quarantined replicas DO count — wedged is recoverable.
            survivors = any(
                r.sid != sid and r.status == "running" and not r.draining
                for r in self.replicas
            )
            retry = []
            for req in pending:
                if req.handle.done():
                    continue
                if survivors and req.retries < self.max_retries:
                    req.retries += 1
                    retry.append(req)
                else:
                    shed_counted(self._counters, req.handle,
                                 SHED_REPLICA_FAILED)
            if retry:
                self._counters.inc("serve.failover.retried", len(retry))
                self.queue.requeue(retry)
            self._publish_live_gauge()
            self._maybe_flush_orphaned_queue(reason=SHED_REPLICA_FAILED)

    def _publish_live_gauge(self) -> None:
        live = sum(1 for r in self.replicas if r.status == "running")
        self._counters.gauge("serve.replicas_live", live)

    def _maybe_flush_orphaned_queue(self, reason: str) -> None:
        """Nobody left to serve: close and shed everything typed —
        callers are unblocked, never abandoned (``replica_failed`` when
        the last replica died, ``closed`` when it drained away). A
        still-draining replica does not stay the flush: it pulls nothing
        more by definition."""
        if any(r.status == "running" and not r.draining
               for r in self.replicas):
            return
        self.queue.close()
        reqs, _ = self.queue.collect(self.ladder.max_batch * 10**6)
        for req in reqs:
            shed_counted(self._counters, req.handle, reason)

    # -- health loop -----------------------------------------------------

    def _stale_sids(self) -> set[int]:
        """Replica sids whose heartbeat machinery calls them stale/missing
        right now (file-based when run_dir is set, else the in-process
        in-flight clock — same threshold either way)."""
        if self._monitor is not None:
            try:
                return {
                    i.rank for i in self._monitor.check()
                    if i.kind in ("stale", "missing")
                }
            except Exception:
                return set()
        now = time.monotonic()
        out = set()
        for r in self.replicas:
            age = r.inflight_age(now)
            if age is not None and age > self.stale_after_s:
                out.add(r.sid)
        return out

    def health_tick(self) -> None:
        """One router health pass: quarantine wedged replicas, restore
        recovered ones, honor a SIGTERM drain request.

        Quarantine requires BOTH a stale heartbeat AND an in-flight batch
        older than the threshold: an *idle* replica beats only per batch,
        so its file goes quiet between bursts — quiet-and-empty is
        healthy, quiet-while-holding-work is wedged.
        """
        from tpu_dp_torch.obs import flightrec

        while self._sigterm_drain:
            sid = self._sigterm_drain.pop()
            if sid is None:
                self.queue.close()  # graceful whole-tier drain
            else:
                self.begin_drain(int(sid), reason="preempted (SIGTERM)")
        stale = self._stale_sids()
        for r in self.replicas:
            if r.status != "running":
                continue
            age = r.inflight_age()
            wedged = (
                r.sid in stale and age is not None
                and age > self.stale_after_s
            )
            if wedged and not r.quarantined:
                r.quarantined = True
                self._counters.inc("serve.replica_quarantine_events")
                self._counters.gauge(f"serve.replica_health.{r.sid}", 0)
                flightrec.record(
                    "replica_quarantined", replica=r.sid,
                    inflight_s=round(age, 3),
                )
            elif r.quarantined and r.inflight_age() is None:
                r.quarantined = False
                self._counters.gauge(f"serve.replica_health.{r.sid}", 1)
                flightrec.record("replica_restored", replica=r.sid)
        self._publish_fleet_streams()

    def _publish_fleet_streams(self) -> None:
        """Append one router record + per-replica records for the fleet
        aggregator (`tpu_dp_torch.obs.fleet.discover_streams` finds the
        files).

        Every failure is swallowed into ``fleet.publish_errors``: this
        runs on the health loop, which must keep quarantining wedged
        replicas even when the obs filesystem is full.

        Replica fields are read lock-free (GIL-atomic attribute loads),
        NEVER via ``r.snapshot()``: a wedged replica holds its ``_lock``
        across the device sync — the exact state this loop exists to
        detect — so contending on it here would stall the tick past the
        quarantine window. ``_books_lock`` is safe: its holds are brief
        post-sync bookkeeping, never spanning a device call."""
        if self._router_stream is None:
            return
        try:
            now = time.time()
            with self._books_lock:
                classes = self.latency_book.rollup(
                    self.class_slo_ms, self.slo_ms)
            live = sum(1 for r in self.replicas
                       if r.status == "running" and not r.quarantined)
            rec = {"kind": "router", "ts": now,
                   "queue_depth": len(self.queue),
                   "replicas_live": live, "classes": classes}
            self._router_stream.write(json.dumps(rec) + "\n")
            self._router_stream.flush()
            for r in self.replicas:
                f = self._replica_streams.get(r.sid)
                if f is None:
                    continue
                rep = {"kind": "replica", "sid": r.sid, "ts": now,
                       "status": r.status,
                       "batches": r._batch_index,
                       "quarantined": r.quarantined,
                       "model_version": r.model_version}
                f.write(json.dumps(rep) + "\n")
                f.flush()
        except Exception:
            self._counters.inc("fleet.publish_errors")

    def _health_loop(self) -> None:
        while not self._health_stop.wait(self.health_every_s):
            self.health_tick()

    # -- signals ---------------------------------------------------------

    def install_sigterm_drain(self, sid: int | None = None) -> None:
        """SIGTERM → drain-then-leave for replica ``sid`` (None: the whole
        tier stops admitting and drains out). The handler only records
        the request — the health loop acts on it, because a signal
        handler must never take the queue lock the interrupted thread
        might hold. Restore with `restore_sigterm`."""
        def _handler(signum, frame):
            from tpu_dp_torch.obs import flightrec

            flightrec.record("preempt_signal", signum=int(signum),
                             scope="serve",
                             replica=-1 if sid is None else int(sid))
            self._counters.inc("preempt.signals")
            self._sigterm_drain.append(sid)

        self._prev_sigterm = signal.signal(signal.SIGTERM, _handler)

    def restore_sigterm(self) -> None:
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

    # -- elastic membership (operator edge) ------------------------------

    def drain(self, sid: int, reason: str = "preempted (graceful)") -> None:
        """Drain-then-leave for replica ``sid`` (non-blocking)."""
        self.begin_drain(sid, reason)

    def rejoin(self, sid: int) -> None:
        """Bring a drained replica back into the feed set — on its
        captured programs and resident weights, so the first post-rejoin
        batch is an ordinary dispatch, not a restart."""
        from tpu_dp_torch.obs import flightrec

        r = self.replicas[sid]
        if r.status not in ("left", "stopped"):
            raise RuntimeError(
                f"replica {sid} is {r.status}; only a drained replica "
                f"rejoins (a dead one lost its donated stats buffers)"
            )
        # Status flips to "left" a few instructions before the old worker
        # thread actually returns — join it, or start() races it.
        r.join(timeout=10.0)
        with self._policy_lock:
            # A swap published while the replica was away still applies:
            # the pending state survives in the replica and is swapped in
            # before its first post-rejoin batch.
            r.quarantined = False
            r.start()
            if self.membership is not None:
                self.membership.rejoin(sid)
            flightrec.record("replica_rejoin", replica=sid)
            self._publish_live_gauge()
            self._counters.gauge(f"serve.replica_health.{sid}", 1)

    # -- hot swap --------------------------------------------------------

    def swap_model(self, state_dict, version: int | None = None) -> int:
        """Park a new weight version (a state dict of the served model) on
        every replica (left ones included — a rejoiner must serve the
        current version); each applies it between batches. Zero dropped
        requests; responses stamped with the serving version."""
        from tpu_dp_torch.obs import flightrec

        self.model_version = (self.model_version + 1
                              if version is None else int(version))
        for r in self.replicas:
            r.set_pending_state(state_dict, self.model_version)
        self._counters.gauge("serve.model_version", self.model_version)
        flightrec.record("model_swap", version=self.model_version,
                         replica=-1, scope="cluster")
        return self.model_version

    def swap_from_checkpoint(self, ckpt_dir,
                             version: int | None = None) -> int:
        """`swap_model` from a training checkpoint (params-only load)."""
        return self.swap_model(_load_swap_checkpoint(ckpt_dir, self.model),
                               version=version)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ServeCluster":
        """Warm every replica's bucket programs, replica by replica (each
        on its own dispatch thread: on a card its graphs are captured
        then), before any worker pulls; then release the workers and
        start the health loop."""
        gate = threading.Event()
        try:
            for r in self.replicas:
                r.start(gate=gate)
        finally:
            gate.set()
        self._publish_live_gauge()
        for r in self.replicas:
            self._counters.gauge(f"serve.replica_health.{r.sid}", 1)
        self._health_stop.clear()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="tpu_dp_torch-serve-health",
            daemon=True,
        )
        self._health_thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Close admission; drain (default) or abandon; join everything.

        Raises only when the WHOLE tier failed (every replica dead) —
        individual replica deaths were already failed over, accounted
        with typed sheds, and are reported in `report()['replicas']` /
        ``replica_errors``.
        """
        self.queue.close()
        if not drain:
            for r in self.replicas:
                r.stop_now()
        for r in self.replicas:
            r.join()
        if not drain:
            reqs, _ = self.queue.collect(self.ladder.max_batch * 10**6)
            for req in reqs:
                shed_counted(self._counters, req.handle, SHED_CLOSED)
        self._health_stop.set()
        if self._health_thread is not None:
            self._health_thread.join()
            self._health_thread = None
        self.restore_sigterm()
        for r in self.replicas:
            if r._hb is not None:
                r._hb.close()
        for f in ([self._router_stream] if self._router_stream else []) + \
                list(self._replica_streams.values()):
            try:
                f.close()
            except OSError:
                pass
        self._router_stream = None
        self._replica_streams = {}
        if self._errors and not any(
            r.status in ("running", "stopped", "left") for r in self.replicas
        ):
            raise RuntimeError(
                f"all {self.n_replicas} serve replicas failed"
            ) from self._errors[-1][1]

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- producer API ----------------------------------------------------

    def submit(self, images, slo_ms: float | None = None,
               slo_class: int = 0) -> RequestHandle:
        """Enqueue one request (see `RequestQueue.submit`); may shed."""
        if slo_ms is None:
            slo_ms = self.class_slo_ms.get(int(slo_class))
        return self.queue.submit(images, slo_ms=slo_ms, slo_class=slo_class)

    # -- reporting -------------------------------------------------------

    @property
    def retraces(self) -> int:
        return sum(r.retraces for r in self.replicas)

    def guard_stats(self) -> list[dict]:
        return [
            dict(g, replica=r.sid)
            for r in self.replicas for g in r.guard_stats()
        ]

    def device_stats(self) -> dict:
        """Cluster device-side ground truth: per-replica served books,
        summed. ``served`` counts every real image exactly once ACROSS
        replicas — the zero-double-serve audit is this sum against the
        caller's books."""
        per = {r.sid: r.device_stats() for r in self.replicas}
        counts = [0] * self.num_classes
        for stats in per.values():
            for i, c in enumerate(stats.get("class_counts") or ()):
                counts[i] += c
        return {
            "served": sum(s["served"] for s in per.values()),
            "class_counts": counts,
            "per_replica": per,
            "unreadable": sorted(
                sid for sid, s in per.items() if s.get("unreadable")
            ),
        }

    def report(self) -> dict:
        """The engine report shape plus the fan-out story: per-replica
        status/batches, per-class attainment, membership epoch, versions."""
        out = serve_report_core(
            self.recorder, self.latency_book, self._books_lock,
            self.class_slo_ms, self.slo_ms, self._counters,
        )
        replicas = {str(r.sid): r.snapshot() for r in self.replicas}
        buckets: dict[int, int] = {}
        for r in replicas.values():
            for b, n in r["bucket_counts"].items():
                buckets[b] = buckets.get(b, 0) + n
        out.update({
            "batches": sum(r["batches"] for r in replicas.values()),
            "bucket_counts": dict(sorted(buckets.items())),
            "retraces": self.retraces,
            "guards": self.guard_stats(),
            "device_stats": self.device_stats(),
            "replicas": replicas,
            "replica_errors": [
                {"sid": sid, "error": f"{type(e).__name__}: {e}"}
                for sid, e in self._errors
            ],
            "membership_epoch": (
                self.membership.current().epoch
                if self.membership is not None else None
            ),
            "model_version": self.model_version,
            "world": self.world,
        })
        return out

    # -- constructors ----------------------------------------------------

    @classmethod
    def from_serve_config(cls, model, serve_cfg, **kwargs):
        """Build from a `tpu_dp_torch.config.ServeConfig` section."""
        from tpu_dp_torch.config import parse_class_slo_ms
        from tpu_dp_torch.serve.batcher import parse_buckets

        return cls(
            model,
            replicas=serve_cfg.replicas,
            buckets=parse_buckets(serve_cfg.buckets),
            max_wait_ms=serve_cfg.max_wait_ms,
            max_queue=serve_cfg.max_queue,
            slo_ms=serve_cfg.slo_ms,
            shed_headroom_ms=serve_cfg.shed_headroom_ms,
            run_dir=serve_cfg.run_dir or None,
            stale_after_s=serve_cfg.stale_after_s,
            max_retries=serve_cfg.max_retries,
            class_slo_ms=parse_class_slo_ms(serve_cfg.class_slo_ms),
            **kwargs,
        )

    @classmethod
    def from_checkpoint(cls, ckpt_dir, model=None, **kwargs):
        """Serve a training checkpoint across replicas, params-only."""
        model, name = _resolve_checkpoint(ckpt_dir, model)
        if name:
            kwargs.setdefault("model_name", name)
        return cls(model, **kwargs)
