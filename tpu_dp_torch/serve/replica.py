"""One serving replica: per-bucket serve programs + a dispatch worker (port
of `tpu_dp.serve.replica`).

The unit the self-healing serving tier is built from. A `ServeReplica`
owns everything that is *per-replica* — its own copy of the model on its
device, its own CUDA stream, one serve program per bucket of the ladder
behind a `RecompileGuard` (on a card a CUDA graph captured at warmup,
`tpu_dp_torch.train.step.ServeGraph`), the versioned weights, the
device-resident served books, pinned host staging buffers, a heartbeat
writer and its fault injectors — and runs one dispatch thread that pulls
padded batches from a **shared** `RequestQueue`.

What it deliberately does NOT own: the queue (shared admission — the
router's, or the engine's), the span recorder and per-class latency book
(shared books: the audit is cluster-wide), and the health/failover policy.
A replica reports *facts* (heartbeats, in-flight age, errors); the router
(`tpu_dp_torch/serve/router.py`) decides what they mean. With
``router=None`` the replica is the single engine's: a dispatch failure
sheds everything ``engine_error`` and closes the queue, because there is
nobody to fail over to.

Where the JAX replica calls ``jax.block_until_ready`` (after the host →
device copy, and after the forward), this one synchronizes its own stream,
so the ``h2d`` / ``device`` / ``d2h`` spans measure the same three things
and replicas sharing a card never wait on each other's work. Host batches
are staged through pinned buffers and copied with ``non_blocking=True``.

Lifecycle states (``status``): ``idle`` → ``running`` → one of
``stopped`` (queue drained/closed), ``left`` (drain-then-leave — elastic
departure; `start` again to rejoin on the captured programs), or ``dead``
(dispatch raised; the router retried/shed its in-flight batch).

Hot swap: `set_pending_state` parks a new state dict + version; the
dispatch loop loads it **between batches** — never mid-batch, so every
response is stamped with exactly the ``model_version`` that computed it
and zero requests are dropped by an upgrade. The load writes the weights
in place and repacks the kernel's cached weights in place
(`refresh_packed_weights`): the captured graphs read both at their
addresses, so a swap never captures again.
"""

from __future__ import annotations

import contextlib
import copy
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from tpu_dp_torch.obs.counters import Counters, counters as _global_counters
from tpu_dp_torch.obs.spans import SpanRecorder, percentile
from tpu_dp_torch.serve.batcher import BucketLadder, DynamicBatcher, FormedBatch
from tpu_dp_torch.serve.queue import SHED_CLOSED, RequestQueue, shed_counted
from tpu_dp_torch.train.step import (
    ServeGraph, init_serve_stats, make_serve_step,
)

#: per-request span names, in pipeline order.
SERVE_SPANS = ("queue_wait", "batch_form", "h2d", "device", "d2h")

#: fault kinds consulted INSIDE the device span (they simulate a slow
#: device) vs at the loop top (process/membership events).
_DEVICE_FAULT_KINDS = ("delay",)
_LOOP_FAULT_KINDS = ("leave", "preempt", "kill")


def parse_fault_specs(spec: str, rank: int):
    """';'-separated fault specs → one injector per plan for ``rank``.

    The single-spec grammar is `tpu_dp_torch.resilience.faultinject`'s;
    the semicolon list exists because a chaos scenario poisons one replica
    with ``delay:`` while another gets ``leave:`` in the same run. Empty
    spec falls back to ``TPU_DP_FAULT`` (same as the single-spec path).
    """
    from tpu_dp_torch.resilience.faultinject import FaultInjector, FaultPlan

    spec = spec or os.environ.get("TPU_DP_FAULT", "")
    out = []
    for part in spec.split(";"):
        plan = FaultPlan.parse(part.strip())
        if plan is not None:
            out.append(FaultInjector(plan, rank=rank))
    return out


class LatencyBook:
    """Shared per-SLO-class completed-request latencies (bounded rings)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._lat: dict[int, deque] = {}

    def note(self, slo_class: int, latency_ms: float) -> None:
        dq = self._lat.get(int(slo_class))
        if dq is None:
            dq = self._lat.setdefault(
                int(slo_class), deque(maxlen=self.capacity)
            )
        dq.append(float(latency_ms))

    def classes(self) -> list[int]:
        return sorted(self._lat)

    def rollup(self, slo_ms_by_class: dict[int, float],
               default_slo_ms: float) -> dict[str, dict]:
        """Per-class latency percentiles + attainment vs the class target
        (keys are stringified class ids; sheds are counted apart)."""
        out: dict[str, dict] = {}
        for cls in self.classes():
            lat = sorted(self._lat[cls])
            if not lat:
                continue
            target = float(slo_ms_by_class.get(cls, default_slo_ms))
            out[str(cls)] = {
                "slo_ms": target,
                "attainment": round(
                    sum(1 for v in lat if v <= target) / len(lat), 4
                ),
                "p50_ms": round(percentile(lat, 50), 3),
                "p95_ms": round(percentile(lat, 95), 3),
                "mean_ms": round(sum(lat) / len(lat), 3),
                "n": len(lat),
            }
        return out


def serve_report_core(recorder: SpanRecorder, latency_book: LatencyBook,
                      books_lock: threading.Lock,
                      class_slo_ms: dict[int, float], slo_ms: float,
                      registry: Counters) -> dict:
    """The report keys shared by `InferenceEngine` and `ServeCluster` —
    one rollup implementation, so the single-replica and fan-out reports
    cannot drift. Overall SLO attainment and latency percentiles come
    from the shared span ring, per-class attainment from the latency
    book, both read under the shared books lock (a rollup racing a
    dispatch thread's append would iterate a mutating deque)."""
    with books_lock:
        lat = sorted(
            rec["spans"]["total"] for rec in recorder.records()
        )
        rollup = recorder.rollup()
        classes = latency_book.rollup(class_slo_ms, slo_ms)
    latency = None
    attainment = None
    if lat:
        latency = {
            "p50_ms": round(percentile(lat, 50), 3),
            "p95_ms": round(percentile(lat, 95), 3),
            "p99_ms": round(percentile(lat, 99), 3),
            "mean_ms": round(sum(lat) / len(lat), 3),
            "max_ms": round(lat[-1], 3),
            "n": len(lat),
        }
        attainment = round(
            sum(1 for v in lat if v <= slo_ms) / len(lat), 4
        )
    snap = registry.snapshot()
    return {
        "slo": {"target_ms": slo_ms, "attainment": attainment},
        "latency_ms": latency,
        "spans": {k: v for k, v in rollup.items() if k != "total"},
        "classes": classes,
        "counters": {k: v for k, v in sorted(snap.items())
                     if k.startswith("serve.")},
        "occupancy": snap.get("serve.batch_occupancy"),
        "device_util": snap.get("serve.device_util"),
    }


class ServeReplica:
    """One replica's serve programs + dispatch worker (module docstring).

    ``model`` is an `nn.Module` holding its weights; the replica serves its
    own deep copy, on ``device``, in eval mode (the caller's module is left
    as it is, and two replicas never share one). ``queue``, ``recorder``,
    ``latency_book`` and ``books_lock`` are shared with the other replicas
    (and the report reader) — everything else is private.
    """

    def __init__(
        self,
        sid: int,
        model: torch.nn.Module,
        device: torch.device,
        ladder: BucketLadder,
        queue: RequestQueue,
        recorder: SpanRecorder,
        latency_book: LatencyBook,
        books_lock: threading.Lock | None = None,
        max_wait_ms: float = 5.0,
        on_retrace: str = "raise",
        fault: str = "",
        hb=None,
        router=None,
        model_version: int = 1,
        peak_flops: float | None = None,
        bucket_flops: dict[int, float] | None = None,
        registry: Counters | None = None,
        profile_dir: str = "",
        profile_batches: tuple[int, int] | None = None,
    ):
        self.sid = int(sid)
        self.device = torch.device(device)
        self.ladder = ladder
        self.queue = queue
        self.recorder = recorder
        self.latency_book = latency_book
        self.batcher = DynamicBatcher(queue, ladder, max_wait_ms=max_wait_ms)
        self.router = router
        self._counters = _global_counters if registry is None else registry
        self._on_retrace = on_retrace
        self._hb = hb
        self._faults = parse_fault_specs(fault, self.sid)

        # Inference state: this replica's own copy of the weights on its
        # device, eval mode, no autograd state — serving never needs
        # optimizer slots or gradients.
        self.model = copy.deepcopy(model).to(self.device).eval()
        self.model.requires_grad_(False)
        self.model_version = int(model_version)
        self._pending_state = None  # (device state dict, version)
        self.num_classes = int(model.num_classes)
        cuda = self.device.type == "cuda"
        #: the replica's own stream: its copies, forwards and syncs run
        #: there, so replicas sharing a card never wait on each other.
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        # One memory pool for the replica's bucket graphs: they replay one
        # at a time on the stream.
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        self._stats = init_serve_stats(self.num_classes, self.device)

        # Pinned host staging + device input buffers, one pair per bucket:
        # the host → device copy is asynchronous, and every batch of a
        # bucket reuses the same buffers (the dispatch loop synchronizes
        # after each copy, so a staging buffer is never overwritten while
        # a copy from it is in flight). The device buffers are the bucket
        # graph's static inputs.
        self._host: dict[int, dict[str, torch.Tensor]] = {}
        self._dev: dict[int, dict[str, torch.Tensor]] = {}
        img_dtype = torch.from_numpy(
            np.zeros((), queue.image_dtype)).dtype
        for b in ladder.buckets:
            shapes = {"image": ((b,) + queue.image_shape, img_dtype),
                      "weight": ((b,), torch.float32)}
            self._host[b] = {
                k: torch.empty(s, dtype=d, pin_memory=cuda)
                for k, (s, d) in shapes.items()
            }
            self._dev[b] = {
                k: torch.zeros(s, dtype=d, device=self.device)
                for k, (s, d) in shapes.items()
            }
        self._steps: dict[int, object] = {}
        self._programs: dict[int, object] = {}
        # Per-bucket FLOPs snapshot (engine.register_serve_costs): the
        # utilization gauges compute from THIS replica's own numbers.
        self._bucket_flops = dict(bucket_flops or {})
        self._peak = peak_flops
        if self._peak is None and cuda:
            from tpu_dp_torch.obs import chips

            self._peak = chips.peak_flops(
                torch.cuda.get_device_name(self.device))

        # Batch-ranged serving capture: a StepProfiler armed over *batch
        # indices*, in a per-sid subdir.
        self._profiler = None
        if profile_dir and profile_batches is not None:
            from tpu_dp_torch.utils.profiling import (
                ChromeTrace, StepProfiler,
            )

            tracer = ChromeTrace(rank=self.sid, cuda=cuda)
            self._profiler = StepProfiler(
                os.path.join(profile_dir, f"r{self.sid}"),
                int(profile_batches[0]), int(profile_batches[1]),
                tracer.start, tracer.stop, label=f"serve_r{self.sid}",
            )

        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._batch_index = 0
        self._bucket_counts: dict[int, int] = {}
        # The dispatch lock brackets the device books' update with the
        # forward, and the model-swap pair (device_stats/report vs the
        # dispatch thread); the books lock guards the SHARED recorder +
        # latency book across replicas. For a single-replica engine both
        # default to the same object.
        self._lock = threading.Lock()
        self._books_lock = self._lock if books_lock is None else books_lock

        self.warmup_ms: dict[int, float] = {}
        self.status = "idle"  # idle | running | stopped | left | dead
        self.draining = False
        self.drain_reason = ""
        self.quarantined = False
        self.inflight_since: float | None = None  # monotonic; device-held
        self.last_progress = time.monotonic()

    # -- programs --------------------------------------------------------

    def _step(self, bucket: int):
        """The eager serve step of ``bucket`` (`make_serve_step`)."""
        step = self._steps.get(bucket)
        if step is None:
            step = make_serve_step(self.model, self.device, bucket)
            self._steps[bucket] = step
        return step

    def _program(self, bucket: int):
        """The bucket's serve program: its step as a CUDA graph on a card
        (`ServeGraph`), under a `RecompileGuard` (a capture after the
        first is a retrace)."""
        from tpu_dp_torch.analysis.recompile import RecompileGuard

        prog = self._programs.get(bucket)
        if prog is None:
            prog = RecompileGuard(
                ServeGraph(self._step(bucket), self.device,
                           stream=self.stream, pool=self._pool),
                name=f"serve_step@b{bucket}",
                warmup_calls=1,
                on_retrace=self._on_retrace,
            )
            self._programs[bucket] = prog
        return prog

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _sync(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()

    def warmup(self) -> dict[int, float]:
        """Build every bucket's program on an all-padding batch (weight 0,
        so the books count nothing); per-bucket wall ms. On a card each
        bucket's step runs once eagerly on the replica's stream (the
        kernels' first loads, their ticket buffers and cuDNN's plans),
        then its graph is captured and replayed once. After this, the
        acceptance bar is ZERO retraces for the rest of the replica's life
        (`retraces`), drain/rejoin and hot swaps included. `start` runs
        it on the dispatch thread, once."""
        times: dict[int, float] = {}
        with self._on_stream():
            for bucket in self.ladder.buckets:
                t0 = time.perf_counter()
                batch = self._place_batch(
                    bucket,
                    np.zeros((bucket,) + self.queue.image_shape,
                             self.queue.image_dtype),
                    np.zeros((bucket,), np.float32),
                )
                prog = self._program(bucket)
                with self._lock:
                    if prog.graphed:
                        self._step(bucket)(self._stats, batch)
                        self._sync()
                    self._stats, _ = prog(self._stats, batch)
                    self._sync()
                times[bucket] = round((time.perf_counter() - t0) * 1e3, 2)
        return times

    @property
    def retraces(self) -> int:
        """Post-warmup retraces across every bucket program (must stay 0)."""
        return sum(g.retraces for g in self._programs.values())

    def guard_stats(self) -> list[dict]:
        return [g.stats() for _, g in sorted(self._programs.items())]

    def graph_books(self) -> dict[int, dict]:
        """Per bucket: captures, replays and one capture's launch books
        (`ServeGraph`); the launches its replays ran are ``captured ×
        replays``. Empty on the CPU."""
        out = {}
        for b, g in sorted(self._programs.items()):
            if g.graphed:
                out[b] = {"captures": g.captures, "replays": g.replays,
                          "captured": dict(g.captured or {})}
        return out

    # -- hot swap --------------------------------------------------------

    def set_pending_state(self, state_dict, version: int) -> None:
        """Park a new state dict; loaded between batches (never mid-batch).
        Placement onto the device happens here, off the dispatch thread,
        on the caller's stream, which is synchronized before the park."""
        placed = {k: torch.as_tensor(v).to(self.device)
                  for k, v in state_dict.items()}
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        with self._lock:
            self._pending_state = (placed, int(version))

    def _apply_pending_swap(self) -> None:
        """Dispatch-thread only: load a parked version between batches, in
        place (weights and the kernel's packed weights), on the replica's
        stream, which is synchronized before the parked tensors (made on
        the caller's stream) are let go."""
        from tpu_dp_torch.models.resnet import refresh_packed_weights
        from tpu_dp_torch.obs import flightrec as _flightrec

        with self._lock:
            pending, self._pending_state = self._pending_state, None
            if pending is None:
                return
            state, version = pending
            with torch.no_grad():
                self.model.load_state_dict(state, strict=True)
            refresh_packed_weights(self.model)
            self._sync()
            self.model_version = version
        self._counters.gauge("serve.model_version", self.model_version)
        _flightrec.record(
            "model_swap", replica=self.sid, version=self.model_version,
            step=self._batch_index,
        )

    # -- health facts ----------------------------------------------------

    def inflight_age(self, now: float | None = None) -> float | None:
        """Seconds the current batch has been held on device, or None."""
        since = self.inflight_since
        if since is None:
            return None
        return (time.monotonic() if now is None else now) - since

    def _touch(self) -> None:
        self.last_progress = time.monotonic()

    # -- lifecycle -------------------------------------------------------

    def start(self,
              gate: threading.Event | None = None) -> "ServeReplica":
        """Launch (or relaunch — rejoin) the dispatch thread; on its first
        launch the thread first runs `warmup` (times in ``warmup_ms``) and
        `start` returns once it is done, re-raising a warmup failure; with
        ``gate``, the thread pulls nothing before the gate is set (the
        cluster warms every replica first).

        The warmup belongs on the dispatch thread: PyTorch keeps cuDNN's
        handles and its cache of convolution plans per thread, so a warmup
        run on another thread leaves the first live batch of every bucket
        to build its plans again. Rejoin is a plain `start`, which warms
        nothing: programs, weights and books survive a drain, so a
        returning replica serves its first batch without a capture or a
        reload.
        """
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(f"replica {self.sid} already running")
        self._stop.clear()
        self.draining = False
        self.drain_reason = ""
        self.status = "running"
        self._touch()
        ready = threading.Event()
        self._thread = threading.Thread(
            target=self._run,
            args=(not self.warmup_ms, ready, gate),
            name=f"tpu_dp_torch-serve-replica-{self.sid}",
            daemon=True,
        )
        self._thread.start()
        ready.wait()
        if self.status == "dead":
            self.join()
            raise RuntimeError(
                f"replica {self.sid} warmup failed") from self.take_error()
        return self

    def _run(self, warmup: bool, ready: threading.Event,
             gate: threading.Event | None) -> None:
        try:
            if warmup:
                self.warmup_ms = self.warmup()
        except BaseException as e:
            self._error = e
            self.status = "dead"
            return
        finally:
            ready.set()
        if gate is not None:
            gate.wait()
        with self._on_stream():
            self._loop()

    def stop_now(self) -> None:
        """Abandon mode: exit after at most the in-flight batch."""
        self._stop.set()

    def request_drain(self, reason: str) -> None:
        """Stop pulling new batches; finish the in-flight one; leave."""
        self.drain_reason = reason
        self.draining = True

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            if not self._thread.is_alive():
                self._thread = None

    def take_error(self) -> BaseException | None:
        err, self._error = self._error, None
        return err

    # -- the dispatch loop ----------------------------------------------

    def _poll_loop_faults(self) -> None:
        """Fire loop-scoped fault plans (leave/preempt/kill) at batch
        boundaries; a fired ``leave`` becomes a drain request — the
        signal-free SIGTERM twin, per replica."""
        for inj in self._faults:
            if inj.plan.kind in _LOOP_FAULT_KINDS:
                inj.on_step(self._batch_index)
            if inj.leave_requested and not self.draining:
                inj.leave_requested = False
                if self.router is not None:
                    self.router.begin_drain(
                        self.sid, reason="preempted (leave)"
                    )
                else:
                    # Single-replica engine: nobody absorbs the queue, so
                    # a leave means "stop admitting, serve out the queue,
                    # exit" — close + drain, never abandoned callers.
                    self.queue.close()

    def _loop(self) -> None:
        batch = None
        try:
            # Flag-bounded service loop: lifetime ends with the stop or
            # drain flag or the queue's close, not with a deadline.
            while True:
                if self._stop.is_set():  # abandon mode: stop(drain=False)
                    self.status = "stopped"
                    return
                self._touch()
                self._poll_loop_faults()
                if self.draining:
                    # Drain-then-leave: the in-flight batch (if any) was
                    # finished by the previous iteration; new work goes to
                    # the survivors. The departure epoch is published
                    # BEFORE status flips to "left" — a rejoiner polling
                    # the status must find the departure already on the
                    # ledger, never rejoin-before-depart.
                    if self.router is not None:
                        self.router.on_replica_drained(
                            self.sid, self.drain_reason
                        )
                    self.status = "left"
                    return
                if self.router is not None and \
                        not self.router.may_dispatch(self.sid):
                    if self.queue.closed and len(self.queue) == 0:
                        # Quarantined through the shutdown drain: nothing
                        # left to be fed anyway — exit, don't wedge join().
                        self.status = "stopped"
                        return
                    time.sleep(0.02)
                    continue
                batch = self.batcher.next_batch(timeout_s=0.05)
                if batch == "closed":
                    self.status = "stopped"
                    return
                if batch == "timeout":
                    batch = None
                    continue
                if self._stop.is_set():
                    # Abandon a batch formed while stopping — its popped
                    # requests go back through the shed-on-close path.
                    for req in batch.requests:
                        shed_counted(self._counters, req.handle, SHED_CLOSED)
                    self.status = "stopped"
                    return
                self._apply_pending_swap()
                # _run_batch advances _batch_index; pin THIS batch's
                # 0-based index so the profiler range means "START:END
                # batch indices", half-open.
                bi = self._batch_index
                if self._profiler is not None:
                    # Arm BEFORE dispatch (the StepProfiler discipline).
                    self._profiler.on_window_start(bi, 1)
                self._run_batch(batch)
                if self._profiler is not None:
                    self._profiler.on_step(bi)
                batch = None
        except BaseException as e:
            self._error = e
            self.status = "dead"
            pending = [
                r for r in (batch.requests
                            if isinstance(batch, FormedBatch) else [])
                if not r.handle.done()
            ]
            if self.router is not None:
                # Failover: the router retries the in-flight batch on a
                # survivor or sheds it `replica_failed` — typed either way.
                self.router.on_replica_error(self.sid, e, pending)
            else:
                # Single-replica engine: neither the in-flight batch nor
                # anything queued may wait forever on a dead loop.
                self.queue.close()
                reqs, _ = self.queue.collect(self.ladder.max_batch * 10**6)
                for req in pending + reqs:
                    shed_counted(self._counters, req.handle, "engine_error")
        finally:
            # A capture window cut short by drain/stop/death still stops
            # the trace (the flightrec profile_stop event points at it).
            if self._profiler is not None:
                self._profiler.close()

    def _place_batch(self, bucket: int, images: np.ndarray,
                     weight: np.ndarray) -> dict[str, torch.Tensor]:
        """Host batch → device through the bucket's pinned staging buffers
        into its static device buffers (one path for warmup and live
        dispatch), on the calling thread's current stream."""
        host, dev = self._host[bucket], self._dev[bucket]
        host["image"].numpy()[...] = images
        host["weight"].numpy()[...] = weight
        for k in ("image", "weight"):
            dev[k].copy_(host[k], non_blocking=True)
        return dev

    def _run_batch(self, batch: FormedBatch) -> None:
        # Expired handles were resolved (shed) by the queue; nothing to
        # serve in an all-expired wake.
        if not batch.requests:
            return
        self.inflight_since = time.monotonic()
        try:
            self._run_batch_inner(batch)
        finally:
            self.inflight_since = None
            self._touch()

    def _run_batch_inner(self, batch: FormedBatch) -> None:
        from tpu_dp_torch.obs import flightrec as _flightrec
        from tpu_dp_torch.obs.counters import update_device_memory_gauges

        t0 = time.perf_counter()
        dev_batch = self._place_batch(batch.bucket, batch.images,
                                      batch.weight)
        self._sync()
        t1 = time.perf_counter()
        version = self.model_version
        with self._lock:
            for inj in self._faults:
                if inj.plan.kind in _DEVICE_FAULT_KINDS:
                    # Deterministic straggler injection, bracketed inside
                    # the device span so an injected delay is attributed
                    # exactly like a real slow device — and surfaces in
                    # this replica's heartbeat, which is what the router's
                    # staleness quarantine keys off.
                    inj.on_step(self._batch_index)
            # The books are updated in place by the program: the lock
            # spans the update until it has landed, so a concurrent
            # device_stats() never reads them half-written.
            self._stats, out = self._program(batch.bucket)(
                self._stats, dev_batch
            )
            self._sync()
        t2 = time.perf_counter()
        # Copied out before the next replay reuses the graph's outputs.
        predictions = out["prediction"].cpu().numpy()
        confidence = out["confidence"].cpu().numpy()
        t3 = time.perf_counter()

        h2d_ms = (t1 - t0) * 1e3
        device_ms = (t2 - t1) * 1e3
        d2h_ms = (t3 - t2) * 1e3
        with self._lock:
            self._bucket_counts[batch.bucket] = (
                self._bucket_counts.get(batch.bucket, 0) + 1
            )
            self._batch_index += 1
        # Card memory gauges from the dispatch loop (nothing on the CPU).
        update_device_memory_gauges(registry=self._counters,
                                    devices=[self.device])
        # Per-bucket device utilization — the fraction of the card's peak
        # this dispatch's forward used, from the analytic per-bucket FLOPs
        # `register_serve_costs` published to the cost registry.
        flops = self._bucket_flops.get(batch.bucket)
        util = (
            flops / (device_ms / 1e3) / self._peak
            if flops and self._peak and device_ms > 0 else None
        )
        if util is not None:
            self._counters.gauge(f"serve.device_util.b{batch.bucket}",
                                 round(util, 4))
            self._counters.gauge("serve.device_util", round(util, 4))
        # The heartbeat write (file I/O — the realistic raiser in this
        # tail) happens BEFORE any handle is claimed: an exception here
        # leaves every handle unclaimed, so the normal failover/shed path
        # still accounts for all of them.
        if self._hb is not None:
            self._hb.beat(
                step=self._batch_index,
                step_ms=batch.form_ms + (t3 - t0) * 1e3,
            )
        resolutions = []
        missed_by_class: dict[int, int] = {}
        completed_by_class: dict[int, int] = {}
        try:
            with self._books_lock:
                for req, sl in zip(batch.requests, batch.slices):
                    if not req.handle._claim():
                        continue  # lost a failover race; books untouched
                    latency_ms = (t3 - req.arrival) * 1e3
                    deadline_missed = t3 > req.deadline
                    cls = req.slo_class
                    completed_by_class[cls] = \
                        completed_by_class.get(cls, 0) + 1
                    if deadline_missed:
                        missed_by_class[cls] = \
                            missed_by_class.get(cls, 0) + 1
                    spans = {
                        "queue_wait": max(
                            0.0,
                            (batch.formed - req.arrival) * 1e3
                            - batch.form_ms,
                        ),
                        "batch_form": batch.form_ms,
                        "h2d": h2d_ms,
                        "device": device_ms,
                        "d2h": d2h_ms,
                        "total": latency_ms,
                    }
                    self.recorder.record(req.req_id, spans,
                                         ts=req.arrival_ts)
                    self.latency_book.note(cls, latency_ms)
                    resolutions.append(
                        (req, sl, latency_ms, deadline_missed, spans)
                    )
            # Publish counters BEFORE waking any waiter: a caller whose
            # last handle just resolved must read books that already
            # include it (the loadgen's exact-consistency audit).
            completed = sum(completed_by_class.values())
            missed = sum(missed_by_class.values())
            self._counters.inc("serve.batches")
            self._counters.inc("serve.completed", completed)
            for cls, n in sorted(completed_by_class.items()):
                self._counters.inc(f"serve.completed.c{cls}", n)
            if missed:
                self._counters.inc("serve.deadline_missed", missed)
                for cls, n in sorted(missed_by_class.items()):
                    self._counters.inc(f"serve.deadline_missed.c{cls}", n)
            self._counters.gauge("serve.batch_occupancy", batch.occupancy)
            self._counters.inc(f"serve.replica_batches.{self.sid}")
            _flightrec.record(
                "serve_dispatch", bucket=batch.bucket, replica=self.sid,
                n=len(resolutions), occupancy=batch.occupancy,
                device_ms=round(device_ms, 3), deadline_missed=missed,
                version=version,
            )
            for req, sl, latency_ms, deadline_missed, spans in resolutions:
                req.handle.model_version = version
                req.handle.served_by = self.sid
                req.handle._finish_resolve(
                    predictions[sl].copy(), confidence[sl].copy(),
                    latency_ms, deadline_missed, spans,
                )
        except BaseException:
            # A claimed handle is invisible to every other resolver (the
            # claim guard no-ops them), so whatever just raised, the
            # already-claimed handles MUST still be finished here — their
            # results exist — or their callers would block forever.
            for req, sl, latency_ms, deadline_missed, spans in resolutions:
                if not req.handle.done():
                    req.handle.model_version = version
                    req.handle.served_by = self.sid
                    req.handle._finish_resolve(
                        predictions[sl].copy(), confidence[sl].copy(),
                        latency_ms, deadline_missed, spans,
                    )
            raise

    # -- reporting -------------------------------------------------------

    def device_stats(self) -> dict:
        """The served books, fetched from the device: ground truth.

        A replica whose books cannot be read (a card fault mid-dispatch)
        is reported honestly as unreadable rather than as a fake zero, and
        the cluster sum marks itself accordingly.
        """
        try:
            with self._lock:
                served = int(self._stats["served"])
                counts = self._stats["class_counts"].cpu().tolist()
            return {"served": served,
                    "class_counts": [int(c) for c in counts]}
        except Exception:
            return {"served": 0, "class_counts": [], "unreadable": True}

    def snapshot(self) -> dict:
        """Host-side replica facts for the report.

        `_lock` brackets exactly what it guards: the books and the
        model-swap pair. `status`/`quarantined` are GIL-atomic publishes
        their writers never lock.
        """
        with self._lock:
            batches = self._batch_index
            bucket_counts = dict(sorted(self._bucket_counts.items()))
            model_version = self.model_version
        return {
            "status": self.status,
            "batches": batches,
            "bucket_counts": bucket_counts,
            "quarantined": self.quarantined,
            "model_version": model_version,
            "retraces": self.retraces,
            "devices": 1,
        }
