"""One serving replica: per-bucket serve steps + a dispatch worker (port of
`tpu_dp.serve.replica`, its core).

A `ServeReplica` owns the model on its device, one serve step per bucket
of the ladder, the device-resident served books, pinned host staging
buffers, and one dispatch thread that pulls padded batches from a shared
`RequestQueue`. The queue, the span recorder and the per-class latency
book are shared with the engine that reads the report.

Where the JAX replica calls ``jax.block_until_ready`` (after the host →
device copy, and after the forward), this one synchronizes the device's
current stream, so the ``h2d`` / ``device`` / ``d2h`` spans measure the
same three things. Host batches are staged through pinned buffers and
copied with ``non_blocking=True``.

Not in this slice (they wait for a later one): fault injection,
heartbeats, the flight recorder, the profiler window, the
`RecompileGuard` (``retraces`` reports 0: eager PyTorch has no retrace)
and the router (health facts, failover): a dispatch failure sheds everything
``engine_error`` and closes the queue.

Hot swap: `set_pending_state` parks a new state dict (placed on the
device off the dispatch thread); the loop loads it **between batches**,
so every response carries the ``model_version`` that computed it.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from tpu_dp_torch.obs.counters import Counters, counters as _global_counters
from tpu_dp_torch.obs.spans import SpanRecorder, percentile
from tpu_dp_torch.serve.batcher import BucketLadder, DynamicBatcher, FormedBatch
from tpu_dp_torch.serve.queue import SHED_CLOSED, RequestQueue, shed_counted
from tpu_dp_torch.train.step import init_serve_stats, make_serve_step

#: per-request span names, in pipeline order.
SERVE_SPANS = ("queue_wait", "batch_form", "h2d", "device", "d2h")


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


class ServeReplica:
    """One replica's serve steps + dispatch worker (module docstring).

    ``model`` is an `nn.Module` holding its weights; the replica moves it
    to ``device`` and puts it in eval mode. ``queue``, ``recorder`` and
    ``latency_book`` are shared with the engine.
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
        max_wait_ms: float = 5.0,
        registry: Counters | None = None,
    ):
        self.sid = int(sid)
        self.device = torch.device(device)
        self.ladder = ladder
        self.queue = queue
        self.recorder = recorder
        self.latency_book = latency_book
        self.batcher = DynamicBatcher(queue, ladder, max_wait_ms=max_wait_ms)
        self._counters = _global_counters if registry is None else registry

        # Inference state: the model's weights on this replica's device,
        # eval mode, no autograd state — serving never needs optimizer
        # slots or gradients.
        self.model = model.to(self.device).eval()
        self.model.requires_grad_(False)
        self.model_version = 1
        self._pending_state = None  # (device state dict, version)
        self.num_classes = int(model.num_classes)
        self._stats = init_serve_stats(self.num_classes, self.device)

        # Pinned host staging + device input buffers, one pair per bucket:
        # the host → device copy is asynchronous, and every batch of a
        # bucket reuses the same buffers (the dispatch loop synchronizes
        # after each copy, so a staging buffer is never overwritten while
        # a copy from it is in flight).
        pin = self.device.type == "cuda"
        self._host: dict[int, dict[str, torch.Tensor]] = {}
        self._dev: dict[int, dict[str, torch.Tensor]] = {}
        img_dtype = torch.from_numpy(
            np.zeros((), queue.image_dtype)).dtype
        for b in ladder.buckets:
            shapes = {"image": ((b,) + queue.image_shape, img_dtype),
                      "weight": ((b,), torch.float32)}
            self._host[b] = {
                k: torch.empty(s, dtype=d, pin_memory=pin)
                for k, (s, d) in shapes.items()
            }
            self._dev[b] = {
                k: torch.empty(s, dtype=d, device=self.device)
                for k, (s, d) in shapes.items()
            }
        self._programs: dict[int, object] = {}

        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._batch_index = 0
        self._bucket_counts: dict[int, int] = {}
        # Brackets the device books' update with the forward, and guards
        # the shared recorder + latency book (device_stats/report vs the
        # dispatch thread).
        self._lock = threading.Lock()

        self.warmup_ms: dict[int, float] = {}
        self.status = "idle"  # idle | running | stopped | dead

    # -- programs --------------------------------------------------------

    def _program(self, bucket: int):
        prog = self._programs.get(bucket)
        if prog is None:
            prog = make_serve_step(self.model, self.device, bucket)
            self._programs[bucket] = prog
        return prog

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def warmup(self) -> dict[int, float]:
        """Run every bucket's step once on an all-padding batch (weight 0,
        so the books count nothing); per-bucket wall ms. On a card this
        also builds and loads the kernels before the first request. It
        warms the calling thread: `start(warmup=True)` runs it on the
        dispatch thread."""
        times: dict[int, float] = {}
        for bucket in self.ladder.buckets:
            t0 = time.perf_counter()
            batch = self._place_batch(
                bucket,
                np.zeros((bucket,) + self.queue.image_shape,
                         self.queue.image_dtype),
                np.zeros((bucket,), np.float32),
            )
            with self._lock:
                self._stats, _ = self._program(bucket)(self._stats, batch)
            self._sync()
            times[bucket] = round((time.perf_counter() - t0) * 1e3, 2)
        return times

    @property
    def retraces(self) -> int:
        """Always 0: eager PyTorch runs each bucket's step as it is, and
        the recompile guard of the JAX package has no counterpart yet."""
        return 0

    # -- hot swap --------------------------------------------------------

    def set_pending_state(self, state_dict, version: int) -> None:
        """Park a new state dict; loaded between batches (never mid-batch).
        Placement onto the device happens here, off the dispatch thread."""
        placed = {k: torch.as_tensor(v).to(self.device)
                  for k, v in state_dict.items()}
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        with self._lock:
            self._pending_state = (placed, int(version))

    def _apply_pending_swap(self) -> None:
        """Dispatch-thread only: load a parked version between batches."""
        with self._lock:
            pending, self._pending_state = self._pending_state, None
            if pending is None:
                return
            state, version = pending
            self.model.load_state_dict(state, strict=True)
            self.model_version = version
        self._counters.gauge("serve.model_version", self.model_version)

    # -- lifecycle -------------------------------------------------------

    def start(self, warmup: bool = False) -> "ServeReplica":
        """Launch the dispatch thread; with ``warmup``, the thread first
        runs `warmup` (times in ``warmup_ms``) and `start` returns once
        it is done, re-raising a warmup failure.

        The warmup belongs on the dispatch thread: PyTorch keeps cuDNN's
        handles and its cache of convolution plans per thread, so a warmup
        run on another thread leaves the first live batch of every bucket
        to build its plans again.
        """
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(f"replica {self.sid} already running")
        self._stop.clear()
        self.status = "running"
        ready = threading.Event()
        self._thread = threading.Thread(
            target=self._run,
            args=(warmup, ready),
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

    def _run(self, warmup: bool, ready: threading.Event) -> None:
        try:
            if warmup:
                self.warmup_ms = self.warmup()
        except BaseException as e:
            self._error = e
            self.status = "dead"
            return
        finally:
            ready.set()
        self._loop()

    def stop_now(self) -> None:
        """Abandon mode: exit after at most the in-flight batch."""
        self._stop.set()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            if not self._thread.is_alive():
                self._thread = None

    def take_error(self) -> BaseException | None:
        err, self._error = self._error, None
        return err

    # -- the dispatch loop ----------------------------------------------

    def _loop(self) -> None:
        batch = None
        try:
            # Flag-bounded service loop: lifetime ends with the stop flag
            # or the queue's close, not with a deadline.
            while True:
                if self._stop.is_set():  # abandon mode: stop(drain=False)
                    self.status = "stopped"
                    return
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
                self._run_batch(batch)
                batch = None
        except BaseException as e:
            self._error = e
            self.status = "dead"
            pending = [
                r for r in (batch.requests
                            if isinstance(batch, FormedBatch) else [])
                if not r.handle.done()
            ]
            # Nobody to fail over to: neither the in-flight batch nor
            # anything queued may wait forever on a dead loop.
            self.queue.close()
            reqs, _ = self.queue.collect(self.ladder.max_batch * 10**6)
            for req in pending + reqs:
                shed_counted(self._counters, req.handle, "engine_error")

    def _place_batch(self, bucket: int, images: np.ndarray,
                     weight: np.ndarray) -> dict[str, torch.Tensor]:
        """Host batch → device through the bucket's pinned staging buffers
        (one path for warmup and live dispatch)."""
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
        t0 = time.perf_counter()
        dev_batch = self._place_batch(batch.bucket, batch.images,
                                      batch.weight)
        self._sync()
        t1 = time.perf_counter()
        version = self.model_version
        with self._lock:
            # The books are updated in place by the step: the lock spans
            # the update until it has landed, so a concurrent
            # device_stats() never reads them half-written.
            self._stats, out = self._program(batch.bucket)(
                self._stats, dev_batch
            )
            self._sync()
        t2 = time.perf_counter()
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
        resolutions = []
        missed_by_class: dict[int, int] = {}
        completed_by_class: dict[int, int] = {}
        try:
            with self._lock:
                for req, sl in zip(batch.requests, batch.slices):
                    if not req.handle._claim():
                        continue  # resolved elsewhere; books untouched
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
            for req, sl, latency_ms, deadline_missed, spans in resolutions:
                req.handle.model_version = version
                req.handle.served_by = self.sid
                req.handle._finish_resolve(
                    predictions[sl].copy(), confidence[sl].copy(),
                    latency_ms, deadline_missed, spans,
                )
        except BaseException:
            # Claimed handles are invisible to every other resolver, so
            # whatever raised, they must still be finished here.
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

    def latency_report(self, class_slo_ms: dict[int, float],
                       slo_ms: float) -> dict:
        """The report keys of `InferenceEngine.report`: overall attainment
        and latency percentiles from the span ring, per-class attainment
        from the latency book, both read under the replica's lock."""
        with self._lock:
            lat = sorted(
                rec["spans"]["total"] for rec in self.recorder.records()
            )
            rollup = self.recorder.rollup()
            classes = self.latency_book.rollup(class_slo_ms, slo_ms)
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
        snap = self._counters.snapshot()
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

    def device_stats(self) -> dict:
        """The served books, fetched from the device: ground truth."""
        with self._lock:
            served = int(self._stats["served"])
            counts = self._stats["class_counts"].cpu().tolist()
        return {"served": served, "class_counts": [int(c) for c in counts]}

    def snapshot(self) -> dict:
        """Host-side replica facts for the report."""
        with self._lock:
            batches = self._batch_index
            bucket_counts = dict(sorted(self._bucket_counts.items()))
            model_version = self.model_version
        return {
            "status": self.status,
            "batches": batches,
            "bucket_counts": bucket_counts,
            "model_version": model_version,
        }
