"""The single-replica inference engine: queue → batcher → one ServeReplica
(port of `tpu_dp.serve.engine`).

    submit() → RequestQueue → DynamicBatcher → per-bucket serve step
    (`tpu_dp_torch.train.step.make_serve_step`) → resolve handles

The engine owns the admission edge (a `RequestQueue` with SLO classes and
typed shedding) and the shared books (span recorder, per-class latency
book); the replica owns the model on its device, the per-bucket steps and
the dispatch thread. `swap_model` hot-swaps a new weight version between
batches — zero dropped requests, every response stamped with the version
that served it.

Telemetry: per-request spans ``queue_wait / batch_form / h2d / device /
d2h`` (+ ``total``) in a `SpanRecorder`; counters ``serve.accepted /
serve.shed[.reason] / serve.completed / serve.deadline_missed /
serve.batches`` (+ per-class ``.c<k>`` twins) and the
``serve.batch_occupancy`` gauge in the process-wide registry.

Checkpoint loading waits for the checkpoint port: the engine serves the
weights the model holds (`tpu_dp_torch.compat.load_jax_variables` loads
the JAX package's variables into it).
"""

from __future__ import annotations

import numpy as np

from tpu_dp_torch.data.cifar import IMAGE_SHAPE
from tpu_dp_torch.obs.counters import Counters, counters as _global_counters
from tpu_dp_torch.obs.spans import SpanRecorder
from tpu_dp_torch.parallel.dist import resolve_device
from tpu_dp_torch.serve.batcher import BucketLadder
from tpu_dp_torch.serve.queue import (
    SHED_CLOSED, RequestHandle, RequestQueue, shed_counted,
)
from tpu_dp_torch.serve.replica import SERVE_SPANS, LatencyBook, ServeReplica

__all__ = ["SERVE_SPANS", "InferenceEngine"]


class InferenceEngine:
    """Batched-inference engine on one device (module docstring): serves
    CIFAR-shaped uint8 images ``[n, 32, 32, 3]``.

    ``device`` defaults to the CUDA card and raises without one; the tests
    pass ``device="cpu"``.
    """

    def __init__(
        self,
        model,
        device=None,
        buckets=None,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        slo_ms: float = 50.0,
        shed_headroom_ms: float = 0.0,
        registry: Counters | None = None,
        class_slo_ms: dict[int, float] | None = None,
    ):
        self.device = resolve_device(device)
        self.ladder = BucketLadder(
            buckets if buckets is not None else BucketLadder().buckets
        )
        self.slo_ms = float(slo_ms)
        self.class_slo_ms = dict(class_slo_ms or {})
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
        self.recorder = SpanRecorder()
        self.latency_book = LatencyBook()
        self.replica = ServeReplica(
            sid=0,
            model=model,
            device=self.device,
            ladder=self.ladder,
            queue=self.queue,
            recorder=self.recorder,
            latency_book=self.latency_book,
            max_wait_ms=max_wait_ms,
            registry=self._counters,
        )
        self.model = self.replica.model
        self.num_classes = self.replica.num_classes
        self._published_version = self.replica.model_version

    @property
    def model_version(self) -> int:
        return self.replica.model_version

    @property
    def retraces(self) -> int:
        return self.replica.retraces

    def device_stats(self) -> dict:
        """The served books, fetched from the device: ground truth."""
        return self.replica.device_stats()

    # -- hot swap --------------------------------------------------------

    def swap_model(self, state_dict, version: int | None = None) -> int:
        """Hot-swap the served weights (a state dict of the served model,
        e.g. `tpu_dp_torch.compat.convert_variables` of JAX variables)
        between batches. Returns the version now pending; versions count
        published swaps."""
        self._published_version = (self._published_version + 1
                                   if version is None else int(version))
        self.replica.set_pending_state(state_dict, self._published_version)
        return self._published_version

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "InferenceEngine":
        """Launch the dispatch thread, which first runs every bucket's step
        once (per-bucket ms in ``replica.warmup_ms``) and returns when that
        warmup is done. The warmup runs on the dispatch thread because
        cuDNN's plans are cached per thread."""
        if self.replica.status == "running":
            raise RuntimeError("engine already started")
        self.replica.start(warmup=True)
        return self

    def stop(self, drain: bool = True) -> None:
        """Close admission; drain (default) or abandon the queue; join.

        ``drain=False`` sheds everything still pending with reason
        ``closed``. Re-raises a dispatch-thread failure.
        """
        self.queue.close()
        if not drain:
            self.replica.stop_now()
        self.replica.join()
        if not drain:
            reqs, _ = self.queue.collect(self.ladder.max_batch * 10**6)
            for req in reqs:
                shed_counted(self._counters, req.handle, SHED_CLOSED)
        err = self.replica.take_error()
        if err is not None:
            raise RuntimeError("serve dispatch thread failed") from err

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

    def report(self) -> dict:
        """SLO attainment + latency percentiles + shed/bucket accounting,
        from the per-request span records (a ring of the last 4096)."""
        out = self.replica.latency_report(self.class_slo_ms, self.slo_ms)
        snap = self.replica.snapshot()
        out.update({
            "batches": snap["batches"],
            "bucket_counts": snap["bucket_counts"],
            "retraces": self.retraces,
            "device_stats": self.device_stats(),
            "model_version": self.replica.model_version,
            "world": 1,
            "device": str(self.device),
        })
        return out

    # -- constructors ----------------------------------------------------

    @classmethod
    def from_serve_config(cls, model, serve_cfg, **kwargs):
        """Build from a `tpu_dp_torch.config.ServeConfig`."""
        from tpu_dp_torch.config import parse_class_slo_ms
        from tpu_dp_torch.serve.batcher import parse_buckets

        return cls(
            model,
            buckets=parse_buckets(serve_cfg.buckets),
            max_wait_ms=serve_cfg.max_wait_ms,
            max_queue=serve_cfg.max_queue,
            slo_ms=serve_cfg.slo_ms,
            shed_headroom_ms=serve_cfg.shed_headroom_ms,
            class_slo_ms=parse_class_slo_ms(serve_cfg.class_slo_ms),
            **kwargs,
        )
