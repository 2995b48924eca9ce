"""Shape-bucketed dynamic batching: coalesce requests into padded buckets.

Copy of the JAX package's module of the same name (host code); the
PyTorch port never imports the JAX package.

The batching-vs-latency trade-off (the Gemma-on-TPU serving comparison,
PAPERS.md): bigger batches amortize dispatch and win throughput, but every
millisecond spent waiting for batch-mates is a millisecond of user-visible
latency. The batcher resolves it with two triggers — dispatch as soon as
the pending work fills the *largest* bucket (nothing to wait for), or when
the oldest pending request has waited ``max_wait_ms`` (no request pays
more than the cap to help its batch-mates).

The **bucket ladder** is the recompilation contract: every formed batch is
zero-padded up to a size from a fixed ascending ladder (1/2/4/…/max), so
the engine's per-bucket pre-compiled programs (`make_serve_step`) cover
every batch that can ever exist and the RecompileGuard stays silent — the
serving analogue of the fixed-shape discipline the training stack enforces
(docs/ANALYSIS.md DP305). Padded rows carry ``weight=0`` so they never
leak into results or the device-side stats.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from tpu_dp_torch.serve.queue import Request, RequestQueue

#: the default ladder — powers of two up to 32 (ServeConfig.buckets)
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


def parse_buckets(spec: str) -> tuple[int, ...]:
    """Parse `ServeConfig.buckets`: comma-separated ascending sizes."""
    try:
        buckets = tuple(int(s) for s in spec.split(",") if s.strip())
    except ValueError:
        raise ValueError(
            f"buckets must be comma-separated integers, got {spec!r}"
        ) from None
    if not buckets:
        raise ValueError(f"buckets spec {spec!r} is empty")
    return buckets


class BucketLadder:
    """A fixed ascending ladder of padded batch sizes."""

    def __init__(self, buckets=DEFAULT_BUCKETS):
        buckets = tuple(int(b) for b in buckets)
        if not buckets:
            raise ValueError("bucket ladder must not be empty")
        if any(b < 1 for b in buckets):
            raise ValueError(f"bucket sizes must be positive: {buckets}")
        if list(buckets) != sorted(set(buckets)):
            raise ValueError(
                f"bucket ladder must be strictly ascending: {buckets}"
            )
        self.buckets = buckets

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def pick(self, n: int) -> int:
        """Smallest bucket holding ``n`` images (n must fit the ladder)."""
        if n < 1:
            raise ValueError(f"cannot bucket {n} images")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"{n} images exceed the largest bucket {self.max_batch}"
        )


@dataclasses.dataclass
class FormedBatch:
    """One padded batch ready for dispatch, plus its form-time accounting."""

    requests: list[Request]     # FIFO order; slices index into images
    slices: list[slice]         # per-request row ranges within images
    expired: list[Request]      # shed at collect time (handles resolved)
    bucket: int                 # padded batch size (ladder element)
    valid: int                  # real (unpadded) image count
    images: np.ndarray          # (bucket, H, W, C), zero-padded
    weight: np.ndarray          # f32 (bucket,): 1.0 real, 0.0 padding
    formed: float               # perf_counter stamp when forming finished
    formed_ts: float            # wall-clock twin (obs records)
    form_ms: float              # time spent assembling/padding

    @property
    def occupancy(self) -> float:
        """Valid fraction of the padded batch — the efficiency the bucket
        ladder trades for shape stability (gauged as
        ``serve.batch_occupancy``)."""
        return self.valid / self.bucket if self.bucket else 0.0


class DynamicBatcher:
    """Single-consumer batch former over a `RequestQueue`."""

    def __init__(self, queue: RequestQueue, ladder: BucketLadder,
                 max_wait_ms: float = 5.0):
        self.queue = queue
        self.ladder = ladder
        self.max_wait_ms = float(max_wait_ms)

    def next_batch(self, timeout_s: float = 0.1) -> FormedBatch | str:
        """Block for the next dispatchable batch.

        Returns a `FormedBatch`, or ``"timeout"`` (nothing arrived —
        re-check your stop flag), or ``"closed"`` (queue closed and fully
        drained). A wake where every pending request had already expired
        returns a batch with ``requests=[]`` — the engine still consumes
        it for the expired handles' accounting.
        """
        why = self.queue.await_work(
            target_images=self.ladder.max_batch,
            max_wait_s=self.max_wait_ms / 1e3,
            timeout_s=timeout_s,
        )
        if why in ("timeout", "closed"):
            return why
        now = time.perf_counter()
        requests, expired = self.queue.collect(self.ladder.max_batch, now)
        return self.form(requests, expired, now)

    def form(self, requests: list[Request], expired: list[Request],
             now: float) -> FormedBatch:
        """Pad ``requests`` into their bucket (pure — unit-testable)."""
        t0 = time.perf_counter()
        valid = sum(r.n for r in requests)
        if not requests:
            return FormedBatch(
                requests=[], slices=[], expired=expired, bucket=0, valid=0,
                images=np.empty((0,) + self.queue.image_shape,
                                self.queue.image_dtype),
                weight=np.empty((0,), np.float32),
                formed=now, formed_ts=time.time(), form_ms=0.0,
            )
        bucket = self.ladder.pick(valid)
        images = np.zeros((bucket,) + self.queue.image_shape,
                          dtype=self.queue.image_dtype)
        weight = np.zeros((bucket,), np.float32)
        slices: list[slice] = []
        offset = 0
        for req in requests:
            sl = slice(offset, offset + req.n)
            images[sl] = req.images
            weight[sl] = 1.0
            slices.append(sl)
            offset += req.n
        form_ms = (time.perf_counter() - t0) * 1e3
        return FormedBatch(
            requests=requests, slices=slices, expired=expired,
            bucket=bucket, valid=valid, images=images, weight=weight,
            formed=time.perf_counter(), formed_ts=time.time(),
            form_ms=form_ms,
        )
