"""tpu_dp_torch.serve — the serving path of the port: queue → dynamic
batcher → per-bucket serve step on one device (port of `tpu_dp.serve`).

Requests enter a bounded, deadline- and SLO-class-aware `RequestQueue`; a
`DynamicBatcher` coalesces them into zero-padded batches at fixed bucket
sizes; an `InferenceEngine` over one `ServeReplica` dispatches them and
resolves the handles. ``python -m tpu_dp_torch.serve`` runs the
synthetic-load smoke with the loadgen's exact audit. The multi-replica
tier (router, failover, drain/rejoin) comes in a later slice.
"""

from tpu_dp_torch.serve.batcher import (
    DEFAULT_BUCKETS,
    BucketLadder,
    DynamicBatcher,
    FormedBatch,
    parse_buckets,
)
from tpu_dp_torch.serve.engine import SERVE_SPANS, InferenceEngine
from tpu_dp_torch.serve.loadgen import ARRIVAL_PATTERNS, arrival_offsets, run_load
from tpu_dp_torch.serve.queue import (
    SHED_CLOSED,
    SHED_DEADLINE,
    SHED_QUEUE_FULL,
    SHED_REPLICA_FAILED,
    Request,
    RequestHandle,
    RequestQueue,
    ShedError,
)
from tpu_dp_torch.serve.replica import LatencyBook, ServeReplica

__all__ = [
    "ARRIVAL_PATTERNS",
    "BucketLadder",
    "DEFAULT_BUCKETS",
    "DynamicBatcher",
    "FormedBatch",
    "InferenceEngine",
    "LatencyBook",
    "Request",
    "RequestHandle",
    "RequestQueue",
    "SERVE_SPANS",
    "SHED_CLOSED",
    "SHED_DEADLINE",
    "SHED_QUEUE_FULL",
    "SHED_REPLICA_FAILED",
    "ServeReplica",
    "ShedError",
    "arrival_offsets",
    "parse_buckets",
    "run_load",
]
