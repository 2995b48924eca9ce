"""tpu_dp_torch.serve — the serving path of the port: queue → dynamic
batcher → per-bucket serve programs (on a card CUDA graphs captured at
warmup) on one device, or fanned out over N replicas (port of
`tpu_dp.serve`).

Requests enter a bounded, deadline- and SLO-class-aware `RequestQueue`; a
`DynamicBatcher` coalesces them into zero-padded batches at fixed bucket
sizes; an `InferenceEngine` over one `ServeReplica` dispatches them and
resolves the handles. `ServeCluster` is the self-healing tier: N replicas
behind one queue, with heartbeat health and quarantine, failover with
exact books, drain/rejoin published as membership epochs, and hot swap.
``python -m tpu_dp_torch.serve`` runs the synthetic-load smoke (and, with
``--replicas N``, the chaos scenarios) with the loadgen's exact audit.
"""

from tpu_dp_torch.serve.batcher import (
    DEFAULT_BUCKETS,
    BucketLadder,
    DynamicBatcher,
    FormedBatch,
    parse_buckets,
)
from tpu_dp_torch.serve.engine import (
    SERVE_SPANS,
    InferenceEngine,
    register_serve_costs,
)
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
from tpu_dp_torch.serve.replica import (
    LatencyBook,
    ServeReplica,
    parse_fault_specs,
    serve_report_core,
)
from tpu_dp_torch.serve.router import ServeCluster

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
    "ServeCluster",
    "ServeReplica",
    "ShedError",
    "arrival_offsets",
    "parse_buckets",
    "parse_fault_specs",
    "register_serve_costs",
    "run_load",
    "serve_report_core",
]
