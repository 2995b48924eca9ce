"""tpu_dp_torch.obs — the port's runtime telemetry (the names of
`tpu_dp.obs` that are ported).

**Live** (gated by ``train.obs``):

- `spans`    — per-step span recording (data_wait / h2d / dispatch /
  device) in a ring buffer with p50/p95/p99 rollups;
- `counters` — the process-wide counter/gauge registry every subsystem
  publishes into, and the card's memory gauges;
- `costs`    — per-program FLOP costs and the rolling MFU/goodput
  accounting the trainer publishes;
- `chips`    — the NVIDIA card registry (dense bf16 peak, HBM and NVLink
  GB/s by device name) behind MFU;
- `health`   — file-based cross-rank heartbeats, straggler attribution
  and hang detection (with the flight recorder's hang-dump trigger);
- `promfile` — atomic Prometheus-text-format export for node scrapers.

**Crash forensics** (always on): `flightrec`, a bounded ring of
structured events dumped on every `Trainer.fit` exit path.

**Comm attribution** (``obs.comm_profile_steps``): `commprof`, the
in-run windows, their reconciliation with the books of what ran and the
``obs.comm_ms`` / ``obs.exposed_comm_ms`` / ``obs.overlap_frac`` gauges,
over `kineto`, the reader of `torch.profiler`'s Chrome traces.

**Post-hoc**: `export`, the Perfetto / Chrome-trace JSON of the spans
(rollback generations as separate track groups); `obsctl` (``python -m
tpu_dp_torch.obs``: timeline, stragglers, merge-trace, diff, watch,
fleet) over `fleet` and `tail`; `objective`, the tuner's score.

The package imports nothing but the standard library at load (the memory
gauges import torch lazily).
"""

from tpu_dp_torch.obs.costs import (
    CostRegistry,
    EfficiencyMeter,
    goodput,
    peak_flops,
    resolve_flops_per_step,
)
from tpu_dp_torch.obs.costs import registry as cost_registry
from tpu_dp_torch.obs.counters import (
    Counters,
    counters,
    update_device_memory_gauges,
)
from tpu_dp_torch.obs.export import (
    export_perfetto,
    instant_event,
    merge_traces,
    to_trace_events,
    validate_trace,
    write_trace,
)
from tpu_dp_torch.obs.flightrec import FlightRecorder
from tpu_dp_torch.obs.flightrec import recorder as flight_recorder
from tpu_dp_torch.obs.health import (
    HealthError,
    HealthIssue,
    HealthMonitor,
    HeartbeatWriter,
)
from tpu_dp_torch.obs.promfile import render_prom, write_promfile
from tpu_dp_torch.obs.spans import STEP_SPANS, SpanRecorder, percentile

__all__ = [
    "CostRegistry",
    "Counters",
    "EfficiencyMeter",
    "FlightRecorder",
    "HealthError",
    "HealthIssue",
    "HealthMonitor",
    "HeartbeatWriter",
    "STEP_SPANS",
    "SpanRecorder",
    "cost_registry",
    "counters",
    "export_perfetto",
    "flight_recorder",
    "goodput",
    "instant_event",
    "merge_traces",
    "peak_flops",
    "percentile",
    "render_prom",
    "resolve_flops_per_step",
    "to_trace_events",
    "update_device_memory_gauges",
    "validate_trace",
    "write_promfile",
    "write_trace",
]
