"""Process-wide counter/gauge registry — the numbers every subsystem emits.

Copy of `tpu_dp.obs.counters` for the PyTorch port (the port never imports
the JAX package). Not carried over: the JAX-backed device-memory gauge
and the metric-name registries the JAX package's linter reads.

The stack already *generates* operational signals nobody collects: retry
attempts (`resilience/retry.py`), silent-recompile retraces
(`analysis/recompile.py`), snapshot write/wait seconds
(`resilience/snapshot.py`), preemption signals (`resilience/preempt.py`).
This module is the single sink those subsystems publish into, and the
single source the trainer snapshots into `metrics.jsonl` and the Perfetto
export (docs/OBSERVABILITY.md "Counter registry").

Design constraints, in order:

- **Signal-safe**: `PreemptionHandler._handle` increments from a signal
  handler, where taking a `threading.Lock` the interrupted main thread
  might hold would deadlock the process at the worst possible moment.
  `inc`/`gauge` therefore use plain dict ops under the GIL — a concurrent
  read-modify-write can lose an increment, which is an acceptable
  telemetry error and the price of never deadlocking.
- **Import-light**: imported by the serving modules at load; imports
  nothing but the standard library.
- **Always-on**: publishing is unconditional (an `inc` is one dict write;
  gating every call site on `train.obs` would couple four subsystems to
  the trainer's config). What the *trainer* does with the registry —
  snapshot it into records, or ignore it — is what `train.obs` gates.

Names are dotted, `subsystem.metric[_unit]`: `retry.attempts`,
`snapshot.write_s`, `recompile.retraces`, `device.mem_in_use_bytes`.
Counters accumulate; gauges hold the last written value.
"""

from __future__ import annotations

from typing import Any


class Counters:
    """A flat registry of monotonic counters and last-value gauges."""

    def __init__(self):
        self._counts: dict[str, float] = {}
        self._gauges: dict[str, float] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        """Add ``value`` to counter ``name`` (creating it at 0).

        Lock-free on purpose — see the module docstring; safe to call from
        signal handlers and background writer threads.
        """
        self._counts[name] = self._counts.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        """Set gauge ``name`` to ``value`` (last write wins)."""
        self._gauges[name] = float(value)

    def get(self, name: str, default: float = 0.0) -> float:
        if name in self._counts:
            return self._counts[name]
        return self._gauges.get(name, default)

    def snapshot(self) -> dict[str, float]:
        """One flat point-in-time dict of every counter and gauge.

        Values are rounded to 6 decimals — these land in JSON records, and
        15-digit float seconds are noise there.
        """
        out = {}
        for src in (self._counts, self._gauges):
            for k, v in list(src.items()):
                out[k] = round(v, 6)
        return out

    def snapshot_typed(self) -> tuple[dict[str, float], dict[str, float]]:
        """(counters, gauges) as two dicts — the Prometheus exporter needs
        the type split (`# TYPE ... counter|gauge`) that the flat
        `snapshot` deliberately erases."""
        return (
            {k: round(v, 6) for k, v in list(self._counts.items())},
            {k: round(v, 6) for k, v in list(self._gauges.items())},
        )

    def reset(self) -> None:
        """Drop everything — test isolation only."""
        self._counts.clear()
        self._gauges.clear()


#: The process-wide registry every subsystem publishes into.
counters = Counters()

