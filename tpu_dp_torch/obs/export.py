"""Perfetto / Chrome-trace export of the recorded spans and counters (the
port of `tpu_dp.obs.export`).

`chrome://tracing` and https://ui.perfetto.dev both consume the Trace
Event JSON object format — ``{"traceEvents": [...]}`` with complete
("ph": "X") slices carrying microsecond ``ts``/``dur`` — so a training
run's host-side step breakdown renders on a zoomable timeline with zero
TensorBoard dependency (`torch.profiler`'s Chrome trace of a step range,
`tpu_dp_torch.utils.profiling`, covers the device; this export answers
the *host loop* questions:
where did step 4017's 80 ms go, and on which rank).

Layout: one trace *process* per rank (``pid`` = rank), one *thread* per
span name (``tid`` — data_wait/h2d/dispatch/device stack as parallel
tracks), metadata events naming both, and counter snapshots as "C" events
on a counters track. Span slices within a step are laid out back-to-back
from the step's wall-clock start — exactly the order the trainer measures
them in its loop, so the picture is honest, not reconstructed.

The format contract is pinned by `validate_trace` (used by the tests and
by `write_trace`): a file this module writes that Perfetto would reject
is a bug here, caught at write time, not in a postmortem.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Mapping, Sequence

from tpu_dp_torch.obs.spans import STEP_SPANS

#: tids [gen * stride, (gen+1) * stride) are rollback-generation ``gen``'s
#: span tracks: each generation renders as its own track group, so a
#: post-rollback replay of step K sits on separate tracks from the
#: rolled-back attempt instead of overdrawing it.
_GEN_TID_STRIDE = 32
#: the counters track sits far above any plausible generation block.
_COUNTER_TID_OFFSET = 10**6


def _span_tid(name: str, gen: int, order: dict[tuple[int, str], int]) -> int:
    key = (gen, name)
    if key not in order:
        in_gen = sum(1 for g, _ in order if g == gen)
        order[key] = gen * _GEN_TID_STRIDE + in_gen
    return order[key]


def to_trace_events(
    records: Sequence[Mapping[str, Any]],
    rank: int = 0,
    counter_points: Sequence[Mapping[str, Any]] = (),
    process_name: str | None = None,
) -> dict:
    """Build the Trace Event JSON object for one rank's span records.

    ``records`` are `SpanRecorder` entries (``{"step", "ts", "spans"}``);
    ``counter_points`` are optional ``{"ts", "counters": {...}}`` dicts
    rendered as Chrome counter ("C") events. ``ts`` is wall-clock seconds;
    events are emitted in microseconds as the format requires.
    """
    rank = int(rank)
    events: list[dict] = []
    tid_order: dict[tuple[int, str], int] = {
        (0, name): i for i, name in enumerate(STEP_SPANS)
    }
    events.append({
        "name": "process_name", "ph": "M", "pid": rank, "tid": 0,
        "args": {"name": process_name or f"tpu_dp rank {rank}"},
    })
    for rec in records:
        t_us = float(rec["ts"]) * 1e6
        spans = rec["spans"]
        # Each rollback generation gets its OWN track group (tid block):
        # a post-rollback trace previously interleaved two attempts at the
        # same step index on one track, which rendered as overlapping
        # slices — now the replay sits under "<span> [gen N]" threads and
        # the rolled-back attempt stays legible next to it.
        gen = int(rec.get("gen", 0))
        # Slices go out in the recorder's span order, laid back-to-back —
        # the loop measures them sequentially, so the timeline is honest.
        ordered = [n for n in STEP_SPANS if n in spans] + [
            n for n in spans if n not in STEP_SPANS
        ]
        for name in ordered:
            dur_us = max(0.0, float(spans[name]) * 1e3)  # ms → µs
            ev = {
                "name": name,
                "cat": "step",
                "ph": "X",
                "ts": round(t_us, 3),
                "dur": round(dur_us, 3),
                "pid": rank,
                "tid": _span_tid(name, gen, tid_order),
                "args": {"step": int(rec["step"])},
            }
            if gen:
                ev["args"]["gen"] = gen
            events.append(ev)
            t_us += dur_us
    for (gen, name), tid in sorted(tid_order.items(), key=lambda kv: kv[1]):
        events.append({
            "name": "thread_name", "ph": "M", "pid": rank, "tid": tid,
            "args": {"name": name if not gen else f"{name} [gen {gen}]"},
        })
    for point in counter_points:
        t_us = round(float(point["ts"]) * 1e6, 3)
        for cname, value in sorted(point.get("counters", {}).items()):
            if not isinstance(value, (int, float)):
                continue
            events.append({
                "name": cname, "ph": "C", "ts": t_us, "pid": rank,
                "tid": _COUNTER_TID_OFFSET, "args": {"value": value},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def merge_traces(traces: Sequence[Mapping[str, Any]]) -> dict:
    """Concatenate per-rank traces into one timeline (pids keep them apart)."""
    events: list[dict] = []
    for tr in traces:
        events.extend(tr.get("traceEvents", []))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def instant_event(name: str, ts_s: float, pid: int = 0,
                  args: Mapping[str, Any] | None = None,
                  scope: str = "g") -> dict:
    """A Perfetto instant ("i") event — a vertical marker for rollbacks
    and other run events. ``scope``
    "g" renders it across the whole timeline (vs "p" process / "t"
    thread)."""
    ev = {
        "name": str(name), "ph": "i", "ts": round(float(ts_s) * 1e6, 3),
        "pid": int(pid), "tid": 0, "s": scope,
    }
    if args:
        ev["args"] = dict(args)
    return ev


def write_trace(path: str | os.PathLike, trace: Mapping[str, Any]) -> Path:
    """Validate + atomically write an already-built trace object.

    The shared tail of `export_perfetto` and of merged traces: a file
    this module writes that Perfetto would reject is a bug here, caught
    at write time, not in a postmortem.
    """
    errors = validate_trace(trace)
    if errors:  # a malformed export is a bug in this module — fail loudly
        raise ValueError(f"refusing to write invalid trace: {errors[:3]}")
    from tpu_dp_torch.obs._atomic import atomic_write_text

    return atomic_write_text(path, json.dumps(trace))


def export_perfetto(
    path: str | os.PathLike,
    records: Sequence[Mapping[str, Any]],
    rank: int = 0,
    counter_points: Sequence[Mapping[str, Any]] = (),
    process_name: str | None = None,
) -> Path:
    """Write one rank's trace JSON to ``path`` (dirs created); returns it.

    Atomic (tmp + rename): an export raced by a preemption must never
    leave a half-written JSON where CI or a human expects a trace.
    """
    trace = to_trace_events(records, rank=rank,
                            counter_points=counter_points,
                            process_name=process_name)
    return write_trace(path, trace)


_REQUIRED_BY_PH = {
    "X": ("name", "ts", "dur", "pid", "tid"),
    "M": ("name", "pid", "args"),
    "C": ("name", "ts", "pid", "args"),
    "i": ("name", "ts", "pid"),
}


def validate_trace(trace: Any) -> list[str]:
    """Structural check against the Trace Event JSON object format.

    Returns a list of human-readable problems (empty = loadable by
    chrome://tracing / Perfetto): the top level must be an object with a
    ``traceEvents`` list, and every event needs a known ``ph`` with that
    phase's required keys, numeric non-negative ``ts``/``dur``, and
    integer ``pid``/``tid``.
    """
    errors: list[str] = []
    if not isinstance(trace, dict) or not isinstance(
        trace.get("traceEvents"), list
    ):
        return ["top level must be an object with a traceEvents list"]
    for i, ev in enumerate(trace["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _REQUIRED_BY_PH:
            errors.append(f"{where}: unknown ph {ph!r}")
            continue
        for key in _REQUIRED_BY_PH[ph]:
            if key not in ev:
                errors.append(f"{where}: ph={ph} missing {key!r}")
        for key in ("ts", "dur"):
            if key in ev and (
                not isinstance(ev[key], (int, float)) or ev[key] < 0
            ):
                errors.append(f"{where}: {key} must be a non-negative number")
        for key in ("pid", "tid"):
            if key in ev and not isinstance(ev[key], int):
                errors.append(f"{where}: {key} must be an int")
    return errors
