"""Chrome-trace parsing: one reader for the traces `torch.profiler` exports
(the port's counterpart of `tpu_dp.obs.xplane`, which reads the xplane
protobufs `jax.profiler` writes).

A captured trace directory holds one ``trace_r<rank:05d>.json`` per
capture (`utils.profiling.ChromeTrace`); this module finds the newest,
reads its ``traceEvents`` and aggregates them into the JAX package's
backend-neutral summary, from one of two sources:

- **device** (a card, NCCL): the CUDA kernel events (``cat`` "kernel").
  A collective is an NCCL kernel, classified by name (`NCCL_KINDS`, both
  spellings: ``ncclDevKernel_AllReduce_Sum_f32_RING_LL`` from NCCL 2.19
  on, ``ncclKernel_AllReduce_RING_LL_Sum_float`` before; ``SendRecv``,
  how NCCL runs ``all_to_all``, is an all-to-all). Every other kernel is
  compute, but `torch.cuda._sleep`'s spin kernels (``spin_kernel``),
  which bracket a session (`utils.profiling.PROFILE_LEAD_IN`), are
  neither: they are counted under ``skipped``. Copies and memsets are
  not kernels and count as neither. NCCL runs on its own stream, so the
  exposed communication is the NCCL time on that stream that no compute
  kernel on any stream covers.
- **host** (gloo: the CPU, and gloo ranks on a card): the CPU op events
  (``cat`` "cpu_op"), a collective classified by its ``c10d::``
  dispatcher op (`HOST_KINDS`). gloo's own ``gloo:*`` events never name
  the kind (a reduce-scatter runs as ``gloo:all_reduce``), but they are
  the collective's execution on gloo's threads, so their spans count as
  communication time. Compute is the ``aten::`` ops nested in no
  collective (outermost ones only, so an op's children are not counted
  twice).
"""

from __future__ import annotations

import json
import os
import re
from glob import glob
from pathlib import Path

#: Collective kinds under the HLO names the JAX package uses
#: (`tpu_dp.obs.xplane.COLLECTIVE_KINDS`), so both packages' reports key
#: the same kinds and ``obsctl diff`` compares them.
COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all",
)

#: NCCL kernel name -> kind, first match wins (both spellings).
NCCL_KINDS = (
    (re.compile(r"^nccl(?:Dev)?Kernel_AllReduce"), "all-reduce"),
    (re.compile(r"^nccl(?:Dev)?Kernel_ReduceScatter"), "reduce-scatter"),
    (re.compile(r"^nccl(?:Dev)?Kernel_AllGather"), "all-gather"),
    (re.compile(r"^nccl(?:Dev)?Kernel_SendRecv"), "all-to-all"),
    (re.compile(r"^nccl(?:Dev)?Kernel_Broadcast"), "broadcast"),
)

#: ``c10d::`` dispatcher op -> kind.
HOST_KINDS = {
    "c10d::allreduce_": "all-reduce",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_": "all-gather",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::broadcast_": "broadcast",
}

#: Device kernels that are neither compute nor communication.
SPIN_MARKER = "spin_kernel"

TRACE_GLOBS = ("trace_r*.json", "*.pt.trace.json")


class KinetoError(ValueError):
    """Typed parse failure: a missing or unreadable trace, a trace with no
    recognizable events, or a window with no op events. The parser refuses
    what it does not understand rather than returning an empty summary
    (the JAX package's `XplaneError`)."""


def find_trace(trace_dir: str | os.PathLike) -> Path | None:
    """Newest Chrome trace under ``trace_dir`` (recursive), or None."""
    paths = [p for g in TRACE_GLOBS
             for p in glob(f"{trace_dir}/**/{g}", recursive=True)]
    return Path(sorted(paths)[-1]) if paths else None


def load_events(path: str | os.PathLike) -> list[dict]:
    """The complete (``"ph": "X"``) events of one Chrome trace."""
    try:
        doc = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, ValueError) as e:
        raise KinetoError(f"cannot read Chrome trace {path}: {e}") from e
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise KinetoError(f"{path}: no traceEvents list")
    return [e for e in events
            if isinstance(e, dict) and e.get("ph") == "X"
            and isinstance(e.get("ts"), (int, float))]


def nccl_kind(name: str) -> str | None:
    """The collective kind of an NCCL kernel name, or None."""
    for pattern, kind in NCCL_KINDS:
        if pattern.match(name):
            return kind
    return None


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted union of (start, end) intervals."""
    out: list[tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _total(merged: list[tuple[float, float]]) -> float:
    return sum(e - s for s, e in merged)


def _subtract_total(a: list[tuple[float, float]],
                    b: list[tuple[float, float]]) -> float:
    """|A \\ B| for two MERGED interval lists (seconds)."""
    out = 0.0
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while cur < e:
            if k >= len(b) or b[k][0] >= e:
                out += e - cur
                break
            bs, be = b[k]
            if bs > cur:
                out += bs - cur
            cur = max(cur, be)
            k += 1
    return out


def exposed_seconds(comm: list[tuple[float, float]],
                    compute: list[tuple[float, float]]) -> float:
    """Wall seconds where a collective is running and NO compute op is —
    the exposed-communication time. Inputs are raw interval lists;
    merging happens here."""
    return _subtract_total(_merge(comm), _merge(compute))


class _Walk:
    """The summary's accumulator (the JAX package's `_PlaneWalk`)."""

    def __init__(self):
        self.ops: dict[str, dict] = {}
        self.by_cat: dict[str, float] = {}
        self.comm_iv: list[tuple[float, float]] = []
        self.compute_iv: list[tuple[float, float]] = []
        self.span: list[float] = []
        self.skipped: dict[str, int] = {}

    def note(self, name: str, start_s: float, dur_s: float,
             kind: str | None) -> None:
        """One op event; ``kind`` its collective kind, None for compute."""
        rec = self.ops.get(name)
        if rec is None:
            rec = self.ops[name] = {"name": name, "base": kind or name,
                                    "count": 0, "dur_s": 0.0, "flops": 0,
                                    "bytes": 0,
                                    "category": "comm" if kind
                                    else "compute"}
        rec["count"] += 1
        rec["dur_s"] += dur_s
        self.by_cat[rec["category"]] = (
            self.by_cat.get(rec["category"], 0.0) + dur_s)
        iv = (start_s, start_s + dur_s)
        (self.comm_iv if kind else self.compute_iv).append(iv)
        self.span += iv

    def skip(self, what: str) -> None:
        self.skipped[what] = self.skipped.get(what, 0) + 1

    def summary(self, source: str, plane: str,
                extra_comm: list[tuple[float, float]] = ()) -> dict:
        coll_counts: dict[str, int] = {}
        coll_dur: dict[str, float] = {}
        for rec in self.ops.values():
            if rec["category"] == "comm":
                k = rec["base"]
                coll_counts[k] = coll_counts.get(k, 0) + rec["count"]
                coll_dur[k] = coll_dur.get(k, 0.0) + rec["dur_s"]
        comm_merged = _merge(self.comm_iv + list(extra_comm))
        compute_merged = _merge(self.compute_iv)
        return {
            "schema": 1,
            "source": source,
            "plane": plane,
            "window_s": (max(self.span) - min(self.span)) if self.span
            else 0.0,
            "op_busy_s": sum(r["dur_s"] for r in self.ops.values()),
            "by_category": self.by_cat,
            "ops": sorted(self.ops.values(), key=lambda r: -r["dur_s"]),
            "collectives": {"counts": coll_counts, "dur_s": coll_dur},
            "comm_s": _total(comm_merged),
            "compute_s": _total(compute_merged),
            "exposed_comm_s": _subtract_total(comm_merged, compute_merged),
            "skipped": self.skipped,
        }


def device_summary(events: list[dict]) -> dict:
    """Summary of a trace's CUDA kernel events (the device source)."""
    walk = _Walk()
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = str(e.get("name", ""))
        if SPIN_MARKER in name:
            walk.skip("spin")
            continue
        walk.note(name, e["ts"] * 1e-6, float(e.get("dur", 0.0)) * 1e-6,
                  nccl_kind(name))
    return walk.summary("device", "cuda kernels")


def _outermost(events: list[dict]) -> list[tuple[dict, dict | None]]:
    """Each event with the outermost event enclosing it on its thread
    (None for an outermost one); events sorted by start, the longer first
    on a tie, so a parent precedes its children."""
    by_tid: dict = {}
    for e in events:
        by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -float(e.get("dur", 0.0))))
        top, top_end = None, float("-inf")
        for e in evs:
            if top is not None and e["ts"] < top_end:
                out.append((e, top))
                continue
            top, top_end = e, e["ts"] + float(e.get("dur", 0.0))
            out.append((e, None))
    return out


def host_summary(events: list[dict]) -> dict:
    """Summary of a trace's CPU op events (the host source)."""
    walk = _Walk()
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and str(e.get("name", "")).startswith(("c10d::", "aten::"))]
    gloo = [e for e in events if str(e.get("name", "")).startswith("gloo:")]
    gloo_iv = []
    for e in gloo:
        t = e["ts"] * 1e-6
        gloo_iv.append((t, t + float(e.get("dur", 0.0)) * 1e-6))
    # Nesting is per thread: an aten op inside a c10d op or a gloo event
    # is the collective's own work.
    for e, parent in _outermost(ops + gloo):
        name = str(e.get("name", ""))
        if parent is not None or name.startswith("gloo:"):
            continue
        if name.startswith("c10d::"):
            kind = HOST_KINDS.get(name)
            if kind is None:
                walk.skip(name)
                continue
        else:
            kind = None
        walk.note(name, e["ts"] * 1e-6, float(e.get("dur", 0.0)) * 1e-6,
                  kind)
    return walk.summary("host", "cpu ops", extra_comm=gloo_iv)


def summarize(trace_dir: str | os.PathLike,
              source: str | None = None) -> dict:
    """Parse the newest trace under ``trace_dir`` into one summary dict.

    ::

        {"schema": 1, "source": "device"|"host", "plane": ...,
         "window_s", "op_busy_s", "by_category": {"comm"|"compute": s},
         "ops": [{"name", "base", "count", "dur_s", "flops", "bytes",
                  "category"}],
         "collectives": {"counts": {kind: events},
                          "dur_s": {kind: seconds}},
         "comm_s", "compute_s", "exposed_comm_s",
         "skipped": {what: events}, "path"}

    ``source`` picks the events; by default "host" when the trace holds
    CPU ops, else "device". ``comm_s``/``compute_s`` are merged-interval
    union lengths (kernels on two streams at once count their wall span
    once); ``exposed_comm_s`` is the comm time no compute interval
    covers. Raises `KinetoError` when no trace exists, it holds none of
    the source's events, or no op event landed.
    """
    path = find_trace(trace_dir)
    if path is None:
        raise KinetoError(f"no Chrome trace under {trace_dir}")
    events = load_events(path)
    has_cpu = any(e.get("cat") == "cpu_op" for e in events)
    has_kernels = any(e.get("cat") == "kernel" for e in events)
    if source is None:
        source = "host" if has_cpu else "device"
    if source not in ("host", "device"):
        raise KinetoError(f"source must be host|device, got {source!r}")
    if not (has_cpu if source == "host" else has_kernels):
        raise KinetoError(
            f"{path}: no {'CPU op' if source == 'host' else 'CUDA kernel'} "
            f"events — unrecognized trace for the {source} source "
            f"(categories: {sorted({str(e.get('cat')) for e in events})})")
    out = host_summary(events) if source == "host" else device_summary(
        events)
    if not out["ops"]:
        raise KinetoError(f"{path}: no op events in the trace — was a "
                          f"step actually executed inside the profiled "
                          f"region?")
    out["path"] = str(path)
    return out
