"""Fleet aggregation — cross-rank live telemetry out of per-rank streams
(the port of `tpu_dp.obs.fleet`; the port's heartbeats carry the same
``me`` stamp and ``me<E>/`` homes, and the published stream keeps the JAX
package's schema tag, so either package reads the other's).

Every live signal the obs layer publishes is per-rank: the metrics sink
is rank 0's view, each heartbeat file is one rank's step cadence, each
serve replica streams its own health. But data-parallel training is a
fleet phenomenon — the step clock is set by the *slowest* arrival at
each collective, so the first-order production signals are relative:
which rank is late, by how much, and for how long. This module derives
them, live or in replay, from the files alone (collective-free, like
`health.py` — fleet aggregation must keep working exactly when the
collectives are what is wedged):

- ``fleet.step_skew_ms`` — max−min step-boundary arrival across ranks
  at the same (membership epoch, generation, step);
- ``fleet.skew_ratio`` — the slowest rank's step time over the
  leave-one-out median of the others (the live per-step generalization
  of `health.py`'s post-hoc straggler factor, same ``min_step_ms``
  floor against µs-scale jitter);
- ``fleet.slowest_rank`` + ``fleet.slowest_streak`` — attribution with
  persistence (a streak of one is scheduler noise; a climbing streak is
  a sick host);
- fleet-wide goodput / mfu and step-time p50/p95 over a rolling window;
- for serving runs, queue depth + per-class attainment aggregated
  across replicas (the router/replica streams the JAX package's
  ``serve/router.py`` registers).

Alignment follows the timeline's newest-attempt-wins sweep: records
group per ``(membership_epoch, generation, step)`` — a step replayed
after a guard rollback or re-split across an elastic regroup never
skews against its own stale attempt, and ranks of different membership
epochs are never compared (stale-world skew). The membership epoch
comes from the heartbeat record's own ``me`` stamp (`HeartbeatWriter`)
with the re-homed ``me<E>/`` directory name as the fallback for
pre-stamp streams.

The published stream (``<obs>/fleet.jsonl`` + promfile gauges) is
schema-versioned; readers refuse unknown schemas instead of guessing,
and `FleetPublisher` swallows every publish failure into a counter —
a full disk on the watcher must never raise into anything hot.

`obsctl fleet` is the CLI; `obsctl watch` evaluates rules over these
signals (``fleet.skew_ratio > 1.5``, ``anomaly:step_time_ms 4``) —
the substrate ROADMAP items 4 (autoscaler trigger) and 5 (canary
comparison) consume.
"""

from __future__ import annotations

import json
import re
from collections import deque
from pathlib import Path
from typing import Any, Iterable

from tpu_dp_torch.obs.counters import Counters, counters as _global_counters
from tpu_dp_torch.obs.spans import percentile
from tpu_dp_torch.obs.tail import JsonlTail

#: Schema tag on every published fleet record. Bump on breaking layout
#: change; `read_fleet_records` refuses unknown tags instead of guessing.
FLEET_SCHEMA = "tpu_dp.obs/fleet/v1"

#: Record kinds the fleet stream carries.
FLEET_KINDS = ("fleet_step", "fleet_serve")

#: Fleet signals a watch rule can target (obsctl extends WATCH_SIGNALS
#: with these; `fleet_signals` maps a fleet record onto them).
FLEET_SIGNALS = (
    "fleet.step_skew_ms", "fleet.skew_ratio", "fleet.slowest_streak",
    "fleet.step_time_p50_ms", "fleet.step_time_p95_ms",
    "fleet.goodput", "fleet.mfu",
    "fleet.queue_depth", "fleet.attainment",
)

_HEARTBEAT_RE = re.compile(r"^heartbeat_r(\d+)\.jsonl$")
_REPLICA_RE = re.compile(r"^replica_r(\d+)\.jsonl$")
_ME_DIR_RE = re.compile(r"^me(\d+)$")


class FleetError(RuntimeError):
    """A fleet stream that cannot be used as asked."""


class FleetSchemaError(FleetError):
    """A fleet record carrying a schema this build does not read —
    the typed refusal; consumers must never guess at unknown layouts."""


# --------------------------------------------------------------------------
# stream discovery
# --------------------------------------------------------------------------

def discover_streams(run_dir: Path) -> list[tuple[str, dict, Path]]:
    """(kind, meta, path) triples for every per-rank stream under a run.

    Kinds: ``heartbeat`` (meta {"me", "rank"} — ``me`` from the re-homed
    ``obs/me<E>/`` dir, 0 for the launch root), ``metrics`` (rank 0's
    sink), ``router`` / ``replica`` (the serving tier's streams). Safe
    to call repeatedly — live discovery registers files as ranks create
    them (a joiner's heartbeat appears mid-run)."""
    run_dir = Path(run_dir)
    out: list[tuple[str, dict, Path]] = []
    metrics = run_dir / "metrics.jsonl"
    if metrics.exists():
        out.append(("metrics", {}, metrics))
    obs_dir = run_dir / "obs"
    roots: list[tuple[int, Path]] = []
    if obs_dir.is_dir():
        roots.append((0, obs_dir))
        for child in sorted(obs_dir.iterdir()):
            m = _ME_DIR_RE.match(child.name)
            if m and child.is_dir():
                roots.append((int(m.group(1)), child))
    elif any(run_dir.glob("heartbeat_r*.jsonl")):
        # bare heartbeat tree: the run dir IS the obs dir
        roots.append((0, run_dir))
    for me, root in roots:
        for path in sorted(root.glob("heartbeat_r*.jsonl")):
            m = _HEARTBEAT_RE.match(path.name)
            if m:
                out.append(("heartbeat",
                            {"me": me, "rank": int(m.group(1))}, path))
        for path in sorted(root.glob("replica_r*.jsonl")):
            m = _REPLICA_RE.match(path.name)
            if m:
                out.append(("replica", {"sid": int(m.group(1))}, path))
        router = root / "serve_router.jsonl"
        if router.exists():
            out.append(("router", {}, router))
    return out


# --------------------------------------------------------------------------
# aggregation
# --------------------------------------------------------------------------

class FleetAggregator:
    """Align per-rank records into per-step fleet records.

    Feed it records via `ingest` (live: from a `StreamTailer` drain;
    replay: `replay()` walks the files itself); it returns newly
    completed fleet records. A ``fleet_step`` record emits as soon as
    ``expected_world`` ranks reported a (me, gen, step) — live
    publication must not wait for a straggler that may never arrive
    beyond the step itself — and `flush()` emits the best remaining
    attempt per step with ≥ 2 ranks (replay tails, shrunken worlds).
    """

    def __init__(self, run_dir: str | Path, *,
                 min_step_ms: float = 1.0,
                 spike_ratio: float = 3.0,
                 window: int = 64,
                 expected_world: int | None = None):
        self.run_dir = Path(run_dir)
        # Same denominator floor as HealthMonitor: at µs-scale step times
        # (tiny CPU smokes) scheduler jitter alone exceeds any factor.
        self.min_step_ms = float(min_step_ms)
        self.spike_ratio = float(spike_ratio)
        self.expected_world = expected_world
        # (me, gen, step) -> {rank: beat}
        self._groups: dict[tuple[int, int, int], dict[int, dict]] = {}
        # step -> highest (me, gen) already emitted for it
        self._emitted: dict[int, tuple[int, int]] = {}
        self._step_times: deque[float] = deque(maxlen=max(2, int(window)))
        self._slowest_rank: int | None = None
        self._slowest_streak = 0
        self._last_mfu: float | None = None
        self._last_goodput: float | None = None
        # serve aggregation state: newest router record + per-sid status
        self._router: dict | None = None
        self._replicas: dict[int, dict] = {}
        #: ranks seen per membership epoch — the live world estimate when
        #: no explicit ``expected_world`` is given.
        self._ranks_seen: dict[int, set[int]] = {}
        #: ranks whose heartbeat STREAM was discovered, per epoch — the
        #: preferred world estimate (`note_stream`): a stream's existence
        #: is known before its beats arrive, so a step never emits with
        #: a not-yet-read rank missing (which would mis-attribute skew).
        self._ranks_expected: dict[int, set[int]] = {}

    # -- ingestion -----------------------------------------------------

    def note_stream(self, kind: str, meta: dict) -> None:
        """Register a discovered stream BEFORE its records arrive — a
        heartbeat file's existence pins its rank into the epoch's
        expected world, so live emission waits for every known rank."""
        if kind == "heartbeat" and "rank" in meta:
            me = int(meta.get("me", 0))
            self._ranks_expected.setdefault(me, set()).add(
                int(meta["rank"]))

    def ingest(self, kind: str, meta: dict, rec: dict) -> list[dict]:
        """One record from one stream; returns fleet records it completed."""
        if kind == "heartbeat":
            return self._ingest_beat(meta, rec)
        if kind == "metrics":
            self._ingest_metrics(rec)
            return []
        if kind == "router":
            self._router = rec
            return [self._serve_record()]
        if kind == "replica":
            sid = int(meta.get("sid", rec.get("sid", -1)))
            self._replicas[sid] = rec
            return []
        return []

    def _ingest_beat(self, meta: dict, rec: dict) -> list[dict]:
        try:
            rank = int(rec["rank"])
            step = int(rec["step"])
            ts = float(rec["ts"])
            step_ms = float(rec["step_ms"])
        except (KeyError, TypeError, ValueError):
            return []
        # The record's own ``me`` stamp wins (a writer re-homed without a
        # directory move); the re-homed dir name is the fallback for
        # pre-stamp streams.
        me = int(rec.get("me", meta.get("me", 0)))
        gen = int(rec.get("gen", 0))
        self._ranks_seen.setdefault(me, set()).add(rank)
        group = self._groups.setdefault((me, gen, step), {})
        group[rank] = {"rank": rank, "step": step, "ts": ts,
                       "step_ms": step_ms}
        expected = self._ranks_expected.get(me)
        world = self.expected_world or (
            len(expected) if expected else len(self._ranks_seen[me]))
        if len(group) >= max(2, world):
            return self._emit(me, gen, step, group)
        return []

    def _ingest_metrics(self, rec: dict) -> None:
        """Track the newest fleet-wide efficiency gauges the rank-0 sink
        publishes (they are already slice-global; the fleet record just
        re-exports the freshest value next to the skew signals)."""
        for key, attr in (("mfu", "_last_mfu"), ("goodput", "_last_goodput")):
            v = rec.get(key)
            if isinstance(v, (int, float)):
                setattr(self, attr, float(v))
        cnt = rec.get("counters")
        if isinstance(cnt, dict):
            if isinstance(cnt.get("obs.mfu"), (int, float)):
                self._last_mfu = float(cnt["obs.mfu"])
            if isinstance(cnt.get("obs.goodput"), (int, float)):
                self._last_goodput = float(cnt["obs.goodput"])

    # -- derivation ----------------------------------------------------

    def _emit(self, me: int, gen: int, step: int,
              group: dict[int, dict]) -> list[dict]:
        attempt = (me, gen)
        prev = self._emitted.get(step)
        if prev is not None and prev >= attempt:
            # a stale attempt completing late must not skew against the
            # already-emitted newer one (no stale-world skew)
            self._groups.pop((me, gen, step), None)
            return []
        self._emitted[step] = attempt
        self._groups.pop((me, gen, step), None)

        by_rank = sorted(group.values(), key=lambda b: b["rank"])
        arrivals = [b["ts"] for b in by_rank]
        skew_ms = (max(arrivals) - min(arrivals)) * 1e3
        slowest = max(by_rank, key=lambda b: b["step_ms"])
        others = sorted(b["step_ms"] for b in by_rank
                        if b["rank"] != slowest["rank"])
        median = max(percentile(others, 50), self.min_step_ms)
        ratio = slowest["step_ms"] / median
        if slowest["rank"] == self._slowest_rank:
            self._slowest_streak += 1
        else:
            self._slowest_rank = slowest["rank"]
            self._slowest_streak = 1
        # the fleet step clock: the step is as slow as its slowest rank
        fleet_ms = slowest["step_ms"]
        self._step_times.append(fleet_ms)
        ordered = sorted(self._step_times)
        rec = {
            "schema": FLEET_SCHEMA,
            "kind": "fleet_step",
            "ts": max(arrivals),
            "step": step,
            "me": me,
            "gen": gen,
            "world": len(by_rank),
            "ranks": [b["rank"] for b in by_rank],
            "step_skew_ms": round(skew_ms, 3),
            "skew_ratio": round(ratio, 3),
            "slowest_rank": slowest["rank"],
            "slowest_ms": round(slowest["step_ms"], 3),
            "median_other_ms": round(median, 3),
            "slowest_streak": self._slowest_streak,
            "step_time_ms": round(fleet_ms, 3),
            "step_time_p50_ms": round(percentile(ordered, 50), 3),
            "step_time_p95_ms": round(percentile(ordered, 95), 3),
            "spike": ratio >= self.spike_ratio,
        }
        # absence over fabrication: goodput/mfu keys exist only once the
        # metrics sink actually published them
        if self._last_goodput is not None:
            rec["goodput"] = self._last_goodput
        if self._last_mfu is not None:
            rec["mfu"] = self._last_mfu
        return [rec]

    def _serve_record(self) -> dict:
        """Aggregate the serving tier's newest router + replica records."""
        router = self._router or {}
        classes = router.get("classes") or {}
        attain = [blk.get("attainment") for blk in classes.values()
                  if isinstance(blk, dict)
                  and isinstance(blk.get("attainment"), (int, float))]
        statuses: dict[str, int] = {}
        for rep in self._replicas.values():
            st = str(rep.get("status", "unknown"))
            statuses[st] = statuses.get(st, 0) + 1
        rec = {
            "schema": FLEET_SCHEMA,
            "kind": "fleet_serve",
            "ts": float(router.get("ts", 0.0)),
            "queue_depth": int(router.get("queue_depth", 0)),
            "replicas_live": router.get("replicas_live"),
            "replica_status": statuses,
            "classes": classes,
        }
        if attain:
            # the fleet attainment is the WORST class — an autoscaler
            # trigger must see the class that is missing its SLO, not an
            # average that a healthy bulk class papers over
            rec["attainment"] = round(min(attain), 4)
        return rec

    # -- replay / flush ------------------------------------------------

    def flush(self) -> list[dict]:
        """Emit the best remaining attempt per step with ≥ 2 ranks.

        Live emission waits for the full expected world; at end of
        stream (replay, or a rank that died mid-step) the newest
        attempt with enough ranks for a median is still a fleet fact."""
        out: list[dict] = []
        by_step: dict[int, tuple[int, int]] = {}
        for (me, gen, step), group in self._groups.items():
            if len(group) < 2:
                continue
            cur = by_step.get(step)
            if cur is None or (me, gen) > cur:
                by_step[step] = (me, gen)
        for step in sorted(by_step):
            me, gen = by_step[step]
            group = self._groups.get((me, gen, step))
            if group:
                out.extend(self._emit(me, gen, step, group))
        self._groups.clear()
        return out

    def replay(self) -> list[dict]:
        """One-shot aggregation over the run's artifacts as they stand."""
        out: list[dict] = []
        streams = discover_streams(self.run_dir)
        # pin every discovered rank into the expected world FIRST: files
        # replay sequentially, and a step must not emit mid-walk with
        # the not-yet-read ranks missing (mis-attributed skew)
        for kind, meta, _ in streams:
            self.note_stream(kind, meta)
        for kind, meta, path in streams:
            for rec in JsonlTail(path).poll():
                out.extend(self.ingest(kind, meta, rec))
        out.extend(self.flush())
        out.sort(key=lambda r: (r.get("ts", 0.0), r.get("step", -1)))
        return out


# --------------------------------------------------------------------------
# publication
# --------------------------------------------------------------------------

class FleetPublisher:
    """Append fleet records to ``fleet.jsonl`` + export promfile gauges.

    Every failure path is swallowed into ``fleet.publish_errors``: the
    publisher may run inside a watcher sharing a host with training, and
    a full disk or torn rename must never raise into anything hot."""

    def __init__(self, out_path: str | Path | None,
                 prom_path: str | Path | None = None,
                 registry: Counters | None = None):
        self.out_path = Path(out_path) if out_path else None
        self.prom_path = Path(prom_path) if prom_path else None
        self.registry = _global_counters if registry is None else registry
        self.published = 0

    def publish(self, recs: Iterable[dict]) -> None:
        recs = [r for r in recs if isinstance(r, dict)]
        if not recs:
            return
        try:
            if self.out_path is not None:
                self.out_path.parent.mkdir(parents=True, exist_ok=True)
                with open(self.out_path, "a", encoding="utf-8") as f:
                    for rec in recs:
                        f.write(json.dumps(rec) + "\n")
            for rec in recs:
                for name, value in fleet_signals(rec).items():
                    if name.startswith("fleet."):
                        self.registry.gauge(name, value)
                if rec.get("kind") == "fleet_step":
                    self.registry.gauge("fleet.slowest_rank",
                                        float(rec["slowest_rank"]))
            if self.prom_path is not None:
                from tpu_dp_torch.obs.promfile import write_promfile

                write_promfile(self.prom_path, registry=self.registry)
            self.published += len(recs)
        except Exception:
            # never into the hot loop; the counter is the evidence
            self.registry.inc("fleet.publish_errors")


def fleet_signals(rec: dict) -> dict[str, float]:
    """The watch signals one fleet record carries.

    ``fleet_step`` also republishes the fleet step clock as plain
    ``step_time_ms`` — deliberately, so a self-baselining
    ``anomaly:step_time_ms`` rule works over the fleet stream (where
    the per-rank metrics sink may publish no step gauge at obs=basic).
    """
    sig: dict[str, float] = {}
    kind = rec.get("kind")
    if kind == "fleet_step":
        for key, name in (
            ("step_skew_ms", "fleet.step_skew_ms"),
            ("skew_ratio", "fleet.skew_ratio"),
            ("slowest_streak", "fleet.slowest_streak"),
            ("step_time_p50_ms", "fleet.step_time_p50_ms"),
            ("step_time_p95_ms", "fleet.step_time_p95_ms"),
            ("goodput", "fleet.goodput"),
            ("mfu", "fleet.mfu"),
        ):
            if isinstance(rec.get(key), (int, float)):
                sig[name] = float(rec[key])
        if isinstance(rec.get("step_time_ms"), (int, float)):
            sig["step_time_ms"] = float(rec["step_time_ms"])
    elif kind == "fleet_serve":
        if isinstance(rec.get("queue_depth"), (int, float)):
            sig["fleet.queue_depth"] = float(rec["queue_depth"])
        if isinstance(rec.get("attainment"), (int, float)):
            sig["fleet.attainment"] = float(rec["attainment"])
    return sig


# --------------------------------------------------------------------------
# reading + reporting
# --------------------------------------------------------------------------

def read_fleet_records(path: str | Path) -> list[dict]:
    """Parse a fleet stream; refuses unknown schemas (`FleetSchemaError`).

    Torn lines are skipped (forensic tolerance), but a RECOGNIZABLE
    record with the wrong schema tag is a hard refusal — a reader that
    guesses at a future layout certifies numbers it cannot interpret."""
    out: list[dict] = []
    for rec in JsonlTail(Path(path)).poll():
        schema = rec.get("schema")
        if schema != FLEET_SCHEMA:
            raise FleetSchemaError(
                f"fleet record in {path} has schema {schema!r}; this "
                f"build reads {FLEET_SCHEMA!r}")
        out.append(rec)
    return out


def summarize(records: list[dict]) -> dict:
    """One fleet report out of a fleet stream — the artifact the CI lane
    archives (`artifacts/fleet_report.json`) and humans read first."""
    steps = [r for r in records if r.get("kind") == "fleet_step"]
    serve = [r for r in records if r.get("kind") == "fleet_serve"]
    report: dict[str, Any] = {
        "schema": FLEET_SCHEMA,
        "steps": len(steps),
        "serve_records": len(serve),
    }
    if steps:
        worst = max(steps, key=lambda r: r.get("skew_ratio", 0.0))
        hist: dict[int, int] = {}
        for r in steps:
            hist[r["slowest_rank"]] = hist.get(r["slowest_rank"], 0) + 1
        ordered = sorted(r["step_time_ms"] for r in steps)
        report.update({
            "first_step": min(r["step"] for r in steps),
            "last_step": max(r["step"] for r in steps),
            "max_skew_ratio": worst.get("skew_ratio"),
            "max_skew_step": worst.get("step"),
            "slowest_rank": max(hist, key=lambda r: hist[r]),
            "slowest_rank_hist": {str(k): v
                                  for k, v in sorted(hist.items())},
            "max_slowest_streak": max(r["slowest_streak"] for r in steps),
            "max_step_skew_ms": max(r["step_skew_ms"] for r in steps),
            "step_time_p50_ms": round(percentile(ordered, 50), 3),
            "step_time_p95_ms": round(percentile(ordered, 95), 3),
            "spikes": sum(1 for r in steps if r.get("spike")),
        })
    if serve:
        last = serve[-1]
        report["serve"] = {
            "queue_depth": last.get("queue_depth"),
            "replicas_live": last.get("replicas_live"),
            "attainment": last.get("attainment"),
        }
    return report
