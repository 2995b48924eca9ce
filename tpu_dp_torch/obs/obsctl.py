"""obsctl — one forensic timeline out of every per-rank run artifact (the
port of `tpu_dp.obs.obsctl`: the port writes the JAX package's formats,
so each package's obsctl reads the other's run directories).

A dead run leaves its story scattered across disjoint files: rank-0's
``metrics.jsonl`` (schema-3 records + guard/elastic events), the
guardrail ``quarantine.jsonl``, per-rank-per-membership-epoch heartbeat
files, per-rank flight-recorder dumps, and the elastic membership
ledger. Each is internally consistent; none alone answers "what
happened". ``obsctl`` merges them — generation-aware on both axes
(guard rollback generations AND elastic membership epochs), so replayed
work never double-counts — into:

- ``timeline``    — the ordered, deduplicated event stream (divergence
  detected → rank attributed → eviction → rollback resume → completion,
  reconstructed from the artifacts directory alone);
- ``stragglers``  — post-hoc leave-one-out straggler attribution over
  every heartbeat dir (`HealthMonitor.scan`);
- ``merge-trace`` — one Perfetto file spanning ranks AND regroup
  generations, with evictions/rollbacks/regroups as instant-event
  markers;
- ``diff``        — a regression verdict of the run's mfu / goodput /
  p95 step time — and, for quantized-collective runs, the int8 codec's
  quant.overflow / quant.clip_blocks as per-step rates, and for
  comm-profiled runs the comm_ms / exposed_comm_ms / overlap_frac
  attribution gauges — against a ``BENCH_*.json`` baseline, exit-coded
  so CI can gate on it (``--write-baseline`` mints a baseline from a
  run);
- ``watch``       — the live ops surface: tails the metrics sink +
  heartbeats of a running (or, with ``--replay``, finished) run and
  evaluates declarative alert rules (``--rule 'mfu<0.9*baseline'``,
  ``--rule 'exposed_comm_ms>5'``, goodput, overflow rate, straggler
  ratio, stale heartbeats, fleet signals, self-baselining
  ``anomaly:SIGNAL K`` rules, and ``--profile tuned.json``-derived
  bounds), emitting timeline-compatible alert events and exit-coding 1
  on any trip / 2 when no rule ever saw data — the same semantics the
  MFU diff gate uses;
- ``fleet``       — the cross-rank surface (`tpu_dp_torch.obs.fleet`): tails
  every rank's heartbeat/metrics/serve streams concurrently, aligns per
  (membership epoch, generation, step), and publishes derived fleet
  signals (``fleet.step_skew_ms``, ``fleet.skew_ratio`` + slowest-rank
  attribution with streaks, fleet p50/p95, serve queue/attainment
  rollups) to a schema-versioned ``obs/fleet.jsonl`` + promfile —
  with the same rule engine and exit codes as ``watch``.

Run it as ``python -m tpu_dp_torch.obs <cmd> <run_dir>``; ``run_dir`` is
the training run's checkpoint root
(the tree that holds ``metrics.jsonl``, ``quarantine.jsonl``, ``obs/``,
``membership/``). Needs no accelerator and dispatches nothing to a
device: postmortems run in watcher processes. ``watch --profile`` (rules
from a tuned profile) waits for the port of the tune harness (ROADMAP
Queue 1 item 12) and exits 2.

Exit codes: 0 clean, 1 regression (``diff`` only), 2 usage/artifact
error.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from datetime import datetime, timezone
from pathlib import Path

from tpu_dp_torch.obs import flightrec
from tpu_dp_torch.obs.fleet import (
    FLEET_KINDS,
    FLEET_SCHEMA,
    FLEET_SIGNALS,
    FleetAggregator,
    FleetPublisher,
    discover_streams,
    fleet_signals,
    summarize as fleet_summarize,
)
from tpu_dp_torch.obs.health import HealthMonitor
from tpu_dp_torch.obs.spans import percentile
from tpu_dp_torch.obs.tail import JsonlTail, StreamTailer, read_jsonl

#: quarantine-log kinds → the metrics-stream event names, so the same
#: finding arriving via both files deduplicates instead of double-telling.
_QUARANTINE_KINDS = {
    "sdc": "guard_sdc",
    "spike": "guard_spike",
    "quarantine": "guard_quarantine",
    "tombstone": "guard_tombstone",
}

#: event kinds rendered as instant markers in ``merge-trace``.
MARKER_KINDS = (
    "guard_sdc", "guard_spike", "guard_quarantine", "guard_tombstone",
    "guard_trigger", "guard_rollback", "guard_halt", "eviction",
    "membership_epoch", "elastic_regroup", "elastic_departure",
    # the grow half (docs/RESILIENCE.md "Grow"): a preempted rank's
    # departure→join→grow-regroup round trip must be reconstructable
    # from artifacts alone, refusals (fencing verdicts) included.
    "elastic_grow", "rank_joined", "elastic_join", "elastic_join_request",
    "join_refused",
    "preempt_signal", "preempt_exit", "dump_request", "exit",
    # the serving tier's lifecycle (the JAX package's router): drain →
    # failover → swap must be reconstructable from artifacts alone.
    "model_swap", "replica_failed", "replica_drain", "replica_rejoin",
    "replica_quarantined", "replica_restored",
    # profiling windows (utils/profiling.StepProfiler + obs/commprof):
    # captured traces are discoverable from artifacts alone — the marker
    # args carry the trace path and step range, so merge-trace links
    # them; watch-rule trips render next to what they fired on.
    "profile_start", "profile_stop", "comm_profile", "alert",
    # fleet-stream skew spikes (`obs.fleet`): a step whose
    # skew_ratio crossed the spike threshold renders next to the guard /
    # elastic events it usually precedes.
    "fleet_skew",
)

#: Event kinds describing one REPLICATED decision that reaches the
#: timeline through several artifacts — the metrics stream, the
#: quarantine log, and every rank's flight recorder all record the same
#: verdict at the same step. Deduped on (kind, step); the first source
#: processed (metrics, which carries the richest detail) wins. Kinds NOT
#: listed are inherently per-rank facts (exits, evictions, departures,
#: preemption signals, serve dispatches) and are never merged away.
_REPLICATED_KINDS = frozenset({
    "guard_sdc", "guard_spike", "guard_quarantine", "guard_tombstone",
    "guard_trigger", "guard_halt", "guard_rollback",
    "elastic_trigger", "elastic_regroup", "elastic_grow",
    "epoch_start", "snapshot",
})

_ME_DIR_RE = re.compile(r"^me(\d+)$")


# --------------------------------------------------------------------------
# artifact discovery + loading
# --------------------------------------------------------------------------

def _parse_ts(value) -> float | None:
    """Epoch seconds from a float or an ISO-8601 string (or None)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return float(value)
    try:
        dt = datetime.fromisoformat(str(value))
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return dt.timestamp()
    except ValueError:
        return None


def _iso(ts: float) -> str:
    return datetime.fromtimestamp(ts, timezone.utc).isoformat(
        timespec="milliseconds"
    )


def _read_jsonl(path: Path) -> list[dict]:
    """Tolerant JSONL reader: torn lines (a record written while the host
    died) are expected in forensic inputs, not an error."""
    if not path.exists():
        return []
    out = []
    for line in path.read_text(encoding="utf-8").splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


#: filenames probed (in order) for a run's archived serve report.
_SERVE_REPORT_NAMES = ("serve_elastic_report.json", "serve_report.json")


class RunArtifacts:
    """Everything obsctl can find under one run directory."""

    def __init__(self, run_dir: str | Path,
                 metrics_path: str | Path | None = None,
                 serve_report_path: str | Path | None = None):
        self.run_dir = Path(run_dir)
        if not self.run_dir.exists():
            raise FileNotFoundError(f"run dir {self.run_dir} does not exist")
        self.metrics_path = (
            Path(metrics_path) if metrics_path
            else self.run_dir / "metrics.jsonl"
        )
        self.obs_dir = self.run_dir / "obs"
        self.fleet_path = self.obs_dir / "fleet.jsonl"
        self.quarantine_path = self.run_dir / "quarantine.jsonl"
        self.membership_dir = self.run_dir / "membership"
        self.alerts_path = self.run_dir / "alerts.jsonl"
        self.serve_report_path = None
        if serve_report_path:
            self.serve_report_path = Path(serve_report_path)
        else:
            for name in _SERVE_REPORT_NAMES:
                if (self.run_dir / name).exists():
                    self.serve_report_path = self.run_dir / name
                    break

    def serve_report(self) -> dict | None:
        """The run's audited serve report, when one was archived."""
        if self.serve_report_path is None or \
                not self.serve_report_path.exists():
            return None
        try:
            rec = json.loads(self.serve_report_path.read_text())
        except (OSError, ValueError):
            return None
        return rec if isinstance(rec, dict) else None

    def metrics(self) -> list[dict]:
        return _read_jsonl(self.metrics_path)

    def quarantine(self) -> list[dict]:
        return _read_jsonl(self.quarantine_path)

    def alerts(self) -> list[dict]:
        """Alert events an `obsctl watch --alerts-out` run recorded."""
        return _read_jsonl(self.alerts_path)

    def fleet_records(self) -> list[dict]:
        """The published fleet stream (`obsctl fleet`), schema-checked.

        RECORDS of an unknown schema are SKIPPED with a warning here —
        the timeline is forensic and must render what it can (a stream
        appended to by a newer build still has readable records) — while
        `read_fleet_records` callers that certify numbers (fleet replay,
        reports) get the hard refusal."""
        if not self.fleet_path.exists():
            return []
        out: list[dict] = []
        skipped = 0
        for rec in read_jsonl(self.fleet_path):
            if rec.get("schema") == FLEET_SCHEMA:
                out.append(rec)
            else:
                skipped += 1
        if skipped:
            print(f"obsctl: skipped {skipped} fleet record(s) in "
                  f"{self.fleet_path} with unknown schema (this build "
                  f"reads {FLEET_SCHEMA!r})", file=sys.stderr)
        return out

    def comm_report(self) -> dict | None:
        """The newest archived comm-attribution window, when one exists
        (`tpu_dp_torch.obs.commprof.write_comm_report` — obs/comm_report.json,
        falling back to the run root for hand-archived copies)."""
        from tpu_dp_torch.obs.commprof import CommProfileError, read_comm_report

        for cand in (self.obs_dir / "comm_report.json",
                     self.run_dir / "comm_report.json"):
            if cand.exists():
                try:
                    return read_comm_report(cand)
                except (OSError, ValueError, CommProfileError) as e:
                    print(f"obsctl: skipping unreadable comm report "
                          f"{cand}: {e}", file=sys.stderr)
        return None

    def heartbeat_dirs(self) -> list[tuple[int, Path]]:
        """(membership_epoch, dir) pairs holding heartbeat files; epoch 0
        is the launch topology's ``obs/`` root, ``obs/me<E>/`` the
        post-regroup re-homes (`Trainer._rebuild_observers`)."""
        out: list[tuple[int, Path]] = []
        roots = [self.obs_dir] if self.obs_dir.is_dir() else []
        # the run dir itself may BE the obs dir (bare heartbeat trees)
        if not roots and any(self.run_dir.glob("heartbeat_r*.jsonl")):
            roots = [self.run_dir]
        for root in roots:
            if any(root.glob("heartbeat_r*.jsonl")):
                out.append((0, root))
            for child in sorted(root.iterdir()):
                m = _ME_DIR_RE.match(child.name)
                if m and child.is_dir() and any(
                    child.glob("heartbeat_r*.jsonl")
                ):
                    out.append((int(m.group(1)), child))
        return out

    def flight_dumps(self) -> list[dict]:
        """Every readable, schema-matching flight-recorder dump."""
        roots = [d for d in (self.obs_dir, self.run_dir) if d.is_dir()]
        seen, dumps = set(), []
        for root in roots:
            for path in sorted(root.rglob(flightrec.DUMP_GLOB)):
                if path in seen:
                    continue
                seen.add(path)
                try:
                    dumps.append(flightrec.read_dump(path))
                except (OSError, ValueError) as e:
                    print(f"obsctl: skipping unreadable dump {path}: {e}",
                          file=sys.stderr)
        return dumps

    def membership_records(self) -> list[dict]:
        """Every membership-epoch record across ledger generations."""
        return self._ledger_files("*/epoch_*.json")

    def _ledger_files(self, pattern: str) -> list[dict]:
        if not self.membership_dir.is_dir():
            return []
        out = []
        for path in sorted(self.membership_dir.glob(pattern)):
            try:
                rec = json.loads(path.read_text())
            except (OSError, ValueError):
                continue
            if isinstance(rec, dict):
                rec["_ledger_generation"] = path.parent.name
                out.append(rec)
        return out

    def join_requests(self) -> list[dict]:
        """Every join request across ledger generations — the request
        file IS the durable record of the admission attempt (the joiner's
        own flight recorder starts fresh after its admission, so the
        request leg of the story lives on the ledger, not in a dump)."""
        return self._ledger_files("*/join_e*_r*.json")

    def join_refusals(self) -> list[dict]:
        """Every fencing refusal across ledger generations — a refused
        zombie/seat-conflict claim is part of the run's story too."""
        return self._ledger_files("*/join_refused_*.json")


# --------------------------------------------------------------------------
# generation sweeps (rollback generations + membership epochs)
# --------------------------------------------------------------------------

def sweep_rollback_generations(records: list[dict]) -> list[dict]:
    """Drop step-stamped records that a later rollback replayed over.

    The reader-side twin of `tpu_dp_torch.resilience.guard.live_records`, over
    the *metrics* stream: a ``guard_rollback`` event retires its
    predecessor generation at ``to_step`` — records of a retired
    generation with ``step > to_step`` describe undone work. Event
    records themselves (the rollback, its triggers) always survive: the
    timeline must show that the rewind HAPPENED, only the replayed-over
    per-step measurements are dead.
    """
    retired: dict[int, int] = {}
    for rec in records:
        if rec.get("event") == "guard_rollback":
            gen = int(rec.get("rollback_generation", 1)) - 1
            to_step = int(rec.get("to_step", 0))
            retired[gen] = min(retired.get(gen, to_step), to_step)
    out = []
    for rec in records:
        if "event" not in rec and "step" in rec and (
            "epoch" not in rec
        ):
            gen = int(rec.get("rollback_generation", 0))
            if gen in retired and int(rec["step"]) > retired[gen]:
                continue
        out.append(rec)
    return out


# --------------------------------------------------------------------------
# timeline
# --------------------------------------------------------------------------

def build_timeline(art: RunArtifacts, include_steps: bool = False) -> dict:
    """The merged, ordered, generation-deduplicated event stream.

    Returns ``{"events": [...], "stats": {...}}``; each event is
    ``{"ts", "iso", "kind", "source", ...}``. Step events (one per global
    optimizer step, surviving attempt only) are included when
    ``include_steps``; their coverage is always summarized in ``stats``.
    """
    events: list[dict] = []
    seen: set[tuple] = set()

    def add(kind: str, ts: float | None, source: str, **fields):
        if kind in _REPLICATED_KINDS:
            key = (kind, fields.get("step"))
            if key in seen:
                return
            seen.add(key)
        ev = {"ts": ts if ts is not None else 0.0, "kind": kind,
              "source": source}
        ev.update({k: v for k, v in fields.items() if v is not None})
        events.append(ev)

    # -- metrics stream (rank 0's schema-3 records) ---------------------
    metrics = sweep_rollback_generations(art.metrics())
    for rec in metrics:
        ts = _parse_ts(rec.get("ts"))
        gen = rec.get("rollback_generation")
        if "event" in rec:
            detail = {k: v for k, v in rec.items()
                      if k not in ("ts", "schema", "event")}
            add(rec["event"], ts, "metrics", step=rec.get("step"),
                gen=gen, detail=detail)
        elif "eval" in rec:
            add("eval", ts, "metrics", detail=rec["eval"])
        elif "epoch" in rec and "loss" in rec:
            add("epoch_complete", ts, "metrics", step=rec.get("step"),
                gen=gen,
                detail={"epoch": rec["epoch"], "loss": rec.get("loss")})

    # -- quarantine log -------------------------------------------------
    for rec in art.quarantine():
        kind = _QUARANTINE_KINDS.get(rec.get("kind"), rec.get("kind"))
        detail = {k: v for k, v in rec.items() if k not in ("ts", "kind")}
        add(kind, _parse_ts(rec.get("ts")), "quarantine",
            step=rec.get("step"), gen=rec.get("rollback_generation"),
            detail=detail)

    # -- membership ledger ---------------------------------------------
    for rec in art.membership_records():
        ts = _parse_ts(rec.get("ts"))
        epoch = rec.get("epoch")
        if epoch == 0:
            add("membership_formed", ts, "membership",
                detail={"members": rec.get("members"),
                        "world": rec.get("world")})
            continue
        add("membership_epoch", ts, "membership",
            detail={"epoch": epoch, "members": rec.get("members"),
                    "world": rec.get("world"),
                    "reason": rec.get("reason"),
                    "resume": rec.get("resume")})
        for dep in rec.get("departed") or ():
            add("eviction", ts, "membership", rank=dep.get("sid"),
                detail={"membership_epoch": epoch,
                        "reason": dep.get("reason")})
        for joined in rec.get("joined") or ():
            add("rank_joined", ts, "membership", rank=joined.get("sid"),
                detail={"membership_epoch": epoch,
                        "world": rec.get("world"),
                        "token": str(joined.get("token", ""))[:8]})

    # -- watch alerts (when a watcher archived them) --------------------
    for rec in art.alerts():
        add("alert", _parse_ts(rec.get("ts")), "watch",
            step=rec.get("step"),
            detail={k: rec.get(k)
                    for k in ("rule", "signal", "value", "bound")
                    if rec.get(k) is not None})

    # -- fleet stream (skew spikes published by `obsctl fleet`) ---------
    for rec in art.fleet_records():
        if rec.get("kind") == "fleet_step" and rec.get("spike"):
            add("fleet_skew", _parse_ts(rec.get("ts")), "fleet",
                step=rec.get("step"), rank=rec.get("slowest_rank"),
                detail={"skew_ratio": rec.get("skew_ratio"),
                        "step_skew_ms": rec.get("step_skew_ms"),
                        "slowest_streak": rec.get("slowest_streak"),
                        "me": rec.get("me")})

    # -- join requests + refusals (the admission story) -----------------
    for rec in art.join_requests():
        add("elastic_join_request", _parse_ts(rec.get("ts")), "membership",
            rank=rec.get("sid"),
            detail={"generation": rec.get("generation"),
                    "token": str(rec.get("token", ""))[:8]})
    for rec in art.join_refusals():
        add("join_refused", _parse_ts(rec.get("ts")), "membership",
            rank=rec.get("sid"),
            detail={"reason": rec.get("reason"), "by": rec.get("by"),
                    "generation": rec.get("_ledger_generation")})

    # -- flight-recorder dumps ------------------------------------------
    # Dump "step" cadence events are NOT timeline step events: the
    # heartbeat files are the canonical (generation-stamped, deduplicable)
    # step record, and emitting both would double-tell every step. They
    # are kept aside as a fallback for heartbeat-less runs (obs=off).
    dumps = art.flight_dumps()
    flight_steps: list[tuple[int | None, dict]] = []
    for dump in dumps:
        rank = dump.get("rank")
        has_exit = False
        for ev in dump.get("events", ()):
            kind = ev.get("kind", "event")
            if kind == "step":
                flight_steps.append((rank, ev))
                continue
            has_exit = has_exit or kind == "exit"
            detail = {k: v for k, v in ev.items()
                      if k not in ("ts", "kind", "step")}
            add(kind, _parse_ts(ev.get("ts")), "flightrec", rank=rank,
                step=ev.get("step"), detail=detail or None)
        if not has_exit:
            # A ring that wrapped past its own exit event (or a dump taken
            # mid-run via the hang sentinel) still yields one exit marker
            # from the dump envelope.
            add("exit", _parse_ts(dump.get("ts")), "flightrec", rank=rank,
                detail={"reason": dump.get("reason"),
                        "events_recorded": dump.get("total_recorded")})

    # -- step coverage from heartbeats (surviving attempt per step) -----
    # Replay happens on two axes: guard rollbacks (``gen`` stamps within
    # one heartbeat file) and elastic regroups (a whole new ``me<E>``
    # directory with reassigned dense ranks). A step's surviving attempt
    # is the one under the highest (membership_epoch, gen) — everything
    # below it was rewound or re-split away.
    best: dict[int, tuple[tuple[int, int], dict]] = {}
    beats_total = 0
    for me_epoch, hb_dir in art.heartbeat_dirs():
        mon = HealthMonitor(hb_dir, world=1)
        for rank, beats in mon.read_beats().items():
            for b in beats:
                beats_total += 1
                attempt = (me_epoch, int(b.get("gen", 0)))
                cur = best.get(b["step"])
                if cur is None or attempt >= cur[0]:
                    best[b["step"]] = (attempt, {**b, "me": me_epoch})
    if not best and flight_steps:
        # Heartbeat-less run (obs=off): the black boxes' step cadence is
        # the only coverage — same keep-highest-generation dedup.
        for rank, ev in flight_steps:
            beats_total += 1
            attempt = (0, int(ev.get("gen", 0)))
            cur = best.get(ev.get("step", -1))
            if cur is None or attempt >= cur[0]:
                best[ev.get("step", -1)] = (attempt, {
                    "rank": rank, "step": ev.get("step", -1),
                    "ts": ev.get("ts", 0.0),
                    "step_ms": ev.get("window_ms"),
                    "gen": ev.get("gen"), "me": 0,
                })
    replay_dropped = beats_total - len(best)
    if include_steps:
        for step, (attempt, b) in sorted(best.items()):
            add("step", b["ts"], "heartbeat", step=step,
                gen=b.get("gen"), rank=b.get("rank"),
                detail={"step_ms": b.get("step_ms"), "me": b["me"]})

    events.sort(key=lambda e: (e["ts"], e.get("step") or 0))
    for ev in events:
        ev["iso"] = _iso(ev["ts"])
    stats = {
        "events": len(events),
        "sources": {
            "metrics": art.metrics_path.exists(),
            "quarantine": art.quarantine_path.exists(),
            "membership": art.membership_dir.is_dir(),
            "flightrec_dumps": len(dumps),
            "heartbeat_dirs": len(art.heartbeat_dirs()),
            "fleet": art.fleet_path.exists(),
        },
        "steps": {
            "distinct": len(best),
            "first": min(best) if best else None,
            "last": max(best) if best else None,
            "replayed_beats_deduped": replay_dropped,
        },
    }
    return {"events": events, "stats": stats}


# --------------------------------------------------------------------------
# efficiency extraction + diff
# --------------------------------------------------------------------------

def _quant_counters(metrics: list[dict]) -> dict:
    """The run's int8-codec health as PER-STEP rates, from its records'
    counter snapshots (``quant.overflow`` / ``quant.clip_blocks``,
    published by the trainer's per-window fetch).

    The registry counters are run-cumulative, so comparing them raw
    against a BENCH baseline (counts over its few latency steps) would
    make every longer-than-bench run a spurious regression — both sides
    normalize to blocks per optimizer step instead (`load_baseline`
    divides the BENCH totals by its ``stats_steps``). The divisor is the
    last counter-carrying record's global step — approximate when
    publishing started mid-run, exact for the zero-overflow gate either
    way (0/N == 0). None when the run never published them — a
    non-quantized run must diff exactly as before, never "0"."""
    overflow = clip = None
    steps = 0
    for r in metrics:
        counters = r.get("counters")
        if not isinstance(counters, dict):
            continue
        if "quant.overflow" in counters:
            overflow = counters["quant.overflow"]
            steps = max(steps, int(r.get("step", 0)))
        if "quant.clip_blocks" in counters:
            clip = counters["quant.clip_blocks"]
            steps = max(steps, int(r.get("step", 0)))
    steps = max(steps, 1)
    return {
        "quant_overflow_per_step": (
            None if overflow is None else round(overflow / steps, 4)),
        "quant_clip_blocks_per_step": (
            None if clip is None else round(clip / steps, 4)),
    }


def _comm_signals(metrics: list[dict], art: RunArtifacts) -> dict:
    """The run's comm-attribution gauges, from the newest ``comm_profile``
    metrics event (the stream is the history) or, failing that, the
    archived comm_report.json. Runs that never profiled a comm window
    contribute no keys — `diff` then skips the comm signals, never
    fabricating a 0 ms communication time."""
    last = None
    for r in metrics:
        if r.get("event") == "comm_profile":
            last = r
    if last is None:
        last = art.comm_report()
    if last is None:
        return {}
    out = {}
    for key in ("comm_ms", "exposed_comm_ms", "overlap_frac"):
        if last.get(key) is not None:
            out[key] = float(last[key])
    return out


def serve_signals(report: dict) -> dict:
    """Gateable serve signals out of an audited serve report.

    ``serve_attainment`` (overall) and per-class ``serve_attainment_c<k>``
    are lower-is-worse; ``serve_p95_ms`` is higher-is-worse — the serving
    twins of mfu/goodput/p95, so a shed-storm or latency regression in
    the replica tier fails CI exactly like an MFU drop. Missing blocks
    produce no key: absence is surfaced as ``skipped``, never a fake 0.
    """
    out: dict[str, float] = {}
    slo = report.get("slo") or {}
    if slo.get("attainment") is not None:
        out["serve_attainment"] = float(slo["attainment"])
    lat = report.get("latency_ms") or {}
    if lat.get("p95_ms") is not None:
        out["serve_p95_ms"] = float(lat["p95_ms"])
    for cls, blk in sorted((report.get("classes") or {}).items()):
        if isinstance(blk, dict) and blk.get("attainment") is not None:
            out[f"serve_attainment_c{cls}"] = float(blk["attainment"])
    return out


def _is_serve_report(rec: dict) -> bool:
    """A raw serve report (vs a BENCH record / obsctl baseline)."""
    return "ground_truth" in rec or (
        isinstance(rec.get("slo"), dict) and "counters" in rec
    )


def run_efficiency(art: RunArtifacts) -> dict:
    """The run's {mfu, goodput, p95_ms, quant_*, serve_*} from its metrics
    stream and (when archived) its serve report.

    Prefers the epoch records' ``efficiency`` rollups (schema 3, written
    by the live accounting); falls back to recomputing from per-step
    span records (obs=full runs predating the rollup, or partial runs).
    Missing signals are None — `diff` compares only what both sides have.
    The int8 codec's overflow/clip counts (when the run published them)
    ride along so a quantization-quality regression is CI-gateable like
    mfu/goodput.
    """
    metrics = sweep_rollback_generations(art.metrics())
    quant = _quant_counters(metrics)
    serve = serve_signals(art.serve_report() or {})
    comm = _comm_signals(metrics, art)
    eff_recs = [r["efficiency"] for r in metrics
                if "epoch" in r and isinstance(r.get("efficiency"), dict)]
    if eff_recs:
        last = eff_recs[-1]
        return {
            "mfu": last.get("mfu"),
            "goodput": last.get("goodput"),
            "p95_ms": (last.get("step_time_ms") or {}).get("p95"),
            "source": "epoch_efficiency_rollup",
            **quant,
            **serve,
            **comm,
        }
    per_step = [r for r in metrics
                if "spans" in r and "event" not in r and "epoch" not in r]
    if not per_step:
        return {"mfu": None, "goodput": None, "p95_ms": None,
                "source": "serve_report" if serve else "none",
                **quant, **serve, **comm}
    totals, waits, mfus, goodputs = [], [], [], []
    for r in per_step:
        spans = r["spans"]
        totals.append(sum(spans.values()))
        waits.append(spans.get("data_wait", 0.0))
        if r.get("mfu") is not None:
            mfus.append(float(r["mfu"]))
        if r.get("goodput") is not None:
            goodputs.append(float(r["goodput"]))
    wall = sum(totals)
    return {
        "mfu": round(sum(mfus) / len(mfus), 4) if mfus else None,
        "goodput": (
            round(sum(goodputs) / len(goodputs), 4) if goodputs
            else (round(1.0 - sum(waits) / wall, 4) if wall > 0 else None)
        ),
        "p95_ms": round(percentile(sorted(totals), 95), 3),
        "source": "per_step_spans",
        **quant,
        **serve,
        **comm,
    }


def load_baseline(path: Path) -> dict:
    """{mfu, goodput, p95_ms, quant_*_per_step, serve_*} out of a
    BENCH_*.json, an obsctl baseline, or a raw serve report. Quant rates
    come from the baseline's own per-step keys, or from a BENCH record's
    ``quant`` block — whose overflow / clip_blocks totals cover
    ``stats_steps`` fenced steps and are normalized here so run and
    baseline always compare in the same unit (blocks per optimizer
    step). Serve signals come from direct ``serve_*`` keys (obsctl
    baseline), a BENCH record's ``serve`` block, or — when the baseline
    file *is* an archived serve report — its slo/latency/classes blocks,
    so `serve_elastic_report.json` of a known-good run gates the next
    one directly."""
    rec = json.loads(path.read_text())
    if str(rec.get("schema", "")).startswith("tpu_dp.tune/profile/"):
        # A tuned.json of the tune harness: its `claims` block IS the
        # baseline (read by its schema; nothing is imported) —
        # the fenced numbers the winning config earned when it was
        # crowned, in these exact signal units. `obsctl diff
        # --baseline tuned.json` therefore re-validates a tuned run
        # against what the profile claims it should deliver.
        rec = dict(rec.get("claims") or {})
    latency = rec.get("latency") or {}
    quant = rec.get("quant") or {}
    q_steps = max(int(quant.get("stats_steps", 0) or 0), 1)

    def rate(total):
        return None if total is None else round(total / q_steps, 4)

    if _is_serve_report(rec):
        serve = serve_signals(rec)
    else:
        serve = serve_signals(rec.get("serve") or {})
        serve.update({k: v for k, v in rec.items()
                      if k.startswith("serve_") and v is not None})
    # Comm-attribution signals: direct keys (an obsctl baseline) or a
    # BENCH record's `comm` block (`bench.py --comm-profile`).
    comm_blk = rec.get("comm") or {}
    return {
        "mfu": rec.get("mfu"),
        "goodput": rec.get("goodput"),
        # The BENCH throughput headline (archived rows carry it as
        # `value`; tune claims under its signal name) — the signal
        # `tune validate` certifies a profile against.
        "img_per_sec_per_chip": rec.get(
            "img_per_sec_per_chip", rec.get("value")),
        "p95_ms": rec.get("p95_ms", latency.get("p95_ms")),
        "quant_overflow_per_step": rec.get(
            "quant_overflow_per_step", rate(quant.get("overflow"))),
        "quant_clip_blocks_per_step": rec.get(
            "quant_clip_blocks_per_step", rate(quant.get("clip_blocks"))),
        "comm_ms": rec.get("comm_ms", comm_blk.get("comm_ms")),
        "exposed_comm_ms": rec.get(
            "exposed_comm_ms", comm_blk.get("exposed_comm_ms")),
        "overlap_frac": rec.get(
            "overlap_frac", comm_blk.get("overlap_frac")),
        **serve,
    }


def diff_verdict(run: dict, base: dict, tolerance: float) -> dict:
    """Per-signal verdicts + the overall regression flag.

    Lower-is-worse signals (mfu, goodput, and the serving tier's overall
    + per-class ``serve_attainment*``) regress below
    ``base x (1 - tolerance)``; higher-is-worse (p95_ms, the serving
    ``serve_p95_ms``, and the int8 codec's per-step quant_overflow /
    quant_clip_blocks rates) above ``base x (1 + tolerance)`` — with a
    zero-rate baseline that bound is zero, so ANY overflow where the
    baseline had none is a regression (exactly right: overflow means
    non-finite blocks entered the codec). Signals missing on either side
    are reported ``skipped`` — absence of evidence is surfaced, never
    silently passed.
    """
    signals = [("mfu", True), ("goodput", True),
               ("img_per_sec_per_chip", True),
               ("p95_ms", False),
               ("quant_overflow_per_step", False),
               ("quant_clip_blocks_per_step", False),
               # Comm attribution (docs/OBSERVABILITY.md): more exposed
               # communication or more comm time regresses like a p95;
               # a lower overlap fraction regresses like MFU.
               ("comm_ms", False),
               ("exposed_comm_ms", False),
               ("overlap_frac", True)]
    # Serving signals are open-ended (one attainment per SLO class), so
    # the comparison set is whatever either side carries — per-class
    # attainment gates like MFU, serve p95 like step-time p95.
    for key in sorted(set(run) | set(base)):
        if key.startswith("serve_attainment"):
            signals.append((key, True))
        elif key.startswith("serve_p95_ms"):
            signals.append((key, False))
    checks = []
    for key, worse_is_lower in signals:
        r, b = run.get(key), base.get(key)
        if r is None or b is None:
            checks.append({"signal": key, "verdict": "skipped",
                           "run": r, "baseline": b})
            continue
        if worse_is_lower:
            bound = b * (1.0 - tolerance)
            regressed = r < bound
        else:
            bound = b * (1.0 + tolerance)
            regressed = r > bound
        checks.append({
            "signal": key, "run": r, "baseline": b,
            "bound": round(bound, 6),
            "verdict": "regressed" if regressed else "ok",
        })
    compared = [c for c in checks if c["verdict"] != "skipped"]
    return {
        "checks": checks,
        "compared": len(compared),
        "regressed": any(c["verdict"] == "regressed" for c in compared),
        "tolerance": tolerance,
    }


# --------------------------------------------------------------------------
# watch — live alert rules over a running (or replayed) run
# --------------------------------------------------------------------------

#: rule text: SIGNAL OP BOUND, BOUND = float | F*baseline | baseline*F |
#: baseline (docs/OBSERVABILITY.md "Watch rules").
_RULE_RE = re.compile(
    r"^\s*([A-Za-z_][\w.]*)\s*(<=|>=|<|>)\s*(.+?)\s*$"
)
#: self-baselining rule text: ``anomaly:SIGNAL K`` — trips when the
#: signal lands K robust deviations (rolling median/MAD) outside its own
#: trailing history; no --baseline file needed.
_ANOMALY_RE = re.compile(
    r"^\s*anomaly:([A-Za-z_][\w.]*)\s+([0-9]*\.?[0-9]+)\s*$"
)
_OPS = {
    "<": lambda v, b: v < b,
    ">": lambda v, b: v > b,
    "<=": lambda v, b: v <= b,
    ">=": lambda v, b: v >= b,
}

#: stream signals a watch rule can reference, and where they come from
#: (per-record values; end-state signals are computed over the artifacts).
WATCH_SIGNALS = (
    "mfu", "goodput", "step_time_ms",
    "comm_ms", "exposed_comm_ms", "overlap_frac",
    "quant_overflow_per_step", "quant_clip_blocks_per_step",
    "straggler_ratio", "heartbeat_age_s",
    # fleet signals (`obs.fleet`): first-class rule targets —
    # `--rule 'fleet.skew_ratio>1.5'` exit-codes like any stream signal.
    # They arrive via fleet records (`obsctl fleet --rule`, or watch over
    # a published fleet.jsonl).
    *FLEET_SIGNALS,
)


class WatchRule:
    """One parsed ``--rule``: a signal, a comparison, and a bound that is
    either a constant or a factor of the baseline's value of the same
    signal (``mfu<0.9*baseline``) — or, with ``kind == "anomaly"``, a
    self-baselining rule (``anomaly:step_time_ms 4``) that trips when
    the signal lands that many robust deviations (rolling median/MAD)
    outside its own trailing history."""

    def __init__(self, text: str):
        self.kind = "threshold"
        self.const: float | None = None
        self.factor: float | None = None
        self.op: str | None = None
        self.deviations: float = 0.0
        am = _ANOMALY_RE.match(text)
        if am is not None:
            self.kind = "anomaly"
            self.text = text.strip()
            self.signal = am.group(1)
            if self.signal not in WATCH_SIGNALS:
                raise ValueError(
                    f"rule {text!r} references unknown signal "
                    f"{self.signal!r} (known: {', '.join(WATCH_SIGNALS)})"
                )
            self.deviations = float(am.group(2))
            if self.deviations <= 0:
                raise ValueError(
                    f"rule {text!r}: the deviation count must be > 0"
                )
            return
        if text.strip().startswith("anomaly:"):
            raise ValueError(
                f"rule {text!r} is not 'anomaly:SIGNAL K' "
                f"(e.g. 'anomaly:step_time_ms 4')"
            )
        m = _RULE_RE.match(text)
        if m is None:
            raise ValueError(
                f"rule {text!r} is not SIGNAL OP BOUND "
                f"(e.g. 'mfu<0.9*baseline', 'exposed_comm_ms>5')"
            )
        self.text = text.strip()
        self.signal, self.op, bound = m.groups()
        if self.signal not in WATCH_SIGNALS:
            # A typo'd signal would otherwise just never evaluate — and a
            # second, healthy rule seeing data would mask it under exit 0.
            raise ValueError(
                f"rule {text!r} references unknown signal "
                f"{self.signal!r} (known: {', '.join(WATCH_SIGNALS)})"
            )
        b = bound.replace(" ", "")
        if b == "baseline":
            self.factor = 1.0
        elif b.endswith("*baseline"):
            self.factor = float(b[: -len("*baseline")])
        elif b.startswith("baseline*"):
            self.factor = float(b[len("baseline*"):])
        else:
            self.const = float(b)

    @property
    def needs_baseline(self) -> bool:
        return self.factor is not None

    def bound(self, baseline: dict | None) -> float | None:
        """The resolved threshold, or None (baseline lacks the signal)."""
        if self.const is not None:
            return self.const
        b = (baseline or {}).get(self.signal)
        return None if b is None else self.factor * float(b)


def stream_signals(rec: dict) -> dict:
    """The watch signals one metrics record carries.

    Absence over fabrication throughout: a record without an MFU gauge
    contributes no ``mfu`` sample, a run that never profiled a comm
    window never produces ``exposed_comm_ms`` — a rule on a signal the
    run does not publish simply never evaluates (and `watch` exits 2
    when NO rule ever saw data, the diff gate's refuse-to-certify).

    Fleet records (`tpu_dp_torch.obs.fleet`) map through `fleet_signals`:
    ``fleet.*`` targets plus the fleet step clock as ``step_time_ms``,
    so anomaly rules on step time work over the fleet stream too."""
    if rec.get("kind") in FLEET_KINDS:
        return fleet_signals(rec)
    sig: dict[str, float] = {}
    for key in ("mfu", "goodput"):
        if isinstance(rec.get(key), (int, float)):
            sig[key] = float(rec[key])
    counters = rec.get("counters")
    if isinstance(counters, dict):
        if "obs.step_time_ms" in counters:
            sig["step_time_ms"] = float(counters["obs.step_time_ms"])
        step = max(1, int(rec.get("step", 1) or 1))
        if "quant.overflow" in counters:
            sig["quant_overflow_per_step"] = (
                float(counters["quant.overflow"]) / step
            )
        if "quant.clip_blocks" in counters:
            sig["quant_clip_blocks_per_step"] = (
                float(counters["quant.clip_blocks"]) / step
            )
    if rec.get("event") == "comm_profile":
        for key in ("comm_ms", "exposed_comm_ms", "overlap_frac"):
            if isinstance(rec.get(key), (int, float)):
                sig[key] = float(rec[key])
    return sig


def end_signals(art: RunArtifacts, now: float | None = None) -> dict:
    """State-of-the-run signals computed over the artifacts, not the
    stream: the worst leave-one-out straggler ratio and the oldest
    rank's heartbeat age (vs ``now``; in replay, vs the newest beat
    anywhere — a finished clean run replays with age ~0, a run whose
    rank wedged mid-way replays with the victim's real gap).

    Only the NEWEST membership epoch's heartbeat dir is read: these are
    state-of-the-run signals, and an elastic shrink's legitimately
    departed rank must not read as a permanently stale heartbeat (its
    old stream stops forever while the survivors re-home to the next
    ``me<E>/`` dir — the departure itself is the timeline's story)."""
    sig: dict[str, float] = {}
    ratios: list[float] = []
    last_beats: list[float] = []
    newest = 0.0
    hb_dirs = art.heartbeat_dirs()
    if hb_dirs:
        hb_dirs = [max(hb_dirs, key=lambda pair: pair[0])]
    for _, hb_dir in hb_dirs:
        world = len(list(hb_dir.glob("heartbeat_r*.jsonl")))
        mon = HealthMonitor(hb_dir, world=world)
        by_rank = mon.read_beats()  # ONE pass shared with the scan
        for issue in mon.scan(beats=by_rank):
            if issue.ratio:
                ratios.append(float(issue.ratio))
        for rank, beats in by_rank.items():
            if beats:
                last_beats.append(float(beats[-1]["ts"]))
                newest = max(newest, float(beats[-1]["ts"]))
    if last_beats:
        sig["straggler_ratio"] = max(ratios) if ratios else 1.0
        ref = float(now) if now is not None else newest
        sig["heartbeat_age_s"] = max(0.0, ref - min(last_beats))
    return sig


#: the byte-offset incremental reader now lives in `tpu_dp_torch.obs.tail`
#: (shared with the fleet aggregator); the old private name stays an
#: alias so downstream imports keep resolving.
_MetricsTail = JsonlTail


def _alert_event(rule: WatchRule, value: float, bound: float,
                 step, ts: float | None,
                 extra: dict | None = None) -> dict:
    ts = float(ts) if ts is not None else datetime.now(
        timezone.utc).timestamp()
    ev = {"ts": ts, "iso": _iso(ts), "kind": "alert", "source": "watch",
          "rule": rule.text, "signal": rule.signal,
          "value": round(float(value), 6), "bound": round(float(bound), 6)}
    if step is not None:
        ev["step"] = step
    if extra:
        ev.update(extra)
    return ev


class WatchEngine:
    """Rule evaluation over a metrics stream + artifact end-state.

    One instance per `cmd_watch` run; `observe_record` feeds stream
    records in order, `observe_state` the end-state signals (repeatable
    — an end-state rule trips at most once). ``evaluated`` tracks which
    rules ever saw data, for the exit-2 refuse-to-certify verdict.

    Anomaly rules keep a rolling window per rule: the incoming value is
    scored against the window's median/MAD BEFORE joining it (a spike
    must not baseline itself), and only counts as evaluated once the
    window holds ``ANOMALY_MIN_POINTS`` — an anomaly rule that never
    accumulated history exit-2s like any rule that never saw data."""

    #: trailing history per anomaly rule; long enough to smooth one-off
    #: jitter, short enough to track a drifting run.
    ANOMALY_WINDOW = 32
    #: minimum history before an anomaly rule scores anything — a median
    #: of two points is not a baseline.
    ANOMALY_MIN_POINTS = 8
    #: sigma floor as a fraction of |median|: near-constant signals have
    #: MAD ~ 0, and without the floor any scheduler-jitter wiggle would
    #: score as infinitely anomalous.
    ANOMALY_REL_FLOOR = 0.05

    def __init__(self, rules: list[WatchRule], baseline: dict | None):
        self.rules = rules
        self.baseline = baseline
        self.alerts: list[dict] = []
        self.evaluated: set[str] = set()
        self._state_tripped: set[str] = set()
        from collections import deque as _deque

        self._windows: dict[str, object] = {}
        self._deque = _deque

    def _check_anomaly(self, rule: WatchRule, value: float,
                       step, ts) -> None:
        win = self._windows.get(rule.text)
        if win is None:
            win = self._windows[rule.text] = self._deque(
                maxlen=self.ANOMALY_WINDOW)
        try:
            if len(win) < self.ANOMALY_MIN_POINTS:
                return
            ordered = sorted(win)
            med = percentile(ordered, 50)
            mad = percentile(sorted(abs(v - med) for v in win), 50)
            # 1.4826 x MAD estimates the std dev of normal data — K
            # "robust deviations" then reads like K sigmas.
            sigma = max(1.4826 * mad,
                        self.ANOMALY_REL_FLOOR * abs(med), 1e-9)
            score = abs(value - med) / sigma
            self.evaluated.add(rule.text)
            if score > rule.deviations:
                bound = med + (sigma * rule.deviations
                               if value >= med else
                               -sigma * rule.deviations)
                self.alerts.append(_alert_event(
                    rule, value, bound, step, ts,
                    extra={"score": round(score, 3),
                           "median": round(med, 6),
                           "window": len(win)}))
        finally:
            # the value always joins the history — an adapting baseline
            # is the point; persistent regressions are threshold rules'
            # and streak counters' business
            win.append(float(value))

    def _check(self, rule: WatchRule, sig: dict, step, ts,
               once: bool = False) -> None:
        value = sig.get(rule.signal)
        if value is None:
            return
        if rule.kind == "anomaly":
            self._check_anomaly(rule, float(value), step, ts)
            return
        bound = rule.bound(self.baseline)
        if bound is None:
            return  # baseline lacks the signal: no-data, never a trip
        self.evaluated.add(rule.text)
        if _OPS[rule.op](value, bound):
            if once:
                if rule.text in self._state_tripped:
                    return
                self._state_tripped.add(rule.text)
            self.alerts.append(_alert_event(rule, value, bound, step, ts))

    def observe_record(self, rec: dict) -> None:
        sig = stream_signals(rec)
        if not sig:
            return
        ts = _parse_ts(rec.get("ts"))
        for rule in self.rules:
            self._check(rule, sig, rec.get("step"), ts)

    def observe_state(self, sig: dict, ts: float | None = None) -> None:
        for rule in self.rules:
            self._check(rule, sig, None, ts, once=True)


# --------------------------------------------------------------------------
# merge-trace
# --------------------------------------------------------------------------

def build_merged_trace(art: RunArtifacts) -> dict:
    """One Perfetto trace across ranks AND regroup generations.

    Every (membership epoch, rank) heartbeat stream becomes its own trace
    process (``pid = me*1000 + rank`` — a reassigned dense rank after a
    regroup is a different logical seat and must not splice into its
    predecessor's track); rollback generations within a stream render as
    separate track groups (`to_trace_events`' gen handling); evictions,
    rollbacks and regroups land as global instant-event markers.
    """
    from tpu_dp_torch.obs.export import instant_event, merge_traces, to_trace_events

    traces = []
    for me_epoch, hb_dir in art.heartbeat_dirs():
        mon = HealthMonitor(hb_dir, world=1)
        for rank, beats in sorted(mon.read_beats().items()):
            recs = []
            for b in beats:
                rec = {
                    "step": b["step"],
                    "ts": b["ts"] - b["step_ms"] / 1e3,
                    "spans": {"step": b["step_ms"]},
                }
                if b.get("gen"):
                    rec["gen"] = int(b["gen"])
                recs.append(rec)
            pid = me_epoch * 1000 + rank
            name = f"rank {rank}" + (f" (me{me_epoch})" if me_epoch else "")
            traces.append(to_trace_events(recs, rank=pid,
                                          process_name=name))
    # the fleet stream's skew renders as counter tracks — the cross-rank
    # signal lines up under the per-rank step tracks it was derived from
    points = [
        {"ts": rec["ts"],
         "counters": {"fleet.step_skew_ms": rec.get("step_skew_ms"),
                      "fleet.skew_ratio": rec.get("skew_ratio")}}
        for rec in art.fleet_records() if rec.get("kind") == "fleet_step"
    ]
    if points:
        traces.append(to_trace_events(
            [], rank=999_000, counter_points=points, process_name="fleet"))
    markers = []
    for ev in build_timeline(art)["events"]:
        if ev["kind"] in MARKER_KINDS:
            args = {"source": ev["source"]}
            if ev.get("rank") is not None:
                args["rank"] = ev["rank"]
            if ev.get("step") is not None:
                args["step"] = ev["step"]
            # Scalar detail fields ride into the marker args — this is
            # how a profile_start/profile_stop marker links the captured
            # trace (its trace_dir + step range) and an alert marker
            # names its rule, directly in the Perfetto UI.
            for k, v in (ev.get("detail") or {}).items():
                if isinstance(v, (str, int, float, bool)) and k not in args:
                    args[k] = v
            markers.append(instant_event(ev["kind"], ev["ts"], args=args))
    return merge_traces(traces + [{"traceEvents": markers}])


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _fmt_event(ev: dict) -> str:
    parts = [ev["iso"], f"{ev['kind']:<20}", f"[{ev['source']}]"]
    if ev.get("rank") is not None:
        parts.append(f"rank={ev['rank']}")
    if ev.get("step") is not None:
        parts.append(f"step={ev['step']}")
    if ev.get("gen"):
        parts.append(f"gen={ev['gen']}")
    detail = ev.get("detail")
    if detail:
        blob = json.dumps(detail, default=str)
        parts.append(blob if len(blob) <= 160 else blob[:157] + "...")
    return "  ".join(parts)


def cmd_timeline(args) -> int:
    art = RunArtifacts(args.run_dir, metrics_path=args.metrics)
    out = build_timeline(art, include_steps=args.steps)
    if args.json:
        print(json.dumps(out))
    else:
        for ev in out["events"]:
            print(_fmt_event(ev))
        print(f"-- {out['stats']['events']} events; steps "
              f"{out['stats']['steps']['first']}.."
              f"{out['stats']['steps']['last']} "
              f"({out['stats']['steps']['distinct']} distinct, "
              f"{out['stats']['steps']['replayed_beats_deduped']} replayed "
              f"beats deduped)")
    return 0


def cmd_stragglers(args) -> int:
    art = RunArtifacts(args.run_dir, metrics_path=args.metrics)
    report = []
    for me_epoch, hb_dir in art.heartbeat_dirs():
        world = len(list(hb_dir.glob("heartbeat_r*.jsonl")))
        mon = HealthMonitor(hb_dir, world=world,
                            straggler_factor=args.factor,
                            min_step_ms=args.min_step_ms)
        issues = mon.scan()
        report.append({
            "membership_epoch": me_epoch,
            "dir": str(hb_dir),
            "world": world,
            "issues": [
                {"kind": i.kind, "rank": i.rank, "step": i.step,
                 "step_ms": i.step_ms, "median_ms": i.median_ms,
                 "ratio": i.ratio}
                for i in issues
            ],
        })
    if args.json:
        print(json.dumps({"stragglers": report}))
    else:
        if not report:
            print("no heartbeat files found")
        for block in report:
            print(f"me{block['membership_epoch']} "
                  f"(world {block['world']}, {block['dir']}):")
            if not block["issues"]:
                print("  no stragglers")
            for i in block["issues"]:
                print(f"  rank {i['rank']} at step {i['step']}: "
                      f"{i['step_ms']:.1f} ms vs median "
                      f"{i['median_ms']:.1f} ({i['ratio']:.1f}x)")
    return 0


def cmd_merge_trace(args) -> int:
    from tpu_dp_torch.obs.export import write_trace

    art = RunArtifacts(args.run_dir, metrics_path=args.metrics)
    trace = build_merged_trace(art)
    if not trace["traceEvents"]:
        print("obsctl: no heartbeat/timeline data to trace",
              file=sys.stderr)
        return 2
    out = write_trace(args.out, trace)
    print(f"merged trace: {out} ({len(trace['traceEvents'])} events) — "
          f"open in chrome://tracing or ui.perfetto.dev")
    return 0


def cmd_diff(args) -> int:
    art = RunArtifacts(args.run_dir, metrics_path=args.metrics,
                       serve_report_path=getattr(args, "serve_report", None))
    run = run_efficiency(art)
    if args.write_baseline:
        payload = {
            "metric": "obsctl_baseline",
            "mfu": run["mfu"],
            "goodput": run["goodput"],
            "p95_ms": run["p95_ms"],
            "quant_overflow_per_step": run.get("quant_overflow_per_step"),
            "quant_clip_blocks_per_step": run.get(
                "quant_clip_blocks_per_step"),
            "comm_ms": run.get("comm_ms"),
            "exposed_comm_ms": run.get("exposed_comm_ms"),
            "overlap_frac": run.get("overlap_frac"),
            **{k: v for k, v in sorted(run.items())
               if k.startswith("serve_")},
            "source_run": str(art.run_dir),
            "source": run["source"],
        }
        out = Path(args.write_baseline)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(payload, indent=2) + "\n")
        print(f"baseline written: {out}")
        return 0
    if not args.baseline:
        print("obsctl diff: --baseline (or --write-baseline) required",
              file=sys.stderr)
        return 2
    base = load_baseline(Path(args.baseline))
    verdict = diff_verdict(run, base, args.tolerance)
    verdict["run_source"] = run["source"]
    if args.json:
        print(json.dumps(verdict))
    else:
        for c in verdict["checks"]:
            print(f"{c['signal']:<26} run={c['run']} "
                  f"baseline={c['baseline']} -> {c['verdict']}")
    if verdict["compared"] == 0:
        print("obsctl diff: no signal present on both sides — cannot "
              "certify; run with train.obs=basic|full (or archive a serve "
              "report) and a baseline carrying mfu/goodput/latency.p95_ms "
              "or serve_attainment/serve_p95_ms", file=sys.stderr)
        return 2
    if verdict["regressed"]:
        print("obsctl diff: REGRESSION", file=sys.stderr)
        return 1
    return 0


def cmd_watch(args) -> int:
    """Evaluate alert rules over a run's telemetry; the live ops surface.

    ``--replay`` processes the finished artifacts as a stream (CI: a
    tampered run must trip, a clean run must not). Without it, the run
    dir is polled live every ``--interval`` seconds for ``--for-s``
    seconds (0 = one evaluation of the current state). Exit 0 clean,
    1 on any tripped rule, 2 when no rule ever saw data (or on usage
    errors) — the diff gate's refuse-to-certify semantics.
    """
    import time as _time

    try:
        rules = [WatchRule(r) for r in (args.rule or [])]
    except ValueError as e:
        print(f"obsctl watch: {e}", file=sys.stderr)
        return 2
    if getattr(args, "profile", None):
        print("obsctl watch: --profile derives rules from a tuned profile "
              "of the tune harness, not ported to tpu_dp_torch yet "
              "(ROADMAP Queue 1 item 12)", file=sys.stderr)
        return 2
    if not rules:
        print("obsctl watch: at least one --rule (or --profile) required "
              "(e.g. --rule 'mfu<0.9*baseline')", file=sys.stderr)
        return 2
    baseline = None
    if args.baseline:
        baseline = load_baseline(Path(args.baseline))
    missing = [r.text for r in rules if r.needs_baseline and baseline is None]
    if missing:
        print(f"obsctl watch: rules {missing} reference 'baseline' but no "
              f"--baseline was given", file=sys.stderr)
        return 2
    art = RunArtifacts(args.run_dir, metrics_path=args.metrics)
    eng = WatchEngine(rules, baseline)
    # fleet.* rules need fleet records: the published stream when one
    # exists, else (replay only) a fresh aggregation over the raw
    # artifacts — a fleet rule must be evaluable from artifacts alone.
    needs_fleet = any(r.signal.startswith("fleet.") for r in rules)

    if args.replay:
        for rec in sweep_rollback_generations(art.metrics()):
            eng.observe_record(rec)
        fleet_recs = art.fleet_records()
        if not fleet_recs and needs_fleet:
            fleet_recs = FleetAggregator(art.run_dir).replay()
        for rec in fleet_recs:
            eng.observe_record(rec)
        eng.observe_state(end_signals(art))
    else:
        # The poll budget is monotonic (DP403/DP402): an NTP step on the
        # pager host must not stretch or cut `--for-s`. Wall-clock stays
        # only where it is DATA — the `now`/`ts` stamps compared against
        # artifact mtimes and recorded in alerts.
        deadline = _time.monotonic() + max(0.0, args.for_s)
        tail = JsonlTail(art.metrics_path)
        fleet_tail = JsonlTail(art.fleet_path)
        while True:
            # Raw append-order tail (no generation sweep): live watching
            # reads the stream as it grows; a rollback's replayed records
            # are new observations, exactly what a pager should see.
            for rec in tail.poll():
                eng.observe_record(rec)
            for rec in fleet_tail.poll():
                # live fleet records feed rules only on a known schema —
                # a future layout must not be half-interpreted
                if rec.get("schema") == FLEET_SCHEMA:
                    eng.observe_record(rec)
            eng.observe_state(end_signals(art, now=_time.time()),
                              ts=_time.time())
            if _time.monotonic() >= deadline:
                break
            _time.sleep(max(0.1, args.interval))

    if args.alerts_out and eng.alerts:
        out = Path(args.alerts_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a", encoding="utf-8") as f:
            for ev in eng.alerts:
                f.write(json.dumps(ev) + "\n")
    if args.json:
        print(json.dumps({
            "alerts": eng.alerts,
            "rules": [r.text for r in rules],
            "evaluated": sorted(eng.evaluated),
        }))
    else:
        for ev in eng.alerts:
            print(f"{ev['iso']}  ALERT {ev['rule']}  value={ev['value']} "
                  f"bound={ev['bound']}"
                  + (f" step={ev['step']}" if "step" in ev else ""))
        print(f"-- {len(eng.alerts)} alert(s); "
              f"{len(eng.evaluated)}/{len(rules)} rule(s) saw data")
    if not eng.evaluated:
        print("obsctl watch: no rule ever saw data — cannot certify; "
              "check the signal names (known: "
              + ", ".join(WATCH_SIGNALS) + ")", file=sys.stderr)
        return 2
    return 1 if eng.alerts else 0


def cmd_fleet(args) -> int:
    """Aggregate per-rank streams into the fleet stream; the live
    cross-rank surface.

    Tails every rank's heartbeat stream, the metrics sink, and the
    serve router/replica streams concurrently (`StreamTailer`), aligns
    per (membership epoch, generation, step), and publishes derived
    fleet records to ``<obs>/fleet.jsonl`` (+ promfile gauges with
    ``--prom``). ``--replay`` aggregates the finished artifacts in one
    pass — the CI mode: a straggler-injected run must exit 1 naming the
    injected rank under a ``--rule``, the clean twin 0. Rules use the
    full watch grammar (fleet signals, anomaly rules) and exit-code
    identically: 0 clean, 1 any trip, 2 no data / no rule saw data.
    """
    import time as _time

    try:
        rules = [WatchRule(r) for r in (args.rule or [])]
    except ValueError as e:
        print(f"obsctl fleet: {e}", file=sys.stderr)
        return 2
    baseline = None
    if args.baseline:
        baseline = load_baseline(Path(args.baseline))
    missing = [r.text for r in rules if r.needs_baseline and baseline is None]
    if missing:
        print(f"obsctl fleet: rules {missing} reference 'baseline' but no "
              f"--baseline was given", file=sys.stderr)
        return 2
    art = RunArtifacts(args.run_dir, metrics_path=args.metrics)
    out_path = Path(args.out) if args.out else art.fleet_path
    agg = FleetAggregator(
        art.run_dir, min_step_ms=args.min_step_ms,
        spike_ratio=args.spike_ratio, window=args.window,
        expected_world=args.world or None,
    )
    pub = FleetPublisher(out_path, prom_path=args.prom)
    eng = WatchEngine(rules, baseline)
    records: list[dict] = []

    def handle(recs: list[dict]) -> None:
        pub.publish(recs)
        records.extend(recs)
        for rec in recs:
            eng.observe_record(rec)

    if args.replay:
        handle(agg.replay())
    else:
        # Live: a background tailer polls every discovered stream while
        # this loop drains, aggregates, and publishes. The duration
        # budget is monotonic (DP403/DP402) — wall-clock stays only
        # where it is data (record ts stamps).
        deadline = _time.monotonic() + max(0.0, args.for_s)
        tailer = StreamTailer(
            interval_s=max(0.1, min(1.0, args.interval / 2)))
        with tailer:
            while True:
                for kind, meta, path in discover_streams(art.run_dir):
                    if tailer.add(path, (kind, meta)):
                        agg.note_stream(kind, meta)
                for (kind, meta), rec in tailer.drain():
                    handle(agg.ingest(kind, meta, rec))
                if _time.monotonic() >= deadline:
                    break
                _time.sleep(max(0.1, args.interval))
        # final synchronous sweep AFTER the thread stopped (no racing
        # tails), so --for-s 0 still aggregates the current state once
        for kind, meta, path in discover_streams(art.run_dir):
            if tailer.add(path, (kind, meta)):
                agg.note_stream(kind, meta)
        tailer.poll_once()
        for (kind, meta), rec in tailer.drain():
            handle(agg.ingest(kind, meta, rec))
        handle(agg.flush())

    report = fleet_summarize(records)
    if args.report:
        rp = Path(args.report)
        rp.parent.mkdir(parents=True, exist_ok=True)
        rp.write_text(json.dumps(report, indent=2) + "\n")
    if args.alerts_out and eng.alerts:
        ap = Path(args.alerts_out)
        ap.parent.mkdir(parents=True, exist_ok=True)
        with open(ap, "a", encoding="utf-8") as f:
            for ev in eng.alerts:
                f.write(json.dumps(ev) + "\n")
    if args.json:
        print(json.dumps({
            "report": report,
            "published": pub.published,
            "out": str(out_path),
            "alerts": eng.alerts,
            "rules": [r.text for r in rules],
            "evaluated": sorted(eng.evaluated),
        }))
    else:
        for ev in eng.alerts:
            print(f"{ev['iso']}  ALERT {ev['rule']}  value={ev['value']} "
                  f"bound={ev['bound']}"
                  + (f" step={ev['step']}" if "step" in ev else ""))
        if report.get("steps"):
            print(f"fleet: {report['steps']} step records "
                  f"(steps {report['first_step']}..{report['last_step']}), "
                  f"max skew_ratio {report['max_skew_ratio']} "
                  f"(rank {report['slowest_rank']} slowest most often, "
                  f"streak <= {report['max_slowest_streak']}), "
                  f"p95 {report['step_time_p95_ms']} ms, "
                  f"{report['spikes']} spike(s) -> {out_path}")
        else:
            print("fleet: no alignable step records "
                  "(need >= 2 ranks' heartbeats)")
    if not records:
        print("obsctl fleet: no fleet records derived — need >= 2 ranks' "
              "heartbeat streams (train.obs=basic|full) or serve streams",
              file=sys.stderr)
        return 2
    if rules:
        if not eng.evaluated:
            print("obsctl fleet: no rule ever saw data — cannot certify "
                  "(known signals: " + ", ".join(WATCH_SIGNALS) + ")",
                  file=sys.stderr)
            return 2
        return 1 if eng.alerts else 0
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dp_torch.obs",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("run_dir", help="training run root (ckpt dir)")
        p.add_argument("--metrics", default=None,
                       help="metrics.jsonl path (default <run>/metrics.jsonl)")
        p.add_argument("--json", action="store_true")

    p = sub.add_parser("timeline", help="merged, ordered event stream")
    common(p)
    p.add_argument("--steps", action="store_true",
                   help="include one event per (surviving) optimizer step")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("stragglers",
                       help="post-hoc leave-one-out straggler attribution")
    common(p)
    p.add_argument("--factor", type=float, default=3.0)
    p.add_argument("--min-step-ms", type=float, default=1.0)
    p.set_defaults(fn=cmd_stragglers)

    p = sub.add_parser("merge-trace",
                       help="one Perfetto file across ranks + generations")
    common(p)
    p.add_argument("-o", "--out", required=True)
    p.set_defaults(fn=cmd_merge_trace)

    p = sub.add_parser("diff",
                       help="regression verdict vs a BENCH_*.json baseline")
    common(p)
    p.add_argument("--serve-report", default=None,
                   help="audited serve report JSON (default: "
                        "<run>/serve_elastic_report.json or "
                        "<run>/serve_report.json) — gates per-class "
                        "attainment + p95 like mfu")
    p.add_argument("--baseline", default=None)
    p.add_argument("--tolerance", type=float, default=0.1,
                   help="relative slack before a delta is a regression")
    p.add_argument("--write-baseline", default=None,
                   help="mint a baseline json from this run and exit")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser(
        "watch",
        help="evaluate live alert rules over a running (or --replay'd) "
             "run; exit 1 on any trip",
    )
    common(p)
    p.add_argument("--rule", action="append", default=[],
                   help="SIGNAL OP BOUND, e.g. 'mfu<0.9*baseline', "
                        "'exposed_comm_ms>5', 'goodput<0.8', "
                        "'quant_overflow_per_step>0', "
                        "'straggler_ratio>3', 'heartbeat_age_s>60' "
                        "(repeatable)")
    p.add_argument("--baseline", default=None,
                   help="baseline json for '*baseline' bounds (BENCH "
                        "record or obsctl baseline)")
    p.add_argument("--replay", action="store_true",
                   help="process the finished artifacts as a stream "
                        "instead of tailing live")
    p.add_argument("--interval", type=float, default=2.0,
                   help="live poll cadence (seconds)")
    p.add_argument("--for-s", type=float, default=0.0, dest="for_s",
                   help="live watch duration; 0 = evaluate the current "
                        "state once")
    p.add_argument("--alerts-out", default=None,
                   help="append tripped alert events to this jsonl "
                        "(obsctl timeline merges <run>/alerts.jsonl)")
    p.add_argument("--profile", default=None,
                   help="tuned.json whose provenance claims derive watch "
                        "rules (not ported yet: ROADMAP Queue 1 item 12)")
    p.add_argument("--profile-tolerance", type=float, default=0.2,
                   dest="profile_tolerance",
                   help="relative slack on profile-derived bounds")
    p.set_defaults(fn=cmd_watch)

    p = sub.add_parser(
        "fleet",
        help="aggregate per-rank streams into live cross-rank fleet "
             "signals (skew attribution, fleet p50/p95, serve rollups)",
    )
    common(p)
    p.add_argument("--rule", action="append", default=[],
                   help="watch-grammar rule over fleet + stream signals, "
                        "e.g. 'fleet.skew_ratio>1.5', "
                        "'anomaly:step_time_ms 4' (repeatable)")
    p.add_argument("--baseline", default=None,
                   help="baseline json for '*baseline' bounds")
    p.add_argument("--replay", action="store_true",
                   help="aggregate the finished artifacts in one pass")
    p.add_argument("--interval", type=float, default=2.0,
                   help="live aggregation cadence (seconds)")
    p.add_argument("--for-s", type=float, default=0.0, dest="for_s",
                   help="live duration; 0 = aggregate the current state "
                        "once")
    p.add_argument("-o", "--out", default=None,
                   help="fleet stream path (default <run>/obs/fleet.jsonl)")
    p.add_argument("--prom", default=None,
                   help="also export fleet gauges to this promfile")
    p.add_argument("--report", default=None,
                   help="write the fleet summary report json here")
    p.add_argument("--alerts-out", default=None,
                   help="append tripped alert events to this jsonl")
    p.add_argument("--spike-ratio", type=float, default=3.0,
                   dest="spike_ratio",
                   help="skew_ratio at which a step records as a spike "
                        "(timeline marker)")
    p.add_argument("--min-step-ms", type=float, default=1.0,
                   dest="min_step_ms",
                   help="floor on the leave-one-out median denominator")
    p.add_argument("--window", type=int, default=64,
                   help="rolling window for fleet p50/p95")
    p.add_argument("--world", type=int, default=0,
                   help="expected ranks per step (default: ranks seen)")
    p.set_defaults(fn=cmd_fleet)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"obsctl: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
