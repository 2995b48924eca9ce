"""Flight recorder: a bounded ring of structured events that survives death.

Copy of `tpu_dp.obs.flightrec` for the PyTorch port (the port never
imports the JAX package): the same event kinds, dump layout and file
names, so a dump from either package reads in the other. In the port the
flight-recorder, snapshot, fault and boundary hooks, the preemption
handler, snapshots and checkpoint writes record into it; the kinds of the
subsystems not ported yet (guard, elastic, serving fleet) stay registered.

The telemetry built so far measures a *healthy* run; when a run dies, the
spans/counters that explain *why* die with the process (the Perfetto
export runs in `fit()`'s finally, but only rank 0 writes it and only the
span ring lands there). The flight recorder is the black box: every
subsystem appends cheap structured events — step ends, guard verdicts,
snapshot/rollback/regroup transitions, preemption signals, serve
dispatches — into a bounded ring, and the ring is dumped ATOMICALLY to
``flightrec_r<rank>.json`` on every exit path out of `Trainer.fit`
(clean, `PreemptedError`, `DivergedError`, `PeerFailedError`,
`HealthError`, unhandled exceptions, and SIGTERM via the preemption
handler's boundary raise), so a dead rank always leaves an ordered,
timestamped account of its last ``capacity`` decisions.
`python -m tpu_dp.obs timeline` merges the per-rank dumps with the
metrics/quarantine/membership artifacts into one forensic timeline
(docs/OBSERVABILITY.md "Flight recorder").

Design constraints, in the counters mold (`tpu_dp/obs/counters.py`):

- **Always-on and allocation-light**: `record` is one dict build + one
  deque append under the GIL — no locks (safe from signal handlers: the
  preemption handler records), no jax, no IO. Subsystems publish
  unconditionally; what gates anything is whether a dump directory was
  `configure`d (the Trainer does; a bare library user gets an in-memory
  ring they can `dump()` themselves).
- **Rank-stable filenames**: the dump name uses the rank given at
  `configure` time — the Trainer passes its *stable* launch rank, so an
  elastic regroup's dense-rank reassignment can never make two processes
  overwrite each other's black box.
- **Atomic dumps**: tmp + rename, like the Perfetto export — a dump
  raced by the dying process's teardown must never leave half a JSON
  where the postmortem expects evidence.

Hang dumps: a hung rank never reaches an exit path, so rank 0's
`HealthMonitor` (which flags the stale heartbeat) drops a
``dump_request.json`` sentinel into the shared obs dir
(`HealthMonitor.request_dump`); every still-stepping rank polls the
sentinel at window boundaries (`FlightRecorderHook`) and dumps its ring
mid-run — the survivors' view of the minutes before the hang is exactly
what the postmortem needs when the hung rank's own ring is unreachable.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from pathlib import Path
from typing import Any

from tpu_dp_torch.obs._atomic import atomic_write_text

#: Dump-file schema version (bumped on any breaking layout change; obsctl
#: refuses schemas it does not know rather than misreading them).
SCHEMA = 1


def _json_default(value):
    """Tolerant JSON fallback: recorded fields arrive from every
    subsystem, numpy scalars included (SDC verdicts, device metrics) — a
    black box that refuses to serialize on a dying exit path would be
    worse than a lossy repr. Float-first (int() would truncate a numpy
    float), narrowed back to int when exact."""
    try:
        f = float(value)
    except (TypeError, ValueError):
        return repr(value)
    i = int(f)
    return i if i == f else f

#: dump filename pattern (rank is the stable launch rank, zero-padded
#: like the heartbeat files so shell globs sort them).
DUMP_GLOB = "flightrec_r*.json"

#: the hang-dump sentinel rank 0's HealthMonitor drops into the obs dir.
DUMP_REQUEST = "dump_request.json"

#: Single-source event-kind registry: every kind any subsystem emits
#: (``flightrec.record``, a metrics ``{"event": ...}`` record, or an
#: obsctl timeline synthesis site) and every kind ``obsctl timeline``
#: renders MUST be declared here, with a one-line meaning. dplint DP404
#: (`tpu_dp.analysis.hostproto`) enforces both directions — an emit of an
#: unregistered kind and a rendered kind nothing emits are both lint
#: failures — so the renderer and the emitters cannot drift apart the way
#: the pre-registry ``dump_request`` marker did (rendered, never
#: recorded). Registration is intentionally a dict, not an enum: kinds
#: stay plain strings at emit sites (signal-handler-safe, no imports) and
#: this table is the audit surface.
KINDS: dict[str, str] = {
    # -- step/epoch lifecycle (train/hooks.py, trainer, obsctl) ---------
    "epoch_start": "an epoch began on this rank",
    "step": "periodic step heartbeat with loss/throughput fields",
    "epoch_complete": "obsctl-synthesized epoch boundary from metrics",
    "eval": "obsctl-synthesized eval record from metrics.jsonl",
    "exit": "Trainer.fit exit path (clean or exceptional), with reason",
    # -- checkpoint / snapshot protocol ---------------------------------
    "snapshot": "in-memory rollback snapshot taken",
    "snapshot_write_error": "async snapshot spill failed (kept in RAM)",
    "ckpt_write_error": "checkpoint write failed after retries",
    "ckpt_corrupt": "checkpoint integrity verification failed on load",
    "ckpt_corrupt_fallback": "load fell back to an older verified step",
    "ckpt_skipped_candidate": "resume skipped a quarantined/partial step",
    # -- divergence guard / SDC (resilience/guard.py, hooks) ------------
    "guard_trigger": "divergence guard tripped (spike/SDC verdict)",
    "guard_rollback": "guard rolled state back to a snapshot",
    "guard_halt": "guard halted the run (rollback budget exhausted)",
    "guard_sdc": "SDC audit verdict recorded",
    "guard_spike": "loss-spike verdict recorded",
    "guard_evict": "guard evicted a suspect rank",
    "guard_quarantine": "rank quarantined by the guard protocol",
    "guard_tombstone": "rank tombstoned (permanent quarantine)",
    # -- quarantine log kinds (resilience/guard.py QuarantineLog) -------
    "spike": "quarantine-log loss-spike entry",
    "sdc": "quarantine-log SDC-mismatch entry",
    "quarantine": "quarantine-log quarantine entry",
    "tombstone": "quarantine-log tombstone entry",
    # -- elastic membership (resilience/elastic.py, trainer) ------------
    "membership_epoch": "membership epoch committed to the ledger",
    "membership_formed": "obsctl-synthesized membership view formed",
    "elastic_trigger": "elastic regroup triggered (departure/grow)",
    "elastic_departure": "peer departure detected",
    "elastic_suspect": "peer suspected dead (missed heartbeats)",
    "elastic_regroup": "regroup committed; ranks/mesh rebuilt",
    "elastic_grow": "grow path admitted waiting joiners",
    "elastic_join": "this rank joined a running job",
    "elastic_join_request": "join request observed in the ledger",
    "join_refused": "join request refused (quota/epoch mismatch)",
    "rank_joined": "obsctl-synthesized joiner admission record",
    "eviction": "rank evicted from the membership ledger",
    # -- preemption ------------------------------------------------------
    "preempt_signal": "SIGTERM/preemption notice received",
    "preempt_exit": "run exited at a preemption boundary",
    # -- serving fleet (serve/) -----------------------------------------
    "model_swap": "replica swapped to a new model version",
    "serve_dispatch": "batch dispatched to the device",
    "replica_failed": "replica marked failed by the router",
    "replica_drain_begin": "router began draining a replica",
    "replica_drain": "replica drain completed",
    "replica_rejoin": "failed replica rejoined the fleet",
    "replica_quarantined": "flapping replica quarantined by health gate",
    "replica_restored": "quarantined replica restored to rotation",
    # -- chaos / storage faults (chaos/storage.py) ----------------------
    "storage_fault_armed": "storage-fault schedule armed on a seam",
    "storage_fault": "injected storage fault fired",
    # -- observability machinery ----------------------------------------
    "comm_profile": "communication profile window summarized",
    "profile_start": "profiler capture started",
    "profile_stop": "profiler capture stopped",
    "dump_request": "hang-dump sentinel honored; ring dumped mid-run",
    "alert": "obsctl-synthesized alert from signal thresholds",
    "fleet_skew": "obsctl-synthesized cross-rank skew spike (fleet stream)",
}


def dump_path_for(dump_dir: str | os.PathLike, rank: int,
                  tag: str = "") -> Path:
    """Dump path for a (stable rank, incarnation tag) pair.

    ``tag`` distinguishes incarnations that legitimately share a stable
    rank: a preempted rank that REJOINS the run (elastic grow) must not
    overwrite its predecessor's departure dump — the departure is exactly
    the forensic record the rejoin story needs. Tagged names still match
    `DUMP_GLOB`, so obsctl reads both incarnations.
    """
    suffix = f"_{tag}" if tag else ""
    return Path(dump_dir) / f"flightrec_r{int(rank):05d}{suffix}.json"


class FlightRecorder:
    """A bounded ring of ``{"ts", "kind", ...}`` events with atomic dumps."""

    def __init__(self, capacity: int = 2048):
        self.capacity = max(1, int(capacity))
        self._events: deque[dict] = deque(maxlen=self.capacity)
        self.total_recorded = 0   # lifetime count, beyond the ring
        self.rank = 0
        self.tag = ""             # incarnation tag (elastic rejoin)
        self.dump_dir: Path | None = None
        self.run: dict[str, Any] = {}
        self.dumps = 0
        self.enabled = True       # disable() makes record() a no-op
        self._req_handled = 0.0   # mtime of the last honored dump request

    def configure(self, rank: int = 0,
                  dump_dir: str | os.PathLike | None = None,
                  capacity: int | None = None,
                  run: dict | None = None,
                  fresh: bool = False,
                  tag: str = "") -> "FlightRecorder":
        """Set identity + dump target (the Trainer calls this at startup).

        ``fresh=True`` marks a RUN boundary: the ring is cleared so a new
        Trainer in a long-lived process (tests, notebooks) never dumps a
        previous run's events as its own. Plain reconfiguration keeps the
        contents — an elastic regroup re-homes the observers mid-run, and
        the pre-regroup events are exactly the forensics a later dump
        must carry. ``capacity`` changes rebuild the ring (contents
        preserved up to the new bound). ``tag`` names this incarnation's
        dump file (`dump_path_for`) — a rejoined rank must not overwrite
        its predecessor's departure dump.
        """
        if fresh:
            self._events.clear()
            self.total_recorded = 0
            self.dumps = 0
            self._req_handled = 0.0
        self.enabled = True
        self.rank = int(rank)
        self.tag = str(tag)
        self.dump_dir = None if dump_dir is None else Path(dump_dir)
        if fresh and self.dump_dir is not None:
            # A dump_request.json left behind by a PREVIOUS incarnation (a
            # hang that got the job killed before the sentinel aged out)
            # must not fire on THIS run's first window — the near-empty new
            # ring would overwrite the very flightrec_r*.json dumps the
            # sentinel existed to preserve. Prime the handled mark with the
            # stale sentinel's mtime; only a request written AFTER this run
            # started is honored.
            try:
                self._req_handled = (
                    self.dump_dir / DUMP_REQUEST).stat().st_mtime
            except OSError:
                pass
        if run is not None:
            self.run = dict(run)
        if capacity is not None and int(capacity) != self.capacity:
            self.capacity = max(1, int(capacity))
            self._events = deque(self._events, maxlen=self.capacity)
        return self

    def disable(self) -> "FlightRecorder":
        """Stop recording entirely (``obs.flightrec_capacity=0``): every
        module-level `record()` call across the codebase becomes a no-op
        — "disabled" must mean no events accumulate, not merely no dump.
        The ring is cleared so a later `dump()` cannot resurrect a
        disabled run's history. Re-enabled by the next `configure`."""
        self.enabled = False
        self._events.clear()
        self.total_recorded = 0
        self.dump_dir = None
        return self

    def record(self, kind: str, step: int | None = None,
               **fields: Any) -> dict:
        """Append one event; safe from signal handlers (no locks, no IO).
        A disabled recorder returns the built event without storing it."""
        ev: dict[str, Any] = {"ts": time.time(), "kind": str(kind)}
        if step is not None:
            ev["step"] = int(step)
        if fields:
            ev.update(fields)
        if self.enabled:
            self._events.append(ev)
            self.total_recorded += 1
        return ev

    def events(self) -> list[dict]:
        """The ring's contents, oldest first."""
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    # -- dumping --------------------------------------------------------

    def dump(self, path: str | os.PathLike | None = None,
             reason: str = "unspecified",
             extra: dict | None = None) -> Path | None:
        """Write the ring (+ a counter snapshot) atomically; returns the
        path, or None when neither ``path`` nor a configured dump dir
        names one. Never raises: the dump runs on dying exit paths where
        a telemetry failure must not mask the original error — a failed
        dump logs and returns None.
        """
        if path is None:
            if self.dump_dir is None:
                return None
            path = dump_path_for(self.dump_dir, self.rank, tag=self.tag)
        out = Path(path)
        try:
            from tpu_dp_torch.obs.counters import counters

            payload = {
                "schema": SCHEMA,
                "rank": self.rank,
                "tag": self.tag,
                "reason": str(reason),
                "ts": time.time(),
                "run": self.run,
                "total_recorded": self.total_recorded,
                "counters": counters.snapshot(),
                "events": list(self._events),
            }
            if extra:
                payload.update(extra)
            atomic_write_text(out, json.dumps(payload,
                                              default=_json_default))
            self.dumps += 1
            return out
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "flight-recorder dump to %s failed", out, exc_info=True
            )
            return None

    # -- hang-dump sentinel --------------------------------------------

    def poll_dump_request(self) -> Path | None:
        """Honor a pending ``dump_request.json`` in the dump dir (once per
        sentinel write): dump the ring mid-run and return the dump path.
        Called at window boundaries by `FlightRecorderHook` — one stat()
        per dispatched window when configured, nothing otherwise.
        """
        if self.dump_dir is None:
            return None
        req = self.dump_dir / DUMP_REQUEST
        try:
            mtime = req.stat().st_mtime
        except OSError:
            return None
        if mtime <= self._req_handled:
            return None
        self._req_handled = mtime
        try:
            why = json.loads(req.read_text()).get("reason", "requested")
        except (OSError, ValueError):
            why = "requested"
        # The honored request is itself an event: before DP404 this kind
        # was rendered by the timeline but never emitted, so a hang
        # postmortem could not see WHICH window each survivor dumped in.
        self.record("dump_request", reason=str(why))
        return self.dump(reason=f"dump_request: {why}")

    def reset(self) -> None:
        """Drop everything — test isolation only."""
        self._events.clear()
        self.total_recorded = 0
        self.dumps = 0
        self.enabled = True
        self._req_handled = 0.0
        self.run = {}
        self.dump_dir = None
        self.rank = 0
        self.tag = ""


#: The process-wide recorder every subsystem publishes into.
recorder = FlightRecorder()


def record(kind: str, step: int | None = None, **fields: Any) -> dict:
    """Module-level shorthand: `recorder.record(...)`."""
    return recorder.record(kind, step=step, **fields)


def write_dump_request(run_dir: str | os.PathLike, reason: str) -> Path:
    """Drop the hang-dump sentinel (rank 0 / an out-of-band watcher).

    Overwrites any previous sentinel: the stepping ranks honor each
    distinct mtime once, so repeated requests produce repeated dumps.
    """
    return atomic_write_text(
        Path(run_dir) / DUMP_REQUEST,
        json.dumps({"reason": str(reason), "ts": time.time()}),
    )


def read_dump(path: str | os.PathLike) -> dict:
    """Load + schema-check one dump file (obsctl / tests)."""
    payload = json.loads(Path(path).read_text(encoding="utf-8"))
    if payload.get("schema") != SCHEMA:
        raise ValueError(
            f"flight-recorder dump {path} has schema "
            f"{payload.get('schema')!r}, expected {SCHEMA}"
        )
    return payload
