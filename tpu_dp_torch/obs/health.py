"""Cross-rank heartbeats + straggler/hang detection (the port of
`tpu_dp.obs.health`, with the same file names and line format, so each
package's `HealthMonitor` reads the other's heartbeat files).

"Step 4017 is slow: which rank?" A data-parallel step runs at the speed of
its slowest replica (every collective is a barrier), so one rank with a
throttled card or a half-dead host drags the whole run, and from rank 0's
own timings every step just looks slow. Per-rank heartbeats make the
laggard attributable; a *stale* heartbeat (a rank that stopped beating)
is the hang signature that otherwise presents as every surviving rank
blocked inside its next collective.

Protocol:

- every process appends ``{"rank", "step", "ts", "step_ms"}`` JSON lines
  to its OWN file, ``<run_dir>/heartbeat_r<rank:05d>.jsonl``: one writer
  per file, no locking; the shared ``run_dir`` is the rendezvous;
- rank 0 (or any out-of-band watcher: the files are JSONL) aggregates
  with `HealthMonitor`: ``check()`` compares the *latest* beat per rank
  (live straggler and stale detection), ``scan()`` every step across
  ranks (post-hoc attribution);
- detection is relative: a rank is a straggler when its step time exceeds
  ``straggler_factor x`` the median of the other ranks at the same
  observation.

File-based and collective-free on purpose: health checking must keep
working exactly when collectives are what is wedged. A writer re-homed
after an elastic regroup stamps its membership epoch (``me``) into every
beat, as the JAX package's does; a rank admitted into a grown world gets
its own "missing" grace from its admission (``HealthMonitor.admit``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from pathlib import Path
from typing import Callable

from tpu_dp_torch.obs.spans import percentile

_HEARTBEAT_GLOB = "heartbeat_r*.jsonl"


class HealthError(RuntimeError):
    """Raised by `HealthMonitor.report(..., on_flag="raise")` — carries the
    issues so a supervisor can requeue the named rank instead of grepping."""

    def __init__(self, message: str, issues: tuple["HealthIssue", ...] = ()):
        super().__init__(message)
        self.issues = tuple(issues)


@dataclasses.dataclass(frozen=True)
class HealthIssue:
    """One flagged rank: what, who, how bad.

    ``kind``: "straggler" (step_ms ≥ factor × median), "stale" (heartbeat
    older than the hang threshold), or "missing" (a rank that never beat).
    ``ratio`` is step_ms / median step_ms for stragglers (the measured lag
    factor); ``age_s`` is the heartbeat age for stale/missing.
    """

    kind: str
    rank: int
    step: int = -1
    step_ms: float = 0.0
    median_ms: float = 0.0
    ratio: float = 0.0
    age_s: float = 0.0

    def describe(self) -> str:
        if self.kind == "straggler":
            return (
                f"rank {self.rank} straggling at step {self.step}: "
                f"{self.step_ms:.1f} ms/step vs median "
                f"{self.median_ms:.1f} ({self.ratio:.1f}x)"
            )
        if self.kind == "stale":
            return (
                f"rank {self.rank} heartbeat stale: last beat at step "
                f"{self.step}, {self.age_s:.1f}s ago — rank hung or dead"
            )
        return f"rank {self.rank} has no heartbeat yet"


class HeartbeatWriter:
    """One process's heartbeat appender (rank-owned file, append + flush).

    ``every_steps`` throttles by boundary-crossing (same discipline as
    `SnapshotManager.due` — windowed dispatch only shows the host window
    boundaries, so equality tests would skip beats). Each line is flushed
    so a monitor — or a post-mortem — always sees the latest completed
    step even if this process dies mid-run; that durability is the point.
    """

    def __init__(self, run_dir: str | os.PathLike, rank: int,
                 every_steps: int = 1, me: int = 0):
        self.rank = int(rank)
        self.every_steps = max(1, int(every_steps))
        # The membership epoch stamped into every beat after a regroup.
        self.me = int(me)
        self.path = Path(run_dir) / f"heartbeat_r{self.rank:05d}.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")
        self._last_step: int | None = None
        self.generation = 0  # bumped by rewind() after a guard rollback

    def beat(self, step: int, step_ms: float, ts: float | None = None) -> bool:
        """Append one heartbeat; returns False when throttled away."""
        step = int(step)
        if self._last_step is not None and (
            step // self.every_steps <= self._last_step // self.every_steps
        ):
            return False
        self._last_step = step
        rec = {
            "rank": self.rank,
            "step": step,
            "ts": time.time() if ts is None else float(ts),
            "step_ms": round(float(step_ms), 3),
        }
        if self.generation:
            # Replayed steps are distinguishable from their first attempt:
            # post-hoc attribution (`HealthMonitor.scan`) keeps the
            # highest-generation record per (rank, step) instead of
            # double-counting the rolled-back pass.
            rec["gen"] = self.generation
        if self.me:
            rec["me"] = self.me
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        return True

    def rewind(self, step: int) -> None:
        """Un-throttle after a rollback rewound the step clock below beats
        already written: without this, `beat` would stay silent for the
        whole replay window (step <= the pre-rollback high-water mark) and
        the monitor would read healthy replaying ranks as hung. Bumps the
        generation stamped on every subsequent record."""
        self._last_step = None
        self.generation += 1

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HealthMonitor:
    """Aggregate the run dir's heartbeat files; flag stragglers and hangs.

    False positives are the design constraint: with ``on_flag="raise"``
    (the CI/supervised-fleet mode) a spurious flag aborts a healthy run,
    so (a) "missing" ranks are only flagged after a startup grace of
    ``stale_after_s`` — the first check can run before any rank finished
    its first (compile-heavy) window; and (b) staleness is judged against
    ``max(stale_after_s, STALE_INTERVAL_FACTOR x the rank's own observed
    inter-beat interval)`` — beats arrive once per dispatched window, and
    a window longer than the fixed threshold must not mark every healthy
    rank as hung."""

    #: a beat is stale only past this multiple of the rank's own observed
    #: inter-beat interval (when known) — hang detection that tolerates
    #: long dispatch windows without a per-deployment threshold.
    STALE_INTERVAL_FACTOR = 3.0

    def __init__(
        self,
        run_dir: str | os.PathLike,
        world: int,
        straggler_factor: float = 3.0,
        stale_after_s: float = 60.0,
        min_step_ms: float = 1.0,
        on_flag: str = "warn",
        logger: Callable[[str], None] | None = None,
    ):
        if on_flag not in ("warn", "raise"):
            raise ValueError(f"on_flag must be warn|raise, got {on_flag!r}")
        if straggler_factor <= 1.0:
            raise ValueError(
                f"straggler_factor must exceed 1.0, got {straggler_factor}"
            )
        self.run_dir = Path(run_dir)
        self.world = int(world)
        self.straggler_factor = float(straggler_factor)
        self.stale_after_s = float(stale_after_s)
        # Floor on the median used as a ratio denominator: at µs-scale step
        # times (tiny CPU smoke runs) scheduler jitter alone exceeds any
        # factor, and a 3x blip on a 0.2ms step is not a straggler.
        self.min_step_ms = float(min_step_ms)
        self.on_flag = on_flag
        self._log = logger
        self._start = time.time()
        # Per-rank admission times (elastic grow): a freshly admitted rank
        # has no heartbeat history, and judging its absence against the
        # monitor's start would flag it "missing" the moment the startup
        # grace ran out, while it still builds its first window. `admit`
        # restarts that rank's grace at its admission.
        self._admitted: dict[int, float] = {}

    def admit(self, rank: int, ts: float | None = None) -> None:
        """Mark ``rank`` (re)admitted at ``ts`` (default: now): its
        "missing" grace restarts from then instead of the monitor's
        construction."""
        self._admitted[int(rank)] = time.time() if ts is None else float(ts)

    # -- reading -------------------------------------------------------

    #: bytes of file tail `latest()` reads per rank — ~70 bytes/beat, so
    #: this holds hundreds of recent beats; the live check is O(world),
    #: not O(world x run length) (which would slowly make rank 0's own
    #: health check the straggler on exactly the long runs it watches).
    TAIL_BYTES = 65536

    def read_beats(self, tail_bytes: int | None = None) -> dict[int, list[dict]]:
        """Beats per rank, file order (append order); ``tail_bytes``
        bounds the read to each file's trailing block (the first line of
        a mid-file tail is dropped as possibly torn). Torn/garbage lines
        are skipped — a beat written while the host died is expected,
        not an error."""
        out: dict[int, list[dict]] = {}
        for path in sorted(self.run_dir.glob(_HEARTBEAT_GLOB)):
            try:
                if tail_bytes is None:
                    text = path.read_text(encoding="utf-8")
                else:
                    with open(path, "rb") as f:
                        f.seek(0, os.SEEK_END)
                        size = f.tell()
                        f.seek(max(0, size - tail_bytes))
                        text = f.read().decode("utf-8", "replace")
                    if size > tail_bytes:
                        # Mid-line seek: everything before the first
                        # newline is a partial record.
                        _, _, text = text.partition("\n")
            except OSError:
                continue
            for line in text.splitlines():
                try:
                    rec = json.loads(line)
                    rank = int(rec["rank"])
                    rec["step"] = int(rec["step"])
                    rec["step_ms"] = float(rec["step_ms"])
                    rec["ts"] = float(rec["ts"])
                except (ValueError, KeyError, TypeError):
                    continue
                out.setdefault(rank, []).append(rec)
        return out

    def latest(self) -> dict[int, dict]:
        """The newest beat per rank (highest (generation, step) wins; file
        order ties). The generation key first: after a guard rollback the
        replay legitimately beats at LOWER steps than the rolled-back
        pass, and judging liveness by the stale pre-rollback high-water
        beat would flag every healthy replaying rank.

        Tail-bounded read (`TAIL_BYTES`): the live check only needs each
        rank's newest line, never the full history."""
        return {
            rank: max(beats, key=lambda b: (b.get("gen", 0), b["step"]))
            for rank, beats in self.read_beats(
                tail_bytes=self.TAIL_BYTES
            ).items()
            if beats
        }

    # -- detection -----------------------------------------------------

    def _straggler_issues(self, by_rank: dict[int, dict]) -> list[HealthIssue]:
        """step_ms outliers among one observation set (latest or per-step).

        Needs ≥ 2 ranks (there is no median to lag behind alone). Each
        rank is compared against the *leave-one-out* median — the median
        of the OTHER ranks' step times: including a rank in its own
        denominator caps the measurable ratio at 2x for a two-rank world
        (the even-count median averages in the outlier), which would make
        any factor ≥ 2 undetectable exactly where detection matters.
        """
        if len(by_rank) < 2:
            return []
        issues = []
        for rank, b in sorted(by_rank.items()):
            others = [o["step_ms"] for r, o in by_rank.items() if r != rank]
            median = max(percentile(sorted(others), 50), self.min_step_ms)
            ratio = b["step_ms"] / median
            if ratio >= self.straggler_factor:
                issues.append(HealthIssue(
                    kind="straggler", rank=rank, step=b["step"],
                    step_ms=round(b["step_ms"], 3),
                    median_ms=round(median, 3), ratio=round(ratio, 2),
                ))
        return issues

    def check(self, now: float | None = None) -> list[HealthIssue]:
        """Live health from the newest beats per rank.

        Flags: ranks whose newest heartbeat is stale (hang/death — older
        than ``max(stale_after_s, STALE_INTERVAL_FACTOR x that rank's own
        last inter-beat interval)``, measured against ``now``, injectable
        for tests), ranks that never produced a file (missing — only
        after a ``stale_after_s`` startup grace), and stragglers among
        the fresh beats' step times.
        """
        now = time.time() if now is None else float(now)
        by_rank = self.read_beats(tail_bytes=self.TAIL_BYTES)
        issues: list[HealthIssue] = []
        for rank in range(self.world):
            # Host-only aggregation: the monitor is collective-free by
            # design (it must work when collectives are what's wedged).
            # The startup grace keeps the first checks, which can run
            # before any rank finishes its first window (cuDNN plans, the
            # graph capture), from flagging a healthy, still-warming run;
            # a rank admitted mid-run (the elastic grow) gets it from its
            # own admission.
            since = self._admitted.get(rank, self._start)
            if rank not in by_rank and now - since > self.stale_after_s:
                issues.append(HealthIssue(
                    kind="missing", rank=rank,
                    age_s=round(now - since, 3),
                ))
        fresh: dict[int, dict] = {}
        for rank, beats in sorted(by_rank.items()):
            # (generation, step): a post-rollback replay's beats outrank
            # the rolled-back pass even at lower step numbers.
            ordered = sorted(beats, key=lambda b: (b.get("gen", 0), b["step"]))
            b = ordered[-1]
            age = now - b["ts"]
            interval = (
                b["ts"] - ordered[-2]["ts"] if len(ordered) >= 2 else 0.0
            )
            threshold = max(self.stale_after_s,
                            self.STALE_INTERVAL_FACTOR * interval)
            if age > threshold:
                issues.append(HealthIssue(
                    kind="stale", rank=rank, step=b["step"],
                    step_ms=b["step_ms"], age_s=round(age, 3),
                ))
            else:
                fresh[rank] = b
        issues.extend(self._straggler_issues(fresh))
        return issues

    def scan(self, beats: dict[int, list[dict]] | None = None
             ) -> list[HealthIssue]:
        """Post-hoc attribution over the full history: for every step at
        which ≥ 2 ranks reported, flag ranks whose step time exceeded
        ``straggler_factor ×`` that step's cross-rank median — "which rank
        made step K slow", answered from the files alone.

        Steps replayed after a guard rollback appear once: per (rank,
        step) only the highest-generation record (the surviving attempt)
        enters the attribution — rolled-back work is never double-counted.

        ``beats`` (a `read_beats` result) lets a caller that also needs
        the raw streams share one file pass (`obsctl watch` polls this
        every tick).
        """
        by_step: dict[int, dict[int, dict]] = {}
        for rank, beats in (self.read_beats()
                            if beats is None else beats).items():
            for b in beats:
                cur = by_step.setdefault(b["step"], {}).get(rank)
                if cur is None or b.get("gen", 0) >= cur.get("gen", 0):
                    by_step[b["step"]][rank] = b
        issues: list[HealthIssue] = []
        for step in sorted(by_step):
            issues.extend(self._straggler_issues(by_step[step]))
        return issues

    # -- hang forensics ------------------------------------------------

    def request_dump(self, issues: list[HealthIssue],
                     dump_dir: str | os.PathLike | None = None
                     ) -> os.PathLike | None:
        """Drop the flight-recorder hang-dump sentinel when ``issues``
        name a stale/missing rank (the flight recorder's hang dump): a
        hung rank never reaches an exit path, so its own
        ring is unreachable — the sentinel makes every still-stepping
        rank dump ITS ring at the next window boundary, preserving the
        survivors' view of the minutes before the hang. Stragglers are
        slow, not dead — they never trigger a dump.

        ``dump_dir`` must be the directory the recorders POLL (the
        trainer passes its flight recorder's dump dir). Defaults to
        ``run_dir``. Returns the sentinel path when one was written."""
        hung = [i for i in issues if i.kind in ("stale", "missing")]
        if not hung:
            return None
        from tpu_dp_torch.obs import flightrec

        reason = "; ".join(i.describe() for i in hung)
        return flightrec.write_dump_request(
            self.run_dir if dump_dir is None else dump_dir, reason
        )

    # -- reporting -----------------------------------------------------

    def report(self, issues: list[HealthIssue]) -> list[HealthIssue]:
        """Surface ``issues`` per ``on_flag``; returns them for chaining.

        "warn" routes each through ``logger`` (default: a warning on the
        ``tpu_dp_torch.obs.health`` logger); "raise" raises `HealthError` carrying the issues — the CI
        / supervisor mode, where a silent straggler is a silent 3x bill.
        """
        if not issues:
            return issues
        if self.on_flag == "raise":
            raise HealthError(
                "; ".join(i.describe() for i in issues), issues=tuple(issues)
            )
        log = self._log
        if log is None:
            logger = logging.getLogger("tpu_dp_torch.obs.health")
            log = lambda msg: logger.warning("health: %s", msg)  # noqa: E731
        for issue in issues:
            log(issue.describe())
        return issues
