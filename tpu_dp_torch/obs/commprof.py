"""In-run comm/compute attribution: wire-time profiling + overlap gauges
(the port of `tpu_dp.obs.commprof`).

An **in-run, step-ranged profiling window** (``obs.comm_profile_steps``,
riding the `utils.profiling.StepProfiler` arm/disarm discipline) captures
a `torch.profiler` trace of exactly the steps under investigation, parses
it through `tpu_dp_torch.obs.kineto`, and publishes a comm/compute/overlap
breakdown:

- per-collective time and event counts, **reconciled against the port's
  own books of what it issued** (`parallel.collectives.counts`, and
  DDP's bucket rebuild in `collectives.torch_issued`, mapped to kinds by
  `BOOK_KINDS`; the JAX package holds its trace against the
  compiled HLO schedule instead): every collective the books say ran in
  the window must be in the trace exactly once, and nothing more. The
  books tick where the host issues a collective, so under a CUDA graph
  at capture only: the trainer's books add each replay's share
  (`MultiStep.replayed_books`). Where the backend runs nothing for a
  kind (NCCL at one rank), the kind is reported absent with the reason,
  neither ok nor a failure;
- wire bytes per update from the tensors the collectives were handed
  (`collectives.wire_bytes`), reconciled against `parallel.quant.
  wire_report` for the sharded exchange — two independent derivations of
  one number — and effective wire GB/s against the card's NVLink rate
  (`obs.chips.link_gbs`; absent at one rank, where nothing crosses a
  link, and on a card whose rate is unknown);
- the headline gauges ``obs.comm_ms``, ``obs.exposed_comm_ms`` (comm not
  hidden under compute) and ``obs.overlap_frac`` (1 − exposed/comm),
  published per window like MFU, in the schema-3 metrics records (a
  ``comm_profile`` event and the counter snapshots), the promfile,
  ``comm_report.json`` (the JAX package's layout, ``SCHEMA`` 1) and
  ``obsctl diff`` / ``obsctl watch``.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Callable

from tpu_dp_torch.obs import kineto
from tpu_dp_torch.obs._atomic import atomic_write_text
from tpu_dp_torch.obs.counters import counters as _obs_counters

#: comm_report.json schema (bumped on breaking layout changes;
#: `read_comm_report` refuses unknown versions, like flightrec dumps).
SCHEMA = 1

#: `parallel.collectives.books` key -> the collective kind it books.
BOOK_KINDS = {
    "ddp_buckets": "all-reduce", "pmean_forward": "all-reduce",
    "pmean_backward": "all-reduce", "psum": "all-reduce",
    "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
    "all_gather": "all-gather", "ddp_rebuild_broadcasts": "broadcast",
}


class CommProfileError(ValueError):
    """Typed failure of the comm-attribution layer (bad spec, unreadable
    report, unparseable capture)."""


def read_comm_report(path: str | os.PathLike) -> dict:
    """Load + schema-check one comm_report.json (obsctl / tests)."""
    rec = json.loads(Path(path).read_text(encoding="utf-8"))
    if rec.get("schema") != SCHEMA:
        raise CommProfileError(
            f"comm report {path} has schema {rec.get('schema')!r}, "
            f"expected {SCHEMA}"
        )
    return rec


def books_by_kind(books: dict[str, int]) -> dict[str, dict[str, int]]:
    """`collectives.books`' flat dict (counts and ``bytes:<kind>``) ->
    ``{"counts": {kind: n}, "bytes": {kind: b}}``."""
    counts: dict[str, int] = {}
    nbytes: dict[str, int] = {}
    for key, v in books.items():
        if key.startswith("bytes:"):
            nbytes[key[6:]] = nbytes.get(key[6:], 0) + int(v)
        elif key in BOOK_KINDS:
            kind = BOOK_KINDS[key]
            counts[kind] = counts.get(kind, 0) + int(v)
    return {"counts": counts, "bytes": nbytes}


def wire_from_books(bytes_per_step: dict[str, float]) -> dict:
    """Per-update wire bytes by kind -> the JAX package's
    `wire_bytes_from_schedule` record: the gradient exchange is the
    reduce-scatters' and all-to-alls' inputs (the quantized payload and
    its scales), the params gather the all-gathers' results, the
    gradient all-reduce the all-reduces' tensors."""
    by_kind = {k: int(round(v)) for k, v in bytes_per_step.items() if v}
    return {
        "grad_exchange": by_kind.get("reduce-scatter", 0)
        + by_kind.get("all-to-all", 0),
        "params_gather": by_kind.get("all-gather", 0),
        "grad_allreduce": by_kind.get("all-reduce", 0),
        "by_kind": by_kind,
    }


def reconcile(expected_total: dict[str, float], observed_raw: dict[str, int],
              steps: int, devices: int,
              absent: dict[str, str] | None = None) -> dict:
    """Trace-vs-books cross-check: every booked collective must be
    observed exactly once per step per participating device.

    ``expected_total`` is the per-kind count the books give over the
    window; ``observed_raw`` the per-kind event counts in the trace
    (``devices`` normalizes them; each rank's trace holds its own, so the
    port passes 1). ``absent`` names kinds the backend runs nothing for,
    with the reason: such a kind with no event is reported, never
    compared; ``ok`` covers the compared kinds (None when every kind was
    absent).
    """
    absent = absent or {}
    per_kind = {}
    ok = True
    compared = False
    for kind in sorted(set(expected_total) | set(observed_raw)):
        exp = float(expected_total.get(kind, 0))
        raw = int(observed_raw.get(kind, 0))
        obs = raw / max(1, devices)
        entry = {
            "expected": exp,
            "observed": obs,
            "observed_raw": raw,
            "per_step_expected": round(exp / max(1, steps), 4),
            "per_step_observed": round(obs / max(1, steps), 4),
        }
        if kind in absent and raw == 0:
            entry.update(ok=None, absent=absent[kind])
        else:
            match = abs(obs - exp) < 1e-9
            ok = ok and match
            compared = True
            entry["ok"] = match
        per_kind[kind] = entry
    return {"ok": ok if compared or not per_kind else None,
            "steps": int(steps),
            "devices": int(devices), "by_kind": per_kind}


def reconcile_wire(schedule_bytes: dict, wire_report: dict,
                   wire_dtype: str) -> dict:
    """Booked wire bytes vs `quant.wire_report`'s accounting.

    The gradient-exchange bytes the collectives were handed
    (reduce-scatter inputs + all-to-all payload/scales) must equal the
    codec's own per-step byte count for the active wire dtype — two
    independent derivations of the same number (tensor sizes at issue vs
    parameter-tree layout math); a mismatch means one of them miscounts
    padding or a leaf silently changed paths.
    """
    dtype = {"": "f32", "i8": "int8"}.get(wire_dtype, wire_dtype)
    report_bytes = (wire_report.get("wire_bytes_per_step") or {}).get(dtype)
    sched = int(schedule_bytes.get("grad_exchange", 0))
    return {
        "dtype": dtype,
        "schedule_bytes_per_step": sched,
        "report_bytes_per_step": report_bytes,
        "ok": report_bytes is not None and sched == int(report_bytes),
    }


def absent_kinds(source: str | None, world: int,
                 expected_total: dict[str, float]) -> dict[str, str]:
    """Kinds the backend launches no kernel for: NCCL at one rank runs each
    collective as a device-to-device copy (a memcpy, not attributable to
    its collective), so at world 1 the device trace holds none of them."""
    if source != "device" or int(world) != 1:
        return {}
    return {k: f"NCCL launches no kernel for a one-rank {k} (a "
               f"device-to-device copy)"
            for k, v in expected_total.items() if v}


def breakdown(summary: dict, *, steps: int, devices: int,
              expected_total: dict[str, float] | None = None,
              wire: dict | None = None,
              world: int | None = None,
              wire_report: dict | None = None,
              wire_dtype: str = "",
              link_gbs: float | None = None) -> dict:
    """One window's comm/compute/overlap report from a kineto summary.

    ``steps``/``devices`` normalize the trace's raw totals;
    ``expected_total`` (per-kind counts over the window, from the books)
    arms the reconciliation; ``wire`` (`wire_from_books`, per update) the
    wire-byte accounting, ``wire_report`` + ``wire_dtype`` its
    cross-check; ``link_gbs`` the effective-bandwidth utilization
    denominator (``ici_util``, the JAX package's key), with ``world`` >
    1. Everything not armed is reported absent, never fabricated.
    """
    steps = max(1, int(steps))
    devices = max(1, int(devices))
    comm_s = float(summary.get("comm_s", 0.0))
    exposed_s = float(summary.get("exposed_comm_s", 0.0))
    compute_s = float(summary.get("compute_s", 0.0))
    counts = dict((summary.get("collectives") or {}).get("counts") or {})
    durs = dict((summary.get("collectives") or {}).get("dur_s") or {})
    crosses = world is not None and int(world) > 1

    by_kind = {}
    for kind in sorted(set(counts) | set(durs)):
        dur_s = float(durs.get(kind, 0.0))
        entry = {
            "events": int(counts.get(kind, 0)),
            "per_step": round(counts.get(kind, 0) / devices / steps, 4),
            # per-device per-step busy time in this kind of collective.
            "dur_ms_per_step": round(dur_s / devices / steps * 1e3, 4),
        }
        if wire is not None and kind in wire["by_kind"]:
            b = wire["by_kind"][kind]
            entry["wire_bytes_per_step"] = int(b)
            if crosses and dur_s > 0 and b:
                gbs = b / (dur_s / devices / steps) / 1e9
                entry["wire_gbs"] = round(gbs, 3)
                if link_gbs:
                    entry["ici_util"] = round(gbs / link_gbs, 4)
        by_kind[kind] = entry

    out = {
        "schema": SCHEMA,
        "source": summary.get("source"),
        "steps": steps,
        "devices": devices,
        # Per-device per-step milliseconds — the same unit as
        # obs.step_time_ms, so the gauges compare directly.
        "comm_ms": round(comm_s / devices / steps * 1e3, 4),
        "exposed_comm_ms": round(exposed_s / devices / steps * 1e3, 4),
        "compute_ms": round(compute_s / devices / steps * 1e3, 4),
        "overlap_frac": (
            round(1.0 - exposed_s / comm_s, 4) if comm_s > 0 else None
        ),
        "by_kind": by_kind,
    }
    if expected_total is not None:
        out["reconciliation"] = reconcile(
            expected_total, counts, steps, devices,
            absent=absent_kinds(summary.get("source"), world or 0,
                                expected_total))
    if wire is not None:
        out["wire"] = {
            "grad_exchange_bytes_per_step": wire["grad_exchange"],
            "params_gather_bytes_per_step": wire["params_gather"],
        }
        if wire_report is not None:
            out["wire"]["reconciliation"] = reconcile_wire(
                wire, wire_report, wire_dtype
            )
    return out


def parse_comm_profile_steps(spec: str | None):
    """``obs.comm_profile_steps`` grammar -> a window plan, or None.

    - ``"START:END"``    — one window over global steps [START, END);
    - ``"every:N"``      — a 1-step window at every N-step boundary
                           (snapping outward to dispatch windows, like
                           any StepProfiler range);
    - ``"every:N:W"``    — W-step windows at every N-step boundary.

    Validated eagerly so a typo fails at config time.
    """
    spec = (spec or "").strip()
    if not spec:
        return None
    if spec.startswith("every:"):
        parts = spec.split(":")
        try:
            n = int(parts[1])
            width = int(parts[2]) if len(parts) > 2 else 1
            if len(parts) > 3:
                raise ValueError
        except (ValueError, IndexError):
            raise CommProfileError(
                f"obs.comm_profile_steps must be START:END or "
                f"every:N[:W], got {spec!r}"
            ) from None
        if n < 1 or width < 1 or width > n:
            raise CommProfileError(
                f"obs.comm_profile_steps every:N:W needs 1 <= W <= N, "
                f"got {spec!r}"
            )
        return ("every", n, width)
    from tpu_dp_torch.utils.profiling import parse_profile_steps

    try:
        rng = parse_profile_steps(spec)
    except ValueError:
        raise CommProfileError(
            f"obs.comm_profile_steps must be START:END or every:N[:W], "
            f"got {spec!r}"
        ) from None
    return ("range", rng[0], rng[1])


class CommProfiler:
    """Step-ranged comm-attribution windows over a training run.

    Rides the `StepProfiler` arm/disarm discipline: the trainer's hook
    calls :meth:`on_window_start` before every dispatch (arming a
    capture whose trace lands in its own ``w<START>`` subdir) and
    :meth:`on_step` after it (stopping + parsing once the range has
    run). The expected collectives are the books' difference over the
    captured dispatches: ``books_fn`` returns the cumulative
    `collectives.books` of what ran (replays included), read when the
    capture arms and when it stops. In ``every:N`` mode a fresh
    `StepProfiler` re-arms for each cadence window — the
    one-artifact-per-run rule applies per window, not per run.

    ``publish`` is the trainer's callback ``(report, start, end,
    trace_dir)``; parsing and publication never raise into the hot loop
    (a failed parse logs, records a flightrec event, and the window is
    skipped).
    """

    def __init__(self, trace_dir: str | os.PathLike, spec,
                 *, devices: int, world: int,
                 books_fn: Callable[[], dict] | None = None,
                 source: str | None = None,
                 wire_report: dict | None = None,
                 wire_dtype: str = "",
                 link_gbs: float | None = None,
                 publish: Callable | None = None,
                 start_fn=None, stop_fn=None):
        if not trace_dir:
            raise CommProfileError(
                "comm profiling needs a trace dir "
                "(obs.comm_profile_dir or the obs run dir)"
            )
        self.trace_dir = Path(trace_dir)
        self.mode, self.a, self.b = spec  # ("range", s, e) | ("every", n, w)
        self.devices = max(1, int(devices))
        self.world = max(1, int(world))
        self.books_fn = books_fn
        self.source = source
        self.wire_report = wire_report
        self.wire_dtype = wire_dtype
        self.link_gbs = link_gbs
        self.publish = publish
        self._start_fn, self._stop_fn = start_fn, stop_fn
        self._prof = None          # the active window's StepProfiler
        self._next_start = self.a if self.mode == "range" else None
        self._win_steps = 0
        self._win_books: dict | None = None
        self._win_first = 0
        self.reports = 0
        self.last_report: dict | None = None

    # -- window scheduling ------------------------------------------------

    def _window_for(self, first_step: int):
        """(start, end) of the next window a step >= first_step can hit,
        or None (range mode, exhausted)."""
        if self.mode == "range":
            return (self.a, self.b) if self._next_start is not None else None
        # every:N:W — windows [kN, kN+W) for k >= 1. A first_step landing
        # INSIDE a W>1 window (step jump after a resume/regroup) still
        # hits that window — the capture snaps outward like any
        # StepProfiler range, it is not forfeited to the next cadence.
        k = max(1, first_step // self.a)
        if k * self.a + self.b <= first_step:
            k += 1
        return (k * self.a, k * self.a + self.b)

    def _books(self) -> dict | None:
        if self.books_fn is None:
            return None
        return dict(self.books_fn())

    # -- the StepProfiler-discipline hooks --------------------------------

    def on_window_start(self, first_step: int, n: int) -> None:
        """Arm (and account) before dispatching steps
        [first_step, first_step + n)."""
        from tpu_dp_torch.utils.profiling import StepProfiler

        # Two passes: a pending window the step clock jumped past (resume,
        # rollback-free regroup) retires on the first, and the cadence
        # window THIS dispatch covers arms on the second — every:N must
        # not silently drop a capture on a step jump. A freshly armed
        # window always ends past first_step, so it can never be done.
        for _ in range(2):
            if self._prof is None:
                win = self._window_for(first_step)
                if win is None:
                    return
                start, end = win
                if self.mode == "range" and first_step >= end:
                    self._next_start = None  # resumed past it; range skipped
                    return
                self._prof = StepProfiler(
                    str(self.trace_dir / f"w{start:08d}"), start, end,
                    start_fn=self._start_fn, stop_fn=self._stop_fn,
                    label="commprof",
                )
                self._win_steps = 0
                self._win_books = None
                self._win_first = 0
            was_active = self._prof.active
            if not was_active:
                # Read before the capture arms: the books hold everything
                # dispatched so far, and the window's count is the
                # difference at its stop.
                books = self._books()
            self._prof.on_window_start(first_step, n)
            if self._prof.active:
                if not was_active:
                    self._win_first = first_step
                    self._win_books = books
                self._win_steps += max(1, n)
                return
            if not self._prof.done:
                return  # armed, pending a future dispatch
            self._retire_window()

    def on_step(self, global_step: int) -> None:
        """The dispatch completed through ``global_step``; stop + parse
        once the window's last step has run."""
        if self._prof is None:
            return
        was_active = self._prof.active
        if was_active and global_step >= self._prof.end_step - 1:
            end_books = self._books()
        self._prof.on_step(global_step)
        if was_active and not self._prof.active:
            trace_dir = self._prof.trace_dir
            self._publish_window(trace_dir, global_step, end_books)
            self._retire_window()

    def close(self) -> None:
        """Stop an armed capture (end of training inside the range). The
        cut-short window is not parsed — its trace stays on disk, and
        the flightrec profile_start/stop events point at it."""
        if self._prof is not None:
            self._prof.close()
            self._retire_window()

    def _retire_window(self) -> None:
        self._prof = None
        if self.mode == "range":
            self._next_start = None

    # -- parse + publish --------------------------------------------------

    def _expected(self, end_books: dict | None):
        """(per-kind counts over the window, per-update bytes by kind)
        from the books' difference, or (None, None) without books."""
        if self._win_books is None or end_books is None:
            return None, None
        delta = {k: end_books.get(k, 0) - self._win_books.get(k, 0)
                 for k in end_books}
        kinds = books_by_kind(delta)
        steps = max(1, self._win_steps)
        return ({k: v for k, v in kinds["counts"].items() if v},
                {k: v / steps for k, v in kinds["bytes"].items()})

    def _publish_window(self, trace_dir: str, last_step: int,
                        end_books: dict | None) -> None:
        from tpu_dp_torch.obs import flightrec

        start = self._win_first
        steps = self._win_steps
        try:
            summary = kineto.summarize(trace_dir, self.source)
            expected, wire_bytes = self._expected(end_books)
            report = breakdown(
                summary, steps=steps, devices=1,
                expected_total=expected,
                wire=wire_from_books(wire_bytes)
                if wire_bytes is not None else None,
                world=self.world,
                wire_report=self.wire_report,
                wire_dtype=self.wire_dtype,
                link_gbs=self.link_gbs,
            )
        except Exception as e:
            import logging

            logging.getLogger(__name__).warning(
                "comm profile window [%d, %d] parse failed; trace kept "
                "at %s", start, last_step + 1, trace_dir, exc_info=True)
            flightrec.record("comm_profile", step=last_step,
                             start_step=start, error=str(e)[:300],
                             trace_dir=str(trace_dir))
            return
        report.update({
            "world": self.world,
            "ts": time.time(),
            "start_step": int(start),
            "end_step": int(last_step) + 1,
            "trace_dir": str(trace_dir),
        })
        self.reports += 1
        self.last_report = report
        _obs_counters.gauge("obs.comm_ms", report["comm_ms"])
        _obs_counters.gauge("obs.exposed_comm_ms",
                            report["exposed_comm_ms"])
        if report["overlap_frac"] is not None:
            _obs_counters.gauge("obs.overlap_frac", report["overlap_frac"])
        flightrec.record(
            "comm_profile", step=last_step, start_step=start,
            comm_ms=report["comm_ms"],
            exposed_comm_ms=report["exposed_comm_ms"],
            overlap_frac=report["overlap_frac"],
            reconciled=(report.get("reconciliation") or {}).get("ok"),
            trace_dir=str(trace_dir),
        )
        if self.publish is not None:
            try:
                self.publish(report, start, last_step + 1, str(trace_dir))
            except Exception:
                import logging

                logging.getLogger(__name__).warning(
                    "comm profile publish failed", exc_info=True)


def write_comm_report(path: str | os.PathLike, report: dict) -> Path:
    """Atomically write one window's report (the newest wins — the file
    is a gauge, the metrics stream the history)."""
    return atomic_write_text(Path(path),
                             json.dumps(report, indent=2) + "\n")
