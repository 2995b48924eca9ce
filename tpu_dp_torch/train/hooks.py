"""Step-lifecycle hooks: the trainer's per-window extension seam (port of
`tpu_dp.train.hooks`).

The loop fires four fixed lifecycle points and each cross-cutting
subsystem registers a `StepHook` instead of editing the loop. The hot
path pays one list iteration per dispatched window; no hook here reads a
device value.

Lifecycle (per `Trainer.train_epoch`):

- ``on_epoch_start(epoch)`` — before the first window of an epoch;
- ``on_window_start(first_step, n)`` — immediately before dispatching a
  window covering optimizer steps ``[first_step, first_step + n)``;
- ``on_step_end(ev)`` — after the window's metrics were accumulated and
  the host step clock advanced (`StepEvent`); a hook here may raise the
  trainer's control-flow exceptions (`PreemptedError`), and later hooks
  of the same sweep are then skipped;
- ``on_snapshot(epoch, done, step, meta)`` — after any snapshot commit
  (cadence or preemption final).

Hook order is load-bearing and owned by `Trainer._build_hooks`, as in the
JAX package: the flight recorder first (it must record the very boundary
a later hook raises out of), then the snapshot cadence, then fault
injection (a kill at step K lands after the step-K snapshot, the
kill/resume contract), and the preemption boundary last (it raises, and
everything before it must have run for the final state to be coherent).
The JAX package's guard, heartbeat and profiler hooks belong to ROADMAP
Queue 1 items 9c and 10 and are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

from tpu_dp_torch.obs import flightrec as _flightrec


@dataclasses.dataclass(frozen=True)
class StepEvent:
    """One dispatched window, observed at its end boundary."""

    epoch: int   # dataset epoch
    done: int    # epoch-cumulative optimizer steps incl. this window
    n: int       # optimizer steps in this window
    window: tuple  # the window's device metrics (a fetch is a host sync)


class StepHook:
    """Base hook: every lifecycle point a no-op; subclass what you need."""

    def __init__(self, trainer):
        self.tr = trainer

    def on_epoch_start(self, epoch: int) -> None:
        pass

    def on_window_start(self, first_step: int, n: int) -> None:
        pass

    def on_step_end(self, ev: StepEvent) -> None:
        pass

    def on_snapshot(self, epoch: int, done: int, step: int,
                    meta: dict[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass


class SnapshotHook(StepHook):
    """Async step-cadence snapshots (``resilience.snapshot_every_steps``)."""

    def on_step_end(self, ev: StepEvent) -> None:
        tr = self.tr
        if tr.snap_mgr.due(tr._host_step):
            tr._take_snapshot(ev.epoch, ev.done)


class FaultHook(StepHook):
    """Deterministic fault injection (``resilience.fault`` /
    ``TPU_DP_FAULT``, tests only): fires the plans whose step boundary was
    reached (`FaultInjector.on_step`)."""

    def on_step_end(self, ev: StepEvent) -> None:
        if self.tr.fault is not None:
            self.tr.fault.on_step(self.tr._host_step)


class FlightRecorderHook(StepHook):
    """The black box's feed (`tpu_dp_torch.obs.flightrec`): one ``step``
    event per window boundary (no device fetch: the window's wall time),
    the hang-dump sentinel polled, and one ``snapshot`` event per commit.
    Decisions (preemption, write errors, injected storage faults) are
    recorded where they are made."""

    def __init__(self, trainer):
        super().__init__(trainer)
        self._t_boundary = time.perf_counter()

    def on_epoch_start(self, epoch: int) -> None:
        self._t_boundary = time.perf_counter()
        _flightrec.record("epoch_start", step=self.tr._host_step,
                          epoch=epoch)

    def on_step_end(self, ev: StepEvent) -> None:
        now = time.perf_counter()
        _flightrec.record("step", step=self.tr._host_step, epoch=ev.epoch,
                          n=ev.n,
                          window_ms=round((now - self._t_boundary) * 1e3, 3))
        self._t_boundary = now
        path = _flightrec.recorder.poll_dump_request()
        if path is not None:
            self.tr._log0("flight recorder: hang-dump request honored -> %s",
                          path)

    def on_snapshot(self, epoch: int, done: int, step: int,
                    meta: dict[str, Any]) -> None:
        _flightrec.record("snapshot", step=step, epoch=epoch, done=done,
                          snapshot_kind=meta.get("kind", "snapshot"))


class BoundaryHook(StepHook):
    """The preemption boundary — always last: a pending signal runs the
    snapshot-and-exit-143 contract (`Trainer._preempt_exit`). Each rank
    reads its own flag, as in the JAX package."""

    def on_step_end(self, ev: StepEvent) -> None:
        tr = self.tr
        if tr.preempt is not None and tr.preempt.requested:
            tr._preempt_exit(ev.epoch, ev.done)
