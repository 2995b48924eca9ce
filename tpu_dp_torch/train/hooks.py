"""Step-lifecycle hooks: the trainer's per-window extension seam (port of
`tpu_dp.train.hooks`).

The loop fires four fixed lifecycle points and each cross-cutting
subsystem registers a `StepHook` instead of editing the loop. The hot
path pays one list iteration per dispatched window; no hook but the
guard's reads a device value.

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
a later hook raises out of), then the guard (a triggering window must
not be snapshotted before its rollback picks a target), the snapshot
cadence, fault injection (a kill at step K lands after the step-K
snapshot, the kill/resume contract), heartbeats (an injected ``delay:``
is attributed to the step it fired at), the step-ranged profiler, the
comm attribution's windows, and the elastic / preemption boundary last
(it raises, and everything before it must have run for the final state
to be coherent).

`GuardHook` is the one hook that reads the device: one fetch of the
window's health per window (the guard's fence).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from tpu_dp_torch.obs import flightrec as _flightrec
from tpu_dp_torch.obs.counters import counters as _counters


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
        if tr._sdc_suspect_active:
            # An SDC audit found live divergence (the guard hook, earlier
            # in this sweep): a snapshot now would be a fresh "newest
            # complete" save carrying the corruption.
            tr._log0("snapshot suppressed at step %d: SDC suspicion active",
                     tr._host_step)
            return
        if tr.snap_mgr.due(tr._host_step):
            tr._take_snapshot(ev.epoch, ev.done)


class FaultHook(StepHook):
    """Deterministic fault injection (``resilience.fault`` /
    ``TPU_DP_FAULT``, tests only): applies a due ``sdc:`` bit flip,
    disarms the device seam's ``nan:``/``spike:`` plans once the boundary
    passed their step, then fires the plans whose step boundary was
    reached (`FaultInjector.on_step`)."""

    def on_step_end(self, ev: StepEvent) -> None:
        tr = self.tr
        if tr.fault is None:
            return
        # sdc and the disarm before on_step: a due kill never returns, and
        # every other fault at that boundary lands first.
        plan = tr.fault.take_sdc(tr._host_step)
        if plan is not None:
            tr._inject_sdc(plan)
        tr.fault.disarm_device(tr._host_step)
        tr.fault.on_step(tr._host_step)


class HeartbeatHook(StepHook):
    """Per-rank liveness beats (`tpu_dp_torch.obs.health.HeartbeatWriter`):
    boundary-to-boundary wall time per step since the last accepted beat.
    Without fences (obs=basic) this is a dispatch rate; sustained,
    backpressure makes it track the device rate."""

    def __init__(self, trainer):
        super().__init__(trainer)
        self._t_boundary = time.perf_counter()
        self._steps = 0

    def on_epoch_start(self, epoch: int) -> None:
        self._t_boundary = time.perf_counter()
        self._steps = 0

    def on_step_end(self, ev: StepEvent) -> None:
        tr = self.tr
        if tr.heartbeat is None:
            return
        now = time.perf_counter()
        self._steps += ev.n
        try:
            accepted = tr.heartbeat.beat(
                tr._host_step, (now - self._t_boundary) / self._steps * 1e3)
        except OSError:
            # Best-effort telemetry on a shared filesystem: a failed beat
            # never aborts training. Logged once; the monitor sees the gap
            # as staleness.
            if not tr._hb_write_failed:
                tr._hb_write_failed = True
                tr._log0("heartbeat write failed (suppressing further "
                         "warnings)", exc_info=True)
            accepted = False
        if accepted:
            self._t_boundary, self._steps = now, 0


class ProfilerHook(StepHook):
    """Step-ranged profiling (``train.profile_steps=START:END``)."""

    def on_window_start(self, first_step: int, n: int) -> None:
        # BEFORE dispatch: the window about to run is steps [first_step,
        # first_step + n); arming at the post-window boundary would trace
        # the window after the requested range.
        if self.tr._step_profiler is not None:
            self.tr._step_profiler.on_window_start(first_step, n)

    def on_step_end(self, ev: StepEvent) -> None:
        if self.tr._step_profiler is not None:
            self.tr._step_profiler.on_step(self.tr._host_step)


class CommProfilerHook(StepHook):
    """In-run comm/compute attribution windows (`tpu_dp_torch.obs.
    commprof`, ``obs.comm_profile_steps``). Same arm-before-dispatch
    discipline as `ProfilerHook`; the stop path additionally parses the
    captured trace and publishes the comm gauges (parse failures log and
    never raise into the hot loop)."""

    def on_window_start(self, first_step: int, n: int) -> None:
        if self.tr._comm_profiler is not None:
            self.tr._comm_profiler.on_window_start(first_step, n)

    def on_step_end(self, ev: StepEvent) -> None:
        if self.tr._comm_profiler is not None:
            self.tr._comm_profiler.on_step(self.tr._host_step)

    def close(self) -> None:
        if self.tr._comm_profiler is not None:
            self.tr._comm_profiler.close()


class FlightRecorderHook(StepHook):
    """The black box's feed (`tpu_dp_torch.obs.flightrec`): one ``step``
    event per window boundary (no device fetch: the window's wall time,
    the rollback generation and the efficiency gauges the trainer already
    computed), the hang-dump sentinel polled, and one ``snapshot`` event
    per commit. Decisions (preemption, write errors, injected storage
    faults) are recorded where they are made."""

    def __init__(self, trainer):
        super().__init__(trainer)
        self._t_boundary = time.perf_counter()

    def on_epoch_start(self, epoch: int) -> None:
        self._t_boundary = time.perf_counter()
        _flightrec.record("epoch_start", step=self.tr._host_step,
                          epoch=epoch)

    def on_step_end(self, ev: StepEvent) -> None:
        tr = self.tr
        now = time.perf_counter()
        fields = {"epoch": ev.epoch, "n": ev.n,
                  "window_ms": round((now - self._t_boundary) * 1e3, 3)}
        self._t_boundary = now
        if tr._rollback_gen:
            fields["gen"] = tr._rollback_gen
        eff = tr._last_efficiency
        if eff:
            fields.update({k: eff[k] for k in ("mfu", "goodput")
                           if k in eff})
        _flightrec.record("step", step=tr._host_step, **fields)
        path = _flightrec.recorder.poll_dump_request()
        if path is not None:
            self.tr._log0("flight recorder: hang-dump request honored -> %s",
                          path)

    def on_snapshot(self, epoch: int, done: int, step: int,
                    meta: dict[str, Any]) -> None:
        _flightrec.record("snapshot", step=step, epoch=epoch, done=done,
                          snapshot_kind=meta.get("kind", "snapshot"))


class BoundaryHook(StepHook):
    """The elastic / preemption boundary — always last. Elastic on
    (``resilience.elastic``): a SIGTERM means "this rank leaves, the job
    goes on", agreed through the membership ledger at a common stop step:
    the boundary runs the detection and the quiesce and raises
    `_RegroupSignal` (a survivor) or `PreemptedError` (the leaver)
    (`Trainer._elastic_boundary`). Elastic off: a pending signal runs the
    snapshot-and-exit-143 contract (`Trainer._preempt_exit`), each rank
    reading its own flag, as in the JAX package."""

    def on_step_end(self, ev: StepEvent) -> None:
        tr = self.tr
        if tr.elastic is not None:
            tr._elastic_boundary(ev.epoch, ev.done)
        elif tr.preempt is not None and tr.preempt.requested:
            tr._preempt_exit(ev.epoch, ev.done)


class GuardHook(StepHook):
    """Training guardrails (`tpu_dp_torch.resilience.guard`; the JAX
    package's `GuardHook`).

    - Before a window (`guard_in`): the sentinel's input, the armed device
      loss cap (spike skip), the LR ease after a rollback and the
      ``nan:``/``spike:`` fault seam.
    - After it (`on_step_end`): ONE fetch of the window's ``loss_raw``,
      ``grad_norm`` and ``applied`` (the guard's fence), the host's update
      counter settled to the device's, the policy fed, the quarantine
      records written (rank 0) and the escalation: `Trainer._GuardRollback`
      or `DivergedError`; the cross-replica SDC audit on its cadence. On
      an SDC finding under ``sdc_action=halt`` every save newer than the
      last clean audit is quarantine-marked and the run halts.

    Every rank computes the same decision from the same values (the
    sentinel's are equal on every rank), with no coordination beyond the
    audit's all-gather. Rank 0 writes the ``guard_quarantine``,
    ``guard_spike`` and ``guard_sdc`` events into ``metrics.jsonl``.

    Under ``resilience.elastic`` (the JAX package's elastic branches):
    while a quiesce converges the guard does not rewind (the trigger is
    recorded; a rewind would take this rank's step clock off the plan's);
    an audit whose gather fails defers to the membership protocol (a
    departed peer is not an audit finding); and an SDC finding evicts the
    suspect through the ledger: the suspect sets the trainer's
    ``_guard_evict`` and leaves with rollback flavour at this boundary's
    `BoundaryHook`, the others publish it as a suspect (`mark_suspect`),
    and rank 0 quarantine-marks every save since the last clean audit, so
    the survivors resume from one that predates the corruption.
    `on_regroup` re-baselines the audit on the new world.
    """

    def __init__(self, trainer):
        super().__init__(trainer)
        from tpu_dp_torch.resilience.guard import GuardPolicy, QuarantineLog

        cfg = trainer.cfg.guard  # checked by `config.check_guard`
        self.policy = GuardPolicy(
            action=cfg.action, spike_window=cfg.spike_window,
            spike_z=cfg.spike_z, spike_min_steps=cfg.spike_min_steps,
            device_cap=cfg.device_cap, max_rollbacks=cfg.max_rollbacks)
        self.log = QuarantineLog(trainer.quarantine_path)
        self._leaf_paths = None
        self._sdc_marker = -1      # cadence-crossing marker (audit)
        self._last_clean_audit = 0  # newest step a clean audit covered
        self._ease_from: int | None = None  # LR ease-in anchor step

    # -- pre-dispatch ---------------------------------------------------

    def guard_in(self, first_step: int, n: int) -> dict:
        """The sentinel input for the window [first_step, first_step+n)."""
        from tpu_dp_torch.train.step import default_guard_in

        tr = self.tr
        gi = default_guard_in()
        cap = self.policy.loss_cap()
        if math.isfinite(cap):
            gi["loss_cap"] = np.float32(cap)
        if self._ease_from is not None:
            cfg = tr.cfg.guard
            t = (first_step - self._ease_from) / max(1, cfg.lr_ease_steps)
            if t >= 1.0:
                self._ease_from = None
            else:
                gi["lr_scale"] = np.float32(
                    cfg.lr_ease_start
                    + (1.0 - cfg.lr_ease_start) * max(0.0, t))
        if tr.fault is not None:
            plan = tr.fault.device_fault()
            if plan is not None:
                gi["fault_step"] = int(plan.step)
                gi["fault_scale"] = np.float32(
                    np.nan if plan.kind == "nan" else plan.scale)
        return gi

    # -- rollback bookkeeping ------------------------------------------

    def arm_lr_ease(self, from_step: int) -> None:
        if self.tr.cfg.guard.lr_ease_steps > 0:
            self._ease_from = int(from_step)

    def on_rollback_rewind(self, to_step: int) -> None:
        """Re-arm the audit cadence below the old high-water step (the
        snapshot manager's `rewind` contract): without it the replayed
        steps, exactly those that diverged, would go unaudited."""
        self._sdc_marker = int(to_step)

    def on_regroup(self) -> None:
        """The world changed (an elastic regroup): the audit's baseline is
        the regroup's resume point; the leaf paths are re-read and the
        cadence re-arms there. The policy's statistics survive (the loss
        scale did not change with the world)."""
        self._leaf_paths = None
        self._last_clean_audit = self.tr._host_step
        self._sdc_marker = self.tr._host_step

    # -- post-window ----------------------------------------------------

    def on_step_end(self, ev: StepEvent) -> None:
        tr = self.tr
        first = tr._host_step - ev.n + 1
        # The guard's fence, its host time in ``guard.fence_s`` over
        # ``guard.fences`` (bounded first in an elastic NCCL run).
        t0 = time.perf_counter()
        if tr._peer_fence is not None:
            tr._peer_fence.drain()
        vals = torch.stack([
            torch.cat([m[k].reshape(-1).double() for m in ev.window])
            for k in ("loss_raw", "grad_norm", "applied")], 1).tolist()
        _counters.inc("guard.fence_s", time.perf_counter() - t0)
        _counters.inc("guard.fences")
        records = [{"step": first + k, "loss": v[0], "gnorm": v[1],
                    "applied": int(v[2])} for k, v in enumerate(vals)]
        skipped = sum(1 for r in records if not r["applied"])
        if skipped:
            tr.step_body.settle(tr.state, skipped)
        triggers = self.policy.observe(records)
        escalate = None
        for t in triggers:
            self._record_trigger(ev, t, first)
            if t.action in ("rollback", "halt"):
                escalate = t
        if escalate is not None:
            self._escalate(ev, escalate)
        cfg = tr.cfg.guard
        # The audit pauses only while a finding is in flight (every rank
        # saw the same verdict), never on this rank's quiesce state: a
        # quiescing member keeps stepping to the common stop threshold, so
        # audits stay in lockstep, and gating them on a rank-local state
        # would send ranks to different collectives.
        if cfg.sdc_every_steps > 0 and not tr._sdc_suspect_active:
            prev = self._sdc_marker if self._sdc_marker >= 0 else 0
            if (tr._host_step // cfg.sdc_every_steps
                    > prev // cfg.sdc_every_steps):
                self._sdc_marker = tr._host_step
                self._sdc_audit(ev)

    def _record_trigger(self, ev: StepEvent, t, first: int) -> None:
        tr = self.tr
        _counters.inc(f"guard.{t.kind}")
        _flightrec.record("guard_trigger", step=t.step, trigger=t.kind,
                          action=t.action, reason=t.reason)
        tr._log0("guard: %s (action=%s)", t.reason, t.action)
        if t.kind in ("nonfinite", "cap"):
            _counters.inc("guard.quarantined")
        if tr.ctx.rank != 0:
            return
        if t.kind in ("nonfinite", "cap"):
            # The quarantined batch's sample-id range: the step's slice of
            # the epoch's deterministic shuffle, (step in epoch) x global
            # batch, re-identifiable from (seed, epoch).
            pos = ev.done - ev.n + (t.step - first)
            gbs = tr.global_batch_size
            rec = self.log.quarantine(
                epoch=ev.epoch, step=t.step,
                sample_range=(pos * gbs, (pos + 1) * gbs),
                rank=tr.ctx.rank, reason=t.reason)
            tr._log_metrics({"event": "guard_quarantine", "step": t.step,
                             "reason": t.reason,
                             "sample_range": rec["sample_range"]})
        elif t.kind == "spike":
            self.log.record("spike", step=t.step, field=t.field,
                            value=t.value, z=t.z, action=t.action)
            tr._log_metrics({"event": "guard_spike", "step": t.step,
                             "field": t.field, "value": t.value, "z": t.z,
                             "action": t.action})

    def _escalate(self, ev: StepEvent, t) -> None:
        from tpu_dp_torch.resilience.guard import DivergedError
        from tpu_dp_torch.train.trainer import _GuardRollback

        tr = self.tr
        if t.action == "halt":
            _counters.inc("guard.halts")
            _flightrec.record("guard_halt", step=tr._host_step,
                              reason=t.reason)
            raise DivergedError(f"guard halt: {t.reason}")
        if tr.elastic is not None and tr.elastic.quiescing:
            # A membership transition is converging; a rewind now would
            # take this rank's step clock off the plan's. The trigger is
            # recorded; the post-regroup replay meets anything real again.
            tr._log0("guard: rollback deferred — elastic quiesce in flight")
            return
        raise _GuardRollback(ev.epoch, ev.done, t)

    # -- SDC audit ------------------------------------------------------

    def _sdc_audit(self, ev: StepEvent) -> None:
        from tpu_dp_torch.parallel.dist import cross_rank_gather
        from tpu_dp_torch.resilience.guard import (
            DivergedError,
            digest_of_sums,
            leaf_paths,
            params_checksum,
            sdc_verdict,
        )

        tr = self.tr
        if self._leaf_paths is None:
            self._leaf_paths = leaf_paths(tr.model)
        sums = params_checksum(tr.model)
        try:
            gathered = cross_rank_gather(sums)
        except Exception as e:
            from tpu_dp_torch.parallel.dist import is_peer_failure

            if tr.elastic is None or not is_peer_failure(e):
                raise
            # A peer died between the boundary and the gather (an evicted
            # rank's exit racing the audit): no audit finding. The
            # membership protocol owns dead peers (the next collective
            # fails into it): this audit is skipped; the regroup
            # re-baselines.
            tr._log0("guard: SDC audit all-gather failed (%s) — peer "
                     "likely departed; deferring to the membership "
                     "protocol", e)
            return
        verdict = sdc_verdict(gathered, self._leaf_paths)
        _counters.inc("guard.sdc_audits")
        if verdict["consistent"]:
            self._last_clean_audit = tr._host_step
            return
        _counters.inc("guard.sdc_mismatches")
        _flightrec.record("guard_sdc", step=tr._host_step,
                          suspects=list(verdict["suspects"]),
                          majority=verdict["majority"])
        detail = {
            "step": tr._host_step,
            "suspects": verdict["suspects"],
            "majority": verdict["majority"],
            "leaves": {str(r): v[:8] for r, v in verdict["leaves"].items()},
            "last_clean_step": self._last_clean_audit,
            "digest": digest_of_sums(sums)[:16],
        }
        tr._log0("guard: SDC audit MISMATCH at step %d — suspect rank(s) %s "
                 "(divergent leaves: %s); params disagree bitwise across "
                 "the data axis", tr._host_step, verdict["suspects"],
                 detail["leaves"])
        acting = tr.elastic is not None or tr.cfg.guard.sdc_action == "halt"
        me = tr.ctx.rank
        if me == 0:
            self.log.record("sdc", **detail)
            tr._log_metrics({"event": "guard_sdc", **detail})
            if acting:
                # Every save since the last clean audit may carry the
                # corruption: no rollback or resume may trust one. The
                # writes in flight are joined first, so none lands after
                # the marking. (warn records only.)
                tr._join_writes()
                tr._quarantine_saves_after(
                    self._last_clean_audit,
                    reason=f"sdc mismatch at step {tr._host_step} "
                           f"(suspects {verdict['suspects']})")
        if not acting:
            return
        tr._sdc_suspect_active = True
        if tr.elastic is not None:
            # Evict the corrupt replica through the membership ledger: the
            # suspect (which sees the same verdict) leaves with rollback
            # flavour, the others accuse it so the record names why; the
            # `BoundaryHook` later in this sweep runs the transition.
            if me in verdict["suspects"] or verdict["majority"] is None:
                tr._guard_evict = True
                _flightrec.record("guard_evict", step=tr._host_step,
                                  rank=me, reason="sdc audit suspect")
                tr._log0("guard: this rank is the SDC suspect — leaving "
                         "the membership (rollback regroup)")
            else:
                for r in verdict["suspects"]:
                    tr.elastic.mark_suspect(
                        r, f"sdc audit mismatch at step {tr._host_step}")
            return
        _counters.inc("guard.halts")
        raise DivergedError(
            f"SDC audit mismatch at step {tr._host_step}: suspect rank(s) "
            f"{verdict['suspects']} hold bitwise-divergent params "
            f"(divergent leaves: {detail['leaves']}); halting before the "
            f"corruption reaches another snapshot")

    def close(self) -> None:
        self.log.close()
