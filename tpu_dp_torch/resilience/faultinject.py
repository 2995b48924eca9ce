"""Deterministic fault injection for resilience testing (port of
`tpu_dp.resilience.faultinject`: the same grammar, plans, firing order and
exit code; the port never imports the JAX package).

The port runs the step-boundary kinds ``kill``, ``preempt``, ``delay``,
``leave`` (it sets `FaultInjector.leave_requested`, which an elastic
trainer polls: a graceful departure without a signal) and ``relaunch``
(it departs exactly like ``leave``; `tpu_dp_torch.train.trainer.
run_elastic` then rejoins the run in the same process), the storage kinds
``ioerr``, ``enospc``, ``torn``, ``bitrot`` and ``slowfs`` (latency on
every membership-ledger read), and the guard's kinds (`GUARD_KINDS`):
``nan`` and ``spike`` through the sentinel step's seam (`device_fault`,
`disarm_device`; they need ``guard.enabled``, refused otherwise with the
JAX package's message) and ``sdc``, a bit flip in this rank's parameters
(`take_sdc`; the Trainer's ``_inject_sdc``). `refuse_unported` turns away
``drop`` before a run starts, since a fault that silently never fires is
the worst property an injector can have: its one consumer is the JAX
package's retrying host ring, which the port does not carry (its
collectives go through `torch.distributed`).

The JAX package's text follows.

Real preemptions and host deaths are non-deterministic; proving the
snapshot/resume path correct needs the opposite — a fault that fires at
exactly the same optimizer step on exactly the same rank every run, so a
killed run and its resumed continuation can be compared bitwise against an
uninterrupted one (`tests/test_resilience.py`). The injector is consulted
by the `Trainer` at step boundaries and by `ResilientRing` before each
collective; in production it is simply never constructed.

Spec grammar (``resilience.fault`` config field or ``TPU_DP_FAULT`` env,
the latter so spawned worker processes inherit the plan)::

    kill:step=13             # os._exit(137) at the first step boundary >= 13
    kill:step=13,rank=1      # only on process 1 (default: every rank)
    preempt:step=9           # deliver SIGTERM to self (exercises the hook)
    preempt:rank=2,step=9    # SIGTERM only on process 2 — the elastic
                             # single-rank eviction (survivors regroup)
    leave:step=9,rank=2      # signal-free preempt twin: sets the injector's
                             # `leave_requested` flag the elastic trainer
                             # polls — same regroup path, usable where a
                             # real SIGTERM can't be (in-process pytest,
                             # non-main threads)
    relaunch:step=9,rank=2   # deterministic in-process twin of "the
                             # preempted rank comes back": departs exactly
                             # like leave:, then `train.trainer.run_elastic`
                             # catches the PreemptedError and rejoins the
                             # run through the membership ledger
                             # (resilience.elastic_join) in the same OS
                             # process — world N → N-1 → N with no external
                             # supervisor
    delay:step=5,ms=250      # sleep 250ms once (straggler simulation)
    drop:step=7              # arm a one-shot collective drop (ring retry path)
    nan:step=4               # guardrail faults (require guard.enabled —
    nan:step=4,rank=1        # the injection seam is compiled into the
    spike:step=4,scale=1e4   # sentinel step): at optimizer step K the loss
    sdc:step=4,rank=2        # and gradients are multiplied by NaN (nan:)
    sdc:step=4,rank=2,leaf=conv1/* # or by a large finite scale (spike:)
                             # INSIDE the device program; sdc: flips the
                             # top exponent bit of the params leaves
                             # matching the ``leaf=`` glob (default: the
                             # first leaf) on the target rank's local
                             # replica AFTER the step boundary — the
                             # silent-data-corruption twin the
                             # cross-replica audit must catch.
    ioerr:step=6             # storage faults (tpu_dp/chaos/storage.py):
    ioerr:step=6,n=2         # armed at the step boundary, applied at the
    enospc:step=6            # checkpoint/snapshot/ledger IO seams. ioerr
    torn:step=6              # fails the next n (default 1) writes with a
    bitrot:step=6            # transient EIO; enospc fails EVERY later
    slowfs:step=6,ms=100     # write with ENOSPC; torn truncates the next
                             # committed save's payload AFTER its sibling
                             # meta rename (defeating per-file atomicity);
                             # bitrot flips bytes inside the next committed
                             # payload (the checksum manifest must catch
                             # it); slowfs adds ms of latency to every
                             # ledger read (n= bounds how many).

**Composed schedules**: a spec may hold several ``;``-separated clauses —
``"bitrot:step=4;spike:step=8,scale=1e6"`` — each clause keeping the
single-fault grammar above and arming/spending independently (one
:class:`FaultInjector` holds them all). Clauses due at the same boundary
fire in spec order, except ``kill`` always fires last (it never returns,
and the other faults at that boundary must land first).

With multi-step windows the host observes step counts only at window
boundaries, so "at step K" means the first boundary where the global step
reached K — deterministic for a fixed window size. The device-seam faults
(``nan:``/``spike:``) fire at ``state.step == K`` inside the program and
are disarmed at the first boundary past K; because a skipped (quarantined)
update freezes the device step counter, a window that packs several steps
past K would poison them all — pin ``train.steps_per_call=1`` for
single-step determinism (the guard test suite does). The full grammar is
documented once, in docs/RESILIENCE.md "Fault-injection spec".
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import time
from typing import Sequence

logger = logging.getLogger(__name__)

#: kinds applied through the storage-fault shim (`tpu_dp.chaos.storage`)
#: at the checkpoint/snapshot/ledger IO seams rather than at the step
#: boundary itself: `on_step` ARMS them (one-shot, rank-gated like every
#: other plan); the shim applies them when the next matching IO happens.
STORAGE_KINDS = ("ioerr", "torn", "bitrot", "slowfs", "enospc")
_KINDS = ("kill", "preempt", "delay", "drop", "leave", "relaunch",
          "nan", "spike", "sdc") + STORAGE_KINDS
#: kinds the Trainer handles through the guardrail layer rather than
#: `on_step`: nan/spike ride the sentinel's compiled injection seam
#: (`train/step._inject_guard_fault`), sdc mutates the host-side params.
GUARD_KINDS = ("nan", "spike", "sdc")
#: exit code for an injected hard kill — SIGKILL's 128+9, the signature of
#: a host OOM-killer / preemption-without-grace death.
KILL_EXIT_CODE = 137


#: kinds the port refuses, each with the reason it has no seam to fire.
UNPORTED_KINDS = {
    "drop": "its one consumer is the JAX package's retrying host ring "
            "(ResilientRing), which the JAX trainer never builds and the "
            "port does not carry: the port's collectives go through "
            "torch.distributed (ROADMAP: the host ring is not to be "
            "ported)",
}


def refuse_unported(kinds: Sequence[str], guard_enabled: bool = False
                    ) -> None:
    """Raise for a fault kind the run cannot fire: ``nan``/``spike``
    without ``guard_enabled``, with the JAX package's message (their seam
    is the sentinel step), and the `UNPORTED_KINDS` with their reason."""
    seam = [k for k in kinds if k in ("nan", "spike")]
    if seam and not guard_enabled:
        raise ValueError(
            f"TPU_DP_FAULT {seam[0]!r} requires guard.enabled=true "
            f"(the injection seam lives in the sentinel-enabled step "
            f"program)")
    for kind in kinds:
        if kind in UNPORTED_KINDS:
            raise ValueError(
                f"TPU_DP_FAULT {kind!r} never fires in tpu_dp_torch: "
                f"{UNPORTED_KINDS[kind]}")


def storage_shim():
    """The chaos storage shim, IFF the chaos package was ever armed.

    THE accessor for every production IO seam (checkpoint writes, ledger
    IO): one definition, so a change to the arming protocol cannot leave
    one seam silently un-shimmed — a fault that silently never fires is
    the worst possible outcome. ``sys.modules`` only: a process that
    never injected a storage fault never imports `tpu_dp.chaos` at all,
    and the per-call cost is one dict lookup.
    """
    import sys

    mod = sys.modules.get("tpu_dp_torch.chaos.storage")
    if mod is not None and mod.shim.active:
        return mod.shim
    return None


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    kind: str          # one of _KINDS
    step: int          # global optimizer step the fault fires at (>=)
    rank: int = -1     # -1: every rank
    delay_ms: float = 0.0  # delay: sleep; slowfs: per-ledger-read latency
    scale: float = 0.0  # spike: multiplier applied to loss/grads
    leaf: str = ""      # sdc: glob over params leaf paths ("" = first leaf)
    count: int = 0      # ioerr: writes to fail (default 1); slowfs: reads
                        # to slow (default 0 = unbounded)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan | None":
        """Parse one ``kind:key=val,key=val`` clause; empty spec → None."""
        spec = (spec or "").strip()
        if not spec:
            return None
        kind, _, rest = spec.partition(":")
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in {spec!r}; "
                f"expected one of {_KINDS}"
            )
        fields: dict[str, float] = {}
        leaf = ""
        for item in filter(None, rest.split(",")):
            key, eq, val = item.partition("=")
            if not eq or key not in ("step", "rank", "ms", "scale", "leaf",
                                     "n"):
                raise ValueError(f"bad fault field {item!r} in {spec!r}")
            if key == "leaf":
                leaf = val
            else:
                fields[key] = float(val)
        if "step" not in fields:
            raise ValueError(f"fault spec {spec!r} needs step=<n>")
        if kind == "spike" and "scale" not in fields:
            raise ValueError(f"fault spec {spec!r} needs scale=<s>")
        return cls(
            kind=kind,
            step=int(fields["step"]),
            rank=int(fields.get("rank", -1)),
            delay_ms=float(fields.get("ms", 0.0)),
            scale=float(fields.get("scale", 0.0)),
            leaf=leaf,
            count=int(fields.get("n", 1 if kind == "ioerr" else 0)),
        )

    @classmethod
    def parse_schedule(cls, spec: str) -> "list[FaultPlan]":
        """Parse a ``;``-separated multi-fault schedule into its plans.

        Empty/whitespace clauses are dropped, so trailing ``;`` and the
        single-clause grammar both parse; an empty schedule is ``[]``.
        """
        out = []
        for clause in (spec or "").split(";"):
            plan = cls.parse(clause)
            if plan is not None:
                out.append(plan)
        return out

    def to_spec(self) -> str:
        """The clause string this plan round-trips through ``parse``."""
        parts = [f"step={self.step}"]
        if self.rank >= 0:
            parts.append(f"rank={self.rank}")
        if self.delay_ms:
            parts.append(f"ms={self.delay_ms:g}")
        if self.scale:
            parts.append(f"scale={self.scale:g}")
        if self.leaf:
            parts.append(f"leaf={self.leaf}")
        if self.count and not (self.kind == "ioerr" and self.count == 1):
            parts.append(f"n={self.count}")
        return f"{self.kind}:{','.join(parts)}"


class FaultInjector:
    """Fires each of a schedule's :class:`FaultPlan`\\ s exactly once.

    Holds ONE plan (the classic single-fault spec) or a composed
    ``;``-schedule of them; every plan arms and spends independently, so
    a chaos trial can compose e.g. a ``bitrot:`` against the snapshot a
    later ``spike:`` rollback will want to restore.
    """

    def __init__(self, plans: "FaultPlan | Sequence[FaultPlan]",
                 rank: int = 0):
        if isinstance(plans, FaultPlan):
            plans = [plans]
        self.plans: list[FaultPlan] = list(plans)
        if not self.plans:
            raise ValueError("FaultInjector needs at least one FaultPlan")
        self.rank = int(rank)
        self._fired = [False] * len(self.plans)
        #: set by a fired ``leave`` plan; the elastic trainer polls it as a
        #: graceful departure request (the signal-free twin of SIGTERM).
        self.leave_requested = False

    @property
    def plan(self) -> FaultPlan:
        """The single-plan accessor (first clause of a composed schedule);
        multi-plan callers iterate ``plans``/use the kind helpers below."""
        return self.plans[0]

    @property
    def fired(self) -> bool:
        """True once EVERY plan has fired/been spent."""
        return all(self._fired)

    def fired_kind(self, kind: str) -> bool:
        """True when any plan of ``kind`` has fired."""
        return any(f and p.kind == kind
                   for p, f in zip(self.plans, self._fired))

    def has_kind(self, kind: str) -> bool:
        return any(p.kind == kind for p in self.plans)

    def kinds(self) -> tuple[str, ...]:
        return tuple(p.kind for p in self.plans)

    def spend(self, kind: str) -> None:
        """Mark every plan of ``kind`` fired (a relaunch consumed by
        `tpu_dp_torch.train.trainer.run_elastic` before the rejoined
        incarnation)."""
        for i, p in enumerate(self.plans):
            if p.kind == kind:
                self._fired[i] = True

    @classmethod
    def from_spec(cls, spec: str, rank: int = 0) -> "FaultInjector | None":
        """Injector from a (possibly ``;``-composed) spec string, falling
        back to the TPU_DP_FAULT env so spawned workers inherit the plan."""
        spec = spec or os.environ.get("TPU_DP_FAULT", "")
        plans = FaultPlan.parse_schedule(spec)
        if not plans:
            return None
        return cls(plans, rank=rank)

    def _due(self, i: int, global_step: int) -> bool:
        if self._fired[i]:
            return False
        plan = self.plans[i]
        if plan.rank >= 0 and plan.rank != self.rank:
            return False
        return global_step >= plan.step

    def on_step(self, global_step: int) -> None:
        """Trainer hook: fire every plan whose step boundary was reached.

        ``kill`` never returns (`os._exit` — no atexit, no flushes, the
        honest simulation of a yanked host), so among plans due at the
        same boundary it fires LAST: the other faults (a storage arm, a
        drop, a leave request) must land first or a composed schedule
        silently loses them. The other kinds return after their side
        effect.
        """
        due = [i for i in range(len(self.plans))
               if self.plans[i].kind not in GUARD_KINDS
               and self._due(i, global_step)]
        due.sort(key=lambda i: self.plans[i].kind == "kill")
        for i in due:
            self._fired[i] = True
            self._fire(self.plans[i], global_step)

    def _fire(self, plan: FaultPlan, global_step: int) -> None:
        if plan.kind in STORAGE_KINDS:
            # Armed here, applied by the shim at the next matching
            # checkpoint/snapshot/ledger IO (tpu_dp/chaos/storage.py).
            logger.warning(
                "fault injection: arming storage fault %s on rank %d at "
                "step %d", plan.kind, self.rank, global_step,
            )
            from tpu_dp_torch.chaos.storage import shim

            shim.arm(plan)
        elif plan.kind == "kill":
            logger.warning(
                "fault injection: killing rank %d at step %d (exit %d)",
                self.rank, global_step, KILL_EXIT_CODE,
            )
            os._exit(KILL_EXIT_CODE)
        elif plan.kind == "preempt":
            logger.warning(
                "fault injection: SIGTERM to self (rank %d) at step %d",
                self.rank, global_step,
            )
            os.kill(os.getpid(), signal.SIGTERM)
        elif plan.kind == "delay":
            logger.warning(
                "fault injection: delaying rank %d for %.0fms at step %d",
                self.rank, plan.delay_ms, global_step,
            )
            time.sleep(plan.delay_ms / 1000.0)
        elif plan.kind in ("leave", "relaunch"):
            # relaunch departs exactly like leave; the "comes back" half is
            # `train.trainer.run_elastic`, which keys off the fired plan's
            # kind after the departure's PreemptedError.
            logger.warning(
                "fault injection: elastic %s request on rank %d at "
                "step %d", plan.kind, self.rank, global_step,
            )
            self.leave_requested = True

    # -- guardrail faults ------------------------------------------------

    def device_fault(self) -> "FaultPlan | None":
        """The armed ``nan:``/``spike:`` plan for this rank, or None.

        The Trainer folds it into the sentinel's guard input (the seam
        fires at ``step_t == plan.step`` on the device) and disarms it
        through `disarm_device` at the first boundary past it. The seam
        carries one fault, so composed schedules get at most one device
        plan armed at a time (earliest-step first)."""
        armed = [self.plans[i] for i in range(len(self.plans))
                 if not self._fired[i]
                 and self.plans[i].kind in ("nan", "spike")
                 and (self.plans[i].rank < 0
                      or self.plans[i].rank == self.rank)]
        if not armed:
            return None
        return min(armed, key=lambda p: p.step)

    def disarm_device(self, global_step: int) -> None:
        """One-shot the device seam: past the fault step, stop arming it
        (the sentinel's frozen step counter cannot disarm itself).

        Strictly past: the device fires while ``step_t == K``, which is
        the window whose END boundary is host step K+1; disarming at
        ``>= K`` would strip the seam from the very window that fires it.
        Until then every update of a window that reaches K with the
        counter frozen there (each one quarantined) fires again, as in the
        JAX package."""
        for i, p in enumerate(self.plans):
            if p.kind in ("nan", "spike") and global_step > p.step:
                self._fired[i] = True

    def take_sdc(self, global_step: int) -> "FaultPlan | None":
        """Consume a due ``sdc:`` plan (the Trainer flips the bit)."""
        for i, p in enumerate(self.plans):
            if p.kind == "sdc" and self._due(i, global_step):
                self._fired[i] = True
                return p
        return None
