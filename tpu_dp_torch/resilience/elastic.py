"""Elastic world size, the shrink (port of the shrink half of
`tpu_dp.resilience.elastic`): when a rank announces its departure, or
vanishes without a word, the members agree the transition through a
**shared-filesystem membership ledger**, and the survivors tear down the
process group and form a new one at world N-1 with dense new ranks
(`tpu_dp_torch.parallel.dist.elastic_initialize`), reload the agreed state
through the resharding checkpoint path and re-split the rest of the epoch
over themselves (`tpu_dp_torch.data.sampler.elastic_resplit`: every
remaining sample of the interrupted epoch visited exactly once).

Two flavours, as in the JAX package. *Graceful*: a leaver checks in, every
member steps to the agreed stop step, rank 0 commits the final snapshot
there and the leaver exits 143. *Rollback*: a member died (its peers'
collectives failed, or a heartbeat went stale and rank 0 published it as
a suspect, `mark_suspect`) or the SDC audit condemned it; the live members
check in with rollback flavour, the acting leader declares every member
that did not check in within ``regroup_timeout_s`` departed (the suspect's
reason, or "no quiesce check-in (timeout)"), and the survivors resume from
the newest complete save and replay the steps since it.

The files, their names and their JSON keys are the JAX package's, so
either package reads a ledger the other wrote. Ported here: the records
(`MembershipRecord`, `QuiescePlan`), the ledger IO under the IO retry
budget, `MembershipLedger`'s quiesce protocol with suspects, and
`ElasticCoordinator`'s shrink. Left out (ROADMAP Queue 1 item 9d-iii): the
grow/join half (join requests, fencing, ``establish_fallback``) and
``ServeMembership``.

Membership ledger layout (``<membership_dir>/<generation>/``)::

    epoch_0000.json      # membership record: epoch, members, coordinator,
                         # departed, resume {steps_done, lineage, ...}
    q_e0001_r00002.json  # quiesce check-in of stable rank 2 for the
                         # transition to epoch 1: step reached, leaving?
    plan_e0001.json      # the agreed transition plan (single writer,
                         # exclusive-create: flavor, stop_step, survivors)
    q_e0001_r00002.done  # post-quiesce ack (final snapshot committed)
    suspect_e0001_r00002.json  # "sid 2 looks dead" (any member may write)
    left_r00002.json     # graceful-departure confirmation

A **generation** is one launch of the job; membership epochs count
regroups within it. A rank's **stable id (sid)** is its rank at the
generation's start: dense ranks are reassigned every epoch, sids never.

Why a filesystem ledger and not collectives: the coordination spans the
gap between two process groups, when no group exists at all. It needs
only the shared filesystem the checkpoints already require; every write
is atomic (tmp + rename, or an exclusive link), and every decision is
either derived from one complete file set or published by a single
writer, so the ranks cannot disagree.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket
import time
from pathlib import Path
from typing import Sequence

from tpu_dp_torch.obs.counters import counters as _counters
from tpu_dp_torch.resilience.faultinject import storage_shim as _storage_shim

logger = logging.getLogger(__name__)

#: membership record / ledger file schema version.
MEMBERSHIP_SCHEMA = 1


class ElasticError(RuntimeError):
    """A regroup could not complete (quorum lost, timeout, bad ledger)."""


@dataclasses.dataclass(frozen=True)
class MembershipRecord:
    """One membership epoch: who is in the job and where it resumes."""

    epoch: int
    members: tuple[int, ...]          # stable ids, sorted
    coordinator: str | None           # host:port; None for world 1
    departed: tuple[dict, ...] = ()   # [{"sid": s, "reason": r}, ...]
    resume: dict | None = None        # {"epoch", "steps_done", "lineage",
                                      #  "global_step", "snapshot_dir"}
    reason: str = "initial"
    ts: float = 0.0
    #: admissions this epoch granted (the grow half; always empty here).
    joined: tuple[dict, ...] = ()
    #: which member hosts the rendezvous; None means dense rank 0.
    service_sid: int | None = None

    @property
    def world(self) -> int:
        return len(self.members)

    def rank_of(self, sid: int) -> int:
        """Dense rank of ``sid`` in this epoch (sorted-sid order)."""
        try:
            return self.members.index(sid)
        except ValueError:
            raise ElasticError(
                f"stable rank {sid} is not a member of epoch {self.epoch} "
                f"(members: {list(self.members)})") from None

    def to_json(self) -> dict:
        return {
            "schema": MEMBERSHIP_SCHEMA,
            "epoch": self.epoch,
            "members": list(self.members),
            "world": self.world,
            "coordinator": self.coordinator,
            "departed": list(self.departed),
            "joined": list(self.joined),
            "service_sid": self.service_sid,
            "resume": self.resume,
            "reason": self.reason,
            "ts": self.ts,
        }

    @classmethod
    def from_json(cls, d: dict) -> "MembershipRecord":
        if d.get("schema") != MEMBERSHIP_SCHEMA:
            raise ElasticError(f"membership record schema "
                               f"{d.get('schema')!r} != {MEMBERSHIP_SCHEMA}")
        svc = d.get("service_sid")
        return cls(
            epoch=int(d["epoch"]),
            members=tuple(int(m) for m in d["members"]),
            coordinator=d.get("coordinator"),
            departed=tuple(d.get("departed") or ()),
            joined=tuple(d.get("joined") or ()),
            service_sid=None if svc is None else int(svc),
            resume=d.get("resume"),
            reason=str(d.get("reason", "")),
            ts=float(d.get("ts", 0.0)),
        )


@dataclasses.dataclass(frozen=True)
class QuiescePlan:
    """The agreed transition out of the current membership epoch.

    ``stop_step`` is a *threshold* on the global step, not a position:
    every member keeps stepping and quiesces at its first window boundary
    with ``host_step >= stop_step``. Because all members dispatch the same
    boundary sequence, that boundary is the same global position on every
    rank. The publisher chooses ``max(check-in steps) + 2×max(window) +
    1``, which no member can have passed before its next plan poll.
    """

    epoch: int                    # the NEW epoch being formed
    flavor: str                   # "graceful" | "rollback" | "grow"
    stop_step: int                # global-step threshold (see above)
    train_epoch: int              # dataset epoch being interrupted
    leavers: tuple[int, ...]      # sids departing gracefully
    departed: tuple[dict, ...]    # sids that vanished ({"sid","reason"})
    survivors: tuple[int, ...]    # sids forming the new epoch
    joiners: tuple[int, ...] = ()  # admitted outsiders (the grow half)

    @property
    def incumbents(self) -> tuple[int, ...]:
        """Survivors that were already members."""
        return tuple(s for s in self.survivors if s not in self.joiners)

    def to_json(self) -> dict:
        return {
            "schema": MEMBERSHIP_SCHEMA,
            "epoch": self.epoch,
            "flavor": self.flavor,
            "stop_step": self.stop_step,
            "train_epoch": self.train_epoch,
            "leavers": list(self.leavers),
            "departed": list(self.departed),
            "survivors": list(self.survivors),
            "joiners": list(self.joiners),
        }

    @classmethod
    def from_json(cls, d: dict) -> "QuiescePlan":
        return cls(
            epoch=int(d["epoch"]), flavor=str(d["flavor"]),
            stop_step=int(d["stop_step"]),
            train_epoch=int(d.get("train_epoch", 0)),
            leavers=tuple(int(x) for x in d["leavers"]),
            departed=tuple(d["departed"]),
            survivors=tuple(int(x) for x in d["survivors"]),
            joiners=tuple(int(x) for x in d.get("joiners") or ()),
        )


#: Every ledger filesystem touch runs under a bounded, jittered retry
#: derived from the IO budget ``resilience.io_retry_s`` (`tpu_dp_torch.
#: resilience.retry.io_retry_params`); attempts, retries and exhaustions
#: land in the ``retry.*`` counters. Exhausted WRITES raise `ElasticError`
#: (a lost publish would stall the protocol until its timeout); exhausted
#: READS degrade to "not readable yet" (None), since every read sits in a
#: poll loop already bounded by ``regroup_timeout_s``. The two module
#: globals below are test-only overrides (None: the configured budget).
_IO_RETRIES: int | None = None
_IO_BASE_DELAY_S: float | None = None
_IO_JITTER = 0.5


def _io_params() -> tuple[int, float]:
    from tpu_dp_torch.resilience.retry import io_retry_params

    retries, base = io_retry_params()
    if _IO_RETRIES is not None:
        retries = _IO_RETRIES
    if _IO_BASE_DELAY_S is not None:
        base = _IO_BASE_DELAY_S
    return retries, base


def _ledger_io(fn, describe: str):
    """Run one ledger filesystem operation under the retry policy.

    `FileNotFoundError` is an answer (the record is not written yet: the
    protocol polls) and propagates at once; every other OSError is retried
    with jittered backoff and, once exhausted, raised as `ElasticError`.
    """
    from tpu_dp_torch.resilience.retry import retry_call

    retries, base_delay = _io_params()

    def attempt():
        try:
            return fn()
        except FileNotFoundError:
            raise
        except OSError as e:
            raise _RetryableLedgerIO(str(e)) from e

    try:
        return retry_call(attempt, retries=retries, base_delay=base_delay,
                          jitter=_IO_JITTER, retry_on=(_RetryableLedgerIO,),
                          describe=f"membership-ledger {describe}")
    except _RetryableLedgerIO as e:
        raise ElasticError(
            f"membership-ledger {describe} failed after {retries + 1} "
            f"attempts: {e.__cause__}") from e.__cause__


class _RetryableLedgerIO(OSError):
    """An OSError the ledger's retry policy may re-attempt (every one but
    FileNotFoundError, which is protocol state)."""


def _atomic_write_json(path: Path, payload: dict) -> None:
    text = json.dumps(payload, indent=2, default=str)

    def write():
        shim = _storage_shim()
        if shim is not None:
            shim.on_write(path)
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        tmp.write_text(text)
        os.replace(tmp, path)

    _ledger_io(write, f"write {path.name}")


def _exclusive_write_json(path: Path, payload: dict) -> bool:
    """First-writer-wins publish; True when THIS call created the file.
    `os.link` of a private tmp onto the target is an atomic create: a
    losing writer gets EEXIST and adopts the canonical file (an answer,
    never retried)."""
    text = json.dumps(payload, indent=2, default=str)

    def write():
        shim = _storage_shim()
        if shim is not None:
            shim.on_write(path)
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        tmp.write_text(text)
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    return _ledger_io(write, f"claim {path.name}")


def _read_json(path: Path) -> dict | None:
    """Parse ``path``; None when absent, torn, or unreadable past the retry
    budget (the caller's poll loop reads again). The storage shim's read
    seam (``slowfs``) is ROADMAP Queue 1 item 9d-iii's."""

    def read():
        try:
            text = path.read_text()
        except FileNotFoundError:
            return None
        try:
            return json.loads(text)
        except ValueError:
            return None  # a torn write in flight; the next poll re-reads

    try:
        return _ledger_io(read, f"read {path.name}")
    except ElasticError:
        logger.warning("membership-ledger read of %s still failing past the "
                       "retry budget; treating as not-yet-readable",
                       path.name, exc_info=True)
        return None


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port on ``host`` (a regroup's rendezvous)."""
    with socket.socket() as s:
        s.bind((host if host else "", 0))
        return int(s.getsockname()[1])


class MembershipLedger:
    """The shared-filesystem half of the protocol: no torch, no devices.

    Every method is an atomic publish or a bounded poll; `ElasticCoordinator`
    composes them. Free of any process group, so the protocol is testable
    with plain threads against one directory."""

    def __init__(self, gen_dir: str | os.PathLike, sid: int):
        self.dir = Path(gen_dir)
        self.sid = int(sid)
        self.dir.mkdir(parents=True, exist_ok=True)

    # -- membership records --------------------------------------------

    def _epoch_path(self, epoch: int) -> Path:
        return self.dir / f"epoch_{int(epoch):04d}.json"

    def write_initial(self, members: Sequence[int],
                      coordinator: str | None) -> MembershipRecord:
        """Publish epoch 0 (the generation's leader; idempotent)."""
        rec = MembershipRecord(
            epoch=0, members=tuple(sorted(int(m) for m in members)),
            coordinator=coordinator, reason="initial", ts=time.time())
        _exclusive_write_json(self._epoch_path(0), rec.to_json())
        return self.current()  # the canonical copy (a racer may have won)

    def current(self) -> MembershipRecord:
        """The newest complete membership record."""
        for path in reversed(sorted(self.dir.glob("epoch_*.json"))):
            d = _read_json(path)
            if d is not None:
                return MembershipRecord.from_json(d)
        raise ElasticError(f"no membership record under {self.dir}")

    def await_epoch(self, epoch: int, timeout_s: float,
                    poll_s: float = 0.05) -> MembershipRecord:
        deadline = time.monotonic() + timeout_s
        while True:
            d = _read_json(self._epoch_path(epoch))
            if d is not None:
                return MembershipRecord.from_json(d)
            if time.monotonic() > deadline:
                raise ElasticError(
                    f"membership epoch {epoch} record did not appear within "
                    f"{timeout_s:.0f}s (sid {self.sid}); the epoch leader "
                    f"may have died mid-regroup")
            time.sleep(poll_s)

    def publish_epoch(self, rec: MembershipRecord) -> MembershipRecord:
        """Single-writer epoch publish (exclusive; losers adopt the
        winner)."""
        _exclusive_write_json(self._epoch_path(rec.epoch), rec.to_json())
        return MembershipRecord.from_json(
            _read_json(self._epoch_path(rec.epoch)))

    # -- suspicion / departure -----------------------------------------

    def mark_suspect(self, epoch: int, sid: int, reason: str) -> None:
        """Publish "sid looks dead" (a stale heartbeat, an SDC verdict).
        Any member may write it; the others fold it into their next poll.
        Scoped to the ``epoch`` transition it accuses: a suspect that
        survives the regroup (slow, not dead) must not re-trigger every
        later epoch's, so once the transition completes its file is
        inert."""
        path = self.dir / f"suspect_e{int(epoch):04d}_r{int(sid):05d}.json"
        if not path.exists():
            _atomic_write_json(path, {"sid": int(sid), "reason": reason,
                                      "by": self.sid, "ts": time.time()})

    def suspects(self, epoch: int) -> dict[int, str]:
        """The suspects accused for the ``epoch`` transition, with their
        reasons."""
        out: dict[int, str] = {}
        for path in self.dir.glob(f"suspect_e{int(epoch):04d}_r*.json"):
            d = _read_json(path)
            if d is not None:
                out[int(d["sid"])] = str(d.get("reason", ""))
        return out

    def confirm_left(self, step: int) -> None:
        _atomic_write_json(self.dir / f"left_r{self.sid:05d}.json", {
            "sid": self.sid, "step": int(step), "ts": time.time()})

    # -- quiesce --------------------------------------------------------

    def _q_path(self, epoch: int, sid: int) -> Path:
        return self.dir / f"q_e{int(epoch):04d}_r{int(sid):05d}.json"

    def check_in(self, epoch: int, step: int, leaving: bool,
                 flavor: str, window: int = 1) -> None:
        """Publish or refresh this rank's quiesce check-in (every
        boundary): a quiescing rank keeps stepping while the plan
        converges, so its published position tracks its boundary;
        ``window`` feeds the publisher's stop-threshold margin."""
        _atomic_write_json(self._q_path(epoch, self.sid), {
            "sid": self.sid, "step": int(step), "leaving": bool(leaving),
            "flavor": flavor, "window": max(1, int(window)),
            "ts": time.time()})

    def check_ins(self, epoch: int) -> dict[int, dict]:
        out: dict[int, dict] = {}
        for path in self.dir.glob(f"q_e{int(epoch):04d}_r*.json"):
            d = _read_json(path)
            if d is not None:
                out[int(d["sid"])] = d
        return out

    def quiesce_triggered(self, epoch: int) -> bool:
        """True once ANY member checked in for the ``epoch`` transition."""
        return any(self.dir.glob(f"q_e{int(epoch):04d}_r*.json"))

    def try_plan(self, epoch: int) -> QuiescePlan | None:
        """The published transition plan, if any (non-blocking)."""
        d = _read_json(self.dir / f"plan_e{int(epoch):04d}.json")
        return QuiescePlan.from_json(d) if d is not None else None

    def maybe_publish_plan(self, epoch: int, members: Sequence[int],
                           train_epoch: int, timed_out: bool) -> None:
        """Publish THE plan when this rank is the acting leader (the
        lowest sid among the check-ins: the natural leader may be the dead
        rank) and the collection is ready: every member checked in, or the
        caller's collection window timed out. A member missing then is
        declared departed, with its suspect file's reason or "no quiesce
        check-in (timeout)"; a plan with departed members, or with any
        rollback check-in, is a rollback. Exclusive create: a slow second
        publisher loses and adopts the canonical file, so divergent local
        views cannot fork the membership."""
        members = sorted(int(m) for m in members)
        seen = self.check_ins(epoch)
        if not seen or min(seen) != self.sid:
            return
        complete = all(m in seen for m in members)
        if not (complete or timed_out):
            return
        suspects = self.suspects(epoch)
        departed = [{"sid": m,
                     "reason": suspects.get(m, "no quiesce check-in "
                                               "(timeout)")}
                    for m in members if m not in seen]
        leavers = tuple(s for s, d in sorted(seen.items()) if d["leaving"])
        rollback = bool(departed) or any(
            d["flavor"] == "rollback" for d in seen.values())
        max_step = max(d["step"] for d in seen.values())
        max_window = max(int(d.get("window", 1)) for d in seen.values())
        plan = QuiescePlan(
            epoch=epoch, flavor="rollback" if rollback else "graceful",
            # The stop threshold (see QuiescePlan): far enough that no
            # still-stepping member overshoots it before its next plan
            # poll, for every plan whose members are all alive (an SDC
            # eviction included: stopping the corrupt rank at once would
            # wedge its peers' collectives); a lone member has nobody to
            # overshoot, and a plan with departed members cannot step.
            stop_step=(max_step + 2 * max_window + 1)
            if not departed and len(members) > 1 else max_step,
            train_epoch=train_epoch, leavers=leavers,
            departed=tuple(departed),
            survivors=tuple(sorted(s for s in seen if s not in leavers)))
        _exclusive_write_json(self.dir / f"plan_e{int(epoch):04d}.json",
                              plan.to_json())

    # -- post-quiesce barrier ------------------------------------------

    def ack_quiesced(self, epoch: int) -> None:
        path = self.dir / f"q_e{int(epoch):04d}_r{self.sid:05d}.done"
        _ledger_io(path.touch, f"touch {path.name}")

    def await_quiesced(self, epoch: int, sids: Sequence[int],
                       timeout_s: float, poll_s: float = 0.05) -> list[int]:
        """Wait for everyone's post-quiesce ack; returns the sids that never
        acked (the final snapshot is committed by then, so a straggler
        must not wedge the regroup)."""
        deadline = time.monotonic() + timeout_s
        pending = {int(s) for s in sids}
        while pending and time.monotonic() <= deadline:
            pending = {s for s in pending if not (
                self.dir / f"q_e{int(epoch):04d}_r{s:05d}.done").exists()}
            if pending:
                time.sleep(poll_s)
        return sorted(pending)


class ElasticCoordinator:
    """Trainer-facing glue: the ledger protocol and the process-group
    surgery. One per process per generation. The trainer calls `poll`
    at every window boundary, `quiesce_step` while a transition
    converges (`quiesce_blocking` when it cannot step: its group failed),
    and on a survivor `establish` and `reinitialize` to form the next
    membership epoch."""

    def __init__(self, membership_dir: str | os.PathLike, generation: str,
                 sid: int, world: int, coordinator_address: str | None,
                 regroup_timeout_s: float = 60.0, poll_every_steps: int = 1,
                 coordinator_host: str = "", min_world: int = 1,
                 record: MembershipRecord | None = None):
        self.root = Path(membership_dir)
        self.ledger = MembershipLedger(self.root / generation, sid)
        self.sid = int(sid)
        self.regroup_timeout_s = float(regroup_timeout_s)
        self.poll_every_steps = max(1, int(poll_every_steps))
        self.coordinator_host = coordinator_host
        self.min_world = max(1, int(min_world))
        self._initial_coordinator = coordinator_address
        self._poll_marker = -1
        self._q_started: float | None = None  # monotonic quiesce start
        if record is not None:
            # Attached to a live generation at its current epoch: the record
            # is the membership truth; epoch 0 is neither written nor read.
            self.record = record
            return
        if self.sid == 0:
            self.ledger.write_initial(range(world), coordinator_address)
        # Non-leaders may race ahead of the leader's first write.
        self.record = self.ledger.await_epoch(0, timeout_s=regroup_timeout_s)

    @classmethod
    def attach(cls, membership_dir: str | os.PathLike, generation: str,
               sid: int, record: MembershipRecord,
               regroup_timeout_s: float = 60.0, poll_every_steps: int = 1,
               coordinator_host: str = "",
               min_world: int = 1) -> "ElasticCoordinator":
        """A coordinator of a LIVE generation at ``record``'s epoch, of
        which ``sid`` is a member: every later transition runs the standard
        protocol from there."""
        return cls(membership_dir, generation, sid, world=record.world,
                   coordinator_address=record.coordinator,
                   regroup_timeout_s=regroup_timeout_s,
                   poll_every_steps=poll_every_steps,
                   coordinator_host=coordinator_host, min_world=min_world,
                   record=record)

    # -- detection ------------------------------------------------------

    def poll(self, host_step: int, leave_requested: bool = False
             ) -> str | None:
        """Regroup trigger at a window boundary, or None: "leave" (this
        rank was told to go), "peer" (another member already checked in
        for the next epoch), "suspect" (a member was published as dead).
        The ledger glob runs once every ``poll_every_steps`` crossed; a
        local leave is never rate-limited."""
        if leave_requested:
            return "leave"
        step = int(host_step)
        if self._poll_marker >= 0 and (
                step // self.poll_every_steps
                <= self._poll_marker // self.poll_every_steps):
            return None
        self._poll_marker = step
        nxt = self.record.epoch + 1
        if self.ledger.quiesce_triggered(nxt):
            return "peer"
        if any(s in self.record.members for s in self.ledger.suspects(nxt)):
            return "suspect"
        return None

    def mark_suspect(self, rank: int, reason: str) -> None:
        """Accuse dense ``rank`` of the current epoch of being dead (for
        the next transition only: `MembershipLedger.mark_suspect`), with an
        ``elastic_suspect`` flight-recorder event."""
        from tpu_dp_torch.obs import flightrec

        sid = self.record.members[rank]
        flightrec.record("elastic_suspect", rank=sid, reason=reason)
        self.ledger.mark_suspect(self.record.epoch + 1, sid, reason)

    def rewind_poll(self, host_step: int) -> None:
        """Re-arm the rate-limited poll after a guard rollback rewound the
        step clock (`SnapshotManager.rewind`'s contract): a marker left at
        the pre-rollback high-water step would suppress peer and suspect
        detection for the whole replay."""
        self._poll_marker = int(host_step)

    # -- quiesce --------------------------------------------------------

    @property
    def quiescing(self) -> bool:
        """A transition is in flight (checked in, plan not yet adopted)."""
        return self._q_started is not None

    def quiesce_step(self, train_epoch: int, host_step: int, leaving: bool,
                     flavor: str = "graceful",
                     window: int = 1) -> QuiescePlan | None:
        """One non-blocking quiesce turn: refresh the check-in, try to
        agree. The caller keeps stepping in between (a stalled member
        would wedge every peer's collective; the plan's stop threshold is
        what halts the epoch). Returns the plan once published, None while
        converging; raises `ElasticError` when no plan appears within twice
        the regroup timeout (the acting leader died mid-transition)."""
        nxt = self.record.epoch + 1
        now = time.monotonic()
        if self._q_started is None:
            self._q_started = now
        self.ledger.check_in(nxt, host_step, leaving, flavor, window=window)
        plan = self.ledger.try_plan(nxt)
        if plan is None:
            self.ledger.maybe_publish_plan(
                nxt, self.record.members, train_epoch,
                timed_out=now > self._q_started + self.regroup_timeout_s)
            plan = self.ledger.try_plan(nxt)
        if plan is not None:
            self._q_started = None
            logger.warning(
                "elastic quiesce e%d (%s): stop threshold %d, leavers=%s "
                "departed=%s survivors=%s (sid %d)", plan.epoch, plan.flavor,
                plan.stop_step, list(plan.leavers),
                [d["sid"] for d in plan.departed], list(plan.survivors),
                self.sid)
            return plan
        if now > self._q_started + 2 * self.regroup_timeout_s:
            raise ElasticError(
                f"quiesce e{nxt}: no plan published within "
                f"{2 * self.regroup_timeout_s:.0f}s (sid {self.sid}; the "
                f"acting leader may have died mid-transition)")
        return None

    def quiesce_blocking(self, train_epoch: int, host_step: int,
                         leaving: bool, flavor: str, window: int = 1,
                         poll_s: float = 0.05) -> QuiescePlan:
        """Converge without stepping: the rollback path (this member's
        group failed). Bounded: `quiesce_step` raises `ElasticError` when
        no plan appears within twice the collection window."""
        while True:
            plan = self.quiesce_step(train_epoch, host_step, leaving,
                                     flavor, window=window)
            if plan is not None:
                return plan
            time.sleep(poll_s)

    def ack_and_await_quiesced(self, plan: QuiescePlan) -> None:
        """The post-snapshot barrier over every member of the plan."""
        self.ledger.ack_quiesced(plan.epoch)
        missing = self.ledger.await_quiesced(
            plan.epoch, plan.leavers + plan.survivors,
            timeout_s=self.regroup_timeout_s)
        if missing:
            logger.warning(
                "elastic quiesce e%d: no ack from sids %s within %.0fs — "
                "proceeding (final snapshot already committed)",
                plan.epoch, missing, self.regroup_timeout_s)

    def confirm_left(self, step: int) -> None:
        self.ledger.confirm_left(step)

    # -- epoch formation (survivor side) --------------------------------

    def establish(self, plan: QuiescePlan, resume: dict) -> MembershipRecord:
        """Form the new epoch: the new leader (the lowest surviving sid)
        publishes, everyone adopts. ``resume`` (the leader's wins) holds
        what a survivor needs to reload and re-split; the new rendezvous
        is on the leader's host at a freshly probed port (world 1 needs
        none)."""
        if len(plan.survivors) < self.min_world:
            raise ElasticError(
                f"regroup e{plan.epoch}: {len(plan.survivors)} survivor(s) "
                f"< resilience.elastic_min_world={self.min_world}")
        if self.sid not in plan.survivors:
            raise ElasticError(
                f"establish() called on non-survivor sid {self.sid}")
        leader = min(plan.survivors)
        if self.sid == leader:
            coordinator = None
            if len(plan.survivors) > 1:
                host = self.coordinator_host or self._default_host()
                # Known race: the probed port is released here and bound by
                # the new group's store only in reinitialize(); another
                # process can take it in between, and the regroup then
                # fails its rendezvous.
                coordinator = f"{host}:{free_port(host)}"
            # A leaver that was also accused (the SDC audit's eviction)
            # carries the accusation as its reason.
            suspects = self.ledger.suspects(plan.epoch)
            rec = MembershipRecord(
                epoch=plan.epoch, members=plan.survivors,
                coordinator=coordinator,
                departed=tuple(list(plan.departed) + [
                    {"sid": s, "reason": suspects.get(
                        s, "preempted (graceful)")}
                    for s in plan.leavers]),
                service_sid=leader, resume=resume, reason=plan.flavor,
                ts=time.time())
            self.record = self.ledger.publish_epoch(rec)
        else:
            self.record = self.ledger.await_epoch(
                plan.epoch, timeout_s=self.regroup_timeout_s)
        return self.record

    def _default_host(self) -> str:
        old = self._initial_coordinator or ""
        host = old.rsplit(":", 1)[0] if ":" in old else ""
        if host in ("127.0.0.1", "localhost", "::1"):
            return host  # a single-host topology stays on loopback
        try:
            return socket.gethostname()
        except OSError:
            return host or "127.0.0.1"

    def reinitialize(self, backend: str, device, record=None):
        """Tear down the old process group and form the new epoch's at
        the record's rendezvous, on ``backend`` (the one the run started
        with) and ``device``; returns the new `DistContext` and sets the
        ``elastic.membership_epoch`` gauge."""
        from tpu_dp_torch.parallel import dist

        rec = record or self.record
        self._poll_marker = -1
        dist.abandon_distributed()
        ctx = dist.elastic_initialize(
            rec.coordinator, rec.world, rec.rank_of(self.sid),
            backend=backend, device=device,
            timeout_s=self.regroup_timeout_s)
        _counters.gauge("elastic.membership_epoch", rec.epoch)
        return ctx
