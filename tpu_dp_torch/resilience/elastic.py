"""Elastic world size (port of `tpu_dp.resilience.elastic`): when a rank
announces its departure, or vanishes without a word, the members agree the
transition through a **shared-filesystem membership ledger**, and the
survivors tear down the process group and form a new one at world N-1 with
dense new ranks (`tpu_dp_torch.parallel.dist.elastic_initialize`), reload
the agreed state through the resharding checkpoint path and re-split the
rest of the epoch over themselves (`tpu_dp_torch.data.sampler.
elastic_resplit`: every remaining sample of the interrupted epoch visited
exactly once). The grow makes it two-way: a relaunched or newly launched
process finds the live generation (`find_live_generation`), publishes a
fenced join request (`request_join`), the members quiesce as for a
graceful shrink with plan flavour ``grow``, and everyone, joiner included,
forms the group at world N+1; the joiner restores from the agreed quiesce
snapshot, never from its own disk.

Three flavours, as in the JAX package. *Graceful*: a leaver checks in,
every member steps to the agreed stop step, rank 0 commits the final
snapshot there and the leaver exits 143. *Rollback*: a member died (its
peers' collectives failed, or a heartbeat went stale and rank 0 published
it as a suspect, `mark_suspect`) or the SDC audit condemned it; the live
members check in with rollback flavour, the acting leader declares every
member that did not check in within ``regroup_timeout_s`` departed (the
suspect's reason, or "no quiesce check-in (timeout)"), and the survivors
resume from the newest complete save and replay the steps since it.
*Grow*: a validated join request is pending and nobody leaves; a graceful
quiesce whose survivors are the members and the joiners. A transition with
both a departure and a join resolves the shrink first ("shrink wins"; the
joiner re-targets the next epoch).

The admission is explicit about identity and fencing: a joiner requests a
stable id, granted only if no live member holds it; the request names the
generation directory and carries a per-incarnation token, and a request
from a stale view (a retired generation or epoch, a live seat) is refused
with a typed ``join_refused_*`` record; the admitting epoch record echoes
the token. A joiner cannot wedge the members: it is left out of the
post-quiesce ack barrier, the incumbents commit to the grown rendezvous
only once it signals ``join_ready`` (the incumbent leader waits, bounded,
and publishes the single verdict), and a joiner that never comes costs
them that wait, after which they re-form at world N from the grow's own
snapshot (`ElasticCoordinator.establish_fallback`: no work lost, no
rollback). `ServeMembership` keeps serving replicas' records in the same
files.

The files, their names and their JSON keys are the JAX package's, so
either package reads a ledger the other wrote.

Membership ledger layout (``<membership_dir>/<generation>/``)::

    epoch_0000.json      # membership record: epoch, members, coordinator,
                         # departed, joined, resume {steps_done, lineage, ...}
    q_e0001_r00002.json  # quiesce check-in of stable rank 2 for the
                         # transition to epoch 1: step reached, leaving?
    plan_e0001.json      # the agreed transition plan (single writer,
                         # exclusive-create: flavor, stop_step, survivors,
                         # joiners)
    q_e0001_r00002.done  # post-quiesce ack (final snapshot committed)
    suspect_e0001_r00002.json  # "sid 2 looks dead" (any member may write)
    left_r00002.json     # graceful-departure confirmation
    join_e0002_r00002.json     # a joiner's admission request for the
                               # transition to epoch 2 (exclusive-create;
                               # generation + incarnation token)
    join_refused_e0002_r00002.json  # typed refusal (fencing verdict)
    join_ready_e0002_r00002.json    # the admitted joiner enters the
                                    # rendezvous
    grow_verdict_e0002.json    # the incumbent leader's commit / abort

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
from typing import Any, Sequence

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
    #: admissions this epoch granted: [{"sid": s, "token": t}, ...]; the
    #: token echo is the joiner's proof that ITS incarnation (not a racing
    #: claimant of the same sid) was admitted.
    joined: tuple[dict, ...] = ()
    #: which member hosts the rendezvous's store. None (a record from
    #: before the grow) means dense rank 0; a grow epoch can seat a joiner
    #: at dense rank 0 (sids sort), and the store stays on the incumbent
    #: leader, whose host the coordinator address names.
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
    joiners: tuple[int, ...] = ()  # admitted outsiders (⊂ survivors)

    @property
    def incumbents(self) -> tuple[int, ...]:
        """Survivors that were already members: they hold the live group,
        the resume truth and (the lowest sid) the leadership."""
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
    budget (the caller's poll loop reads again). Every read passes the
    storage shim's read seam (``slowfs``)."""

    def read():
        shim = _storage_shim()
        if shim is not None:
            shim.on_read(path)  # slowfs: injected per-read latency
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

    # -- join (grow) ----------------------------------------------------

    def _join_path(self, epoch: int, sid: int) -> Path:
        return self.dir / f"join_e{int(epoch):04d}_r{int(sid):05d}.json"

    def _refusal_path(self, epoch: int, sid: int) -> Path:
        return (self.dir
                / f"join_refused_e{int(epoch):04d}_r{int(sid):05d}.json")

    def _ready_path(self, epoch: int, sid: int) -> Path:
        return (self.dir
                / f"join_ready_e{int(epoch):04d}_r{int(sid):05d}.json")

    def publish_join(self, epoch: int, sid: int, token: str,
                     generation: str, host: str = "") -> bool:
        """Claim the ``sid`` seat for the ``epoch`` transition (joiner
        side). Exclusive create: True when THIS incarnation's claim won,
        False when another claimant holds the seat for this transition
        (its file says whose token)."""
        return _exclusive_write_json(self._join_path(epoch, sid), {
            "sid": int(sid), "token": str(token),
            "generation": str(generation), "host": str(host),
            "ts": time.time()})

    def join_request(self, epoch: int, sid: int) -> dict | None:
        return _read_json(self._join_path(epoch, sid))

    def confirm_join_ready(self, epoch: int, sid: int) -> None:
        """The joiner's point of no return, published just before it
        enters the rendezvous: the incumbents commit to the grown group
        only for a joiner that is demonstrably alive now (a rendezvous
        with an absent party costs its whole timeout). Retried like every
        ledger write: a transient error here must not cost the incumbents
        the ready wait."""
        path = self._ready_path(epoch, sid)
        _ledger_io(path.touch, f"touch {path.name}")

    def await_join_ready(self, epoch: int, sids: Sequence[int],
                         timeout_s: float, poll_s: float = 0.05
                         ) -> list[int]:
        """Wait for every admitted joiner's ready signal; returns the sids
        that never signalled (the caller aborts the grow for them)."""
        deadline = time.monotonic() + timeout_s
        pending = {int(s) for s in sids}
        while pending and time.monotonic() <= deadline:
            pending = {s for s in pending
                       if not self._ready_path(epoch, s).exists()}
            if pending:
                time.sleep(poll_s)
        return sorted(pending)

    def publish_grow_verdict(self, epoch: int, commit: bool,
                             reason: str = "") -> None:
        """The single decision on whether a grow epoch's rendezvous runs,
        published by the incumbent leader after its `await_join_ready`:
        per-incumbent timers would split the incumbents between world N+1
        and the world-N fallback on a joiner that signals inside their
        skew, two camps that never meet."""
        _exclusive_write_json(
            self.dir / f"grow_verdict_e{int(epoch):04d}.json",
            {"commit": bool(commit), "reason": str(reason), "by": self.sid,
             "ts": time.time()})

    def await_grow_verdict(self, epoch: int, timeout_s: float,
                           poll_s: float = 0.05) -> dict | None:
        """The leader's published verdict, or None on timeout (the leader
        died mid-grow: the caller raises)."""
        deadline = time.monotonic() + timeout_s
        path = self.dir / f"grow_verdict_e{int(epoch):04d}.json"
        while time.monotonic() <= deadline:
            d = _read_json(path)
            if d is not None:
                return d
            time.sleep(poll_s)
        return None

    def join_refusal(self, epoch: int, sid: int) -> dict | None:
        return _read_json(self._refusal_path(epoch, sid))

    def refuse_join(self, epoch: int, sid: int, reason: str) -> None:
        """Publish the typed fencing verdict (idempotent, any member)."""
        path = self._refusal_path(epoch, sid)
        if not path.exists():
            logger.warning("elastic: refusing join of sid %d for e%d: %s",
                           sid, epoch, reason)
            _atomic_write_json(path, {"sid": int(sid), "reason": str(reason),
                                      "by": self.sid, "ts": time.time()})

    def refuse_stale_joins(self, current_epoch: int,
                           members: Sequence[int] = ()) -> None:
        """Refuse join requests aimed at transitions that already
        completed: a zombie acting on a retired record targets an epoch
        the live run is past. Spared: a request at the current epoch (a
        shrink-deferred claim whose owner is re-targeting), a claim whose
        sid is a current member (admitted, maybe at a later epoch than it
        first targeted), and a claim its own target epoch admitted."""
        import re

        live = {int(m) for m in members}
        for path in self.dir.glob("join_e*_r*.json"):
            m = re.fullmatch(r"join_e(\d+)_r(\d+)\.json", path.name)
            if m is None:
                continue
            epoch, sid = int(m.group(1)), int(m.group(2))
            if epoch >= int(current_epoch) or sid in live:
                continue
            rec_d = _read_json(self._epoch_path(epoch))
            if rec_d is not None and sid in (
                    int(x) for x in rec_d.get("members") or ()):
                continue  # a consumed claim: its epoch admitted it
            self.refuse_join(
                epoch, sid,
                f"stale epoch fencing: transition e{epoch} already "
                f"completed (current membership epoch "
                f"{int(current_epoch)}) — request built from a retired "
                f"incarnation's view")

    def validate_joins(self, epoch: int, members: Sequence[int],
                       max_world: int = 0) -> dict[int, dict]:
        """The ``epoch`` transition's admissible join requests, fencing
        applied (deterministic given the same files): a request naming
        another generation than this directory is refused (a retired
        incarnation's view); one for a live member's sid is a seat
        conflict, refused; admissions beyond ``max_world`` (0: unbounded)
        are refused, lowest sid first admitted. A published refusal is
        final for its transition (the claimant may already have acted on
        it); the epoch record stays the canonical admission."""
        members = {int(m) for m in members}
        out: dict[int, dict] = {}
        for path in sorted(self.dir.glob(f"join_e{int(epoch):04d}_r*.json")):
            d = _read_json(path)
            if d is None:
                continue
            sid = int(d["sid"])
            if self._refusal_path(epoch, sid).exists():
                continue
            if str(d.get("generation", "")) != self.dir.name:
                self.refuse_join(
                    epoch, sid,
                    f"stale generation fencing: request names "
                    f"{d.get('generation')!r}, live generation is "
                    f"{self.dir.name!r}")
                continue
            if sid in members:
                self.refuse_join(
                    epoch, sid,
                    f"sid {sid} is a live member of this epoch (seat "
                    f"conflict — a departed rank must be observed departed "
                    f"before its seat can be re-claimed)")
                continue
            if max_world and len(members) + len(out) + 1 > int(max_world):
                self.refuse_join(
                    epoch, sid,
                    f"world at resilience.elastic_max_world={max_world}")
                continue
            out[sid] = d
        return out

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
                           train_epoch: int, timed_out: bool,
                           max_world: int = 0) -> None:
        """Publish THE plan when this rank is the acting leader (the
        lowest sid among the check-ins: the natural leader may be the dead
        rank) and the collection is ready: every member checked in, or the
        caller's collection window timed out. A member missing then is
        declared departed, with its suspect file's reason or "no quiesce
        check-in (timeout)"; a plan with departed members, or with any
        rollback check-in, is a rollback. The transition's validated join
        requests become ``joiners`` only on a transition that is otherwise
        clean (no leaver, nothing departed: "shrink wins", the joiner
        re-targets the next epoch), making a grow. Exclusive create: a
        slow second publisher loses and adopts the canonical file, so
        divergent local views cannot fork the membership."""
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
        joiners: tuple[int, ...] = ()
        if not rollback and not leavers:
            joiners = tuple(sorted(self.validate_joins(
                epoch, members, max_world=max_world)))
        max_step = max(d["step"] for d in seen.values())
        max_window = max(int(d.get("window", 1)) for d in seen.values())
        plan = QuiescePlan(
            epoch=epoch, flavor=("rollback" if rollback
                                 else "grow" if joiners else "graceful"),
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
            survivors=tuple(sorted([s for s in seen if s not in leavers]
                                   + list(joiners))),
            joiners=joiners)
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


class ServeMembership:
    """Serving replicas' membership records over the same ledger files
    (the JAX package's, for its router): replicas are independent
    consumers of one queue, so there is no quiesce and no stop step; the
    router is the single writer, and an epoch is "who is fed now". Every
    drain, failure and rejoin is an atomically published
    `MembershipRecord`, with ``reason`` ``serve_departure`` or
    ``serve_rejoin`` so the two protocols stay apart in one timeline, and
    departure reasons in the training ledger's words (``preempted
    (graceful)`` for a drain)."""

    def __init__(self, membership_dir: str | os.PathLike,
                 generation: str = "serve", sid: int = 0):
        self.ledger = MembershipLedger(Path(membership_dir) / generation, sid)

    def initial(self, members: Sequence[int]) -> MembershipRecord:
        """Publish epoch 0 (idempotent: adopts an existing record)."""
        return self.ledger.write_initial(members, None)

    def current(self) -> MembershipRecord:
        return self.ledger.current()

    def depart(self, sid: int, reason: str) -> MembershipRecord:
        """Publish the epoch without ``sid`` (a drain or a failure)."""
        cur = self.ledger.current()
        out = self.ledger.publish_epoch(MembershipRecord(
            epoch=cur.epoch + 1,
            members=tuple(m for m in cur.members if m != int(sid)),
            coordinator=None,
            departed=({"sid": int(sid), "reason": str(reason)},),
            reason="serve_departure", ts=time.time()))
        _counters.gauge("serve.membership_epoch", out.epoch)
        return out

    def rejoin(self, sid: int) -> MembershipRecord:
        """Publish the epoch with ``sid`` back in the feed set."""
        cur = self.ledger.current()
        out = self.ledger.publish_epoch(MembershipRecord(
            epoch=cur.epoch + 1,
            members=tuple(sorted(set(cur.members) | {int(sid)})),
            coordinator=None, reason="serve_rejoin", ts=time.time()))
        _counters.gauge("serve.membership_epoch", out.epoch)
        return out


class ElasticCoordinator:
    """Trainer-facing glue: the ledger protocol and the process-group
    surgery. One per process per generation. The trainer calls `poll`
    at every window boundary, `quiesce_step` while a transition
    converges (`quiesce_blocking` when it cannot step: its group failed),
    and on a survivor `establish` and `reinitialize` to form the next
    membership epoch (`establish_fallback` after a grow whose joiner never
    came); a joiner attaches to the live generation (`attach`)."""

    def __init__(self, membership_dir: str | os.PathLike, generation: str,
                 sid: int, world: int, coordinator_address: str | None,
                 regroup_timeout_s: float = 60.0, poll_every_steps: int = 1,
                 coordinator_host: str = "", min_world: int = 1,
                 max_world: int = 0,
                 record: MembershipRecord | None = None):
        self.root = Path(membership_dir)
        self.ledger = MembershipLedger(self.root / generation, sid)
        self.sid = int(sid)
        self.regroup_timeout_s = float(regroup_timeout_s)
        self.poll_every_steps = max(1, int(poll_every_steps))
        self.coordinator_host = coordinator_host
        self.min_world = max(1, int(min_world))
        self.max_world = max(0, int(max_world))
        self._initial_coordinator = coordinator_address
        self._poll_marker = -1
        self._q_started: float | None = None  # monotonic quiesce start
        #: the rendezvous store this process opened for a record it
        #: publishes (`_open_service`), handed to the group it forms.
        self._service_store = None
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
               coordinator_host: str = "", min_world: int = 1,
               max_world: int = 0) -> "ElasticCoordinator":
        """A coordinator of a LIVE generation at ``record``'s epoch: the
        joiner's constructor (``sid`` was admitted by ``record``,
        `request_join`). It never writes or waits for epoch 0; every later
        transition (a further shrink, another grow, this rank's own
        departure) runs the standard protocol from there."""
        return cls(membership_dir, generation, sid, world=record.world,
                   coordinator_address=record.coordinator,
                   regroup_timeout_s=regroup_timeout_s,
                   poll_every_steps=poll_every_steps,
                   coordinator_host=coordinator_host, min_world=min_world,
                   max_world=max_world, record=record)

    # -- detection ------------------------------------------------------

    def poll(self, host_step: int, leave_requested: bool = False
             ) -> str | None:
        """Regroup trigger at a window boundary, or None: "leave" (this
        rank was told to go), "peer" (another member already checked in
        for the next epoch), "suspect" (a member was published as dead),
        "join" (an outsider published an admissible join request: fencing
        applied and refusals written, so an invalid claim never starts a
        quiesce). The ledger glob runs once every ``poll_every_steps``
        crossed; a local leave is never rate-limited. At the same cadence
        the leader alone refuses requests aimed at transitions already
        completed (a stale claimant exits on the verdict instead of
        waiting out its timeout)."""
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
        if self.ledger.validate_joins(nxt, self.record.members,
                                      max_world=self.max_world):
            return "join"
        if self.sid == min(self.record.members):
            self.ledger.refuse_stale_joins(self.record.epoch,
                                           members=self.record.members)
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
                timed_out=now > self._q_started + self.regroup_timeout_s,
                max_world=self.max_world)
            plan = self.ledger.try_plan(nxt)
        if plan is not None:
            self._q_started = None
            logger.warning(
                "elastic quiesce e%d (%s): stop threshold %d, leavers=%s "
                "departed=%s joiners=%s survivors=%s (sid %d)", plan.epoch,
                plan.flavor, plan.stop_step, list(plan.leavers),
                [d["sid"] for d in plan.departed], list(plan.joiners),
                list(plan.survivors), self.sid)
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
        """The post-snapshot barrier over every member of the plan still
        alive. Joiners are left out: they never quiesced, and a half-dead
        joiner must not cost the members this wait on top of the join-
        ready gate that already fences it."""
        self.ledger.ack_quiesced(plan.epoch)
        missing = self.ledger.await_quiesced(
            plan.epoch, [s for s in plan.leavers + plan.survivors
                         if s not in plan.joiners],
            timeout_s=self.regroup_timeout_s)
        if missing:
            logger.warning(
                "elastic quiesce e%d: no ack from sids %s within %.0fs — "
                "proceeding (final snapshot already committed)",
                plan.epoch, missing, self.regroup_timeout_s)

    def confirm_left(self, step: int) -> None:
        self.ledger.confirm_left(step)

    # -- epoch formation (survivor side) --------------------------------

    def _open_service(self, members: Sequence[int]) -> str | None:
        """The rendezvous of a record this leader publishes: None for a
        group of one (it needs no address), else ``host:port`` of a store
        opened here and now at a port the OS assigns, held until
        `reinitialize` hands it to the group (no port is probed, released
        and bound later, so no other process can take it in between)."""
        from tpu_dp_torch.parallel.dist import open_rendezvous_store

        self._service_store = None
        if len(members) <= 1:
            return None
        host = self.coordinator_host or self._default_host()
        self._service_store = open_rendezvous_store(
            host, timeout_s=self.regroup_timeout_s)
        return f"{host}:{self._service_store.port}"

    def establish(self, plan: QuiescePlan, resume: dict) -> MembershipRecord:
        """Form the new epoch: the new leader publishes, everyone adopts.
        ``resume`` (the leader's wins) holds what a survivor needs to
        reload and re-split. The leader is the lowest *incumbent* sid: a
        joiner can hold the lowest sid overall, but only an incumbent
        holds the live state and a host the peers already reach, so the
        record pins the rendezvous store to it (``service_sid``), whatever
        the dense ranks; its ``joined`` entries echo each joiner's token."""
        if len(plan.survivors) < self.min_world:
            raise ElasticError(
                f"regroup e{plan.epoch}: {len(plan.survivors)} survivor(s) "
                f"< resilience.elastic_min_world={self.min_world}")
        if self.sid not in plan.survivors:
            raise ElasticError(
                f"establish() called on non-survivor sid {self.sid}")
        leader = min(plan.incumbents or plan.survivors)
        if self.sid == leader:
            coordinator = self._open_service(plan.survivors)
            # A leaver that was also accused (the SDC audit's eviction)
            # carries the accusation as its reason.
            suspects = self.ledger.suspects(plan.epoch)
            requests = {s: self.ledger.join_request(plan.epoch, s) or {}
                        for s in plan.joiners}
            rec = MembershipRecord(
                epoch=plan.epoch, members=plan.survivors,
                coordinator=coordinator,
                departed=tuple(list(plan.departed) + [
                    {"sid": s, "reason": suspects.get(
                        s, "preempted (graceful)")}
                    for s in plan.leavers]),
                joined=tuple({"sid": s,
                              "token": str(requests[s].get("token", ""))}
                             for s in plan.joiners),
                service_sid=leader, resume=resume, reason=plan.flavor,
                ts=time.time())
            self.record = self.ledger.publish_epoch(rec)
        else:
            self.record = self.ledger.await_epoch(
                plan.epoch, timeout_s=self.regroup_timeout_s)
        return self.record

    def establish_fallback(self, failed: MembershipRecord,
                           reason: str) -> MembershipRecord:
        """Abort a grow whose joiner never completed the handshake:
        re-form at world N. The incumbent leader publishes the corrective
        epoch with the same resume (the grow quiesce's final snapshot:
        nothing lost, nothing rolled back), the incumbents as members and
        each would-be joiner departed with ``reason``; a slow joiner that
        wakes later sees the record form without it and requests again."""
        joined = tuple(int(j["sid"]) for j in failed.joined)
        incumbents = tuple(s for s in failed.members if s not in joined)
        if not incumbents or self.sid not in incumbents:
            raise ElasticError(
                f"grow fallback from e{failed.epoch}: sid {self.sid} is "
                f"not an incumbent (members {list(failed.members)}, "
                f"joined {list(joined)})")
        leader = min(incumbents)
        epoch = failed.epoch + 1
        if self.sid == leader:
            rec = MembershipRecord(
                epoch=epoch, members=incumbents,
                coordinator=self._open_service(incumbents),
                departed=tuple({"sid": s, "reason": reason} for s in joined),
                service_sid=leader, resume=failed.resume,
                reason="grow_aborted", ts=time.time())
            self.record = self.ledger.publish_epoch(rec)
        else:
            self.record = self.ledger.await_epoch(
                epoch, timeout_s=self.regroup_timeout_s)
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
        ``elastic.membership_epoch`` gauge. The member the record names
        (``service_sid``; dense rank 0 in a record without one) hosts the
        store, the one `_open_service` opened when it published."""
        from tpu_dp_torch.parallel import dist

        rec = record or self.record
        rank = rec.rank_of(self.sid)
        service = (rank == 0 if rec.service_sid is None
                   else rec.service_sid == self.sid)
        store, self._service_store = self._service_store, None
        if store is not None and not (
                service and rec.coordinator
                and rec.coordinator.endswith(f":{store.port}")):
            store = None  # opened for another record (a lost publish)
        self._poll_marker = -1
        dist.abandon_distributed()
        ctx = dist.elastic_initialize(
            rec.coordinator, rec.world, rank, backend=backend, device=device,
            timeout_s=self.regroup_timeout_s, store=store,
            host_service=service)
        _counters.gauge("elastic.membership_epoch", rec.epoch)
        return ctx


# ---------------------------------------------------------------------------
# The joiner: discovery, join request, admission, the grown group.
# ---------------------------------------------------------------------------


def find_live_generation(membership_root: str | os.PathLike
                         ) -> tuple[Path, MembershipRecord] | None:
    """The newest generation under ``membership_root`` and its current
    record, or None when the ledger is empty or unreadable. "Newest" by
    the records' own publish stamps (the one clock every incarnation
    stamped), not directory times: an archived copy or a lagging shared
    filesystem must not elect a retired incarnation."""
    root = Path(membership_root)
    if not root.is_dir():
        return None
    best: tuple[float, Path, MembershipRecord] | None = None
    for gen_dir in root.iterdir():
        if not gen_dir.is_dir():
            continue
        try:
            rec = MembershipLedger(gen_dir, sid=-1).current()
        except ElasticError:
            continue
        if best is None or rec.ts > best[0]:
            best = (rec.ts, gen_dir, rec)
    if best is None:
        return None
    return best[1], best[2]


def request_join(gen_dir: str | os.PathLike, sid: int,
                 timeout_s: float = 60.0, poll_s: float = 0.1,
                 attempts: int = 3, host: str = "",
                 alive_timeout_s: float | None = None
                 ) -> tuple[MembershipRecord, str]:
    """The joiner's half of the admission handshake (ledger only).

    Publishes an exclusive-create join request for the generation's next
    transition and waits, each attempt, for one of three outcomes:
    *admitted* (an epoch record whose ``joined`` echoes this
    incarnation's token: returned with the token), *refused* (a
    ``join_refused_*`` verdict: `ElasticError` with the members' reason),
    or the transition forming *without* it (a shrink won, another
    claimant took the seat: re-target the next epoch). A generation that
    answers nothing within ``timeout_s`` is presumed dead, and raises. A
    sid that is still a live member waits for the next record first
    (the live-seat zombie fence), never claiming over it.

    ``alive_timeout_s`` tells "is anyone serving this ledger?" from "how
    long may a live quiesce take": once the members answer (a check-in or
    a plan for the target transition), the attempt's deadline extends to
    it, so a short liveness probe never abandons a grow that converges
    (a stop threshold's worth of real updates and a snapshot)."""
    import uuid

    gen_dir = Path(gen_dir)
    ledger = MembershipLedger(gen_dir, int(sid))
    token = uuid.uuid4().hex
    for _ in range(max(1, int(attempts))):
        deadline = time.monotonic() + float(timeout_s)
        cur = ledger.current()
        if int(sid) in cur.members:
            # The seat is still live: the departure record has not formed
            # yet (this raced its own predecessor's eviction), or a zombie
            # asks for a seat it never left. Wait for the next record.
            try:
                ledger.await_epoch(
                    cur.epoch + 1,
                    timeout_s=max(0.5, deadline - time.monotonic()))
            except ElasticError:
                raise ElasticError(
                    f"join: sid {sid} is a live member of {gen_dir.name} "
                    f"epoch {cur.epoch} and no departure record formed "
                    f"within {timeout_s:.0f}s — refusing to claim a live "
                    f"seat (zombie fencing)") from None
            continue
        target = cur.epoch + 1
        if not ledger.publish_join(target, sid, token, gen_dir.name,
                                   host=host):
            claim = ledger.join_request(target, sid) or {}
            if str(claim.get("token")) != token:
                logger.warning(
                    "join: sid %d seat for e%d already claimed by another "
                    "incarnation; waiting for the transition", sid, target)
        logger.warning("elastic join: sid %d requesting admission to %s "
                       "e%d (token %s)", sid, gen_dir.name, target,
                       token[:8])
        extended = alive_timeout_s is None
        while time.monotonic() < deadline:
            if not extended and (ledger.quiesce_triggered(target)
                                 or ledger.try_plan(target) is not None):
                extended = True
                deadline = max(deadline,
                               time.monotonic() + float(alive_timeout_s))
                logger.warning("join: members are converging e%d — "
                               "extending the admission wait to %.0fs",
                               target, alive_timeout_s)
            # The epoch record is canonical and read first: a racing
            # refusal from one member's glob must not kill an admitted
            # joiner.
            rec_d = _read_json(ledger._epoch_path(target))
            if rec_d is not None:
                rec = MembershipRecord.from_json(rec_d)
                if any(int(j.get("sid", -1)) == int(sid)
                       and str(j.get("token")) == token for j in rec.joined):
                    return rec, token
                logger.warning("join: e%d formed without sid %d (reason "
                               "%r); re-targeting e%d", target, sid,
                               rec.reason, target + 1)
                break
            refusal = ledger.join_refusal(target, sid)
            if refusal is not None:
                raise ElasticError(
                    f"join refused for sid {sid} (e{target}, "
                    f"{gen_dir.name}): {refusal.get('reason')}")
            time.sleep(poll_s)
        else:
            raise ElasticError(
                f"join: no admission, refusal, or transition for sid {sid} "
                f"within {timeout_s:.0f}s ({gen_dir.name} e{target}) — the "
                f"run is dead, idle past the poll cadence, or the ledger is "
                f"not shared")
    raise ElasticError(
        f"join: admission not granted after {attempts} transition "
        f"attempt(s) for sid {sid} under {gen_dir.name}")


@dataclasses.dataclass
class JoinOutcome:
    """Everything a joined Trainer needs from the admission handshake."""

    coordinator: ElasticCoordinator
    record: MembershipRecord
    ctx: Any  # tpu_dp_torch.parallel.dist.DistContext
    token: str
    generation: str


def maybe_join(cfg, device=None) -> JoinOutcome | None:
    """The Trainer's joiner bootstrap (``resilience.elastic_join``):
    whether this process JOINS a live run instead of starting one, and if
    so the whole handshake (discovery, fenced request, admission, the
    grown group on ``device``). None means the classic bootstrap: mode
    "never"; no ledger (or no stable id) under "auto"; the newest
    generation's record still lists this sid (a whole-job restart, or a
    plain resume) under "auto"; an auto probe that nobody answered or
    that was refused. "always" skips only that membership heuristic, not
    the fencing: it joins or raises `ElasticError`.

    The stable id is ``parallel.process_id`` (or ``RANK``; the JAX
    package's ``TPU_DP_PROCESS_ID`` too). The group's backend is the one
    this process already ran with (the in-process rejoin), else NCCL on a
    card and gloo on the CPU."""
    res = cfg.resilience
    mode = res.elastic_join
    if mode not in ("auto", "always", "never"):
        raise ValueError(f"resilience.elastic_join must be "
                         f"auto|always|never, got {mode!r}")
    if mode == "never":
        return None
    root = Path(res.membership_dir
                or Path(cfg.train.ckpt_dir) / "membership")
    sid = cfg.parallel.process_id
    if sid is None:
        sid = int(os.environ.get("TPU_DP_PROCESS_ID",
                                 os.environ.get("RANK", -1)))
    if sid < 0:
        if mode == "always":
            raise ElasticError(
                "resilience.elastic_join=always needs an explicit stable id "
                "(parallel.process_id / RANK / TPU_DP_PROCESS_ID) to "
                "request")
        return None
    found = find_live_generation(root)
    if found is None:
        if mode == "always":
            raise ElasticError(f"resilience.elastic_join=always but no "
                               f"membership generation exists under {root}")
        return None
    gen_dir, current = found
    if mode == "auto" and int(sid) in current.members:
        return None
    timeout = float(res.elastic_join_timeout_s or res.regroup_timeout_s)
    probe = timeout
    if mode == "auto" and not res.elastic_join_timeout_s:
        # Auto's probe guesses that the run is alive, wrongly exactly when
        # the whole job restarted after a shrink: its peers wait in the
        # classic bootstrap, bounded by regroup_timeout_s, so a short probe
        # falls back in time; alive_timeout_s restores the full budget once
        # the members answer.
        probe = min(timeout, 15.0)
    try:
        host = socket.gethostname()
    except OSError:
        host = ""
    try:
        record, token = request_join(gen_dir, int(sid), timeout_s=probe,
                                     host=host, alive_timeout_s=timeout)
    except ElasticError as e:
        if mode == "always":
            raise
        logger.warning("elastic join (auto): probe of %s failed (%s) — "
                       "falling back to the classic bootstrap",
                       gen_dir.name, e)
        return None
    coord = ElasticCoordinator.attach(
        root, gen_dir.name, int(sid), record,
        regroup_timeout_s=res.regroup_timeout_s,
        poll_every_steps=res.elastic_poll_every_steps,
        coordinator_host=res.elastic_coordinator_host,
        min_world=res.elastic_min_world, max_world=res.elastic_max_world)
    # The incumbents may already have aborted this grow (this joiner was
    # too slow for their join_ready gate): a corrective record without it
    # means the admitted rendezvous is never served.
    aborted = _read_json(coord.ledger._epoch_path(record.epoch + 1))
    if aborted is not None and int(sid) not in (aborted.get("members") or ()):
        raise ElasticError(
            f"grow e{record.epoch} was aborted by the incumbents before "
            f"this joiner signalled ready (epoch {record.epoch + 1} formed "
            f"without sid {sid}); re-run to request again")
    from tpu_dp_torch.parallel import dist as _dist

    prior = _dist.current_context()
    dev = _dist.resolve_device(device)
    backend = (prior.backend if prior is not None and prior.backend
               else "nccl" if dev.type == "cuda" else "gloo")
    # The point of no return: the incumbents commit to the grown group
    # only for a joiner that signalled here.
    coord.ledger.confirm_join_ready(record.epoch, int(sid))
    ctx = coord.reinitialize(backend, dev, record)
    _counters.inc("elastic.joins")
    logger.warning("elastic join: sid %d admitted to %s e%d — world %d, "
                   "dense rank %d", sid, gen_dir.name, record.epoch,
                   record.world, record.rank_of(int(sid)))
    return JoinOutcome(coordinator=coord, record=record, ctx=ctx,
                       token=token, generation=gen_dir.name)
