"""Training guardrails of the port (of `tpu_dp.resilience.guard`):
divergence policy, batch quarantine, SDC audit.

A copy of the JAX package's module (it imports no JAX; the port keeps its
own copy), with the two functions that read parameters rewritten on
tensors: `leaf_paths` names the model's parameters by their JAX leaf
paths in JAX leaf order (`tpu_dp_torch.compat.param_leaves`), and
`params_checksum` is `make_params_checksum`'s per-leaf wrapping uint32 sum
of the bit patterns, bit for bit. The sentinel that feeds the policy is
`tpu_dp_torch.train.step.TrainStep` with ``sentinel=True``; the hook
that runs it is `tpu_dp_torch.train.hooks.GuardHook`.

The JAX package's text follows.

Training guardrails: divergence policy, batch quarantine, SDC audit.

The resilience stack up to here survives *loud* failures — preemption,
peer death, shrinking meshes. This module defends against the *quiet*
ones: a NaN/Inf gradient, a loss spike from a pathological batch, or
silent data corruption (SDC) on one chip — failures that poison every
replica through the gradient all-reduce and then every subsequent
snapshot, so ``--resume=auto`` faithfully resumes a corrupted run
(routine at pod scale: the pjit/TPUv4 scaling report, arXiv:2204.06514,
treats hardware-induced numeric faults as an operational fact).

Three pieces (docs/RESILIENCE.md "Guardrails"):

- :class:`GuardPolicy` — the host-side detector/action engine fed by the
  on-device health summary (`train/step.py` ``sentinel=True``): hard
  non-finite triggers plus windowed median/MAD z-score spike detection on
  loss and grad-norm, with escalating actions ``warn`` / ``skip`` /
  ``rollback`` / ``halt``. Pure Python, jax-free, unit-testable.
- :class:`QuarantineLog` — the append-only ``quarantine.jsonl`` record of
  every batch whose update was withheld, every rollback, and every SDC
  finding; records carry ``rollback_generation`` so post-hoc analysis
  never double-counts replayed steps (tombstone records mark the rewind).
- the SDC audit helpers — a cheap device-side bit-checksum of the
  parameter tree (:func:`make_params_checksum`) whose per-leaf sums are
  compared cross-rank over the same transport as the DP304 fingerprint
  check (`parallel/dist.cross_rank_digests`); a mismatching rank is
  attributed by majority vote (:func:`sdc_verdict`), down to the leaf.

:class:`DivergedError` is the typed "this run is mathematically dead"
exit: ``train.py`` maps it to exit code 65 (EX_DATAERR) — distinct from
the preemption 143 and the injected-kill 137, so supervisors can tell
"restart me" from "do NOT restart me, the data/math is wrong".
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
from collections import deque
from pathlib import Path
from typing import Any, Sequence

#: EX_DATAERR — the conventional "input data was incorrect" status: a
#: diverged run must not look like a preemption (143) to the supervisor,
#: which would auto-restart it into the same divergence.
DIVERGED_EXIT_CODE = 65

#: 1/Φ⁻¹(3/4): scales the median absolute deviation to a consistent
#: standard-deviation estimate under normality (the usual robust-z factor).
MAD_SCALE = 1.4826


class DivergedError(RuntimeError):
    """Raised when the guard policy escalates to ``halt`` (or exhausts its
    rollback budget): training is mathematically compromised and an
    auto-restart would reproduce the failure."""

    exit_code = DIVERGED_EXIT_CODE


@dataclasses.dataclass(frozen=True)
class GuardTrigger:
    """One policy finding for one optimizer step."""

    kind: str       # "nonfinite" | "cap" | "spike"
    step: int       # global optimizer step (host clock)
    reason: str     # human-readable detector attribution
    action: str     # what the policy wants: "record" | "rollback" | "halt"
    field: str = ""      # "loss" | "grad_norm" for spikes
    value: float = 0.0   # the offending observation
    z: float = 0.0       # robust z-score (spikes)


def robust_stats(values: Sequence[float]) -> tuple[float, float]:
    """(median, scaled MAD) of ``values`` — the spike detector's baseline.

    MAD (scaled by `MAD_SCALE`) rather than stddev: one genuine spike in
    the trailing window must not inflate the threshold enough to hide the
    next one (breakdown point 50% vs 0%).
    """
    xs = sorted(float(v) for v in values)
    n = len(xs)
    if n == 0:
        return 0.0, 0.0
    med = xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
    devs = sorted(abs(x - med) for x in xs)
    mad = devs[n // 2] if n % 2 else 0.5 * (devs[n // 2 - 1] + devs[n // 2])
    return med, MAD_SCALE * mad


class GuardPolicy:
    """Windowed divergence detection + escalating actions (host side).

    Fed once per dispatched window with the sentinel's per-step health
    records (``loss_raw``, ``grad_norm``, ``applied``); every rank runs
    the same policy over the same replicated values, so every rank reaches
    the same decision at the same boundary with zero extra coordination.

    Detectors, in order:

    - **non-finite** — ``applied == 0`` with a non-finite loss/grad-norm.
      The device already withheld the update (the sentinel's guarded
      select); the policy's job is the quarantine record and the
      configured escalation.
    - **cap** — ``applied == 0`` with finite values: the device-side
      ``loss_cap`` (armed from the previous window's median/MAD under
      ``action=skip``) caught a spike before its update applied.
    - **spike** — a robust z-score (``|x − median| / (1.4826·MAD)``) above
      ``spike_z`` on loss or grad-norm over the trailing ``spike_window``
      applied steps. Retrospective: the update already applied, so under
      ``action=skip`` a detected spike is record-and-warn (the *next*
      window's cap tightens), while ``rollback`` rewinds it away.

    Action escalation: ``max_rollbacks`` consecutive rollbacks without
    progress past the previous high-water step escalate to ``halt`` — a
    deterministic divergence replays identically, and rolling back into it
    forever is a livelock, not resilience.
    """

    ACTIONS = ("warn", "skip", "rollback", "halt")

    def __init__(
        self,
        action: str = "skip",
        spike_window: int = 64,
        spike_z: float = 8.0,
        spike_min_steps: int = 16,
        device_cap: bool = True,
        max_rollbacks: int = 3,
    ):
        if action not in self.ACTIONS:
            raise ValueError(
                f"guard.action must be one of {self.ACTIONS}, got {action!r}"
            )
        if spike_window < 4:
            raise ValueError(f"spike_window must be >= 4, got {spike_window}")
        if spike_z <= 0:
            raise ValueError(f"spike_z must be positive, got {spike_z}")
        self.action = action
        self.spike_window = int(spike_window)
        self.spike_z = float(spike_z)
        self.spike_min_steps = max(4, int(spike_min_steps))
        self.device_cap = bool(device_cap)
        self.max_rollbacks = int(max_rollbacks)
        self._loss: deque[float] = deque(maxlen=self.spike_window)
        self._gnorm: deque[float] = deque(maxlen=self.spike_window)
        self.rollbacks = 0            # total rollbacks this run
        self._rollback_streak = 0     # consecutive, without progress
        self._high_water = -1         # highest step ever observed applied

    # -- detection ------------------------------------------------------

    def _primed(self) -> bool:
        return len(self._loss) >= self.spike_min_steps

    def _z(self, history: deque, value: float) -> float:
        med, mad = robust_stats(history)
        if mad <= 0.0:
            # A flat window (constant loss) has no scale; only an actually
            # non-finite value is anomalous against it.
            return math.inf if not math.isfinite(value) else 0.0
        return abs(value - med) / mad

    def loss_cap(self) -> float:
        """Device-side skip threshold for the NEXT window (+inf = disarmed).

        Armed only under ``action=skip`` with a primed window: the cap is
        the same median + z·MAD bound the retrospective detector applies,
        evaluated *inside* the compiled step so a spiking batch's update is
        withheld instead of detected after the fact.
        """
        if not (self.device_cap and self.action == "skip" and self._primed()):
            return math.inf
        med, mad = robust_stats(self._loss)
        if mad <= 0.0:
            return math.inf
        return med + self.spike_z * mad

    def observe(self, records: Sequence[dict]) -> list[GuardTrigger]:
        """Fold one window's per-step health records into the policy.

        Each record: ``{"step", "loss", "gnorm", "applied"}`` (loss/gnorm
        RAW, from the sentinel's ``loss_raw``/``grad_norm`` metrics).
        Returns the triggers, worst action last — the caller applies them
        in order and lets the final rollback/halt take control flow.
        """
        out: list[GuardTrigger] = []
        for rec in records:
            step = int(rec["step"])
            loss = float(rec["loss"])
            gnorm = float(rec["gnorm"])
            applied = bool(rec["applied"])
            if not applied:
                nonfinite = not (math.isfinite(loss) and math.isfinite(gnorm))
                kind = "nonfinite" if nonfinite else "cap"
                act = "record"
                if self.action == "halt":
                    act = "halt"
                elif self.action == "rollback":
                    act = "rollback"
                out.append(GuardTrigger(
                    kind=kind, step=step, action=act,
                    reason=(
                        f"non-finite update at step {step} "
                        f"(loss={loss}, grad_norm={gnorm})" if nonfinite else
                        f"loss {loss:.6g} over the armed device cap at "
                        f"step {step}"
                    ),
                    field="loss", value=loss,
                ))
                continue  # a skipped step never enters the baseline window
            triggered = None
            if self._primed():
                for field, value, hist in (
                    ("loss", loss, self._loss),
                    ("grad_norm", gnorm, self._gnorm),
                ):
                    z = self._z(hist, value)
                    if z >= self.spike_z:
                        act = {"warn": "record", "skip": "record",
                               "rollback": "rollback",
                               "halt": "halt"}[self.action]
                        triggered = GuardTrigger(
                            kind="spike", step=step, action=act,
                            reason=(
                                f"{field} {value:.6g} is {z:.1f} robust "
                                f"sigmas off the trailing median at step "
                                f"{step}"
                            ),
                            field=field, value=value, z=round(z, 2),
                        )
                        break
            if triggered is not None:
                out.append(triggered)
                # The spiking observation is excluded from the baseline:
                # feeding it in would teach the detector that spikes are
                # normal exactly when they repeat.
                continue
            self._loss.append(loss)
            self._gnorm.append(gnorm)
            if step > self._high_water:
                self._high_water = step
                self._rollback_streak = 0
        return out

    # -- rollback bookkeeping ------------------------------------------

    def on_rollback(self) -> None:
        """Record a rollback; raises `DivergedError` past the budget.

        The streak resets when training progresses past its previous
        high-water step (`observe`), so only rollbacks that fail to make
        progress count against ``max_rollbacks``.
        """
        self.rollbacks += 1
        self._rollback_streak += 1
        # The replayed window re-approaches the trigger with a fresh
        # baseline; stale pre-rollback statistics would z-score the replay
        # against a window that partially no longer exists.
        self._loss.clear()
        self._gnorm.clear()
        if self._rollback_streak > self.max_rollbacks:
            raise DivergedError(
                f"guard: {self._rollback_streak} rollbacks without progress "
                f"past step {self._high_water} — the divergence replays "
                f"deterministically; halting instead of thrashing"
            )


class QuarantineLog:
    """Append-only jsonl ledger of quarantined batches / rollbacks / SDC.

    One record per event, every record stamped with the current
    ``rollback_generation`` so a reader can tell a first-attempt step from
    its post-rollback replay (the rewind itself appends a ``tombstone``
    record naming the generation it retired and the step it rewound past —
    records from that generation above that step describe undone work).
    Written by rank 0 only (the caller gates); fsync-free append+flush,
    same durability contract as the heartbeat files.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = None
        self.generation = 0

    def _append(self, rec: dict) -> None:
        if self._f is None or self._f.closed:
            # Forensic append stream, deliberately on the heartbeat
            # durability contract (class docstring): records must land
            # even mid-quarantine, so a retry budget here would stall the
            # guard path it exists to document.
            # dplint: allow(DP401) fsync-free forensic stream by contract
            self._f = open(self.path, "a", encoding="utf-8")
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def record(self, kind: str, **fields: Any) -> dict:
        rec = {
            "kind": kind,
            "ts": time.time(),
            "rollback_generation": self.generation,
            **fields,
        }
        self._append(rec)
        return rec

    def quarantine(self, *, epoch: int, step: int, sample_range: tuple[int, int],
                   rank: int, reason: str, **fields: Any) -> dict:
        """The batch-quarantine record: ``(epoch, step, sample-id range,
        rank)`` — enough to re-identify (and re-inspect, or permanently
        drop) the offending samples from the epoch's deterministic shuffle.
        """
        return self.record(
            "quarantine", epoch=int(epoch), step=int(step),
            sample_range=[int(sample_range[0]), int(sample_range[1])],
            rank=int(rank), reason=reason, **fields,
        )

    def tombstone(self, *, from_step: int, to_step: int, reason: str) -> dict:
        """Mark a rewind: generation ``generation`` ends; records of that
        generation with ``step > to_step`` describe undone (replayed) work.
        Bumps the generation for everything that follows."""
        rec = self.record(
            "tombstone", from_step=int(from_step), to_step=int(to_step),
            reason=reason,
        )
        self.generation += 1
        return rec

    def read(self) -> list[dict]:
        """Every record (tests / post-hoc tooling); torn lines skipped."""
        if not self.path.exists():
            return []
        out = []
        for line in self.path.read_text(encoding="utf-8").splitlines():
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
        return out

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()


def live_records(records: Sequence[dict]) -> list[dict]:
    """Filter quarantine-log records down to work that was never undone.

    Replays a reader-side sweep of the tombstones: a record is dead when a
    later tombstone retired its generation at a step below the record's.
    The post-hoc half of the rollback-rewind contract (`QuarantineLog`).
    """
    retired: dict[int, int] = {}  # generation -> rewound-to step
    for rec in records:
        if rec.get("kind") == "tombstone":
            gen = int(rec.get("rollback_generation", 0))
            to_step = int(rec.get("to_step", 0))
            retired[gen] = min(retired.get(gen, to_step), to_step)
    out = []
    for rec in records:
        if rec.get("kind") == "tombstone":
            continue
        gen = int(rec.get("rollback_generation", 0))
        if gen in retired and int(rec.get("step", 0)) > retired[gen]:
            continue
        out.append(rec)
    return out


# --------------------------------------------------------------------------
# SDC audit: device-side bit-checksum of the parameters.
# --------------------------------------------------------------------------

def _named(params) -> dict:
    """``{name: tensor}`` of a module's parameters (``params`` itself when
    it is already such a dict)."""
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return dict(params)


def leaf_paths(params) -> list[str]:
    """The JAX package's "/"-joined leaf paths of the parameters of
    ``params`` (a module, or ``{name: tensor}`` keyed like its
    ``named_parameters()``), in JAX leaf order: the names the audit's
    attribution and the ``sdc:`` fault spec's ``leaf=`` glob address."""
    from tpu_dp_torch.compat import param_leaves

    return [key for key, _, _ in param_leaves(_named(params))]


#: the signed integer of each element width: a leaf's bits are read as it.
_INT_OF_WIDTH = {1: "int8", 2: "int16", 4: "int32", 8: "int64"}


def params_checksum(params):
    """Per-leaf bit-checksum of the parameters of ``params`` (a module or
    ``{name: tensor}``), in `leaf_paths` order: ``uint32[num_leaves]``
    (numpy), equal bit for bit to the JAX package's `make_params_checksum`
    of the same parameters.

    Each float leaf is read as the integers of its element width (an
    integer leaf as it is) and summed, wrapping, into 32 bits. The sum
    does not depend on the order of the elements, so the torch layout
    (OIHW, ``(out, in)``) sums as the JAX leaf does. A float leaf is
    bitcast (``Tensor.view``) to the signed integer of its width, which
    sign-extends when widened: its 8- and 16-bit patterns are masked to
    their width per element before the sum, and a 32- or 64-bit sum is
    reduced mod 2**32 at the end (the same residue as the JAX package's
    unsigned sum). The sums run on the tensors' device; the result is one
    fetch of ``num_leaves`` integers."""
    import numpy as np
    import torch

    from tpu_dp_torch.compat import param_leaves

    named = _named(params)
    sums = []
    for _, name, _ in param_leaves(named):
        t = named[name].detach().reshape(-1)
        if t.dtype.is_floating_point:
            width = t.element_size()
            t = t.view(getattr(torch, _INT_OF_WIDTH[width]))
            if width < 4:
                t = t.to(torch.int64) & ((1 << (8 * width)) - 1)
        sums.append(t.sum(dtype=torch.int64))
    if not sums:
        return np.zeros(0, np.uint32)
    total = torch.stack(sums) & 0xFFFFFFFF
    return total.cpu().numpy().astype(np.uint32)

def digest_of_sums(sums) -> str:
    """sha256 hex digest of a checksum vector (the cross-rank token)."""
    import numpy as np

    arr = np.ascontiguousarray(np.asarray(sums, dtype=np.uint32))
    return hashlib.sha256(arr.tobytes()).hexdigest()


def sdc_verdict(per_rank_sums, paths: Sequence[str]) -> dict:
    """Majority-vote attribution over every rank's checksum vector.

    ``per_rank_sums``: array [world, num_leaves] (uint32) — each rank's
    `make_params_checksum` output, allgathered. The majority checksum
    vector is the reference; ranks differing from it are the suspects,
    each attributed down to the leaves whose sums diverge. A 50/50 split
    (world=2) has no majority — both ranks are reported, ``majority`` is
    None, and the caller must treat the audit as "divergence detected,
    attribution unavailable".
    """
    import numpy as np

    arr = np.asarray(per_rank_sums, dtype=np.uint32)
    world = arr.shape[0]
    votes: dict[bytes, list[int]] = {}
    for rank in range(world):
        votes.setdefault(arr[rank].tobytes(), []).append(rank)
    ranked = sorted(votes.values(), key=len, reverse=True)
    if len(ranked) == 1:
        return {"consistent": True, "suspects": [], "majority": ranked[0],
                "leaves": {}}
    if len(ranked[0]) == len(ranked[1]):
        # No majority: report everyone, attribute nothing.
        return {"consistent": False, "majority": None,
                "suspects": sorted(r for g in ranked for r in g),
                "leaves": {}}
    majority_ranks = ranked[0]
    ref = arr[majority_ranks[0]]
    suspects = sorted(r for g in ranked[1:] for r in g)
    leaves = {
        r: [paths[i] for i in np.nonzero(arr[r] != ref)[0]]
        for r in suspects
    }
    return {"consistent": False, "majority": majority_ranks,
            "suspects": suspects, "leaves": leaves}
