"""Async training snapshots — checkpoint cadence measured in steps, not
epochs (port of `tpu_dp.resilience.snapshot`).

`SnapshotManager` snapshots the live `TrainState` every
``snapshot_every_steps`` optimizer steps into its own directory (default
``<ckpt_dir>/snapshots``), keeping the newest ``keep``. Saves are in the
JAX package's snapshot format (``meta["kind"] == "snapshot"``, ``epoch``,
``steps_done``, ``global_step``), so either package resumes from the
other's.

The host copy costs the step almost nothing:

- the parameters, statistics and momentum are concatenated on the device
  and copied into one of two **reusable host buffers** (pinned on a card)
  on the caller's current stream, after the window that produced them; a
  CUDA event is recorded behind the copy and the writer thread waits on it
  before it encodes, so the training thread never waits for the copy. The
  windows' CUDA graphs update parameters and momentum in place, and a
  window's stream waits on the caller's stream before it replays (`train.
  step.MultiStep`), so the next replay cannot overwrite them before the
  copy has read them;
- slot discipline: a buffer comes around again only after the write that
  used it was joined (each save joins the previous in-flight write before
  starting the next), as in the JAX package;
- encode and IO run on the manager's worker thread, the commit is atomic
  (tmp + rename, then the ``latest`` pointer), writes retry on the IO
  budget, and a failed write degrades (``snapshot.write_errors``, the log
  and the flight recorder) instead of ending the run.

Under the sharded update the snapshot gathers every rank's momentum and
residual shards (a collective: every rank calls `snapshot` at the same
boundary; rank 0 writes).
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Any

import torch

from tpu_dp_torch import checkpoint as ckpt_lib
from tpu_dp_torch.obs import flightrec
from tpu_dp_torch.obs.counters import counters as _counters
from tpu_dp_torch.parallel.dist import process_index

log = logging.getLogger(__name__)


class SnapshotManager:
    """Step-cadence async snapshots of `TrainState` with double buffering.

    ``every_steps <= 0`` disables the cadence (`maybe` never fires) but the
    manager still serves explicit `snapshot` calls — the preemption
    boundary's final snapshot works with periodic snapshots off."""

    def __init__(self, snap_dir: str | os.PathLike, every_steps: int = 0,
                 keep: int = 2, async_save: bool = True):
        self.snap_dir = Path(snap_dir)
        self.every_steps = int(every_steps)
        self.keep = int(keep)
        self._mgr = ckpt_lib.CheckpointManager(self.snap_dir, keep=keep,
                                               async_save=async_save)
        self._buffers: list[torch.Tensor | None] = [None, None]
        self._slot = 0
        self._last_step = -1
        #: the newest snapshot's ms on the training thread (the copy's
        #: enqueue and the handoff, which joins the previous write).
        self.last_blocking_ms: float | None = None

    def _host_copy(self, state):
        """``(host tree, ready event or None)``: the state's leaves copied
        into the next reusable host buffer, the copy enqueued on the
        current stream (a card) or done (the CPU)."""
        leaves = ckpt_lib.state_leaves(state)
        tensors = [t.detach() for _, _, t in leaves]
        if any(t.dtype != torch.float32 for t in tensors):
            raise ValueError("the saved state is float32 throughout")
        flat = torch.cat([t.reshape(-1) for t in tensors])
        slot = self._slot
        self._slot ^= 1
        buf = self._buffers[slot]
        if buf is None or buf.numel() != flat.numel():
            buf = torch.empty(flat.numel(), dtype=torch.float32,
                              pin_memory=flat.device.type == "cuda")
            self._buffers[slot] = buf
        ready = None
        if flat.device.type == "cuda":
            buf.copy_(flat, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(flat.device))
        else:
            buf.copy_(flat)
        arr, arrays, at = buf.numpy(), [], 0
        for t in tensors:
            arrays.append(arr[at:at + t.numel()].reshape(tuple(t.shape)))
            at += t.numel()
        return ckpt_lib.tree_of(state.step, leaves, arrays), ready

    def due(self, global_step: int) -> bool:
        """True when ``global_step`` crossed a cadence boundary.

        Crossing, not equality: with multi-step windows the host sees steps
        only at window boundaries, so cadence 50 with 24-step windows fires
        at 72, 120, … — every boundary past a multiple of 50."""
        if self.every_steps <= 0:
            return False
        prev = self._last_step if self._last_step >= 0 else 0
        return global_step // self.every_steps > prev // self.every_steps

    def rewind(self, global_step: int) -> None:
        """Reset the cadence marker after the step clock was rewound (a
        resume or a rollback), so `due` compares against the new clock."""
        self._last_step = int(global_step)

    def maybe(self, state, global_step: int,
              meta: dict[str, Any] | None = None) -> Path | None:
        """Snapshot iff the cadence is due; returns the path when taken."""
        if not self.due(global_step):
            return None
        return self.snapshot(state, global_step, meta)

    def snapshot(self, state, global_step: int,
                 meta: dict[str, Any] | None = None) -> Path | None:
        """Unconditional snapshot of ``state`` at ``global_step``: the host
        copy is enqueued now, encode and IO are asynchronous. Rank 0 writes;
        a sharded state's gather is a collective the other ranks join here.
        A failed handoff degrades (returns None)."""
        self._last_step = int(global_step)
        if process_index() != 0:
            if getattr(state.optimizer, "is_sharded_update", False):
                state.optimizer.gather_state()
            return None
        t0 = time.perf_counter()
        tree, ready = self._host_copy(state)
        meta = dict(meta or {})
        meta.setdefault("kind", "snapshot")
        meta["global_step"] = int(global_step)
        try:
            out = self._mgr.save(state, meta, step=int(global_step),
                                 host_tree=tree, ready=ready)
        except (RuntimeError, OSError) as e:
            # Degrade, don't end the run: the cadence marker is set, so the
            # next crossing tries again.
            self._record_write_error(int(global_step), e)
            return None
        self.last_blocking_ms = 1e3 * (time.perf_counter() - t0)
        _counters.inc("snapshot.writes")
        _counters.inc("snapshot.write_s", self.last_blocking_ms / 1e3)
        return out

    @staticmethod
    def _record_write_error(global_step: int, err: BaseException) -> None:
        _counters.inc("snapshot.write_errors")
        flightrec.record("snapshot_write_error", step=global_step,
                         error=str(err)[:300])
        log.warning("snapshot write at step %d failed (%s) — training "
                    "continues; the cadence re-arms at its next crossing",
                    global_step, err)

    def latest_dir(self) -> Path | None:
        return self._mgr.latest_dir()

    def restore(self, target):
        return self._mgr.restore(target)

    def wait(self) -> None:
        """Join the in-flight write; raises its failure."""
        t0 = time.perf_counter()
        self._mgr.wait()
        _counters.inc("snapshot.wait_s", time.perf_counter() - t0)

    def close(self) -> None:
        """Join and tear down; a failed in-flight write degrades here
        (counted and logged: masking a propagating training error with a
        disk error would be worse). Callers that need the commit call
        `wait`, which raises."""
        try:
            self._mgr.close()
        except (RuntimeError, OSError) as e:
            self._record_write_error(self._last_step, e)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

