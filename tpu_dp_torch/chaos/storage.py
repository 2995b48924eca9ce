"""Storage-fault shim: deterministic disk failures at the IO seams (port of
`tpu_dp.chaos.storage`, which the port never imports). Its seams are the
port's checkpoint and snapshot writes and the membership ledger's writes
and reads. The JAX package's text follows.

The fault domain `TPU_DP_FAULT` could not reach before this module: the
whole recovery story (tmp+rename snapshots, the ``latest`` pointer, the
membership ledger) trusts the filesystem, and a dying host does not. The
shim is armed by `resilience.faultinject.FaultInjector` when a
storage plan's step boundary is reached, and consulted by exactly three
seams:

- ``on_write(path)`` — immediately before a checkpoint/snapshot payload
  or ledger file is written (`checkpoint._atomic_write_state`,
  the membership ledger's atomic/exclusive writes). ``ioerr`` fails the
  next ``n`` calls with a transient ``EIO`` (the retry budgets must
  absorb it); ``enospc`` fails every later call with ``ENOSPC`` (the
  degrade paths must absorb *that*).
- ``on_read(path)`` — before a ledger read (`elastic._read_json`).
  ``slowfs`` sleeps ``ms`` per read, stressing the jittered retry
  schedule and the protocol poll loops above it.
- ``post_commit(step_dir)`` — after a save's BOTH renames landed.
  ``torn`` truncates the committed payload (both files exist, so only a
  parse/checksum can reveal the tear — defeating per-file atomicity
  exactly like a dying host does); ``bitrot`` flips bytes inside the
  committed payload (silent corruption only the checksum manifest can
  catch). One-shot: the first commit after arming is the victim.

Everything is no-op-cheap when nothing is armed; the seams reach the
shim through ``sys.modules`` so production processes never import it.
The shim never touches jax and is safe from the async checkpoint writer
thread (state transitions are single-word flag flips).
"""

from __future__ import annotations

import errno
import logging
import os
import time
from pathlib import Path

from tpu_dp_torch.obs import flightrec as _flightrec
from tpu_dp_torch.obs.counters import counters as _counters

logger = logging.getLogger(__name__)

#: the payload file post_commit corrupts (checkpoint._CKPT_NAME;
#: named here literally so the shim stays import-free of checkpoint).
_PAYLOAD_NAME = "state.msgpack"


class StorageFaultShim:
    """Armed storage faults, applied at the IO seams (one shim/process)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._ioerr_left = 0
        self._enospc = False
        self._slowfs_ms = 0.0
        self._slowfs_left: int | None = None  # None = unbounded
        self._torn_pending = False
        self._bitrot_pending = False
        self.active = False

    def _update_active(self) -> None:
        self.active = bool(
            self._ioerr_left or self._enospc or self._slowfs_ms
            or self._torn_pending or self._bitrot_pending
        )

    # -- arming (FaultInjector.on_step at the plan's boundary) -----------

    def arm(self, plan) -> None:
        """Arm one storage `FaultPlan` (kind in ``STORAGE_KINDS``)."""
        kind = plan.kind
        if kind == "ioerr":
            self._ioerr_left += max(1, int(plan.count))
        elif kind == "enospc":
            self._enospc = True
        elif kind == "slowfs":
            self._slowfs_ms = float(plan.delay_ms) or 50.0
            self._slowfs_left = int(plan.count) or None
        elif kind == "torn":
            self._torn_pending = True
        elif kind == "bitrot":
            self._bitrot_pending = True
        else:
            raise ValueError(f"not a storage fault kind: {kind!r}")
        self._update_active()
        _counters.inc("chaos.storage_armed")
        _flightrec.record("storage_fault_armed", step=plan.step,
                         fault=kind)

    # -- the seams -------------------------------------------------------

    def on_write(self, path: str | os.PathLike) -> None:
        """Checkpoint/snapshot/ledger write seam; may raise OSError."""
        if not self.active:
            return
        if self._enospc:
            _counters.inc("chaos.storage_faults")
            _flightrec.record("storage_fault", fault="enospc",
                             path=str(path))
            raise OSError(errno.ENOSPC,
                          f"injected ENOSPC (chaos) writing {path}")
        if self._ioerr_left > 0:
            self._ioerr_left -= 1
            self._update_active()
            _counters.inc("chaos.storage_faults")
            _flightrec.record("storage_fault", fault="ioerr",
                             path=str(path))
            raise OSError(errno.EIO,
                          f"injected transient EIO (chaos) writing {path}")

    def on_read(self, path: str | os.PathLike) -> None:
        """Ledger read seam: ``slowfs`` latency."""
        if not self.active or not self._slowfs_ms:
            return
        if self._slowfs_left is not None:
            if self._slowfs_left <= 0:
                self._slowfs_ms = 0.0
                self._update_active()
                return
            self._slowfs_left -= 1
        _counters.inc("chaos.storage_slow_reads")
        time.sleep(self._slowfs_ms / 1000.0)

    def post_commit(self, step_dir: str | os.PathLike) -> None:
        """Corrupt a JUST-COMMITTED save (``torn``/``bitrot``), one-shot."""
        if not self.active or not (self._torn_pending
                                   or self._bitrot_pending):
            return
        payload = Path(step_dir) / _PAYLOAD_NAME
        if not payload.exists():
            return
        if self._torn_pending:
            self._torn_pending = False
            size = payload.stat().st_size
            with open(payload, "r+b") as f:
                f.truncate(max(1, size // 2))
            kind = "torn"
        else:
            self._bitrot_pending = False
            with open(payload, "r+b") as f:
                f.seek(max(0, payload.stat().st_size // 2))
                byte = f.read(1) or b"\x00"
                f.seek(-len(byte), os.SEEK_CUR)
                f.write(bytes([byte[0] ^ 0xFF]))
            kind = "bitrot"
        self._update_active()
        _counters.inc("chaos.storage_faults")
        _flightrec.record("storage_fault", fault=kind,
                         path=str(payload))
        logger.warning("chaos: %s injected into committed save %s",
                       kind, payload)


#: The process-wide shim `FaultInjector` arms and the IO seams consult.
shim = StorageFaultShim()
