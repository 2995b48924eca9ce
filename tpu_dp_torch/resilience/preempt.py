"""Resume from the newest usable save (port of the resume half of
`tpu_dp.resilience.preempt`).

`find_candidates` lists the complete, unquarantined step directories of
the checkpoint root and the snapshot root, newest step first, epoch
checkpoints winning ties; each exclusion is logged with its reason.
`resume_latest` restores the best one; a candidate that fails its
checksums is quarantined (`quarantine_save_dir`) and the next older one
restores instead.

The snapshot cadence, the preemption handler and the rest of the JAX
package's resilience section are not ported yet (ROADMAP Queue 1 item 9):
the port reads snapshot-kind saves (``meta["kind"] == "snapshot"``) but
does not write them.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

from tpu_dp_torch import checkpoint as ckpt_lib
from tpu_dp_torch.checkpoint import QUARANTINED_MARKER
from tpu_dp_torch.obs.counters import counters as _counters

logger = logging.getLogger(__name__)


def quarantine_save_dir(step_dir: Path, reason: str) -> None:
    """Mark one save directory untrusted (idempotent)."""
    path = Path(step_dir) / QUARANTINED_MARKER
    if not path.exists():
        path.write_text(json.dumps({"reason": reason, "ts": time.time()})
                        + "\n")


def _skip_candidate(step_dir: Path, reason: str) -> None:
    _counters.inc("ckpt.skipped_candidates")
    logger.warning("resume candidate %s skipped: %s", step_dir, reason)


def _quarantine_reason(save_dir: Path) -> str:
    try:
        return json.loads((save_dir / QUARANTINED_MARKER).read_text()).get(
            "reason", "unspecified")
    except (OSError, ValueError):
        return "unspecified"


def find_candidates(ckpt_dir: str | Path,
                    snapshot_dir: str | Path | None = None
                    ) -> list[tuple[Path, int]]:
    """Every complete resumable save, best first: ``(dir, global_step)``,
    newest step first, epoch checkpoints before snapshots of the same
    step. Torn and quarantined dirs are excluded and logged. The flat
    pre-manager layout (``<ckpt_dir>/state.msgpack``) is the last resort."""
    ranked: list[tuple[int, int, Path]] = []  # (step, priority, dir)
    for priority, root in ((1, ckpt_dir), (0, snapshot_dir)):
        if root is None:
            continue
        for d in ckpt_lib.CheckpointManager(root).step_dirs():
            missing = ckpt_lib.missing_save_files(d)
            if missing:
                _skip_candidate(d, f"incomplete save (missing "
                                   f"{', '.join(missing)} — torn write)")
                continue
            if (d / QUARANTINED_MARKER).exists():
                _skip_candidate(d, f"quarantined: {_quarantine_reason(d)}")
                continue
            ranked.append((int(d.name.split("_")[1]), priority, d))
    out = [(d, step) for step, _, d in
           sorted(ranked, key=lambda c: (c[0], c[1]), reverse=True)]
    if not out and ckpt_lib.checkpoint_exists(ckpt_dir):
        flat = Path(ckpt_dir)
        if (flat / QUARANTINED_MARKER).exists():
            _skip_candidate(flat, f"quarantined: {_quarantine_reason(flat)}")
        else:
            out.append((flat, -1))
    return out


def resume_latest(target, ckpt_dir: str | Path,
                  snapshot_dir: str | Path | None = None):
    """Restore the newest usable save into ``target`` (a port
    `TrainState`); returns ``(target, meta, source_dir)``.

    Raises `FileNotFoundError` when there is nothing to resume from, and
    `RuntimeError` when every candidate is unreadable. A candidate that
    fails verification (`CorruptCheckpointError`) is quarantined; any
    other unreadable one is skipped with a warning; the next older one is
    tried. ``target`` is written only by a load that succeeds."""
    found = find_candidates(ckpt_dir, snapshot_dir)
    if not found:
        raise FileNotFoundError(
            f"nothing to resume from under {ckpt_dir}"
            + (f" or {snapshot_dir}" if snapshot_dir else ""))
    last_err: Exception | None = None
    for source, _ in found:
        try:
            state, meta = ckpt_lib.load_checkpoint(source, target)
            return state, meta, source
        except ckpt_lib.CorruptCheckpointError as e:
            last_err = e
            _counters.inc("ckpt.corrupt_candidates")
            quarantine_save_dir(source, f"checksum refusal: {e}")
            logger.warning("resume candidate %s failed checksum "
                           "verification (%s); quarantined, falling back to "
                           "the next older complete save", source, e)
        except (OSError, ValueError, KeyError) as e:
            last_err = e
            logger.warning("resume candidate %s is unreadable (%s); falling "
                           "back to the previous complete save", source, e)
    raise RuntimeError(
        f"every resume candidate under {ckpt_dir} is unreadable"
    ) from last_err
