"""Resilience of the port (of `tpu_dp.resilience`): step snapshots, the
preemption handler and resume, the IO retry budget and deterministic
fault injection. The guard (ROADMAP Queue 1 item 9c) and elastic world
size (item 9d) are not ported yet."""

from tpu_dp_torch.resilience.faultinject import (
    KILL_EXIT_CODE,
    FaultInjector,
    FaultPlan,
)
from tpu_dp_torch.resilience.preempt import (
    PREEMPTED_EXIT_CODE,
    PreemptedError,
    PreemptionHandler,
    find_candidates,
    quarantine_save_dir,
    resume_latest,
)
from tpu_dp_torch.resilience.retry import (
    PeerFailedError,
    configure_io_retry,
    io_retry_params,
    retry_call,
)
from tpu_dp_torch.resilience.snapshot import SnapshotManager

__all__ = ["KILL_EXIT_CODE", "PREEMPTED_EXIT_CODE", "FaultInjector",
           "FaultPlan", "PeerFailedError", "PreemptedError",
           "PreemptionHandler", "SnapshotManager", "configure_io_retry",
           "find_candidates", "io_retry_params", "quarantine_save_dir",
           "resume_latest", "retry_call"]
