"""Resilience of the port (of `tpu_dp.resilience`): step snapshots, the
preemption handler and resume, the IO retry budget, deterministic fault
injection and the training guard (the divergence policy, the quarantine
log and the SDC audit), and elastic world size, its shrink (graceful and
rollback) and its grow (`tpu_dp_torch.resilience.elastic`: the membership
ledger, the coordinator and the joiner's handshake)."""

from tpu_dp_torch.resilience.elastic import (
    ElasticCoordinator,
    ElasticError,
    JoinOutcome,
    MembershipLedger,
    MembershipRecord,
    QuiescePlan,
    ServeMembership,
    find_live_generation,
    maybe_join,
    request_join,
)
from tpu_dp_torch.resilience.faultinject import (
    GUARD_KINDS,
    KILL_EXIT_CODE,
    FaultInjector,
    FaultPlan,
)
from tpu_dp_torch.resilience.guard import (
    DIVERGED_EXIT_CODE,
    DivergedError,
    GuardPolicy,
    GuardTrigger,
    QuarantineLog,
    digest_of_sums,
    leaf_paths,
    live_records,
    params_checksum,
    robust_stats,
    sdc_verdict,
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

__all__ = ["DIVERGED_EXIT_CODE", "GUARD_KINDS", "KILL_EXIT_CODE",
           "PREEMPTED_EXIT_CODE", "DivergedError", "ElasticCoordinator",
           "ElasticError", "FaultInjector", "FaultPlan", "GuardPolicy",
           "GuardTrigger", "JoinOutcome", "MembershipLedger",
           "MembershipRecord", "PeerFailedError", "QuiescePlan",
           "PreemptedError", "PreemptionHandler", "QuarantineLog",
           "ServeMembership", "SnapshotManager", "configure_io_retry",
           "digest_of_sums", "find_candidates", "find_live_generation",
           "io_retry_params", "leaf_paths", "live_records", "maybe_join",
           "params_checksum", "quarantine_save_dir", "request_join",
           "resume_latest", "retry_call", "robust_stats", "sdc_verdict"]
