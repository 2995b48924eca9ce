"""Resume of the port (the part of `tpu_dp.resilience` that resume needs)."""

from tpu_dp_torch.resilience.preempt import (
    find_candidates,
    quarantine_save_dir,
    resume_latest,
)

__all__ = ["find_candidates", "quarantine_save_dir", "resume_latest"]
