"""Cross-replica-exact metrics of the port (copy of `tpu_dp.metrics`)."""

from tpu_dp_torch.metrics.metrics import Accuracy, Mean

__all__ = ["Accuracy", "Mean"]
