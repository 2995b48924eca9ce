"""Accuracy and Mean metric accumulators with exact global semantics (copy
of `tpu_dp.metrics.metrics` for the PyTorch port, which never imports the
JAX package).

The train and eval steps already return globally exact (correct, count)
scalars (every rank's batch reduced inside the step), so these host-side
accumulators only sum Python scalars: `torchmetrics.Accuracy(
dist_sync_on_step=True)` semantics with no extra collective per step, and
exact weighted loss means.
"""

from __future__ import annotations


class Accuracy:
    """Global top-1 accuracy from per-step (correct, count) scalars."""

    def __init__(self):
        self.correct = 0
        self.count = 0

    def update(self, correct, count) -> None:
        self.correct += int(correct)
        self.count += int(count)

    def compute(self) -> float:
        return self.correct / max(1, self.count)

    def reset(self) -> None:
        self.correct = 0
        self.count = 0


class Mean:
    """Weighted running mean (e.g. loss over examples)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value, weight=1) -> None:
        self.total += float(value) * int(weight)
        self.count += int(weight)

    def compute(self) -> float:
        return self.total / max(1, self.count)

    def reset(self) -> None:
        self.total = 0.0
        self.count = 0
