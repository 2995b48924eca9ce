"""Learning-rate schedules (port of `tpu_dp.train.schedule`).

Plain functions of the step counter. Each computes in float32, operation
for operation as the JAX package's traced version does, so the port's
learning rate for update k is the JAX schedule's value at k. Each also
names the step from which its value no longer changes (``constant_from``),
so `lr_table` can hold the whole schedule on the device: the train step
reads the rate there at its device step counter, without the host.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

Schedule = Callable[[int], float]

_f32 = np.float32


def constant_lr(lr: float) -> Schedule:
    """lr forever."""
    value = float(_f32(lr))

    def schedule(step: int) -> float:
        return value

    schedule.constant_from = 0
    return schedule


def cosine_lr(
    base_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    final_lr: float = 0.0,
) -> Schedule:
    """Linear warmup 0→base over `warmup_steps`, cosine decay to `final_lr`."""

    def schedule(step: int) -> float:
        s = _f32(step)
        if s < warmup_steps:
            return float(_f32(base_lr) * s / _f32(max(1.0, warmup_steps)))
        decay = _f32(max(1.0, total_steps - warmup_steps))
        t = min(max((s - _f32(warmup_steps)) / decay, _f32(0)), _f32(1))
        cos = _f32(math.cos(_f32(math.pi) * t))
        return float(_f32(final_lr)
                     + _f32(0.5 * (base_lr - final_lr)) * (_f32(1) + cos))

    # t reaches 1 here and stays there.
    schedule.constant_from = math.ceil(
        warmup_steps + max(1.0, total_steps - warmup_steps))
    return schedule


def make_schedule(
    name: str,
    base_lr: float,
    total_steps: int = 0,
    warmup_steps: int = 0,
    final_lr: float = 0.0,
) -> Schedule:
    if name == "constant":
        return constant_lr(base_lr)
    if name == "cosine":
        return cosine_lr(base_lr, total_steps, warmup_steps, final_lr)
    raise ValueError(f"unknown schedule {name!r}")


def lr_table(schedule: Schedule, device=None) -> torch.Tensor:
    """The schedule as an f32 tensor on ``device``: ``table[k] ==
    float32(schedule(k))`` for k up to ``schedule.constant_from``, whose
    value every later step shares, so a lookup clamps its index to the
    last entry."""
    n = int(getattr(schedule, "constant_from", -1)) + 1
    if n < 1:
        raise ValueError("lr_table needs a schedule from make_schedule "
                         "(one that names its constant_from step)")
    return torch.tensor([schedule(k) for k in range(n)],
                        dtype=torch.float32, device=device)
