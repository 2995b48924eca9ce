"""Images-per-second metering (port of `tpu_dp.utils.meter`).

Excludes a configurable number of warmup steps (cuDNN plans and the
kernels' first loads happen there). The fence is a device synchronize:
`mark` waits for the card (``torch.cuda.synchronize``) before it stamps
the end of measured work, so the rate is a throughput, not a dispatch
rate (PyTorch returns before the device finishes).
"""

from __future__ import annotations

import time

import torch


class ThroughputMeter:
    def __init__(self, warmup_steps: int = 2, device=None):
        # The measurement window opens at the warmup-th step's dispatch, so
        # at least one step must be excluded — a rate needs a start stamp.
        self.warmup_steps = max(1, warmup_steps)
        self.device = None if device is None else torch.device(device)
        self._steps = 0
        self._images = 0
        self._start: float | None = None
        self._last: float | None = None

    def step(self, batch_size: int) -> None:
        """Call after each dispatched step."""
        now = time.perf_counter()
        self._steps += 1
        if self._steps == self.warmup_steps:
            self._start = now
        elif self._steps > self.warmup_steps:
            self._images += batch_size
        self._last = now

    def mark(self, fenced: bool = False) -> float:
        """Wait until the card has finished the work queued so far (unless
        the caller ``fenced`` it already), then record 'now' as the end of
        measured work; returns that stamp (`time.perf_counter` seconds,
        the span recorder's clock: one fence, two consumers)."""
        if (not fenced and self.device is not None
                and self.device.type == "cuda"):
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._steps > self.warmup_steps:
            self._last = now
        return now

    @property
    def images_per_sec(self) -> float:
        if self._start is None or self._last is None:
            return 0.0
        elapsed = self._last - self._start
        return self._images / elapsed if elapsed > 0 else 0.0
