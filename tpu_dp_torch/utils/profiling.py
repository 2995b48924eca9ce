"""Profiler hooks of the port: `torch.profiler` Chrome traces, whole-run or
over a step range (the port of `tpu_dp.utils.profiling`).

``train.profile_dir`` alone traces the whole of `Trainer.fit`;
``train.profile_steps=START:END`` with it traces only that range of global
optimizer steps (`StepProfiler`). The artifact is a Chrome-trace JSON,
``<profile_dir>/trace_r<rank:05d>.json`` (chrome://tracing, ui.perfetto.dev),
not the TensorBoard directory `jax.profiler` writes. On a card the
profiler records CUDA activity only: with CPU and CUDA activities
together it loses device records (`tools/port_profiler_loss.py`). On the
CPU it records CPU activity, and on a card under gloo both (the comm
attribution reads gloo's collectives from the CPU ops,
`tpu_dp_torch.obs.kineto`).

On a card a session opens and closes with a spin bracket: `PROFILE_LEAD_IN`
spin kernels of `PROFILE_SPIN_CYCLES` each (`torch.cuda._sleep`), waited
for, right after it starts and again before it stops, after the device
drained. Without them a session loses the records of the first kernels it
sees (`tools/port_profiler_loss.py`) and of the last
(`tools/port_profiler_drops.py`); the trace parser leaves the spins out.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Callable

#: spin kernels launched at the start of a session on a card, before the
#: work it records, and again at its end, after it; each spins
#: `PROFILE_SPIN_CYCLES` clock cycles (about a quarter of a millisecond at
#: the H100's clock).
PROFILE_LEAD_IN = 64
PROFILE_SPIN_CYCLES = 500_000


def spin_bracket() -> None:
    """`PROFILE_LEAD_IN` spin kernels on the current stream, waited for,
    after everything queued before them on the card."""
    import torch

    torch.cuda.synchronize()
    for _ in range(PROFILE_LEAD_IN):
        torch.cuda._sleep(PROFILE_SPIN_CYCLES)
    torch.cuda.synchronize()


def parse_profile_steps(spec: str | None) -> tuple[int, int] | None:
    """``"START:END"`` → (start, end); empty/None → None.

    Global optimizer steps, half-open [START, END): profiling starts at
    the first host boundary where the step count reaches START and stops
    at the first boundary ≥ END. Validated eagerly so a typo fails at
    config time, not hours in at step START.
    """
    spec = (spec or "").strip()
    if not spec:
        return None
    start_s, sep, end_s = spec.partition(":")
    try:
        if not sep:
            raise ValueError
        start, end = int(start_s), int(end_s)
    except ValueError:
        raise ValueError(
            f"train.profile_steps must be START:END (global steps), "
            f"got {spec!r}"
        ) from None
    if start < 0 or end <= start:
        raise ValueError(
            f"train.profile_steps needs 0 <= START < END, got {spec!r}"
        )
    return start, end


class ChromeTrace:
    """One `torch.profiler` session at a time, exported as a Chrome trace:
    `start` (``trace_dir``) begins recording, `stop` ends it and writes
    ``<trace_dir>/trace_r<rank:05d>.json`` (``path``). CUDA activity only
    on a card (with ``cpu`` CPU activity too: gloo's collectives), CPU
    activity on the CPU; on a card inside the spin bracket (module
    doc)."""

    def __init__(self, rank: int = 0, cuda: bool = True, cpu: bool = False):
        self.rank = int(rank)
        self.cuda = bool(cuda)
        self.cpu = bool(cpu) or not self.cuda
        self.path: Path | None = None
        self._prof = None

    def start(self, trace_dir: str) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.path = Path(trace_dir) / f"trace_r{self.rank:05d}.json"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        acts = ([ProfilerActivity.CUDA] if self.cuda else []) + (
            [ProfilerActivity.CPU] if self.cpu else [])
        self._prof = profile(activities=acts)
        self._prof.start()
        if self.cuda:
            spin_bracket()

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        if self.cuda:
            spin_bracket()
        prof.stop()
        prof.export_chrome_trace(str(self.path))


@contextlib.contextmanager
def profile_trace(trace_dir: str | None, tracer: ChromeTrace):
    """Trace the enclosed region into ``trace_dir`` with ``tracer`` when
    set; no-op otherwise."""
    if not trace_dir:
        yield
        return
    tracer.start(trace_dir)
    try:
        yield
    finally:
        tracer.stop()


class StepProfiler:
    """Start/stop a trace over a global-step range.

    Two trainer hooks bracket each dispatched window:
    :meth:`on_window_start` (BEFORE dispatch, with the steps the window
    is about to run) arms the trace as soon as a window overlaps
    [start, end) — arming only after a window completes would trace the
    window *after* the requested one, and a range that fits inside a
    single window would be skipped entirely; :meth:`on_step` (after the
    window, with the completed step count) stops it once step END-1 has
    run. The profiler arms once (a second pass over the range after e.g.
    a resume does not re-trace — one artifact per run). With windowed
    dispatch the realized range snaps outward to window boundaries: a
    replayed CUDA graph cannot be cut mid-window.

    ``start_fn``/``stop_fn`` begin and end the trace (the trainer's
    `ChromeTrace`; tests inject their own). Arm/stop transitions are recorded as flight-recorder
    ``profile_start``/``profile_stop`` events carrying the trace dir and
    step range (and ``label``: "commprof" for the comm attribution's
    windows), so a captured trace is discoverable from the run's
    artifacts alone.
    """

    def __init__(
        self,
        trace_dir: str,
        start_step: int,
        end_step: int,
        start_fn: Callable[[str], None],
        stop_fn: Callable[[], None],
        label: str = "profile",
    ):
        if not trace_dir:
            raise ValueError(
                "profile_steps needs train.profile_dir for the trace output"
            )
        self.trace_dir = trace_dir
        self.start_step = int(start_step)
        self.end_step = int(end_step)
        self._start = start_fn
        self._stop = stop_fn
        self.label = str(label)
        self.active = False
        self.done = False

    def _record(self, kind: str, step: int) -> None:
        from tpu_dp_torch.obs import flightrec

        flightrec.record(kind, step=step, label=self.label,
                         trace_dir=str(self.trace_dir),
                         start_step=self.start_step,
                         end_step=self.end_step)

    def on_window_start(self, first_step: int, n_steps: int) -> None:
        """About to dispatch steps [first_step, first_step + n_steps):
        arm the trace if the window overlaps the requested range."""
        if self.done or self.active:
            return
        if first_step >= self.end_step:
            self.done = True  # range skipped entirely (e.g. resume past it)
            return
        last = first_step + max(1, n_steps) - 1
        if last >= self.start_step:
            self._start(self.trace_dir)
            self.active = True
            self._record("profile_start", first_step)

    def on_step(self, global_step: int) -> None:
        """``global_step`` steps have completed; stop once the range has
        fully executed (its last step is END - 1, half-open range)."""
        if self.active and global_step >= self.end_step - 1:
            self._stop()
            self.active = False
            self.done = True
            self._record("profile_stop", global_step)

    def close(self) -> None:
        """Stop an armed trace (end of training inside the range)."""
        if self.active:
            self._stop()
            self.active = False
            self.done = True
            self._record("profile_stop", self.end_step - 1)
