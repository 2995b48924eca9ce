"""RecompileGuard: count a program's recompiles after warmup, at run time
(the port of the run-time half of `tpu_dp.analysis.recompile`).

A program that silently compiles anew turns a millisecond step into a
slow one with no error anywhere. In the JAX package the observable is a
jitted function's trace-cache size; in the port it is the number of CUDA
graphs a program has captured (`tpu_dp_torch.train.step.ServeGraph` for a
serve bucket, `MultiStep` for a training window), which both expose as
``_cache_size()``. Any growth after the warmup calls is a retrace: the
guard warns or raises with the count, and adds it to the process-wide
``recompile.retraces`` counter. On a program without a cache (``None``:
an eager step on the CPU) the guard is inert.

`tpu_dp_torch.train.trainer` wraps its window programs
(``train.recompile_guard``: warn|raise|off, unwrapped without
``data.drop_remainder``), and every serve replica its bucket programs.
The static DP305 pass waits for ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

from typing import Any, Callable


class RecompileError(RuntimeError):
    """A guarded step retraced after warmup with on_retrace='raise'."""


class RecompileGuard:
    """Wrap a compiled callable; count retraces after warmup; warn or raise.

    The callable's ``_cache_size()`` (captures, or a trace cache) is the
    retrace observable: any growth after the warmup calls means the
    program compiled again behind the caller's back.

    ``warmup_calls`` calls establish the baseline (1 for a fixed-shape
    step; more when the first calls legitimately compile variants).
    ``on_retrace``: "warn" logs through ``logger`` (default: stderr),
    "raise" raises `RecompileError` — CI's choice.
    """

    def __init__(
        self,
        fn: Callable,
        name: str | None = None,
        warmup_calls: int = 1,
        on_retrace: str = "warn",
        logger: Callable[[str], None] | None = None,
    ):
        if on_retrace not in ("warn", "raise"):
            raise ValueError(
                f"on_retrace must be warn|raise, got {on_retrace!r}"
            )
        self._fn = fn
        self.name = name or getattr(fn, "__name__", "jitted")
        self.warmup_calls = max(1, int(warmup_calls))
        self.on_retrace = on_retrace
        self._log = logger
        self.calls = 0
        self.retraces = 0
        self._baseline: int | None = None

    def _cache_size(self) -> int | None:
        probe = getattr(self._fn, "_cache_size", None)
        try:
            return int(probe()) if callable(probe) else None
        except Exception:
            return None

    def __call__(self, *args, **kwargs) -> Any:
        out = self._fn(*args, **kwargs)
        self.calls += 1
        size = self._cache_size()
        if size is None:
            return out
        if self.calls <= self.warmup_calls or self._baseline is None:
            self._baseline = max(self._baseline or 0, size)
        elif size > self._baseline:
            grew = size - self._baseline
            self._baseline = size
            self.retraces += grew
            # Retraces land in the process-wide registry, so metrics.jsonl
            # records carry the recompile count beside the step times.
            from tpu_dp_torch.obs.counters import counters

            counters.inc("recompile.retraces", grew)
            msg = (
                f"RecompileGuard({self.name}): {grew} retrace(s) after "
                f"warmup (call {self.calls}, trace cache now {size}) — an "
                f"argument's shape/dtype/weak-type changed across calls; "
                f"the step recompiled instead of hitting the cache"
            )
            if self.on_retrace == "raise":
                raise RecompileError(msg)
            if self._log is not None:
                self._log(msg)
            else:
                import sys

                print(msg, file=sys.stderr)
        return out

    def stats(self) -> dict:
        """BENCH/report block: calls, retraces, final cache size."""
        return {
            "name": self.name,
            "calls": self.calls,
            "retraces": self.retraces,
            "cache_size": self._cache_size(),
        }

    def __getattr__(self, item):
        # Transparent proxy for the wrapped program's attributes.
        return getattr(self._fn, item)
