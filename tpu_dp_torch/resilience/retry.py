"""Bounded retry with exponential backoff + typed peer-failure errors
(copy of `tpu_dp.resilience.retry` for the PyTorch port, which never
imports the JAX package).

- :func:`retry_call` — one generic bounded-retry loop (exponential
  backoff, deterministic delays unless a caller asks for jitter);
- :func:`io_retry_schedule` / :func:`configure_io_retry` /
  :func:`io_retry_params` — the one shared-filesystem IO budget
  (``resilience.io_retry_s``) every checkpoint and snapshot write retries
  on;
- :class:`PeerFailedError` — the typed terminal error a resilient caller
  raises after retries are exhausted, with rank attribution.

Not carried over: `ResilientRing`, the JAX package's retrying host ring;
the port's cross-process collectives go through `torch.distributed`
(gloo on the host, NCCL on the cards).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Sequence

from tpu_dp_torch.obs.counters import counters as _counters

logger = logging.getLogger(__name__)


class PeerFailedError(RuntimeError):
    """A collective failed because a peer process is gone (or unreachable).

    Carries enough attribution for a supervisor to act: which rank saw the
    failure, the world size, and which peer ranks are suspect (for a ring,
    the immediate neighbors — the only ranks this process talks to).
    """

    def __init__(self, message: str, *, rank: int | None = None,
                 world: int | None = None,
                 suspect_ranks: Sequence[int] = ()):
        super().__init__(message)
        self.rank = rank
        self.world = world
        self.suspect_ranks = tuple(suspect_ranks)


def backoff_delays(retries: int, base_delay: float = 0.05,
                   max_delay: float = 2.0) -> list[float]:
    """The deterministic delay schedule retry_call sleeps through."""
    return [min(max_delay, base_delay * (2.0 ** i)) for i in range(retries)]


#: Default total backoff budget for shared-filesystem IO (seconds). The
#: 0.1+0.2+0.4+0.8+1.6 ≈ 3.1s schedule PR 12 hard-coded into the
#: membership ledger, now the single `resilience.io_retry_s` knob every
#: ledger AND checkpoint write derives its schedule from
#: (`io_retry_schedule`): long enough to absorb a real NFS server hiccup,
#: short enough that a genuinely dead disk surfaces inside one regroup
#: timeout.
DEFAULT_IO_RETRY_S = 3.1
_IO_BASE_DELAY_S = 0.1
_io_retry_total_s = DEFAULT_IO_RETRY_S


def io_retry_schedule(total_s: float, base_delay: float = _IO_BASE_DELAY_S,
                      max_delay: float = 2.0) -> tuple[int, float]:
    """``(retries, base_delay)`` whose exponential backoff sums ≤ total_s.

    Doubling from ``base_delay`` (capped at ``max_delay``) until the next
    sleep would overrun the budget — so ``total_s=3.1`` reproduces the
    historical 5-retry/0.1s schedule exactly, and a test passing
    ``io_retry_s=0.01`` gets a fast single-retry exhaustion.
    """
    retries, spent = 0, 0.0
    while True:
        nxt = min(max_delay, base_delay * (2.0 ** retries))
        if spent + nxt > float(total_s) + 1e-9:
            break
        spent += nxt
        retries += 1
    return max(1, retries), base_delay


def configure_io_retry(total_s: float) -> None:
    """Install the process-wide IO retry budget (``resilience.io_retry_s``,
    set once by the Trainer; `io_retry_params` serves every consumer)."""
    global _io_retry_total_s
    _io_retry_total_s = float(total_s) if total_s > 0 else DEFAULT_IO_RETRY_S


def io_retry_params() -> tuple[int, float]:
    """The configured ``(retries, base_delay)`` for one IO retry loop."""
    return io_retry_schedule(_io_retry_total_s)


def retry_call(
    fn: Callable[..., Any],
    *args: Any,
    retries: int = 3,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    retry_on: tuple[type[BaseException], ...] = (RuntimeError, OSError),
    describe: str = "",
    sleep: Callable[[float], None] = time.sleep,
    jitter: float = 0.0,
    **kwargs: Any,
) -> Any:
    """Call ``fn`` with up to ``retries`` retries and exponential backoff.

    ``retries`` counts *re*-tries: the function runs at most
    ``retries + 1`` times. Only ``retry_on`` exceptions are retried;
    anything else propagates immediately (a typed `PeerFailedError` from a
    nested resilient call is terminal by design — re-wrapping it in more
    retries would just multiply timeouts). The final failure re-raises the
    last exception; callers that want rank attribution catch it and raise
    `PeerFailedError` with their topology context.

    ``jitter`` adds up to that fraction of each delay, uniformly random.
    The default stays 0 (deterministic — multi-rank logs line up), but
    shared-filesystem callers (the elastic membership ledger) pass a
    nonzero jitter so every rank of a slice retrying the same NFS blip
    does not re-stampede the server on the identical schedule.
    """
    name = describe or getattr(fn, "__name__", repr(fn))
    delays = backoff_delays(retries, base_delay, max_delay)
    if jitter > 0.0:
        import random

        delays = [d * (1.0 + random.uniform(0.0, jitter)) for d in delays]
    last: BaseException | None = None
    for attempt in range(retries + 1):
        # Telemetry (obs.counters): every attempt counted; the split between
        # `retry.attempts` and `retry.retries` is what distinguishes "lots
        # of calls" from "calls that keep failing" in metrics.jsonl.
        _counters.inc("retry.attempts")
        try:
            return fn(*args, **kwargs)
        except PeerFailedError:
            raise  # already terminal + attributed
        except retry_on as e:
            last = e
            if attempt == retries:
                break
            _counters.inc("retry.retries")
            logger.warning(
                "%s failed (attempt %d/%d): %s — retrying in %.3fs",
                name, attempt + 1, retries + 1, e, delays[attempt],
            )
            sleep(delays[attempt])
    _counters.inc("retry.exhausted")
    raise last  # type: ignore[misc]
