"""Synthetic load generation: Poisson/burst/diurnal arrivals + the

Copy of the JAX package's module of the same name (host code); the
PyTorch port never imports the JAX package.
ground-truth audit that makes chaos testable.

Serving behavior under heavy traffic AND injected failure must be testable
on the CPU backend (the same 8-virtual-device trick the training tests
use), so the load generator is deterministic-seeded and keeps its own
books: every submit outcome (accepted / shed-with-reason) and every handle
resolution (completed / shed / deadline-missed, per SLO class, per model
version) is counted caller-side, then compared **exactly** against the
engine's `tpu_dp_torch.obs` counters and the device-side donated stats. A
telemetry number that can drift from ground truth is worse than no number
— the audit is the test, and it must hold through replica failover, drain,
rejoin and hot swap (`tests/test_serve_elastic.py`,
`tools/run_tier1.sh --serve-elastic`).

Arrival patterns:

- ``poisson`` — exponential inter-arrival gaps at ``rate_rps`` (the
  classic open-loop model of independent user traffic);
- ``burst``   — groups of ``burst`` requests arriving back-to-back,
  separated by the idle gap that keeps the same average rate (the pattern
  that actually exercises queue-depth shedding and big buckets);
- ``diurnal`` — Poisson with the rate swept through one trough→peak→trough
  cycle across the run (peak = ``rate_rps``, trough = 25% of it) — the
  compressed day of traffic a serving tier must ramp across.

Requests are "mixed-size" (1..max(sizes) images, drawn from ``sizes``) and
optionally mixed-class (``class_mix``): the dynamic batcher's coalescing,
the queue's class-ordered dispatch, and lowest-class-first shedding all
see realistic variety. ``events`` injects scenario actions (hot swap,
drain, rejoin, SIGTERM) at exact request indices, so a chaos matrix is a
list of (index, label, callable) — deterministic where it matters.
"""

from __future__ import annotations

import time

import numpy as np

from tpu_dp_torch.serve.queue import ShedError

ARRIVAL_PATTERNS = ("poisson", "burst", "diurnal")

#: diurnal trough rate as a fraction of the peak ``rate_rps``.
DIURNAL_TROUGH = 0.25


def arrival_offsets(n: int, pattern: str, rate_rps: float, burst: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Arrival times (seconds from start) for ``n`` requests."""
    if pattern not in ARRIVAL_PATTERNS:
        raise ValueError(
            f"pattern must be one of {ARRIVAL_PATTERNS}, got {pattern!r}"
        )
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be positive, got {rate_rps}")
    if n <= 0:
        return np.zeros((0,))
    if pattern == "poisson":
        gaps = rng.exponential(1.0 / rate_rps, size=n)
        gaps[0] = 0.0
        return np.cumsum(gaps)
    if pattern == "diurnal":
        # One trough→peak→trough cycle over the request sequence: the
        # i-th gap is drawn at the instantaneous rate of that phase of
        # the "day", so density ramps up to rate_rps mid-run and back.
        phase = np.sin(np.pi * (np.arange(n) + 0.5) / n) ** 2
        rates = rate_rps * (DIURNAL_TROUGH + (1.0 - DIURNAL_TROUGH) * phase)
        gaps = rng.exponential(1.0 / rates)
        gaps[0] = 0.0
        return np.cumsum(gaps)
    # burst: k back-to-back arrivals, then one gap sized to hold the rate.
    burst = max(1, int(burst))
    offsets = np.zeros(n)
    t = 0.0
    for i in range(n):
        if i and i % burst == 0:
            t += burst / rate_rps
        offsets[i] = t
    return offsets


def _empty_class_truth() -> dict:
    return {"submitted": 0, "accepted": 0, "completed": 0, "shed": 0,
            "deadline_missed": 0}


def run_load(
    engine,
    n_requests: int = 200,
    pattern: str = "poisson",
    rate_rps: float = 400.0,
    sizes=(1, 2, 3, 4),
    burst: int = 8,
    slo_ms: float | None = None,
    seed: int = 0,
    wait_timeout_s: float = 60.0,
    class_mix=None,
    class_slo_ms: dict[int, float] | None = None,
    events=None,
) -> dict:
    """Drive ``engine`` (an `InferenceEngine` OR a `ServeCluster`) with
    synthetic traffic; return the audited report.

    The engine must already be started. ``class_mix`` is an optional
    probability vector over SLO classes (class i with probability
    ``class_mix[i]``; default: everything class 0); ``class_slo_ms``
    overrides the per-class latency budget at submit. ``events`` is a
    list of ``(request_index, label, fn)``: ``fn()`` runs immediately
    before submitting that request — the scenario-matrix hook for hot
    swaps, drains, rejoins and signals (each firing is stamped into
    ``report["load"]["events"]``).

    Returns the engine's `report()` extended with the loadgen's
    ``ground_truth`` block and ``consistent`` — True iff the engine's
    serve counters match the caller-side books exactly (accepted,
    completed, shed total and per-reason, deadline_missed, AND each of
    those per SLO class) and the device-side served count across every
    replica equals the images actually served — zero dropped, zero
    double-served, through whatever the events/faults did to the tier.
    """
    rng = np.random.default_rng(seed)
    offsets = arrival_offsets(n_requests, pattern, rate_rps, burst, rng)
    sizes = tuple(int(s) for s in sizes)
    req_sizes = rng.choice(sizes, size=n_requests)
    if class_mix is not None:
        mix = np.asarray(list(class_mix), dtype=float)
        if mix.ndim != 1 or mix.size == 0 or (mix < 0).any() or \
                not np.isclose(mix.sum(), 1.0):
            raise ValueError(
                f"class_mix must be a probability vector, got {class_mix!r}"
            )
        req_classes = rng.choice(mix.size, size=n_requests, p=mix)
    else:
        req_classes = np.zeros(n_requests, dtype=int)
    class_slo_ms = dict(class_slo_ms or {})
    shape = engine.queue.image_shape
    dtype = engine.queue.image_dtype
    if np.issubdtype(dtype, np.integer):
        payloads = [
            rng.integers(0, 256, size=(k,) + shape).astype(dtype)
            for k in req_sizes
        ]
    else:
        payloads = [
            rng.standard_normal((k,) + shape).astype(dtype)
            for k in req_sizes
        ]
    fired_events = []
    events_at: dict[int, list] = {}
    for idx, label, fn in (events or ()):
        events_at.setdefault(int(idx), []).append((str(label), fn))

    before = {
        k: v for k, v in engine._counters.snapshot().items()
        if k.startswith("serve.")
    }
    served_before = engine.device_stats()["served"]

    handles = []
    truth = {
        "submitted": n_requests,
        "accepted": 0,
        "shed": 0,
        "shed_by_reason": {},
        "completed": 0,
        "deadline_missed": 0,
        "images_submitted": int(req_sizes.sum()),
        "images_served": 0,
        "by_class": {},
        "served_by_version": {},
    }
    by_class = truth["by_class"]
    t_start = time.perf_counter()
    for i in range(n_requests):
        for label, fn in events_at.get(i, ()):
            fired_events.append({
                "at_request": i, "label": label,
                "t_s": round(time.perf_counter() - t_start, 3),
            })
            fn()
        delay = t_start + float(offsets[i]) - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        cls = int(req_classes[i])
        cb = by_class.setdefault(cls, _empty_class_truth())
        cb["submitted"] += 1
        budget = class_slo_ms.get(cls, slo_ms)
        try:
            handles.append(
                (i, engine.submit(payloads[i], slo_ms=budget, slo_class=cls))
            )
            truth["accepted"] += 1
            cb["accepted"] += 1
        except ShedError as e:
            truth["shed"] += 1
            cb["shed"] += 1
            truth["shed_by_reason"][e.reason] = (
                truth["shed_by_reason"].get(e.reason, 0) + 1
            )

    deadline = time.perf_counter() + wait_timeout_s
    unresolved = 0
    for i, h in handles:
        cb = by_class[int(req_classes[i])]
        if not h.wait(max(0.0, deadline - time.perf_counter())):
            unresolved += 1
            continue
        if h.ok:
            truth["completed"] += 1
            cb["completed"] += 1
            truth["images_served"] += h.n
            truth["deadline_missed"] += int(h.deadline_missed)
            cb["deadline_missed"] += int(h.deadline_missed)
            if h.model_version is not None:
                truth["served_by_version"][str(h.model_version)] = (
                    truth["served_by_version"].get(str(h.model_version), 0)
                    + 1
                )
        else:
            truth["shed"] += 1
            cb["shed"] += 1
            truth["shed_by_reason"][h.shed_reason] = (
                truth["shed_by_reason"].get(h.shed_reason, 0) + 1
            )
    # An ADMITTED request may be evicted by a later higher-class submit
    # (lowest-class-first queue_full shedding): it was counted accepted at
    # submit and resolves shed afterwards. Both sides of the audit see it
    # exactly once in each role, so the books still reconcile — but note
    # accepted != completed + shed as *disjoint outcomes*; the invariant
    # is submitted == completed + shed + unresolved.
    truth["unresolved"] = unresolved
    wall_s = time.perf_counter() - t_start

    report = engine.report()
    after = report["counters"]

    def delta(name: str) -> float:
        return after.get(name, 0.0) - before.get(name, 0.0)

    per_class_consistent = all(
        delta(f"serve.accepted.c{cls}") == cb["accepted"]
        and delta(f"serve.completed.c{cls}") == cb["completed"]
        and delta(f"serve.shed.c{cls}") == cb["shed"]
        and delta(f"serve.deadline_missed.c{cls}") == cb["deadline_missed"]
        for cls, cb in by_class.items()
    )
    consistent = (
        unresolved == 0
        and delta("serve.accepted") == truth["accepted"]
        and delta("serve.completed") == truth["completed"]
        and delta("serve.shed") == truth["shed"]
        and delta("serve.deadline_missed") == truth["deadline_missed"]
        and all(
            delta(f"serve.shed.{reason}") == count
            for reason, count in truth["shed_by_reason"].items()
        )
        and per_class_consistent
        and report["device_stats"]["served"] - served_before
        == truth["images_served"]
    )
    report["load"] = {
        "pattern": pattern,
        "rate_rps": rate_rps,
        "sizes": list(sizes),
        "burst": burst if pattern == "burst" else None,
        "class_mix": None if class_mix is None else [float(m) for m in mix],
        "seed": seed,
        "wall_s": round(wall_s, 3),
        "offered_rps": round(n_requests / wall_s, 1) if wall_s else None,
        "events": fired_events,
    }
    report["ground_truth"] = truth
    report["consistent"] = bool(consistent)
    return report
