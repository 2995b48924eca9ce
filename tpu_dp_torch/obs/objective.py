"""Objective extraction from fenced BENCH records — the tuner's score (the
port of `tpu_dp.obs.objective`, for the tune harness's port, ROADMAP
Queue 1 item 12).

The tune harness ranks configs by numbers, and the numbers must be the SAME
ones the rest of the observability stack gates on: throughput is the
BENCH headline (``value``, img/s/chip), goodput is the CostRegistry
gauge `obsctl diff` compares, and the tie-breaker is commprof's
byte-exact ``exposed_comm_ms``. Keeping the extraction here (not inside
tune) means a schema change to the BENCH record has exactly one place to
break, next to the code that reads the record everywhere else.

Stdlib-only, like the rest of the parsing half of this package.
"""

from __future__ import annotations

from typing import Any, Mapping

#: objective name -> (record path, human unit). "throughput" is the
#: BENCH headline; "goodput" prefers the run that wastes the least of
#: the hardware it was given (arXiv:2204.06514's framing).
OBJECTIVES = ("throughput", "goodput")

#: Ties within this relative window fall through to the tie-breaker.
TIE_FRAC = 0.03

#: The tie-breaker signal: of two configs with the same headline, the
#: one exposing less communication has more headroom left for bigger
#: models/batches on the same topology (docs/TUNE.md).
TIEBREAK_SIGNAL = "exposed_comm_ms"


def trial_signals(record: Mapping[str, Any]) -> dict[str, Any]:
    """The obsctl-unit signal dict of one fenced BENCH record: the keys
    `obsctl diff`'s verdict machinery compares, plus the throughput
    headline under its archive name."""
    latency = record.get("latency") or {}
    comm = record.get("comm") or {}
    return {
        "img_per_sec_per_chip": record.get("value"),
        "mfu": record.get("mfu"),
        "goodput": record.get("goodput"),
        "p95_ms": latency.get("p95_ms"),
        "comm_ms": comm.get("comm_ms"),
        "exposed_comm_ms": comm.get("exposed_comm_ms"),
        "overlap_frac": comm.get("overlap_frac"),
    }


def objective_value(record: Mapping[str, Any],
                    objective: str = "throughput") -> float | None:
    """The scalar the tuner maximizes, or None when the record cannot
    support the objective (a failed trial scores None and loses to any
    measured one — never ranks as a silent zero)."""
    if objective not in OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r} (known: "
            f"{', '.join(OBJECTIVES)})")
    sig = trial_signals(record)
    value = (sig["img_per_sec_per_chip"] if objective == "throughput"
             else sig["goodput"])
    return None if value is None else float(value)


def tiebreak_value(record: Mapping[str, Any]) -> float:
    """Lower wins. A record with no comm attribution ties LAST — a
    config that cannot show its exposed-comm number must not win the
    tie on missing evidence."""
    v = trial_signals(record).get(TIEBREAK_SIGNAL)
    return float("inf") if v is None else float(v)


def is_tied(a: float, b: float, tie_frac: float = TIE_FRAC) -> bool:
    """Whether two objective values are within the tie window."""
    return abs(a - b) <= tie_frac * max(abs(a), abs(b), 1e-12)
