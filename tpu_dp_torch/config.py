"""Serving configuration of the port (the part of `tpu_dp.config` the
serving slice reads): the `ServeConfig` fields `InferenceEngine` takes and
the two SLO-class parsers. Defaults are the JAX package's."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ServeConfig:
    """Batched-inference serving (`tpu_dp_torch.serve`)."""

    # Padded batch-size ladder: every formed batch is zero-padded up to one
    # of these sizes, so the forward only ever sees these shapes.
    buckets: str = "1,2,4,8,16,32"
    # Dynamic-batching latency cap: dispatch when the pending work fills
    # the largest bucket OR the oldest request has waited this long.
    max_wait_ms: float = 5.0
    # Queue bound (requests): past this depth `submit` sheds "queue_full",
    # lowest SLO class first.
    max_queue: int = 256
    # Per-request latency target; attainment is reported from the spans.
    slo_ms: float = 50.0
    # A request whose deadline budget is already below this is shed at
    # admission (reason "deadline").
    shed_headroom_ms: float = 0.0
    # Per-SLO-class latency targets, class 0 first, e.g. "50,100,250".
    class_slo_ms: str = ""


def parse_class_slo_ms(spec: str) -> dict[int, float]:
    """Parse `ServeConfig.class_slo_ms`: per-class targets, class 0 first."""
    spec = (spec or "").strip()
    if not spec:
        return {}
    try:
        return {i: float(s) for i, s in enumerate(spec.split(","))}
    except ValueError:
        raise ValueError(
            f"class_slo_ms must be comma-separated milliseconds, got {spec!r}"
        ) from None


def parse_class_floors(spec: str) -> dict[int, float]:
    """Parse `ServeConfig.class_floors`: ``class:attainment`` pairs."""
    spec = (spec or "").strip()
    if not spec:
        return {}
    out = {}
    for item in spec.split(","):
        cls, sep, floor = item.partition(":")
        try:
            if not sep:
                raise ValueError
            out[int(cls)] = float(floor)
        except ValueError:
            raise ValueError(
                f"class_floors must be class:attainment pairs, got {spec!r}"
            ) from None
    return out
