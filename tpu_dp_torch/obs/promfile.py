"""Prometheus text-format export of the counter registry — no server
(the port of `tpu_dp.obs.promfile`; the same format, names and prefix).

Fleet scrapers (node_exporter's textfile collector, the Prometheus
agent's file discovery) consume plain ``metric{labels} value`` files from
a well-known directory; writing one is the zero-dependency way to get
``obs.mfu`` / ``obs.goodput`` / the guard and elastic counters onto a
dashboard without running an HTTP endpoint inside the training process
(an in-process server is a thread, a port, and a failure mode the hot
loop does not need). The trainer rewrites the file atomically at log
boundaries, epoch ends, and on exit (`obs.prom_path`); a scraper that
reads mid-rewrite sees the previous complete file, never a torn one.

Format notes (the subset every Prometheus parser accepts):

- metric names are the registry's dotted names with non-alphanumerics
  mapped to ``_`` and a configurable prefix (default ``tpu_dp``);
- counters emit ``# TYPE ... counter``, gauges ``# TYPE ... gauge`` —
  the registry knows which is which (`Counters.snapshot_typed`);
- every sample carries the provided labels (the trainer stamps
  ``rank``), so one shared filesystem dir can hold every rank's file.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Mapping

from tpu_dp_torch.obs._atomic import atomic_write_text
from tpu_dp_torch.obs.counters import Counters
from tpu_dp_torch.obs.counters import counters as _global_counters

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(name: str, prefix: str) -> str:
    base = _NAME_RE.sub("_", name)
    if prefix:
        base = f"{prefix}_{base}"
    if base and base[0].isdigit():
        base = "_" + base
    return base


def _label_str(labels: Mapping[str, str] | None) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_NAME_RE.sub("_", str(k))}="{str(v)}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render_prom(counts: Mapping[str, float], gauges: Mapping[str, float],
                labels: Mapping[str, str] | None = None,
                prefix: str = "tpu_dp") -> str:
    """The exposition-format text for one registry snapshot."""
    lines: list[str] = []
    lbl = _label_str(labels)
    for kind, src in (("counter", counts), ("gauge", gauges)):
        for name in sorted(src):
            metric = _metric_name(name, prefix)
            lines.append(f"# TYPE {metric} {kind}")
            value = float(src[name])
            lines.append(f"{metric}{lbl} {value:g}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_promfile(path: str | os.PathLike,
                   registry: Counters | None = None,
                   labels: Mapping[str, str] | None = None,
                   prefix: str = "tpu_dp") -> Path:
    """Atomically (re)write ``path`` with the registry's current state."""
    reg = _global_counters if registry is None else registry
    counts, gauges = reg.snapshot_typed()
    text = render_prom(counts, gauges, labels=labels, prefix=prefix)
    return atomic_write_text(path, text)


def parse_promfile(text: str) -> dict[str, dict]:
    """Parse exposition text back to ``{metric: {"type", "samples"}}``
    (tests and tools — not a general Prometheus parser, just the subset
    `render_prom` emits)."""
    out: dict[str, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            out.setdefault(name, {"type": kind.strip(), "samples": {}})
            continue
        if line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, _, label = head.partition("{")
        rec = out.setdefault(name, {"type": "untyped", "samples": {}})
        rec["samples"]["{" + label if label else ""] = float(value)
    return out
