"""Live efficiency accounting of the port: per-program FLOP costs, MFU,
goodput (the port of `tpu_dp.obs.costs`).

The `Trainer` registers one optimizer step's per-card cost in the
process-wide `registry` under the program tags its loop dispatches
(``train_step``, ``multi_step``, ``resident_loop[w<n>]``) and publishes
rolling ``obs.mfu`` / ``obs.goodput`` / ``obs.step_time_ms`` gauges per
dispatched window (`EfficiencyMeter`).

Definitions (the JAX package's):

- **MFU** = flops_per_step_per_chip x steps / wall_s / peak_flops(card),
  the peak the dense bf16 one of `tpu_dp_torch.obs.chips` for f32 runs
  too. Wall time is the window's boundary-to-boundary host time: at
  ``train.obs=full`` the window ends on a device fence, so this is device
  time; at ``basic`` it is a dispatch rate, which tracks the device rate
  only under sustained backpressure.
- **goodput** = 1 - data_wait / window_wall: the share of wall time not
  spent blocked on the input feed.

The cost of a step is the analytic per-model count
(`MODEL_TRAIN_FLOPS_PER_IMAGE`) or, with ``obs.measure_flops=true``, one
train step counted by `torch.utils.flop_counter.FlopCounterMode`
(`count_train_flops`, the port's counterpart of the JAX package's XLA
cost analysis), checked against the analytic count within
`FLOPS_CHECK_RTOL` by `resolve_flops_per_step`.

Import-light on purpose (torch only inside `count_train_flops`): the
registry is consulted by post-hoc tooling with no card attached.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

from tpu_dp_torch.obs import chips as _chips
from tpu_dp_torch.obs.spans import percentile

#: Analytic conv+dot FLOPs for one *trained* image, by model name (per
#: layer MAC counts x ~3 for the backward pass; the JAX package's table).
#: Models not listed have no analytic yardstick: their MFU needs a measured
#: cost (``obs.measure_flops=true``).
MODEL_TRAIN_FLOPS_PER_IMAGE = {
    "resnet18": 3.0e9,
    "resnet50": 7.0e9,
}

#: +-35%: covers backward-pass accounting slop, not 30x
#: (`resolve_flops_per_step`).
FLOPS_CHECK_RTOL = 1.35


def peak_flops(device_name: str) -> float | None:
    """Dense bf16 FLOP/s for a device name, or None when unknown
    (delegates to the `tpu_dp_torch.obs.chips` registry)."""
    return _chips.peak_flops(device_name)


def train_flops_per_image(model_name: str) -> float | None:
    """Analytic trained-image FLOPs for a known model name, else None."""
    return MODEL_TRAIN_FLOPS_PER_IMAGE.get(str(model_name).lower())


def serve_flops_per_image(model_name: str) -> float | None:
    """Analytic forward-only FLOPs per image (~training/3: the backward
    pass costs ~2 forwards; serving runs only the forward)."""
    trained = train_flops_per_image(model_name)
    return None if trained is None else trained / 3.0


def resolve_flops_per_step(program_flops, step_flops, window, per_chip_batch,
                           flops_per_image):
    """Per-optimizer-step per-card FLOPs for MFU, with the JAX package's
    resolution order and check (all inputs and the result per card):

    1. ``step_flops``: the measured count of one train step (here
       `count_train_flops`), with no loop and so no ambiguity;
    2. ``program_flops``: a windowed program's count, read as-is or
       divided by ``window``, whichever lies closer in log-space to the
       analytic count;
    3. the analytic count itself (check "unverified").

    Returns (flops_per_step, source, check); check is "ok" when the
    resolved value agrees with the analytic count within
    `FLOPS_CHECK_RTOL`, else "mismatch:analytic_ratio=R" ("unchecked" with
    no analytic yardstick; (None, "unavailable", "unavailable") with
    nothing at all).
    """
    analytic = (
        None if flops_per_image is None
        else float(flops_per_image) * per_chip_batch
    )
    if step_flops:
        resolved, source = float(step_flops), "w1_step_cost_analysis"
    elif program_flops:
        body = float(program_flops)
        divided = float(program_flops) / max(int(window), 1)
        if analytic is None:
            return body, "scan_cost_analysis_body", "unchecked"
        resolved = min((body, divided),
                       key=lambda f: abs(math.log(f / analytic)))
        source = ("scan_cost_analysis_body" if resolved == body
                  else "scan_cost_analysis_divided")
    elif analytic is not None:
        return analytic, "analytic", "unverified"
    else:
        return None, "unavailable", "unavailable"
    if analytic is None:
        return resolved, source, "unchecked"
    ratio = resolved / analytic
    check = ("ok" if 1 / FLOPS_CHECK_RTOL <= ratio <= FLOPS_CHECK_RTOL
             else f"mismatch:analytic_ratio={ratio:.3g}")
    return resolved, source, check


def count_train_flops(model, images, labels) -> float:
    """FLOPs of one train step's forward and backward of ``model`` on
    ``images`` / ``labels`` (the softmax cross-entropy loss), counted by
    `torch.utils.flop_counter.FlopCounterMode` on the meta device, so no
    card and no memory is needed.

    ``model`` must run its plain path (``fused_stages`` off): the counter
    sees the ATen ops, not the FLOPs inside the conv kernel's
    `torch.autograd.Function`s, and the plain path computes the same
    function. ``images`` is ``[B, H, W, C]``; the model is copied to the
    meta device and left as it was.
    """
    import copy

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    meta = copy.deepcopy(model).to("meta").train()
    x = torch.empty(images.shape, dtype=torch.float32, device="meta")
    y = torch.empty(labels.shape, dtype=torch.int64, device="meta")
    with FlopCounterMode(display=False) as counter:
        logits = meta(x).float()
        loss = torch.nn.functional.cross_entropy(logits, y)
        loss.backward()
    return float(counter.get_total_flops())


def goodput(data_wait_ms: float, window_ms: float) -> float:
    """1 - data_wait/window: the non-input-starved fraction of wall time."""
    if window_ms <= 0:
        return 0.0
    return max(0.0, min(1.0, 1.0 - float(data_wait_ms) / float(window_ms)))


@dataclasses.dataclass(frozen=True)
class ProgramCost:
    """One program's per-optimizer-step per-card FLOP cost."""

    tag: str            # program tag, e.g. "train_step"
    flops_per_step_per_chip: float
    source: str         # w1_step_cost_analysis | scan_* | analytic
    check: str          # ok | unverified | unchecked | mismatch:...

    @property
    def measured(self) -> bool:
        return self.source != "analytic"


class CostRegistry:
    """Per-program cost registry, keyed by program tags. Measured entries
    outrank analytic estimates: an analytic `register` never overwrites a
    measured one."""

    def __init__(self):
        self._by_tag: dict[str, ProgramCost] = {}

    def register(self, tag: str, flops_per_step_per_chip: float | None,
                 source: str = "analytic",
                 check: str = "unverified") -> ProgramCost | None:
        """Record a program's cost; returns the registry's current entry
        (which may be a pre-existing measured one that outranks this)."""
        if not flops_per_step_per_chip:
            return self._by_tag.get(tag)
        cost = ProgramCost(str(tag), float(flops_per_step_per_chip),
                           str(source), str(check))
        cur = self._by_tag.get(tag)
        if cur is not None and cur.measured and not cost.measured:
            return cur
        self._by_tag[tag] = cost
        return cost

    def register_analytic(self, tag: str, model_name: str,
                          per_chip_batch: float) -> ProgramCost | None:
        """Analytic per-step cost for a known model, or None (unknown)."""
        per_image = train_flops_per_image(model_name)
        if per_image is None:
            return self._by_tag.get(tag)
        return self.register(tag, per_image * float(per_chip_batch),
                             source="analytic", check="unverified")

    def alias(self, tag: str, source_tag: str) -> ProgramCost | None:
        """Register ``tag`` with ``source_tag``'s cost (one optimizer step
        costs the same whether dispatched alone, windowed or resident)."""
        src = self._by_tag.get(source_tag)
        if src is None:
            return None
        cost = dataclasses.replace(src, tag=str(tag))
        self._by_tag[tag] = cost
        return cost

    def get(self, tag: str) -> ProgramCost | None:
        return self._by_tag.get(tag)

    def tags(self) -> list[str]:
        return sorted(self._by_tag)

    def mfu(self, tag: str, n_steps: float, elapsed_s: float,
            peak: float | None) -> float | None:
        """Model FLOPs utilization of ``n_steps`` of ``tag`` over
        ``elapsed_s`` against ``peak``; None when anything is unknown."""
        cost = self._by_tag.get(tag)
        if cost is None or not peak or elapsed_s <= 0:
            return None
        return cost.flops_per_step_per_chip * float(n_steps) / float(
            elapsed_s
        ) / float(peak)

    def reset(self) -> None:
        """Drop everything — test isolation only."""
        self._by_tag.clear()


#: The process-wide registry the trainer publishes from.
registry = CostRegistry()


class EfficiencyMeter:
    """Rolling window-level MFU / goodput / step-time accounting: `observe`
    once per dispatched window (its boundary-to-boundary wall time and its
    measured data_wait) returns the window's gauges; `rollup` summarizes
    the ring for epoch records and the CLI's summary."""

    def __init__(self, registry_: CostRegistry | None = None,
                 peak: float | None = None, capacity: int = 4096):
        self.registry = registry if registry_ is None else registry_
        self.peak = peak
        self._win: deque[dict] = deque(maxlen=max(1, int(capacity)))

    def observe(self, tag: str, n_steps: int, window_wall_ms: float,
                data_wait_ms: float) -> dict:
        """Account one dispatched window; returns the window's gauges."""
        n = max(1, int(n_steps))
        wall_ms = max(1e-6, float(window_wall_ms))
        out = {
            "step_time_ms": round(wall_ms / n, 3),
            "goodput": round(goodput(data_wait_ms, wall_ms), 4),
        }
        mfu = self.registry.mfu(tag, n, wall_ms / 1e3, self.peak)
        if mfu is not None:
            out["mfu"] = round(mfu, 4)
        cost = self.registry.get(tag)
        if cost is not None:
            out["flops_per_step_per_chip"] = cost.flops_per_step_per_chip
        self._win.append({"n": n, **out})
        return out

    def rollup(self) -> dict | None:
        """Percentile/mean summary over the ring (None before any window)."""
        if not self._win:
            return None
        step_ms = sorted(w["step_time_ms"] for w in self._win)
        total_steps = sum(w["n"] for w in self._win)
        wsum = lambda k: sum(  # noqa: E731  (step-weighted means)
            w[k] * w["n"] for w in self._win if k in w
        )
        wn = lambda k: sum(w["n"] for w in self._win if k in w)  # noqa: E731
        out = {
            "windows": len(self._win),
            "steps": total_steps,
            "goodput": round(wsum("goodput") / max(1, wn("goodput")), 4),
            "step_time_ms": {
                "p50": round(percentile(step_ms, 50), 3),
                "p95": round(percentile(step_ms, 95), 3),
                "p99": round(percentile(step_ms, 99), 3),
                "mean": round(sum(step_ms) / len(step_ms), 3),
                "max": round(step_ms[-1], 3),
            },
        }
        n_mfu = wn("mfu")
        if n_mfu:
            out["mfu"] = round(wsum("mfu") / n_mfu, 4)
        costs = {w.get("flops_per_step_per_chip") for w in self._win
                 if "flops_per_step_per_chip" in w}
        if costs:
            out["flops_per_step_per_chip"] = max(costs)
        return out

    def reset(self) -> None:
        self._win.clear()
