"""Configuration of the port (the parts of `tpu_dp.config` it reads).

Training: the `ModelConfig` / `DataConfig` / `OptimConfig` /
`TrainConfig` / `ParallelConfig` / `ResilienceConfig` / `GuardConfig` /
`ObsConfig` fields the trainer implements, the presets and `parse_cli`
(``--preset=name`` or ``--config=file``, ``--resume``, then
``--section.field=value``), with the JAX package's defaults and preset
values. Every other field the JAX package knows is listed in `NOT_PORTED`
with its default: setting one away from its default raises
`NotPortedError` — a knob is never silently ignored.
`Config.to_dict` writes every section of the JAX package's config (the
unported fields at their defaults), so a checkpoint's ``meta.json`` loads
in either package, and `Config.from_dict` reads one.

Serving: the `serve` section (`ServeConfig`, every field of the JAX
package's, read by `InferenceEngine` and `ServeCluster`) and the two
SLO-class parsers.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence


class NotPortedError(ValueError):
    """A configuration the JAX package runs and the port does not yet."""


@dataclass
class ModelConfig:
    name: str = "net"  # net | resnet18 | resnet50
    num_classes: int | None = None  # None = derive from dataset; set = must agree
    bf16: bool = False  # compute dtype bfloat16 (params stay f32)
    # Stages whose stride-1 blocks run on the fused conv kernel: "" (off),
    # "all", or comma-separated stage indices. Fused activations round
    # through bfloat16 inside the kernel, as in the JAX package.
    fused_stages: str = ""
    fused_bwd: bool = False  # route the backward input-grad conv through it too


@dataclass
class DataConfig:
    dataset: str = "cifar10"  # cifar10 | cifar100 | synthetic
    root: str = "./data"
    batch_size: int = 4
    shuffle: bool = True
    augment: bool = False  # on-device random crop + flip
    drop_remainder: bool = True
    prefetch: int = 2  # batches placed ahead of the consumer
    synthetic_train_size: int | None = None
    synthetic_test_size: int | None = None
    allow_synthetic: bool = True
    # Stage the whole train set on the device once and feed each window
    # only int32 indices, gathered on the device inside the step.
    # "auto": on when the train set fits resident_max_bytes and
    # drop_remainder holds; "on"/"off" force it.
    device_resident: str = "auto"  # auto | on | off
    resident_max_bytes: int = 512 * 1024 * 1024
    # Block on every placed batch or window (a measurement escape hatch:
    # the copy then no longer overlaps the step).
    sync_placement: bool = False


@dataclass
class OptimConfig:
    lr: float = 0.001
    momentum: float = 0.9
    weight_decay: float = 0.0
    # Exclude biases + norm scale/bias from decay.
    decay_exclude_bias_and_norm: bool = False
    schedule: str = "constant"  # constant | cosine
    warmup_epochs: float = 0.0
    final_lr: float = 0.0
    # Microbatches per optimizer update (needs data.drop_remainder).
    grad_accum_steps: int = 1


@dataclass
class TrainConfig:
    epochs: int = 2
    log_every: int = 2000
    seed: int = 0
    eval_at_end: bool = True
    eval_every_epochs: int = 0  # 0 = only at end
    pallas_xent: bool = False  # the fused softmax-xent kernels
    # Updates per dispatch: on a card a replayed CUDA graph of K updates;
    # 0 = auto (min(24, steps per epoch) with data.drop_remainder, else 1).
    steps_per_call: int = 1
    # RecompileGuard over the window programs: a capture after the first
    # is a retrace, "warn"ed or "raise"d; "off" leaves them unwrapped.
    recompile_guard: str = "warn"  # off | warn | raise
    ckpt_dir: str = "./checkpoints"
    ckpt_keep: int = 3  # retained epoch checkpoints (0 = keep all)
    ckpt_async: bool = True  # write checkpoints on a worker thread
    resume: bool = False  # continue from the newest usable save
    # The cross-replica sharded weight update: "replicated" (DDP's
    # gradient all-reduce, the full update on every rank) or "sharded"
    # (reduce-scatter, the update on 1/world of the parameters and
    # momentum per rank, all-gather of the parameters).
    update_sharding: str = "replicated"
    # Wire format of the sharded update's gradient reduce-scatter: "" (f32),
    # "bf16" (half the bytes) or "int8" (blockwise absmax-scaled, with
    # error-feedback residuals).
    collective_dtype: str = ""
    # Elements per f32 scale of the int8 wire.
    quant_block_size: int = 256
    # Target MB of f32 gradient per exchange of the sharded update (one
    # collective set per bucket, reverse leaf order); 0 = one exchange.
    bucket_mb: float = 0.0
    # torch.profiler Chrome traces into this dir when set: the whole of
    # fit, or only train.profile_steps.
    profile_dir: str | None = None
    # Runtime telemetry (`tpu_dp_torch.obs`). "off": the untelemetered
    # loop. "basic": per-window data_wait/dispatch spans, efficiency
    # gauges, cross-rank heartbeats, no added host synchronisation.
    # "full": adds the h2d and fence-to-fence device spans (one CUDA-event
    # synchronize per window) and one metrics.jsonl record per update.
    obs: str = "off"  # off | basic | full
    # metrics.jsonl sink ("" = <train.ckpt_dir>/metrics.jsonl).
    metrics_path: str = ""
    # Step-ranged profiling: "START:END" global steps traced into
    # train.profile_dir (which must be set) instead of the whole run.
    profile_steps: str = ""


@dataclass
class ParallelConfig:
    """The process group (`tpu_dp_torch.parallel.dist.initialize`); unset
    fields come from the launcher's env contract."""

    # One process drives one device: None (or 1) only.
    num_devices: int | None = None
    # host:port of rank 0's rendezvous (tcp://), or an init-method URL.
    coordinator_address: str | None = None
    num_processes: int | None = None  # the world size
    process_id: int | None = None  # this process's rank


@dataclass
class ResilienceConfig:
    """The resilience fields (`tpu_dp_torch.resilience`), the JAX
    package's, with its defaults."""

    # Snapshot cadence in optimizer steps; 0 = off (the epoch checkpoint
    # still runs, and a preemption's final snapshot still lands).
    snapshot_every_steps: int = 0
    snapshot_keep: int = 2  # retained step snapshots
    snapshot_dir: str = ""  # "" = <train.ckpt_dir>/snapshots
    # SIGTERM/SIGINT → final snapshot → barrier → exit 143 during fit().
    handle_signals: bool = True
    # Bounded exponential backoff of the preemption barrier.
    max_retries: int = 2
    retry_base_delay_s: float = 0.05
    # Deterministic fault injection (tests only), e.g. "kill:step=13" or
    # a ';'-composed schedule (`resilience.faultinject`).
    fault: str = ""
    # Total backoff budget (s) of every checkpoint, snapshot and
    # membership-ledger write.
    io_retry_s: float = 3.1
    # Elastic world size (`tpu_dp_torch.resilience.elastic`): a rank that
    # announces its departure (SIGTERM, preempt:, leave:, relaunch:) or
    # vanishes leaves, the survivors regroup at world N-1, reshard and
    # re-split the epoch; a joiner grows the world back. Needs
    # data.drop_remainder and a filesystem under train.ckpt_dir that every
    # rank shares.
    elastic: bool = False
    # Membership-ledger directory ("" = <train.ckpt_dir>/membership).
    membership_dir: str = ""
    # Bound on every regroup phase (quiesce collection, epoch-record wait,
    # the new group's rendezvous).
    regroup_timeout_s: float = 60.0
    # Ledger-poll cadence in optimizer steps (crossing discipline).
    elastic_poll_every_steps: int = 1
    # Refuse to regroup below this world size (survivors raise instead).
    elastic_min_world: int = 1
    # Host the new leader advertises for the regrouped rendezvous ("" =
    # loopback when the run started on it, else the hostname).
    elastic_coordinator_host: str = ""
    # The JAX package's collective-schedule fingerprint check after a
    # regroup; HLO-based there, so an elastic run here needs it false
    # (its stand-in is ROADMAP Queue 1 item 13).
    elastic_verify_fingerprint: bool = True
    # The grow: whether a starting process JOINS a live run through the
    # membership ledger instead of starting one. "auto": join when the
    # newest generation's record does not list this rank's stable id (a
    # relaunched departed rank); "always": join or raise a typed error
    # (an explicit relaunch); "never": the classic bootstrap only.
    elastic_join: str = "auto"  # auto | always | never
    # Bound on the joiner's admission wait per attempt (0 =
    # regroup_timeout_s). The members bound the handshake by
    # regroup_timeout_s either way: a joiner that never comes costs them
    # the join-ready wait, then they re-form at world N.
    elastic_join_timeout_s: float = 0.0
    # Refuse to grow beyond this world size (0 = unbounded): a join past it
    # is refused with a typed reason on the ledger.
    elastic_max_world: int = 0


@dataclass
class GuardConfig:
    """Training guardrails (`tpu_dp_torch.resilience.guard`): the
    NaN/divergence sentinel on the device, bad-batch quarantine, the
    cross-replica SDC audit and auto-rollback; the JAX package's fields
    and defaults."""

    # Master switch: the sentinel in every train step (the health summary
    # and the guarded update on the device) and the policy at window
    # boundaries. Off, the step is the unguarded one, bit for bit.
    enabled: bool = False
    # warn | skip | rollback | halt: "skip" quarantines the batch (its
    # update withheld on the device), "rollback" rewinds to the newest
    # complete save, "halt" raises DivergedError (exit 65).
    action: str = "skip"
    # Spike detector: robust z-score over the trailing window of applied
    # steps, armed after spike_min_steps observations.
    spike_window: int = 64
    spike_z: float = 8.0
    spike_min_steps: int = 16
    # Under action=skip, arm the device-side loss cap from the window.
    device_cap: bool = True
    # Rollbacks without progress before the policy escalates to halt.
    max_rollbacks: int = 3
    # LR ease-in after a rollback: lr_ease_start back to 1.0 over
    # lr_ease_steps steps (0 = off).
    lr_ease_steps: int = 0
    lr_ease_start: float = 0.1
    # Cross-replica SDC audit cadence in optimizer steps (0 = off).
    sdc_every_steps: int = 0
    sdc_action: str = "halt"  # warn | halt
    # quarantine.jsonl sink ("" = <train.ckpt_dir>/quarantine.jsonl).
    quarantine_path: str = ""


@dataclass
class ObsConfig:
    """Telemetry tuning (`tpu_dp_torch.obs`; enabled by ``train.obs``),
    the JAX package's fields and defaults."""

    # Shared telemetry dir ("" = <train.ckpt_dir>/obs): heartbeat files,
    # the flight recorder's dumps and the Perfetto export land here.
    run_dir: str = ""
    # Span ring-buffer length (per-step records kept for rollups/export).
    span_capacity: int = 4096
    # Heartbeat cadence in optimizer steps (crossing discipline, like
    # snapshots); 0 disables heartbeats while keeping spans/counters.
    heartbeat_every_steps: int = 1
    # Straggler threshold: flagged when a rank's step time exceeds this
    # factor x the median of the other ranks at the same observation.
    straggler_factor: float = 3.0
    # Hang threshold: a heartbeat older than this is a stale/hung rank.
    stale_after_s: float = 60.0
    # Median floor (ms) of the straggler ratio's denominator.
    min_step_ms: float = 1.0
    # What rank 0 does when the monitor flags an issue: warn | raise.
    on_straggler: str = "warn"
    # Perfetto trace output ("" = <run_dir>/trace.perfetto.json), written
    # by rank 0 at the end of fit.
    perfetto_path: str = ""
    # Ring size of the always-on flight recorder; 0 disables it.
    flightrec_capacity: int = 2048
    # Prometheus text file ("" = off), rewritten at log boundaries, epoch
    # ends and exit; multi-process runs suffix it with .r<rank>.
    prom_path: str = ""
    # Peak FLOP/s override for MFU (0 = the card's dense bf16 peak from
    # `tpu_dp_torch.obs.chips`; unknown cards publish no MFU).
    peak_flops_override: float = 0.0
    # Count one train step's FLOPs (FlopCounterMode, on the plain path)
    # instead of the analytic per-model estimate.
    measure_flops: bool = False
    # In-run comm/compute attribution (`tpu_dp_torch.obs.commprof`):
    # "START:END" captures one torch.profiler window over those global
    # steps, "every:N[:W]" a W-step window (default 1) at every N-step
    # boundary. Each captured window is parsed into a per-collective
    # comm/compute/overlap breakdown, reconciled against the books of the
    # collectives that ran, and published as the obs.comm_ms /
    # obs.exposed_comm_ms / obs.overlap_frac gauges + a comm_profile
    # metrics event + <obs dir>/comm_report.json. Mutually exclusive with
    # train.profile_steps / train.profile_dir (profiler sessions cannot
    # nest). Rank 0 only.
    comm_profile_steps: str = ""
    # Capture-window trace root ("" = <obs run dir>/commprof); each
    # window lands in its own w<START> subdir.
    comm_profile_dir: str = ""


@dataclass
class ServeConfig:
    """Batched-inference serving (`tpu_dp_torch.serve`): the JAX package's
    fields, every one read by the port."""

    # Padded batch-size ladder: every formed batch is zero-padded up to one
    # of these sizes, each with its own serve program (on a card a CUDA
    # graph captured at warmup) — fixed shapes, so the RecompileGuard
    # stays silent.
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
    # Heartbeat directory ("" = disabled): per-batch heartbeats of the
    # single engine land here. The multi-replica tier uses run_dir.
    obs_dir: str = ""
    # Replica fan-out (`tpu_dp_torch.serve.router.ServeCluster`): N
    # replicas behind one shared admission queue, with heartbeat-derived
    # health, failover, drain/rejoin and hot swap.
    replicas: int = 1
    # Serving artifact root ("" = disabled): heartbeats and the fleet
    # streams under <run_dir>/obs, the serving membership ledger under
    # <run_dir>/membership/serve.
    run_dir: str = ""
    # A replica whose heartbeat is older than this WHILE it holds an
    # in-flight batch is quarantined until it beats again.
    stale_after_s: float = 2.0
    # Failover budget: retries of a dead replica's in-flight request on a
    # survivor before it is shed "replica_failed".
    max_retries: int = 1
    # Per-SLO-class latency targets, class 0 first, e.g. "50,100,250".
    class_slo_ms: str = ""
    # Per-class attainment floors, "0:0.9,1:0.5": the serve CLI exits 1
    # when a listed class completes below its floor.
    class_floors: str = ""
    # "START:END" batch indices traced by each replica with torch.profiler
    # into profile_dir/r<sid>.
    profile_batches: str = ""
    # Trace root for profile_batches (required with it).
    profile_dir: str = ""


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    guard: GuardConfig = field(default_factory=GuardConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)

    def override(self, dotted: str, value: str) -> None:
        """Apply one ``section.field=value`` override, coercing to the
        field's type; a known but unported knob set away from its default
        raises `NotPortedError`."""
        section_name, _, field_name = dotted.partition(".")
        if not field_name:
            raise ValueError(f"override {dotted!r} must be section.field")
        if dotted in NOT_PORTED:
            default = NOT_PORTED[dotted]
            if _coerce(value, default) != default:
                raise NotPortedError(
                    f"--{dotted}={value}: not ported to tpu_dp_torch yet "
                    f"(only the default {default!r} runs; "
                    f"{_roadmap(dotted)})")
            return
        if section_name not in _SECTIONS:
            raise ValueError(f"unknown config section {section_name!r}")
        section = getattr(self, section_name)
        if not hasattr(section, field_name):
            raise ValueError(f"no field {field_name!r} in {section_name}")
        current = getattr(section, field_name)
        setattr(section, field_name, _coerce(value, current))

    def to_dict(self) -> dict[str, Any]:
        """Every section and field of the JAX package's config: the port's
        values, the unported fields at their defaults."""
        out = dataclasses.asdict(self)
        for dotted, default in NOT_PORTED.items():
            section, _, name = dotted.partition(".")
            out[section][name] = default
        return out

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        """Rebuild from a `to_dict` dump of either package (a checkpoint's
        meta ``config``). Unknown sections and fields raise `ValueError`;
        an unported field away from its default raises `NotPortedError`;
        values are coerced to and checked against the field's type."""
        cfg = cls()
        for section_name, fields in d.items():
            if not isinstance(fields, dict):
                raise ValueError(f"config section {section_name!r} must be "
                                 f"an object, got {type(fields).__name__}")
            if section_name not in _SECTIONS:
                raise ValueError(f"unknown config section {section_name!r}")
            section = getattr(cfg, section_name)
            for name, value in fields.items():
                dotted = f"{section_name}.{name}"
                if dotted in NOT_PORTED:
                    _require_default(dotted, value, NOT_PORTED[dotted])
                    continue
                if not hasattr(section, name):
                    raise ValueError(
                        f"unknown field {name!r} in {section_name}")
                current = getattr(section, name)
                setattr(section, name, _typed(dotted, value, current))
        return cfg


_SECTIONS = ("model", "data", "optim", "train", "parallel", "resilience",
             "guard", "obs", "serve")

#: Fields of the ported sections that the port does not implement yet,
#: with the JAX package's defaults (the only values that run).
NOT_PORTED: dict[str, Any] = {
    # The TPU kernel's images per grid step (ResNet-18 and ResNet-50
    # alike); the Hopper kernel's tile is fixed by the shape (`conv_block.
    # tile_of`), so there is no per-block knob to give it and only the
    # automatic default runs.
    "model.fused_block_b": 0,
    "train.verify_fingerprint": False,
    "train.profile": "",
}

#: The ROADMAP Queue 1 item that ports each refused section or field
#: (longest matching prefix); `model.fused_block_b` stays refused by design.
_NOT_PORTED_ITEMS = {
    "train.profile": "12", "train.verify_fingerprint": "13",
}


def _roadmap(dotted: str) -> str:
    """Where the ROADMAP names the work that ports ``dotted``."""
    for key in (dotted, dotted.partition(".")[0]):
        if key in _NOT_PORTED_ITEMS:
            return f"ROADMAP Queue 1 item {_NOT_PORTED_ITEMS[key]}"
    return "ROADMAP.md"


def _coerce(value: str, current: Any):
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if current is None:
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
        return None if value.lower() in ("none", "null") else value
    return value


def _typed(dotted: str, value: Any, current: Any):
    """``value`` from a JSON config, coerced to ``current``'s type (a
    string as from the command line, an integral float as an int) and
    checked against it."""
    if isinstance(value, str) and current is not None and not isinstance(
            current, str):
        value = _coerce(value, current)
    elif (isinstance(current, int) and not isinstance(current, bool)
          and isinstance(value, float) and value.is_integer()):
        value = int(value)
    if current is None or value is None:
        ok = value is None or isinstance(value, (str, int, float, bool))
    elif isinstance(current, bool):
        ok = isinstance(value, bool)
    elif isinstance(current, float):
        ok = isinstance(value, (int, float)) and not isinstance(value, bool)
        value = float(value) if ok else value
    elif isinstance(current, int):
        ok = isinstance(value, int) and not isinstance(value, bool)
    else:
        ok = isinstance(value, type(current))
    if not ok:
        raise ValueError(f"{dotted}: {value!r} is not a "
                         f"{type(current).__name__}")
    return value


def _require_default(dotted: str, value: Any, default: Any) -> None:
    if _typed(dotted, value, default) != default:
        raise NotPortedError(
            f"{dotted}={value!r}: not ported to tpu_dp_torch yet (only the "
            f"default {default!r} runs; {_roadmap(dotted)})")


def check_ported(cfg: Config) -> Config:
    """Raise `NotPortedError` for a configuration the port cannot run
    (a model other than net, resnet18 and resnet50, more than one device
    per process), `ValueError` for one that is invalid (an enabled guard's
    knobs, `check_guard`; a ``nan:``/``spike:`` fault without the guard;
    a feed mode other
    than auto|on|off; the device-resident feed forced on, gradient
    accumulation or a window above 1, each with a ragged final batch;
    gradient accumulation below 1, a negative window; the sharded
    update's knobs as the JAX package refuses them; a telemetry mode
    other than off|basic|full, a step range without a trace dir; an
    elastic run with a ragged final batch), with the JAX package's
    messages; an elastic run with the fingerprint check on or under the
    guard is not ported yet."""
    if cfg.parallel.num_devices not in (None, 1):
        raise NotPortedError(
            f"parallel.num_devices={cfg.parallel.num_devices}: one "
            f"tpu_dp_torch process drives one device; run one process per "
            f"device (torchrun --nproc_per_node)")
    if cfg.model.name.lower() not in ("net", "resnet18", "resnet50"):
        raise NotPortedError(
            f"model.name={cfg.model.name!r}: tpu_dp_torch trains net, "
            f"resnet18 and resnet50 only so far (ROADMAP.md)")
    if cfg.data.device_resident not in ("auto", "off", "on"):
        raise ValueError(f"data.device_resident must be auto|on|off, got "
                         f"{cfg.data.device_resident!r}")
    if cfg.data.device_resident == "on" and not cfg.data.drop_remainder:
        raise ValueError(
            "data.device_resident=on requires data.drop_remainder=true")
    if cfg.optim.grad_accum_steps < 1:
        raise ValueError(f"optim.grad_accum_steps must be >= 1, got "
                         f"{cfg.optim.grad_accum_steps}")
    if cfg.optim.grad_accum_steps > 1 and not cfg.data.drop_remainder:
        raise ValueError("optim.grad_accum_steps > 1 requires "
                         "data.drop_remainder=true")
    if cfg.train.recompile_guard not in ("off", "warn", "raise"):
        raise ValueError(
            f"train.recompile_guard must be off|warn|raise, "
            f"got {cfg.train.recompile_guard!r}")
    if cfg.train.steps_per_call < 0:
        raise ValueError(f"train.steps_per_call must be >= 0 (0 = auto), "
                         f"got {cfg.train.steps_per_call}")
    if cfg.train.steps_per_call > 1 and not cfg.data.drop_remainder:
        raise ValueError("train.steps_per_call > 1 requires "
                         "data.drop_remainder=true")
    _check_elastic(cfg)
    _check_update_sharding(cfg.train)
    _check_telemetry(cfg)
    if cfg.guard.enabled:
        check_guard(cfg.guard)
    if cfg.resilience.fault:
        from tpu_dp_torch.resilience.faultinject import (
            FaultPlan,
            refuse_unported,
        )

        refuse_unported([p.kind for p in FaultPlan.parse_schedule(
            cfg.resilience.fault)], guard_enabled=cfg.guard.enabled)
    return cfg


def _check_elastic(cfg: Config) -> None:
    """An elastic run's checks: the JAX package's ``drop_remainder``
    refusal (its message), then what the port does not run yet: the
    HLO-based fingerprint check (item 13's stand-in)."""
    if not cfg.resilience.elastic:
        return
    if not cfg.data.drop_remainder:
        raise ValueError(
            "resilience.elastic requires data.drop_remainder=true "
            "(the mid-epoch re-split carries no weight masks)")
    if cfg.resilience.elastic_verify_fingerprint:
        raise NotPortedError(
            "resilience.elastic_verify_fingerprint=true: the JAX package's "
            "check is HLO-based and has no port yet (ROADMAP Queue 1 item "
            "13); run elastic with --resilience.elastic_verify_fingerprint"
            "=false")


def _check_telemetry(cfg: Config) -> None:
    """The JAX package's checks of the telemetry knobs, with its messages
    (its `Trainer`, `StepProfiler` and `commprof`): ``train.obs``, then
    ``train.profile_steps`` (its form, and ``train.profile_dir`` with it),
    then ``obs.comm_profile_steps`` (its form, and no ``train.profile_*``
    beside it)."""
    from tpu_dp_torch.obs.commprof import parse_comm_profile_steps
    from tpu_dp_torch.utils.profiling import parse_profile_steps

    if cfg.train.obs not in ("off", "basic", "full"):
        raise ValueError(
            f"train.obs must be off|basic|full, got {cfg.train.obs!r}")
    if (parse_profile_steps(cfg.train.profile_steps) is not None
            and not cfg.train.profile_dir):
        raise ValueError(
            "profile_steps needs train.profile_dir for the trace output")
    if parse_comm_profile_steps(cfg.obs.comm_profile_steps) is not None and (
            cfg.train.profile_steps or cfg.train.profile_dir):
        raise ValueError(
            "obs.comm_profile_steps cannot combine with "
            "train.profile_steps/train.profile_dir — jax.profiler "
            "sessions cannot nest, and the comm window replaces the "
            "undirected trace")


def check_guard(guard: GuardConfig) -> None:
    """The JAX package's checks of an enabled guard, in its order and with
    its messages (its `GuardHook` and `GuardPolicy`): ``sdc_action``,
    ``action``, ``spike_window``, ``spike_z``."""
    from tpu_dp_torch.resilience.guard import GuardPolicy

    if guard.sdc_action not in ("warn", "halt"):
        raise ValueError(
            f"guard.sdc_action must be warn|halt, got {guard.sdc_action!r}")
    GuardPolicy(action=guard.action, spike_window=guard.spike_window,
                spike_z=guard.spike_z)


def _check_update_sharding(train: TrainConfig) -> None:
    """The JAX package's checks of the sharded update's knobs, with its
    messages (`tpu_dp.train.trainer.Trainer`): a mode other than
    replicated|sharded, a wire dtype or buckets without the sharded
    update, a block size below 1, an unknown wire dtype, negative MB."""
    from tpu_dp_torch.parallel import bucketing, quant

    us = train.update_sharding
    if us not in ("replicated", "sharded"):
        raise ValueError(
            f"train.update_sharding must be replicated|sharded, got {us!r}")
    if train.collective_dtype and us != "sharded":
        raise ValueError(
            "train.collective_dtype applies to the sharded update's "
            "reduce-scatter; set train.update_sharding=sharded")
    if int(train.quant_block_size) < 1:
        raise ValueError(f"train.quant_block_size must be >= 1, got "
                         f"{train.quant_block_size}")
    quant.make_wire_codec(train.collective_dtype, train.quant_block_size)
    if bucketing.parse_bucket_mb(train.bucket_mb) and us != "sharded":
        raise ValueError(
            "train.bucket_mb applies to the sharded update's "
            "reduce-scatter; set train.update_sharding=sharded")


#: The coupled-knob regime `coupling_warning` warns about (the JAX
#: package's thresholds).
COUPLING_BUCKET_MB = 4.0
COUPLING_QUANT_BLOCK = 256


def coupling_warning(bucket_mb, quant_block_size,
                     collective_dtype) -> str | None:
    """The bucket/quant coupling guard of the JAX package: under the int8
    codec each bucket quantizes on its own, so a large bucket with large
    scaling blocks couples many MB of gradient to a few coarse scales (a
    quality cliff a throughput measurement cannot see). The warning
    string, or None when the combination is fine."""
    try:
        bucket = float(bucket_mb or 0.0)
        block = int(quant_block_size or 0)
    except (TypeError, ValueError):
        return None
    if (str(collective_dtype) in ("int8", "i8")
            and bucket >= COUPLING_BUCKET_MB
            and block >= COUPLING_QUANT_BLOCK):
        return (
            f"train.bucket_mb={bucket:g} with "
            f"train.quant_block_size={block} under the int8 codec: "
            f"buckets >= {COUPLING_BUCKET_MB:g} MB quantized with blocks "
            f">= {COUPLING_QUANT_BLOCK} share coarse absmax scales across "
            f"a large payload (outlier-widened scales + bucket-wide "
            f"error feedback); shrink quant_block_size or bucket_mb "
            f"(docs/TUNE.md \"Coupled knobs\")")
    return None


def _preset_reference_single() -> Config:
    """The reference's `Net`, batch 4, 2 epochs (reference parity)."""
    return Config()


def _preset_resnet18_cifar10() -> Config:
    """ResNet-18 on CIFAR-10, batch 128, SGD 0.1 with cosine + 1 warmup
    epoch, weight decay 5e-4, augmentation on."""
    c = Config()
    c.model = ModelConfig(name="resnet18", num_classes=10)
    c.data.batch_size = 128
    c.optim = OptimConfig(lr=0.1, momentum=0.9, weight_decay=5e-4,
                          schedule="cosine", warmup_epochs=1.0)
    c.data.augment = True
    c.train.epochs = 30
    return c


def _preset_resnet50_cifar100() -> Config:
    """ResNet-50 on CIFAR-100: the ResNet-18 preset with the model and
    the dataset changed."""
    c = _preset_resnet18_cifar10()
    c.model = ModelConfig(name="resnet50", num_classes=100)
    c.data.dataset = "cifar100"
    return c


# The JAX package's configs 4 and 5 name 8-chip layouts, and there one
# process drives every chip, so their data.batch_size (1024, 4096) is the
# global batch. A port process drives one card: these presets state the
# per-card batch of the 8-card layout (global / 8). At world 8 the global
# batch and the learning rate are the JAX package's; at any other world
# the global batch is batch_size x world (`Trainer.global_batch_size`).


def _preset_resnet18_8chip_gb1024() -> Config:
    """Data-parallel ResNet-18, global batch 1024 on 8 cards: 128 a card,
    lr 0.4, 5 warmup epochs, 50 epochs."""
    c = _preset_resnet18_cifar10()
    c.data.batch_size = 1024 // 8
    c.optim.lr = 0.4
    c.optim.warmup_epochs = 5.0
    c.train.epochs = 50
    return c


def _preset_bf16_cosine_gb4096() -> Config:
    """bf16 compute (parameters, classifier and loss in f32) with the
    cosine schedule, global batch 4096 on 8 cards: 512 a card, lr 1.6, 10
    warmup epochs, 60 epochs."""
    c = _preset_resnet18_8chip_gb1024()
    c.model.bf16 = True
    c.data.batch_size = 4096 // 8
    c.optim.lr = 1.6
    c.optim.warmup_epochs = 10.0
    c.train.epochs = 60
    return c


PRESETS = {
    "reference": _preset_reference_single,
    "resnet18_cifar10": _preset_resnet18_cifar10,
    "resnet50_cifar100": _preset_resnet50_cifar100,
    "resnet18_8chip_gb1024": _preset_resnet18_8chip_gb1024,
    "bf16_cosine_gb4096": _preset_bf16_cosine_gb4096,
}


def parse_cli(argv: Sequence[str]) -> Config:
    """``--preset=name`` or ``--config=file.json``, ``--resume``, then
    ``--section.field=value`` overrides, then `check_ported`.

    ``--config`` takes a bare `Config.to_dict` dump or a checkpoint's
    ``meta.json`` (its ``config``), of either package; the ``parallel``
    section is dropped (it describes the launch it came from). From a
    meta, an explicit ``--train.ckpt_dir`` or ``--train.resume=true`` is
    required: a reproduction must not write into the run it reproduces.
    ``--resume`` (``=auto|true|latest``) sets ``train.resume``. The JAX
    package's ``--profile`` raises `NotPortedError`."""
    cfg: Config | None = None
    from_meta = False
    overrides: list[tuple[str, str]] = []
    for arg in argv:
        if not arg.startswith("--"):
            raise ValueError(f"unexpected argument {arg!r}")
        key, _, value = arg[2:].partition("=")
        if key in ("preset", "config") and cfg is not None:
            raise ValueError("give at most one of --preset / --config")
        if key == "profile":
            raise NotPortedError(f"--{key}: not ported to tpu_dp_torch yet "
                                 f"({_roadmap('train.profile')})")
        if key == "preset":
            if value not in PRESETS:
                raise ValueError(
                    f"unknown preset {value!r}; available: {sorted(PRESETS)}")
            cfg = PRESETS[value]()
        elif key == "config":
            payload = json.loads(Path(value).read_text())
            if isinstance(payload.get("config"), dict):
                payload = payload["config"]  # a checkpoint's meta.json
                from_meta = True
            payload.pop("parallel", None)  # environment, not experiment
            cfg = Config.from_dict(payload)
        elif key == "resume":
            if value not in ("", "auto", "true", "1", "latest"):
                raise ValueError(
                    f"--resume takes auto|true|latest, got {value!r}")
            overrides.append(("train.resume", "true"))
        else:
            overrides.append((key, value))
    resume_on = any(k == "train.resume" and _coerce(v, False)
                    for k, v in overrides)
    new_ckpt_dir = any(k == "train.ckpt_dir" for k, _ in overrides)
    if from_meta and not (new_ckpt_dir or resume_on):
        raise ValueError(
            "reproducing from checkpoint meta.json writes checkpoints; pass "
            "--train.ckpt_dir=<new dir> (fresh reproduction) or "
            "--train.resume=true (continue in place) explicitly")
    cfg = cfg or Config()
    for key, value in overrides:
        cfg.override(key, value)
    return check_ported(cfg)


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
