"""Configuration of the port (the parts of `tpu_dp.config` it reads).

Training: the `ModelConfig` / `DataConfig` / `OptimConfig` /
`TrainConfig` / `ParallelConfig` fields the trainer implements, the presets and `parse_cli`
(``--preset=name`` or ``--config=file``, ``--resume``, then
``--section.field=value``), with the JAX package's defaults and preset
values. Every other field the JAX package knows is listed in `NOT_PORTED`
or `NOT_PORTED_SECTIONS` with its default: setting one away from its
default raises `NotPortedError` — a knob is never silently ignored.
`Config.to_dict` writes every section of the JAX package's config (the
unported fields at their defaults), so a checkpoint's ``meta.json`` loads
in either package, and `Config.from_dict` reads one.

Serving: the `ServeConfig` fields `InferenceEngine` takes and the two
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
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def override(self, dotted: str, value: str) -> None:
        """Apply one ``section.field=value`` override, coercing to the
        field's type; a known but unported knob set away from its default
        raises `NotPortedError`."""
        section_name, _, field_name = dotted.partition(".")
        if not field_name:
            raise ValueError(f"override {dotted!r} must be section.field")
        if section_name in NOT_PORTED_SECTIONS:
            raise NotPortedError(
                f"--{dotted}: the {section_name!r} section is not ported to "
                f"tpu_dp_torch yet (ROADMAP.md)")
        if dotted in NOT_PORTED:
            default = NOT_PORTED[dotted]
            if _coerce(value, default) != default:
                raise NotPortedError(
                    f"--{dotted}={value}: not ported to tpu_dp_torch yet "
                    f"(only the default {default!r} runs; ROADMAP.md)")
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
        for section, fields in NOT_PORTED_SECTIONS.items():
            out[section] = dict(fields)
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
            if section_name in NOT_PORTED_SECTIONS:
                known = NOT_PORTED_SECTIONS[section_name]
                for name, value in fields.items():
                    if name not in known:
                        raise ValueError(
                            f"unknown field {name!r} in {section_name}")
                    _require_default(f"{section_name}.{name}", value,
                                     known[name])
                continue
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


_SECTIONS = ("model", "data", "optim", "train", "parallel")

#: Sections of the JAX package's config the trainer does not read yet,
#: with the JAX package's defaults (a meta.json carries them).
NOT_PORTED_SECTIONS: dict[str, dict[str, Any]] = {
    "resilience": {
        "snapshot_every_steps": 0, "snapshot_keep": 2, "snapshot_dir": "",
        "handle_signals": True, "max_retries": 2, "retry_base_delay_s": 0.05,
        "fault": "", "io_retry_s": 3.1, "elastic": False,
        "membership_dir": "", "regroup_timeout_s": 60.0,
        "elastic_poll_every_steps": 1, "elastic_min_world": 1,
        "elastic_coordinator_host": "", "elastic_verify_fingerprint": True,
        "elastic_join": "auto", "elastic_join_timeout_s": 0.0,
        "elastic_max_world": 0,
    },
    "guard": {
        "enabled": False, "action": "skip", "spike_window": 64,
        "spike_z": 8.0, "spike_min_steps": 16, "device_cap": True,
        "max_rollbacks": 3, "lr_ease_steps": 0, "lr_ease_start": 0.1,
        "sdc_every_steps": 0, "sdc_action": "halt", "quarantine_path": "",
    },
    "obs": {
        "run_dir": "", "span_capacity": 4096, "heartbeat_every_steps": 1,
        "straggler_factor": 3.0, "stale_after_s": 60.0, "min_step_ms": 1.0,
        "on_straggler": "warn", "perfetto_path": "",
        "flightrec_capacity": 2048, "prom_path": "",
        "peak_flops_override": 0.0, "measure_flops": False,
        "comm_profile_steps": "", "comm_profile_dir": "",
    },
    "serve": {
        "buckets": "1,2,4,8,16,32", "max_wait_ms": 5.0, "max_queue": 256,
        "slo_ms": 50.0, "shed_headroom_ms": 0.0, "obs_dir": "",
        "replicas": 1, "run_dir": "", "stale_after_s": 2.0,
        "max_retries": 1, "class_slo_ms": "", "class_floors": "",
        "profile_batches": "", "profile_dir": "",
    },
}

#: Fields of the ported sections that the port does not implement yet,
#: with the JAX package's defaults (the only values that run).
NOT_PORTED: dict[str, Any] = {
    # The TPU kernel's images per grid step (ResNet-18 and ResNet-50
    # alike); the Hopper kernel's tile is fixed by the shape (`conv_block.
    # tile_of`), so there is no per-block knob to give it and only the
    # automatic default runs.
    "model.fused_block_b": 0,
    "train.profile_dir": None,
    "train.recompile_guard": "warn",
    "train.verify_fingerprint": False,
    "train.obs": "off",
    "train.metrics_path": "",
    "train.profile_steps": "",
    "train.profile": "",
}


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
            f"default {default!r} runs; ROADMAP.md)")


def check_ported(cfg: Config) -> Config:
    """Raise `NotPortedError` for a configuration the port cannot run
    (a model other than net, resnet18 and resnet50, more than one device
    per process), `ValueError` for one that is invalid (a feed mode other
    than auto|on|off; the device-resident feed forced on, gradient
    accumulation or a window above 1, each with a ragged final batch;
    gradient accumulation below 1, a negative window; the sharded
    update's knobs as the JAX package refuses them), with the JAX
    package's messages."""
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
    if cfg.train.steps_per_call < 0:
        raise ValueError(f"train.steps_per_call must be >= 0 (0 = auto), "
                         f"got {cfg.train.steps_per_call}")
    if cfg.train.steps_per_call > 1 and not cfg.data.drop_remainder:
        raise ValueError("train.steps_per_call > 1 requires "
                         "data.drop_remainder=true")
    _check_update_sharding(cfg.train)
    return cfg


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
            raise NotPortedError(f"--{key}: not ported to tpu_dp_torch yet")
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
