"""Configuration of the port (the parts of `tpu_dp.config` it reads).

Training: the `ModelConfig` / `DataConfig` / `OptimConfig` /
`TrainConfig` / `ParallelConfig` fields the trainer implements, the presets and `parse_cli`
(``--preset=name``, then ``--section.field=value``), with the JAX
package's defaults and preset values. Every other field the JAX package
knows is listed in `NOT_PORTED` with its default: setting one away from
its default raises `NotPortedError`, and so does any field of a section
the trainer does not read — a knob is never silently ignored.

Serving: the `ServeConfig` fields `InferenceEngine` takes and the two
SLO-class parsers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence


class NotPortedError(ValueError):
    """A configuration the JAX package runs and the port does not yet."""


@dataclass
class ModelConfig:
    name: str = "net"  # the port trains resnet18 only
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
    # "on" (stage the train set on the device) is not ported; "auto"
    # means off here.
    device_resident: str = "auto"  # auto | on | off


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


@dataclass
class TrainConfig:
    epochs: int = 2
    log_every: int = 2000
    seed: int = 0
    eval_at_end: bool = True
    eval_every_epochs: int = 0  # 0 = only at end
    pallas_xent: bool = False  # the fused softmax-xent kernels


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
        return dataclasses.asdict(self)


_SECTIONS = ("model", "data", "optim", "train", "parallel")

#: Sections of the JAX package's config the trainer does not read yet.
NOT_PORTED_SECTIONS = ("resilience", "guard", "obs", "serve")

#: Fields of the ported sections that the port does not implement yet,
#: with the JAX package's defaults (the only values that run).
NOT_PORTED: dict[str, Any] = {
    # The TPU kernel's images per grid step; the Hopper kernel's tile is
    # fixed, so only the automatic default runs.
    "model.fused_block_b": 0,
    "data.resident_max_bytes": 512 * 1024 * 1024,
    "data.sync_placement": False,
    "optim.grad_accum_steps": 1,
    "train.steps_per_call": 1,
    "train.ckpt_dir": "./checkpoints",
    "train.ckpt_keep": 3,
    "train.ckpt_async": True,
    "train.resume": False,
    "train.profile_dir": None,
    "train.recompile_guard": "warn",
    "train.verify_fingerprint": False,
    "train.update_sharding": "replicated",
    "train.collective_dtype": "",
    "train.quant_block_size": 256,
    "train.bucket_mb": 0.0,
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


def check_ported(cfg: Config) -> Config:
    """Raise `NotPortedError` for a configuration the port cannot run
    (a model other than resnet18, the device-resident feed, more than one
    device per process)."""
    if cfg.parallel.num_devices not in (None, 1):
        raise NotPortedError(
            f"parallel.num_devices={cfg.parallel.num_devices}: one "
            f"tpu_dp_torch process drives one device; run one process per "
            f"device (torchrun --nproc_per_node)")
    if cfg.model.name.lower() != "resnet18":
        raise NotPortedError(
            f"model.name={cfg.model.name!r}: tpu_dp_torch trains resnet18 "
            f"only so far (ROADMAP.md)")
    if cfg.data.device_resident not in ("auto", "off", "on"):
        raise ValueError(f"data.device_resident must be auto|on|off, got "
                         f"{cfg.data.device_resident!r}")
    if cfg.data.device_resident == "on":
        raise NotPortedError(
            "data.device_resident=on: the device-resident feed is not "
            "ported yet (auto means off in tpu_dp_torch)")
    return cfg


def _preset_reference_single() -> Config:
    """The reference's `Net`, batch 4, 2 epochs (``model.name=net`` is not
    ported: pass ``--model.name=resnet18``)."""
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


PRESETS = {
    "reference": _preset_reference_single,
    "resnet18_cifar10": _preset_resnet18_cifar10,
}


def parse_cli(argv: Sequence[str]) -> Config:
    """``--preset=name``, then ``--section.field=value`` overrides, then
    `check_ported`. ``--config``, ``--resume`` and ``--profile`` of the
    JAX package's CLI raise `NotPortedError`."""
    cfg: Config | None = None
    overrides: list[tuple[str, str]] = []
    for arg in argv:
        if not arg.startswith("--"):
            raise ValueError(f"unexpected argument {arg!r}")
        key, _, value = arg[2:].partition("=")
        if key in ("config", "resume", "profile"):
            raise NotPortedError(f"--{key}: not ported to tpu_dp_torch yet")
        if key == "preset":
            if cfg is not None:
                raise ValueError("give at most one --preset")
            if value not in PRESETS:
                raise ValueError(
                    f"unknown preset {value!r}; available: {sorted(PRESETS)}")
            cfg = PRESETS[value]()
        else:
            overrides.append((key, value))
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
