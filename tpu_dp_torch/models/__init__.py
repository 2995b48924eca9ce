"""Model zoo of the port: the CIFAR ResNet-18 (this slice).

`build_model` and `parse_fused_stages` keep the JAX package's names and
contracts (`tpu_dp.models`); `Net` and ResNet-50 come in a later slice.
"""

from __future__ import annotations

from tpu_dp_torch.models.resnet import ResNet, ResNet18

_REGISTRY = {"resnet18": ResNet18}


def parse_fused_stages(spec: str | None) -> tuple[int, ...]:
    """Parse a ``fused_stages`` spec: '' -> none, 'all' -> all four
    stages, else comma-separated stage indices ('0' or '0,1,2,3')."""
    if not spec:
        return ()
    if spec.strip().lower() == "all":
        return (0, 1, 2, 3)
    try:
        stages = tuple(sorted({int(s) for s in spec.split(",") if s.strip()}))
    except ValueError:
        raise ValueError(
            f"fused_stages must be '', 'all', or comma-separated stage "
            f"indices, got {spec!r}") from None
    if any(s not in (0, 1, 2, 3) for s in stages):
        raise ValueError(
            f"fused_stages indices must be in 0..3, got {spec!r}")
    return stages


def build_model(name: str, num_classes: int = 10, **kwargs):
    """Construct a model by config name. ``kwargs`` go to the model:
    ``num_filters``, ``dtype`` (a torch dtype), ``fused_stages``,
    ``generator`` (a seeded `torch.Generator` for the init) and
    ``device``."""
    try:
        factory = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return factory(num_classes=num_classes, **kwargs)


__all__ = ["ResNet", "ResNet18", "build_model", "parse_fused_stages"]
