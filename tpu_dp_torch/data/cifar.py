"""CIFAR normalize and the deterministic synthetic set (port of
`tpu_dp.data.cifar`, the two functions the serving path needs).

Arrays stay numpy uint8 NHWC on the host, as in the JAX package; the
serve step normalizes on the device (`tpu_dp_torch.train.step`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

IMAGE_SHAPE = (32, 32, 3)


@dataclasses.dataclass(frozen=True)
class ArrayDataset:
    """An in-memory labeled image dataset: uint8 NHWC images, int32 labels."""

    images: np.ndarray
    labels: np.ndarray
    name: str
    num_classes: int
    synthetic: bool = False

    def __post_init__(self):
        assert self.images.ndim == 4 and self.images.dtype == np.uint8
        assert len(self.images) == len(self.labels)

    def __len__(self) -> int:
        return len(self.images)


def normalize(images):
    """uint8 [0, 255] → float32 [-1, 1]: ``x*(2/255) - 1``.

    Takes a numpy array or a tensor and returns the same kind.
    """
    if isinstance(images, torch.Tensor):
        return images.to(torch.float32) * (2.0 / 255.0) - 1.0
    return images.astype(np.float32) * (2.0 / 255.0) - 1.0


def make_synthetic(
    num_examples: int,
    num_classes: int,
    seed: int = 0,
    name: str = "synthetic",
    example_seed: int | None = None,
) -> ArrayDataset:
    """Deterministic synthetic image classes: a fixed random uint8 template
    per class plus Gaussian pixel noise. Same numpy stream as the JAX
    package's `make_synthetic`, so equal seeds give equal arrays."""
    rng = np.random.default_rng(seed)
    templates = rng.integers(
        0, 256, size=(num_classes, *IMAGE_SHAPE), dtype=np.int16
    )
    rng_e = (
        rng if example_seed is None else np.random.default_rng(example_seed)
    )
    labels = rng_e.integers(0, num_classes, size=num_examples).astype(np.int32)
    noise = rng_e.normal(0.0, 24.0, size=(num_examples, *IMAGE_SHAPE))
    images = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
    return ArrayDataset(
        images=images, labels=labels, name=name,
        num_classes=num_classes, synthetic=True,
    )
