"""CIFAR-10/100 loading, normalize and the deterministic synthetic set
(port of `tpu_dp.data.cifar`).

`load_dataset` reads the standard CIFAR python pickle-batch layout under
``root`` (what torchvision extracts into ``./data``) and otherwise falls
back to `make_synthetic`, a deterministic dataset of the same shapes. Arrays
stay numpy uint8 NHWC on the host, as in the JAX package; the steps
normalize on the device (`tpu_dp_torch.train.step`).
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import torch

IMAGE_SHAPE = (32, 32, 3)

# Default sizes for the synthetic fallback (the JAX package's).
_DEFAULT_SYNTHETIC_TRAIN = 1024
_DEFAULT_SYNTHETIC_TEST = 256


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


def _read_pickle_batches(files: list[Path], label_key: bytes):
    """Read the standard CIFAR python pickle-batch layout: a dict with
    b'data' of shape (N, 3072) uint8 in CHW order and a label list."""
    datas, labels = [], []
    for f in files:
        with open(f, "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        datas.append(np.asarray(d[b"data"], dtype=np.uint8))
        labels.extend(d[label_key])
    data = np.concatenate(datas, axis=0)
    images = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(images), np.asarray(labels, dtype=np.int32)


_SPECS = {
    "cifar10": dict(
        dirname="cifar-10-batches-py",
        train_files=[f"data_batch_{i}" for i in range(1, 6)],
        test_files=["test_batch"],
        label_key=b"labels",
        num_classes=10,
    ),
    "cifar100": dict(
        dirname="cifar-100-python",
        train_files=["train"],
        test_files=["test"],
        label_key=b"fine_labels",
        num_classes=100,
    ),
}


def load_dataset(
    name: str,
    root,
    train: bool = True,
    allow_synthetic: bool = True,
    synthetic_num_examples: int | None = None,
    seed: int = 0,
) -> ArrayDataset:
    """Load CIFAR-10/100 from ``root`` or fall back to synthetic data.

    ``name`` is cifar10, cifar100 or synthetic. When the files are absent
    and ``allow_synthetic``, a deterministic synthetic dataset with the
    right shapes and class count is returned (flagged ``.synthetic``);
    otherwise FileNotFoundError. Equal arguments give the JAX package's
    arrays.
    """
    name = name.lower()
    default_n = (
        _DEFAULT_SYNTHETIC_TRAIN if train else _DEFAULT_SYNTHETIC_TEST
    )
    n_synth = synthetic_num_examples or default_n
    # Same base seed (shared class templates across train/test), distinct
    # example seeds (disjoint noise/label draws).
    example_seed = seed * 2 + (0 if train else 1)

    if name == "synthetic":
        return make_synthetic(
            n_synth, 10, seed=seed, name="synthetic",
            example_seed=example_seed,
        )

    if name not in _SPECS:
        raise ValueError(
            f"unknown dataset {name!r}; available: "
            f"{sorted(_SPECS) + ['synthetic']}"
        )
    spec = _SPECS[name]
    base = Path(root) / spec["dirname"]
    files = [
        base / f for f in (spec["train_files"] if train else spec["test_files"])
    ]
    if all(f.exists() for f in files):
        images, labels = _read_pickle_batches(files, spec["label_key"])
        return ArrayDataset(
            images=images, labels=labels, name=name,
            num_classes=spec["num_classes"], synthetic=False,
        )
    if not allow_synthetic:
        raise FileNotFoundError(
            f"{name} not found under {base} and allow_synthetic=False; "
            f"expected files: {[f.name for f in files]}"
        )
    return make_synthetic(
        n_synth, spec["num_classes"], seed=seed, name=name,
        example_seed=example_seed,
    )
