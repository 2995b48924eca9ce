"""On-device data augmentation (port of `tpu_dp.data.augment`): pad-4
random crop + horizontal flip per image, NHWC, applied after normalize.

Deterministic in ``(seed, step, rank)``: each call draws its offsets and
flips from a `torch.Generator` on the images' device seeded from all three,
so a step replays identically, and the ranks of a data-parallel run crop
and flip their rows independently (with one key, row i of every rank
would get the same crop). The draws are not `jax.random`'s bits; the
distribution is the same (offsets uniform over 0..2*pad, flip rate 1/2).
"""

from __future__ import annotations

import numpy as np
import torch


def random_crop_flip(gen: torch.Generator, images: torch.Tensor,
                     pad: int = 4, fill: float = 0.0) -> torch.Tensor:
    """Pad-`pad` constant-pad random crop + random horizontal flip, per
    image; shape- and dtype-preserving. ``fill`` is the pad value: 0 for
    raw pixel space, -1 for [-1, 1]-normalized inputs (black in both)."""
    n, h, w, c = images.shape
    dev = images.device
    padded = images.new_full((n, h + 2 * pad, w + 2 * pad, c), fill)
    padded[:, pad:pad + h, pad:pad + w] = images
    offsets = torch.randint(0, 2 * pad + 1, (n, 2), generator=gen,
                            device=dev)
    flips = torch.randint(0, 2, (n,), generator=gen, device=dev).bool()
    ar_h = torch.arange(h, device=dev)
    ar_w = torch.arange(w, device=dev)
    rows = offsets[:, :1] + ar_h                           # [n, h]
    cols = offsets[:, 1:] + torch.where(flips[:, None], w - 1 - ar_w, ar_w)
    idx = torch.arange(n, device=dev)[:, None, None]
    return padded[idx, rows[:, :, None], cols[:, None, :]]


def make_augment_fn(seed: int, fill: float = -1.0, rank: int = 0):
    """Build ``aug(step, images)``: deterministic in (seed, step, rank).
    The train step calls it with the update counter after its on-device
    normalize, so the default ``fill`` of -1 pads black."""

    def aug(step, images: torch.Tensor) -> torch.Tensor:
        gen = torch.Generator(device=images.device)
        key = np.random.SeedSequence([int(seed), int(step), int(rank)])
        gen.manual_seed(int(key.generate_state(1, np.uint64)[0]) >> 1)
        return random_crop_flip(gen, images, fill=fill)

    return aug
