"""On-device data augmentation (port of `tpu_dp.data.augment`): pad-4
random crop + horizontal flip per image, NHWC, applied after normalize.

Deterministic in ``(seed, step, rank)``: each image's two offsets and its
flip come from a counter-based hash of ``(seed, rank, step, row, draw)``
computed on the images' device, so a step replays identically, a CUDA
graph of the step replays the step it captured with the key it reads from
the device (the train step's step counter), and the ranks of a
data-parallel run crop and flip their rows independently (with one key,
row i of every rank would get the same crop). The hash is murmur3's
32-bit finalizer on int64 tensors, each product split at 16 bits and
masked to 32, so no operation overflows and the CPU and a card give the
same bits. The draws are not `jax.random`'s bits; the distribution is
the same (offsets uniform over 0..2*pad, flip rate 1/2).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for x in [0, 2**32): the low half's product
    (below 2**48) plus the high half's, taken mod 2**16 before its shift."""
    return (((x & 0xFFFF) * c) + ((((x >> 16) * (c & 0xFFFF)) & 0xFFFF)
                                  << 16)) & _M32


def _fmix32(h):
    """murmur3's finalizer: a bijection of [0, 2**32) that mixes every
    input bit into every output bit. Python ints or int64 tensors."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def crop_flip_draws(key: torch.Tensor, n: int, seed: int, rank: int = 0,
                    pad: int = 4):
    """``(offsets [n, 2], flips [n])`` of ``n`` images for the int64 0-dim
    ``key`` (the step) on its device: offsets uniform over ``0..2*pad``,
    flips at 1/2."""
    base = _fmix32(_fmix32((int(seed) & _M32) ^ _GOLDEN) ^ (int(rank) & _M32))
    k = _fmix32((key & _M32) ^ base)
    counters = torch.arange(3 * n, dtype=torch.int64, device=key.device)
    h = _fmix32(k ^ _mul32(counters + 1, _GOLDEN)).view(n, 3)
    return h[:, :2] % (2 * pad + 1), (h[:, 2] >> 31).bool()


def random_crop_flip(images: torch.Tensor, offsets: torch.Tensor,
                     flips: torch.Tensor, pad: int = 4,
                     fill: float = 0.0) -> torch.Tensor:
    """Pad-`pad` constant-pad crop at ``offsets`` ([n, 2]: row, column)
    and a horizontal flip where ``flips``, per image; shape- and
    dtype-preserving. ``fill`` is the pad value: 0 for raw pixel space, -1
    for [-1, 1]-normalized inputs (black in both)."""
    n, h, w, c = images.shape
    dev = images.device
    padded = images.new_full((n, h + 2 * pad, w + 2 * pad, c), fill)
    padded[:, pad:pad + h, pad:pad + w] = images
    ar_h = torch.arange(h, device=dev)
    ar_w = torch.arange(w, device=dev)
    rows = offsets[:, :1] + ar_h                           # [n, h]
    cols = offsets[:, 1:] + torch.where(flips[:, None], w - 1 - ar_w, ar_w)
    idx = torch.arange(n, device=dev)[:, None, None]
    return padded[idx, rows[:, :, None], cols[:, None, :]]


def make_augment_fn(seed: int, fill: float = -1.0, rank: int = 0):
    """Build ``aug(step, images)``: deterministic in (seed, step, rank).
    ``step`` is an int or an int64 0-dim tensor on the images' device (the
    train step passes its device counter, so nothing waits for the host).
    The train step calls it after its on-device normalize, so the default
    ``fill`` of -1 pads black."""

    def aug(step, images: torch.Tensor) -> torch.Tensor:
        key = torch.as_tensor(step, dtype=torch.int64, device=images.device)
        offsets, flips = crop_flip_draws(key, images.shape[0], seed, rank)
        return random_crop_flip(images, offsets, flips, fill=fill)

    return aug
