"""On-device data augmentation (port of `tpu_dp.data.augment`): pad-4
random crop + horizontal flip per image, NHWC, applied after normalize.

The draws are `jax.random`'s own bits, as the JAX package makes them
(``jax_threefry_partitionable`` on, the ``threefry2x32`` generator): the
key of step ``s`` is ``fold_in(PRNGKey(seed), s)`` (``s = step·a + i`` for
microbatch i of a under gradient accumulation), split into ``k_off,
k_flip``; the offsets are ``randint(k_off, (N, 2), 0, 2·pad + 1)`` and the
flips ``bernoulli(k_flip, 0.5, (N,))`` over the global batch of N rows.
In partitionable mode the bits of element ``j`` of a draw depend only on
the key and ``j`` (its row-major flat index), so a rank draws its own rows
``[row0, row0 + n)`` without drawing the rest of the batch.

This module is the plain version: threefry2x32 and the `jax.random`
functions above on int64 tensors (or Python ints), each value kept in
[0, 2**32) by masking, so every operation is exact and the CPU and a
card give the same bits. The train step on a card runs the hand-written
kernel instead (`tpu_dp_torch.ops.augment`), which reads the step from
the device counter, so a CUDA graph of the step replays the step it runs.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
#: threefry2x32's rotations, by round parity (`jax._src.prng`).
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for x in [0, 2**32) and c < 2**32 without
    leaving int64: the low half's product (below 2**48) plus the high
    half's, taken mod 2**16 before its shift."""
    return (((x & 0xFFFF) * c) + ((((x >> 16) * (c & 0xFFFF)) & 0xFFFF)
                                  << 16)) & _M32


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """`jax._src.prng.threefry2x32_p` (its unrolled lowering): the
    Threefry-2x32 block cipher, 20 rounds, of the count pair ``(x1, x2)``
    under the key ``(k1, k2)``; every argument a Python int or an int64
    tensor in [0, 2**32), broadcast elementwise. Returns the pair."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for r in range(5):
        for rot in _ROTATIONS[r % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, rot) ^ x1
        x1 = (x1 + ks[(r + 1) % 3]) & _M32
        x2 = (x2 + ks[(r + 2) % 3] + r + 1) & _M32
    return x1, x2


def prng_key(seed: int) -> tuple[int, int]:
    """`jax.random.PRNGKey(seed)` (`threefry_seed`) with ``jax_enable_x64``
    off, as the JAX package runs: ``(0, seed mod 2**32)``."""
    return 0, int(seed) & _M32


def fold_in(key, data):
    """`jax.random.fold_in` (`threefry_fold_in`): threefry of the count
    pair ``(0, data)`` under ``key``; ``data`` is taken as uint32 (an int
    or an int64 tensor)."""
    return threefry2x32(key[0], key[1], 0, data & _M32)


def split(key, num: int = 2) -> list:
    """`jax.random.split` in partitionable mode (`_threefry_split_foldlike`):
    key i is threefry of the count pair ``(i >> 32, i & M)``."""
    return [threefry2x32(key[0], key[1], i >> 32, i & _M32)
            for i in range(num)]


def random_bits(key, counts: torch.Tensor) -> torch.Tensor:
    """`jax.random.bits` (32-bit, `_threefry_random_bits_partitionable`) at
    the row-major flat positions ``counts`` (int64) of the drawn array:
    ``bits1 ^ bits2`` of threefry of ``(counts >> 32, counts & M)``."""
    b1, b2 = threefry2x32(key[0], key[1], counts >> 32, counts & _M32)
    return b1 ^ b2


def randint(key, counts: torch.Tensor, minval: int,
            maxval: int) -> torch.Tensor:
    """`jax.random.randint` into int32 (`jax._src.random._randint`) at the
    flat positions ``counts``: split the key, draw higher and lower 32-bit
    words, and fold them into ``[minval, maxval)`` with the span and
    multiplier arithmetic of uint32 (wrapping), as JAX does."""
    k1, k2 = split(key)
    higher, lower = random_bits(k1, counts), random_bits(k2, counts)
    span = max(int(maxval) - int(minval), 1) & _M32
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    offset = ((_mul32(higher % span, multiplier) + lower % span) & _M32
              ) % span
    return int(minval) + offset


def uniform(key, counts: torch.Tensor) -> torch.Tensor:
    """`jax.random.uniform` over [0, 1) in float32 (`_uniform`) at the flat
    positions ``counts``: the top 23 bits as the mantissa of a float in
    [1, 2), minus 1 (exact, as is JAX's scale by 1 and shift by 0)."""
    bits = (random_bits(key, counts) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key, p: float, counts: torch.Tensor) -> torch.Tensor:
    """`jax.random.bernoulli` (mode "low"): ``uniform < p`` in float32."""
    return uniform(key, counts) < torch.tensor(
        p, dtype=torch.float32, device=counts.device)


def crop_flip_draws(key, n: int, seed: int, row0: int = 0,
                    global_n: int | None = None, pad: int = 4):
    """``(offsets [n, 2] int64, flips [n] bool)`` of rows ``[row0, row0 +
    n)`` of a ``global_n``-row batch (default ``row0 + n``) for the step
    key ``key`` (an int, or an int64 tensor on the draws' device):
    `tpu_dp.data.augment.random_crop_flip`'s draws under
    ``fold_in(PRNGKey(seed), key)``, bit for bit."""
    if global_n is not None and not 0 <= row0 <= row0 + n <= global_n:
        raise ValueError(f"rows [{row0}, {row0 + n}) outside a batch of "
                         f"{global_n}")
    device = key.device if isinstance(key, torch.Tensor) else None
    k_off, k_flip = split(fold_in(prng_key(seed), key))
    rows = torch.arange(row0, row0 + n, dtype=torch.int64, device=device)
    cells = (2 * rows[:, None] + torch.arange(2, device=device)).reshape(-1)
    offsets = randint(k_off, cells, 0, 2 * pad + 1).view(n, 2)
    return offsets, bernoulli(k_flip, 0.5, rows)


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


def make_augment_fn(seed: int, fill: float = -1.0, row0: int = 0,
                    global_n: int | None = None):
    """Build ``aug(step, images, accum=1, micro=0)``: the crops and flips
    of rows ``[row0, row0 + B)`` of the ``global_n``-row batch under the
    key ``step·accum + micro`` (`tpu_dp_torch.ops.augment.
    crop_flip_draws`: the kernel on a card, the plain version on the CPU).
    ``step`` is an int or an int64 0-dim tensor on the images' device (the
    train step passes its device counter, so nothing waits for the host).
    The train step calls it after its on-device normalize, so the default
    ``fill`` of -1 pads black."""
    from tpu_dp_torch.ops import augment as aug_ops

    def aug(step, images: torch.Tensor, accum: int = 1,
            micro: int = 0) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.int64, device=images.device)
        offsets, flips = aug_ops.crop_flip_draws(
            step, images.shape[0], seed, row0, global_n, accum, micro)
        return random_crop_flip(images, offsets, flips, fill=fill)

    return aug
