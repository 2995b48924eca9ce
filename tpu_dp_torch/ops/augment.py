"""The crop and flip draws of the on-device augmentation: the Hopper kernel
and its dispatch (the plain version is `tpu_dp_torch.data.augment.
crop_flip_draws`).

`crop_flip_draws(step, n, seed, row0, global_n, accum, micro)` returns
``(offsets [n, 2] int64, flips [n] bool)``: `jax.random`'s draws of rows
``[row0, row0 + n)`` of the global batch under ``fold_in(PRNGKey(seed),
step·accum + micro)``. ``step`` is an int64 0-dim tensor (the train step's
device counter). On a CUDA tensor it launches `csrc/augment.cu` (one
thread per row, the whole key chain in registers, the step read from the
device, so a CUDA graph replays the step it runs) or raises; on a CPU
tensor it runs the plain version. The JAX package draws these with XLA
ops, not a Pallas kernel (``tpu_dp/data/augment.py:30-36``).

``launches`` counts kernel launches (CUDA only).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpu_dp_torch.data import augment as plain

#: kernel launches since import or the last `reset_launches` (CUDA only).
launches = 0
_fn = None
#: serializes the book's increments across threads.
_books_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _books_lock:
        launches = 0


def count_launch() -> None:
    """Book one launch (exact under concurrent threads)."""
    global launches
    with _books_lock:
        launches += 1


def _kernel():
    global _fn
    if _fn is None:
        from tpu_dp_torch.ops import _build

        fn = _build.load("augment").tpu_dp_crop_flip_draws
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def crop_flip_draws(step: torch.Tensor, n: int, seed: int, row0: int = 0,
                    global_n: int | None = None, accum: int = 1,
                    micro: int = 0, pad: int = 4):
    """The draws of rows ``[row0, row0 + n)`` for the key ``step·accum +
    micro`` (module doc): the kernel for a CUDA ``step``, the plain
    version for a CPU one."""
    if step.dtype != torch.int64 or step.dim() != 0:
        raise ValueError(f"step must be an int64 0-dim tensor, got "
                         f"{step.dtype} {tuple(step.shape)}")
    if global_n is not None and not 0 <= row0 <= row0 + n <= global_n:
        raise ValueError(f"rows [{row0}, {row0 + n}) outside a batch of "
                         f"{global_n}")
    if step.device.type == "cpu":
        key = step * accum + micro if (accum, micro) != (1, 0) else step
        return plain.crop_flip_draws(key, n, seed, row0, global_n, pad)
    if step.device.type != "cuda":
        raise ValueError(f"crop_flip_draws runs on cpu or cuda, got "
                         f"{step.device}")
    dev = step.device
    offsets = torch.empty((n, 2), dtype=torch.int64, device=dev)
    flips = torch.empty(n, dtype=torch.bool, device=dev)
    seed_hi, seed_lo = plain.prng_key(seed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _kernel()(step.data_ptr(), int(accum), int(micro), seed_hi,
                       seed_lo, int(row0), int(n), 2 * pad + 1,
                       offsets.data_ptr(), flips.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"crop/flip draw kernel launch failed: error {rc}")
    count_launch()
    return offsets, flips
