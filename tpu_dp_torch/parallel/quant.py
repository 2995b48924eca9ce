"""Blockwise int8 wire codec of the sharded update's gradient exchange
(port of `tpu_dp.parallel.quant`): the codec math on torch tensors, the
layout rules, the residual state and the byte accounting. The exchange
itself is `tpu_dp_torch.parallel.collectives.psum_scatter_quant`.

Codec format (the JAX package's, bit for bit). A flat f32 vector is split
into blocks of ``train.quant_block_size`` elements, each scaled by its
absmax::

    scale = max(|block|) / 127          (f32, one per block)
    q     = clip(round(block / scale), -127, 127)   (int8; half to even)
    block ~ q * scale                   (dequantize)

A NaN in a block makes its scale NaN (``amax`` propagates it), so every
dequantized value of the block is non-finite: a corrupt gradient is never
laundered into a finite int8 value. An all-zero block quantizes through a
safe scale of 1.0 to exact zeros. Before the int8 cast a NaN quotient
becomes 0, which is what the JAX package's cast gives.

Only leaves (or buckets) of at least ``world * block_size`` elements
quantize; smaller ones ride the f32 reduce-scatter. Error feedback: each
rank adds its previous rounding error to the next update's gradient
before quantizing (``eff = grad + residual``; ``residual = eff -
dequantize(quantize(eff))``). Residuals are per-rank state, one f32 row
of ``quant_padded_size`` per quantizing leaf (or bucket); the global
layout is ``[world, qpad]`` (row r = rank r's), the checkpoint's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

DEFAULT_BLOCK_SIZE = 256

#: f32 bytes per block of scales riding alongside the int8 payload.
SCALE_BYTES = 4


@dataclasses.dataclass(frozen=True)
class CastCodec:
    """A dtype cast on the wire: the payload is cast before the
    reduce-scatter and back after (no scales, no state)."""

    dtype: torch.dtype
    name: str = "bf16"


@dataclasses.dataclass(frozen=True)
class Int8BlockCodec:
    """Blockwise absmax-scaled int8 wire format with error feedback."""

    block_size: int = DEFAULT_BLOCK_SIZE
    error_feedback: bool = True
    name: str = "int8"


def make_wire_codec(collective_dtype: str | None,
                    block_size: int = DEFAULT_BLOCK_SIZE,
                    error_feedback: bool = True):
    """``train.collective_dtype`` -> wire codec, or None for the leaf
    dtype: "" / "f32" / "float32" keep f32, "bf16" / "bfloat16" cast,
    "int8" / "i8" the blockwise codec (the JAX package's names and
    errors)."""
    if not collective_dtype:
        return None
    allowed = {"bf16": CastCodec(torch.bfloat16),
               "bfloat16": CastCodec(torch.bfloat16),
               "f32": None, "float32": None}
    if collective_dtype in ("int8", "i8"):
        if block_size < 1:
            raise ValueError(
                f"quant_block_size must be >= 1, got {block_size}")
        return Int8BlockCodec(block_size=int(block_size),
                              error_feedback=bool(error_feedback))
    if collective_dtype not in allowed:
        raise ValueError(
            f"collective_dtype must be one of "
            f"{sorted(allowed) + ['int8']} (or empty), "
            f"got {collective_dtype!r}")
    return allowed[collective_dtype]


# -- layout ----------------------------------------------------------------


def quant_padded_size(n: int, world: int, block_size: int) -> int:
    """``n`` rounded up to a multiple of ``world * block_size``: the flat
    layout under which every 1/world chunk is a whole number of blocks."""
    m = world * block_size
    return n + (-n) % m


def leaf_quantizes(n: int, world: int, block_size: int) -> bool:
    """True when a leaf (or bucket) of ``n`` elements rides the int8
    wire: at least ``world * block_size`` elements."""
    return n >= world * block_size


def leaf_key(path: Sequence[str]) -> str:
    """Stable string key of one params leaf: its flax path '/'-joined
    (``conv1/kernel``), as `tpu_dp_torch.compat.param_leaves` names it."""
    return "/".join(str(p) for p in path)


# -- the block codec ---------------------------------------------------------


def quantize_blocks(flat: torch.Tensor, block_size: int):
    """Blockwise absmax int8 quantization of a flat f32 vector whose size
    is a multiple of ``block_size``: ``(q, scales)``, int8 shaped like
    ``flat`` and one f32 scale per block."""
    b = flat.reshape(-1, block_size)
    scale = b.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.nan_to_num((b / safe).round_().clamp_(-127, 127), nan=0.0)
    return q.to(torch.int8).reshape(flat.shape), scale.reshape(-1)


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      block_size: int) -> torch.Tensor:
    """Inverse of `quantize_blocks` (up to quantization error): f32."""
    deq = q.reshape(-1, block_size).to(torch.float32) * scales[:, None]
    return deq.reshape(q.shape)


def block_stats(q: torch.Tensor, scales: torch.Tensor):
    """Codec-health counts of one quantized vector (int32 device
    scalars): ``overflow``, blocks whose scale is not finite (NaN or inf
    gradients entered the codec); ``clip``, blocks with more than one
    value at the ±127 rail (the absmax element sits there by
    construction)."""
    overflow = (~torch.isfinite(scales)).sum().to(torch.int32)
    at_rail = (q.reshape(scales.numel(), -1).to(torch.int32).abs()
               == 127).sum(dim=1)
    clip = (at_rail > 1).sum().to(torch.int32)
    return overflow, clip


# -- residual state ----------------------------------------------------------


def init_residuals(leaves: Sequence[tuple[str, int]], world: int,
                   block_size: int = DEFAULT_BLOCK_SIZE,
                   bucket_bytes: int = 0) -> dict[str, np.ndarray]:
    """Zero error-feedback residuals in the global layout: one
    ``f32[world, qpad]`` entry per quantizing leaf of ``leaves`` (``(key,
    elements)`` pairs in JAX order), keyed by leaf key; with
    ``bucket_bytes`` one per quantizing bucket of the plan, keyed by its
    composition key. Host numpy arrays (the checkpoint's layout)."""
    if bucket_bytes:
        from tpu_dp_torch.parallel import bucketing

        plan = bucketing.plan_for_tree(leaves, world, bucket_bytes,
                                       block_size=block_size, int8=True)
        return {b.key: np.zeros((world, b.quant_padded(world, block_size)),
                                np.float32)
                for b in plan if b.quantizes}
    return {key: np.zeros((world, quant_padded_size(n, world, block_size)),
                          np.float32)
            for key, n in leaves if leaf_quantizes(n, world, block_size)}


def local_residuals(residuals: dict, world: int) -> dict:
    """One rank's view of global-layout residuals (row 0 of each leaf);
    ``world`` checks that the rows are this world's."""
    out = {}
    for key, r in residuals.items():
        if r.shape[0] != world:
            raise ValueError(
                f"residual leaf has {r.shape[0]} replica rows, expected "
                f"world={world} — not this group's global layout")
        out[key] = r[:1]
    return out


# -- wire accounting ---------------------------------------------------------


def wire_report(leaves: Sequence[tuple[str, int]], world: int,
                block_size: int = DEFAULT_BLOCK_SIZE,
                bucket_bytes: int = 0) -> dict:
    """Bytes each wire format puts on the gradient exchange per update
    (each rank's whole flat-padded gradient; int8 counts payload plus f32
    scales for quantizing leaves or buckets and f32 for the rest), for
    ``leaves`` (``(key, elements)`` pairs in JAX order). With
    ``bucket_bytes`` the block padding and the quantize decision are per
    bucket, and the record gains the plan's ``buckets`` summary."""
    from tpu_dp_torch.parallel.collectives import padded_size

    leaves = list(leaves)
    f32 = bf16 = int8 = 0
    quantized = total = 0
    buckets_summary = None
    if bucket_bytes:
        from tpu_dp_torch.parallel import bucketing

        plan = bucketing.plan_for_tree(leaves, world, bucket_bytes,
                                       block_size=block_size, int8=True)
        buckets_summary = bucketing.plan_summary(plan, world, block_size)
        groups = [(len(b.keys), b.padded_elements(world),
                   b.quant_padded(world, block_size) if b.quantizes
                   else None) for b in plan]
    else:
        groups = [(1, padded_size(n, world),
                   quant_padded_size(n, world, block_size)
                   if leaf_quantizes(n, world, block_size) else None)
                  for _, n in leaves]
    for count, pad, qpad in groups:
        total += count
        f32 += pad * 4
        bf16 += pad * 2
        if qpad is not None:
            quantized += count
            int8 += qpad + (qpad // block_size) * SCALE_BYTES
        else:
            int8 += pad * 4
    out = {
        "block_size": int(block_size),
        "world": int(world),
        "leaves": int(total),
        "quantized_leaves": int(quantized),
        "wire_bytes_per_step": {"f32": int(f32), "bf16": int(bf16),
                                "int8": int(int8)},
        "compression_vs_f32": round(f32 / int8, 3) if int8 else None,
    }
    if buckets_summary is not None:
        out["bucket_bytes"] = int(bucket_bytes)
        out["buckets"] = buckets_summary
    return out


# -- residual relayout (checkpoints across bucket and world changes) ---------


def decompose_residual(saved, leaf_sizes: dict[str, int],
                       key: str) -> dict[str, np.ndarray]:
    """One saved residual ``f32[w_old, qpad_old]`` in the layout of
    ``key``'s composition -> the pending correction per params leaf (the
    sum over rows, as ``f32[n]`` in the leaf's element order). A leaf of
    unknown size, or a layout that is not this composition's, gives {}
    (the correction is forfeited, at most one update's rounding)."""
    from tpu_dp_torch.parallel import bucketing
    from tpu_dp_torch.parallel.collectives import shard_size

    saved = np.asarray(saved)
    keys = bucketing.composition(key)
    if saved.ndim != 2 or any(k not in leaf_sizes for k in keys):
        return {}
    w_old = saved.shape[0]
    if w_old < 1 or saved.shape[1] % w_old:
        return {}
    cpad_old = saved.shape[1] // w_old
    pchunks = [shard_size(int(leaf_sizes[k]), w_old) for k in keys]
    if sum(pchunks) > cpad_old:
        return {}
    pending = saved.sum(axis=0).reshape(w_old, cpad_old)
    out: dict = {}
    off = 0
    for k, pchunk in zip(keys, pchunks):
        n = int(leaf_sizes[k])
        out[k] = pending[:, off:off + pchunk].reshape(-1)[:n].astype(
            saved.dtype)
        off += pchunk
    return out


def compose_residual(pending: dict[str, np.ndarray], like,
                     leaf_sizes: dict[str, int], key: str) -> np.ndarray:
    """Per-leaf pending corrections -> one residual shaped ``like`` in the
    layout of ``key``'s composition, the whole debt on row 0 (rank 0 pays
    it on its first update after the restore); leaves without an entry
    contribute zeros."""
    from tpu_dp_torch.parallel import bucketing
    from tpu_dp_torch.parallel.collectives import shard_size

    like = np.asarray(like)
    out = np.zeros(like.shape, like.dtype)
    keys = bucketing.composition(key)
    if like.ndim != 2 or like.shape[0] < 1 or like.shape[1] % like.shape[0]:
        return out
    w_new = like.shape[0]
    cpad_new = like.shape[1] // w_new
    row = np.zeros((w_new, cpad_new), like.dtype)
    off = 0
    for k in keys:
        n = int(leaf_sizes.get(k, 0))
        pchunk = shard_size(n, w_new)
        vec = pending.get(k)
        if vec is not None and n:
            padded = np.zeros(w_new * pchunk, like.dtype)
            padded[:n] = np.asarray(vec).reshape(-1)[:n]
            row[:, off:off + pchunk] = padded.reshape(w_new, pchunk)
        off += pchunk
    out[0] = row.reshape(-1)
    return out
