"""Cross-rank reductions of the port (of `tpu_dp.parallel.collectives`).

`psum` and `pmean` reduce a tensor, or a list of tensors of one dtype, as
ONE flattened ``all_reduce`` over ``group``; with no group (None), or a
group of one rank, they are the identity and issue nothing. `pmean` is
differentiable: its backward is the same mean of the cotangent across
ranks, the transpose that ``shard_map`` gives ``lax.pmean``. That is what
makes sync-BN exact: forward mean, backward mean, then DDP's mean of the
gradients over ranks gives the gradient of the global batch's mean loss.

Every rank must issue the same collectives in the same order. The callers
keep that by construction: BatchNorm's reductions run in module order in
the forward and in autograd's order in the backward, on the thread that
runs the step, as torch's ``SyncBatchNorm`` does. No collective is issued
from a thread of this package's own.

``counts`` books the reductions issued (not the identities):
``pmean_forward`` and ``pmean_backward`` (sync-BN's), ``psum`` (metrics),
``ddp_buckets`` (DDP's bucket all-reduces, through
`counting_allreduce_hook`), and the sharded update's ``reduce_scatter``,
``all_to_all`` and ``all_gather``.

The sharded weight update (``train.update_sharding=sharded``; Xu et al.,
the JAX package's second and third gradient schedules) splits the
gradient all-reduce into its two halves with the optimizer between them:
a reduce-scatter gives each rank the sum of its 1/world shard of every
leaf, the rank updates that shard, and an all-gather of the updated
parameters closes the step. Every leaf is flattened in the JAX leaf's
element order and zero-padded to a multiple of the world
(`padded_size`); rank r owns elements ``[r*pchunk, (r+1)*pchunk)``
(`shard_size`). A set of leaves exchanged together is laid out as the
JAX package's ``_bucket_rows``: each leaf's ``[world, pchunk]`` rows
concatenated along dimension 1, so one collective serves them all and its
per-element arithmetic is that of one reduce-scatter per leaf.
`exchange_plan` says which leaves go together: all of them (f32, bf16),
the quantizing leaves and the rest (int8), or one exchange per bucket of
`bucketing.plan_buckets` (``train.bucket_mb``; the JAX package's
``psum_scatter_bucketed`` and ``psum_scatter_quant_bucketed``). On the
wire: `psum_scatter` (f32, or cast to bf16 and back) and
`psum_scatter_quant` (the int8 codec of `quant`: one ``all_to_all_single``
of the payload and one of the f32 scales, then dequantize-and-sum); the
updated parameters come back through `all_gather`. With no group (one
process) each is the identity; with a group they are issued even at
world 1. ``mean=True`` divides after the sum, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.distributed as dist

from tpu_dp_torch.parallel import bucketing, quant

#: reductions issued since import or the last `reset_counts`.
counts = {"pmean_forward": 0, "pmean_backward": 0, "psum": 0,
          "ddp_buckets": 0, "reduce_scatter": 0, "all_to_all": 0,
          "all_gather": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def world_of(group) -> int:
    """Ranks in ``group``; 1 for no group."""
    if group is None:
        return 1
    return dist.get_world_size(group)


def _flat(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    if len({x.dtype for x in xs}) != 1:
        raise TypeError(f"one all_reduce needs one dtype, got "
                        f"{sorted(str(x.dtype) for x in xs)}")
    return torch.cat([x.reshape(-1) for x in xs])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]):
    out, at = [], 0
    for x in like:
        out.append(flat[at:at + x.numel()].view(x.shape))
        at += x.numel()
    return out


def _all_reduce(x: torch.Tensor, group, mean: bool) -> torch.Tensor:
    """A reduced copy of ``x`` (``all_reduce`` works in place)."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.div_(dist.get_world_size(group)) if mean else y


def psum(x, group=None):
    """Sum of ``x`` (a tensor or a list of tensors) over ``group``'s ranks,
    in one ``all_reduce``; not differentiable (metrics)."""
    if world_of(group) == 1:
        return x
    counts["psum"] += 1
    if isinstance(x, torch.Tensor):
        return _all_reduce(x.detach(), group, mean=False)
    return _unflat(_all_reduce(_flat([t.detach() for t in x]), group, False),
                   x)


class _PMean(torch.autograd.Function):
    """``all_reduce(SUM) / W`` forward, the same of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        counts["pmean_forward"] += 1
        return _all_reduce(x, group, mean=True)

    @staticmethod
    def backward(ctx, ct):
        counts["pmean_backward"] += 1
        return _all_reduce(ct, ctx.group, mean=True), None


def pmean(x, group=None):
    """Mean of ``x`` (a tensor or a list of tensors) over ``group``'s
    ranks, in one ``all_reduce`` each way; differentiable."""
    if world_of(group) == 1:
        return x
    if isinstance(x, torch.Tensor):
        return _PMean.apply(x, group)
    return _unflat(_PMean.apply(_flat(x), group), x)


def counting_allreduce_hook(group, bucket):
    """DDP's default mean of a gradient bucket (torch's ``allreduce_hook``:
    divide by the world, ``all_reduce`` sum), booked in
    ``counts["ddp_buckets"]``."""
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    counts["ddp_buckets"] += 1
    return default_hooks.allreduce_hook(group, bucket)


# -- the sharded update's exchange -------------------------------------------


def padded_size(n: int, world: int) -> int:
    """``n`` rounded up to a multiple of ``world`` (the flat shard layout)."""
    return n + (-n) % world


def shard_size(n: int, world: int) -> int:
    """Per-rank elements of a flat-sharded leaf with ``n`` elements."""
    return padded_size(n, world) // world


@dataclasses.dataclass(frozen=True)
class Segment:
    """Leaves that share one stretch of an exchange's chunk: ``cpad`` is
    its chunk length (Σ per-leaf `shard_size`, block-padded at the tail
    when it quantizes). A quantizing segment carries one residual, keyed
    by `key` (its leaf keys joined, `bucketing.KEY_SEP`)."""

    keys: tuple[str, ...]
    sizes: tuple[int, ...]
    cpad: int

    @property
    def key(self) -> str:
        return bucketing.KEY_SEP.join(self.keys)


@dataclasses.dataclass(frozen=True)
class Exchange:
    """One collective set of an update: its segments side by side in the
    ``[world, chunk]`` wire layout, int8 or not."""

    segments: tuple[Segment, ...]
    quantizes: bool

    @property
    def chunk(self) -> int:
        return sum(s.cpad for s in self.segments)


def exchange_plan(leaves: Sequence[tuple[str, int]], world: int, *,
                  codec=None, bucket_bytes: int = 0) -> list[Exchange]:
    """The exchanges of one update, in issue order, for ``leaves`` (``(key,
    elements)`` pairs in JAX order) under ``codec`` (`quant.
    make_wire_codec`'s). Without buckets: one exchange of every leaf; under
    int8, one of the quantizing leaves (a segment and a residual each,
    block-padded per leaf as the JAX package pads them) and one f32
    exchange of the rest. With ``bucket_bytes``: one exchange per bucket of
    `bucketing.plan_buckets`, in plan order."""
    int8 = isinstance(codec, quant.Int8BlockCodec)
    block = codec.block_size if int8 else quant.DEFAULT_BLOCK_SIZE
    leaves = [(k, int(n)) for k, n in leaves]
    if bucket_bytes:
        return [Exchange((Segment(
            b.keys, b.sizes,
            b.quant_padded(world, block) // world if b.quantizes
            else b.shard_elements(world)),), b.quantizes)
            for b in bucketing.plan_buckets(leaves, world, bucket_bytes,
                                            block_size=block, int8=int8)]
    if not int8:
        return [Exchange(tuple(Segment((k,), (n,), shard_size(n, world))
                               for k, n in leaves), False)]
    big = [(k, n) for k, n in leaves if quant.leaf_quantizes(n, world, block)]
    small = [(k, n) for k, n in leaves
             if not quant.leaf_quantizes(n, world, block)]
    out = []
    if big:
        out.append(Exchange(tuple(
            Segment((k,), (n,), quant.quant_padded_size(n, world, block)
                    // world) for k, n in big), True))
    if small:
        out.append(Exchange(tuple(Segment((k,), (n,), shard_size(n, world))
                                  for k, n in small), False))
    return out


def _all_gather_single():
    """torch's one-tensor all-gather under the name this release has."""
    return (getattr(dist, "all_gather_single", None)
            or dist.all_gather_into_tensor)


def _reduce_scatter_single():
    """torch's one-tensor reduce-scatter under the name this release has."""
    return (getattr(dist, "reduce_scatter_single", None)
            or dist.reduce_scatter_tensor)


def psum_scatter(rows: torch.Tensor, group, *, mean: bool = False,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """Reduce-scatter of ``rows`` (``[world, chunk]``, this rank's
    contribution; row r goes to rank r): the f32 sum over ranks of this
    rank's row, ``/ world`` with ``mean``. ``dtype`` casts the payload
    before the collective and back after (the bf16 wire: the sum runs in
    the wire dtype, as the JAX package's does)."""
    world = rows.shape[0]
    x = rows if dtype is None else rows.to(dtype)
    if group is None:
        if world != 1:
            raise ValueError(f"{world} rows need a group")
        out = x[0]
    else:
        out = torch.empty(rows.shape[1], dtype=x.dtype, device=x.device)
        _reduce_scatter_single()(out, x.reshape(-1), op=dist.ReduceOp.SUM,
                                 group=group)
        counts["reduce_scatter"] += 1
    out = out.to(torch.float32)
    return out / world if mean else out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [world, k]: row r to rank r; row r of the result from rank r."""
    if group is None:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    counts["all_to_all"] += 1
    return out


def psum_scatter_quant(rows: torch.Tensor, residual: torch.Tensor | None,
                       group, *, mean: bool = False,
                       block_size: int = quant.DEFAULT_BLOCK_SIZE,
                       error_feedback: bool = True):
    """The int8 wire of `psum_scatter`: ``rows`` ``[world, cpad]`` (f32,
    ``cpad`` whole blocks of ``block_size``) plus this rank's pending
    rounding error ``residual`` (same shape, updated in place) is quantized
    once; one ``all_to_all_single`` of the int8 payload and one of the f32
    scales; each rank dequantizes the ``world`` chunks it received and sums
    them in f32, rank 0's first. Returns ``(shard [cpad], overflow, clip)``,
    the counts rank-local (`quant.block_stats`). ``error_feedback=False``
    (the ablation) neither reads nor writes ``residual``."""
    world, cpad = rows.shape
    eff = rows + residual if error_feedback else rows
    q, scales = quant.quantize_blocks(eff.reshape(-1), block_size)
    if error_feedback:
        residual.copy_((eff.reshape(-1) - quant.dequantize_blocks(
            q, scales, block_size)).view(world, cpad))
    overflow, clip = quant.block_stats(q, scales)
    nb = cpad // block_size
    qx = _all_to_all(q.view(world, cpad), group)
    sx = _all_to_all(scales.view(world, nb), group)
    deq = qx.view(world, nb, block_size).to(torch.float32) * sx[..., None]
    shard = deq[0]
    for r in range(1, world):
        shard = shard + deq[r]
    shard = shard.reshape(cpad)
    return (shard / world if mean else shard), overflow, clip


def all_gather(shard: torch.Tensor, group, world: int | None = None,
               book: bool = True) -> torch.Tensor:
    """Every rank's ``shard``, concatenated in rank order (``[world *
    len]``); the identity with no group. ``book=False`` leaves
    ``counts`` alone (a checkpoint's gather is no part of an update)."""
    if group is None:
        return shard
    world = dist.get_world_size(group) if world is None else world
    out = torch.empty(world * shard.numel(), dtype=shard.dtype,
                      device=shard.device)
    _all_gather_single()(out, shard.contiguous(), group=group)
    if book:
        counts["all_gather"] += 1
    return out
