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
``pmean_forward`` and ``pmean_backward`` (sync-BN's), ``psum`` (metrics)
and ``ddp_buckets`` (DDP's bucket all-reduces, through
`counting_allreduce_hook`).

The sharded-update helpers (``psum_scatter``, ``all_gather``,
``padded_size``) are not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

#: reductions issued since import or the last `reset_counts`.
counts = {"pmean_forward": 0, "pmean_backward": 0, "psum": 0,
          "ddp_buckets": 0}


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
