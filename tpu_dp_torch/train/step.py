"""The train, eval and serve steps of the port (of `tpu_dp.train.step`).

`make_train_step` is the training hot path: normalize → augment keyed by
the step → forward/backward → SGD update with the schedule's learning rate
for this update, on a batch already on the device. `make_eval_step` is the
running-statistics forward with a masked tail; `make_serve_step` is the
serving hot path, one step per padded bucket size. Steps return device
tensors and never wait on the device, so the host runs ahead of the card
until the caller fetches a value.

Data parallel (the JAX package's GSPMD ``make_train_step`` over the
``data`` mesh): each rank runs the train step on its shard of the global
batch through `data_parallel`'s ``DistributedDataParallel`` (the gradient
mean across ranks, from autograd hooks) with the model's BatchNorms synced
over the same group; the step's metrics are global, one all-reduce of
``[loss·count, correct, count]`` per step; the eval step sums ``correct``,
``count`` and the weighted loss across ranks the same way. With no group
(one process) none of these collectives exists.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import torch

from tpu_dp_torch.data.cifar import normalize
from tpu_dp_torch.parallel import collectives


def cross_entropy_loss(logits, labels, weight=None):
    """(Weighted) mean softmax cross-entropy from integer labels, in f32
    (`nn.CrossEntropyLoss()` parity). ``weight`` masks padded examples out
    of the mean (eval's final partial batch)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    per_example = logz - true_logit
    if weight is None:
        return per_example.mean()
    return (per_example * weight).sum() / weight.sum().clamp(min=1.0)


def _select_loss_impl(use_pallas_xent: bool):
    """One source of truth for the loss implementation switch."""
    if use_pallas_xent:
        from tpu_dp_torch.ops.xent import mean_softmax_xent

        return mean_softmax_xent
    return cross_entropy_loss


def _maybe_normalize(images: torch.Tensor) -> torch.Tensor:
    """On-device normalize of uint8 batches (``x*(2/255) - 1``); float
    batches pass through."""
    if images.dtype == torch.uint8:
        return normalize(images)
    return images


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step: the update counter
    (the schedule's and the augmentation's step), the model (parameters and
    BatchNorm statistics) and the optimizer (momentum buffers)."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def data_parallel(model, ctx):
    """``model`` wrapped in ``DistributedDataParallel`` over ``ctx``'s group
    (`tpu_dp_torch.parallel.dist.DistContext`): the gradient mean across
    ranks, bucketed and booked by `collectives.counting_allreduce_hook`.

    Buffers are not broadcast (``broadcast_buffers=False``): the running
    statistics come out of the synced moments, identical on every rank,
    and a broadcast would add 40 collectives a step. Every parameter takes
    part in the loss, fused path included (``find_unused_parameters=
    False``)."""
    dev = ctx.device
    with warnings.catch_warnings():
        # Newer torch deprecates the name; its replacement still syncs
        # buffers at init and does not exist in older releases.
        warnings.filterwarnings("ignore", message=".*broadcast_buffers",
                                category=FutureWarning)
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            broadcast_buffers=False, find_unused_parameters=False)
    ddp.register_comm_hook(None, collectives.counting_allreduce_hook)
    return ddp


def _global_metrics(loss, correct, count, group):
    """``(loss, correct, count)`` over every rank's batch from this rank's
    mean ``loss`` and its ``correct`` and ``count`` tensors, in one
    all-reduce of ``[loss·count, correct, count]``. Under NCCL the
    all-reduce orders the streams and does not wait on the host."""
    total = collectives.psum(torch.stack(
        [loss * count, correct.to(loss.dtype), count.to(loss.dtype)]), group)
    correct, count = total[1:].to(torch.int64).unbind()
    return total[0] / total[2].clamp(min=1.0), correct, count


def make_train_step(model, optimizer, schedule, use_pallas_xent=False,
                    augment_fn=None, device=None,
                    process_group=None) -> Callable:
    """Build ``step(state, batch) -> metrics`` for ``model``/``optimizer``.

    ``batch`` is ``{"image": uint8 or float [B,H,W,3], "label": int [B]}``
    on ``device``. The learning rate of update k is ``schedule(k)``, read
    before ``state.step`` advances. Metrics: ``loss`` (f32 scalar tensor),
    ``correct`` (int tensor), ``count`` and ``lr`` (numbers). ``model``
    may be `data_parallel`'s wrapper; with a ``process_group`` of more
    than one rank the metrics are the global batch's (``count`` = the
    rank's batch times the world).
    """
    loss_impl = _select_loss_impl(use_pallas_xent)
    device = None if device is None else torch.device(device)
    world = collectives.world_of(process_group)
    inner = getattr(model, "module", model)  # DDP's wrapped module

    def step(state: TrainState, batch):
        images, labels = batch["image"], batch["label"]
        if device is not None and images.device != device:
            raise ValueError(f"train step on {device} got a batch on "
                             f"{images.device}")
        if not inner.training:
            model.train()
        images = _maybe_normalize(images)
        if augment_fn is not None:
            images = augment_fn(state.step, images)
        logits = model(images)
        loss = loss_impl(logits, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = schedule(state.step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        state.step += 1
        loss = loss.detach()
        correct = (logits.detach().argmax(dim=-1) == labels).sum()
        count = int(labels.shape[0])
        if world > 1:
            # The ranks' batches are equal: the global count is known here.
            loss, correct, _ = _global_metrics(
                loss, correct, torch.full_like(loss, count), process_group)
        return {"loss": loss, "correct": correct, "count": count * world,
                "lr": lr}

    return step


def make_eval_step(model, process_group=None) -> Callable:
    """Build ``step(batch) -> {loss, correct, count}`` (device tensors): the
    running-statistics forward; an optional ``batch["weight"]`` (1.0 = real
    example) masks padded rows out of all three. With a ``process_group``
    of more than one rank all three are summed over its ranks' batches
    (``loss`` the weighted mean of the union)."""
    world = collectives.world_of(process_group)

    @torch.no_grad()
    def step(batch):
        if model.training:
            model.eval()
        labels, weight = batch["label"], batch.get("weight")
        logits, predictions = _infer_forward(model, batch)
        hit = predictions == labels
        if weight is None:
            correct = hit.sum()
            count = hit.new_full((), labels.shape[0], dtype=torch.int64)
        else:
            correct = (hit * weight).sum().to(torch.int64)
            count = weight.sum().to(torch.int64)
        loss = cross_entropy_loss(logits, labels, weight)
        if world > 1:
            loss, correct, count = _global_metrics(loss, correct, count,
                                                   process_group)
        return {"loss": loss, "correct": correct, "count": count}

    return step


def _infer_forward(model, batch):
    """normalize → model (eval) → ``(logits, predictions)``; the one
    forward the serve step and the eval step share."""
    logits = model(_maybe_normalize(batch["image"]))
    return logits, torch.argmax(logits, dim=-1)


def init_serve_stats(num_classes: int, device) -> dict[str, torch.Tensor]:
    """Device-resident serving books threaded through every serve step:
    ``served`` (examples actually served, padding excluded) and
    ``class_counts`` (the per-class prediction histogram) — the device-side
    ground truth the host counters are audited against."""
    return {
        "served": torch.zeros((), dtype=torch.int64, device=device),
        "class_counts": torch.zeros(int(num_classes), dtype=torch.int64,
                                    device=device),
    }


def make_serve_step(model, device, batch_size: int) -> Callable:
    """Inference step for ONE padded bucket size.

    Returns ``step(stats, batch) -> (new_stats, out)``: ``batch`` is
    ``{"image": [B, H, W, C], "weight": f32[B]}`` on ``device`` with
    ``weight`` masking padded rows out of the books (1.0 = real example),
    ``out`` is ``{"prediction": int32[B], "confidence": f32[B]}`` (top-1
    class and its softmax probability). The books are updated in place
    (the JAX step donates them; here the same buffers are reused) and
    returned. Runs under `torch.inference_mode`.
    """
    if batch_size < 1:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    device = torch.device(device)

    @torch.inference_mode()
    def step(stats, batch):
        images, weight = batch["image"], batch["weight"]
        if images.shape[0] != batch_size or images.device != device:
            raise ValueError(
                f"serve step for bucket {batch_size} on {device} got a "
                f"batch of {images.shape[0]} on {images.device}")
        logits, predictions = _infer_forward(model, batch)
        probs = torch.softmax(logits.float(), dim=-1)
        confidence = probs.max(dim=-1).values
        # No op here waits on the device (bincount and boolean indexing
        # would): the books stay asynchronous like the forward.
        w = weight.to(torch.int64)
        stats["served"] += w.sum()
        stats["class_counts"].index_add_(0, predictions, w)
        out = {
            "prediction": predictions.to(torch.int32),
            "confidence": confidence,
        }
        return stats, out

    return step
