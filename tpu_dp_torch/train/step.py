"""The inference half of `tpu_dp.train.step` for the port.

`make_serve_step` is the serving hot path: one step per padded bucket
size, fed a batch already on the device, returning the served-books update
and the per-example outputs. Training steps come with the training slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_dp_torch.data.cifar import normalize


def _maybe_normalize(images: torch.Tensor) -> torch.Tensor:
    """On-device normalize of uint8 batches (``x*(2/255) - 1``); float
    batches pass through."""
    if images.dtype == torch.uint8:
        return normalize(images)
    return images


def _infer_forward(model, batch):
    """normalize → model (eval) → ``(logits, predictions)``; the one
    forward the serve step and any eval share."""
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
