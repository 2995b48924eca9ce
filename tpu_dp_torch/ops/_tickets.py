"""Ticket counters of the kernels' one-launch cross-block sums
(`csrc/ordered_reduce.cuh`): zeroed int32 buffers, one per (device,
stream).

A launch that sums across its blocks takes integer tickets on these
counters, and the block that finishes each sum sets its counter back to 0
before it exits, so a buffer is zero between launches. It is zeroed once
when made, and made again, larger, when a launch needs more; the kernels
allocate nothing. Launches on one stream run one after another, so the conv
and xent kernels share a stream's buffer; launches on two streams may
overlap, so two streams never share one. A buffer that is zero at rest lets
a launch be captured in a CUDA graph and replayed, as long as it exists
before the capture: made inside one, its zeroing would be recorded in the
graph and its memory taken from the graph's pool. So `tickets` raises
instead of allocating on a stream that is capturing; a launch on the
capturing stream before the capture (the trainer's warm-up) makes the
buffer.
"""

from __future__ import annotations

import torch

_buffers: dict[tuple[int, int], torch.Tensor] = {}


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zero int32 counters on ``device`` for launches on its
    current stream."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _buffers.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"ticket counters for {n} would be allocated inside a CUDA "
                f"graph capture (stream {key[1]} of {device}): run the "
                f"launch once on the capturing stream before the capture")
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _buffers[key] = buf
    return buf
