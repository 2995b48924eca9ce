"""Batching + prefetch to the device: the port's input feed (the host-batch
part of `tpu_dp.data.pipeline`).

- Each process draws its shard of the epoch's global permutation from
  `ShardedSampler` (``shard_id::num_shards``, padded by wraparound so
  every rank has the same number of batches of the same size: a mean of
  the ranks' means is then the global batch's mean) and gathers
  ``batch_size`` examples per step on the host; the global batch is
  ``batch_size x num_shards``.
- Batches ship as uint8 images and int64 labels and are normalized on the
  device inside the step (4x fewer bytes than float32). The gather writes
  straight into page-locked (pinned) buffers, and the copy to the card is
  ``non_blocking``, so it runs asynchronously on the stream; PyTorch's
  pinned-memory allocator keeps a buffer from reuse until its copy is done.
- A background thread keeps ``prefetch`` placed batches ahead of the
  consumer.
- The final partial batch (eval, ``drop_remainder=False``) is padded by
  wraparound to keep shapes static, and carries a float ``weight`` mask
  (1.0 = real example, then 0.0 for the pad) that the eval step uses to
  exclude that pad from its counts and loss. The sampler's own wraparound
  duplicates (a dataset that does not divide by the shard count) are real
  examples here and count, as in the JAX package and in the reference's
  ``DistributedSampler`` + torchmetrics eval: at world 2 a 21-image test
  set counts 22.
- ``skip_steps`` starts the epoch at a later step (the mid-epoch resume
  position): step ``s`` always draws ``idx[s*B:(s+1)*B]``, wherever
  iteration starts, so no batch is replayed and none is skipped.

The JAX package's scan windows and its device-resident feed are not
ported yet.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from tpu_dp_torch.data.cifar import ArrayDataset
from tpu_dp_torch.data.sampler import ShardedSampler

_END = object()


class DataPipeline:
    """Iterable over device-placed batches of one dataset."""

    def __init__(self, dataset: ArrayDataset, batch_size: int, device,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True, prefetch: int = 2,
                 num_shards: int = 1, shard_id: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.device = torch.device(device)
        self.drop_remainder = drop_remainder
        self.prefetch = int(prefetch)
        self.sampler = ShardedSampler(len(dataset), num_shards=num_shards,
                                      shard_id=shard_id, shuffle=shuffle,
                                      seed=seed)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        """Steps per epoch."""
        shard = len(self.sampler)
        if self.drop_remainder:
            return shard // self.batch_size
        return -(-shard // self.batch_size)  # ceil

    def _host_batches(self, skip_steps: int = 0):
        """Yield host-side batches (numpy index arrays and the optional
        weight mask) for the current epoch, from step ``skip_steps``."""
        idx = self.sampler.shard_indices()
        per_step = self.batch_size
        for s in range(int(skip_steps), len(self)):
            take = idx[s * per_step:(s + 1) * per_step]
            weight = None
            if len(take) < per_step:
                # Pad-by-wraparound for a static shape; the weight mask
                # zeroes the pad out of the eval counts and loss. np.resize
                # tiles the shard if the pad exceeds its length.
                pad = per_step - len(take)
                weight = np.concatenate([np.ones(len(take), np.float32),
                                         np.zeros(pad, np.float32)])
                take = np.concatenate([take, np.resize(idx, pad)])
            yield take, weight

    def _place(self, take, weight):
        """Gather ``take`` into (pinned, on a card) host buffers and start
        their copies to the device; returns the device batch."""
        images, labels = self.dataset.images, self.dataset.labels
        pin = self.device.type == "cuda"
        img = torch.empty((len(take), *images.shape[1:]), dtype=torch.uint8,
                          pin_memory=pin)
        lab = torch.empty(len(take), dtype=torch.int64, pin_memory=pin)
        np.take(images, take, axis=0, out=img.numpy())
        lab.numpy()[:] = labels[take]
        batch = {"image": img, "label": lab}
        if weight is not None:
            w = torch.empty(len(weight), dtype=torch.float32, pin_memory=pin)
            w.numpy()[:] = weight
            batch["weight"] = w
        return {k: v.to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _prefetched(self, items):
        """Drain ``items`` through the bounded background prefetcher; early
        exit safe (a stop flag unblocks the producer)."""
        if self.prefetch <= 0:
            yield from items
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def _producer():
            try:
                for item in items:
                    if not _put(item):
                        return
                _put(_END)
            except BaseException as e:  # surface in the consumer
                _put(e)

        t = threading.Thread(target=_producer, name="tpu_dp_torch-prefetch",
                             daemon=True)
        t.start()
        try:
            while True:
                # Bounded get: a producer that died without its sentinel
                # must not wedge the consumer.
                try:
                    item = q.get(timeout=1.0)
                except queue.Empty:
                    if not t.is_alive():
                        raise RuntimeError(
                            "prefetch producer thread died without "
                            "delivering its end-of-epoch sentinel") from None
                    continue
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)

    def __iter__(self, skip_steps: int = 0):
        return self._prefetched(
            self._place(take, w)
            for take, w in self._host_batches(skip_steps))
