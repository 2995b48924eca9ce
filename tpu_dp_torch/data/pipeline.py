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
  ``non_blocking``, so it runs asynchronously; PyTorch's pinned-memory
  allocator keeps a buffer from reuse until its copy is done.
- A background thread keeps ``prefetch`` placed batches ahead of the
  consumer. On a card it copies on a stream of its own and hands each
  batch over with an event: the consumer's current stream waits for the
  event, and the batch's memory is marked in use by that stream, so the
  copies overlap the consumer's work on whatever stream it runs.
- With ``accum_steps`` a > 1 (`optim.grad_accum_steps`), a consecutive
  microbatches of ``batch_size`` make one step (an optimizer update) and
  ship as one ``[a, B, ...]`` stack: one pinned buffer, one copy. It
  requires ``drop_remainder`` (the accumulating step carries no weight
  mask), and ``len`` and ``skip_steps`` count updates.
- `windows` (``train.steps_per_call``) groups an epoch's steps into full
  windows of k, each one ``[k, (a,) B, ...]`` stack placed with one copy,
  and the trailing ``len % k`` steps as single batches.
- The final partial batch (eval, ``drop_remainder=False``) is padded by
  wraparound to keep shapes static, and carries a float ``weight`` mask
  (1.0 = real example, then 0.0 for the pad) that the eval step uses to
  exclude that pad from its counts and loss. The sampler's own wraparound
  duplicates (a dataset that does not divide by the shard count) are real
  examples here and count, as in the JAX package and in the reference's
  ``DistributedSampler`` + torchmetrics eval: at world 2 a 21-image test
  set counts 22.
- ``skip_steps`` starts the epoch at a later step (the mid-epoch resume
  position): step ``s`` always draws ``idx[s*per_step:(s+1)*per_step]``,
  wherever iteration starts, so no batch is replayed and none is skipped.
- ``sync_placement`` (``data.sync_placement``) blocks the placing thread
  on every placed batch or window until its copy has landed: the copy no
  longer overlaps the consumer's work (a measurement escape hatch, off by
  default).
- The device-resident feed (``data.device_resident``): `resident_data`
  stages the whole dataset on the device once (uint8 images, int64
  labels), and `index_windows` is the twin of `windows` that ships only
  each window's int32 dataset indices, ``[n, (a,) B]``, in one small
  pinned copy; the step gathers its batch on the device
  (`tpu_dp_torch.train.step.gather_batch`). Same sampler order, same
  window and tail structure, same ``skip_steps``; no prefetch thread (a
  window's indices are kilobytes). `dataset_bytes` is the host size the
  ``resident_max_bytes`` budget is held against.
- ``sampler`` replaces the `ShardedSampler` (the JAX package's seam): an
  elastic regroup feeds the rest of an interrupted epoch from an
  `ElasticTailSampler` of the re-split indices, through the streamed
  windows and the resident index windows alike.
"""

from __future__ import annotations

import contextlib
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
                 num_shards: int = 1, shard_id: int = 0,
                 accum_steps: int = 1, sync_placement: bool = False,
                 sampler=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.accum_steps = int(accum_steps)
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if self.accum_steps > 1 and not drop_remainder:
            # A wraparound-padded final stack would give duplicated
            # examples full gradient weight (no mask in the train step).
            raise ValueError("accum_steps > 1 requires drop_remainder=True")
        self.device = torch.device(device)
        self.drop_remainder = drop_remainder
        self.prefetch = int(prefetch)
        self.sync_placement = bool(sync_placement)
        self.sampler = sampler if sampler is not None else ShardedSampler(
            len(dataset), num_shards=num_shards, shard_id=shard_id,
            shuffle=shuffle, seed=seed)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        """Steps per epoch (optimizer updates, not microbatches)."""
        per_step = self.batch_size * self.accum_steps
        shard = len(self.sampler)
        if self.drop_remainder:
            return shard // per_step
        return -(-shard // per_step)  # ceil

    def _host_batches(self, skip_steps: int = 0):
        """Yield host-side batches (numpy index arrays and the optional
        weight mask) for the current epoch, from step ``skip_steps``."""
        idx = self.sampler.shard_indices()
        per_step = self.batch_size * self.accum_steps
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

    def _step_shape(self) -> tuple[int, ...]:
        """Leading dims of one step's batch: ``(a, B)``, or ``(B,)``."""
        return ((self.accum_steps, self.batch_size) if self.accum_steps > 1
                else (self.batch_size,))

    def _place(self, take, weight, lead=None):
        """Gather ``take`` into one (pinned, on a card) host buffer shaped
        ``lead + example shape`` (one step's by default) and start its copy
        to the device; returns the device batch."""
        images, labels = self.dataset.images, self.dataset.labels
        lead = self._step_shape() if lead is None else tuple(lead)
        if weight is not None:
            lead = (len(take),)  # the eval tail: one padded batch
        pin = self.device.type == "cuda"
        img = torch.empty((len(take), *images.shape[1:]), dtype=torch.uint8,
                          pin_memory=pin)
        lab = torch.empty(len(take), dtype=torch.int64, pin_memory=pin)
        np.take(images, take, axis=0, out=img.numpy())
        lab.numpy()[:] = labels[take]
        batch = {"image": img.view(*lead, *images.shape[1:]),
                 "label": lab.view(lead)}
        if weight is not None:
            w = torch.empty(len(weight), dtype=torch.float32, pin_memory=pin)
            w.numpy()[:] = weight
            batch["weight"] = w
        placed = {k: v.to(self.device, non_blocking=True)
                  for k, v in batch.items()}
        if self.sync_placement:
            _wait_placed(self.device)
        return placed

    def _prefetched(self, items):
        """Drain ``items`` (a generator that places batches) through the
        bounded background prefetcher; early exit safe (a stop flag
        unblocks the producer). On a card the producer places on its own
        stream and hands each item over with an event (module doc)."""
        if self.prefetch <= 0:
            yield from items
            return
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None
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
                with (torch.cuda.stream(copy_stream) if cuda
                      else contextlib.nullcontext()):
                    for item in items:
                        done = None
                        if cuda:
                            done = torch.cuda.Event()
                            done.record(copy_stream)
                        if not _put((item, done)):
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
                    got = q.get(timeout=1.0)
                except queue.Empty:
                    if not t.is_alive():
                        raise RuntimeError(
                            "prefetch producer thread died without "
                            "delivering its end-of-epoch sentinel") from None
                    continue
                if got is _END:
                    break
                if isinstance(got, BaseException):
                    raise got
                item, done = got
                if done is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(done)
                    for v in _tensors(item):
                        v.record_stream(consumer)
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)

    def __iter__(self, skip_steps: int = 0):
        return self._prefetched(
            self._place(take, w)
            for take, w in self._host_batches(skip_steps))

    def windows(self, k: int, skip_steps: int = 0):
        """``(n_steps, batch)`` pairs for `tpu_dp_torch.train.step.
        MultiStep` (the JAX package's `DataPipeline.windows`): full windows
        as ``(k, pool)``, the pool ``k`` consecutive steps stacked on a
        leading axis (``[k, (a,) B, ...]``, one pinned buffer and one copy),
        then the epoch's trailing ``len(self) % k`` steps as ``(1, batch)``
        singles for the per-step path. From ``skip_steps`` the remaining
        steps are windowed anew (mid-epoch resume). ``k > 1`` requires
        ``drop_remainder`` (windows carry no weight masks)."""
        k = int(k)
        if k > 1 and not self.drop_remainder:
            raise ValueError("windows(k) requires drop_remainder=True")
        return self._prefetched(self._windows(k, int(skip_steps)))

    def _windows(self, k: int, skip_steps: int):
        steps = len(self)
        if k <= 1:
            for take, w in self._host_batches(skip_steps):
                yield 1, self._place(take, w)
            return
        idx = self.sampler.shard_indices()
        per_step = self.batch_size * self.accum_steps
        remaining = max(0, steps - skip_steps)
        full = skip_steps + remaining - remaining % k
        for s in range(skip_steps, full, k):
            yield k, self._place(idx[s * per_step:(s + k) * per_step], None,
                                 (k, *self._step_shape()))
        for take, w in self._host_batches(full):
            yield 1, self._place(take, w)

    def dataset_bytes(self) -> int:
        """Host size of the dataset's arrays (the ``resident_max_bytes``
        budget's measure, the JAX package's)."""
        return self.dataset.images.nbytes + self.dataset.labels.nbytes

    def resident_data(self) -> dict[str, torch.Tensor]:
        """The whole dataset on the pipeline's device: ``{"image": uint8
        [N, H, W, C], "label": int64 [N]}`` (the dtypes the streamed
        batches carry), copied once; on the CPU the images share the
        host array."""
        images = torch.from_numpy(self.dataset.images)
        labels = torch.from_numpy(self.dataset.labels).long()
        return {"image": images.to(self.device),
                "label": labels.to(self.device)}

    def index_windows(self, k: int, skip_steps: int = 0):
        """``(n_steps, idx)`` pairs for the resident window
        (`tpu_dp_torch.train.step.ResidentMultiStep`): the twin of
        `windows` (the JAX package's `DataPipeline.index_windows`), each
        item the int32 dataset indices ``[n, (a,) B]`` of the examples
        `windows` would ship, on the device: full windows of ``k``, then
        the epoch's trailing steps as ``n = 1``; from ``skip_steps`` the
        remaining steps are windowed anew. Requires ``drop_remainder``
        (the resident train path carries no weight masks)."""
        k = int(k)
        if not self.drop_remainder:
            raise ValueError("index_windows requires drop_remainder=True")
        return self._index_windows(k, int(skip_steps))

    def _index_windows(self, k: int, skip_steps: int):
        idx = np.ascontiguousarray(self.sampler.shard_indices(), np.int32)
        per_step = self.batch_size * self.accum_steps
        steps = len(self)
        remaining = max(0, steps - skip_steps)
        full = skip_steps + (remaining - remaining % k if k > 1 else 0)
        for s in range(skip_steps, full, k):
            yield k, self._place_indices(
                idx[s * per_step:(s + k) * per_step], k)
        for s in range(full, steps):
            yield 1, self._place_indices(
                idx[s * per_step:(s + 1) * per_step], 1)

    def _place_indices(self, take: np.ndarray, n: int) -> torch.Tensor:
        """``take`` as ``[n, (a,) B]`` int32 on the device: one pinned
        buffer (on a card) and one asynchronous copy on the current
        stream, ahead of the step that reads it."""
        buf = torch.empty(len(take), dtype=torch.int32,
                          pin_memory=self.device.type == "cuda")
        buf.numpy()[:] = take
        return buf.view(n, *self._step_shape()).to(self.device,
                                                   non_blocking=True)


def _wait_placed(device: torch.device) -> None:
    """Block until the copies issued on the current stream have landed
    (``sync_placement``); a copy to the CPU is already done."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _tensors(item):
    """The tensors of a placed batch or an ``(n, batch)`` pair."""
    if isinstance(item, tuple):
        item = item[1]
    return list(item.values())
