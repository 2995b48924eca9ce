"""The train, eval and serve steps of the port (of `tpu_dp.train.step`).

`make_train_step` is the training hot path: normalize → augment keyed by
the step → forward/backward → SGD update with the schedule's learning rate
for this update, on a batch already on the device. `make_eval_step` is the
running-statistics forward with a masked tail (the final batch's
static-shape pad weighs 0; the sampler's wraparound duplicates count, as
in the JAX package); `make_serve_step` is the
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

The device-resident feed (the JAX package's `make_multi_step_resident`):
`ResidentMultiStep` runs `MultiStep`'s window on batches gathered on the
device from the staged dataset by int32 indices (`gather_batch`), inside
the CUDA graph on a card.

The sharded weight update (``train.update_sharding=sharded``; the JAX
package's ``make_local_step`` reduce hook): the optimizer is a
`tpu_dp_torch.train.optim.ShardedUpdate` and the model runs without DDP's
reducer. After the last microbatch's backward (and the division by the
microbatch count) `_sharded_reduce` gathers the gradients into the wire
layout of each of the optimizer's exchanges, in plan order, and reduces
them (`collectives.psum_scatter` in f32 or bf16, `psum_scatter_quant`
under int8 with the optimizer's residuals); the optimizer then updates its
shard and all-gathers the parameters. Under int8 the step's metrics gain
``quant_overflow`` and ``quant_clip``, summed over the ranks in the
metrics' one all-reduce.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import warnings
from typing import Callable

import torch
import torch.distributed as dist

from tpu_dp_torch.data.cifar import normalize
from tpu_dp_torch.parallel import collectives, quant
from tpu_dp_torch.train.schedule import lr_table


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


def _global_metrics(loss, correct, count, group, extra=()):
    """``(loss, correct, count, *extra)`` over every rank's batch from this
    rank's mean ``loss`` and its ``correct``, ``count`` and ``extra``
    (integer counts, summed) tensors, in one all-reduce of ``[loss·count,
    correct, count, *extra]``. Under NCCL the all-reduce orders the
    streams and does not wait on the host."""
    total = collectives.psum(torch.stack(
        [loss * count] + [t.to(loss.dtype) for t in (correct, count)
                          + tuple(extra)]), group)
    ints = total[1:].to(torch.int64).unbind()
    return (total[0] / total[2].clamp(min=1.0), ints[0], ints[1],
            *(t.to(e.dtype) for t, e in zip(ints[2:], extra)))


def _sharded_reduce(opt):
    """The sharded update's reduce hook: the f32 gradient shard of this
    rank (the mean over ranks), one collective set per exchange of the
    `optim.ShardedUpdate` ``opt`` in plan order, over its group and wire
    codec; under int8 also the rank-local ``(overflow, clip)`` block
    counts, else ``()``."""
    group, codec = opt.group, opt.codec
    flat = opt.flat_grads()
    cast = codec.dtype if isinstance(codec, quant.CastCodec) else None
    shards, stats = [], []
    for g, ex in enumerate(opt.exchanges):
        rows = opt.wire_rows(flat, g)
        if ex.quantizes:
            shard, overflow, clip = collectives.psum_scatter_quant(
                rows, opt.residual_rows[g], group, mean=True,
                block_size=codec.block_size,
                error_feedback=codec.error_feedback)
            stats.append(torch.stack([overflow, clip]))
        else:
            shard = collectives.psum_scatter(rows, group, mean=True,
                                             dtype=cast)
        shards.append(opt.compact(shard, g))
    grad = torch.cat(shards) if len(shards) > 1 else shards[0]
    if not isinstance(codec, quant.Int8BlockCodec):
        return grad, ()
    counts = (sum(stats[1:], stats[0]) if stats
              else torch.zeros(2, dtype=torch.int32, device=grad.device))
    return grad, tuple(counts.unbind())


def launch_books() -> dict[str, int]:
    """The host-side books of the train step's device work, flat: the
    kernel wrappers' launch counts (conv by role, xent by direction) and
    `collectives.counts`. They tick where the host calls a wrapper or
    issues a collective, so under a CUDA graph they tick at capture only
    (`MultiStep.captured`, `MultiStep.replays`)."""
    from tpu_dp_torch.ops import conv_block, xent

    out = {f"conv.{k}": v for k, v in conv_block.launches_by_role.items()}
    out.update({f"xent.{k}": v for k, v in xent.launches.items()})
    out.update(collectives.counts)
    return out


class TrainStep:
    """``step(state, batch) -> metrics``: one optimizer update (see
    `make_train_step`). `update` is its device body, which `MultiStep`
    runs K times in a window, eagerly or captured in a CUDA graph: one
    body for both, so a window's updates are the per-step path's.

    The body reads no host state that changes from update to update: the
    update counter lives on the device (``step_t``, int64), the learning
    rate is looked up in the device table `lr_table` at that counter
    (clamped at the table's end, from where the schedule is constant), and
    the augmentation is keyed by it. The host's ``state.step`` stays the
    truth for checkpoints and logs; `sync_counter` writes it to the device
    when the two part (a new state, a restore)."""

    def __init__(self, model, optimizer, schedule, use_pallas_xent=False,
                 augment_fn=None, device=None, process_group=None,
                 accum_steps=1):
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.model, self.optimizer, self.schedule = model, optimizer, schedule
        #: the sharded update (`optim.ShardedUpdate`), or None.
        self.sharded = (optimizer if getattr(optimizer, "is_sharded_update",
                                             False) else None)
        int8 = self.sharded is not None and self.sharded.int8
        #: what `update` returns, in order.
        self.metric_names = ("loss", "correct") + (
            ("quant_overflow", "quant_clip") if int8 else ())
        self.loss_impl = _select_loss_impl(use_pallas_xent)
        self.augment_fn = augment_fn
        self.process_group = process_group
        self.world = collectives.world_of(process_group)
        self.accum_steps = int(accum_steps)
        self.inner = getattr(model, "module", model)  # DDP's wrapped module
        self.ddp = model if model is not self.inner else None
        if self.sharded is not None and self.ddp is not None:
            raise ValueError("the sharded update reduces the gradients "
                             "itself: pass the model, not DDP's wrapper")
        self.device = torch.device(device) if device is not None else next(
            self.inner.parameters()).device
        self.lr_table = lr_table(schedule, self.device)
        self.step_t = torch.zeros((), dtype=torch.int64, device=self.device)
        self._step_host = 0  # what step_t holds, as the host knows it

    def sync_counter(self, state: TrainState) -> None:
        """Make the device counter ``state.step`` (a write only when the
        host's step moved without it)."""
        if state.step != self._step_host:
            self.step_t.fill_(state.step)
            self._step_host = state.step

    def advance(self, state: TrainState, n: int) -> None:
        """The host's side of ``n`` updates the device has been given."""
        state.step += n
        self._step_host += n

    def count(self, labels: torch.Tensor) -> int:
        """Examples an update counts: ``accum_steps`` microbatches of
        ``labels``' last dim, on every rank."""
        return self.accum_steps * int(labels.shape[-1]) * self.world

    def check_batch(self, images: torch.Tensor, lead: tuple) -> None:
        want = lead + ((self.accum_steps,) if self.accum_steps > 1 else ())
        if images.device != self.device or tuple(
                images.shape[:len(want)]) != want:
            raise ValueError(
                f"train step on {self.device} wants batches led by {want}, "
                f"got {tuple(images.shape)} on {images.device}")

    def update(self, images: torch.Tensor, labels: torch.Tensor):
        """One optimizer update on the device: ``(loss, correct)``, 0-dim
        device tensors (the global batch's under a group), then the int8
        codec's counts when it runs (`metric_names`). With
        ``accum_steps`` a > 1 the batch is ``[a, B, ...]``: the
        microbatches run in order, augmentation keyed by ``step·a + i``,
        BatchNorm's running statistics carried from one to the next,
        gradients summed (DDP reduces only the last microbatch's backward:
        the earlier ones run under ``no_sync``, so one gradient all-reduce
        per update) and then divided by a; the loss is the microbatches'
        mean, ``correct`` their sum. The sharded update reduces once,
        after the division (`_sharded_reduce`)."""
        a = self.accum_steps
        if not self.inner.training:
            self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss_sum = correct = None
        for i in range(a):
            x, y = (images[i], labels[i]) if a > 1 else (images, labels)
            x = _maybe_normalize(x)
            if self.augment_fn is not None:
                x = self.augment_fn(self.step_t * a + i if a > 1
                                    else self.step_t, x)
            last = i == a - 1
            with (contextlib.nullcontext() if self.ddp is None or last
                  else self.ddp.no_sync()):
                logits = self.model(x)
                loss = self.loss_impl(logits, y)
                loss.backward()
            hit = (logits.detach().argmax(dim=-1) == y).sum()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            correct = hit if correct is None else correct + hit
        if a > 1:
            torch._foreach_div_([p.grad for p in self.inner.parameters()
                                 if p.grad is not None], float(a))
            loss_sum = loss_sum / a
        at = self.step_t.clamp(max=self.lr_table.numel() - 1).view(1)
        lr = self.lr_table.index_select(0, at).view(())
        extra = ()
        if self.sharded is None:
            self.optimizer.step(lr)
        else:
            grad, extra = _sharded_reduce(self.sharded)
            self.sharded.update(grad, lr)
        self.step_t.add_(1)
        if self.world > 1:
            # The ranks' batches are equal: the global count is known here.
            n = a * int(labels.shape[-1])
            loss_sum, correct, _, *extra = _global_metrics(
                loss_sum, correct, torch.full_like(loss_sum, n),
                self.process_group, extra)
        return (loss_sum, correct, *extra)

    def __call__(self, state: TrainState, batch) -> dict:
        images, labels = batch["image"], batch["label"]
        self.check_batch(images, ())
        self.sync_counter(state)
        lr = self.schedule(state.step)
        out = dict(zip(self.metric_names, self.update(images, labels)))
        self.advance(state, 1)
        return {**out, "count": self.count(labels), "lr": lr}


def make_train_step(model, optimizer, schedule, use_pallas_xent=False,
                    augment_fn=None, device=None, process_group=None,
                    accum_steps=1) -> TrainStep:
    """Build ``step(state, batch) -> metrics`` for ``model``/``optimizer``
    (`TrainStep`; ``optimizer`` is `tpu_dp_torch.train.optim.SGD`).

    ``batch`` is ``{"image": uint8 or float [B,H,W,3], "label": int [B]}``
    on ``device`` (the model's by default), with a leading
    ``accum_steps`` axis when that is above 1 (`_make_accum_body`'s
    microbatch stack). The learning rate of update k is ``schedule(k)``
    (a schedule from `make_schedule`), read on the device before the
    counter advances. Metrics: ``loss`` (f32 scalar tensor), ``correct``
    (int tensor), ``count`` and ``lr`` (numbers), and under the int8 wire
    ``quant_overflow`` and ``quant_clip`` (int tensors). ``model`` may be
    `data_parallel`'s wrapper; with a ``process_group`` of more than one
    rank the metrics are the global batch's (``count`` = the rank's
    examples times the world). ``optimizer`` may be an
    `optim.ShardedUpdate` (``model`` then unwrapped): the sharded update.
    """
    return TrainStep(model, optimizer, schedule, use_pallas_xent,
                     augment_fn, device, process_group, accum_steps)


#: eager updates before a window is captured: torch's CUDA-graph notes
#: ask DistributedDataParallel for 11 iterations (its first ones build
#: buckets and time themselves with host syncs; it counts an iteration
#: per synced forward, so per update, not per microbatch); without it,
#: enough for cuDNN's plans, the kernels' first loads and the allocator.
DDP_WARMUP_ITERS = 11
WARMUP_UPDATES = 3


class MultiStep:
    """``loop(state, pool) -> metrics``: ``num_steps`` updates in one
    dispatch (the port of `make_multi_step`'s window). ``pool`` is
    ``{"image": [K, (a,) B, ...], "label": [K, (a,) B]}`` on the device;
    metrics come back stacked per update (``loss``, ``correct`` and any
    codec counts as [K] tensors, ``lr`` a list, ``count`` per update),
    equal to K calls of the train step.

    On a card, with NCCL or no group, the window is a CUDA graph of
    ``train_step.update`` K times, reading slot i of static input
    buffers: the first windows run eagerly on the capture stream
    (`WARMUP_UPDATES`, or `DDP_WARMUP_ITERS` under DDP: real updates),
    then one window is captured there (cuDNN's
    benchmark off, ``thread_local`` capture mode so the feed's thread may
    allocate meanwhile) and every later window is the pool copied into the
    static buffers on the capture stream, one replay, and a copy of the
    [K] outputs. A capture that fails raises: there is no eager fallback
    on a card. On the CPU or under gloo (which a graph cannot capture) a
    window is the same K updates run eagerly.

    The call is stream-transparent: the capture stream waits for the
    caller's current stream first, and the caller's stream waits for the
    window after. The wrappers' counters tick at capture only:
    ``captured`` holds the books (`launch_books`) of the captured K
    updates and ``replays`` the replays since, so the launches that ran
    are the eager ones plus ``captured × replays``.
    """

    def __init__(self, train_step: TrainStep, num_steps: int, stream=None):
        if int(num_steps) < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        self.step, self.k = train_step, int(num_steps)
        dev = train_step.device
        group = train_step.process_group
        backend = None if group is None else dist.get_backend(group)
        self.graphed = dev.type == "cuda" and backend in (None, "nccl")
        self.stream = stream if stream is not None or not self.graphed else (
            torch.cuda.Stream(dev))
        need = (DDP_WARMUP_ITERS if train_step.ddp is not None
                else WARMUP_UPDATES)
        self.warmup_windows = math.ceil(need / self.k)
        self.eager_windows = 0
        self.graph = None
        self.captured: dict[str, int] | None = None
        self.replays = 0
        self.capture_ms: float | None = None
        self.capture_bytes: int | None = None
        self._static = self._out = None

    def _slot(self, inputs, i):
        """``(images, labels)`` of update i of the window's inputs."""
        images, labels = inputs
        return images[i], labels[i]

    def _window(self, *inputs):
        """K updates, slot i of the inputs each: the body eager windows run
        and the graph captures."""
        out = [self.step.update(*self._slot(inputs, i))
               for i in range(self.k)]
        return tuple(torch.stack(col) for col in zip(*out))

    def _capture(self, *inputs) -> None:
        dev = self.step.device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # as the capture does first
        held = torch.cuda.memory_reserved(dev)
        self._static = tuple(torch.empty_like(t) for t in inputs)
        before = launch_books()
        graph = torch.cuda.CUDAGraph()
        bench = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                self._out = self._window(*self._static)
        finally:
            torch.backends.cudnn.benchmark = bench
        self.capture_ms = 1e3 * (time.perf_counter() - t0)
        # What the capture holds on: the static inputs and the graph's
        # private pool (reserved; its tensors are free between replays).
        self.capture_bytes = torch.cuda.memory_reserved(dev) - held
        after = launch_books()
        self.captured = {k: after[k] - before[k] for k in after}
        self.graph = graph

    def _replay(self, *inputs):
        for static, t in zip(self._static, inputs):
            static.copy_(t)
        self.graph.replay()
        self.replays += 1
        # The graph updated these in place where the host did not look:
        # bump their versions, as the eager ops would (the model's packed
        # eval weights are cached by parameter version).
        for p in self.step.inner.parameters():
            torch.autograd.graph.increment_version(p)
        return tuple(t.clone() for t in self._out)

    def close(self) -> None:
        """Release the graph (and its pool) once the device is done with
        it; a window after this captures anew. Call before the process
        group is destroyed: a graph holds the NCCL collectives it
        captured."""
        if self.graph is not None:
            torch.cuda.synchronize(self.step.device)
            self.graph.reset()
        self.graph = self._static = self._out = None

    def __call__(self, state: TrainState, pool) -> dict:
        return self._run(state, (pool["image"], pool["label"]))

    def _run(self, state: TrainState, inputs: tuple) -> dict:
        """The window on ``inputs``, the tensors the graph copies into its
        static buffers (led by ``[K, (a,) B]``; the last one's last dim is
        the batch)."""
        self.step.check_batch(inputs[0], (self.k,))
        lrs = [self.step.schedule(state.step + i) for i in range(self.k)]
        if not self.graphed:
            self.step.sync_counter(state)
            out = self._window(*inputs)
        else:
            cur = torch.cuda.current_stream(self.step.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                self.step.sync_counter(state)
                if self.graph is None and (
                        self.eager_windows < self.warmup_windows):
                    out = self._window(*inputs)
                    self.eager_windows += 1
                else:
                    if self.graph is None:
                        self._capture(*inputs)
                    out = self._replay(*inputs)
            if cur != self.stream:
                cur.wait_stream(self.stream)
                for t in inputs:
                    t.record_stream(self.stream)
                for t in out:
                    t.record_stream(cur)
        self.step.advance(state, self.k)
        return {**dict(zip(self.step.metric_names, out)),
                "count": self.step.count(inputs[-1]), "lr": lrs}


def gather_batch(table: dict, idx: torch.Tensor) -> dict:
    """The batch the dataset indices ``idx`` name in the device-resident
    ``table`` (`DataPipeline.resident_data`): ``{"image": [*idx.shape, H,
    W, C], "label": [*idx.shape]}``, gathered on the table's device by
    `index_select` (no host sync, so a CUDA graph captures it)."""
    flat = idx.reshape(-1)
    images = table["image"].index_select(0, flat)
    return {"image": images.view(*idx.shape, *images.shape[1:]),
            "label": table["label"].index_select(0, flat).view(idx.shape)}


def _table_key(table: dict) -> tuple:
    """What a captured gather reads of ``table``: its tensors' addresses,
    shapes and dtypes."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for t in (table["image"], table["label"]))


class ResidentMultiStep(MultiStep):
    """``loop(state, table, idx) -> metrics``: the window fed by the
    device-resident dataset (the port of `make_multi_step_resident`).
    ``table`` is `DataPipeline.resident_data`'s, ``idx`` the window's
    int32 dataset indices ``[K, (a,) B]`` (`DataPipeline.index_windows`);
    update i runs `TrainStep.update` on ``gather_batch(table, idx[i])``,
    so normalize, augmentation, the forward and backward, the update,
    accumulation and the reduce hooks are `MultiStep`'s and a window
    equals K updates on the streamed batches bit for bit.

    On a card with NCCL or no group the gather is inside the CUDA graph:
    its one static input is the index buffer, and a replay copies K·B
    indices instead of K·B images. The graph reads the table at the
    address it captured: a call with another table (`_table_key`)
    releases the graph and captures anew. Eager under gloo and on the
    CPU, as `MultiStep`."""

    table: dict | None = None
    _captured_key: tuple | None = None

    def _slot(self, inputs, i):
        (idx,) = inputs
        b = gather_batch(self.table, idx[i])
        return b["image"], b["label"]

    def _capture(self, *inputs) -> None:
        super()._capture(*inputs)
        self._captured_key = _table_key(self.table)

    def __call__(self, state: TrainState, table: dict, idx) -> dict:
        if self.graph is not None and _table_key(table) != self._captured_key:
            self.close()
        self.table = table
        return self._run(state, (idx,))


def make_multi_step(train_step: TrainStep, num_steps: int,
                    stream=None) -> MultiStep:
    """``num_steps`` updates of ``train_step`` per call (`MultiStep`);
    ``stream`` is the capture stream on a card (a new one by default)."""
    return MultiStep(train_step, num_steps, stream)


def make_multi_step_resident(train_step: TrainStep, num_steps: int,
                             stream=None) -> ResidentMultiStep:
    """`make_multi_step`'s window fed by a device-resident dataset and
    indices (`ResidentMultiStep`)."""
    return ResidentMultiStep(train_step, num_steps, stream)


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
