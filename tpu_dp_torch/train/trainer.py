"""The training loop of the port: the core of `tpu_dp.train.trainer.
Trainer.fit`, one process per device, data-parallel across processes.

`Trainer(cfg, device)` joins the process group (`parallel.dist.
initialize`: the launcher's env contract or the ``parallel`` section;
alone when neither is there), builds the data (train and test
`DataPipeline`s on this rank's shard), the model (`Net`, ResNet-18 or ResNet-50;
seeded init, sync-BN over the group), SGD and the schedule — total
steps = steps per epoch × epochs, warmup = ``warmup_epochs`` × steps per
epoch — and the train and eval steps. With a group the model trains
under `step.data_parallel`'s DDP, and every metric is global: the batch
is ``data.batch_size`` per rank, the global batch that times the world
(`global_batch_size`).
`fit` runs the epochs, prints the reference-format ``[epoch, step]
loss:`` line every ``train.log_every`` steps and a line per epoch,
evaluates at the end and prints ``Finished Training`` and the accuracy
line; rank 0 alone prints.

Checkpoints (`tpu_dp_torch.checkpoint`, the JAX package's format): rank 0
saves after every epoch into ``train.ckpt_dir`` (``step_<n>`` dirs, meta
``{"epoch", "config", "seed"}``, the host snapshot taken on the training
thread and written on a worker thread), and exports ``final_params.
msgpack`` at the end; a failed write is logged and training goes on. With
``train.resume`` the newest usable save (epoch checkpoints, and snapshot-
kind saves under ``<ckpt_dir>/snapshots``) is restored before training:
rank 0 reads it and broadcasts the state and the position, every rank
then holds bit-identical parameters, buffers, momentum and step (checked),
and `fit` starts at the saved position: the next epoch after an epoch
checkpoint, the step after a snapshot's ``steps_done`` (the sampler skips
the steps already taken). The restored step drives the schedule and the
augmentation key (seed, step, rank).

Gradient accumulation (``optim.grad_accum_steps`` = a): an update takes
a microbatches of ``data.batch_size`` (`make_train_step`'s
``accum_steps``), so the global batch and every count are a times larger
and an epoch has a times fewer updates. Windows (``train.steps_per_call``
= K, 0 = auto: min(24, steps per epoch)): an epoch runs as full windows of
K updates, each one stacked host-to-device copy and one dispatch of
`make_multi_step` (on a card a replayed CUDA graph on the trainer's
capture stream, DDP built on that stream and the NCCL error handler's
event polling off, as torch's CUDA-graph notes ask), then the trailing
``len % K`` updates as single steps; losses, log lines and epoch stats
are those of K single steps.

The sharded weight update (``train.update_sharding=sharded``, with
``train.collective_dtype`` "" / "bf16" / "int8", ``train.quant_block_size``
and ``train.bucket_mb``): the model runs without DDP, the optimizer is
`optim.ShardedUpdate` over the whole group (issuing its collectives at
world 1 too when there is a group), which broadcasts rank 0's parameters
and buffers as DDP would; each rank holds 1/world of the momentum (and the
int8 residuals), the epoch save gathers them (every rank takes part, rank
0 writes), and a resume broadcasts the restored global arrays for each
rank to take its slice. The JAX package's coupling warning is logged.

The device-resident feed (``data.device_resident``; the JAX package's
default on its main path): with "auto" it is on when ``data.
drop_remainder`` holds and the train set's host bytes fit ``data.
resident_max_bytes`` (512 MiB: the CIFAR-10 train set, 153.8 MB, fits);
"on" forces it (over the budget rank 0 logs the JAX package's warning and
goes on), "off" keeps the streamed feed. The train set is staged on the
device at the first epoch (`resident_train`), and each window ships only
its int32 indices (`DataPipeline.index_windows`): full windows run
`make_multi_step_resident` (on a card the gather is inside the CUDA
graph), single steps the per-step call on the gathered batch. The
trajectory is the streamed feed's, bit for bit. Eval stays streamed.

The loop never waits on the device inside an epoch: losses and correct
counts stay device tensors until a log line or the epoch's end fetches
them; the epoch's one fetch also checks the device's update counter
against the host's. The snapshot cadence, preemption, guardrails,
elastic world size and telemetry are not ported yet.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

from tpu_dp_torch import checkpoint as ckpt_lib
from tpu_dp_torch.compat import export_params
from tpu_dp_torch.config import Config, check_ported, coupling_warning
from tpu_dp_torch.data.augment import make_augment_fn
from tpu_dp_torch.data.cifar import load_dataset
from tpu_dp_torch.data.pipeline import DataPipeline
from tpu_dp_torch.models import build_model, parse_fused_stages
from tpu_dp_torch.obs.counters import counters as _counters
from tpu_dp_torch.parallel import bucketing, quant
from tpu_dp_torch.parallel.dist import broadcast_one_to_all, initialize
from tpu_dp_torch.resilience import resume_latest
from tpu_dp_torch.train.optim import make_sgd, shard_optimizer
from tpu_dp_torch.train.schedule import make_schedule
from tpu_dp_torch.train.step import (
    TrainState,
    data_parallel,
    gather_batch,
    make_eval_step,
    make_multi_step,
    make_multi_step_resident,
    make_train_step,
)
from tpu_dp_torch.utils.meter import ThroughputMeter

log = logging.getLogger("tpu_dp_torch.train")


class Trainer:
    def __init__(self, cfg: Config, device=None):
        check_ported(cfg)
        self.cfg = cfg
        par = cfg.parallel
        if cfg.train.steps_per_call != 1:
            # torch's CUDA-graph notes: a captured NCCL collective needs
            # the error handler's event polling off, set before the group.
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        addr = par.coordinator_address
        self.ctx = initialize(
            init_method=(None if not addr else addr if "://" in addr
                         else f"tcp://{addr}"),
            world_size=par.num_processes, rank=par.process_id,
            device=device)
        self.device = self.ctx.device
        group = self.ctx.process_group
        seed = cfg.train.seed

        self.train_ds = load_dataset(
            cfg.data.dataset, cfg.data.root, train=True,
            allow_synthetic=cfg.data.allow_synthetic,
            synthetic_num_examples=cfg.data.synthetic_train_size, seed=seed)
        self.test_ds = load_dataset(
            cfg.data.dataset, cfg.data.root, train=False,
            allow_synthetic=cfg.data.allow_synthetic,
            synthetic_num_examples=cfg.data.synthetic_test_size, seed=seed)
        # The dataset determines the number of classes; an explicit config
        # value must agree (a mis-sized head trains garbage).
        num_classes = self.train_ds.num_classes
        if cfg.model.num_classes is not None and (
                cfg.model.num_classes != num_classes):
            raise ValueError(
                f"model.num_classes={cfg.model.num_classes} conflicts with "
                f"dataset {self.train_ds.name!r} ({num_classes} classes)")

        shard = dict(num_shards=self.ctx.world, shard_id=self.ctx.rank)
        accum = cfg.optim.grad_accum_steps
        self.train_pipe = DataPipeline(
            self.train_ds, cfg.data.batch_size, self.device,
            shuffle=cfg.data.shuffle, seed=seed,
            drop_remainder=cfg.data.drop_remainder,
            prefetch=cfg.data.prefetch, accum_steps=accum,
            sync_placement=cfg.data.sync_placement, **shard)
        self.test_pipe = DataPipeline(
            self.test_ds, cfg.data.batch_size, self.device, shuffle=False,
            seed=seed, drop_remainder=False, prefetch=cfg.data.prefetch,
            sync_placement=cfg.data.sync_placement, **shard)
        mode = cfg.data.device_resident
        ds_bytes = self.train_pipe.dataset_bytes()
        budget = cfg.data.resident_max_bytes
        if mode == "on" and ds_bytes > budget and self.ctx.is_main_process:
            log.warning(
                "warning: data.device_resident=on stages %d bytes, over "
                "data.resident_max_bytes=%d — staging may exhaust device "
                "memory; raise the budget or use auto", ds_bytes, budget)
        #: whether the train feed is device-resident (module doc).
        self._resident_enabled = mode == "on" or (
            mode == "auto" and cfg.data.drop_remainder
            and ds_bytes <= budget)
        self._resident_train = None

        self.model = build_model(
            cfg.model.name, num_classes=num_classes,
            dtype=torch.bfloat16 if cfg.model.bf16 else torch.float32,
            fused_stages=parse_fused_stages(cfg.model.fused_stages),
            fused_bwd=cfg.model.fused_bwd,
            generator=torch.Generator().manual_seed(seed),
            process_group=group,
        ).to(self.device)
        steps_per_epoch = len(self.train_pipe)
        spc = cfg.train.steps_per_call
        if spc == 0:
            spc = min(24, steps_per_epoch) if cfg.data.drop_remainder else 1
        #: updates per window (`make_multi_step`); 1: the per-step path.
        self.steps_per_call = max(1, spc)
        #: the capture stream of the windows' CUDA graphs, on a card.
        self.stream = (torch.cuda.Stream(self.device)
                       if self.steps_per_call > 1
                       and self.device.type == "cuda"
                       and self.ctx.backend in (None, "nccl") else None)
        tc = cfg.train
        #: the sharded weight update's optimizer runs the exchange itself.
        self.sharded = tc.update_sharding == "sharded"
        if self.sharded:
            coupled = coupling_warning(tc.bucket_mb, tc.quant_block_size,
                                       tc.collective_dtype)
            if coupled and self.ctx.is_main_process:
                log.warning("config warning: %s", coupled)
        #: the module the train step runs: DDP's wrapper with a group,
        #: built on the capture stream when there is one (torch's notes).
        self.ddp = None
        if self.sharded:
            self.optimizer = shard_optimizer(
                self.model, self.ctx.world, self.ctx.rank,
                dist.group.WORLD if self.ctx.backend is not None else None,
                cfg.optim.momentum, cfg.optim.weight_decay,
                cfg.optim.decay_exclude_bias_and_norm,
                quant.make_wire_codec(tc.collective_dtype,
                                      tc.quant_block_size),
                bucketing.parse_bucket_mb(tc.bucket_mb))
        elif self.ctx.backend is not None and self.stream is None:
            self.ddp = data_parallel(self.model, self.ctx)
        elif self.ctx.backend is not None:
            # The model's copies to the card come first; its broadcast
            # from rank 0 is done before the default stream reads it.
            here = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(here)
            with torch.cuda.stream(self.stream):
                self.ddp = data_parallel(self.model, self.ctx)
            here.wait_stream(self.stream)
            # DDP times its first 10 iterations and every 100th with host
            # syncs; none of them may fall in a capture.
            self.ddp._set_ddp_runtime_logging_sample_rate(2**31 - 1)
        if not self.sharded:
            self.optimizer = make_sgd(
                self.model, cfg.optim.momentum, cfg.optim.weight_decay,
                cfg.optim.decay_exclude_bias_and_norm)
        self.schedule = make_schedule(
            cfg.optim.schedule, cfg.optim.lr,
            steps_per_epoch * cfg.train.epochs,
            int(cfg.optim.warmup_epochs * steps_per_epoch),
            cfg.optim.final_lr)
        augment_fn = (make_augment_fn(seed + 1, rank=self.ctx.rank)
                      if cfg.data.augment else None)
        self.state = TrainState(step=0, model=self.model,
                                optimizer=self.optimizer)
        #: the update body both paths run (its device counter, its lr
        #: table); `train_step` is the per-step call, which callers may
        #: wrap.
        self.step_body = make_train_step(
            self.ddp or self.model, self.optimizer, self.schedule,
            use_pallas_xent=cfg.train.pallas_xent, augment_fn=augment_fn,
            device=self.device, process_group=group, accum_steps=accum)
        self.train_step = self.step_body
        make_window = (make_multi_step_resident if self._resident_enabled
                       else make_multi_step)
        self.multi_step = (
            make_window(self.step_body, self.steps_per_call,
                        stream=self.stream)
            if self.steps_per_call > 1 else None)
        # Eval runs the unwrapped module: no gradient, nothing to reduce.
        self.eval_step = make_eval_step(self.model, process_group=group)
        self.meter = ThroughputMeter(warmup_steps=2, device=self.device)
        #: every update's global loss, fetched once per epoch (host floats).
        self.step_losses: list[float] = []

        self.ckpt_mgr = ckpt_lib.CheckpointManager(
            cfg.train.ckpt_dir, keep=cfg.train.ckpt_keep,
            async_save=cfg.train.ckpt_async)
        # The JAX package's snapshot root (`resilience.snapshot_dir`'s
        # default): read on resume; the port writes no snapshots yet.
        self.snapshot_dir = str(Path(cfg.train.ckpt_dir) / "snapshots")
        self.start_epoch = 0
        self.start_step = 0  # step within start_epoch (mid-epoch resume)
        self.resumed_from: str | None = None
        if cfg.train.resume:
            self._maybe_resume()

    @property
    def num_devices(self) -> int:
        """Devices in the run: one per rank."""
        return self.ctx.world

    @property
    def momentum_bytes_per_rank(self) -> int:
        """Bytes of momentum this rank holds: every buffer replicated, its
        1/world shard under the sharded update."""
        if self.sharded:
            bufs = [self.optimizer.momentum_shard]
        else:
            bufs = [st.get("momentum_buffer")
                    for st in self.optimizer.state.values()]
        return sum(t.numel() * t.element_size() for t in bufs
                   if t is not None)

    @property
    def resident_train(self) -> dict[str, torch.Tensor] | None:
        """The device-resident train set, staged on first access
        (`DataPipeline.resident_data`), or None when the feed streams:
        a Trainer built only to evaluate or restore never stages it."""
        if self._resident_enabled and self._resident_train is None:
            self._resident_train = self.train_pipe.resident_data()
        return self._resident_train

    @property
    def global_batch_size(self) -> int:
        """Examples per update over every rank: ``data.batch_size`` ×
        world × ``optim.grad_accum_steps``."""
        return (self.cfg.data.batch_size * self.ctx.world
                * self.cfg.optim.grad_accum_steps)

    def _print(self, msg: str) -> None:
        if self.ctx.is_main_process:
            print(msg, flush=True)

    # -- checkpoints and resume ----------------------------------------

    def _resume_position(self, meta: dict) -> tuple[int, int]:
        """(start_epoch, start_step) a restored save's meta encodes: the
        next epoch after an epoch checkpoint; the same epoch at
        ``steps_done`` after a snapshot (the next epoch when it was taken
        at the epoch's end)."""
        if meta.get("kind") == "snapshot":
            epoch = int(meta.get("epoch", 0))
            step = int(meta.get("steps_done", 0))
            spe = len(self.train_pipe)
            if spe and step >= spe:
                return epoch + 1, 0
            return epoch, step
        return int(meta.get("epoch", -1)) + 1, 0

    def _maybe_resume(self) -> None:
        """Restore the newest usable save, agreed across the ranks: rank 0
        reads it (`resume_latest`: a corrupt candidate is quarantined and
        the next older one restores) and broadcasts the state and the
        position. Nothing to resume from, or every candidate unreadable:
        a fresh start, logged."""
        cfg = self.cfg
        info = None
        if self.ctx.is_main_process:
            try:
                _, meta, source = resume_latest(
                    self.state, cfg.train.ckpt_dir, self.snapshot_dir)
                info = (self._resume_position(meta), str(source))
            except FileNotFoundError:
                pass
            except RuntimeError:
                log.warning("resume: every candidate unreadable — starting "
                            "fresh", exc_info=True)
        if self.ctx.world > 1:
            info = broadcast_one_to_all(info)
            if info is not None:
                self._broadcast_state()
        if info is None:
            return
        (self.start_epoch, self.start_step), self.resumed_from = info
        log.info("resumed from %s at epoch %d step-in-epoch %d (global "
                 "step %d)", self.resumed_from, self.start_epoch,
                 self.start_step, self.state.step)

    def _replica_tensors(self) -> list[torch.Tensor]:
        """Parameters, buffers and (replicated) momentum buffers, in one
        fixed order."""
        out = list(self.model.state_dict().values())
        if self.sharded:
            return out
        if any(g.get("momentum", 0.0) for g in self.optimizer.param_groups):
            for p in self.model.parameters():
                st = self.optimizer.state[p]
                if st.get("momentum_buffer") is None:
                    st["momentum_buffer"] = torch.zeros_like(p)
                out.append(st["momentum_buffer"])
        return out

    def _broadcast_state(self) -> None:
        """Rank 0's restored state on every rank (in place), then a check
        that every rank holds the same bytes and step. The sharded
        update's restored global arrays go as one object, each rank taking
        its slice."""
        tensors = broadcast_one_to_all(self._replica_tensors())
        if self.sharded:
            opt = self.optimizer
            glob = broadcast_one_to_all(
                opt.restored if self.ctx.is_main_process else None)
            opt.load_state(*glob)
        self.state.step = broadcast_one_to_all(self.state.step)
        h = hashlib.sha256(str(self.state.step).encode())
        for t in tensors:
            h.update(t.detach().cpu().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
        digests = [None] * self.ctx.world
        dist.all_gather_object(digests, h.hexdigest())
        if len(set(digests)) != 1:
            raise RuntimeError("resume: the ranks' states differ after the "
                               "broadcast")

    def _ckpt_write_error(self, err: BaseException) -> None:
        """A failed checkpoint or export write costs durability, loudly —
        never the run."""
        _counters.inc("ckpt.write_errors")
        log.warning("checkpoint write failed (%s) — training continues; "
                    "resume falls back to the newest earlier complete save",
                    err)

    def _save_epoch(self, epoch: int) -> None:
        """The epoch checkpoint (rank 0 writes; the unwrapped module, so no
        ``module.`` reaches the file)."""
        meta = {"epoch": epoch, "config": self.cfg.to_dict(),
                "seed": self.cfg.train.seed}
        try:
            self.ckpt_mgr.save(self.state, meta)
        except (RuntimeError, OSError) as e:
            self._ckpt_write_error(e)

    def _export_final(self) -> None:
        """Join the last epoch save, then write ``final_params.msgpack``."""
        try:
            self.ckpt_mgr.wait()
        except RuntimeError as e:
            self._ckpt_write_error(e)
        try:
            ckpt_lib.save_params(
                Path(self.cfg.train.ckpt_dir) / "final_params.msgpack",
                export_params({k: p.detach().cpu() for k, p in
                               self.model.named_parameters()}))
        except OSError as e:
            self._ckpt_write_error(e)

    # -- training --------------------------------------------------------

    def train_epoch(self, epoch: int, start_step: int = 0
                    ) -> dict[str, float]:
        """One epoch; ``start_step`` > 0 resumes it after that many steps
        (no batch replayed, none skipped). Full windows of
        ``steps_per_call`` updates go to `multi_step`, single steps to
        `train_step` (on the batch gathered from `resident_train` when the
        feed is resident); a window's stacked metrics are booked update by
        update, as K single steps would be."""
        cfg = self.cfg
        every = cfg.train.log_every
        self.train_pipe.set_epoch(epoch)
        # Device losses not yet logged (1-D pieces; the first `logged`
        # values of their concatenation are), and updates since the log.
        pending, logged, run_steps = [], 0, 0
        losses, correct, count, quant_counts = [], None, 0, None
        i = start_step
        table = self.resident_train
        feed = (self.train_pipe.windows if table is None
                else self.train_pipe.index_windows)
        for n, item in feed(self.steps_per_call, skip_steps=start_step):
            if n == 1:
                m = self.train_step(self.state, item if table is None
                                    else gather_batch(table, item[0]))
                c = m["correct"]
            else:
                m = (self.multi_step(self.state, item) if table is None
                     else self.multi_step(self.state, table, item))
                c = m["correct"].sum()
            if "quant_overflow" in m:
                c8 = torch.stack([m["quant_overflow"].sum(),
                                  m["quant_clip"].sum()]).to(torch.int64)
                quant_counts = (c8 if quant_counts is None
                                else quant_counts + c8)
            loss = m["loss"].reshape(-1)
            losses.append(loss)
            pending.append(loss)
            correct = c if correct is None else correct + c
            count += n * m["count"]
            self.meter.step(n * m["count"])
            for _ in range(n):
                i += 1
                run_steps += 1
                if i % every == 0:
                    # Reference print format; the fetch is the only wait
                    # on the device per log interval.
                    flat = torch.cat(pending)
                    vals = flat[logged:logged + run_steps].tolist()
                    self._print("[%d, %5d] loss: %.3f"
                                % (epoch + 1, i, sum(vals) / len(vals)))
                    pending = [flat[logged + run_steps:]]
                    logged = run_steps = 0
        if not losses:
            return {"loss": 0.0, "accuracy": 0.0}
        # One fetch: the epoch's losses, the device's update counter and
        # the int8 codec's block counts.
        flat = torch.cat(losses).double()
        tail = [self.step_body.step_t.double().view(1)]
        if quant_counts is not None:
            tail.append(quant_counts.double())
        fetched = torch.cat([flat] + tail).tolist()
        epoch_losses, rest = fetched[:flat.numel()], fetched[flat.numel():]
        device_step = int(rest[0])
        if quant_counts is not None:
            overflow, clip = int(rest[1]), int(rest[2])
            _counters.inc("quant.overflow", overflow)
            _counters.inc("quant.clip_blocks", clip)
        if device_step != self.state.step:
            raise RuntimeError(f"the device's update counter reads "
                               f"{device_step}, the host's {self.state.step}")
        self.step_losses.extend(epoch_losses)
        stats = {"loss": sum(epoch_losses) / len(epoch_losses),
                 "accuracy": int(correct) / count}
        if quant_counts is not None:
            stats.update(quant_overflow=overflow, quant_clip=clip)
        self.meter.mark()
        return stats

    def evaluate(self) -> dict[str, float]:
        """Test accuracy, loss and example count over every rank's shard,
        with one fetch from the device. The count is the JAX package's: the
        sampler's wraparound duplicates (a test set that does not divide by
        the world) count, the final batch's static-shape pad does not."""
        correct = count = loss_sum = None
        for batch in self.test_pipe:
            m = self.eval_step(batch)
            batch_loss_sum = m["loss"] * m["count"]  # mean → sum
            if correct is None:
                correct, count, loss_sum = m["correct"], m["count"], \
                    batch_loss_sum
            else:
                correct = correct + m["correct"]
                count = count + m["count"]
                loss_sum = loss_sum + batch_loss_sum
        if count is None:
            return {"accuracy": 0.0, "loss": 0.0, "count": 0}
        correct, count, loss_sum = torch.stack(
            [correct.double(), count.double(), loss_sum.double()]).tolist()
        n = max(int(count), 1)
        return {"accuracy": correct / n, "loss": loss_sum / n,
                "count": int(count)}

    def fit(self) -> dict[str, Any]:
        cfg = self.cfg
        log.info("training %s on %s (%s, rank %d of %d): batch %d per "
                 "rank × %d microbatches, %d global, %d epochs, %d updates "
                 "per call, %s feed", cfg.model.name,
                 self.train_ds.name, self.device, self.ctx.rank,
                 self.ctx.world, cfg.data.batch_size,
                 cfg.optim.grad_accum_steps, self.global_batch_size,
                 cfg.train.epochs, self.steps_per_call,
                 "resident" if self._resident_enabled else "streamed")
        t0 = time.perf_counter()
        history = []
        for epoch in range(self.start_epoch, cfg.train.epochs):
            stats = self.train_epoch(
                epoch, self.start_step if epoch == self.start_epoch else 0)
            history.append(stats)
            self._print("epoch %d: train loss %.4f acc %.4f (%.1f img/s)"
                        % (epoch + 1, stats["loss"], stats["accuracy"],
                           self.meter.images_per_sec))
            self._save_epoch(epoch)
            every = cfg.train.eval_every_epochs
            if every and (epoch + 1) % every == 0:
                ev = self.evaluate()
                self._print("epoch %d: eval loss %.4f acc %.4f"
                            % (epoch + 1, ev["loss"], ev["accuracy"]))
        self._print("Finished Training")
        self._export_final()
        result: dict[str, Any] = {
            "history": history,
            "start_epoch": self.start_epoch,
            "resumed_from": self.resumed_from,
            "wall_time_s": time.perf_counter() - t0,
            # The meter counts global images (every rank's batch).
            "images_per_sec": self.meter.images_per_sec,
            "images_per_sec_per_card":
                self.meter.images_per_sec / self.ctx.world,
        }
        if cfg.train.eval_at_end:
            result["eval"] = self.evaluate()
            self._print("Accuracy of the network on the %d test images: %d %%"
                        % (len(self.test_ds),
                           int(100 * result["eval"]["accuracy"])))
        return result
