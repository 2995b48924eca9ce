"""The training loop of the port: the core of `tpu_dp.train.trainer.
Trainer.fit`, one process per device, data-parallel across processes.

`Trainer(cfg, device)` joins the process group (`parallel.dist.
initialize`: the launcher's env contract or the ``parallel`` section;
alone when neither is there), builds the data (train and test
`DataPipeline`s on this rank's shard), the ResNet-18 (seeded init, sync-BN
over the group), SGD and the schedule — total steps = steps per epoch ×
epochs, warmup = ``warmup_epochs`` × steps per epoch — and the train and
eval steps. With a group the model trains under `step.data_parallel`'s
DDP, and every metric is global: the batch is ``data.batch_size`` per
rank, the global batch that times the world (`global_batch_size`).
`fit` runs the epochs, prints the reference-format ``[epoch, step]
loss:`` line every ``train.log_every`` steps and a line per epoch,
evaluates at the end and prints ``Finished Training`` and the accuracy
line; rank 0 alone prints.

The loop never waits on the device inside an epoch: losses and correct
counts stay device tensors until a log line or the epoch's end fetches
them. Checkpoints, resume, guardrails, elastic world size and telemetry
are not ported yet.
"""

from __future__ import annotations

import logging
import time
from typing import Any

import torch

from tpu_dp_torch.config import Config, check_ported
from tpu_dp_torch.data.augment import make_augment_fn
from tpu_dp_torch.data.cifar import load_dataset
from tpu_dp_torch.data.pipeline import DataPipeline
from tpu_dp_torch.models import build_model, parse_fused_stages
from tpu_dp_torch.parallel.dist import initialize
from tpu_dp_torch.train.optim import make_sgd
from tpu_dp_torch.train.schedule import make_schedule
from tpu_dp_torch.train.step import (
    TrainState,
    data_parallel,
    make_eval_step,
    make_train_step,
)
from tpu_dp_torch.utils.meter import ThroughputMeter

log = logging.getLogger("tpu_dp_torch.train")


class Trainer:
    def __init__(self, cfg: Config, device=None):
        check_ported(cfg)
        self.cfg = cfg
        par = cfg.parallel
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
        self.train_pipe = DataPipeline(
            self.train_ds, cfg.data.batch_size, self.device,
            shuffle=cfg.data.shuffle, seed=seed,
            drop_remainder=cfg.data.drop_remainder,
            prefetch=cfg.data.prefetch, **shard)
        self.test_pipe = DataPipeline(
            self.test_ds, cfg.data.batch_size, self.device, shuffle=False,
            seed=seed, drop_remainder=False, prefetch=cfg.data.prefetch,
            **shard)

        self.model = build_model(
            cfg.model.name, num_classes=num_classes,
            dtype=torch.bfloat16 if cfg.model.bf16 else torch.float32,
            fused_stages=parse_fused_stages(cfg.model.fused_stages),
            fused_bwd=cfg.model.fused_bwd,
            generator=torch.Generator().manual_seed(seed),
            process_group=group,
        ).to(self.device)
        #: the module the train step runs: DDP's wrapper with a group.
        self.ddp = (data_parallel(self.model, self.ctx)
                    if self.ctx.backend is not None else None)
        self.optimizer = make_sgd(
            self.model, cfg.optim.momentum, cfg.optim.weight_decay,
            cfg.optim.decay_exclude_bias_and_norm)
        steps_per_epoch = len(self.train_pipe)
        self.schedule = make_schedule(
            cfg.optim.schedule, cfg.optim.lr,
            steps_per_epoch * cfg.train.epochs,
            int(cfg.optim.warmup_epochs * steps_per_epoch),
            cfg.optim.final_lr)
        augment_fn = (make_augment_fn(seed + 1, rank=self.ctx.rank)
                      if cfg.data.augment else None)
        self.state = TrainState(step=0, model=self.model,
                                optimizer=self.optimizer)
        self.train_step = make_train_step(
            self.ddp or self.model, self.optimizer, self.schedule,
            use_pallas_xent=cfg.train.pallas_xent, augment_fn=augment_fn,
            device=self.device, process_group=group)
        # Eval runs the unwrapped module: no gradient, nothing to reduce.
        self.eval_step = make_eval_step(self.model, process_group=group)
        self.meter = ThroughputMeter(warmup_steps=2, device=self.device)
        #: every update's global loss, fetched once per epoch (host floats).
        self.step_losses: list[float] = []

    @property
    def num_devices(self) -> int:
        """Devices in the run: one per rank."""
        return self.ctx.world

    @property
    def global_batch_size(self) -> int:
        """Per-step batch over every rank: ``data.batch_size`` × world."""
        return self.cfg.data.batch_size * self.ctx.world

    def _print(self, msg: str) -> None:
        if self.ctx.is_main_process:
            print(msg, flush=True)

    def train_epoch(self, epoch: int) -> dict[str, float]:
        cfg = self.cfg
        self.train_pipe.set_epoch(epoch)
        run_loss, run_steps = None, 0  # device-side running-loss sum
        losses, correct, count = [], None, 0
        for i, batch in enumerate(self.train_pipe):
            m = self.train_step(self.state, batch)
            losses.append(m["loss"])
            correct = m["correct"] if correct is None else correct + m[
                "correct"]
            count += m["count"]
            run_loss = m["loss"] if run_loss is None else run_loss + m["loss"]
            run_steps += 1
            self.meter.step(m["count"])
            if i % cfg.train.log_every == cfg.train.log_every - 1:
                # Reference print format; the float() is the only wait on
                # the device per log interval.
                self._print("[%d, %5d] loss: %.3f"
                            % (epoch + 1, i + 1, float(run_loss) / run_steps))
                run_loss, run_steps = None, 0
        if not losses:
            return {"loss": 0.0, "accuracy": 0.0}
        epoch_losses = torch.stack(losses).tolist()  # one fetch
        self.step_losses.extend(epoch_losses)
        stats = {"loss": sum(epoch_losses) / len(epoch_losses),
                 "accuracy": int(correct) / count}
        self.meter.mark()
        return stats

    def evaluate(self) -> dict[str, float]:
        """Test accuracy, loss and example count over every rank's shard,
        with one fetch from the device."""
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
                 "rank, %d global, %d epochs", cfg.model.name,
                 self.train_ds.name, self.device, self.ctx.rank,
                 self.ctx.world, cfg.data.batch_size, self.global_batch_size,
                 cfg.train.epochs)
        t0 = time.perf_counter()
        history = []
        for epoch in range(cfg.train.epochs):
            stats = self.train_epoch(epoch)
            history.append(stats)
            self._print("epoch %d: train loss %.4f acc %.4f (%.1f img/s)"
                        % (epoch + 1, stats["loss"], stats["accuracy"],
                           self.meter.images_per_sec))
            every = cfg.train.eval_every_epochs
            if every and (epoch + 1) % every == 0:
                ev = self.evaluate()
                self._print("epoch %d: eval loss %.4f acc %.4f"
                            % (epoch + 1, ev["loss"], ev["accuracy"]))
        self._print("Finished Training")
        result: dict[str, Any] = {
            "history": history,
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
