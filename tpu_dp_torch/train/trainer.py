"""The training loop of the port: the core of `tpu_dp.train.trainer.
Trainer.fit`, single process on one device.

`Trainer(cfg, device)` builds the data (train and test `DataPipeline`s),
the ResNet-18 (seeded init), SGD and the schedule — total steps = steps
per epoch × epochs, warmup = ``warmup_epochs`` × steps per epoch — and the
train and eval steps. `fit` runs the epochs, prints the reference-format
``[epoch, step] loss:`` line every ``train.log_every`` steps and a line per
epoch, evaluates at the end and prints ``Finished Training`` and the
accuracy line.

The loop never waits on the device inside an epoch: losses and correct
counts stay device tensors until a log line or the epoch's end fetches
them. Checkpoints, resume, guardrails, elastic world size, telemetry and
multi-rank data parallelism are not ported yet: a world size above 1
(``WORLD_SIZE``) raises `NotPortedError`.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any

import torch

from tpu_dp_torch.config import Config, NotPortedError, check_ported
from tpu_dp_torch.data.augment import make_augment_fn
from tpu_dp_torch.data.cifar import load_dataset
from tpu_dp_torch.data.pipeline import DataPipeline
from tpu_dp_torch.models import build_model, parse_fused_stages
from tpu_dp_torch.parallel.dist import resolve_device
from tpu_dp_torch.train.optim import make_sgd
from tpu_dp_torch.train.schedule import make_schedule
from tpu_dp_torch.train.step import TrainState, make_eval_step, make_train_step
from tpu_dp_torch.utils.meter import ThroughputMeter

log = logging.getLogger("tpu_dp_torch.train")


class Trainer:
    def __init__(self, cfg: Config, device=None):
        check_ported(cfg)
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world > 1:
            raise NotPortedError(
                f"WORLD_SIZE={world}: multi-rank training is not ported to "
                f"tpu_dp_torch yet (ROADMAP.md)")
        self.cfg = cfg
        self.device = resolve_device(device)
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

        self.train_pipe = DataPipeline(
            self.train_ds, cfg.data.batch_size, self.device,
            shuffle=cfg.data.shuffle, seed=seed,
            drop_remainder=cfg.data.drop_remainder,
            prefetch=cfg.data.prefetch)
        self.test_pipe = DataPipeline(
            self.test_ds, cfg.data.batch_size, self.device, shuffle=False,
            seed=seed, drop_remainder=False, prefetch=cfg.data.prefetch)

        self.model = build_model(
            cfg.model.name, num_classes=num_classes,
            dtype=torch.bfloat16 if cfg.model.bf16 else torch.float32,
            fused_stages=parse_fused_stages(cfg.model.fused_stages),
            fused_bwd=cfg.model.fused_bwd,
            generator=torch.Generator().manual_seed(seed),
        ).to(self.device)
        self.optimizer = make_sgd(
            self.model, cfg.optim.momentum, cfg.optim.weight_decay,
            cfg.optim.decay_exclude_bias_and_norm)
        steps_per_epoch = len(self.train_pipe)
        self.schedule = make_schedule(
            cfg.optim.schedule, cfg.optim.lr,
            steps_per_epoch * cfg.train.epochs,
            int(cfg.optim.warmup_epochs * steps_per_epoch),
            cfg.optim.final_lr)
        augment_fn = make_augment_fn(seed + 1) if cfg.data.augment else None
        self.state = TrainState(step=0, model=self.model,
                                optimizer=self.optimizer)
        self.train_step = make_train_step(
            self.model, self.optimizer, self.schedule,
            use_pallas_xent=cfg.train.pallas_xent, augment_fn=augment_fn,
            device=self.device)
        self.eval_step = make_eval_step(self.model)
        self.meter = ThroughputMeter(warmup_steps=2, device=self.device)
        #: every update's loss, fetched once per epoch (host floats).
        self.step_losses: list[float] = []

    @property
    def num_devices(self) -> int:
        return 1

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
                print("[%d, %5d] loss: %.3f"
                      % (epoch + 1, i + 1, float(run_loss) / run_steps),
                      flush=True)
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
        """Test accuracy and loss with one fetch from the device."""
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
            return {"accuracy": 0.0, "loss": 0.0}
        correct, count, loss_sum = torch.stack(
            [correct.double(), count.double(), loss_sum.double()]).tolist()
        n = max(int(count), 1)
        return {"accuracy": correct / n, "loss": loss_sum / n}

    def fit(self) -> dict[str, Any]:
        cfg = self.cfg
        log.info("training %s on %s (%s): batch %d, %d epochs",
                 cfg.model.name, self.train_ds.name, self.device,
                 cfg.data.batch_size, cfg.train.epochs)
        t0 = time.perf_counter()
        history = []
        for epoch in range(cfg.train.epochs):
            stats = self.train_epoch(epoch)
            history.append(stats)
            print("epoch %d: train loss %.4f acc %.4f (%.1f img/s)"
                  % (epoch + 1, stats["loss"], stats["accuracy"],
                     self.meter.images_per_sec), flush=True)
            every = cfg.train.eval_every_epochs
            if every and (epoch + 1) % every == 0:
                ev = self.evaluate()
                print("epoch %d: eval loss %.4f acc %.4f"
                      % (epoch + 1, ev["loss"], ev["accuracy"]), flush=True)
        print("Finished Training", flush=True)
        result: dict[str, Any] = {
            "history": history,
            "wall_time_s": time.perf_counter() - t0,
            "images_per_sec": self.meter.images_per_sec,
        }
        if cfg.train.eval_at_end:
            result["eval"] = self.evaluate()
            print("Accuracy of the network on the %d test images: %d %%"
                  % (len(self.test_ds), int(100 * result["eval"]["accuracy"])),
                  flush=True)
        return result
