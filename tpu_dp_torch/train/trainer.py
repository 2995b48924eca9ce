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
augmentation key. The crop and flip draws are the JAX package's
`jax.random` bits (`tpu_dp_torch.data.augment`): a rank draws its rows
``[rank·B, (rank+1)·B)`` of the global (micro)batch, and under the sharded
update rows ``0..B-1``, as the JAX package's per-shard step does.

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
against the host's.

Resilience, as the JAX package builds it under its default config: the
IO retry budget (``resilience.io_retry_s``) of every checkpoint and
snapshot write; `SnapshotManager` (``resilience.snapshot_every_steps``,
``snapshot_keep``, ``snapshot_dir``), whose host copy is enqueued after
the window into reusable pinned buffers; `PreemptionHandler`
(``resilience.handle_signals``): a SIGTERM or SIGINT at any point becomes
a final snapshot at the next window boundary (or the epoch's end), joined,
a barrier on the group and `PreemptedError`; the fault injector
(``resilience.fault`` / ``TPU_DP_FAULT``); and the flight recorder
(``obs.flightrec_capacity``, dumped into ``obs.run_dir`` or
``<ckpt_dir>/obs`` on every exit from `fit`). The step-lifecycle hooks
(`tpu_dp_torch.train.hooks`) run once per window, after its updates:
flight recorder, snapshot cadence, fault injection, preemption boundary.
Each rank reads its own preemption flag, as in the JAX package.

The guard (``guard.enabled``; `tpu_dp_torch.resilience.guard`): the train
step is the sentinel step (`make_train_step`'s ``sentinel``), each window
gets its guard input from `hooks.GuardHook` (the armed loss cap, the LR
ease, the ``nan:``/``spike:`` seam) and the hook, right after the flight
recorder, fetches the window's health once, settles ``state.step`` to the
device's counter, writes ``quarantine.jsonl`` (``guard.quarantine_path``)
and escalates: ``action=rollback`` raises `_GuardRollback` out of
`train_epoch` and `fit` rewinds to the newest complete, non-quarantined
save (`_execute_guard_rollback`: rank 0 decides and broadcasts, the state
restored in place so a captured window keeps training the same tensors),
``halt`` raises `DivergedError` (exit 65 from the CLI). Two clocks, as in
the JAX package: ``state.step`` counts applied updates (the schedule's and
the augmentation's step), `_host_step` dispatched batches (the hooks', the
snapshots' and the faults' clock, the snapshots' ``global_step``); they
part on every quarantined batch.

Telemetry (`tpu_dp_torch.obs`), as the JAX package builds it: rank 0
appends schema-3 records to ``metrics.jsonl`` (``train.metrics_path``, by
default ``<ckpt_dir>/metrics.jsonl``) at every ``train.obs`` mode: one per
epoch, the eval record, the guard's events. ``train.obs=basic`` records
each window's ``data_wait`` and ``dispatch`` spans (split over its
updates), the efficiency gauges (``obs.mfu``, ``obs.goodput``,
``obs.step_time_ms``: `obs.costs`) and heartbeats, with no added host
synchronisation; rank 0 checks every rank's heartbeats at the log
boundary (already a fetch) and at epoch ends. ``full`` adds the ``h2d``
span (device time still spent placing the window's input after the host
had it, from CUDA events) and the fence-to-fence ``device`` span (one
CUDA-event synchronize per window, after its dispatch) and one record per
update. Nothing is recorded inside a captured window. ``obs.prom_path``
is rewritten at log boundaries, epoch ends and exit; rank 0 writes
``trace.perfetto.json`` at the end of `fit`; ``train.profile_dir`` traces
the whole of `fit` with `torch.profiler`, or only ``train.profile_steps``.
``obs.comm_profile_steps`` (rank 0; never with ``train.profile_*``)
captures its windows into ``obs.comm_profile_dir`` (``<obs dir>/
commprof``), parses each trace (`obs.kineto`), reconciles the collectives
in it with the books of what ran and publishes the comm/compute/overlap
report (`obs.commprof`): the ``comm_profile`` event, ``<obs dir>/
comm_report.json``, the ``obs.comm_ms``, ``obs.exposed_comm_ms`` and
``obs.overlap_frac`` gauges, the flight recorder and the promfile.

Elastic world size, the graceful shrink (``resilience.elastic``;
`tpu_dp_torch.resilience.elastic`): a rank told to go (SIGTERM,
``preempt:``, ``leave:``) checks in on the membership ledger at its next
window boundary and every member keeps stepping to the agreed stop step,
where rank 0 commits the final snapshot (stamped with the epoch's
consumption lineage) and the leaver raises `PreemptedError` (exit 143).
The survivors release the windows' graphs, form the new group at world
N-1 (`dist.elastic_initialize`, the run's backend), rebuild everything the
group touches (`_build_world`), reload the snapshot through the
resharding checkpoint path and re-split the rest of the epoch over
themselves (`_set_elastic_tail`); every later record carries its
``membership_epoch``. The rollback flavour: a member that dies without a
word (its peers' collectives fail: `dist.is_peer_failure`; on NCCL the
window boundary's bounded fence, `dist.PeerFence`, gives up on a wedged
replay and the communicators are aborted), that rank 0's health check
finds stale (a suspect on the ledger) or that the SDC audit condemns
(`hooks.GuardHook`) leaves the run: the survivors abandon the failed
group (a collective or a fence waits on a peer a third of the window at
most: `dist.PEER_WAIT_SHARE`), check in with rollback flavour, and the
acting leader declares the silent member departed once
``resilience.regroup_timeout_s`` passes; the survivors re-form at world
N-1, reload the newest complete save (not a final snapshot), rebuild the
re-split tail from its lineage and replay the updates since it. A
rollback whose members are all alive and staying is no membership event:
every rank re-raises. The grow: a process that is not a member (a
departed rank relaunched, `run_elastic` after a fired ``relaunch:``, or
``resilience.elastic_join=auto|always`` with a stable id) asks to join
before it forms any group (`elastic.maybe_join`); the members see the
request at a window boundary and run a graceful quiesce whose plan admits
it (flavour ``grow``: the final snapshot at the stop step), the incumbent
leader waits for the joiner's ``join_ready`` (bounded by
``regroup_timeout_s``) and publishes the verdict, and everyone forms the
group at world N+1; the joiner restores the grow's snapshot (never its
own disk: `_adopt_join_resume`), and the interrupted epoch's rest is
re-split over the grown world. A joiner that never comes costs the
incumbents that wait; they re-form at world N from the same snapshot
(``grow_aborted``).
"""

from __future__ import annotations

import fnmatch
import hashlib
import json
import logging
import os
import sys
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
from tpu_dp_torch.obs import costs as _costs
from tpu_dp_torch.obs import flightrec as _flightrec
from tpu_dp_torch.obs.counters import counters as _counters
from tpu_dp_torch.obs.counters import update_device_memory_gauges
from tpu_dp_torch.parallel import bucketing, collectives, quant
from tpu_dp_torch.parallel.dist import (
    broadcast_one_to_all,
    collect_released,
    fault_tolerant_barrier,
    initialize,
)
from tpu_dp_torch.resilience import (
    FaultInjector,
    PreemptedError,
    PreemptionHandler,
    SnapshotManager,
    configure_io_retry,
    find_candidates,
    quarantine_save_dir,
    resume_latest,
)
from tpu_dp_torch.resilience.faultinject import refuse_unported
from tpu_dp_torch.train import hooks as hooks_lib
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
from tpu_dp_torch.utils.profiling import (
    ChromeTrace,
    StepProfiler,
    parse_profile_steps,
    profile_trace,
)

log = logging.getLogger("tpu_dp_torch.train")


def _timing_event(device) -> torch.cuda.Event:
    """A timing CUDA event recorded now on ``device``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _iso_ts(epoch_seconds: float) -> str:
    """ISO-8601 UTC stamp for metrics records (millisecond resolution)."""
    from datetime import datetime, timezone

    return datetime.fromtimestamp(
        epoch_seconds, timezone.utc).isoformat(timespec="milliseconds")


class _RegroupSignal(Exception):
    """Raised out of `train_epoch` by a survivor when a quiesce completed:
    the group must shrink before the next step (`Trainer.
    _execute_regroup`). Internal control flow; never escapes `fit()`."""

    def __init__(self, epoch: int, done: int, plan):
        super().__init__(f"elastic regroup at epoch {epoch} step {done}")
        self.epoch = int(epoch)
        self.done = int(done)
        self.plan = plan


class _GuardRollback(Exception):
    """Raised out of `train_epoch` by the guard hook when the divergence
    policy escalates to rollback: rewind to the newest complete (and
    non-quarantined) save before the next step
    (`Trainer._execute_guard_rollback`). Internal control flow; never
    escapes `fit()`."""

    def __init__(self, epoch: int, done: int, trigger):
        super().__init__(
            f"guard rollback at epoch {epoch} step {done}: {trigger.reason}")
        self.epoch = int(epoch)
        self.done = int(done)
        self.trigger = trigger


class Trainer:
    def __init__(self, cfg: Config, device=None):
        check_ported(cfg)
        self.cfg = cfg
        par = cfg.parallel
        if cfg.train.steps_per_call != 1 or cfg.resilience.elastic:
            # torch's CUDA-graph notes: a captured NCCL collective needs
            # the error handler's event polling off, set before the group.
            # An elastic run finds a dead peer at its window fence
            # (`dist.PeerFence`) and aborts the communicators itself.
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        #: the admission of a process that JOINS a live elastic run instead
        #: of starting one (`elastic.maybe_join`): it replaces the
        #: bootstrap, since the joiner's world and dense rank exist only
        #: once the members admit it.
        self._join = None
        if cfg.resilience.elastic:
            from tpu_dp_torch.resilience.elastic import maybe_join

            self._join = maybe_join(cfg, device=device)
        if self._join is not None:
            self.ctx = self._join.ctx
        else:
            addr = par.coordinator_address
            self.ctx = initialize(
                init_method=(None if not addr else addr if "://" in addr
                             else f"tcp://{addr}"),
                world_size=par.num_processes, rank=par.process_id,
                device=device)
        self.device = self.ctx.device
        # Elastic world size (`resilience.elastic`): this rank's stable id
        # is its rank at the generation's start (a joiner's, the one it was
        # admitted with); dense ranks are reassigned per membership epoch,
        # stable ids never.
        self.stable_rank = (self._join.coordinator.sid if self._join
                            else self.ctx.rank)
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

        #: the guard (module doc): the sentinel step and `GuardHook`.
        self.guard_enabled = bool(cfg.guard.enabled)
        self._num_classes = num_classes
        #: the re-split rest of an interrupted epoch after a regroup (or a
        #: resume into one), and the epoch's consumption lineage so far.
        self._elastic_tail = None
        self._epoch_lineage: list[list[int]] = []
        #: the `ElasticCoordinator` of an elastic run (end of __init__).
        self.elastic = None
        self._build_world()
        mode, budget = cfg.data.device_resident, cfg.data.resident_max_bytes
        ds_bytes = self.train_pipe.dataset_bytes()
        if mode == "on" and ds_bytes > budget and self.ctx.is_main_process:
            log.warning(
                "warning: data.device_resident=on stages %d bytes, over "
                "data.resident_max_bytes=%d — staging may exhaust device "
                "memory; raise the budget or use auto", ds_bytes, budget)
        tc = cfg.train
        if self.sharded:
            coupled = coupling_warning(tc.bucket_mb, tc.quant_block_size,
                                       tc.collective_dtype)
            if coupled and self.ctx.is_main_process:
                log.warning("config warning: %s", coupled)
        self.meter = ThroughputMeter(warmup_steps=2, device=self.device)
        #: every update's global loss, fetched once per epoch (host floats).
        self.step_losses: list[float] = []

        self.ckpt_mgr = ckpt_lib.CheckpointManager(
            cfg.train.ckpt_dir, keep=cfg.train.ckpt_keep,
            async_save=cfg.train.ckpt_async)
        # Resilience, in the JAX package's order: the IO retry budget, the
        # snapshot manager (always built: with the cadence off the
        # preemption final still lands there), the preemption handler and
        # the fault injector.
        res = cfg.resilience
        configure_io_retry(res.io_retry_s)
        self.snapshot_dir = res.snapshot_dir or str(
            Path(cfg.train.ckpt_dir) / "snapshots")
        self.snap_mgr = SnapshotManager(
            self.snapshot_dir, every_steps=res.snapshot_every_steps,
            keep=res.snapshot_keep, async_save=cfg.train.ckpt_async)
        self.preempt = PreemptionHandler() if res.handle_signals else None
        self.fault = FaultInjector.from_spec(res.fault, rank=self.ctx.rank)
        if self.fault is not None:
            refuse_unported(self.fault.kinds(), self.guard_enabled)
        # Guardrail run state: the rollback generation stamps every
        # quarantine record and snapshot written after a rewind, and an SDC
        # finding suppresses snapshots (`hooks.SnapshotHook`).
        self._rollback_gen = 0
        self._sdc_suspect_active = False
        #: the SDC audit named this rank corrupt: it leaves (rollback).
        self._guard_evict = False
        #: the batch clock (module doc); set from the update counter after
        #: a resume, as in the JAX package.
        self._host_step = 0
        # The flight recorder: always on (obs.flightrec_capacity 0 turns it
        # off), dumped into obs.run_dir or <ckpt_dir>/obs on every exit
        # from fit.
        self.obs_dir = Path(cfg.obs.run_dir
                            or Path(cfg.train.ckpt_dir) / "obs")
        self.flightrec = None
        if cfg.obs.flightrec_capacity <= 0:
            _flightrec.recorder.disable()
        else:
            # Named by the stable rank; a rejoined incarnation's dump is
            # tagged with the membership epoch that admitted it, beside its
            # predecessor's departure dump.
            self.flightrec = _flightrec.recorder.configure(
                rank=self.stable_rank, dump_dir=self.obs_dir,
                capacity=cfg.obs.flightrec_capacity, fresh=True,
                tag=(f"me{self._join.record.epoch:04d}"
                     if self._join is not None else ""),
                run={"model": cfg.model.name, "world": self.ctx.world,
                     "devices": self.num_devices,
                     "global_batch": self.global_batch_size,
                     "elastic": bool(cfg.resilience.elastic),
                     "guard": self.guard_enabled,
                     "joined": self._join is not None})
        self._build_telemetry()
        self._register_program_costs()
        self._build_hooks()
        self.start_epoch = 0
        self.start_step = 0  # step within start_epoch (mid-epoch resume)
        self.resumed_from: str | None = None
        if cfg.train.resume and self._join is None:
            self._maybe_resume()
        elif cfg.train.resume:
            log.info("elastic join: ignoring --resume — a joiner's state "
                     "comes from the admitted membership record's "
                     "snapshot, never its stale local disk")
        self._host_step = int(self.state.step)
        #: the batch clock at `step_losses`' first entry (`fit` resets it).
        self._losses_from = self._host_step
        self._quiesce_plan = None
        self._q_flavor = "graceful"
        #: epoch steps done at the last boundary (`_elastic_rollback`), and
        #: the epoch's device losses so far (kept past a peer failure).
        self._epoch_done = 0
        self._inflight_losses: list[torch.Tensor] = []
        #: the bounded window fence of an elastic NCCL run (module doc).
        self._peer_fence = None
        if res.elastic and self._join is not None:
            # The admission attached this process to the live generation:
            # the record's resume is the state, the step clock and the
            # re-split tail.
            self.elastic = self._join.coordinator
            self._adopt_join_resume(self._join.record)
        elif res.elastic:
            self.elastic = self._build_elastic()
        if res.elastic:
            if self.ctx.backend == "nccl":
                from tpu_dp_torch.parallel.dist import PeerFence

                self._peer_fence = PeerFence(self.device,
                                             self._peer_wait_s)
            self._bound_peer_waits()
        if self._join is not None:
            self._complete_join(self._join.record)

    def _adopt_join_resume(self, record) -> None:
        """Install the admitting record's resume: the state from the grow
        quiesce's final snapshot (``resume.snapshot_dir``) through the
        resharding load, never this process's own disk (a retired
        incarnation's); the step clock, the snapshot cadence, the lineage
        and the re-split tail as the incumbents set theirs
        (`_execute_regroup`). A snapshot that fails its checksums raises
        `ElasticError`: restoring other bytes than the incumbents hold is
        never silent (their join gate or rendezvous then times out and
        they re-form without this process)."""
        from tpu_dp_torch.resilience.elastic import ElasticError

        resume = dict(record.resume or {})
        snap = resume.get("snapshot_dir")
        if snap:
            try:
                ckpt_lib.load_checkpoint(Path(snap), self.state)
            except ckpt_lib.CorruptCheckpointError as e:
                raise ElasticError(
                    f"elastic join: admitted snapshot {snap} failed "
                    f"checksum verification — aborting the join ({e})"
                ) from e
        else:
            # The run itself restarted from scratch at this epoch.
            self._log0("elastic join: admitted record carries no snapshot "
                       "— starting from init like the incumbents")
        self._host_step = int(resume.get("global_step", 0))
        self._losses_from = self._host_step
        self.snap_mgr.rewind(self._host_step)
        self.start_epoch, self.start_step = self._lineage_position(
            int(resume.get("epoch", 0)), int(resume.get("steps_done", 0)),
            resume.get("lineage") or [])
        self._log0("elastic join: adopted resume — epoch %d step %d (global "
                   "step %d, membership epoch %d, world %d)",
                   self.start_epoch, self.start_step, self._host_step,
                   record.epoch, record.world)

    def _complete_join(self, record) -> None:
        """The joiner's half of `_execute_regroup`'s epilogue: its
        ``elastic_join`` flight-recorder event, the observers homed into
        the membership epoch, the guard's fresh audit baseline, then the
        same ``regroup_ready`` barrier the incumbents meet."""
        from tpu_dp_torch.parallel.dist import membership_barrier

        _flightrec.record("elastic_join", step=self._host_step,
                          sid=self.stable_rank,
                          membership_epoch=record.epoch, world=record.world,
                          rank=self.ctx.rank)
        self._rebuild_observers(record)
        if self._guard_hook is not None:
            self._guard_hook.on_regroup()
        membership_barrier("regroup_ready", record.epoch,
                           timeout_s=self.cfg.resilience.regroup_timeout_s)
        log.info("elastic join: membership epoch %d live — joined at world "
                 "%d as dense rank %d (stable id %d)", record.epoch,
                 record.world, self.ctx.rank, self.stable_rank)

    def _build_elastic(self):
        """The run's `ElasticCoordinator`. Its generation key joins what
        every rank already agrees on (the resumed step, the launch world)
        with a token rank 0 mints into the group's store, so a restarted
        launch gets a fresh ledger directory even when it resumes from the
        same step (the JAX package's key)."""
        import uuid

        from tpu_dp_torch.parallel.dist import agree_token
        from tpu_dp_torch.resilience.elastic import ElasticCoordinator

        res = self.cfg.resilience
        nonce = agree_token("elastic_gen", lambda: uuid.uuid4().hex[:8],
                            timeout_s=res.regroup_timeout_s)
        return ElasticCoordinator(
            res.membership_dir or str(
                Path(self.cfg.train.ckpt_dir) / "membership"),
            generation=(f"gen_{self._host_step:010d}_w{self.ctx.world}"
                        f"_{nonce}"),
            sid=self.stable_rank, world=self.ctx.world,
            coordinator_address=self.ctx.coordinator_address,
            regroup_timeout_s=res.regroup_timeout_s,
            poll_every_steps=res.elastic_poll_every_steps,
            coordinator_host=res.elastic_coordinator_host,
            min_world=res.elastic_min_world,
            max_world=res.elastic_max_world)

    @property
    def _peer_wait_s(self) -> float:
        """How long an elastic run waits on a peer (`dist.
        PEER_WAIT_SHARE` of the collection window)."""
        from tpu_dp_torch.parallel.dist import PEER_WAIT_SHARE

        return self.cfg.resilience.regroup_timeout_s * PEER_WAIT_SHARE

    def _bound_peer_waits(self) -> None:
        """An elastic gloo group's collectives wait on a peer
        `_peer_wait_s` at most (set once the group and its DDP are built;
        NCCL's wait is the window fence's)."""
        if self.ctx.backend == "gloo":
            from tpu_dp_torch.parallel.dist import set_collective_timeout

            set_collective_timeout(self._peer_wait_s)

    def _build_world(self) -> None:
        """Everything that depends on the group: the train and test
        pipelines on this rank's shard, the resident decision, the model
        (sync-BN over the group), the window size and capture stream, DDP
        or the sharded update, SGD, the schedule (its length from this
        world's steps per epoch), the augmentation's rows, a fresh state,
        and the train, window and eval steps. Run at construction and
        again by an elastic regroup on the new group (`_execute_regroup`),
        as the JAX package rebuilds its pipelines and programs."""
        cfg = self.cfg
        group = self.ctx.process_group
        seed = cfg.train.seed
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
        #: whether the train feed is device-resident (module doc).
        self._resident_enabled = mode == "on" or (
            mode == "auto" and cfg.data.drop_remainder
            and self.train_pipe.dataset_bytes()
            <= cfg.data.resident_max_bytes)
        self._resident_train = None
        self.model = self._init_model(group).to(self.device)
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
        augment_fn = None
        if cfg.data.augment:
            # The JAX package's draws: the replicated step augments the
            # global (micro)batch, whose rows [rank·B, (rank+1)·B) this
            # rank holds; the sharded update's per-shard body draws its
            # local rows 0..B-1 on every rank (`make_train_step_shard_map`).
            b = cfg.data.batch_size
            augment_fn = make_augment_fn(
                seed + 1, row0=0 if self.sharded else self.ctx.rank * b,
                global_n=b if self.sharded else self.ctx.world * b)
        self.state = TrainState(step=0, model=self.model,
                                optimizer=self.optimizer)
        #: the update body both paths run (its device counter, its lr
        #: table); `train_step` is the per-step call, which callers may
        #: wrap.
        self.step_body = make_train_step(
            self.ddp or self.model, self.optimizer, self.schedule,
            use_pallas_xent=cfg.train.pallas_xent, augment_fn=augment_fn,
            device=self.device, process_group=group, accum_steps=accum,
            sentinel=self.guard_enabled)
        self.train_step = self.step_body
        make_window = (make_multi_step_resident if self._resident_enabled
                       else make_multi_step)
        self.multi_step = (
            make_window(self.step_body, self.steps_per_call,
                        stream=self.stream)
            if self.steps_per_call > 1 else None)
        #: `multi_step`'s `RecompileGuard` (`_guarded`), rebuilt with it
        #: at a regroup; None unguarded.
        self._window_guard = self._guarded(
            f"resident_loop[w{self.steps_per_call}]"
            if self._resident_enabled else "multi_step", self.multi_step)
        # Eval runs the unwrapped module: no gradient, nothing to reduce.
        self.eval_step = make_eval_step(self.model, process_group=group)

    def _guarded(self, name: str, program):
        """A `RecompileGuard` over a window program
        (``train.recompile_guard``), as the JAX package's trainer wraps
        its steps; None when it runs unguarded.

        warmup_calls=2, the JAX package's count; the guard's baseline is
        the first capture in any case (a window's ``_cache_size`` is None
        until then: its eager warm-up windows compile nothing). Without
        ``data.drop_remainder`` the window runs unguarded, as the JAX
        package's steps do there. On the CPU and under gloo the window is
        eager and the guard inert."""
        mode = self.cfg.train.recompile_guard
        if (program is None or mode == "off"
                or not self.cfg.data.drop_remainder):
            return None
        from tpu_dp_torch.analysis.recompile import RecompileGuard

        return RecompileGuard(program, name=name, on_retrace=mode,
                              warmup_calls=2)

    def _init_model(self, group=None) -> torch.nn.Module:
        """The model as a fresh run initializes it (on the CPU), from the
        seed."""
        cfg = self.cfg
        return build_model(
            cfg.model.name, num_classes=self._num_classes,
            dtype=torch.bfloat16 if cfg.model.bf16 else torch.float32,
            fused_stages=parse_fused_stages(cfg.model.fused_stages),
            fused_bwd=cfg.model.fused_bwd,
            generator=torch.Generator().manual_seed(cfg.train.seed),
            process_group=group)

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

    @property
    def quarantine_path(self) -> Path:
        """The quarantine.jsonl sink (``guard.quarantine_path``, by default
        ``<ckpt_dir>/quarantine.jsonl``)."""
        return Path(self.cfg.guard.quarantine_path
                    or Path(self.cfg.train.ckpt_dir) / "quarantine.jsonl")

    def _print(self, msg: str) -> None:
        if self.ctx.is_main_process:
            print(msg, flush=True)

    def _log0(self, msg: str, *args, **kwargs) -> None:
        if self.ctx.is_main_process:
            log.info(msg, *args, **kwargs)

    def _build_telemetry(self) -> None:
        """The live telemetry of ``train.obs`` (module doc): nothing at
        off, where the loop runs untelemetered; at basic and full the span
        ring, this rank's heartbeat writer, rank 0's health monitor and
        the efficiency meter (its peak the card's dense bf16 one, or
        ``obs.peak_flops_override``; an unknown card publishes no MFU).
        The step-ranged profiler at any mode."""
        from tpu_dp_torch.obs.health import HealthMonitor, HeartbeatWriter
        from tpu_dp_torch.obs.spans import SpanRecorder

        cfg = self.cfg
        self._metrics_file = None  # opened by _log_metrics (rank 0)
        self._hb_write_failed = False  # one-shot heartbeat-failure warning
        self._prom_failed = False  # one-shot prom-write failure warning
        self.obs_mode = cfg.train.obs
        self.spans = self.heartbeat = self.health = None
        self._eff = None
        self._last_efficiency: dict | None = None
        if self.obs_mode != "off":
            self.spans = SpanRecorder(capacity=cfg.obs.span_capacity)
            if cfg.obs.heartbeat_every_steps > 0 and self._join is None:
                # Every rank appends to its own heartbeat file. A joiner
                # never writes into the launch's obs root, where its dense
                # rank's file belongs to another seat: `_complete_join`
                # homes it into obs/me<E>/.
                self.heartbeat = HeartbeatWriter(
                    self.obs_dir, rank=self.ctx.rank,
                    every_steps=cfg.obs.heartbeat_every_steps)
            if self.heartbeat is not None and self.ctx.is_main_process:
                self.health = HealthMonitor(
                    self.obs_dir, world=self.ctx.world,
                    straggler_factor=cfg.obs.straggler_factor,
                    stale_after_s=cfg.obs.stale_after_s,
                    min_step_ms=cfg.obs.min_step_ms,
                    on_flag=cfg.obs.on_straggler,
                    logger=lambda msg: log.warning("health: %s", msg))
            peak = cfg.obs.peak_flops_override or None
            if peak is None and self.device.type == "cuda":
                peak = _costs.peak_flops(
                    torch.cuda.get_device_name(self.device))
            self._eff = _costs.EfficiencyMeter(
                peak=peak, capacity=cfg.obs.span_capacity)
        # torch.profiler: one Chrome trace per rank (`utils.profiling`),
        # with the CPU ops under gloo (its collectives are host ops).
        self._tracer = ChromeTrace(rank=self.ctx.rank,
                                   cuda=self.device.type == "cuda",
                                   cpu=self.ctx.backend == "gloo")
        profile_range = parse_profile_steps(cfg.train.profile_steps)
        self._step_profiler = None
        if profile_range is not None:
            self._step_profiler = StepProfiler(
                cfg.train.profile_dir, *profile_range,
                start_fn=self._tracer.start, stop_fn=self._tracer.stop)
        self._comm_profiler = None
        self._build_comm_profiler()

    def _build_comm_profiler(self) -> None:
        """The comm-attribution capture driver (rank 0 only; `config.
        check_ported` refuses it beside ``train.profile_*``: profiler
        sessions cannot nest). Its expected collectives are the books of
        what ran (`_collective_books`), with the resident feed as with
        the streamed one; the sharded update's wire is held against
        `quant.wire_report` for this world. Built again against the new
        world after an elastic regroup (`_execute_regroup`)."""
        from tpu_dp_torch.obs import chips
        from tpu_dp_torch.obs.commprof import (
            CommProfiler,
            parse_comm_profile_steps,
        )

        cfg = self.cfg
        spec = parse_comm_profile_steps(cfg.obs.comm_profile_steps)
        if spec is None or not self.ctx.is_main_process:
            return
        trace_dir = cfg.obs.comm_profile_dir or str(self.obs_dir / "commprof")
        wire_report = None
        if self.sharded:
            wire_report = quant.wire_report(
                self.optimizer.leaves, self.ctx.world,
                cfg.train.quant_block_size,
                bucket_bytes=bucketing.parse_bucket_mb(cfg.train.bucket_mb))
        cuda = self.device.type == "cuda"
        self._comm_profiler = CommProfiler(
            trace_dir, spec, devices=1, world=self.ctx.world,
            books_fn=self._collective_books,
            source="device" if cuda and self.ctx.backend != "gloo"
            else "host",
            wire_report=wire_report,
            wire_dtype=cfg.train.collective_dtype or "",
            link_gbs=(chips.link_gbs(torch.cuda.get_device_name(self.device))
                      if cuda else None),
            publish=self._publish_comm_report,
            start_fn=self._tracer.start, stop_fn=self._tracer.stop)
        self._log0("comm profile: windows %r -> %s",
                   cfg.obs.comm_profile_steps, trace_dir)

    def _collective_books(self) -> dict[str, int]:
        """The collectives that ran, counts and bytes (`collectives.
        books`), a window's replays included (`MultiStep.
        replayed_books`)."""
        books = collectives.books()
        if self.multi_step is not None:
            for k, v in self.multi_step.replayed_books.items():
                books[k] += v
        return books

    def _publish_comm_report(self, report: dict, start: int, end: int,
                             trace_dir: str) -> None:
        """One captured window's breakdown -> metrics event + report file.

        The gauges were already set by the CommProfiler (they ride the
        next records' counter snapshots and the promfile); this stamps
        the schema-3 ``comm_profile`` event and rewrites
        ``<obs dir>/comm_report.json`` (newest window wins — the file is
        a gauge, the metrics stream the history).
        """
        from tpu_dp_torch.obs.commprof import write_comm_report

        recon = report.get("reconciliation") or {}
        self._log_metrics({
            "event": "comm_profile",
            "start_step": start,
            "end_step": end,
            "comm_ms": report["comm_ms"],
            "exposed_comm_ms": report["exposed_comm_ms"],
            "overlap_frac": report["overlap_frac"],
            "compute_ms": report["compute_ms"],
            "reconciled": recon.get("ok"),
            "by_kind": {k: v["per_step"]
                        for k, v in report["by_kind"].items()},
            "trace_dir": trace_dir,
        })
        write_comm_report(self.obs_dir / "comm_report.json", report)
        self._write_prom()
        self._log0("comm profile [%d, %d): comm %.3f ms/step (exposed %.3f, "
                   "overlap %s), compute %.3f ms/step%s — %s",
                   start, end, report["comm_ms"], report["exposed_comm_ms"],
                   report["overlap_frac"], report["compute_ms"],
                   "" if not recon else (
                       ", books reconciled" if recon.get("ok")
                       else ", nothing to reconcile" if recon.get("ok") is None
                       else ", RECONCILIATION MISMATCH"),
                   trace_dir)

    def _register_program_costs(self) -> None:
        """Stamp one optimizer step's per-card cost into the process-wide
        cost registry under "train_step", aliased to the windowed tags the
        loop dispatches (`obs.costs`): the analytic per-model estimate, or
        with ``obs.measure_flops`` (and telemetry on) one step counted by
        `obs.costs.count_train_flops` on the model's plain path, checked
        against the analytic count."""
        cfg = self.cfg
        per_chip = self.global_batch_size / max(1, self.num_devices)
        model = cfg.model.name
        cost = _costs.registry.register_analytic("train_step", model,
                                                 per_chip)
        if cfg.obs.measure_flops and self.obs_mode != "off":
            b, accum = cfg.data.batch_size, cfg.optim.grad_accum_steps
            shape = (b, *self.train_ds.images.shape[1:])
            try:
                plain = build_model(
                    model, num_classes=self._num_classes,
                    dtype=torch.bfloat16 if cfg.model.bf16
                    else torch.float32)
                step_flops = accum * _costs.count_train_flops(
                    plain, torch.empty(shape),
                    torch.empty(b, dtype=torch.int64))
            except Exception:
                self._log0("obs.measure_flops: counting the step failed; "
                           "keeping the analytic estimate", exc_info=True)
                step_flops = None
            if step_flops:
                resolved, source, check = _costs.resolve_flops_per_step(
                    None, step_flops, 1, per_chip,
                    _costs.train_flops_per_image(model))
                cost = _costs.registry.register("train_step", resolved,
                                                source=source, check=check)
                self._log0("obs: measured step cost %.3g FLOPs/step/card "
                           "(%s, check=%s)", resolved, source, check)
        if cost is not None:
            for tag in ("multi_step", "resident_loop[w1]",
                        f"resident_loop[w{self.steps_per_call}]"):
                _costs.registry.alias(tag, "train_step")
            _counters.gauge("obs.flops_per_step_per_chip",
                            cost.flops_per_step_per_chip)

    def _build_hooks(self) -> None:
        """The step-lifecycle hooks, in the JAX package's load-bearing
        order (`tpu_dp_torch.train.hooks`): the flight recorder first, then
        the guard, the snapshot cadence, fault injection, heartbeats, the
        step-ranged profiler, the comm attribution's windows, and the
        preemption boundary last."""
        self._guard_hook = (hooks_lib.GuardHook(self) if self.guard_enabled
                            else None)
        hooks: list = []
        if self.flightrec is not None:
            hooks.append(hooks_lib.FlightRecorderHook(self))
        if self._guard_hook is not None:
            hooks.append(self._guard_hook)
        hooks += [hooks_lib.SnapshotHook(self), hooks_lib.FaultHook(self),
                  hooks_lib.HeartbeatHook(self), hooks_lib.ProfilerHook(self),
                  hooks_lib.CommProfilerHook(self),
                  hooks_lib.BoundaryHook(self)]
        self._hooks = hooks

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
        if cfg.resilience.elastic:
            self._maybe_resume_into_tail(self.resumed_from)
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
        """A failed checkpoint or export write costs durability, loudly
        (the counter, the log and the flight recorder) — never the run."""
        _counters.inc("ckpt.write_errors")
        _flightrec.record("ckpt_write_error", step=self._host_step,
                          error=str(err)[:300])
        log.warning("checkpoint write failed (%s) — training continues; "
                    "resume falls back to the newest earlier complete save",
                    err)

    def _snapshot_meta(self, epoch: int, steps_done: int) -> dict[str, Any]:
        """A snapshot's meta: the mid-epoch resume position (the JAX
        package's keys)."""
        meta = {"kind": "snapshot", "epoch": epoch, "steps_done": steps_done,
                "config": self.cfg.to_dict(), "seed": self.cfg.train.seed}
        if self._rollback_gen:
            # A post-rollback save names its generation (the tombstoned
            # quarantine records of the pass it replaced).
            meta["rollback_generation"] = self._rollback_gen
        membership = self._membership_meta(steps_done)
        if membership is not None:
            meta["membership"] = membership
        return meta

    def _segment_steps(self, done: int) -> int:
        """Steps of the current world's segment out of ``done`` epoch
        steps (the part `_epoch_lineage` does not cover)."""
        return int(done) - sum(int(s) for _, s in self._epoch_lineage)

    def _membership_meta(self, steps_done: int) -> dict | None:
        """An elastic snapshot's membership stamp (the JAX package's keys):
        the membership epoch, world and members, and the interrupted
        epoch's whole consumption ``lineage`` (the prior segments and the
        one in flight), from which a later reader rebuilds the remaining
        sample set with `elastic_resplit`."""
        if self.elastic is None:
            return None
        rec = self.elastic.record
        return {"epoch": rec.epoch, "world": self.ctx.world,
                "members": list(rec.members),
                "lineage": [list(map(int, seg)) for seg in self._epoch_lineage]
                + [[self.ctx.world, self._segment_steps(steps_done)]]}

    def _set_elastic_tail(self, epoch: int, lineage, skip: int = 0) -> bool:
        """Install the re-split rest of an interrupted epoch (`elastic_
        resplit` over this world, an `ElasticTailSampler` pipeline);
        ``skip`` fast-forwards within the tail. False when the lineage
        already covers the whole epoch (the caller goes on to the next)."""
        from types import SimpleNamespace

        from tpu_dp_torch.data.sampler import (
            ElasticTailSampler,
            elastic_resplit,
        )

        cfg = self.cfg
        lineage = [list(map(int, seg)) for seg in lineage]
        per_step = cfg.data.batch_size * cfg.optim.grad_accum_steps
        idx = elastic_resplit(len(self.train_ds), cfg.data.shuffle,
                              cfg.train.seed, epoch, per_step, lineage,
                              self.ctx.world, self.ctx.rank)
        steps = len(idx) // per_step
        if steps - int(skip) <= 0:
            self._elastic_tail = None
            self._epoch_lineage = []
            return False
        self._epoch_lineage = lineage
        pipe = DataPipeline(
            self.train_ds, cfg.data.batch_size, self.device,
            shuffle=cfg.data.shuffle, seed=cfg.train.seed,
            drop_remainder=True, prefetch=cfg.data.prefetch,
            accum_steps=cfg.optim.grad_accum_steps,
            sync_placement=cfg.data.sync_placement,
            sampler=ElasticTailSampler(idx, epoch))
        self._elastic_tail = SimpleNamespace(
            epoch=int(epoch), pipe=pipe,
            base=sum(s for _, s in lineage), skip=int(skip))
        self._log0("elastic: epoch %d re-split over world %d — %d prior "
                   "step(s) across %s, %d step(s) remain (resuming %d in)",
                   epoch, self.ctx.world, self._elastic_tail.base, lineage,
                   steps, skip)
        return True

    def _maybe_resume_into_tail(self, resume_dir: str) -> None:
        """Honour a snapshot's membership lineage on a restart: an epoch
        consumed across several worlds cannot resume by the one-world
        skip. Every rank reads the meta itself (an elastic run's ckpt tree
        is shared) and installs the re-split tail for this launch's world."""
        try:
            meta = ckpt_lib.read_meta(resume_dir)
        except (OSError, ValueError):
            return
        lineage = (meta.get("membership") or {}).get("lineage") or []
        if meta.get("kind") != "snapshot" or not lineage:
            return
        if len(lineage) == 1 and int(lineage[0][0]) == self.ctx.world:
            return  # a one-world epoch: the standard skip is exact
        self.start_epoch, self.start_step = self._lineage_position(
            int(meta.get("epoch", 0)), self.start_step, lineage)

    def _lineage_position(self, epoch: int, steps_done: int,
                          lineage) -> tuple[int, int]:
        """Where a save of ``epoch`` at ``steps_done``, stamped with the
        consumption ``lineage``, continues at this world: by the standard
        skip when the epoch ran at this world alone; otherwise on the
        re-split tail (`_set_elastic_tail`), less what a last segment at
        this world already ran, or at the next epoch when nothing
        remains."""
        lineage = [[int(w), int(n)] for w, n in lineage]
        world = self.ctx.world
        if not lineage or (len(lineage) == 1 and lineage[0][0] == world):
            self._elastic_tail = None
            self._epoch_lineage = []
            return epoch, steps_done
        if lineage[-1][0] == world:
            # The last segment ran at this world: its tail is this run's
            # stream too, less what it already ran.
            prior, skip = lineage[:-1], lineage[-1][1]
        else:
            prior, skip = lineage, 0
        if self._set_elastic_tail(epoch, prior, skip=skip):
            return epoch, 0
        return epoch + 1, 0

    def _take_snapshot(self, epoch: int, steps_done: int,
                       wait: bool = False) -> bool:
        """One snapshot and the ``on_snapshot`` hook sweep. False when the
        write degraded (counted and logged by the snapshot manager; with
        ``wait`` a failure of the joined write too): the hooks see only
        snapshots that committed. Every rank calls it at the same boundary
        (the sharded update's gather is a collective)."""
        meta = self._snapshot_meta(epoch, steps_done)
        if self._peer_fence is not None:
            # The window before this boundary may still run on the card
            # (one stays in flight): a save of it must wait for its
            # collectives, bounded, or it could keep a wedged window's state.
            self._peer_fence.drain()
        out = self.snap_mgr.snapshot(self.state, self._host_step, meta)
        if out is None:
            return False
        if wait:
            try:
                self.snap_mgr.wait()
            except (RuntimeError, OSError) as e:
                self.snap_mgr._record_write_error(self._host_step, e)
                return False
        for hook in self._hooks:
            hook.on_snapshot(epoch, steps_done, self._host_step, meta)
        return True

    def _preempt_exit(self, epoch: int, steps_done: int) -> None:
        """The preemption contract: final snapshot (joined) → barrier on
        the process group → `PreemptedError` (exit 143 from the CLI)."""
        _flightrec.record("preempt_exit", step=self._host_step, epoch=epoch,
                          done=steps_done)
        self._log0("preemption: taking final snapshot at epoch %d step %d "
                   "(global step %d)", epoch, steps_done, self._host_step)
        if not self._take_snapshot(epoch, steps_done, wait=True):
            # Degrade, still honor the 143 contract: the resume falls back
            # to the newest earlier complete save.
            self._log0("preemption: final snapshot FAILED — resume will "
                       "fall back to the newest earlier complete save")
        if self.ctx.backend is not None:
            res = self.cfg.resilience
            try:
                fault_tolerant_barrier(retries=res.max_retries,
                                       base_delay=res.retry_base_delay_s)
            except Exception:
                # A half-dead group must not block the others' clean exit:
                # the snapshot is already committed.
                self._log0("preemption barrier failed; exiting anyway",
                           exc_info=True)
        raise PreemptedError(
            f"preempted at epoch {epoch}, step-in-epoch {steps_done} "
            f"(global step {self._host_step}); snapshot committed to "
            f"{self.snapshot_dir}")

    def _save_epoch(self, epoch: int) -> None:
        """The epoch checkpoint (rank 0 writes; the unwrapped module, so no
        ``module.`` reaches the file)."""
        meta = {"epoch": epoch, "config": self.cfg.to_dict(),
                "seed": self.cfg.train.seed}
        if self.elastic is not None:
            # Which membership epoch and world finished this dataset epoch
            # (no lineage: an epoch checkpoint resumes at an epoch start).
            rec = self.elastic.record
            meta["membership"] = {"epoch": rec.epoch,
                                  "world": self.ctx.world,
                                  "members": list(rec.members)}
        try:
            self.ckpt_mgr.save(self.state, meta)
        except (RuntimeError, OSError) as e:
            self._ckpt_write_error(e)

    def _inject_sdc(self, plan) -> None:
        """Apply an ``sdc:`` fault: flip the top exponent bit (bit 30 of an
        f32) of the first element of each parameter leaf matching the
        plan's ``leaf=`` glob over the JAX leaf paths (default: the first
        leaf), on this rank's replica only (tests only). In place: a
        captured window reads the flipped bit, and the version bump makes
        the packed eval weights repack. A high bit, not a low one, as in
        the JAX package: a denormal flip of a zero leaf would be absorbed
        by the next identical update, leaving nothing to audit."""
        from tpu_dp_torch.compat import param_leaves

        named = dict(self.model.named_parameters())
        leaves = param_leaves(named)
        paths = [key for key, _, _ in leaves]
        targets = ([p for p in paths if fnmatch.fnmatch(p, plan.leaf)]
                   if plan.leaf else paths[:1])
        if not targets:
            raise ValueError(
                f"sdc fault leaf={plan.leaf!r} matches no params leaf; "
                f"available: {paths[:8]}...")
        self._log0("fault injection: sdc bit-flip on rank %d at step %d "
                   "(leaves %s)", self.ctx.rank, self._host_step, targets)
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}
        with torch.no_grad():
            for key, name, index in leaves:
                if key not in targets:
                    continue
                p = named[name]
                width = p.element_size()
                bits = p.detach().view(-1).view(ints[width])
                j = int(index[0])  # element 0 of the JAX leaf
                bits[j:j + 1].bitwise_xor_(1 << (8 * width - 2))

    def _quarantine_saves_after(self, clean_step: int, reason: str) -> None:
        """Mark every complete save newer than ``clean_step`` untrusted
        (rank 0, the writer): no rollback or resume lands on a save that
        may carry the corruption (`find_candidates` skips them)."""
        for source, step in find_candidates(self.cfg.train.ckpt_dir,
                                            self.snapshot_dir):
            if step > int(clean_step):
                quarantine_save_dir(source, reason)
                self._log0("guard: quarantined save %s (step %d > last "
                           "clean audit %d)", source, step, clean_step)

    # -- guard rollback ---------------------------------------------------

    def _rollback_resume(self) -> dict:
        """Where a rollback resumes: the newest complete readable save
        (``epoch``, ``steps_done``, ``lineage``, ``global_step`` and
        ``snapshot_dir``, the JAX package's keys), or a fresh start at
        step 0."""
        for source, step in find_candidates(self.cfg.train.ckpt_dir,
                                            self.snapshot_dir):
            try:
                meta = ckpt_lib.read_meta(source)
            except (OSError, ValueError):
                self._log0("rollback: %s has unreadable meta; skipping",
                           source)
                continue
            if meta.get("kind") == "snapshot":
                return {"epoch": int(meta.get("epoch", 0)),
                        "steps_done": int(meta.get("steps_done", 0)),
                        "lineage": (meta.get("membership") or {}).get(
                            "lineage") or [],
                        "global_step": int(meta.get("global_step",
                                                    max(step, 0))),
                        "snapshot_dir": str(source)}
            return {"epoch": int(meta.get("epoch", -1)) + 1,
                    "steps_done": 0, "lineage": [],
                    "global_step": max(step, 0), "snapshot_dir": str(source)}
        return {"epoch": 0, "steps_done": 0, "lineage": [], "global_step": 0,
                "snapshot_dir": None}

    def _load_rollback_state(self, resume: dict) -> dict:
        """Restore ``resume["snapshot_dir"]`` into the state in place; a
        candidate that fails its checksums is quarantined and the next
        older one tried. Returns the resume that loaded (``snapshot_dir``
        None: nothing usable, the caller starts fresh)."""
        while resume.get("snapshot_dir"):
            source = Path(resume["snapshot_dir"])
            try:
                ckpt_lib.load_checkpoint(source, self.state)
                return resume
            except ckpt_lib.CorruptCheckpointError as e:
                _counters.inc("ckpt.corrupt_candidates")
                quarantine_save_dir(source, f"checksum refusal: {e}")
                _flightrec.record("ckpt_corrupt_fallback",
                                  step=self._host_step, dir=str(source))
                self._log0("rollback restore: %s failed checksum "
                           "verification (%s) — marked corrupt, falling "
                           "back to the next-older complete candidate",
                           source, e)
                resume = self._rollback_resume()
        return resume

    @torch.no_grad()
    def _fresh_state(self) -> None:
        """The state of a fresh start, written in place (a captured window
        keeps the same tensors): the seed's model, zero momentum (and zero
        int8 residuals), step 0."""
        self.model.load_state_dict(self._init_model().state_dict())
        if self.sharded:
            if self.optimizer.momentum_shard is not None:
                self.optimizer.momentum_shard.zero_()
            for rows in self.optimizer.residual_rows.values():
                rows.zero_()
        else:
            for st in self.optimizer.state.values():
                if st.get("momentum_buffer") is not None:
                    st["momentum_buffer"].zero_()
        self.state.step = 0

    def _execute_guard_rollback(self, sig: _GuardRollback) -> tuple[int, int]:
        """Rewind to the newest complete, non-quarantined save and replay
        (``guard.action=rollback``); returns the ``(epoch, start_step)`` to
        continue from. Every rank reaches the decision at the same
        boundary; rank 0, the save writer, joins its writes in flight,
        picks and restores the save and broadcasts the position and the
        state (each host has its own disk). The restore writes the live
        tensors in place, so a captured window replays on the restored
        state; the next window writes the restored step to the device
        counter. The rolled-back records are tombstoned, and every later
        record carries the bumped ``rollback_generation``."""
        from_step = self._host_step
        hook = self._guard_hook
        # Past max_rollbacks without progress this raises DivergedError.
        hook.policy.on_rollback()
        if self.fault is not None:
            # The guard hook raised before the fault hook's disarm: the
            # replay must not re-arm the seam that caused the rollback.
            self.fault.disarm_device(from_step)
        self._log0("guard: rolling back from step %d — %s", from_step,
                   sig.trigger.reason)
        resume = None
        if self.ctx.is_main_process:
            self._join_writes()
            resume = self._load_rollback_state(self._rollback_resume())
        if self.ctx.world > 1:
            resume = broadcast_one_to_all(resume)
        if resume["snapshot_dir"] is None:
            self._fresh_state()  # the same seed on every rank
        elif self.ctx.world > 1:
            self._broadcast_state()
        self._host_step = int(resume["global_step"])
        # A save whose epoch ran at other worlds (an elastic run's lineage)
        # continues on the re-split tail, as a regroup's resume does.
        position = self._lineage_position(
            int(resume["epoch"]), int(resume["steps_done"]),
            resume.get("lineage") or [])
        self._rollback_gen += 1
        if self.ctx.is_main_process:
            hook.log.tombstone(from_step=from_step, to_step=self._host_step,
                               reason=sig.trigger.reason)
        hook.log.generation = self._rollback_gen
        if self.heartbeat is not None:
            self.heartbeat.rewind(self._host_step)
        self.snap_mgr.rewind(self._host_step)
        hook.on_rollback_rewind(self._host_step)
        if self.elastic is not None:
            # The ledger poll's cadence too: a marker at the pre-rollback
            # high-water step would hide peers and suspects in the replay.
            self.elastic.rewind_poll(self._host_step)
        hook.arm_lr_ease(self._host_step)
        # The rolled-back updates' losses are undone work.
        del self.step_losses[max(0, self._host_step - self._losses_from):]
        _counters.inc("guard.rollbacks")
        _flightrec.record("guard_rollback", step=self._host_step,
                          from_step=from_step, to_step=self._host_step,
                          gen=self._rollback_gen, reason=sig.trigger.reason)
        if self.spans is not None:
            self.spans.record_window(self._host_step, 1,
                                     {"guard_rollback": 0.0},
                                     gen=self._rollback_gen)
        self._log_metrics({
            "event": "guard_rollback", "from_step": from_step,
            "to_step": self._host_step, "trigger": sig.trigger.reason,
            "resume_epoch": position[0], "resume_step": position[1]})
        self._log0("guard: rolled back %d step(s) — resuming at epoch %d "
                   "step %d (global step %d, generation %d)",
                   from_step - self._host_step, position[0], position[1],
                   self._host_step, self._rollback_gen)
        return position

    # -- elastic world size ------------------------------------------------

    def _leave_requested(self) -> bool:
        """This rank was told to go: a SIGTERM or SIGINT (under elastic a
        departure, not the whole job's exit), ``preempt:`` (a signal to
        itself), the ``leave:`` fault, or the SDC audit named it corrupt
        (`hooks.GuardHook`: a replica holding divergent parameters leaves
        before it poisons another gradient reduction)."""
        return ((self.preempt is not None and self.preempt.requested)
                or (self.fault is not None and self.fault.leave_requested)
                or self._guard_evict)

    def _elastic_boundary(self, epoch: int, done: int) -> None:
        """The window boundary's elastic turn (`hooks.BoundaryHook`):
        detect, converge, hand over. Detection is one rate-limited ledger
        glob and the local leave flags. A triggered transition converges
        without stalling: the rank refreshes its check-in at every
        boundary and keeps stepping (a stopped member would wedge its
        peers' collectives) until the plan's stop threshold, whose first
        boundary is the same global position on every member. There
        control leaves `train_epoch`: `PreemptedError` on the leaver,
        `_RegroupSignal` on a survivor. The flavour is rollback on a
        "suspect" trigger or an SDC eviction (a graceful final snapshot
        would keep the very state the audit condemned), else graceful."""
        plan = self._quiesce_plan
        if plan is None:
            el = self.elastic
            leaving = self._leave_requested()
            if not el.quiescing:
                trigger = el.poll(self._host_step, leave_requested=leaving)
                if trigger is None:
                    return
                self._log0("elastic: regroup trigger %r at epoch %d step %d "
                           "(global step %d)", trigger, epoch, done,
                           self._host_step)
                _flightrec.record("elastic_trigger", step=self._host_step,
                                  trigger=str(trigger), leaving=leaving)
                self._q_flavor = ("rollback" if trigger == "suspect"
                                  or self._guard_evict else "graceful")
            plan = el.quiesce_step(epoch, self._host_step, leaving=leaving,
                                   flavor=self._q_flavor,
                                   window=self.steps_per_call)
            if plan is None:
                return  # keep stepping; the next boundary converges again
            self._quiesce_plan = plan
        # A rollback plan with departed members finishes at once (the
        # group is broken: no step can complete); a live-membered one (an
        # SDC eviction) converges at the stop threshold like a graceful
        # one, or this rank would wedge its still-stepping peers.
        if (plan.flavor == "rollback" and plan.departed) \
                or self._host_step >= plan.stop_step:
            self._finish_quiesce(epoch, done, plan)

    def _finish_quiesce(self, epoch: int, done: int, plan) -> None:
        """The quiesce's end. Graceful and grow: the final snapshot at the
        agreed step (the regroup's resume point: nothing replayed, nothing
        dropped; a grow's joiner restores it), joined before the ledger's
        barrier; one that does not commit (a peer died between the plan
        and the stop step) leaves the new leader to fall back to the
        rollback resume. Rollback: no final
        snapshot (the regroup resumes from the newest complete save), and
        a rollback with no membership change is refused. Then the
        hand-off."""
        from tpu_dp_torch.resilience.elastic import ElasticError

        if (plan.flavor == "rollback" and not plan.departed
                and not plan.leavers):
            # Every member is alive and staying: some rank reported a
            # failure that is no membership event (its own error is
            # re-raised there). Regrouping the same world would wait in
            # the rendezvous for the rank that is busy dying.
            self._quiesce_plan = None
            raise ElasticError(
                f"rollback quiesce e{plan.epoch} carries no membership "
                f"change: a peer reported a non-membership failure (see "
                f"its log); refusing to regroup the same world")
        if plan.flavor in ("graceful", "grow"):
            try:
                committed = self._take_snapshot(epoch, done, wait=True)
            except (RuntimeError, OSError):
                committed = False
                self._log0("elastic: final snapshot at step %d failed",
                           self._host_step, exc_info=True)
            if not committed:
                self._log0("elastic: final snapshot at step %d did not "
                           "commit — the regroup will resume from the "
                           "newest complete one", self._host_step)
        self.elastic.ack_and_await_quiesced(plan)
        self._quiesce_plan = None
        if self.elastic.sid in plan.leavers:
            self.elastic.confirm_left(done)
            _counters.inc("elastic.departures")
            _flightrec.record("elastic_departure", step=self._host_step,
                              epoch=epoch, done=done, flavor=plan.flavor,
                              membership_epoch=plan.epoch)
            raise PreemptedError(
                f"elastic departure at epoch {epoch}, step-in-epoch {done} "
                f"(global step {self._host_step}); membership epoch "
                f"{plan.epoch} forms with {len(plan.survivors)} "
                f"survivor(s)")
        raise _RegroupSignal(epoch, done, plan)

    def _elastic_rollback(self, epoch: int, err: BaseException) -> None:
        """A peer is gone without a goodbye (``err``, `dist.
        is_peer_failure`): abandon the failed group, check in with
        rollback flavour and converge without stepping, hand over to the
        regroup. A graceful plan (its leaver was killed before the stop
        step) is downgraded to rollback here; the leader's resume then
        comes from the newest complete save. A grow plan cannot be: its
        survivors (every incumbent and the joiner) now hold a dead member,
        so neither the grown group nor a re-form of that set can meet,
        and this raises `ElasticError` (a restart of the world resumes
        from the newest save). Raises; never returns: ``err`` itself when
        every member is alive and staying."""
        import dataclasses

        from tpu_dp_torch.resilience.elastic import ElasticError

        done = self._epoch_done
        log.warning("elastic: collective failure at epoch %d step %d — "
                    "entering rollback regroup", epoch, done, exc_info=err)
        self._abandon_failed_world()
        if self._quiesce_plan is None:
            self._quiesce_plan = self.elastic.quiesce_blocking(
                epoch, self._host_step, leaving=False, flavor="rollback",
                window=self.steps_per_call)
        elif self._quiesce_plan.flavor == "grow":
            plan_epoch = self._quiesce_plan.epoch
            self._quiesce_plan = None
            raise ElasticError(
                f"member failure while grow plan e{plan_epoch} was in "
                f"flight ({err}); the planned membership (incumbents + "
                f"joiner) is unsatisfiable with a dead member — restart "
                f"the world") from err
        if self._quiesce_plan.flavor == "graceful":
            # The group died under a graceful plan (adopted before the
            # failure, or published from check-ins made before it): its
            # common stop step is out of reach and no final snapshot can
            # be taken, so this rank carries it out as a rollback.
            self._quiesce_plan = dataclasses.replace(self._quiesce_plan,
                                                     flavor="rollback")
        plan = self._quiesce_plan
        if not plan.departed and not plan.leavers:
            # Not a membership event (every member checked in, none is
            # leaving): shrinking would change nothing.
            self._quiesce_plan = None
            raise err
        self._finish_quiesce(epoch, done, plan)

    def _abandon_failed_world(self) -> None:
        """Walk away from a failed group: the windows' graphs released
        (a wedged card's work aborted first, `_release_world`), the
        communicators aborted (NCCL), the epoch's losses so far kept (the
        regroup trims those it replays), the group destroyed. A gloo
        group's sockets stay open (torch closes them only with the group
        object, which DDP keeps alive): a live peer blocked on this rank
        fails at the collective timeout instead (`_bound_peer_waits`)."""
        from tpu_dp_torch.parallel.dist import (
            abandon_distributed,
            abort_communicators,
        )

        self._release_world()
        abort_communicators(self._peer_wait_s)
        self._keep_inflight_losses()
        abandon_distributed()

    def _keep_inflight_losses(self) -> None:
        """Append the interrupted epoch's losses so far to `step_losses`
        (a regroup trims the updates it replays)."""
        pending, self._inflight_losses = self._inflight_losses, []
        if pending:
            self.step_losses.extend(torch.cat(pending).double().tolist())

    def _release_world(self) -> None:
        """Drop what holds the old group before it goes: an armed comm
        capture is stopped (its driver is bound to the world; unparsed),
        then the windows' CUDA
        graphs (a graph replayed after its NCCL communicator is
        destroyed faults on the card), DDP, the resident table, the
        re-split tail and the heartbeat writer. Under the window fence the
        card's queued work is waited for, bounded, first; work wedged on a
        dead peer is ended (`_end_wedged_window`) and the card drained
        (`dist.PeerFence.settle`)."""
        from tpu_dp_torch.resilience.retry import PeerFailedError

        fence = self._peer_fence
        if fence is not None:
            if not fence.wedged:
                try:
                    fence.drain()
                except PeerFailedError:
                    pass  # wedged
            if fence.wedged:
                self._end_wedged_window()
                fence.settle()
        if self._comm_profiler is not None:
            self._comm_profiler.close()
            self._comm_profiler = None
        if self.multi_step is not None:
            self.multi_step.close()
        self.multi_step = self._window_guard = self.ddp = None
        self._resident_train = None
        self._elastic_tail = None
        if self.heartbeat is not None:
            self.heartbeat.close()

    def _retire(self) -> None:
        """Let go of all a departed incarnation holds on the card and on
        its group (`run_elastic`'s rejoin): the world (`_release_world`),
        then the model, optimizer, state, steps and pipelines, so that a
        caller still holding this object holds nothing of them."""
        self._release_world()
        self.model = self.optimizer = self.state = None
        self.step_body = self.train_step = self.eval_step = None
        self.train_pipe = self.test_pipe = None

    def _end_wedged_window(self) -> None:
        """End a window replay wedged on a dead peer. NCCL's abort waits
        for the CUDA graphs that captured its work to be destroyed, and a
        graph's release waits for its replay, which only the abort ends
        (four H100s, torch 2.11, NCCL 2.28.9: an abort with the graph
        alive never returned; `tools/port_nccl_abort_probe.py`): the
        release runs on a helper thread while this one aborts, each
        bounded by `_peer_wait_s` (`ElasticError` past it)."""
        import threading

        from tpu_dp_torch.parallel.dist import abort_communicators
        from tpu_dp_torch.resilience.elastic import ElasticError

        closer = None
        if self.multi_step is not None:
            closer = threading.Thread(target=self.multi_step.close,
                                      kwargs={"wait": False}, daemon=True)
            closer.start()
        abort_communicators(self._peer_wait_s)
        if closer is not None:
            closer.join(self._peer_wait_s)
            if closer.is_alive():
                raise ElasticError(
                    f"the wedged window's CUDA graph was not released "
                    f"within {self._peer_wait_s:g} s of the abort")

    def _join_writes(self) -> None:
        """Join this rank's epoch-save and snapshot writes in flight (rank
        0 writes): a save still being written is no candidate yet, so the
        choice of the newest complete one does not depend on the disk's
        speed. A failed write degrades, as everywhere."""
        try:
            self.ckpt_mgr.wait()
        except (RuntimeError, OSError) as e:
            self._ckpt_write_error(e)
        try:
            self.snap_mgr.wait()
        except (RuntimeError, OSError) as e:
            self.snap_mgr._record_write_error(self._host_step, e)

    def _execute_regroup(self, sig: "_RegroupSignal") -> tuple[int, int]:
        """Form the new epoch's group (shrunk to the survivors, or grown to
        admit a joiner) and go on; returns the ``(epoch, start_step)`` to
        continue from. The JAX package's sequence: the new leader (the
        lowest incumbent) publishes the membership record, whose resume is
        the final snapshot and the epoch's lineage (graceful, grow), or the
        newest complete save (rollback, and a graceful or grow plan whose
        final snapshot never committed: the leader checks before it
        publishes); everyone adopts it; a grow record passes its gate
        (`_grow_gate`: the joiner signalled ready, or the incumbents
        re-form at world N from the same snapshot); the old group is
        released and the new one formed at the record's rendezvous with
        dense new ranks (a grown rendezvous that fails falls back the
        same way); the pipelines,
        model, DDP or the sharded update, schedule and windows are rebuilt
        on it (`_build_world`); every survivor reloads the agreed save
        through the resharding checkpoint path (the shared filesystem; a
        fresh start when nothing is readable); the interrupted epoch's
        rest is re-split over the survivors from the save's lineage, and a
        rollback replays the updates since the save; the telemetry is
        re-homed; a store barrier of the new epoch closes."""
        from tpu_dp_torch.parallel.dist import membership_barrier

        t0 = time.perf_counter()
        plan, cfg = sig.plan, self.cfg
        if plan.flavor in ("graceful", "grow"):
            snap_dir = Path(self.snapshot_dir) / f"step_{self._host_step:010d}"
            resume = {"epoch": sig.epoch, "steps_done": sig.done,
                      "lineage": [list(map(int, seg))
                                  for seg in self._epoch_lineage]
                      + [[self.ctx.world, self._segment_steps(sig.done)]],
                      "global_step": self._host_step,
                      "snapshot_dir": str(snap_dir)}
            if (self.elastic.sid == min(plan.incumbents or plan.survivors)
                    and not ckpt_lib.checkpoint_exists(snap_dir)):
                # The final snapshot never landed: the new leader checks
                # before it publishes, so every survivor follows one
                # fallback instead of racing the filesystem.
                self._log0("elastic: final snapshot %s missing — falling "
                           "back to the rollback resume", snap_dir)
                self._join_writes()
                resume = self._rollback_resume()
        else:
            self._join_writes()
            resume = self._rollback_resume()
        record = self.elastic.establish(plan, resume)
        if record.joined:
            record = self._grow_gate(record)
        resume = record.resume  # the leader's payload is canonical
        old_world, old_rank = self.ctx.world, self.ctx.rank
        backend = self.ctx.backend
        from_step = self._host_step
        self._release_world()
        try:
            self.ctx = self.elastic.reinitialize(backend, self.device,
                                                 record)
        except Exception:
            if not record.joined:
                raise
            # The joiner signalled ready, then never reached the
            # rendezvous: every incumbent's timed out alike. Re-form at
            # world N from the same resume (the grow's snapshot).
            log.warning("elastic: grow rendezvous at world %d failed — "
                        "joiner presumed dead mid-handshake; re-forming at "
                        "world %d", record.world,
                        record.world - len(record.joined), exc_info=True)
            record = self.elastic.establish_fallback(
                record, reason="join handshake timeout (grow aborted)")
            resume = record.resume
            self.ctx = self.elastic.reinitialize(backend, self.device,
                                                 record)
        self._build_world()
        self._bound_peer_waits()
        collect_released()  # the old world's objects
        resume = self._load_rollback_state(dict(resume))
        if resume.get("snapshot_dir") is None:
            self._log0("elastic: no readable save to resume regroup e%d "
                       "from — starting fresh on world %d", record.epoch,
                       record.world)
            self._fresh_state()
        self._host_step = int(resume.get("global_step", 0))
        # The replayed updates' losses are undone work; the snapshot
        # cadence re-arms from the resume point.
        del self.step_losses[max(0, self._host_step - self._losses_from):]
        self.snap_mgr.rewind(self._host_step)
        self._register_program_costs()
        # The comm attribution re-keyed to this world: its rank 0, its
        # wire report, its books (the new windows').
        self._build_comm_profiler()
        position = self._lineage_position(
            int(resume.get("epoch", 0)), int(resume.get("steps_done", 0)),
            resume.get("lineage") or [])
        self._rebuild_observers(record)
        # The guard's audit baseline is topology-bound; an eviction flag
        # (this rank survived, so it was not the suspect) resets.
        self._guard_evict = False
        self._sdc_suspect_active = False
        if self._guard_hook is not None:
            self._guard_hook.on_regroup()
        membership_barrier("regroup_ready", record.epoch,
                           timeout_s=cfg.resilience.regroup_timeout_s)
        dt = time.perf_counter() - t0
        departed = [d.get("sid") for d in record.departed]
        joined = [int(j["sid"]) for j in record.joined]
        _counters.inc("elastic.regroups")
        _counters.inc("elastic.lost_ranks", max(0, old_world - record.world))
        _counters.inc("elastic.joined_ranks", max(0, record.world - old_world))
        _counters.inc("elastic.regroup_s", dt)
        _flightrec.record("elastic_regroup", step=self._host_step,
                          membership_epoch=record.epoch, flavor=plan.flavor,
                          world=record.world, departed=departed,
                          joined=joined, regroup_s=round(dt, 3))
        if joined:
            # "Capacity came back" gets its own marker beside the regroup.
            _flightrec.record("elastic_grow", step=self._host_step,
                              membership_epoch=record.epoch,
                              world=record.world, joined=joined)
        if self.spans is not None:
            self.spans.record_window(self._host_step, 1,
                                     {"elastic_regroup": dt * 1e3},
                                     gen=self._rollback_gen)
        tail_base = self._elastic_tail.base if self._elastic_tail else 0
        self._log_metrics({
            "event": "elastic_regroup", "membership_epoch": record.epoch,
            "flavor": plan.flavor, "world": record.world,
            "departed": departed, "joined": joined,
            "resume_epoch": position[0],
            "resume_step": position[1] or tail_base,
            "regroup_s": round(dt, 3)})
        if joined:
            self._log_metrics({
                "event": "elastic_grow", "membership_epoch": record.epoch,
                "world": record.world, "joined": joined})
        self._log0("elastic: membership epoch %d live — world %d→%d (rank "
                   "%d→%d), %s resume at epoch %d step %d (global step %d, "
                   "%d update(s) replayed), regroup took %.2fs",
                   record.epoch, old_world, record.world, old_rank,
                   self.ctx.rank, plan.flavor, position[0],
                   tail_base or position[1], self._host_step,
                   from_step - self._host_step, dt)
        return position

    def _grow_gate(self, record):
        """Commit to a grow record's rendezvous only for joiners that are
        alive now: each signals ``join_ready`` just before its own
        rendezvous, and one that does not within ``regroup_timeout_s`` is
        presumed dead mid-handshake. One decider: the incumbent leader
        waits and publishes the verdict, the other incumbents follow it
        (their own timers would split them on a joiner that signals inside
        the timers' skew). Returns the record to form: ``record``, or the
        corrective world-N record (`establish_fallback`, the same resume).
        A verdict that never comes raises `ElasticError`."""
        from tpu_dp_torch.resilience.elastic import ElasticError

        timeout = self.cfg.resilience.regroup_timeout_s
        ledger = self.elastic.ledger
        joined = [int(j["sid"]) for j in record.joined]
        incumbents = [m for m in record.members if m not in joined]
        if self.elastic.sid == min(incumbents):
            missing = ledger.await_join_ready(record.epoch, joined,
                                              timeout_s=timeout)
            ledger.publish_grow_verdict(
                record.epoch, commit=not missing,
                reason="" if not missing else f"no join_ready from "
                                              f"{missing}")
            commit = not missing
        else:
            verdict = ledger.await_grow_verdict(record.epoch,
                                                timeout_s=2 * timeout)
            if verdict is None:
                raise ElasticError(
                    f"grow e{record.epoch}: no verdict from the incumbent "
                    f"leader within {2 * timeout:.0f}s (leader died "
                    f"mid-grow)")
            commit = bool(verdict.get("commit"))
        if commit:
            return record
        self._log0("elastic: admitted joiner(s) %s never signalled ready "
                   "within %.0fs — aborting the grow, re-forming at world "
                   "%d", joined, timeout, len(incumbents))
        return self.elastic.establish_fallback(
            record, reason="join handshake timeout (grow aborted)")

    def _rebuild_observers(self, record) -> None:
        """Re-home the heartbeats and rank 0's health monitor for a new
        membership epoch (``<obs dir>/me<E>``: a reassigned dense rank
        must not append to another rank's stream); a demoted rank 0 closes
        its metrics sink (the new rank 0 appends to the same file)."""
        from tpu_dp_torch.obs.health import HealthMonitor, HeartbeatWriter

        if self._metrics_file is not None and not self.ctx.is_main_process:
            self._metrics_file.close()
        if self.obs_mode == "off":
            return
        cfg = self.cfg.obs
        run_dir = self.obs_dir / f"me{record.epoch:04d}"
        self.heartbeat = self.health = None
        if cfg.heartbeat_every_steps > 0:
            self.heartbeat = HeartbeatWriter(
                run_dir, rank=self.ctx.rank,
                every_steps=cfg.heartbeat_every_steps, me=record.epoch)
            if self.ctx.is_main_process:
                self.health = HealthMonitor(
                    run_dir, world=self.ctx.world,
                    straggler_factor=cfg.straggler_factor,
                    stale_after_s=cfg.stale_after_s,
                    min_step_ms=cfg.min_step_ms, on_flag=cfg.on_straggler,
                    logger=lambda msg: log.warning("health: %s", msg))

    # -- telemetry sinks ---------------------------------------------------

    @property
    def metrics_path(self) -> Path:
        """The metrics.jsonl sink (``train.metrics_path``, by default
        ``<ckpt_dir>/metrics.jsonl``)."""
        return Path(self.cfg.train.metrics_path
                    or Path(self.cfg.train.ckpt_dir) / "metrics.jsonl")

    def _log_metrics(self, record: dict) -> None:
        """Append a schema-3 JSON line to the metrics sink (rank 0 only),
        stamped with ``ts`` (ISO-8601 UTC), the host ``step``, ``schema:
        3`` and, after a guard rollback, ``rollback_generation``; the
        caller's fields win (per-update records carry their own measured
        ts and step). The sink is opened once and held (append and flush
        per record: obs=full writes one per update), closed in `fit`'s
        teardown; a record after it (the eval line) reopens it."""
        if not self.ctx.is_main_process:
            return
        rec = {"ts": _iso_ts(time.time()), "step": self._host_step,
               "schema": 3}
        if self._rollback_gen:
            rec["rollback_generation"] = self._rollback_gen
        if self.elastic is not None:
            # A stream that spans a shrink explains its own discontinuity.
            rec["membership_epoch"] = self.elastic.record.epoch
        rec.update(record)
        if self._metrics_file is None or self._metrics_file.closed:
            path = self.metrics_path
            path.parent.mkdir(parents=True, exist_ok=True)
            self._metrics_file = open(path, "a")
        self._metrics_file.write(json.dumps(rec) + "\n")
        self._metrics_file.flush()

    def _write_prom(self) -> None:
        """Atomically rewrite the Prometheus textfile (``obs.prom_path``;
        ``.r<rank>`` suffixed when there is more than one rank). A failure
        warns once and never aborts training."""
        path = self.cfg.obs.prom_path
        if not path:
            return
        from tpu_dp_torch.obs.promfile import write_promfile

        out = Path(path)
        if self.ctx.world > 1:
            out = out.with_name(out.name + f".r{self.ctx.rank}")
        try:
            write_promfile(out, labels={"rank": str(self.ctx.rank)})
        except OSError:
            if not self._prom_failed:
                self._prom_failed = True
                self._log0("prometheus textfile write failed (suppressing "
                           "further warnings)", exc_info=True)

    def _check_health(self) -> None:
        """Rank 0's health pass over every rank's heartbeats: the
        hang-dump sentinel first (into the directory the flight recorders
        poll), then the report (``obs.on_straggler=raise`` raises
        `HealthError`)."""
        if self.health is None:
            return
        issues = self.health.check()
        if self.flightrec is not None:
            self.health.request_dump(issues,
                                     dump_dir=self.flightrec.dump_dir)
        self.health.report(issues)
        self._suspect_from_health(issues)

    def _suspect_from_health(self, issues) -> None:
        """Fold rank 0's hang detection into the membership ledger: a
        "stale" or "missing" heartbeat makes its rank a suspect, which
        every member's next poll sees (a rollback quiesce). Stragglers are
        slow, not dead: never suspected."""
        if self.elastic is None:
            return
        for issue in issues:
            if issue.kind in ("stale", "missing"):
                self.elastic.mark_suspect(issue.rank, issue.describe())

    def export_trace(self) -> Path | None:
        """Write the Perfetto/Chrome trace JSON of this rank's spans
        (``obs.perfetto_path``, by default ``<obs dir>/trace.perfetto.
        json``); rank 0 only. None when obs is off or not rank 0."""
        if self.spans is None or not self.ctx.is_main_process:
            return None
        from tpu_dp_torch.obs.export import export_perfetto

        path = Path(self.cfg.obs.perfetto_path
                    or self.obs_dir / "trace.perfetto.json")
        out = export_perfetto(
            path, self.spans.records(), rank=self.ctx.rank,
            counter_points=[{"ts": time.time(),
                             "counters": _counters.snapshot()}])
        self._log0("perfetto trace: %s (%d step records)", out,
                   len(self.spans))
        return out

    def obs_summary(self) -> dict[str, Any] | None:
        """Span rollup, counter snapshot and efficiency rollup for the
        CLI's JSON line; None when obs is off."""
        if self.spans is None:
            return None
        out = {"mode": self.obs_mode, "spans_ms": self.spans.rollup(),
               "counters": _counters.snapshot()}
        eff = self._eff.rollup() if self._eff is not None else None
        if eff is not None:
            out["efficiency"] = eff
        cp = self._comm_profiler
        if cp is not None and cp.last_report is not None:
            r = cp.last_report
            out["comm"] = {
                "windows": cp.reports,
                "comm_ms": r["comm_ms"],
                "exposed_comm_ms": r["exposed_comm_ms"],
                "overlap_frac": r["overlap_frac"],
                "reconciled": (r.get("reconciliation") or {}).get("ok"),
            }
        return out

    def _export_final(self) -> None:
        """Write ``final_params.msgpack`` (the last epoch save was joined by
        `fit`'s teardown)."""
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
        # After a mid-epoch regroup (or a resume into one) the interrupted
        # epoch's remaining samples come from the re-split tail's pipeline;
        # the step count `i` stays epoch-cumulative across the world
        # change (snapshot meta, the quiesce protocol, the log lines).
        tail = self._elastic_tail
        if tail is not None and tail.epoch != epoch:
            tail = None
        pipe = self.train_pipe if tail is None else tail.pipe
        base = 0 if tail is None else tail.base
        if tail is not None:
            start_step = tail.skip
        pipe.set_epoch(epoch)
        # Device losses not yet logged (1-D pieces; the first `logged`
        # values of their concatenation are), and updates since the log.
        pending, logged, run_steps = [], 0, 0
        losses, correct, count, quant_counts = [], None, 0, None
        i = base + start_step
        # Kept past a peer failure (`_keep_inflight_losses`).
        self._inflight_losses, self._epoch_done = losses, i
        fence = self._peer_fence
        table = self.resident_train
        feed = pipe.windows if table is None else pipe.index_windows
        # Telemetry (train.obs != off): host stamps bracket each window,
        # t0 -> t1 data_wait (the feed, the pre-dispatch hooks), t1 -> t3
        # dispatch, and at full t3 -> t4 device (the window's one fence)
        # and h2d from CUDA events; nothing inside the dispatched window.
        spans = self.spans
        obs_full = self.obs_mode == "full"
        timed = obs_full and self.device.type == "cuda"
        for hook in self._hooks:
            hook.on_epoch_start(epoch)
        it = iter(feed(self.steps_per_call, skip_steps=start_step))
        while True:
            if spans is not None:
                # The window's wall-clock start, before next(): the
                # data_wait slice sits in its real place on the timeline.
                ts_wall = time.time()
                t0 = time.perf_counter()
                if timed:
                    asked = _timing_event(self.device)
            try:
                n, item = next(it)
            except StopIteration:
                break
            for hook in self._hooks:
                hook.on_window_start(self._host_step + 1, n)
            # The sentinel's input (guard on only): the armed loss cap, the
            # LR ease and the nan/spike seam.
            guard = (() if self._guard_hook is None else
                     (self._guard_hook.guard_in(self._host_step + 1, n),))
            if spans is not None:
                t1 = time.perf_counter()
                if timed:
                    # After the feed's copy (or its wait on the copy) on
                    # this stream: the input is usable when this completes.
                    handed = _timing_event(self.device)
            if n == 1:
                m = self.train_step(self.state, item if table is None
                                    else gather_batch(table, item[0]),
                                    *guard)
                c = m["correct"]
            else:
                window = self._window_guard or self.multi_step
                m = (window(self.state, item, *guard) if table is None
                     else window(self.state, table, item, *guard))
                c = m["correct"].sum()
            if "quant_overflow" in m:
                c8 = torch.stack([m["quant_overflow"].sum(),
                                  m["quant_clip"].sum()]).to(torch.int64)
                quant_counts = (c8 if quant_counts is None
                                else quant_counts + c8)
            if fence is not None:
                # One window stays in flight; a wait past the deadline
                # aborts the communicators and raises `PeerFailedError`.
                fence.step()
            if spans is not None:
                self._observe_window(n, ts_wall, t0, t1, obs_full,
                                     (asked, handed) if timed else None)
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
                    if fence is not None:
                        fence.drain()
                    flat = torch.cat(pending)
                    vals = flat[logged:logged + run_steps].tolist()
                    self._print("[%d, %5d] loss: %.3f"
                                % (epoch + 1, i, sum(vals) / len(vals)))
                    pending = [flat[logged + run_steps:]]
                    logged = run_steps = 0
                    # Rank 0 reads every rank's heartbeats at this boundary
                    # (already a fetch), then the promfile.
                    self._check_health()
                    self._write_prom()
            # The hook sweep, once per dispatched window (`_build_hooks`'
            # order); a hook may raise `PreemptedError`, `_RegroupSignal`,
            # `_GuardRollback` or `DivergedError`.
            self._host_step += n
            self._epoch_done = i
            ev = hooks_lib.StepEvent(epoch=epoch, done=i, n=n, window=(m,))
            try:
                for hook in self._hooks:
                    hook.on_step_end(ev)
            except (_GuardRollback, _RegroupSignal):
                # The epoch's losses so far: a rollback keeps those of the
                # updates before its target, a regroup those before its
                # resume point.
                self._keep_inflight_losses()
                raise
        self._inflight_losses = []
        if not losses:
            return {"loss": 0.0, "accuracy": 0.0}
        if fence is not None:
            fence.drain()
        # One fetch: the epoch's losses, the device's update counter (the
        # host's `state.step`, settled by the guard's fetch when it skips)
        # and the int8 codec's block counts.
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
        if start_step or base:
            # A resumed (or regrouped) epoch's stats cover only its tail
            # (the JAX package's label).
            stats["resumed_at_step"] = base + start_step
        if quant_counts is not None:
            stats.update(quant_overflow=overflow, quant_clip=clip)
        self.meter.mark()
        return stats

    def _observe_window(self, n: int, ts_wall: float, t0: float, t1: float,
                        obs_full: bool, events) -> None:
        """Book one dispatched window's telemetry (``train.obs`` basic or
        full; `train_epoch` stamped ``t0``/``t1`` around the feed and the
        pre-dispatch hooks, and on a card at full recorded ``events``, the
        timing events around the input's placement). At full: the
        window's one host wait on a card (a CUDA event recorded after the
        dispatch, synchronized: never a fetch), the ``device`` and
        ``h2d`` spans, the memory gauges and one metrics record per
        update. The spans are split evenly over the
        window's updates (`SpanRecorder.record_window`); the efficiency
        gauges come from the window's wall time (to the fence at full, to
        the dispatch's return at basic)."""
        t3 = t4 = time.perf_counter()
        window_spans = {"data_wait": (t1 - t0) * 1e3,
                        "dispatch": (t3 - t1) * 1e3}
        if obs_full:
            if events is not None:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                done.synchronize()
            t4 = self.meter.mark(fenced=True)
            _counters.gauge("throughput.images_per_sec",
                            round(self.meter.images_per_sec, 1))
            update_device_memory_gauges(devices=[self.device])
            # Absent at basic rather than 0.0: absence means "not
            # measured". h2d: how long the device still placed the input
            # after the host had it (both events done after the fence).
            h2d = 0.0
            if events is not None:
                asked, handed = events
                h2d = max(0.0, asked.elapsed_time(handed)
                          - window_spans["data_wait"])
            window_spans["h2d"] = h2d
            window_spans["device"] = (t4 - t3) * 1e3
        first = self._host_step + 1
        new_recs = self.spans.record_window(first, n, window_spans,
                                            ts=ts_wall,
                                            gen=self._rollback_gen)
        if self._resident_enabled:
            tag = f"resident_loop[w{n}]"
        else:
            tag = "train_step" if n == 1 else "multi_step"
        eff = self._eff.observe(tag, n, (t4 - t0) * 1e3,
                                window_spans["data_wait"])
        self._last_efficiency = eff
        _counters.gauge("obs.step_time_ms", eff["step_time_ms"])
        _counters.gauge("obs.goodput", eff["goodput"])
        if "mfu" in eff:
            _counters.gauge("obs.mfu", eff["mfu"])
        if not obs_full:
            return
        snap = _counters.snapshot()
        for r in new_recs:
            rec = {"step": r["step"], "ts": _iso_ts(r["ts"]),
                   "spans": {k: round(v, 3) for k, v in r["spans"].items()},
                   "counters": snap, "goodput": eff["goodput"]}
            if "mfu" in eff:
                rec["mfu"] = eff["mfu"]
            self._log_metrics(rec)

    def _close_resilience(self) -> None:
        """`fit`'s teardown on every exit path: join the epoch save and the
        snapshot writes (a failure degrades: counted and logged, never
        masking the run's outcome), restore the signal handlers, dump
        the flight recorder with the JAX package's reason string, then the
        promfile, the step profiler, the heartbeats, the Perfetto export
        and the metrics sink."""
        try:
            self.ckpt_mgr.close()
        except (RuntimeError, OSError) as e:
            self._ckpt_write_error(e)
        self.snap_mgr.close()
        if self.preempt is not None:
            self.preempt.uninstall()
        if self.flightrec is not None:
            exc = sys.exc_info()
            reason = "clean" if exc[0] is None else (
                f"{exc[0].__name__}: {exc[1]}"[:500])
            self.flightrec.record("exit", step=self._host_step,
                                  reason=reason)
            self.flightrec.dump(reason=reason)
        # The telemetry's teardown, each step guarded on its own: a crashed
        # or preempted run is exactly when the trace matters.
        self._write_prom()
        closers = []
        if self._step_profiler is not None:
            closers.append(("step-profiler close", self._step_profiler.close))
        if self.heartbeat is not None:
            closers.append(("heartbeat close", self.heartbeat.close))
        if self.spans is not None and len(self.spans):
            closers.append(("perfetto export", self.export_trace))
        if self._metrics_file is not None:
            closers.append(("metrics sink close", self._metrics_file.close))
        for what, close in closers:
            try:
                close()
            except Exception:
                self._log0("%s failed", what, exc_info=True)
        for hook in self._hooks:
            try:
                hook.close()
            except Exception:
                self._log0("step hook close failed", exc_info=True)

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
        if self._peer_fence is not None:
            self._peer_fence.drain()
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
        self._losses_from = self._host_step
        try:
            if self.preempt is not None:
                self.preempt.install()
            # Step-ranged profiling replaces the whole-run trace.
            whole_run = (None if self._step_profiler is not None
                         else cfg.train.profile_dir)
            with profile_trace(whole_run, self._tracer):
                self._fit_epochs(history)
        finally:
            self._close_resilience()
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
            result["eval"] = ev = self.evaluate()
            self._log_metrics({"eval": {k: ev[k]
                                        for k in ("accuracy", "loss")}})
            self._print("Accuracy of the network on the %d test images: %d %%"
                        % (len(self.test_ds),
                           int(100 * result["eval"]["accuracy"])))
        return result

    def _fit_epochs(self, history: list) -> None:
        """`fit`'s epochs from the start position: each epoch's record
        (its stats and rate; at basic and full the span and efficiency
        rollups and the counters) and promfile, its checkpoint, the
        periodic eval and rank 0's health pass; a guard rollback rewinds
        and replays, a pending signal exits at the epoch's end."""
        cfg = self.cfg
        epoch, start_step = self.start_epoch, self.start_step
        while epoch < cfg.train.epochs:
            try:
                stats = self.train_epoch(epoch, start_step)
            except _RegroupSignal as sig:
                # A survivor of a completed quiesce: shrink the group and
                # go on from the agreed position.
                epoch, start_step = self._execute_regroup(sig)
                continue
            except _GuardRollback as sig:
                # The policy condemned the trajectory: rewind to the newest
                # trusted save and replay (DivergedError past the budget).
                epoch, start_step = self._execute_guard_rollback(sig)
                continue
            except Exception as e:
                from tpu_dp_torch.parallel.dist import is_peer_failure

                if self.elastic is None or not is_peer_failure(e):
                    raise
                try:
                    self._elastic_rollback(epoch, e)
                except _RegroupSignal as sig:
                    epoch, start_step = self._execute_regroup(sig)
                continue
            history.append(stats)
            self._print("epoch %d: train loss %.4f acc %.4f (%.1f img/s)"
                        % (epoch + 1, stats["loss"], stats["accuracy"],
                           self.meter.images_per_sec))
            # The codec's counts go to the counters, as in the JAX package.
            rec = {"epoch": epoch + 1,
                   **{k: v for k, v in stats.items()
                      if not k.startswith("quant_")},
                   "images_per_sec": round(self.meter.images_per_sec, 1)}
            if self.spans is not None:
                _counters.gauge("throughput.images_per_sec",
                                round(self.meter.images_per_sec, 1))
                update_device_memory_gauges(devices=[self.device])
                rec["spans"] = self.spans.rollup()
                eff = self._eff.rollup()
                if eff is not None:
                    rec["efficiency"] = eff
                rec["counters"] = _counters.snapshot()
            self._log_metrics(rec)
            self._write_prom()
            self._save_epoch(epoch)
            every = cfg.train.eval_every_epochs
            if every and (epoch + 1) % every == 0:
                ev = self.evaluate()
                self._print("epoch %d: eval loss %.4f acc %.4f"
                            % (epoch + 1, ev["loss"], ev["accuracy"]))
            # A rank that went quiet mid-epoch is flagged here even when
            # the log boundary never came.
            self._check_health()
            # A signal that lands between epochs (or during eval) still
            # gets the snapshot-and-exit-143 contract; under elastic the
            # next epoch's first boundary runs the departure instead.
            if (self.elastic is None and self.preempt is not None
                    and self.preempt.requested):
                self._preempt_exit(epoch + 1, 0)
            # The epoch is consumed: its re-split tail and lineage are done.
            self._elastic_tail = None
            self._epoch_lineage = []
            epoch, start_step = epoch + 1, 0


def run_elastic(cfg: Config, device=None, trainer: Trainer | None = None
                ) -> tuple[Trainer, dict[str, Any]]:
    """`Trainer.fit` with the ``relaunch:`` fault's in-process rejoin (the
    JAX package's `run_elastic`): a fired ``relaunch:step=K,rank=R``
    departs exactly like ``leave:``, the survivors shrink to world N-1,
    and instead of surfacing the `PreemptedError` this builds a join-mode
    `Trainer` in the same process (``resilience.elastic_join=always``,
    the fault spent, ``--resume`` off: ledger discovery, fenced request,
    admission, the state from the agreed snapshot) and trains to the end
    at the grown world. The departed incarnation lets go of its world
    first: its windows' CUDA graphs, its DDP and its group (torch has one
    default group, and the old graphs hold card memory and a dead group);
    the card's kernels stay built in the process. Every other
    `PreemptedError` propagates (the CLI's exit 143), and so does a second
    departure. ``trainer``: the first incarnation, when the caller built
    it already."""
    import copy

    from tpu_dp_torch.parallel.dist import abandon_distributed

    tr = trainer if trainer is not None else Trainer(cfg, device=device)
    rejoined = False
    while True:
        try:
            return tr, tr.fit()
        except PreemptedError:
            fault = tr.fault
            if rejoined or not (fault is not None
                                and fault.fired_kind("relaunch")):
                raise
        # Out of the handler, so the departure's traceback no longer holds
        # the departed incarnation.
        rejoined = True
        log.warning("relaunch fault: departed at global step %d — "
                    "rejoining the run in-process", tr._host_step)
        sid = tr.stable_rank
        tr._retire()
        abandon_distributed()
        tr = None
        collect_released()  # the departed incarnation's objects
        cfg2 = copy.deepcopy(cfg)
        cfg2.resilience.fault = ""
        cfg2.resilience.elastic_join = "always"
        cfg2.train.resume = False
        if cfg2.parallel.process_id is None:
            cfg2.parallel.process_id = sid  # the seat it held
        tr = Trainer(cfg2, device=device)
        if tr.fault is not None and tr.fault.has_kind("relaunch"):
            # A TPU_DP_FAULT spec from the environment survives into the
            # rejoined incarnation; it fired once in this process.
            tr.fault.spend("relaunch")
