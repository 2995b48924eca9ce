"""Train entry point of the port (of the repository's ``train.py``).

    python -m tpu_dp_torch.train --preset=resnet18_cifar10 \\
        --model.fused_stages=all --model.fused_bwd=true \\
        --train.pallas_xent=true [--device cpu]
    python -m tpu_dp_torch.train --preset=resnet50_cifar100 \\
        --model.fused_stages=all --model.fused_bwd=true \\
        --train.pallas_xent=true [--device cpu]

Data-parallel under a launcher, one process per card (NCCL), or on the
CPU (gloo) with ``--device cpu``:

    torchrun --nproc_per_node=N -m tpu_dp_torch.train --preset=... [...]
    python -m torch.distributed.run --nproc_per_node=N \\
        -m tpu_dp_torch.train --device cpu --preset=... [...]

``--train.steps_per_call=0`` trains in windows of min(24, steps per epoch)
updates, each a replayed CUDA graph on a card (K > 0 sets the window);
``--optim.grad_accum_steps=a`` makes each update from a microbatches of
``data.batch_size``.

With no arguments it is the reference preset (`Net`, batch 4, 2 epochs).
``data.batch_size`` is per rank. Any ported config field is overridable as
``--section.field=value`` (`tpu_dp_torch.config`); ``--config=FILE`` (a
dump or a checkpoint's ``meta.json``) and ``--resume`` work as in the
repository's ``train.py``; a knob the port does not implement yet exits 2
with its `NotPortedError`. Rank 0 saves a checkpoint after every epoch
into ``train.ckpt_dir`` (default ``./checkpoints``) and the final params
into ``final_params.msgpack`` there. Each rank runs on
``cuda:LOCAL_RANK`` unless ``--device`` names another device; without a
card and without ``--device cpu`` it exits 2. Rank 0 ends with one JSON
line: model, dataset, synthetic, devices, world, backend,
images_per_sec (global), images_per_sec_per_card, wall_time_s,
final_train_loss, eval, start_epoch, resumed_from (null on a fresh
run), update_sharding, collective_dtype, bucket_mb and
momentum_bytes_per_rank.

Resilience as in the repository's ``train.py``: a SIGTERM or SIGINT
(``resilience.handle_signals``, on by default) takes a final snapshot at
the next window boundary, joins it and exits **143** after printing
``preempted: ...``; ``--resilience.snapshot_every_steps=N`` snapshots
every N updates into ``<ckpt_dir>/snapshots`` (``--resume`` continues
from the newest complete save, mid-epoch included); every exit from
training dumps the flight recorder to ``<ckpt_dir>/obs/flightrec_r<rank>.
json`` (``obs.run_dir``); ``--resilience.fault=kill:step=K`` (or
``TPU_DP_FAULT``) exits 137 at the first window boundary at or past K.

``--guard.enabled=true`` trains under the guard (the sentinel step, the
quarantine log ``<ckpt_dir>/quarantine.jsonl``, ``guard.action`` skip,
rollback, halt or warn, the SDC audit every ``guard.sdc_every_steps``);
a halt prints ``diverged: ...`` and exits **65**, never 143, so a
supervisor does not restart into the same divergence; the JSON line then
carries a ``guard`` rollup. ``--resilience.fault=nan:step=K`` (or
``spike:step=K,scale=S``, ``sdc:step=K,rank=R``) injects the guard's
faults.

Telemetry as in the repository's ``train.py``: rank 0 always appends
schema-3 records to ``<ckpt_dir>/metrics.jsonl`` (``--train.
metrics_path``): an epoch record, the eval record, the guard's events.
``--train.obs=basic`` adds per-window ``data_wait``/``dispatch`` spans,
the MFU/goodput gauges and per-rank heartbeats (``<obs dir>/heartbeat_r
<rank>.jsonl``, rank 0 flagging stragglers and stale ranks) with no added
host synchronisation; ``--train.obs=full`` adds the ``h2d`` and
``device`` spans (one CUDA-event synchronize a window) and one record per
update; with either, rank 0 writes ``<obs dir>/trace.perfetto.json`` and
the JSON line carries ``obs`` and ``efficiency`` rollups.
``--obs.prom_path=P`` rewrites a Prometheus text file (``P.r<rank>``
with more than one rank). ``--train.profile_dir=D`` traces the run with
`torch.profiler` into ``D/trace_r<rank>.json`` (a Chrome trace, CUDA
activity only on a card), ``--train.profile_steps=A:B`` only those
updates (snapped outward to windows).

``--resilience.elastic=true --resilience.elastic_verify_fingerprint=
false`` (with ``data.drop_remainder``, a ``train.ckpt_dir`` every rank
shares) makes a SIGTERM, ``preempt:`` or ``--resilience.fault=leave:step=
K,rank=R`` a graceful departure: that rank exits 143 after ``preempted:
elastic departure ...`` and the others regroup at world N-1 and finish,
their JSON line carrying an ``elastic`` rollup. ``--resilience.fault=
relaunch:step=K,rank=R`` departs the same way, then the rank rejoins the
run in its own process and the world grows back to N (`run_elastic`). A
departed rank relaunched with its stable id (``RANK`` or ``--parallel.
process_id``) and ``--resilience.elastic_join=always`` (``auto``, the
default, joins when the newest membership record does not list it)
joins the live run instead of starting one. A launcher that tears every
worker down when one exits non-zero (plain ``torchrun``) cannot host the
shrink: start each rank as its own process with ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (README).

``--train.update_sharding=sharded`` trains with the sharded weight update
(each rank keeps 1/world of the momentum), its gradient exchange in f32,
``--train.collective_dtype=bf16`` or ``=int8`` (``--train.
quant_block_size``), in buckets of ``--train.bucket_mb`` MB.
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    rest = []
    for i, arg in enumerate(argv):
        if arg.startswith("--device="):
            device = arg.partition("=")[2]
        elif arg == "--device" and i + 1 < len(argv):
            device = argv[i + 1]
        elif not (i > 0 and argv[i - 1] == "--device"):
            rest.append(arg)

    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.parallel.dist import shutdown
    from tpu_dp_torch.obs.counters import counters
    from tpu_dp_torch.resilience import DivergedError, PreemptedError
    from tpu_dp_torch.train.trainer import Trainer, run_elastic

    # f32 means f32: no TF32 in cuDNN's convs or in matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = None
    try:
        try:
            cfg = parse_cli(rest)
            trainer = Trainer(cfg, device=device)
        except (ValueError, RuntimeError, OSError) as e:
            print(f"train: {e}", file=sys.stderr)
            return 2
        try:
            if cfg.resilience.elastic:
                # A fired relaunch: fault rejoins the run in-process
                # instead of exiting 143; a relaunched process JOINs a
                # live run through resilience.elastic_join.
                trainer, result = run_elastic(cfg, device=device,
                                              trainer=trainer)
            else:
                result = trainer.fit()
        except PreemptedError as e:
            # The final snapshot is committed: the terminated-by-SIGTERM
            # status, so a supervisor restarts with --resume (an elastic
            # leaver's departure, whatever its rank, says so itself).
            if trainer.ctx.is_main_process or trainer.elastic is not None:
                print(f"preempted: {e}", flush=True)
            return PreemptedError.exit_code
        except DivergedError as e:
            # The guard's halt: training is mathematically compromised.
            # Exit 65 (EX_DATAERR), not 143, so a supervisor does not
            # restart into the same divergence.
            if trainer.ctx.is_main_process:
                print(f"diverged: {e}", flush=True)
            return DivergedError.exit_code
        if not trainer.ctx.is_main_process:
            return 0
        summary = {
            "model": cfg.model.name,
            "dataset": trainer.train_ds.name,
            "synthetic": trainer.train_ds.synthetic,
            "devices": trainer.num_devices,
            "world": trainer.ctx.world,
            "backend": trainer.ctx.backend,
            "images_per_sec": round(result["images_per_sec"], 1),
            "images_per_sec_per_card":
                round(result["images_per_sec_per_card"], 1),
            "wall_time_s": round(result["wall_time_s"], 1),
            "final_train_loss": round(result["history"][-1]["loss"], 4)
            if result["history"] else None,
            "eval": result.get("eval"),
            "start_epoch": result["start_epoch"],
            "resumed_from": result["resumed_from"],
            "update_sharding": cfg.train.update_sharding,
            "collective_dtype": cfg.train.collective_dtype,
            "bucket_mb": cfg.train.bucket_mb,
            "momentum_bytes_per_rank": trainer.momentum_bytes_per_rank,
        }
        if trainer.guard_enabled:
            summary["guard"] = {
                "quarantined": int(counters.get("guard.quarantined")),
                "spikes": int(counters.get("guard.spike")),
                "rollbacks": int(counters.get("guard.rollbacks")),
                "sdc_audits": int(counters.get("guard.sdc_audits")),
                "sdc_mismatches": int(counters.get("guard.sdc_mismatches")),
                "quarantine_log": str(trainer.quarantine_path),
            }
        if trainer.elastic is not None:
            rec = trainer.elastic.record
            summary["elastic"] = {
                "membership_epoch": rec.epoch, "world": rec.world,
                "members": list(rec.members),
                "regroups": int(counters.get("elastic.regroups")),
                "lost_ranks": int(counters.get("elastic.lost_ranks")),
                "joined_ranks": int(counters.get("elastic.joined_ranks")),
                "regroup_s": round(counters.get("elastic.regroup_s"), 3),
            }
        obs = trainer.obs_summary()
        if obs is not None:
            summary["obs"] = obs
            if "efficiency" in obs:
                summary["efficiency"] = obs["efficiency"]
        print(json.dumps(summary), flush=True)
        return 0
    finally:
        if trainer is not None and trainer.multi_step is not None:
            # The windows' graph goes before the group its collectives use.
            trainer.multi_step.close()
        trainer = None  # what refers to the group goes with it
        shutdown()


if __name__ == "__main__":
    sys.exit(main())
