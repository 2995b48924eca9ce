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
    from tpu_dp_torch.train.trainer import Trainer

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
        result = trainer.fit()
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
        print(json.dumps(summary), flush=True)
        return 0
    finally:
        if trainer is not None and trainer.multi_step is not None:
            # The windows' graph goes before the group its collectives use.
            trainer.multi_step.close()
        shutdown()


if __name__ == "__main__":
    sys.exit(main())
