"""Train entry point of the port (of the repository's ``train.py``).

    python -m tpu_dp_torch.train --preset=resnet18_cifar10 \\
        --model.fused_stages=all --model.fused_bwd=true \\
        --train.pallas_xent=true [--device cpu]

Data-parallel under a launcher, one process per card (NCCL), or on the
CPU (gloo) with ``--device cpu``:

    torchrun --nproc_per_node=N -m tpu_dp_torch.train --preset=... [...]
    python -m torch.distributed.run --nproc_per_node=N \\
        -m tpu_dp_torch.train --device cpu --preset=... [...]

``data.batch_size`` is per rank. Any ported config field is overridable as
``--section.field=value`` (`tpu_dp_torch.config`); a knob the port does
not implement yet exits 2 with its `NotPortedError`. Each rank runs on
``cuda:LOCAL_RANK`` unless ``--device`` names another device; without a
card and without ``--device cpu`` it exits 2. Rank 0 ends with one JSON
line: model, dataset, synthetic, devices, world, backend,
images_per_sec (global), images_per_sec_per_card, wall_time_s,
final_train_loss, eval.
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
    try:
        try:
            cfg = parse_cli(rest)
            trainer = Trainer(cfg, device=device)
        except (ValueError, RuntimeError) as e:
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
        }
        print(json.dumps(summary), flush=True)
        return 0
    finally:
        shutdown()


if __name__ == "__main__":
    sys.exit(main())
