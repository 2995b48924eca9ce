"""Train entry point of the port (of the repository's ``train.py``).

    python -m tpu_dp_torch.train --preset=resnet18_cifar10 \\
        --model.fused_stages=all --model.fused_bwd=true \\
        --train.pallas_xent=true [--device cpu]

Any ported config field is overridable as ``--section.field=value``
(`tpu_dp_torch.config`); a knob the port does not implement yet exits 2
with its `NotPortedError`. Runs on the first CUDA card unless ``--device``
names another device; without a card and without ``--device cpu`` it
exits 2. Ends with one JSON line: model, dataset, synthetic, devices,
images_per_sec, wall_time_s, final_train_loss, eval.
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
    from tpu_dp_torch.train.trainer import Trainer

    try:
        cfg = parse_cli(rest)
        trainer = Trainer(cfg, device=device)
    except (ValueError, RuntimeError) as e:
        print(f"train: {e}", file=sys.stderr)
        return 2
    # f32 means f32: no TF32 in cuDNN's convs or in matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    result = trainer.fit()
    summary = {
        "model": cfg.model.name,
        "dataset": trainer.train_ds.name,
        "synthetic": trainer.train_ds.synthetic,
        "devices": trainer.num_devices,
        "images_per_sec": round(result["images_per_sec"], 1),
        "wall_time_s": round(result["wall_time_s"], 1),
        "final_train_loss": round(result["history"][-1]["loss"], 4)
        if result["history"] else None,
        "eval": result.get("eval"),
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
