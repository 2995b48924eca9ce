"""The device-resident feed across cards: ``--preset=resnet18_8chip_gb1024``
(per-card batch 128, the 8-card layout's) with the kernel knobs, one epoch
of a 50,000-image synthetic train set (CIFAR-10's size) in windows of 24
(``--train.steps_per_call=0``), at world 1, 2 and 4 (as many as the visible
cards allow), resident and streamed (``--data.device_resident=on|off``).
Each run is ``torch.distributed.run --standalone --nproc_per_node=N`` of
this file's worker; rank 0 prints one JSON line: the fenced meter's global
images/s, each rank's state digest (parameters, BN statistics, momentum)
and whether every rank holds the same bytes. Run from the repository root
on a machine with the cards:

    python3 tools/port_resident_multicard.py

One line per run goes to chiprun_out/resident_multicard.jsonl; the exit
code is 1 when a run fails or its ranks disagree.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--preset=resnet18_8chip_gb1024", "--model.fused_stages=all",
        "--model.fused_bwd=true", "--train.pallas_xent=true",
        "--data.dataset=synthetic", "--data.synthetic_train_size=50000",
        "--data.synthetic_test_size=256", "--train.epochs=1",
        "--train.log_every=1000", "--train.steps_per_call=0"]


def worker(argv) -> int:
    """One rank: `Trainer` on ``argv``, fit, then the ranks' digests."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from tpu_dp_torch.checkpoint import _walk_state_dict, state_dict_of
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.parallel.dist import shutdown
    from tpu_dp_torch.train.trainer import Trainer

    trainer = Trainer(parse_cli(argv))
    result = trainer.fit()
    h = hashlib.sha256()
    for _, v in sorted(_walk_state_dict(state_dict_of(trainer.state))):
        h.update(v.tobytes())
    digests = [None] * trainer.ctx.world
    dist.all_gather_object(digests, h.hexdigest())
    if trainer.multi_step is not None:
        trainer.multi_step.close()
    if trainer.ctx.is_main_process:
        print(json.dumps({
            "world": trainer.ctx.world,
            "resident": trainer.resident_train is not None,
            "updates": trainer.state.step,
            "global_batch": trainer.global_batch_size,
            "images_per_sec": result["images_per_sec"],
            "images_per_sec_per_card": result["images_per_sec_per_card"],
            "wall_time_s": result["wall_time_s"],
            "final_loss": trainer.step_losses[-1],
            "losses_sha256": hashlib.sha256(json.dumps(
                trainer.step_losses).encode()).hexdigest(),
            "rank_digests": digests,
            "ranks_bit_identical": len(set(digests)) == 1}), flush=True)
    shutdown()
    return 0


def main() -> int:
    import torch

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    worlds = [n for n in (1, 2, 4) if n <= torch.cuda.device_count()]
    bad = 0
    path = os.path.join(ROOT, "chiprun_out", "resident_multicard.jsonl")
    with open(path, "w", encoding="utf-8") as lines:
        for n in worlds:
            for feed in ("on", "off"):
                ckpt = os.path.join(ROOT, "build", "resident_multicard_ckpt")
                t0 = time.perf_counter()
                run = subprocess.run(
                    [sys.executable, "-m", "torch.distributed.run",
                     "--standalone", f"--nproc_per_node={n}", __file__,
                     "--worker", *ARGS, f"--data.device_resident={feed}",
                     f"--train.ckpt_dir={ckpt}"],
                    cwd=ROOT, capture_output=True, text=True, timeout=900)
                subprocess.run(["rm", "-rf", ckpt], check=False)
                last = (run.stdout.strip().splitlines() or [""])[-1]
                try:
                    rec = json.loads(last)
                except json.JSONDecodeError:
                    rec = {"world": n, "error": run.stderr[-3000:]}
                rec.update(feed=feed, rc=run.returncode, card=card,
                           secs=time.perf_counter() - t0)
                ok = (run.returncode == 0 and rec.get("ranks_bit_identical")
                      and rec.get("resident") == (feed == "on"))
                bad += not ok
                print(json.dumps(rec), flush=True)
                lines.write(json.dumps(rec) + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2:]))
    sys.exit(main())
