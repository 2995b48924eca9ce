"""The port's live MFU at each preset of the JAX package: every preset with
an analytic FLOP count (ResNet-18 and ResNet-50; the reference `Net` has
none, so it publishes no MFU), with the kernel knobs, on synthetic data,
one epoch of ``--windows`` windows of ``--k`` updates (the preset's
synthetic dataset: CIFAR-10's or CIFAR-100's shapes and classes) at
``--train.obs=full``: the ``obs.mfu`` gauge of the last window (the
card's dense bf16 data-sheet peak, `tpu_dp_torch/obs/chips.py`), the
efficiency rollup, the per-update spans of that window and the windowed
update's CUDA-event ms for comparison.

    python tools/port_obs_mfu.py                       # on the card
    python tools/port_obs_mfu.py --device cpu --batch 2 --k 2 --windows 2 \\
        --peak 1e12                                    # rehearsal

Prints the card's name and power limit, then one JSON line per preset;
the same records go to ``chiprun_out/port_obs_mfu.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ("resnet18_cifar10", "resnet18_8chip_gb1024", "resnet50_cifar100",
           "bf16_cosine_gb4096")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=0,
                    help="per-card batch (0: the preset's)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--peak", type=float, default=0.0,
                    help="obs.peak_flops_override (0: the card's)")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.obs.counters import counters
    from tpu_dp_torch.train.trainer import Trainer

    cuda = args.device.startswith("cuda")
    if cuda and not torch.cuda.is_available():
        print("port_obs_mfu: no CUDA device", file=sys.stderr)
        return 1
    card = "cpu"
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    recs = []
    for preset in PRESETS:
        with tempfile.TemporaryDirectory(prefix="port_obs_mfu_") as tmp:
            cfg = parse_cli([
                f"--preset={preset}", "--model.fused_stages=all",
                "--model.fused_bwd=true", "--train.pallas_xent=true",
                # The preset's dataset, synthetic: a data root without
                # files (CIFAR-100's 100 classes for ResNet-50).
                f"--data.root={os.path.join(tmp, 'no_cifar_files')}",
                "--train.epochs=1",
                "--train.log_every=1000", "--train.eval_at_end=false",
                f"--train.steps_per_call={args.k}", "--train.obs=full",
                f"--obs.peak_flops_override={args.peak}",
                f"--train.ckpt_dir={tmp}"])
            if args.batch:
                cfg.data.batch_size = args.batch
            cfg.data.synthetic_train_size = (args.k * args.windows
                                             * cfg.data.batch_size)
            cfg.data.synthetic_test_size = cfg.data.batch_size
            t = Trainer(cfg, device=args.device)
            t.fit()
            with open(t.metrics_path, encoding="utf-8") as f:
                lines = [json.loads(line) for line in f]
            last = [r for r in lines if "spans" in r
                    and "epoch" not in r][-args.k:]
            epoch = next(r for r in lines if "epoch" in r)
            rec = {"preset": preset, "card": card,
                   "batch": cfg.data.batch_size,
                   "bf16": cfg.model.bf16, "k": args.k,
                   "mfu_gauge": counters.get("obs.mfu", None),
                   "efficiency": epoch.get("efficiency"),
                   "spans_last_window": {k: statistics.median(
                       r["spans"][k] for r in last)
                       for k in last[0]["spans"]}}
            if cuda:
                it = t.train_pipe.index_windows(args.k)
                _, idx = next(it)
                it.close()
                table = t.resident_train
                call = lambda: t.multi_step(t.state, table, idx)  # noqa: E731
                call()
                times = []
                for _ in range(5):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    call()
                    b.record()
                    b.synchronize()
                    times.append(a.elapsed_time(b) / args.k)
                rec["event_ms_per_update"] = statistics.median(times)
                flops = rec["efficiency"]["flops_per_step_per_chip"]
                peak = t._eff.peak
                rec["mfu_cuda_events"] = (flops / (rec["event_ms_per_update"]
                                                   / 1e3) / peak)
            if t.multi_step is not None:
                t.multi_step.close()
            del t
        counters.reset()
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    with open(os.path.join(out_dir, "port_obs_mfu.jsonl"), "w",
              encoding="utf-8") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
