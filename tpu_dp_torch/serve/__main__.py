"""`python -m tpu_dp_torch.serve` — the synthetic-load serving smoke of the
port (of `python -m tpu_dp.serve`, single replica).

Builds a freshly initialized f32 model from ``--seed`` (the fused
ResNet-18, full width by default: every stride-1 BasicBlock conv on the
hand-written CUDA kernel), serves ``--requests`` synthetic requests
through the whole pipeline on the CUDA card (``--device cpu`` runs it on
the CPU with the kernels' plain versions) and prints the audited report
JSON. f32 means f32: TF32 is switched off for cuDNN and matmuls.

Exit code is the verdict:

- 0: every request accounted for, loadgen ground truth == serve counters
  exactly (per class included), device-side served books == images
  served, zero retraces, and every ``--floors`` class met its floor;
- 1: the run completed but the audit failed;
- 2: usage error (including no CUDA card without ``--device``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dp_torch.serve",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--pattern", default="poisson",
                    choices=["poisson", "burst", "diurnal"])
    ap.add_argument("--rate-rps", type=float, default=400.0)
    ap.add_argument("--burst", type=int, default=8)
    ap.add_argument("--sizes", default="1,2,3,4",
                    help="request image-count choices (mixed-size traffic)")
    ap.add_argument("--buckets", default="1,2,4,8,16,32",
                    help="padded batch-size ladder")
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--slo-ms", type=float, default=250.0,
                    help="per-request latency target")
    ap.add_argument("--model", default="resnet18")
    ap.add_argument("--num-filters", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the report JSON here")
    ap.add_argument("--class-mix", default=None,
                    help="SLO-class probability mix, class 0 first "
                         "(e.g. '0.6,0.3,0.1')")
    ap.add_argument("--class-slo-ms", default="",
                    help="per-class latency targets, class 0 first")
    ap.add_argument("--floors", default="",
                    help="per-class attainment floors 'cls:frac,...' — "
                         "exit 1 when missed")
    ap.add_argument("--swap-at", type=int, default=None,
                    help="hot-swap to a fresh seed+1 init before this "
                         "request index")
    args = ap.parse_args(argv)

    import torch

    from tpu_dp_torch.config import parse_class_floors, parse_class_slo_ms
    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.parallel.dist import resolve_device
    from tpu_dp_torch.serve import (
        BucketLadder, InferenceEngine, parse_buckets, run_load,
    )

    try:
        device = resolve_device(args.device)
        buckets = BucketLadder(parse_buckets(args.buckets)).buckets
        sizes = tuple(int(s) for s in args.sizes.split(",") if s.strip())
        class_slo_ms = parse_class_slo_ms(args.class_slo_ms)
        floors = parse_class_floors(args.floors)
        class_mix = (
            None if args.class_mix is None
            else tuple(float(m) for m in args.class_mix.split(","))
        )
    except (ValueError, RuntimeError) as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    def fresh(seed):
        gen = torch.Generator().manual_seed(seed)
        return build_model(args.model, num_filters=args.num_filters,
                           fused_stages=(0, 1, 2, 3), generator=gen)

    engine = InferenceEngine(
        fresh(args.seed), device=device, buckets=buckets,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        slo_ms=args.slo_ms, class_slo_ms=class_slo_ms,
    )
    events = []
    if args.swap_at is not None:
        events.append((args.swap_at, "swap",
                       lambda: engine.swap_model(
                           fresh(args.seed + 1).state_dict())))

    engine.start()
    try:
        report = run_load(
            engine,
            n_requests=args.requests,
            pattern=args.pattern,
            rate_rps=args.rate_rps,
            sizes=sizes,
            burst=args.burst,
            seed=args.seed,
            class_mix=class_mix,
            class_slo_ms=class_slo_ms,
            events=events,
        )
    finally:
        engine.stop()

    floor_misses = []
    for cls, floor in sorted(floors.items()):
        got = (report["classes"].get(str(cls)) or {}).get("attainment")
        if got is None or got < floor:
            floor_misses.append(
                {"class": cls, "floor": floor, "attainment": got}
            )
    ok = (report["consistent"] and report["retraces"] == 0
          and not floor_misses)
    report["verdict"] = {
        "ok": bool(ok),
        "consistent": report["consistent"],
        "retraces": report["retraces"],
        "floors": {str(c): f for c, f in sorted(floors.items())},
        "floor_misses": floor_misses,
    }

    payload = json.dumps(report, indent=2, sort_keys=True)
    print(payload)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(payload + "\n")

    if not ok:
        print(
            f"serve: AUDIT FAILED — consistent={report['consistent']} "
            f"retraces={report['retraces']} floor_misses={floor_misses}",
            file=sys.stderr,
        )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
