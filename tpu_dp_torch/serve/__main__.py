"""`python -m tpu_dp_torch.serve` — the synthetic-load serving smoke and
chaos scenarios of the port (of `python -m tpu_dp.serve`).

Builds a freshly initialized f32 model from ``--seed`` (the fused
ResNet-18, full width by default: every stride-1 BasicBlock conv on the
hand-written CUDA kernel; ``--model=resnet50``: every stride-1
bottleneck's 3x3 on it), or with ``--ckpt=DIR`` serves a training
checkpoint of either package (a ``step_*`` dir or a checkpoint root; the
model comes from its meta), serves ``--requests`` synthetic requests
through the whole pipeline and prints the audited report JSON. f32 means
f32: TF32 is switched off for cuDNN and matmuls. On a card every bucket
runs as a CUDA graph captured at warmup.

Devices: without ``--device`` the run needs the CUDA card(s) — one
replica per visible card with ``--replicas N`` — and exits 2 without
one; ``--device D`` puts every replica on ``D`` (``--device cuda``:
replicas share the one card, each on its own stream; ``--device cpu``
runs on the CPU with the kernels' plain versions).

With ``--replicas N`` the run goes through the self-healing tier
(`ServeCluster`): failover, elastic drain/rejoin, hot swap and SLO
classes, all scriptable mid-load:

    --fault "delay:step=3,ms=500,rank=0;leave:step=5,rank=1"
    --drain-at 40:1 --rejoin-at 160:1 --swap-at 120
    --class-mix 0.6,0.4 --class-slo-ms 250,800 --floors 0:0.9
    --run-dir DIR        # heartbeats + membership ledger + flightrec dump
                         # → `python -m tpu_dp_torch.obs timeline DIR`

SIGTERM during the run means drain-then-leave for ``--sigterm-drains SID``
(default: the whole tier stops admitting and drains out — typed `closed`
sheds, never dropped requests).

Exit code is the verdict:

- 0: every request accounted for, loadgen ground truth == serve counters
  exactly (per class included), zero post-warmup retraces, and every
  ``--floors`` class met its attainment floor;
- 1: the run completed but the audit failed (inconsistent books, a
  retrace, or a class below its floor);
- 2: usage error (including no CUDA card without ``--device``, and
  ``--profile``: the tune harness's profiles are not ported yet).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse_at_sid(spec: str, flag: str) -> tuple[int, int]:
    try:
        at, _, sid = spec.partition(":")
        return int(at), int(sid)
    except ValueError:
        raise ValueError(f"{flag} takes INDEX:SID, got {spec!r}") from None


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
    ap.add_argument("--ckpt", default=None,
                    help="serve params from this checkpoint dir "
                         "(from_checkpoint, params-only) instead of a "
                         "fresh init")
    ap.add_argument("--num-filters", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device of every replica (default: the "
                         "CUDA cards, one per replica)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the report JSON here")
    # -- the self-healing tier -------------------------------------------
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--run-dir", default=None,
                    help="serving artifact root: heartbeats, membership "
                         "ledger, flight-recorder dump (obsctl's input)")
    ap.add_argument("--fault", default="",
                    help="';'-separated deterministic fault specs, rank = "
                         "replica sid (e.g. 'delay:step=3,ms=500,rank=0;"
                         "leave:step=5,rank=1')")
    ap.add_argument("--stale-after-s", type=float, default=2.0)
    ap.add_argument("--max-retries", type=int, default=1)
    ap.add_argument("--class-mix", default=None,
                    help="SLO-class probability mix, class 0 first "
                         "(e.g. '0.6,0.3,0.1')")
    ap.add_argument("--class-slo-ms", default="",
                    help="per-class latency targets, class 0 first")
    ap.add_argument("--floors", default="",
                    help="per-class attainment floors 'cls:frac,...' — "
                         "exit 1 when missed")
    ap.add_argument("--swap-at", type=int, default=None,
                    help="hot-swap the model weights before this request "
                         "index (a fresh seed+1 init, or --swap-ckpt)")
    ap.add_argument("--swap-ckpt", default=None,
                    help="checkpoint dir the --swap-at swap loads "
                         "(params-only)")
    ap.add_argument("--drain-at", default=None, metavar="INDEX:SID",
                    help="drain-then-leave replica SID before request INDEX")
    ap.add_argument("--rejoin-at", default=None, metavar="INDEX:SID",
                    help="rejoin replica SID before request INDEX (waits "
                         "briefly for its drain to finish)")
    ap.add_argument("--sigterm-drains", type=int, default=None,
                    help="SIGTERM drains this replica sid instead of the "
                         "whole tier")
    ap.add_argument("--profile", default=None,
                    help="a tuned.json of the tune harness: not ported to "
                         "tpu_dp_torch yet (exit 2)")
    args = ap.parse_args(argv)

    if args.profile is not None:
        print(f"serve: --profile {args.profile}: the tune harness's "
              f"profiles are not ported to tpu_dp_torch yet (ROADMAP "
              f"Queue 1 item 12)", file=sys.stderr)
        return 2

    import torch

    from tpu_dp_torch.config import parse_class_floors, parse_class_slo_ms
    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.parallel.dist import resolve_device
    from tpu_dp_torch.serve import (
        BucketLadder, InferenceEngine, ServeCluster, parse_buckets, run_load,
    )
    from tpu_dp_torch.serve.router import replica_devices

    try:
        buckets = BucketLadder(parse_buckets(args.buckets)).buckets
        sizes = tuple(int(s) for s in args.sizes.split(",") if s.strip())
        class_slo_ms = parse_class_slo_ms(args.class_slo_ms)
        floors = parse_class_floors(args.floors)
        class_mix = (
            None if args.class_mix is None
            else tuple(float(m) for m in args.class_mix.split(","))
        )
        drain_at = (None if args.drain_at is None
                    else _parse_at_sid(args.drain_at, "--drain-at"))
        rejoin_at = (None if args.rejoin_at is None
                     else _parse_at_sid(args.rejoin_at, "--rejoin-at"))
        if args.replicas < 1:
            raise ValueError(f"--replicas must be >= 1, got {args.replicas}")
        cluster_only = [
            name for name, val in (
                ("--drain-at", drain_at), ("--rejoin-at", rejoin_at),
                ("--run-dir", args.run_dir),
                ("--sigterm-drains", args.sigterm_drains),
            ) if val is not None
        ]
        if args.replicas == 1 and cluster_only:
            raise ValueError(
                f"{', '.join(cluster_only)} need --replicas >= 2"
            )
        multi = args.replicas > 1
        if multi:
            devices = replica_devices(
                args.replicas,
                None if args.device is None
                else [resolve_device(args.device)] * args.replicas)
        else:
            device = resolve_device(args.device)
    except (ValueError, RuntimeError) as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def fresh(seed):
        gen = torch.Generator().manual_seed(seed)
        width = ({} if args.model.lower() == "net"
                 else {"num_filters": args.num_filters})
        return build_model(args.model, fused_stages=(0, 1, 2, 3),
                           generator=gen, **width)

    common = dict(buckets=buckets,
                  max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
                  slo_ms=args.slo_ms, class_slo_ms=class_slo_ms,
                  fault=args.fault)
    if multi:
        common.update(replicas=args.replicas, devices=devices,
                      run_dir=args.run_dir,
                      stale_after_s=args.stale_after_s,
                      max_retries=args.max_retries)
        cls = ServeCluster
    else:
        common.update(device=device)
        cls = InferenceEngine
    if args.ckpt:
        try:
            engine = cls.from_checkpoint(args.ckpt, **common)
        except (OSError, ValueError, KeyError) as e:
            print(f"serve: {e}", file=sys.stderr)
            return 2
    else:
        engine = cls(fresh(args.seed), model_name=args.model, **common)

    # The flight recorder + final dump are CLI-owned (not the cluster's):
    # a library embedder may share the process-wide recorder with a
    # trainer, and redirecting its dump dir behind their back would
    # misfile the trainer's black box.
    recorder = None
    if args.run_dir:
        from tpu_dp_torch.obs import flightrec

        recorder = flightrec.recorder
        recorder.configure(
            rank=0, dump_dir=os.path.join(args.run_dir, "obs"), fresh=True,
            run={"kind": "serve", "replicas": args.replicas,
                 "model": args.model},
        )

    def _swap():
        if args.swap_ckpt:
            engine.swap_from_checkpoint(args.swap_ckpt)
            return
        engine.swap_model(fresh(args.seed + 1).state_dict())

    def _rejoin(sid):
        # Wait briefly for the drain (scripted or fault-injected) to
        # land: rejoining a still-running replica is a scenario bug.
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if engine.replicas[sid].status in ("left", "stopped"):
                engine.rejoin(sid)
                return
            time.sleep(0.02)
        print(f"serve: replica {sid} never drained; rejoin skipped",
              file=sys.stderr)

    events = []
    if drain_at is not None:
        at, sid = drain_at
        events.append((at, f"drain:{sid}", lambda s=sid: engine.drain(s)))
    if rejoin_at is not None:
        at, sid = rejoin_at
        events.append((at, f"rejoin:{sid}", lambda s=sid: _rejoin(s)))
    if args.swap_at is not None:
        events.append((args.swap_at, "swap", _swap))

    if multi:
        engine.install_sigterm_drain(args.sigterm_drains)
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
        if recorder is not None:
            recorder.dump(reason="serve_exit")

    floor_misses = []
    for cls_id, floor in sorted(floors.items()):
        got = (report["classes"].get(str(cls_id)) or {}).get("attainment")
        if got is None or got < floor:
            floor_misses.append(
                {"class": cls_id, "floor": floor, "attainment": got}
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
