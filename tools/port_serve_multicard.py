"""The serving tier across cards: `ServeCluster` with the default device
spread (one replica per visible CUDA card), at 2 replicas and at every
visible card.

    python3 tools/port_serve_multicard.py [--requests 400] [--rate 800]

Each run serves the fused full-width ResNet-18 (f32, random weights and
BN statistics from seed 0, every bucket a CUDA graph) under Poisson
requests of 1-4 images, classes 0.6/0.4 with SLOs 250/800 ms, and checks
the audited books overall and per class, the summed device books against
the images served, one replica per card, every replica serving, and 0
retraces with one capture per bucket per replica. Prints one JSON line
per run (p50/p95, images/s, per-class rollup) and the cards' names and
power limits; exits 1 if a check fails, 2 with fewer than two cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _model():
    import torch

    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.models.resnet import BatchNorm

    gen = torch.Generator().manual_seed(0)
    model = build_model("resnet18", num_filters=64, fused_stages=(0, 1, 2, 3),
                        generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.numel()
                m.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return model


def run(replicas: int, requests: int, rate: float) -> dict:
    import numpy as np

    from tpu_dp_torch.obs.counters import Counters
    from tpu_dp_torch.serve import ServeCluster, run_load

    slo = {0: 250.0, 1: 800.0}
    cluster = ServeCluster(_model(), replicas=replicas,
                           buckets=(1, 2, 4, 8, 16, 32), slo_ms=250.0,
                           class_slo_ms=slo, registry=Counters(),
                           model_name="resnet18")
    cluster.start()
    handles = []

    class _Keep:
        def submit(self, *a, **kw):
            h = cluster.submit(*a, **kw)
            handles.append(h)
            return h

        def __getattr__(self, name):
            return getattr(cluster, name)

    try:
        report = run_load(_Keep(), n_requests=requests, pattern="poisson",
                          rate_rps=rate, sizes=(1, 2, 3, 4), seed=0,
                          class_mix=(0.6, 0.4), class_slo_ms=slo)
    finally:
        cluster.stop()
    truth, dev = report["ground_truth"], report["device_stats"]
    hist = np.zeros(cluster.num_classes, np.int64)
    for h in handles:
        if h.ok:
            np.add.at(hist, np.asarray(h.predictions, np.int64), 1)
    guards = cluster.guard_stats()
    devices = [str(r.device) for r in cluster.replicas]
    checks = {
        "consistent": report["consistent"],
        "served_eq_images": dev["served"] == truth["images_served"],
        "histogram_eq_handles": dev["class_counts"] == hist.tolist(),
        "one_card_per_replica": len(set(devices)) == replicas
        and report["world"] == replicas,
        "every_replica_served": all(
            r["batches"] > 0 for r in report["replicas"].values()),
        "no_retraces": report["retraces"] == 0 and all(
            g["cache_size"] == 1 for g in guards),
    }
    lat = report["latency_ms"] or {}
    return {"replicas": replicas, "devices": devices, "checks": checks,
            "p50_ms": lat.get("p50_ms"), "p95_ms": lat.get("p95_ms"),
            "images_per_s": truth["images_served"]
            / report["load"]["wall_s"],
            "batches": {k: v["batches"]
                        for k, v in report["replicas"].items()},
            "classes": report["classes"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--rate", type=float, default=800.0)
    args = ap.parse_args()
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"port_serve_multicard: needs two or more CUDA cards, "
              f"{n} visible", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    ok = True
    for replicas in sorted({2, n}):
        rec = run(replicas, args.requests, args.rate)
        ok = ok and all(rec["checks"].values())
        print(json.dumps({"card": card, **rec}))
    print(f"serve_cluster_multi_card: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
