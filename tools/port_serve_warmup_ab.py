"""A/B of where the port's serving warmup runs, on one CUDA card.

    python3 tools/port_serve_warmup_ab.py [--requests 200] [--rounds 2]

``caller``: the replica's ``warmup()`` on the calling thread, then the
replica's ``start(warmup=False)`` — the dispatch thread meets every bucket
cold. ``dispatch``: `InferenceEngine.start()`, which warms every bucket on
the dispatch thread itself (the only mode the engine offers). Both serve the full-width fused ResNet-18 (f32, seed 0) under the
same 200 Poisson requests at 400/s, in turns (caller, dispatch, caller,
dispatch, ...). Prints one JSON line per run — serve p50/p95 and device-span
p95, and the device span of the first batches in order — and the card's
name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(mode: str, requests: int) -> dict:
    import torch

    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.obs.counters import Counters
    from tpu_dp_torch.serve import InferenceEngine, run_load

    model = build_model("resnet18", fused_stages=(0, 1, 2, 3),
                        generator=torch.Generator().manual_seed(0))
    eng = InferenceEngine(model, device="cuda", registry=Counters())
    if mode == "caller":
        eng.replica.warmup()
        eng.replica.start(warmup=False)
    else:
        eng.start()
    try:
        rep = run_load(eng, n_requests=requests, seed=0)
    finally:
        eng.stop()
    batches = []
    for r in eng.recorder.records():  # one device span per batch
        d = round(r["spans"]["device"], 2)
        if not batches or batches[-1] != d:
            batches.append(d)
    return {
        "mode": mode, "consistent": rep["consistent"],
        "p50_ms": rep["latency_ms"]["p50_ms"],
        "p95_ms": rep["latency_ms"]["p95_ms"],
        "device_p95_ms": rep["spans"]["device"]["p95"],
        "first_batches_device_ms": batches[:12],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_serve_warmup_ab: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for _ in range(args.rounds):
        for mode in ("caller", "dispatch"):
            print(json.dumps({"card": card, **run(mode, args.requests)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
