"""What NCCL runs on the card for each of the port's collectives at one rank.

    python3 tools/port_nccl_world1_probe.py

Forms an NCCL group of one rank on ``cuda:0`` and issues the collectives
the port issues (an in-place all-reduce, a reduce-scatter, an all-gather,
an all-to-all of f32 and of int8, a broadcast), each once, between spin
kernels, under `torch.profiler` twice: with CUDA activity alone (the
trainer's session under NCCL) and with CPU activity too. Prints, for each
session, the device events by category (kernels, memcpys, memsets) and
the ``c10d::`` ops, with the card's name and power limit, torch's, CUDA's
and NCCL's versions; writes the record to
``chiprun_out/nccl_world1_probe.json``. The comm attribution reports each
kind absent at NCCL world 1 on what this shows (`tpu_dp_torch.obs.
commprof.absent_kinds`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_nccl_world1_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    rec = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            x = torch.randn(1 << 20, device=dev)

            def collectives():
                y = x.clone()
                dist.all_reduce(y)
                out = torch.empty_like(y)
                dist.reduce_scatter_tensor(out, y)
                dist.all_gather_into_tensor(torch.empty_like(y), out)
                dist.all_to_all_single(torch.empty_like(y), y)
                q = y.to(torch.int8)
                dist.all_to_all_single(torch.empty_like(q), q)
                dist.broadcast(y, 0)

            collectives()
            torch.cuda.synchronize()
            for name, acts in (("cuda", [ProfilerActivity.CUDA]),
                               ("cuda+cpu", [ProfilerActivity.CUDA,
                                             ProfilerActivity.CPU])):
                with profile(activities=acts) as prof:
                    for _ in range(64):
                        torch.cuda._sleep(500_000)
                    torch.cuda.synchronize()
                    collectives()
                    torch.cuda.synchronize()
                    for _ in range(64):
                        torch.cuda._sleep(500_000)
                    torch.cuda.synchronize()
                path = os.path.join(tmp, f"{name}.json")
                prof.export_chrome_trace(path)
                with open(path, encoding="utf-8") as f:
                    events = [e for e in json.load(f)["traceEvents"]
                              if e.get("ph") == "X"]
                by_cat: dict = {}
                for e in events:
                    cat, n = e.get("cat"), e.get("name")
                    if cat in ("kernel", "gpu_memcpy", "gpu_memset") or (
                            cat == "cpu_op" and str(n).startswith("c10d::")):
                        by_cat.setdefault(cat, {}).setdefault(n, 0)
                        by_cat[cat][n] += 1
                rec[name] = by_cat
        finally:
            dist.destroy_process_group()
    print(json.dumps(rec, indent=1))
    kernels = {n: c for n, c in rec["cuda"].get("kernel", {}).items()
               if "spin_kernel" not in n}
    nccl = {n: c for n, c in kernels.items() if n.startswith("nccl")}
    print(f"{card}: NCCL {rec['nccl']} at one rank: NCCL kernels {nccl or 'none'}"
          f"; memcpys {rec['cuda'].get('gpu_memcpy', {})}; other kernels "
          f"{ {n: c for n, c in kernels.items() if n not in nccl} }")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "nccl_world1_probe.json"),
              "w", encoding="utf-8") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
