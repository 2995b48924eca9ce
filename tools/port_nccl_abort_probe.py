"""Can a survivor end an NCCL collective that waits on a dead peer, and go
on in the same process? The question behind the elastic rollback's NCCL
path (`tpu_dp_torch.parallel.dist.PeerFence`, `abort_communicators`,
`Trainer._release_world`).

Each variant runs as two processes on two cards (NCCL, world 2): both
all-reduce once; unless the variant is ``eager`` they capture four
all-reduces in a CUDA graph and replay it once; rank 1 then exits
(``os._exit(137)``) and rank 0 issues the collective again (a replay, or
one eager all-reduce), which waits on the dead peer. Rank 0 checks that
the card is wedged (an event not done after 3 s), then tries to end it:

- ``eager``, ``abort_pg``: ``torch.distributed.distributed_c10d.
  _abort_process_group()``;
- ``backend_abort``: the default group's NCCL backend ``abort()``;
- ``nonblocking``: ``_abort_process_group()`` with non-blocking NCCL
  communicators (``TORCH_NCCL_USE_COMM_NONBLOCKING=1``);
- ``reset_then_abort``: the graph freed first (``CUDAGraph.reset()``,
  no synchronisation), then ``_abort_process_group()``.

After the abort it records whether the card drained, synchronises, uses
the card, and forms a new NCCL group of one and all-reduces on it. A
variant that hangs is cut after 20 s by `faulthandler`, which prints where
rank 0 was. Pairs of variants run at once on cards (0, 1) and (2, 3). One
line per step of each variant, each with its seconds; the card's name and
power limit and the torch and NCCL versions head the output. Run from the
repository root on a machine with four H100s:

    python3 tools/port_nccl_abort_probe.py [variant ...]
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import subprocess
import sys
import time

VARIANTS = ("eager", "abort_pg", "backend_abort", "nonblocking",
            "reset_then_abort")


def rank_main(variant: str, rank: int, port: int, card0: int) -> None:
    """One rank of one variant (module docstring)."""
    if variant == "nonblocking":
        os.environ["TORCH_NCCL_USE_COMM_NONBLOCKING"] = "1"
    os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
    import torch
    import torch.distributed as dist

    def say(*what):
        print(variant, *what, flush=True)

    dev = torch.device("cuda", card0 + rank)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
        rank=rank, timeout=datetime.timedelta(seconds=60))
    x = torch.ones(1 << 20, device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    graph = None
    if variant != "eager":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                dist.all_reduce(x)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(4):
                dist.all_reduce(x)
                x.mul_(0.5)
        graph.replay()
        torch.cuda.synchronize()
    dist.barrier(device_ids=[dev.index])
    torch.cuda.synchronize()
    if rank == 1:
        say("rank 1 exits")
        os._exit(137)
    time.sleep(2)
    if graph is not None:
        graph.replay()
    else:
        dist.all_reduce(x)
    done = torch.cuda.Event()
    done.record()
    t0 = time.time()
    while not done.query() and time.time() - t0 < 3:
        time.sleep(0.01)
    say("wedged:", not done.query())
    faulthandler.dump_traceback_later(20, exit=True)
    t0 = time.time()
    if variant == "reset_then_abort":
        graph.reset()
        graph = None
        say(f"graph reset without a synchronisation after "
            f"{time.time() - t0:.2f} s")
    if variant == "backend_abort":
        dist.group.WORLD._get_backend(dev).abort()
    else:
        dist.distributed_c10d._abort_process_group()
    say(f"abort returned after {time.time() - t0:.2f} s")
    t0 = time.time()
    while not done.query() and time.time() - t0 < 10:
        time.sleep(0.01)
    say(f"drained: {done.query()} after {time.time() - t0:.2f} s")
    if graph is not None:
        graph.reset()
    torch.cuda.synchronize()
    say("synchronized; the card computes:",
        (torch.ones(4, device=dev) * 2).sum().item())
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port + 7}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=30))
    z = torch.ones(8, device=dev)
    dist.all_reduce(z)
    torch.cuda.synchronize()
    say("a new group of one all-reduces:", z.sum().item())
    faulthandler.cancel_dump_traceback_later()
    os._exit(0)


def main(argv: list[str]) -> int:
    import torch

    variants = argv or list(VARIANTS)
    if torch.cuda.device_count() < 2:
        print("port_nccl_abort_probe: needs two cards")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0])
    print("torch", torch.__version__, "nccl", torch.cuda.nccl.version())
    pairs = torch.cuda.device_count() // 2
    for start in range(0, len(variants), pairs):
        procs = []
        for j, variant in enumerate(variants[start:start + pairs]):
            port = 29500 + 100 * (start + j)
            procs.append((variant, [subprocess.Popen(
                [sys.executable, __file__, "--rank", variant, str(r),
                 str(port), str(2 * j)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in (0, 1)]))
        for variant, ranks in procs:
            for r, p in enumerate(ranks):
                try:
                    log = p.communicate(timeout=90)[0]
                except subprocess.TimeoutExpired:
                    p.kill()
                    log = p.communicate()[0] + "\n(killed at 90 s)"
                if r == 0:
                    lines = [x for x in log.splitlines()
                             if "Warning" not in x]
                    print(f"=== {variant} (rank 0, rc {p.returncode})")
                    print("\n".join(lines[-25:]))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        v, rk, pt, c0 = sys.argv[2:6]
        rank_main(v, int(rk), int(pt), int(c0))
    else:
        sys.exit(main(sys.argv[1:]))
