"""How many device records `torch.profiler` loses on the card, and what
the loss follows: the number of profiler sessions the process has opened,
the process's age, or the CPU activity a session traces.

Profiles the port's training step (`chip_smoke.py`'s configuration) in
three rounds of sessions, in one process:

1. after a short warm-up (one epoch of the step);
2. after a long warm workload without any session (``--warm-epochs``
   epochs more: the process ages, the session count does not);
3. straight after round 2 (the session count grows, the age barely).

Each round opens ``--sessions`` sessions of ``--steps`` steps per mode,
the modes alternating: CPU + CUDA activities (as `chip_smoke.py` once
profiled), CUDA alone, and CUDA alone after a lead-in of spin kernels
waited for and left out of the counts (`chip_smoke.PROFILE_LEAD_IN`, what
every by-name check of `chip_smoke.py` does now). The step launches
the same kernels every time, so a session that counts fewer device events
than the most any session counted lost records. One JSON line per session
(round, mode, the process's session index, its age in seconds, events,
records short) and a summary by round and mode; the card's name and power
limit head the output; the record goes to ``chiprun_out/profiler_loss.json``.
Run from the repository root on a machine with an H100:

    python3 tools/port_profiler_loss.py [--sessions 20] [--steps 5] \\
        [--warm-epochs 8]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's kernels, by name (what the by-name books count).
OURS = ("conv_block_kernel", "xent_", "crop_flip_draws")


def _profile(fn, steps, activities, lead_in=0):
    import torch
    from torch.profiler import profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(lead_in):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    counts: dict[str, int] = {}
    for ev in prof.key_averages():
        if (str(getattr(ev, "device_type", "")) == "DeviceType.CUDA"
                and not (lead_in and "spin_kernel" in ev.key)):
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=20)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warm-epochs", type=int, default=8)
    args = ap.parse_args()

    born = time.perf_counter()
    sys.path.insert(0, HERE)
    import torch
    from torch.profiler import ProfilerActivity

    import chip_smoke as cs
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        print("port_profiler_loss: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(card, flush=True)

    trainer = Trainer(parse_cli(cs.TRAIN_ARGS), device="cuda")
    trainer.fit()
    batch = next(iter(trainer.train_pipe))

    def step():
        return trainer.train_step(trainer.state, batch)

    modes = {"cpu+cuda": ([ProfilerActivity.CPU, ProfilerActivity.CUDA], 0),
             "cuda": ([ProfilerActivity.CUDA], 0),
             "cuda+lead-in": ([ProfilerActivity.CUDA], cs.PROFILE_LEAD_IN)}
    sessions = []
    opened = 0
    for rnd in (1, 2, 3):
        if rnd == 2:
            for epoch in range(args.warm_epochs):
                trainer.train_epoch(epoch)
            torch.cuda.synchronize()
        for _ in range(args.sessions):
            for mode, (acts, lead_in) in modes.items():
                counts = _profile(step, args.steps, acts, lead_in)
                opened += 1
                sessions.append({
                    "round": rnd, "mode": mode, "session": opened,
                    "age_s": round(time.perf_counter() - born, 3),
                    "events": sum(counts.values()), "counts": counts})
    most = {m: max(s["events"] for s in sessions if s["mode"] == m)
            for m in modes}
    for s in sessions:
        s["short"] = most[s["mode"]] - s["events"]
        full = max((x["counts"] for x in sessions
                    if x["mode"] == s["mode"]
                    and x["events"] == most[s["mode"]]), key=len)
        s["short_by_kernel"] = {k: v - s["counts"].get(k, 0)
                                for k, v in full.items()
                                if s["counts"].get(k, 0) != v}
        s["ours_short"] = sum(v for k, v in s["short_by_kernel"].items()
                              if any(t in k for t in OURS))
        print(json.dumps({k: v for k, v in s.items() if k != "counts"}),
              flush=True)
    summary = {}
    for rnd in (1, 2, 3):
        for mode in modes:
            mine = [s for s in sessions
                    if s["round"] == rnd and s["mode"] == mode]
            summary[f"round{rnd}/{mode}"] = {
                "sessions": len(mine),
                "sessions_short": sum(1 for s in mine if s["short"]),
                "records_short": sum(s["short"] for s in mine),
                "ours_short": sum(s["ours_short"] for s in mine),
                "first_session": mine[0]["session"],
                "age_s": [mine[0]["age_s"], mine[-1]["age_s"]]}
    record = {"card": card, "steps_per_session": args.steps,
              "warm_epochs": args.warm_epochs, "most": most,
              "summary": summary,
              "sessions": [{k: v for k, v in s.items() if k != "counts"}
                           for s in sessions]}
    print(json.dumps({"summary": summary, "most": most}), flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profiler_loss.json"), "w",
              encoding="utf-8") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
