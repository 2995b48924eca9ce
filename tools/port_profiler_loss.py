"""How many device records `torch.profiler` loses on the card: profiles the
port's training step (`chip_smoke.py`'s configuration, after a one-epoch
fit) in many sessions of a few steps each and counts the device events of
every session. The step launches the same kernels every time, so a session
that counts fewer events than the most any session counted lost records.
Run from the repository root on a machine with an H100:

    python3 tools/port_profiler_loss.py [--sessions 60] [--steps 5]

Profiles with CPU + CUDA activities (as `chip_smoke.py` does) and with CUDA
alone, and prints one JSON line per mode: the events of each session, the
sessions that lost records, and the kernels whose count fell between the
first session and the last. The card's name and power limit head the
output; the record goes to ``chiprun_out/profiler_loss.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _profile(fn, steps, activities):
    import torch
    from torch.profiler import profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    counts: dict[str, int] = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")) == "DeviceType.CUDA":
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=60)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

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

    record = {"card": card, "steps_per_session": args.steps, "modes": {}}
    modes = {"cpu+cuda": [ProfilerActivity.CPU, ProfilerActivity.CUDA],
             "cuda": [ProfilerActivity.CUDA]}
    for mode, acts in modes.items():
        sessions = [_profile(step, args.steps, acts)
                    for _ in range(args.sessions)]
        events = [sum(s.values()) for s in sessions]
        most = max(events)
        lost = {i: most - e for i, e in enumerate(events) if e < most}
        fell = {k: [sessions[0].get(k, 0), sessions[-1].get(k, 0)]
                for k in set(sessions[0]) | set(sessions[-1])
                if sessions[0].get(k, 0) != sessions[-1].get(k, 0)}
        rec = {"mode": mode, "events": events, "most": most,
               "sessions_short": len(lost), "lost_by_session": lost,
               "first_vs_last": fell}
        record["modes"][mode] = rec
        print(json.dumps(rec), flush=True)

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profiler_loss.json"), "w",
              encoding="utf-8") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
