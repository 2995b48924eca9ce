"""The comm attribution across cards (`chip_smoke.commprof_multi_card`) on a
machine with two or more cards: NCCL at world 2 and at world 4 (when four
cards are visible), one rank a card through ``torch.distributed.run``,
replicated (DDP) and sharded (f32 and int8), a comm window of 10 updates
over CUDA-graph windows of 10. Each run is held to the reconciliation per
kind, the sharded wire against `quant.wire_report`, ``wire_gbs`` and
``ici_util`` against the card's NVLink rate, and records the overlap
share.

    python3 tools/port_commprof_multicard.py

Prints each run's report and checks, writes the record to
``chiprun_out/commprof_multicard.json`` (each run's log beside it) and
exits 0 when every run held, 1 otherwise; with one card visible it prints
``commprof_nccl_multi_card: not run, 1 card visible`` and exits 0.
"""

from __future__ import annotations

import json
import os
import sys
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    out: dict = {}
    cs.phase_header(out)
    n = torch.cuda.device_count()
    if n < 2:
        print(f"commprof_nccl_multi_card: not run, {n} card visible")
        return 0
    cs.phase_build(out)
    rc = 0
    for world in sorted({2, min(n, 4)}):
        for wire in (None, "", "int8"):
            try:
                cs.commprof_multi_card(out, world, wire)
            except Exception:
                traceback.print_exc()
                rc = 1
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "commprof_multicard.json"),
              "w", encoding="utf-8") as f:
        json.dump(out, f, default=str)
    return rc


if __name__ == "__main__":
    sys.exit(main())
