"""Phase 17's NCCL runs of `chip_smoke.py` alone, on a machine with two or
more cards: (h) the grow, world 2 -> 1 -> 2 by ``relaunch:`` on rank 1 in
windows of 10 as CUDA graphs, then (e) the rollback, rank 1 killed at
update 30, each with every check of `chip_smoke.py` and each rank process
within a 300 s deadline (the full phase allows 480).

    python3 tools/port_elastic_multicard.py

Prints each run's checks and seconds, writes the record to
``chiprun_out/elastic_multicard.json`` (the ranks' logs beside it) and
exits 0 when both held, 1 when (h) failed, 2 when only (e) failed.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    cs.ELASTIC_RANK_DEADLINE_S = 300
    out: dict = {}
    cs.phase_header(out)
    cs.phase_build(out)
    out["elastic"] = {"card": out["card"]}
    rc = 0
    t0 = time.perf_counter()
    try:
        grow = cs.ELASTIC_ARGS + [
            f"--data.synthetic_train_size={cs.ELASTIC_NCCL_TRAIN}",
            f"--train.steps_per_call={cs.ELASTIC_NCCL_WIN}",
            f"--resilience.snapshot_every_steps={cs.ELASTIC_NCCL_WIN}",
            "--resilience.snapshot_keep=0",
            f"--resilience.fault=relaunch:step={cs.ELASTIC_NCCL_K},rank=1"]
        rec = cs._elastic_grow_run(out, cs._start_elastic(
            "elastic_grow_nccl_multi_card", "nccl", 2, grow, grow=True),
            "nccl", 2, 1, grow)
        print(f"(h) captured {rec['captured']}, "
              f"{time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        rc = 1
    t0 = time.perf_counter()
    try:
        nccl_args = cs.ELASTIC_ARGS + [
            f"--data.synthetic_train_size={cs.ELASTIC_NCCL_TRAIN}",
            f"--train.steps_per_call={cs.ELASTIC_NCCL_WIN}",
            "--train.epochs=1"]
        rec = cs._elastic_rollback_run(
            out, "elastic_rollback_nccl_multi_card", "nccl", 2, 1,
            cs.ELASTIC_NCCL_KILL_K, nccl_args, eager=False)
        print(f"(e) captured {rec['captured']}, "
              f"{time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        rc = rc or 2
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "elastic_multicard.json"),
              "w", encoding="utf-8") as f:
        json.dump(out, f, default=str)
    return rc


if __name__ == "__main__":
    sys.exit(main())
