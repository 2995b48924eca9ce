"""Preemption across two gloo ranks of the port (``resilience.fault=
preempt:step=K`` on both ranks): each rank takes the final snapshot at the
same window boundary (under the sharded update the snapshot's gather is a
collective both ranks join), meets the other at the barrier and raises
`PreemptedError`; a resume at the same world ends bit-identical to the
uninterrupted run, replicated and sharded. The ranks run as subprocesses
(tests/torch_ddp_worker.py) meeting through a ``file://`` rendezvous."""

from __future__ import annotations

import pytest
import torch

from torch_port_util import run_worker_ranks

pytestmark = pytest.mark.port

torch.set_num_threads(2)

#: the reference `Net`, 2 per rank (global batch 4): 12 updates an epoch.
_ARGS = ["--data.dataset=synthetic", "--data.synthetic_train_size=48",
         "--data.synthetic_test_size=8", "--data.batch_size=2",
         "--train.epochs=2", "--train.log_every=100", "--data.augment=true",
         "--data.device_resident=off", "--resilience.snapshot_every_steps=5"]


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.parametrize("sharding", ["replicated", "sharded"])
def test_two_ranks_preempted_and_resumed_bit_identical(tmp_path, sharding):
    args = _ARGS + [f"--train.update_sharding={sharding}"]

    def ranks(name, *extra):
        return run_worker_ranks(tmp_path / name, {"job": "trainer", "args": (
            args + [f"--train.ckpt_dir={tmp_path / name}", *extra])}, 2)

    full = ranks("full")
    part = ranks("run", "--resilience.fault=preempt:step=15")
    for r in part:
        assert r["preempted"] and "global step 15" in r["preempted"]
    assert (tmp_path / "run" / "snapshots" / "step_0000000015").exists()
    resumed = run_worker_ranks(tmp_path / "resume", {"job": "trainer",
                               "args": args + [
                                   f"--train.ckpt_dir={tmp_path / 'run'}",
                                   "--resume"]}, 2)
    for r, f, p in zip(resumed, full, part):
        assert r["start"] == (1, 3) and "snapshots" in r["resumed_from"]
        assert _same(r["restored"], p["final"])
        assert r["losses"] == f["losses"][15:]
        assert _same(r["final"], f["final"])
    assert _same(resumed[0]["final"], resumed[1]["final"])
