"""The port's graceful elastic shrink across three gloo ranks (the twins of
tests/test_multiprocess.py's elastic runs, without the JAX package's
fingerprint check): ``leave:step=2,rank=2``, and a real external SIGTERM
to rank 0 under the sharded update (the membership leader, the snapshot
writer and the metrics owner hands over; the regroup reshards real
optimizer state).

In each run the leaver exits 143, the survivors regroup at world 2 with
dense new ranks and finish both epochs with bit-identical parameters,
equal (within 2e-5, the JAX package's bound) to a one-process oracle that
trains on the global batches rebuilt from the published membership record
with the JAX package's `ShardedSampler` and `elastic_resplit`; the oracle's
coverage is exact (no sample twice, at most a seam batch shed); the
counters and the ``elastic_regroup`` metrics event carry membership epoch
1. The ranks are subprocesses (tests/torch_ddp_worker.py, ``"job":
"elastic"``) meeting through a ``file://`` rendezvous; the regroup's
rendezvous is the record's loopback address."""

from __future__ import annotations

import json
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_util import ROOT, WORKER
from tpu_dp.data.sampler import ShardedSampler, elastic_resplit
from tpu_dp_torch.config import parse_cli
from tpu_dp_torch.data.cifar import load_dataset
from tpu_dp_torch.train.trainer import Trainer

pytestmark = pytest.mark.port

torch.set_num_threads(2)

_WORLD, _B, _EPOCHS = 3, 4, 2
_TIMEOUT_S = 240


def _args(ckpt: Path, train_size: int, *extra) -> list[str]:
    return ["--data.dataset=synthetic",
            f"--data.synthetic_train_size={train_size}",
            "--data.synthetic_test_size=16", f"--data.batch_size={_B}",
            f"--train.epochs={_EPOCHS}", "--train.log_every=100",
            "--train.eval_at_end=false", "--train.steps_per_call=1",
            "--train.ckpt_async=false", f"--train.ckpt_dir={ckpt}",
            "--resilience.elastic=true",
            "--resilience.elastic_verify_fingerprint=false",
            "--resilience.elastic_coordinator_host=127.0.0.1",
            "--resilience.regroup_timeout_s=60", *extra]


def _start(tmp: Path, args: list[str], world: int = _WORLD
           ) -> list[subprocess.Popen]:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("TPU_DP_FAULT", None)
    procs = []
    for rank in range(world):
        spec = {"job": "elastic", "args": args, "rank": rank,
                "world": world, "init": f"file://{tmp / 'rendezvous'}",
                "out": str(tmp / f"rank{rank}.pkl")}
        path = tmp / f"spec{rank}.json"
        path.write_text(json.dumps(spec))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(path)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(tmp: Path, procs, victim: int) -> dict:
    """Every rank's output; the victim exits 143, the survivors 0 (every
    rank 0 when ``victim`` is -1)."""
    try:
        logs = [p.communicate(timeout=_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        want = 143 if rank == victim else 0
        assert p.returncode == want, f"rank {rank}: rc {p.returncode}\n" \
                                     f"{log[-4000:]}"
    return {rank: pickle.loads((tmp / f"rank{rank}.pkl").read_bytes())
            for rank in range(len(procs))}


def _oracle(record: dict, train_size: int, tmp: Path):
    """The one-process oracle of the run's batch sequence: the global
    batches rebuilt from the record alone (`ShardedSampler` streams before
    the regroup, `elastic_resplit` for the tail, the world's streams after
    it), trained one update each by a port `Trainer` alone from the same
    seed; returns its parameters and how often each sample ran."""
    resume = record["resume"]
    interrupted, lineage = int(resume["epoch"]), resume["lineage"]
    world1 = int(record["world"])
    ds = load_dataset("synthetic", "./data", train=True,
                      allow_synthetic=True,
                      synthetic_num_examples=train_size, seed=0)

    def streams(epoch, prior, world):
        if not prior:
            out = []
            for r in range(world):
                s = ShardedSampler(len(ds), world, r, shuffle=True, seed=0)
                s.set_epoch(epoch)
                out.append(s.shard_indices())
            return out
        return [elastic_resplit(len(ds), True, 0, epoch, _B, prior, world, r)
                for r in range(world)]

    tr = Trainer(parse_cli(_args(tmp / "oracle", train_size)[:-4]),
                 device="cpu")
    counts = np.zeros(len(ds), np.int64)
    for epoch in range(_EPOCHS):
        if epoch < interrupted:
            segments = [([], _WORLD, None)]
        elif epoch == interrupted:
            segments = [([], _WORLD, int(lineage[0][1])),
                        (lineage, world1, None)]
        else:
            segments = [([], world1, None)]
        for prior, world, steps in segments:
            ss = streams(epoch, prior, world)
            n = min(len(s) for s in ss) // _B if steps is None else steps
            for k in range(n):
                sel = np.concatenate([s[k * _B:(k + 1) * _B] for s in ss])
                counts[sel] += 1
                tr.train_step(tr.state, {
                    "image": torch.from_numpy(ds.images[sel]),
                    "label": torch.from_numpy(ds.labels[sel]).long()})
    return ({k: p.detach().numpy() for k, p in tr.model.named_parameters()},
            counts)


def _check_run(results: dict, victim: int, train_size: int, tmp: Path):
    survivors = sorted(r for r in results if r != victim)
    assert "elastic departure" in results[victim]["preempted"]
    a = results[survivors[0]]
    record = a["record"]
    assert record["epoch"] == 1 and record["reason"] == "graceful"
    assert record["members"] == survivors
    assert [d["sid"] for d in record["departed"]] == [victim]
    assert record["resume"]["lineage"][0][0] == _WORLD
    for new_rank, sid in enumerate(survivors):
        r = results[sid]
        assert (r["sid"], r["new_rank"], r["world"]) == (sid, new_rank, 2)
        assert r["preempted"] is None
        c = r["counters"]
        assert c["elastic.regroups"] == 1 and c["elastic.lost_ranks"] == 1
        assert c["elastic.regroup_s"] > 0
        assert c["elastic.membership_epoch"] == 1
    assert results[victim]["counters"]["elastic.departures"] == 1
    # The survivors' states are bit-identical (parameters, statistics,
    # momentum) ...
    b = results[survivors[1]]
    assert a["final"].keys() == b["final"].keys()
    for k in a["final"]:
        assert a["final"][k].tobytes() == b["final"][k].tobytes(), k
    # ... and equal the oracle built from the record alone.
    params, counts = _oracle(record, train_size, tmp)
    final = {k.split("/", 1)[1]: v for k, v in a["final"].items()
             if k.startswith("params/")}
    from tpu_dp_torch.compat import convert_grads

    mine = {k: v.numpy() for k, v in convert_grads(
        _unflatten(final)).items()}
    assert mine.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(mine[k], v, atol=2e-5, rtol=0,
                                   err_msg=k)
    # Coverage: no sample ran more than once an epoch, and the interrupted
    # epoch shed at most its seam (under a new-world global batch).
    assert (counts <= _EPOCHS).all(), "a sample was consumed twice"
    assert int((counts < _EPOCHS).sum()) < 2 * _B * 2
    return record


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def test_leave_on_rank_2_shrinks_to_two_survivors(tmp_path):
    procs = _start(tmp_path, _args(tmp_path / "ck", 48,
                                   "--resilience.fault=leave:step=2,rank=2"))
    results = _finish(tmp_path, procs, victim=2)
    record = _check_run(results, 2, 48, tmp_path)
    # The ledger holds the whole transition.
    gen = next((tmp_path / "ck" / "membership").iterdir())
    names = {p.name for p in gen.iterdir()}
    assert {"epoch_0000.json", "epoch_0001.json", "plan_e0001.json",
            "left_r00002.json", "q_e0001_r00000.done",
            "q_e0001_r00001.done", "q_e0001_r00002.done"} <= names
    plan = json.loads((gen / "plan_e0001.json").read_text())
    assert plan["leavers"] == [2] and plan["survivors"] == [0, 1]
    assert record["resume"]["global_step"] == plan["stop_step"]


def test_external_sigterm_on_rank_0_under_the_sharded_update(tmp_path):
    """A real SIGTERM to rank 0 while it is parked at its step-2 boundary
    (a one-shot delay: the run is milliseconds a step, and an unpinned
    signal could land after the job ended)."""
    ck = tmp_path / "ck"
    procs = _start(tmp_path, _args(
        ck, 96, "--train.update_sharding=sharded", "--train.obs=basic",
        "--resilience.fault=delay:step=2,rank=0,ms=3000"))
    hb = ck / "obs" / "heartbeat_r00000.jsonl"
    deadline = time.monotonic() + 180
    while time.monotonic() < deadline:
        if hb.exists() and hb.read_text().count("\n") >= 1:
            break
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.05)
    procs[0].send_signal(signal.SIGTERM)
    results = _finish(tmp_path, procs, victim=0)
    _check_run(results, 0, 96, tmp_path)
    # The new rank 0 owns the metrics sink: the regroup's event and every
    # later record carry membership epoch 1.
    metrics = [json.loads(line) for line in
               (ck / "metrics.jsonl").read_text().splitlines()]
    regroups = [m for m in metrics if m.get("event") == "elastic_regroup"]
    assert len(regroups) == 1
    assert regroups[0]["membership_epoch"] == 1
    assert regroups[0]["world"] == 2 and regroups[0]["departed"] == [0]
    assert [m for m in metrics if "epoch" in m and "loss" in m
            and m.get("membership_epoch") == 1]
    # The re-homed heartbeats stamp their membership epoch.
    beats = (ck / "obs" / "me0001" / "heartbeat_r00000.jsonl").read_text()
    assert all(json.loads(line)["me"] == 1 for line in beats.splitlines())


def test_shutdown_frees_the_group_before_the_interpreters_teardown(tmp_path):
    """`dist.shutdown` (and `park_distributed`) free what still refers to
    the group: a `Trainer` is a reference cycle (its hooks hold it), and a
    group and store its model and sharded update kept alive into the
    interpreter's teardown could abort the exiting rank ("terminate called
    without an active exception": seen in gloo rank workers, elastic or
    not). With the collector off, only `shutdown`'s own collection frees
    them."""
    code = (
        "import gc, json, weakref, sys\n"
        "gc.disable()\n"
        "import torch.distributed as dist\n"
        "from tpu_dp_torch.config import parse_cli\n"
        "from tpu_dp_torch.parallel.dist import initialize, shutdown\n"
        "from tpu_dp_torch.train.trainer import Trainer\n"
        f"initialize(backend='gloo', init_method='file://{tmp_path}/rdv',\n"
        "           world_size=1, rank=0, device='cpu')\n"
        "t = Trainer(parse_cli(['--data.dataset=synthetic',\n"
        "    '--data.synthetic_train_size=16', '--data.batch_size=4',\n"
        "    '--train.update_sharding=sharded',\n"
        f"    '--train.ckpt_dir={tmp_path}/ck']), device='cpu')\n"
        "refs = [weakref.ref(dist.group.WORLD),\n"
        "        weakref.ref(dist.distributed_c10d._get_default_store())]\n"
        "del t\n"
        "shutdown()\n"
        "print(json.dumps([r() is None for r in refs]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, True]
