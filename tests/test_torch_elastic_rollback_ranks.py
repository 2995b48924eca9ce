"""The rollback flavour of the port's elastic shrink across three gloo ranks
(the twins of tests/test_multiprocess.py's rollback runs, without the JAX
package's fingerprint check), each run against a one-process oracle
rebuilt from the published membership record
(tests/test_torch_elastic_ranks.py's `_oracle`: the JAX package's
`ShardedSampler` and `elastic_resplit`):

- ``kill:step=5,rank=2`` (`os._exit(137)`, no goodbye): the survivors'
  collectives fail, they free the old group and check in with rollback
  flavour, and the acting leader declares rank 2 departed ("no quiesce
  check-in (timeout)") once the collection window passes; they re-form at
  world 2 from the newest complete snapshot (step 4, lineage ``[[3, 4]]``),
  replay the update the kill threw away and finish both epochs
  bit-identical, within the JAX package's 2e-5 of the oracle, every
  remaining sample visited once;
- a graceful plan whose leaver is killed before the stop step is
  downgraded to rollback, and the run resumes from the newest complete
  save; a graceful plan whose final snapshot never committed falls back to
  the same resume;
- a failure on one rank with every member alive is no membership event:
  every rank re-raises, nothing regroups;
- a live peer blocked in a collective with a failed rank fails at a third
  of the collection window, not at the group's timeout.

The SDC eviction is tests/test_torch_elastic_rollback_sdc.py. Each run has
its own deadline (`_TIMEOUT_S`): a hang fails that test."""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_elastic_ranks import _args, _oracle, _unflatten
from torch_port_util import ROOT, WORKER
from tpu_dp_torch.compat import convert_grads

pytestmark = pytest.mark.port

_WORLD, _TIMEOUT_S = 3, 240
#: the collection window: a vanished member costs seconds, not minutes.
_WINDOW = "--resilience.regroup_timeout_s=5"


def _start(tmp: Path, args: list[str], **spec_extra) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("TPU_DP_FAULT", None)
    procs = []
    for rank in range(_WORLD):
        spec = {"job": "elastic", "args": args, "rank": rank,
                "world": _WORLD, "init": f"file://{tmp / 'rendezvous'}",
                "out": str(tmp / f"rank{rank}.pkl"), **spec_extra}
        path = tmp / f"spec{rank}.json"
        path.write_text(json.dumps(spec))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(path)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(tmp: Path, procs) -> tuple[list[int], list[str], dict]:
    """Every rank's exit code, log and output (none for a killed rank),
    each rank under the run's deadline."""
    try:
        logs = [p.communicate(timeout=_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    outs = {r: pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(_WORLD) if (tmp / f"rank{r}.pkl").exists()}
    return [p.returncode for p in procs], logs, outs


def _ledger(tmp: Path) -> tuple[Path, dict]:
    gen = next((tmp / "ck" / "membership").iterdir())
    return gen, json.loads((gen / "plan_e0001.json").read_text())


def _check_rollback(tmp: Path, outs: dict, train_size: int, victim: int,
                    resume_step: int) -> dict:
    """The survivors' shared checks: one rollback regroup onto dense ranks
    at world 2 from the snapshot at ``resume_step``, bit-identical states,
    the oracle of the record within 2e-5, exact coverage."""
    survivors = [r for r in range(_WORLD) if r != victim]
    a, b = outs[survivors[0]], outs[survivors[1]]
    record = a["record"]
    assert b["record"] == record
    assert (record["epoch"], record["reason"], record["members"],
            record["world"]) == (1, "rollback", survivors, 2)
    assert [d["sid"] for d in record["departed"]] == [victim]
    resume = record["resume"]
    assert resume["snapshot_dir"].endswith(f"step_{resume_step:010d}")
    assert (resume["global_step"], resume["lineage"]) == (
        resume_step, [[_WORLD, resume_step]])
    for new_rank, sid in enumerate(survivors):
        r = outs[sid]
        assert (r["sid"], r["new_rank"], r["world"]) == (sid, new_rank, 2)
        c = r["counters"]
        assert c["elastic.regroups"] == 1 and c["elastic.lost_ranks"] == 1
        assert c["elastic.membership_epoch"] == 1
        # The losses are the record's sequence: the replayed updates'
        # first attempts are gone.
        assert len(r["losses"]) == r["host_step"]
    for k in a["final"]:
        assert a["final"][k].tobytes() == b["final"][k].tobytes(), k
    params, counts = _oracle(record, train_size, tmp)
    final = {k.split("/", 1)[1]: v for k, v in a["final"].items()
             if k.startswith("params/")}
    mine = {k: v.numpy() for k, v in convert_grads(_unflatten(final)).items()}
    for k, v in params.items():
        np.testing.assert_allclose(mine[k], v, atol=2e-5, rtol=0, err_msg=k)
    # Each remaining sample once an epoch; the re-split epoch sheds at
    # most its seam.
    assert (counts <= 2).all(), "a sample was consumed twice"
    assert int((counts < 2).sum()) < 2 * 4 * 2
    return record


def test_kill_on_rank_2_rolls_back_onto_two_survivors(tmp_path):
    procs = _start(tmp_path, _args(
        tmp_path / "ck", 96, _WINDOW, "--resilience.snapshot_every_steps=2",
        "--resilience.fault=kill:step=5,rank=2"))
    rcs, logs, outs = _finish(tmp_path, procs)
    assert rcs == [0, 0, 137], "\n".join(x[-3000:] for x in logs)
    record = _check_rollback(tmp_path, outs, 96, victim=2, resume_step=4)
    assert record["departed"] == [
        {"sid": 2, "reason": "no quiesce check-in (timeout)"}]
    gen, plan = _ledger(tmp_path)
    assert (plan["flavor"], plan["leavers"], plan["survivors"]) == (
        "rollback", [], [0, 1])
    assert plan["departed"] == record["departed"]
    names = {p.name for p in gen.iterdir()}
    assert {"q_e0001_r00000.json", "q_e0001_r00001.json",
            "epoch_0001.json"} <= names
    assert "q_e0001_r00002.json" not in names
    assert all(json.loads((gen / f"q_e0001_r{s:05d}.json").read_text())[
        "flavor"] == "rollback" for s in (0, 1))
    # The updates since the snapshot ran again at world 2: 4 at world 3,
    # then the tail's (96 - 48) / 8 = 6 and epoch 2's 12 at world 2.
    assert all(outs[s]["host_step"] == 4 + 6 + 12 for s in (0, 1))


def test_a_graceful_plan_whose_leaver_dies_is_downgraded_to_rollback(
        tmp_path):
    """Rank 2 announces its departure at step 2 (the graceful plan is
    published, its stop step at 5 or later) and is killed at step 4: the
    survivors' collectives fail under the graceful plan, they carry it out
    as a rollback, and resume from the step-4 snapshot, the newest complete
    save."""
    procs = _start(tmp_path, _args(
        tmp_path / "ck", 96, _WINDOW, "--resilience.snapshot_every_steps=1",
        "--resilience.fault=leave:step=2,rank=2;kill:step=4,rank=2"))
    rcs, logs, outs = _finish(tmp_path, procs)
    assert rcs == [0, 0, 137], "\n".join(x[-3000:] for x in logs)
    gen, plan = _ledger(tmp_path)
    assert (plan["flavor"], plan["leavers"]) == ("graceful", [2])
    assert plan["stop_step"] > 4
    record = _check_rollback(tmp_path, outs, 96, victim=2, resume_step=4)
    assert record["departed"] == [
        {"sid": 2, "reason": "preempted (graceful)"}]
    assert not (gen / "left_r00002.json").exists()


def test_a_graceful_plan_whose_final_snapshot_never_committed(tmp_path):
    """``leave:step=2,rank=2`` with the final snapshot lost (the writer's
    grace window: nothing commits at the stop step): the leader finds it
    missing before it publishes and falls back to the rollback resume, the
    newest cadence snapshot before the stop step; the leaver still departs
    (143), and the survivors replay from there."""
    procs = _start(tmp_path, _args(
        tmp_path / "ck", 96, _WINDOW, "--resilience.snapshot_every_steps=2",
        "--resilience.fault=leave:step=2,rank=2"), no_final_snapshot=True)
    rcs, logs, outs = _finish(tmp_path, procs)
    assert rcs == [0, 0, 143], "\n".join(x[-3000:] for x in logs)
    gen, plan = _ledger(tmp_path)
    stop = plan["stop_step"]
    assert plan["flavor"] == "graceful" and 4 < stop < 8
    assert "elastic departure" in outs[2]["preempted"]
    a = outs[0]
    record = a["record"]
    assert record["reason"] == "graceful"
    assert record["departed"] == [{"sid": 2,
                                   "reason": "preempted (graceful)"}]
    resume_step = (stop - 1) // 2 * 2
    assert record["resume"]["snapshot_dir"].endswith(
        f"step_{resume_step:010d}")
    assert record["resume"]["lineage"] == [[_WORLD, resume_step]]
    assert outs[1]["final"].keys() == a["final"].keys()
    for k in a["final"]:
        assert a["final"][k].tobytes() == outs[1]["final"][k].tobytes(), k
    params, counts = _oracle(record, 96, tmp_path)
    final = {k.split("/", 1)[1]: v for k, v in a["final"].items()
             if k.startswith("params/")}
    mine = {k: v.numpy() for k, v in convert_grads(_unflatten(final)).items()}
    for k, v in params.items():
        np.testing.assert_allclose(mine[k], v, atol=2e-5, rtol=0, err_msg=k)
    assert (counts <= 2).all()


def test_an_error_with_every_member_alive_reraises_on_every_rank(tmp_path):
    """Rank 1 fails (an injected `PeerFailedError`) with every member
    alive: its peers' collectives fail as it frees its group, all three
    check in with rollback flavour, the plan carries no membership change,
    and every rank re-raises; no membership epoch 1 forms."""
    procs = _start(tmp_path, _args(tmp_path / "ck", 96, _WINDOW),
                   raise_at=[1, 3])
    rcs, logs, outs = _finish(tmp_path, procs)
    assert all(rc not in (0, 137, 143) for rc in rcs), rcs
    assert outs == {}
    gen, plan = _ledger(tmp_path)
    assert (plan["flavor"], plan["departed"], plan["leavers"],
            plan["survivors"]) == ("rollback", [], [], [0, 1, 2])
    assert not (gen / "epoch_0001.json").exists()
    assert "injected failure, every member alive" in logs[1]
    assert all("Traceback" in x for x in logs)


def test_a_live_peer_blocked_on_a_failed_rank_fails_inside_the_window(
        tmp_path):
    """Rank 1 waits in a collective with rank 0, which has failed and
    never joins it. gloo's abort closes no socket, and freeing the group
    is impossible once DDP holds it, so an elastic gloo group's
    collectives wait on a peer a third of the collection window at most
    (6 s here): rank 1 fails with a peer failure after 2 s, in time to
    check in, not at the group's 300 s timeout."""
    code = (
        "import json, sys, time\n"
        "import torch, torch.distributed as dist\n"
        "from tpu_dp_torch.config import parse_cli\n"
        "from tpu_dp_torch.parallel.dist import is_peer_failure\n"
        "from tpu_dp_torch.train.trainer import Trainer\n"
        "rank = int(sys.argv[1])\n"
        "cfg = parse_cli(['--data.dataset=synthetic',\n"
        "    '--data.synthetic_train_size=16', '--data.batch_size=4',\n"
        "    '--resilience.elastic=true',\n"
        "    '--resilience.elastic_verify_fingerprint=false',\n"
        "    '--resilience.regroup_timeout_s=6',\n"
        f"    '--train.ckpt_dir={tmp_path}/ck'])\n"
        f"cfg.parallel.coordinator_address = 'file://{tmp_path}/rdv'\n"
        "cfg.parallel.num_processes, cfg.parallel.process_id = 2, rank\n"
        "t = Trainer(cfg, device='cpu')\n"
        "out = {}\n"
        "if rank == 1:\n"
        "    t0 = time.monotonic()\n"
        "    try:\n"
        "        dist.all_reduce(torch.zeros(4))\n"
        "    except Exception as e:\n"
        "        out = {'s': time.monotonic() - t0,\n"
        "               'peer': is_peer_failure(e)}\n"
        "else:\n"
        "    time.sleep(8)\n"
        "print('RESULT ' + json.dumps(out), flush=True)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    res = json.loads(next(line for line in logs[1].splitlines()
                          if line.startswith("RESULT "))[7:])
    assert res["peer"] and 1.5 < res["s"] < 5, logs[1][-2000:]
