"""Joiners that are not a relaunched rank of the run, against the port's
elastic grow (the twin of tests/test_multiprocess.py::
test_two_process_joiner_crash_mid_handshake_no_wedge, and a freshly
launched joiner).

- The joiner that never comes: two gloo ranks train; the test forges a
  valid join request for sid 2 into the live generation and never starts
  that process. The members quiesce, publish the grow plan and the
  admitting record, wait out the join-ready gate (``regroup_timeout_s``),
  and re-form at world 2 from the very snapshot the grow committed: the
  ledger holds e1 (grow, admitting sid 2) then e2 (``grow_aborted``, sid 2
  departed with "join handshake timeout (grow aborted)", e1's resume), the
  verdict file says abort, nothing is replayed and both ranks finish both
  epochs bit-identical.
- A freshly launched joiner: a new OS process with
  ``--resilience.elastic_join=always --parallel.process_id=2`` joins a live
  two-rank run; all three end at world 3, bit-identical.

Every rank of both runs is a subprocess (tests/torch_ddp_worker.py) with
its own deadline. So that the run is still training when the joiner's
request lands, every rank sleeps at its step-2 boundary (``delay:`` with
no rank: all of them at once, so none waits on a peer in a collective)."""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from torch_port_util import ROOT, WORKER
from test_torch_elastic_ranks import _args, _finish, _start
from tpu_dp_torch.resilience.elastic import MembershipLedger

pytestmark = pytest.mark.port

torch.set_num_threads(2)

_TIMEOUT_S = 180


def _live_generation(ck_dir: Path, procs, deadline_s: float = 120) -> Path:
    """The run's generation directory once its epoch-0 record exists."""
    root = ck_dir / "membership"
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        gens = sorted(root.iterdir()) if root.exists() else []
        if gens and (gens[0] / "epoch_0000.json").exists():
            return gens[0]
        assert all(p.poll() is None for p in procs), "a rank exited early"
        time.sleep(0.05)
    raise AssertionError("no membership generation appeared")


def _records(gen: Path) -> list[dict]:
    return [json.loads(p.read_text())
            for p in sorted(gen.glob("epoch_*.json"))]


def _two_ranks(tmp: Path, n: int, *extra):
    """Two gloo ranks of the elastic Net run (the grow tests' args)."""
    args = _args(tmp / "ck", n, *extra)
    return args, _start(tmp, args, world=2)


def _same_final(results: dict) -> None:
    a = results[0]["final"]
    for r, x in results.items():
        assert x["final"].keys() == a.keys()
        for k in a:
            assert x["final"][k].tobytes() == a[k].tobytes(), (r, k)


def test_a_joiner_that_never_comes_costs_only_the_gate(tmp_path):
    window = 9  # regroup_timeout_s: the gate's wait on the ghost
    args, procs = _two_ranks(
        tmp_path, 64, "--resilience.fault=delay:step=2,ms=1500",
        "--resilience.snapshot_every_steps=2",
        "--resilience.snapshot_keep=0",
        f"--resilience.regroup_timeout_s={window}")
    try:
        gen = _live_generation(tmp_path / "ck", procs)
        assert MembershipLedger(gen, 2).publish_join(
            1, 2, token="ghost-token", generation=gen.name)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    t0 = time.monotonic()
    results = _finish(tmp_path, procs, victim=-1)
    assert time.monotonic() - t0 < _TIMEOUT_S
    records = _records(gen)
    assert [r["world"] for r in records] == [2, 3, 2]
    grow, back = records[1], records[2]
    assert grow["reason"] == "grow"
    assert grow["joined"] == [{"sid": 2, "token": "ghost-token"}]
    assert back["reason"] == "grow_aborted" and back["members"] == [0, 1]
    assert back["departed"] == [{
        "sid": 2, "reason": "join handshake timeout (grow aborted)"}]
    assert back["resume"] == grow["resume"]
    snap = Path(back["resume"]["snapshot_dir"])
    assert (snap / "state.msgpack").exists()
    verdict = json.loads((gen / "grow_verdict_e0001.json").read_text())
    assert verdict["commit"] is False and "[2]" in verdict["reason"]
    assert not (gen / "join_ready_e0001_r00002.json").exists()
    for sid in (0, 1):
        r = results[sid]
        assert (r["world"], r["new_rank"], r["preempted"]) == (2, sid, None)
        assert r["record"] == back
        # Nothing replayed: one loss per update, the clock at the epochs'
        # end (8 updates an epoch at world 2, both epochs).
        assert r["host_step"] == len(r["losses"]) == 16
        c = r["counters"]
        assert (c["elastic.regroups"], c["elastic.joined_ranks"],
                c["elastic.lost_ranks"]) == (1, 0, 0)
    _same_final(results)


def test_a_freshly_launched_joiner_grows_a_live_run(tmp_path):
    args, procs = _two_ranks(
        tmp_path, 96, "--resilience.fault=delay:step=2,ms=8000",
        "--resilience.regroup_timeout_s=30")
    # A new process with a stable id, no group of its own and no fault,
    # started beside the members; it asks to join once their generation
    # is live.
    spec = {"job": "elastic", "rank": 2,
            "out": str(tmp_path / "rank2.pkl"),
            "await_ledger": str(tmp_path / "ck" / "membership"),
            "args": [a for a in args
                     if not a.startswith("--resilience.fault=")]
            + ["--resilience.elastic_join=always",
               "--parallel.process_id=2"]}
    path = tmp_path / "spec2.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("TPU_DP_FAULT", None)
    joiner = subprocess.Popen(
        [sys.executable, str(WORKER), str(path)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        results = _finish(tmp_path, procs, victim=-1)
        log = joiner.communicate(timeout=_TIMEOUT_S)[0]
        assert joiner.returncode == 0, log[-4000:]
    finally:
        for p in procs + [joiner]:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    gen = next((tmp_path / "ck" / "membership").iterdir())
    results[2] = pickle.loads((tmp_path / "rank2.pkl").read_bytes())
    records = _records(gen)
    assert [r["world"] for r in records] == [2, 3]
    request = json.loads((gen / "join_e0001_r00002.json").read_text())
    assert records[1]["reason"] == "grow"
    assert records[1]["joined"] == [{"sid": 2, "token": request["token"]}]
    for sid in range(3):
        r = results[sid]
        assert (r["sid"], r["new_rank"], r["world"]) == (sid, sid, 3)
        assert r["record"] == records[1] and r["preempted"] is None
    assert results[2]["counters"]["elastic.joins"] == 1
    assert results[2]["adopted"]["step"] == records[1]["resume"][
        "global_step"]
    _same_final(results)
