"""The port's in-run comm attribution across gloo ranks (the JAX package's
acceptance run, tests/test_commprof.py's
``test_inrun_comm_profile_sharded_reconciles``, on the port's Trainer):

- two ranks of the reference ``Net`` at ``--train.obs=full`` with
  ``--obs.comm_profile_steps=4:6``, replicated (DDP), sharded f32 and
  sharded int8: rank 0's ``comm_report.json`` (source "host", window
  [4, 6) of 2 updates at world 2) reconciles every collective kind
  exactly with the books of what ran (the metrics' all-reduce, DDP's
  buckets; the reduce-scatter, the all-gather and, under int8, the
  all-to-alls), and the sharded
  exchange's booked wire bytes equal `quant.wire_report`'s; the
  ``comm_profile`` metrics event, the gauges in the counter snapshots of
  later records, the flight recorder's ``profile_start`` /
  ``profile_stop`` (label "commprof") and ``comm_profile`` events,
  ``obsctl diff`` from both packages, ``obsctl watch`` (clean, and
  tripped by a tampered baseline) and the timeline carry the window;
  rank 1 captures nothing; profiling changes no number (the parameters
  equal an unprofiled run's bit for bit);
- three elastic ranks with ``leave:step=2,rank=2``: the window after the
  regroup reports world 2 and still reconciles, DDP's bucket rebuild on
  the new group (two broadcasts at its second forward) included;
- ``train.profile_steps`` or ``train.profile_dir`` beside
  ``obs.comm_profile_steps`` is refused with the JAX package's message.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import ROOT, WORKER, run_worker_ranks
from tpu_dp.obs import commprof as jcp
from tpu_dp.obs import obsctl as jobsctl
from tpu_dp_torch.config import parse_cli
from tpu_dp_torch.obs import commprof, flightrec, obsctl
from tpu_dp_torch.parallel import quant

pytestmark = pytest.mark.port

torch.set_num_threads(2)

_B = 4
_NET = ["--data.dataset=synthetic", "--data.synthetic_train_size=64",
        "--data.synthetic_test_size=8", f"--data.batch_size={_B}",
        "--train.epochs=1", "--train.log_every=100",
        "--train.eval_at_end=false", "--resilience.handle_signals=false",
        "--train.ckpt_async=false", "--train.steps_per_call=1"]
_WIRES = {"replicated": [],
          "f32": ["--train.update_sharding=sharded"],
          "int8": ["--train.update_sharding=sharded",
                   "--train.collective_dtype=int8",
                   "--train.quant_block_size=64"]}


def _run(tmp, wire, *extra):
    args = _NET + _WIRES[wire] + [f"--train.ckpt_dir={tmp / 'ck'}",
                                  *extra]
    return run_worker_ranks(tmp / "ranks", {"job": "trainer", "args": args},
                            2, timeout=300)


@pytest.fixture(scope="module", params=sorted(_WIRES))
def profiled(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"commprof_{request.param}")
    outs = _run(tmp, request.param, "--train.obs=full",
                "--obs.comm_profile_steps=4:6")
    return request.param, tmp / "ck", outs


def test_the_report_reconciles_with_the_books(profiled):
    wire, ck, outs = profiled
    rep = commprof.read_comm_report(ck / "obs" / "comm_report.json")
    assert jcp.read_comm_report(ck / "obs" / "comm_report.json") == rep
    assert (rep["source"], rep["start_step"], rep["end_step"]) == (
        "host", 4, 6)
    assert (rep["steps"], rep["devices"], rep["world"]) == (2, 1, 2)
    recon = rep["reconciliation"]
    assert recon["ok"] is True, recon
    kinds = {k for k, v in recon["by_kind"].items() if v["expected"]}
    # The metrics' all-reduce in every mode, DDP's buckets replicated.
    want = {"replicated": {"all-reduce"},
            "f32": {"all-reduce", "reduce-scatter", "all-gather"},
            "int8": {"all-reduce", "reduce-scatter", "all-gather",
                     "all-to-all"}}[wire]
    assert kinds == want
    for k in kinds:
        entry = recon["by_kind"][k]
        assert entry["observed"] == entry["expected"] > 0
    assert rep["comm_ms"] > 0 and rep["compute_ms"] > 0
    assert rep["overlap_frac"] is not None
    assert rep["trace_dir"].endswith("w00000004")
    assert outs[0]["host_step"] == outs[1]["host_step"] == 8


def test_the_sharded_wire_reconciles_with_the_wire_report(profiled):
    wire, ck, _ = profiled
    rep = commprof.read_comm_report(ck / "obs" / "comm_report.json")
    if wire == "replicated":
        assert rep["wire"]["grad_exchange_bytes_per_step"] == 0
        assert "reconciliation" not in rep["wire"]
        return
    w = rep["wire"]["reconciliation"]
    assert w["ok"] is True, w
    assert w["dtype"] == wire
    from tpu_dp_torch.compat import param_leaves
    from tpu_dp_torch.models import build_model

    named = dict(build_model("net", num_classes=10).named_parameters())
    leaves = [(k, named[n].numel()) for k, n, _ in param_leaves(named)]
    report = quant.wire_report(leaves, 2, 64 if wire == "int8" else 256)
    assert w["report_bytes_per_step"] == \
        report["wire_bytes_per_step"][wire]
    # The params gather: every rank's shard of every leaf, f32.
    padded = sum(n + (-n) % 2 for _, n in leaves)
    assert rep["wire"]["params_gather_bytes_per_step"] == padded * 4


def test_every_surface_carries_the_window(profiled):
    wire, ck, _ = profiled
    rep = commprof.read_comm_report(ck / "obs" / "comm_report.json")
    recs = [json.loads(line) for line in
            (ck / "metrics.jsonl").read_text().splitlines()]
    events = [r for r in recs if r.get("event") == "comm_profile"]
    assert len(events) == 1
    ev = events[0]
    assert (ev["start_step"], ev["end_step"], ev["reconciled"]) == (4, 6,
                                                                    True)
    assert ev["comm_ms"] == rep["comm_ms"]
    assert ev["by_kind"] == {k: v["per_step"]
                             for k, v in rep["by_kind"].items()}
    later = [r for r in recs if r.get("counters")
             and r.get("step", 0) >= 6]
    assert later and all(
        r["counters"]["obs.comm_ms"] == rep["comm_ms"]
        and r["counters"]["obs.exposed_comm_ms"] == rep["exposed_comm_ms"]
        for r in later)
    dump = flightrec.read_dump(ck / "obs" / "flightrec_r00000.json")
    prof = [e for e in dump["events"]
            if e["kind"] in ("profile_start", "profile_stop")]
    assert [(e["kind"], e["step"], e["label"]) for e in prof] == [
        ("profile_start", 4, "commprof"), ("profile_stop", 5, "commprof")]
    cpe = [e for e in dump["events"] if e["kind"] == "comm_profile"]
    assert len(cpe) == 1 and cpe[0]["reconciled"] is True
    other = flightrec.read_dump(ck / "obs" / "flightrec_r00001.json")
    assert not [e for e in other["events"]
                if e["kind"] in ("profile_start", "comm_profile")]
    assert sorted(p.name for p in (ck / "obs" / "commprof").iterdir()) == [
        "w00000004"]
    # obsctl from either package reads the comm signals.
    mine = obsctl.run_efficiency(obsctl.RunArtifacts(ck))
    theirs = jobsctl.run_efficiency(jobsctl.RunArtifacts(ck))
    assert mine == theirs
    assert mine["exposed_comm_ms"] == rep["exposed_comm_ms"]
    kinds = [e["kind"] for e in
             obsctl.build_timeline(obsctl.RunArtifacts(ck))["events"]]
    assert "profile_start" in kinds and "comm_profile" in kinds


def test_watch_gates_the_comm_signals(profiled, tmp_path):
    _, ck, _ = profiled
    rep = commprof.read_comm_report(ck / "obs" / "comm_report.json")
    base = tmp_path / "base.json"
    assert obsctl.main(["diff", str(ck), "--write-baseline",
                        str(base)]) == 0
    for main in (obsctl.main, jobsctl.main):
        assert main(["watch", str(ck), "--replay", "--baseline", str(base),
                     "--rule", "comm_ms>1.5*baseline"]) == 0
    tampered = tmp_path / "tampered.json"
    payload = json.loads(base.read_text())
    payload["comm_ms"] = rep["comm_ms"] / 100.0
    tampered.write_text(json.dumps(payload))
    for main in (obsctl.main, jobsctl.main):
        assert main(["watch", str(ck), "--replay", "--baseline",
                     str(tampered), "--rule", "comm_ms>1.5*baseline"]) == 1


def test_profiling_changes_no_number(profiled, tmp_path):
    wire, _, outs = profiled
    plain = _run(tmp_path, wire, "--train.obs=full")
    for a, b in zip(outs, plain):
        assert a["losses"] == b["losses"]
        for k in a["final"]:
            assert np.array_equal(a["final"][k], b["final"][k]), k


def test_a_window_after_a_leave_reports_world_2(tmp_path):
    args = ["--data.dataset=synthetic", "--data.synthetic_train_size=48",
            "--data.synthetic_test_size=16", f"--data.batch_size={_B}",
            "--train.epochs=2", "--train.log_every=100",
            "--train.eval_at_end=false", "--train.steps_per_call=1",
            "--train.ckpt_async=false", f"--train.ckpt_dir={tmp_path / 'ck'}",
            "--resilience.elastic=true",
            "--resilience.elastic_verify_fingerprint=false",
            "--resilience.elastic_coordinator_host=127.0.0.1",
            "--resilience.regroup_timeout_s=60",
            "--resilience.fault=leave:step=2,rank=2",
            "--obs.comm_profile_steps=7:9"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("TPU_DP_FAULT", None)
    procs = []
    for rank in range(3):
        spec = {"job": "elastic", "args": args, "rank": rank, "world": 3,
                "init": f"file://{tmp_path / 'rendezvous'}",
                "out": str(tmp_path / f"rank{rank}.pkl")}
        (tmp_path / f"spec{rank}.json").write_text(json.dumps(spec))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(tmp_path / f"spec{rank}.json")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == (143 if rank == 2 else 0), log[-4000:]
    out0 = pickle.loads((tmp_path / "rank0.pkl").read_bytes())
    assert out0["world"] == 2
    rep = commprof.read_comm_report(tmp_path / "ck" / "obs" /
                                    "comm_report.json")
    assert (rep["start_step"], rep["end_step"], rep["world"]) == (7, 9, 2)
    recon = rep["reconciliation"]
    assert recon["ok"] is True, recon
    assert recon["by_kind"]["all-reduce"]["expected"] == 4
    # The rebuilt DDP's second forward (step 8) rebuilds its buckets: two
    # broadcasts, booked where DDP turns its flag.
    assert recon["by_kind"]["broadcast"]["expected"] == 2


@pytest.mark.parametrize("knobs", [
    ["--train.profile_steps=1:2", "--train.profile_dir=p"],
    ["--train.profile_dir=p"]])
def test_a_comm_window_beside_the_step_profiler_is_refused(knobs, tmp_path):
    from tpu_dp import config as jax_config
    from tpu_dp.parallel import dist as jax_dist
    from tpu_dp.train import trainer as jax_trainer_mod

    argv = ["--data.dataset=synthetic", "--data.synthetic_train_size=8",
            "--obs.comm_profile_steps=2:3", *knobs]
    with pytest.raises(ValueError) as mine:
        parse_cli(argv)
    with pytest.raises(ValueError) as theirs:
        jax_trainer_mod.Trainer(
            jax_config.parse_cli(argv + [
                f"--train.ckpt_dir={tmp_path / 'jax'}"]),
            mesh=jax_dist.data_mesh(num_devices=1))
    assert str(mine.value) == str(theirs.value)
