"""The port's fleet aggregation (`tpu_dp_torch.obs.fleet`, ``obsctl
fleet``) against the JAX package's (`tpu_dp.obs.fleet`) over one elastic
run the port wrote: three gloo ranks of the reference ``Net`` at
``--train.obs=basic`` with ``relaunch:step=2,rank=2`` (3 -> 2 -> 3: rank
2 departs, rejoins through `run_elastic` and the world grows back; its
heartbeats re-homed under ``obs/me<E>/``) and a comm window after the
grow:

- `discover_streams` and `FleetAggregator.replay` give the same streams
  and the same records in both packages (timestamps included: they come
  from the files), and ``obsctl fleet --replay`` the same stream, summary
  and exit codes (clean 0; a rule that must trip 1);
- the ``fleet_step`` records cover every global step once across the two
  regroups, each stamped with the membership epoch the ledger's records
  give for it, at that epoch's world;
- the timeline shows the departure and the rejoin; the comm window after
  the grow reports world 3 and reconciles.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from test_torch_elastic_ranks import _args, _finish, _start
from tpu_dp.obs import fleet as jfleet
from tpu_dp.obs import obsctl as jobsctl
from tpu_dp_torch.obs import commprof, fleet, obsctl

pytestmark = pytest.mark.port

torch.set_num_threads(2)

_N = 96


@pytest.fixture(scope="module")
def grown(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    procs = _start(tmp, _args(tmp / "ck", _N,
                              "--resilience.fault=relaunch:step=2,rank=2",
                              "--resilience.snapshot_every_steps=2",
                              "--resilience.snapshot_keep=0",
                              "--train.obs=basic",
                              "--obs.comm_profile_steps=12:14"))
    results = _finish(tmp, procs, victim=-1)
    gen = next((tmp / "ck" / "membership").iterdir())
    records = [json.loads(p.read_text())
               for p in sorted(gen.glob("epoch_*.json"))]
    assert [r["world"] for r in records] == [3, 2, 3]
    return tmp / "ck", results, records


def _rel(obj, root: Path):
    """``obj`` with ``root`` cut out of every string (the path of a stream
    differs only by the package that found it: it does not)."""
    return json.loads(json.dumps(obj).replace(str(root), "<run>"))


def test_streams_and_records_equal_the_jax_packages(grown):
    ck, _, _ = grown
    assert fleet.discover_streams(ck) == jfleet.discover_streams(ck)
    mine = fleet.FleetAggregator(ck).replay()
    assert mine == jfleet.FleetAggregator(ck).replay()
    assert fleet.summarize(mine) == jfleet.summarize(mine)
    assert [fleet.fleet_signals(r) for r in mine] == [
        jfleet.fleet_signals(r) for r in mine]


def test_every_step_once_at_its_membership_epoch(grown):
    ck, results, records = grown
    steps = [r for r in fleet.FleetAggregator(ck).replay()
             if r["kind"] == "fleet_step"]
    assert [r["step"] for r in steps] == list(
        range(1, results[0]["host_step"] + 1))
    # The epoch a step ran in: the newest record whose resume step is
    # below it (a record's resume is where its world starts).
    starts = [(int(r["epoch"]), int((r.get("resume") or {}).get(
        "global_step", 0)), int(r["world"])) for r in records]
    for rec in steps:
        me, _, world = max(s for s in starts if s[1] < rec["step"])
        assert (rec["me"], rec["world"], len(rec["ranks"])) == (
            me, world, world), rec
    assert {r["me"] for r in steps} == {0, 1, 2}


def test_obsctl_fleet_equals_the_jax_packages(grown, tmp_path, capsys):
    ck, _, _ = grown
    outs = []
    for main, name in ((obsctl.main, "port"), (jobsctl.main, "jax")):
        rc = main(["fleet", str(ck), "--replay", "--json", "-o",
                   str(tmp_path / f"{name}.jsonl"), "--report",
                   str(tmp_path / f"{name}_report.json"), "--rule",
                   "fleet.skew_ratio>1000"])
        outs.append((rc, capsys.readouterr().out))
    assert outs[0][0] == outs[1][0] == 0
    assert _rel(outs[0][1], tmp_path / "port.jsonl") == _rel(
        outs[1][1], tmp_path / "jax.jsonl")
    assert fleet.read_fleet_records(tmp_path / "port.jsonl") == \
        jfleet.read_fleet_records(tmp_path / "jax.jsonl")
    assert json.loads((tmp_path / "port_report.json").read_text()) == \
        json.loads((tmp_path / "jax_report.json").read_text())
    for main in (obsctl.main, jobsctl.main):
        assert main(["fleet", str(ck), "--replay", "-o",
                     str(tmp_path / "trip.jsonl"), "--rule",
                     "fleet.skew_ratio>0"]) == 1
    capsys.readouterr()


def test_timeline_shows_the_departure_and_the_rejoin(grown):
    ck, _, _ = grown
    mine = obsctl.build_timeline(obsctl.RunArtifacts(ck))
    assert mine == jobsctl.build_timeline(jobsctl.RunArtifacts(ck))
    kinds = [e["kind"] for e in mine["events"]]
    for k in ("elastic_departure", "elastic_join_request", "elastic_join",
              "elastic_grow"):
        assert k in kinds, (k, kinds)
    assert kinds.index("elastic_departure") < kinds.index("elastic_join")


def test_the_comm_window_after_the_grow_reports_world_3(grown):
    ck, _, _ = grown
    rep = commprof.read_comm_report(ck / "obs" / "comm_report.json")
    assert (rep["start_step"], rep["end_step"], rep["world"]) == (12, 14, 3)
    assert rep["reconciliation"]["ok"] is True
