"""The grow half of the port's elastic world size against the JAX
package's (`tpu_dp_torch/resilience/elastic.py`, `faultinject.py`,
`chaos/storage.py`, `obs/health.py`, `config.py`; the grow half of
tests/test_elastic.py, tests/test_chaos.py's slowfs and tests/test_obs.py's
admission grace).

- The join ledger: exclusive seat claims, the fencing verdicts (a live
  seat, a retired generation or epoch, ``max_world``), grow plans only on
  an otherwise clean transition ("shrink wins"), the joiner's handshake
  against member threads (admitted, refused, a dead generation), the
  join-ready gate and the grow verdict; the same plan from both packages.
- Byte compatibility both ways: join requests, refusals, join-ready
  markers, grow verdicts, grow and ``grow_aborted`` records and
  `ServeMembership` records one package writes, the other reads, under the
  same names and keys; `find_live_generation` picks the same generation.
- The coordinator: the ``join`` trigger and the leader's stale refusals,
  the ack barrier without the joiner, ``establish`` echoing the token with
  the store on the lowest incumbent, ``establish_fallback``; the
  rendezvous store the leader holds from its publish on (no probed port
  to lose); `maybe_join`'s modes.
- `elastic_resplit` on growing lineages equals the JAX package's index for
  index, with exact coverage and lockstep.
- ``relaunch:`` departs like ``leave:`` and is spent; ``slowfs`` delays
  ledger reads; ``drop`` stays refused naming the host ring;
  `HealthMonitor.admit` restarts a joiner's grace as the JAX package's
  does; the grow's config fields run with the JAX package's defaults.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

import tpu_dp.config as jax_config
import tpu_dp.resilience.elastic as jel
from tpu_dp.data import sampler as jsampler
from tpu_dp.obs import health as jhealth
from tpu_dp.resilience import faultinject as jfi
from tpu_dp_torch.config import parse_cli
from tpu_dp_torch.data import sampler as tsampler
from tpu_dp_torch.obs import health as thealth
from tpu_dp_torch.resilience import FaultInjector, FaultPlan
from tpu_dp_torch.resilience import elastic as tel
from tpu_dp_torch.resilience.elastic import (
    ElasticCoordinator,
    ElasticError,
    MembershipLedger,
    MembershipRecord,
    QuiescePlan,
)

pytestmark = pytest.mark.port

_ELASTIC = ["--resilience.elastic=true",
            "--resilience.elastic_verify_fingerprint=false"]


@pytest.fixture(autouse=True)
def _no_storage_faults():
    """The storage shim is per process: a test that arms it resets it."""
    from tpu_dp_torch.chaos.storage import shim

    shim.reset()
    yield
    shim.reset()


# -- the join ledger ------------------------------------------------------------


def test_join_claim_is_exclusive_per_transition(tmp_path):
    led = MembershipLedger(tmp_path, 2)
    assert led.publish_join(1, 2, token="aaa", generation=tmp_path.name)
    # A second incarnation racing for the same seat loses the claim and
    # can read whose token holds it.
    assert not led.publish_join(1, 2, token="bbb", generation=tmp_path.name)
    assert led.join_request(1, 2)["token"] == "aaa"


def test_join_refused_when_sid_is_live_member(tmp_path):
    led = MembershipLedger(tmp_path, 0)
    led.write_initial([0, 1], None)
    led.publish_join(1, 1, token="ttt", generation=tmp_path.name)
    assert led.validate_joins(1, [0, 1]) == {}
    assert "live member" in led.join_refusal(1, 1)["reason"]


def test_join_refused_beyond_max_world(tmp_path):
    led = MembershipLedger(tmp_path, 0)
    led.write_initial([0, 1], None)
    led.publish_join(1, 2, token="t2", generation=tmp_path.name)
    led.publish_join(1, 3, token="t3", generation=tmp_path.name)
    accepted = led.validate_joins(1, [0, 1], max_world=3)
    # Deterministic lowest-sid-first admission under the bound.
    assert sorted(accepted) == [2]
    assert "elastic_max_world" in led.join_refusal(1, 3)["reason"]


def test_a_zombie_of_a_retired_generation_or_epoch_is_refused(tmp_path):
    led = MembershipLedger(tmp_path / "gen_live", 0)
    led.write_initial([0, 1], None)
    MembershipLedger(tmp_path / "gen_live", 7).publish_join(
        1, 7, token="zzz", generation="gen_retired")
    assert led.validate_joins(1, [0, 1]) == {}
    assert "stale generation" in led.join_refusal(1, 7)["reason"]
    # The verdict is final for the transition, and never makes a grow.
    assert led.validate_joins(1, [0, 1]) == {}
    led.check_in(1, 5, leaving=False, flavor="graceful")
    led.maybe_publish_plan(1, [0, 1], train_epoch=0, timed_out=True)
    plan = led.try_plan(1)
    assert plan.flavor == "rollback" and plan.joiners == ()
    # A request aimed at a transition the run is past is refused; one at
    # the current epoch, one a later epoch admitted and one its own epoch
    # admitted are spared.
    live = MembershipLedger(tmp_path / "g2", 0)
    live.write_initial([0, 1], None)
    live.publish_epoch(MembershipRecord(
        epoch=2, members=(0, 1, 9), coordinator=None,
        joined=({"sid": 9, "token": "ok"},), ts=time.time()))
    for sid, epoch in ((9, 2), (7, 1), (8, 3), (5, 1)):
        MembershipLedger(tmp_path / "g2", sid).publish_join(
            epoch, sid, token="t", generation="g2")
    live.publish_epoch(MembershipRecord(
        epoch=3, members=(0, 1, 9), coordinator=None, ts=time.time()))
    live.refuse_stale_joins(current_epoch=3, members=[0, 1, 5, 9])
    assert "stale epoch" in live.join_refusal(1, 7)["reason"]
    assert live.join_refusal(3, 8) is None
    assert live.join_refusal(2, 9) is None
    assert live.join_refusal(1, 5) is None


def _grow_files(mod, gen: Path) -> None:
    """A member set {0, 1} with a valid join request of sid 2 and both
    members checked in, through package ``mod``."""
    mod.MembershipLedger(gen, 0).write_initial([0, 1], None)
    mod.MembershipLedger(gen, 2).publish_join(1, 2, token="tok",
                                              generation=gen.name)
    for sid in (0, 1):
        mod.MembershipLedger(gen, sid).check_in(
            1, 6 + sid, leaving=False, flavor="graceful")


def test_grow_plan_from_valid_join_equals_the_jax_packages(tmp_path):
    plans = {}
    for name, mod in (("jax", jel), ("port", tel)):
        gen = tmp_path / name / "gen_g"
        _grow_files(mod, gen)
        led = mod.MembershipLedger(gen, 0)
        led.maybe_publish_plan(1, [0, 1], train_epoch=0, timed_out=False)
        plans[name] = json.loads((gen / "plan_e0001.json").read_text())
    plan = QuiescePlan.from_json(plans["port"])
    assert plan.flavor == "grow" and plan.joiners == (2,)
    assert plan.survivors == (0, 1, 2) and plan.incumbents == (0, 1)
    assert plan.leavers == () and plan.departed == ()
    # The stop threshold clears every member's published position (the
    # joiner is not stepping and publishes none).
    assert plan.stop_step > 7
    assert plans["port"] == plans["jax"]


def test_shrink_wins_over_concurrent_join(tmp_path):
    led = MembershipLedger(tmp_path, 0)
    led.write_initial([0, 1, 2], None)
    MembershipLedger(tmp_path, 5).publish_join(1, 5, token="tok",
                                               generation=tmp_path.name)
    for sid, leaving in ((0, False), (1, False), (2, True)):
        MembershipLedger(tmp_path, sid).check_in(
            1, 4, leaving=leaving, flavor="graceful")
    led.maybe_publish_plan(1, [0, 1, 2], train_epoch=0, timed_out=False)
    plan = led.try_plan(1)
    assert plan.flavor == "graceful" and plan.leavers == (2,)
    assert plan.joiners == () and 5 not in plan.survivors
    # No refusal either: the claim rides to the next transition.
    assert led.join_refusal(1, 5) is None


def _member_admits(led: MembershipLedger, joiner: int,
                   deadline_s: float = 20.0) -> None:
    """A world-1 member converging a grow the way the trainer does: poll,
    check in, publish, establish (echoing the joiner's token)."""
    deadline = time.monotonic() + deadline_s
    step = 3
    while time.monotonic() < deadline and not led.validate_joins(1, [0]):
        time.sleep(0.01)
    plan = None
    while time.monotonic() < deadline and plan is None:
        led.check_in(1, step, leaving=False, flavor="graceful")
        led.maybe_publish_plan(1, [0], train_epoch=0, timed_out=False)
        plan = led.try_plan(1)
        step += 1
        time.sleep(0.01)
    req = led.join_request(1, joiner)
    led.publish_epoch(MembershipRecord(
        epoch=1, members=tuple(sorted(plan.survivors)),
        coordinator="127.0.0.1:1",
        joined=({"sid": joiner, "token": req["token"]},), service_sid=0,
        resume={"epoch": 0, "steps_done": plan.stop_step, "lineage": [],
                "global_step": plan.stop_step, "snapshot_dir": None},
        reason="grow", ts=time.time()))


def test_request_join_admission_handshake_threads(tmp_path):
    gen = tmp_path / "gen_x"
    led = MembershipLedger(gen, 0)
    led.write_initial([0], None)
    t = threading.Thread(target=_member_admits, args=(led, 2), daemon=True)
    t.start()
    record, token = tel.request_join(gen, 2, timeout_s=15)
    t.join(timeout=20)
    assert record.epoch == 1 and record.members == (0, 2)
    assert record.joined == ({"sid": 2, "token": token},)
    assert record.service_sid == 0 and record.rank_of(2) == 1


def test_join_ready_gate_and_grow_verdict(tmp_path):
    led = MembershipLedger(tmp_path, 0)
    assert led.await_join_ready(2, [5], timeout_s=0.2) == [5]  # a ghost
    MembershipLedger(tmp_path, 5).confirm_join_ready(2, 5)
    assert led.await_join_ready(2, [5], timeout_s=2) == []
    assert led.await_grow_verdict(2, timeout_s=0.1) is None
    led.publish_grow_verdict(2, commit=False, reason="no join_ready")
    # One decider: a second verdict never replaces the first.
    MembershipLedger(tmp_path, 1).publish_grow_verdict(2, commit=True)
    verdict = MembershipLedger(tmp_path, 1).await_grow_verdict(2, 1.0)
    assert (verdict["commit"], verdict["by"]) == (False, 0)


def test_request_join_refusal_is_typed(tmp_path):
    gen = tmp_path / "gen_y"
    led = MembershipLedger(gen, 0)
    led.write_initial([0], None)

    def refuser():
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if led.join_request(1, 3) is not None:
                led.refuse_join(1, 3,
                                "world at resilience.elastic_max_world=1")
                return
            time.sleep(0.01)

    t = threading.Thread(target=refuser, daemon=True)
    t.start()
    with pytest.raises(ElasticError, match="join refused.*max_world"):
        tel.request_join(gen, 3, timeout_s=10)
    t.join(timeout=15)


def test_request_join_times_out_on_dead_generation(tmp_path):
    gen = tmp_path / "gen_dead"
    MembershipLedger(gen, 0).write_initial([0, 1], None)
    with pytest.raises(ElasticError, match="no admission"):
        tel.request_join(gen, 2, timeout_s=0.5, attempts=1)
    # A live seat is never claimed: the zombie fence waits for a record.
    with pytest.raises(ElasticError, match="zombie fencing"):
        tel.request_join(gen, 1, timeout_s=0.5, attempts=1)


# -- byte compatibility both ways ---------------------------------------------


_RESUME = {"epoch": 0, "steps_done": 6, "lineage": [[3, 4], [2, 2]],
           "global_step": 8, "snapshot_dir": "snap/step_0000000008"}


def _write_grow_ledger(mod, root: Path) -> None:
    """Every file of the grow half, written through package ``mod``."""
    gen = root / "gen_a"
    lead = mod.MembershipLedger(gen, 0)
    lead.publish_epoch(mod.MembershipRecord(
        epoch=0, members=(0, 1), coordinator="127.0.0.1:9", ts=10.0))
    mod.MembershipLedger(gen, 2).publish_join(1, 2, token="tok",
                                              generation="gen_a", host="h")
    mod.MembershipLedger(gen, 3).publish_join(1, 3, token="t3",
                                              generation="gen_old")
    lead.validate_joins(1, [0, 1])  # refuses sid 3 (stale generation)
    mod.MembershipLedger(gen, 2).confirm_join_ready(1, 2)
    lead.publish_grow_verdict(1, commit=False, reason="no join_ready")
    lead.publish_epoch(mod.MembershipRecord(
        epoch=1, members=(0, 1, 2), coordinator="127.0.0.1:10",
        joined=({"sid": 2, "token": "tok"},), service_sid=0,
        resume=_RESUME, reason="grow", ts=11.0))
    lead.publish_epoch(mod.MembershipRecord(
        epoch=2, members=(0, 1), coordinator="127.0.0.1:11",
        departed=({"sid": 2,
                   "reason": "join handshake timeout (grow aborted)"},),
        service_sid=0, resume=_RESUME, reason="grow_aborted", ts=12.0))
    old = mod.MembershipLedger(root / "gen_old", 0)
    old.publish_epoch(mod.MembershipRecord(
        epoch=0, members=(0, 1, 2), coordinator=None, ts=5.0))
    serve = mod.ServeMembership(root / "serve_root", sid=0)
    serve.initial([0, 1])
    serve.depart(1, "preempted (graceful)")
    serve.rejoin(1)


def _files(root: Path) -> dict[str, dict]:
    """Every ledger file's JSON (``ts`` dropped), by relative path."""
    out = {}
    for p in sorted(root.rglob("*.json")):
        d = json.loads(p.read_text()) if p.stat().st_size else {}
        d.pop("ts", None)
        out[str(p.relative_to(root))] = d
    return out


def test_the_grow_files_are_the_jax_packages_name_for_name(tmp_path):
    _write_grow_ledger(jel, tmp_path / "jax")
    _write_grow_ledger(tel, tmp_path / "port")
    theirs, mine = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert "gen_a/join_ready_e0001_r00002.json" in mine
    assert "gen_a/join_refused_e0001_r00003.json" in mine
    assert "gen_a/grow_verdict_e0001.json" in mine
    assert mine == theirs


@pytest.mark.parametrize("writer,reader", [(jel, tel), (tel, jel)],
                         ids=["jax_writes", "port_writes"])
def test_a_grow_ledger_one_package_writes_the_other_reads(tmp_path, writer,
                                                          reader):
    _write_grow_ledger(writer, tmp_path)
    gen = tmp_path / "gen_a"
    led = reader.MembershipLedger(gen, 0)
    assert led.join_request(1, 2)["token"] == "tok"
    assert "stale generation" in led.join_refusal(1, 3)["reason"]
    assert led.await_join_ready(1, [2, 3], timeout_s=0.2) == [3]
    assert led.await_grow_verdict(1, timeout_s=0.5)["commit"] is False
    grow = reader.MembershipRecord.from_json(
        json.loads((gen / "epoch_0001.json").read_text()))
    assert (grow.reason, grow.joined, grow.service_sid, grow.world) == (
        "grow", ({"sid": 2, "token": "tok"},), 0, 3)
    cur = led.current()
    assert (cur.epoch, cur.members, cur.reason, cur.resume) == (
        2, (0, 1), "grow_aborted", _RESUME)
    assert cur.departed[0]["reason"] == "join handshake timeout " \
                                        "(grow aborted)"
    serve = reader.ServeMembership(tmp_path / "serve_root").current()
    assert (serve.epoch, serve.members, serve.reason) == (
        2, (0, 1), "serve_rejoin")
    found = reader.find_live_generation(tmp_path)
    other = (jel if reader is tel else tel).find_live_generation(tmp_path)
    assert found[0] == other[0] and found[0].name == "gen_a"
    assert found[1].to_json() == other[1].to_json()


def test_find_live_generation_picks_newest_by_record_ts(tmp_path):
    assert tel.find_live_generation(tmp_path / "nope") is None
    for name, ts in (("gen_old", 100.0), ("gen_new", 200.0)):
        MembershipLedger(tmp_path / name, 0).publish_epoch(MembershipRecord(
            epoch=0, members=(0, 1, 2), coordinator=None, ts=ts))
    MembershipLedger(tmp_path / "gen_new", 0).publish_epoch(MembershipRecord(
        epoch=1, members=(0, 1), coordinator=None, ts=300.0,
        departed=({"sid": 2, "reason": "preempted (graceful)"},)))
    gen_dir, rec = tel.find_live_generation(tmp_path)
    assert gen_dir.name == "gen_new" and rec.epoch == 1
    assert jel.find_live_generation(tmp_path)[0] == gen_dir


# -- the coordinator --------------------------------------------------------------


def _coordinators(tmp_path, members=(0, 1), epoch=0, **kw):
    """One coordinator per member sid, attached to a generation whose
    newest record is ``epoch`` with ``members``."""
    gen = tmp_path / "gen_c"
    rec = MembershipLedger(gen, min(members)).publish_epoch(MembershipRecord(
        epoch=epoch, members=tuple(members), coordinator="127.0.0.1:1",
        ts=time.time()))
    return {sid: ElasticCoordinator.attach(
        tmp_path, gen.name, sid, rec, regroup_timeout_s=5,
        coordinator_host="127.0.0.1", **kw) for sid in members}, gen


def test_poll_triggers_join_and_the_leader_refuses_stale_claims(tmp_path):
    co, gen = _coordinators(tmp_path, epoch=1, max_world=3)
    assert co[0].poll(1) is None
    MembershipLedger(gen, 2).publish_join(2, 2, token="t",
                                          generation=gen.name)
    assert co[1].poll(2) == "join" and co[0].poll(2) == "join"
    # A claim past max_world is refused before it starts a quiesce.
    MembershipLedger(gen, 3).publish_join(2, 3, token="u",
                                          generation=gen.name)
    assert co[0].poll(3) == "join"
    assert "elastic_max_world=3" in co[0].ledger.join_refusal(2, 3)["reason"]
    # A request for a transition already past: only the leader refuses it.
    MembershipLedger(gen, 4).publish_join(0, 4, token="v",
                                          generation=gen.name)
    (gen / "join_e0002_r00002.json").unlink()
    assert co[1].poll(4) is None
    assert co[1].ledger.join_refusal(0, 4) is None
    assert co[0].poll(4) is None
    assert "stale epoch" in co[0].ledger.join_refusal(0, 4)["reason"]


def test_establish_echoes_the_token_and_pins_the_store_to_the_incumbent(
        tmp_path):
    """sid 0 rejoins: it sorts first (dense rank 0), but the record pins
    the rendezvous store to the lowest incumbent, sid 1; the ack barrier
    leaves the joiner out; the leader holds the store's port from the
    publish on."""
    co, gen = _coordinators(tmp_path, members=(1, 2))
    MembershipLedger(gen, 0).publish_join(1, 0, token="tok0",
                                          generation=gen.name)
    for sid in (1, 2):
        co[sid].ledger.check_in(1, 5, leaving=False, flavor="graceful")
    co[1].ledger.maybe_publish_plan(1, [1, 2], train_epoch=0,
                                    timed_out=False)
    plan = co[1].ledger.try_plan(1)
    assert plan.flavor == "grow" and plan.survivors == (0, 1, 2)
    co[2].ledger.ack_quiesced(plan.epoch)
    t0 = time.monotonic()
    co[1].ack_and_await_quiesced(plan)  # no joiner ack awaited
    assert time.monotonic() - t0 < 4
    rec = co[1].establish(plan, {"epoch": 0, "steps_done": 9})
    assert co[2].establish(plan, {}).to_json() == rec.to_json()
    assert rec.joined == ({"sid": 0, "token": "tok0"},)
    assert rec.service_sid == 1 and rec.rank_of(0) == 0
    assert rec.reason == "grow" and rec.resume == {"epoch": 0,
                                                   "steps_done": 9}
    host, _, port = rec.coordinator.rpartition(":")
    with socket.socket() as s, pytest.raises(OSError):
        s.bind((host, int(port)))  # held by the leader's store
    import datetime

    import torch.distributed as dist

    client = dist.TCPStore(host, int(port), None, False,
                           timeout=datetime.timedelta(seconds=5))
    client.set("k", "v")
    assert co[1]._service_store.get("k") == b"v"
    # The fallback: the incumbents at world 2, the joiner departed with
    # the handshake's reason, the same resume.
    back = co[1].establish_fallback(
        rec, reason="join handshake timeout (grow aborted)")
    assert co[2].establish_fallback(rec, reason="x").to_json() \
        == back.to_json()
    assert (back.epoch, back.members, back.reason, back.resume) == (
        2, (1, 2), "grow_aborted", rec.resume)
    assert back.departed == ({"sid": 0, "reason": "join handshake "
                                                  "timeout (grow aborted)"},)
    assert back.service_sid == 1 and back.coordinator != rec.coordinator
    with pytest.raises(ElasticError, match="not an incumbent"):
        ElasticCoordinator.attach(tmp_path, gen.name, 0, rec) \
            .establish_fallback(rec, reason="x")


def test_a_grow_of_one_member_needs_no_store(tmp_path):
    co, gen = _coordinators(tmp_path, members=(0,))
    plan = QuiescePlan(epoch=1, flavor="graceful", stop_step=3,
                       train_epoch=0, leavers=(), departed=(),
                       survivors=(0,))
    rec = co[0].establish(plan, {})
    assert rec.coordinator is None and co[0]._service_store is None


def _cfg(tmp_path, *extra):
    return parse_cli(_ELASTIC + [f"--train.ckpt_dir={tmp_path}", *extra])


def test_maybe_join_modes(tmp_path, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("TPU_DP_PROCESS_ID", raising=False)
    cfg = _cfg(tmp_path, "--resilience.elastic_join=never",
               "--parallel.process_id=2")
    assert tel.maybe_join(cfg) is None
    # auto: no stable id, or no ledger, is the classic bootstrap.
    assert tel.maybe_join(_cfg(tmp_path)) is None
    assert tel.maybe_join(_cfg(tmp_path, "--parallel.process_id=2")) is None
    with pytest.raises(ElasticError, match="explicit stable id"):
        tel.maybe_join(_cfg(tmp_path, "--resilience.elastic_join=always"))
    with pytest.raises(ElasticError, match="no membership generation"):
        tel.maybe_join(_cfg(tmp_path, "--resilience.elastic_join=always",
                            "--parallel.process_id=2"))
    with pytest.raises(ValueError, match="auto\\|always\\|never"):
        tel.maybe_join(_cfg(tmp_path, "--resilience.elastic_join=maybe",
                            "--parallel.process_id=2"))
    # auto with the sid still a member of the newest record (a whole-job
    # restart, or a plain resume): the classic bootstrap, at once.
    MembershipLedger(tmp_path / "membership" / "gen_r", 0).write_initial(
        [0, 1, 2], None)
    t0 = time.monotonic()
    assert tel.maybe_join(_cfg(tmp_path, "--parallel.process_id=2")) is None
    monkeypatch.setenv("RANK", "1")
    assert tel.maybe_join(_cfg(tmp_path)) is None
    assert time.monotonic() - t0 < 2
    # auto with the sid departed and nobody serving: a short probe, then
    # the classic bootstrap; always raises.
    cfg = _cfg(tmp_path, "--parallel.process_id=5",
               "--resilience.elastic_join_timeout_s=0.3")
    assert tel.maybe_join(cfg) is None
    cfg.resilience.elastic_join = "always"
    with pytest.raises(ElasticError, match="no admission"):
        tel.maybe_join(cfg)


def test_maybe_join_refuses_a_grow_the_incumbents_already_aborted(
        tmp_path, monkeypatch):
    """The admission stands in the ledger, but the incumbents re-formed
    without this joiner (it was too slow for their gate): it raises rather
    than wait at a rendezvous nobody serves, and signals no join_ready."""
    gen = tmp_path / "membership" / "gen_z"
    led = MembershipLedger(gen, 0)
    led.write_initial([0], None)
    grow = led.publish_epoch(MembershipRecord(
        epoch=1, members=(0, 2), coordinator="127.0.0.1:1",
        joined=({"sid": 2, "token": "tok"},), service_sid=0,
        reason="grow", ts=time.time()))
    led.publish_epoch(MembershipRecord(
        epoch=2, members=(0,), coordinator=None,
        departed=({"sid": 2, "reason": "join handshake timeout "
                                       "(grow aborted)"},),
        reason="grow_aborted", ts=time.time()))
    monkeypatch.setattr(tel, "request_join",
                        lambda gen_dir, sid, **kw: (grow, "tok"))
    with pytest.raises(ElasticError, match="aborted by the incumbents"):
        tel.maybe_join(_cfg(tmp_path, "--resilience.elastic_join=always",
                            "--parallel.process_id=2"), device="cpu")
    assert not (gen / "join_ready_e0001_r00002.json").exists()


# -- the re-split on growing lineages ---------------------------------------------


def _consumed(e, world, steps, per_step, seed=7, epoch=0):
    out = []
    for r in range(world):
        s = jsampler.ShardedSampler(e, world, r, shuffle=True, seed=seed)
        s.set_epoch(epoch)
        out.append(s.shard_indices()[:steps * per_step])
    return np.concatenate(out)


def test_resplit_grow_exact_coverage_shrink_then_grow():
    """3 ranks run 2 steps, the world shrinks to 2 for 1 step, then grows
    back to 3: everything consumed plus the grown tails is the epoch,
    nothing twice, every member of the grown world the same step count;
    the port's tails equal the JAX package's index for index."""
    e, b = 96, 4
    consumed3 = _consumed(e, 3, 2, b)
    seg2 = [tsampler.elastic_resplit(e, True, 7, 0, b, [(3, 2)], 2, m)[:b]
            for m in range(2)]
    tails = [tsampler.elastic_resplit(e, True, 7, 0, b, [(3, 2), (2, 1)],
                                      3, m) for m in range(3)]
    for m in range(3):
        np.testing.assert_array_equal(tails[m], jsampler.elastic_resplit(
            e, True, 7, 0, b, [(3, 2), (2, 1)], 3, m))
    joined = sorted(np.concatenate([consumed3, *seg2, *tails]).tolist())
    assert len(joined) == len(set(joined)), "a sample consumed twice"
    assert e - len(joined) < 3 * b
    assert len({len(t) for t in tails}) == 1
    assert len(tails[0]) % b == 0 and len(tails[0]) > 0


@pytest.mark.parametrize("e,lineage,new_world,b", [
    (50, [(2, 2)], 3, 4),             # plain grow 2 -> 3
    (47, [(3, 1), (2, 2)], 3, 4),     # shrink 3 -> 2, then grow 2 -> 3
    (49, [(1, 3)], 4, 2),             # world 1 grows to 4
    (53, [(2, 1), (3, 2)], 5, 2),     # grow -> grow
], ids=["grow", "shrink_grow", "one_to_four", "grow_grow"])
def test_resplit_grow_lockstep_on_awkward_remainders(e, lineage, new_world,
                                                     b):
    from tpu_dp.data.sampler import _pad_to_multiple

    tails = [tsampler.elastic_resplit(e, True, 11, 2, b, lineage, new_world,
                                      m) for m in range(new_world)]
    for m, tail in enumerate(tails):
        np.testing.assert_array_equal(tail, jsampler.elastic_resplit(
            e, True, 11, 2, b, lineage, new_world, m))
    assert len({len(t) for t in tails}) == 1
    assert len(tails[0]) % b == 0
    # Nothing is invented: per-sample consumption (the lineage and the
    # grown tails) never exceeds the padded streams' plan.
    base = jsampler.ShardedSampler(e, 1, 0, shuffle=True, seed=11)
    base.set_epoch(2)
    stream_counts: Counter = Counter()
    remaining = base.shard_indices()
    consumed_all: list = []
    for world, steps in lineage:
        stream = _pad_to_multiple(remaining, world)
        stream_counts.update(stream.tolist())
        shards = [stream[r::world] for r in range(world)]
        consumed_all += [s[:steps * b] for s in shards]
        remaining = np.concatenate([s[steps * b:] for s in shards])
    stream_counts.update(_pad_to_multiple(remaining, new_world).tolist())
    got = Counter(np.concatenate(consumed_all + tails).tolist())
    for sample, n in got.items():
        assert n <= stream_counts[sample], (e, lineage, sample)


# -- faults, health, config --------------------------------------------------------


def test_faultinject_relaunch_departs_like_leave():
    for mod_plan, mod_inj in ((FaultPlan, FaultInjector),
                              (jfi.FaultPlan, jfi.FaultInjector)):
        plan = mod_plan.parse("relaunch:step=3,rank=1")
        assert (plan.kind, plan.step, plan.rank) == ("relaunch", 3, 1)
        bystander = mod_inj(plan, rank=0)
        bystander.on_step(9)
        assert not bystander.leave_requested
        target = mod_inj(plan, rank=1)
        target.on_step(2)
        assert not target.leave_requested
        target.on_step(3)
        assert target.leave_requested and target.fired
        assert target.fired_kind("relaunch")
    # spend: a rejoined incarnation's copy of the plan never fires.
    inj = FaultInjector(FaultPlan.parse("relaunch:step=3"), rank=0)
    inj.spend("relaunch")
    inj.on_step(5)
    assert inj.fired and not inj.leave_requested


def test_slowfs_delays_ledger_reads(tmp_path):
    led = MembershipLedger(tmp_path, 0)
    led.check_in(1, 7, leaving=False, flavor="graceful")
    FaultInjector(FaultPlan.parse("slowfs:step=2,ms=30,n=2"),
                  rank=0).on_step(2)
    t0 = time.perf_counter()
    assert led.check_ins(1)[0]["step"] == 7  # reads still work
    assert time.perf_counter() - t0 >= 0.025  # ... only slower
    led.check_ins(1)  # the second slowed read spends the n=2 budget
    t0 = time.perf_counter()
    led.check_ins(1)
    assert time.perf_counter() - t0 < 0.025  # spent: fast again


@pytest.mark.parametrize("spec", ["relaunch:step=4,rank=1",
                                  "slowfs:step=3,ms=5",
                                  "kill:step=9;relaunch:step=4"])
def test_the_grow_halfs_faults_are_taken(spec):
    cfg = parse_cli(_ELASTIC + [f"--resilience.fault={spec}"])
    assert cfg.resilience.fault == spec
    with pytest.raises(ValueError, match="host ring"):
        parse_cli(_ELASTIC + ["--resilience.fault=drop:step=2"])


def _beats(run_dir: Path, rank: int, step: int, ts: float) -> None:
    run_dir.mkdir(parents=True, exist_ok=True)
    with open(run_dir / f"heartbeat_r{rank:05d}.jsonl", "a") as f:
        f.write(json.dumps({"rank": rank, "step": step, "step_ms": 10.0,
                            "ts": ts}) + "\n")


@pytest.mark.parametrize("mod", [thealth, jhealth], ids=["port", "jax"])
def test_health_monitor_joiner_admission_grace(tmp_path, mod):
    now = time.time()
    _beats(tmp_path, 0, 8, now)
    _beats(tmp_path, 1, 8, now)
    mon = mod.HealthMonitor(tmp_path, world=3, stale_after_s=60.0)
    mon._start = now - 300.0  # the startup grace long elapsed
    assert {(i.kind, i.rank) for i in mon.check(now=now)} == {("missing",
                                                               2)}
    # An admission restarts the joiner's own grace ...
    mon.admit(2, ts=now - 5.0)
    assert mon.check(now=now) == []
    # ... which is finite, measured from the admission.
    missing = [i for i in mon.check(now=now + 100.0) if i.kind == "missing"]
    assert [(i.kind, i.rank) for i in missing] == [("missing", 2)]
    assert missing[0].age_s == pytest.approx(105.0, abs=1.0)
    _beats(tmp_path, 2, 9, now + 100.0)
    assert not [i for i in mon.check(now=now + 100.0)
                if i.kind == "missing"]


def test_the_grow_knobs_run_with_the_jax_packages_defaults(tmp_path):
    default = parse_cli([]).resilience
    theirs = jax_config.Config().resilience
    for k in ("elastic_join", "elastic_join_timeout_s", "elastic_max_world"):
        assert getattr(default, k) == getattr(theirs, k)
    cfg = parse_cli(_ELASTIC + ["--resilience.elastic_join=always",
                                "--resilience.elastic_join_timeout_s=5",
                                "--resilience.elastic_max_world=4"])
    res = cfg.resilience
    assert (res.elastic_join, res.elastic_join_timeout_s,
            res.elastic_max_world) == ("always", 5.0, 4)
    dumped = cfg.to_dict()["resilience"]
    jcfg = jax_config.Config.from_dict({"resilience": dumped})
    assert {k: getattr(jcfg.resilience, k) for k in dumped} == dumped
    # The coordinator takes its bound from the config.
    co = ElasticCoordinator(tmp_path, "g", 0, world=1,
                            coordinator_address=None, max_world=4)
    assert co.max_world == 4
