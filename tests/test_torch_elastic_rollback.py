"""The rollback flavour of the port's elastic shrink, in one process, against
the JAX package (`tpu_dp_torch/resilience/elastic.py`, `tpu_dp_torch/
parallel/dist.py`, `Trainer._rollback_resume`, `_lineage_position` and
`_suspect_from_health`; the rollback half of tests/test_elastic.py).

- The ledger: a member that never checks in is declared departed when the
  collection window passes, a suspect's reason lands in the plan, and of
  racing rollback publishers exactly one wins (tests/test_elastic.py's
  three twins, by threads); suspect files, rollback plans and rollback
  records one package writes the other reads, byte for byte.
- The coordinator: the "suspect" trigger, ``mark_suspect`` (its flight
  recorder event), ``rewind_poll``, the collection window's timeout arms
  (the plan at the window, `ElasticError` at twice it), an accused leaver's
  reason in the record.
- The rollback resume: the newest complete save, past a torn step
  directory and an unreadable meta, equal to the JAX package's payload;
  its re-split tail equal to `tpu_dp.data.sampler.elastic_resplit` index
  for index.
- `_suspect_from_health`: a stale heartbeat makes its rank a suspect, a
  straggler does not, as in the JAX package.
- `is_peer_failure`: gloo's transport errors and the typed peer failures,
  never another `RuntimeError`; the guard with elastic is accepted.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tpu_dp.resilience.elastic as jel
from tpu_dp.data.sampler import elastic_resplit as jax_resplit
from tpu_dp.obs.health import HealthMonitor as JaxHealthMonitor
from tpu_dp.train.trainer import Trainer as JaxTrainer
from tpu_dp_torch.config import parse_cli
from tpu_dp_torch.obs import flightrec
from tpu_dp_torch.obs.health import HealthMonitor
from tpu_dp_torch.parallel.dist import is_peer_failure
from tpu_dp_torch.resilience import PeerFailedError
from tpu_dp_torch.resilience import elastic as tel
from tpu_dp_torch.resilience.elastic import (
    ElasticCoordinator,
    ElasticError,
    MembershipLedger,
    MembershipRecord,
)
from tpu_dp_torch.train.trainer import Trainer

pytestmark = pytest.mark.port

torch.set_num_threads(2)

_ELASTIC = ["--resilience.elastic=true",
            "--resilience.elastic_verify_fingerprint=false"]


# ---------------------------------------------------------------------------
# the ledger, by threads (tests/test_elastic.py's rollback twins)
# ---------------------------------------------------------------------------


def _converge(ledger, members, step0, flavor="rollback", deadline_s=20.0,
              window_s=1.0):
    start = time.monotonic()
    step = step0
    while time.monotonic() - start < deadline_s:
        ledger.check_in(1, step, False, flavor, window=1)
        plan = ledger.try_plan(1)
        if plan is None:
            ledger.maybe_publish_plan(
                1, members, train_epoch=0,
                timed_out=time.monotonic() - start > window_s)
            plan = ledger.try_plan(1)
        if plan is not None:
            return plan
        step += 1
        time.sleep(0.01)
    raise AssertionError("no plan within deadline")


def test_ledger_timeout_declares_departed(tmp_path):
    """Member 2 never checks in (a hard death): the collection times out
    and the plan declares it departed, with rollback flavour; the JAX
    package publishes the same plan from the same check-ins."""
    members, plans = [0, 1, 2], {}

    def member(sid):
        plans[sid] = _converge(MembershipLedger(tmp_path, sid), members, 3,
                               flavor="graceful")

    threads = [threading.Thread(target=member, args=(s,)) for s in (0, 1)]
    [t.start() for t in threads]
    [t.join(timeout=30) for t in threads]
    plan = plans[0]
    assert plans[1].to_json() == plan.to_json()
    assert plan.flavor == "rollback"
    assert plan.departed == ({"sid": 2,
                              "reason": "no quiesce check-in (timeout)"},)
    assert plan.survivors == (0, 1) and plan.leavers == ()
    # From the same check-ins both packages publish the same plan; with
    # members departed nobody can step, so it stops where it stands.
    plans = {}
    for name, cls in (("port", MembershipLedger),
                      ("jax", jel.MembershipLedger)):
        for sid, step in ((0, 10), (1, 12)):
            cls(tmp_path / name, sid).check_in(1, step, False, "graceful")
        cls(tmp_path / name, 0).maybe_publish_plan(1, members, 0,
                                                    timed_out=True)
        plans[name] = (tmp_path / name / "plan_e0001.json").read_text()
    assert plans["port"] == plans["jax"]
    assert json.loads(plans["port"])["stop_step"] == 12


@pytest.mark.parametrize("ledger_cls", [MembershipLedger,
                                        jel.MembershipLedger],
                         ids=["port", "jax"])
def test_ledger_suspect_reason_lands_in_plan(tmp_path, ledger_cls):
    led0 = ledger_cls(tmp_path, 0)
    led0.mark_suspect(1, 1, "heartbeat stale 42s")
    led0.check_in(1, 7, leaving=False, flavor="rollback")
    led0.maybe_publish_plan(1, [0, 1], train_epoch=0, timed_out=True)
    plan = led0.try_plan(1)
    assert plan.flavor == "rollback"
    assert plan.departed == ({"sid": 1, "reason": "heartbeat stale 42s"},)
    # Epoch-scoped: the same file is inert for the next transition.
    assert led0.suspects(2) == {}
    assert led0.suspects(1) == {1: "heartbeat stale 42s"}
    # The other package reads the accusation and the plan alike.
    other = (jel.MembershipLedger if ledger_cls is MembershipLedger
             else MembershipLedger)(tmp_path, 0)
    assert other.suspects(1) == {1: "heartbeat stale 42s"}
    assert other.try_plan(1).to_json() == plan.to_json()


def test_ledger_plan_publish_is_exclusive(tmp_path):
    """Two acting leaders whose views diverge (the second saw a late
    check-in after the first's window passed) race to publish: exactly one
    plan file, which both adopt, whichever package wrote it."""
    for name, writer in (("a", MembershipLedger), ("b", jel.MembershipLedger)):
        gen = tmp_path / name
        early = writer(gen, 0)
        early.check_in(1, 5, leaving=False, flavor="rollback")
        early.maybe_publish_plan(1, [0, 1, 2], train_epoch=0,
                                 timed_out=True)
        MembershipLedger(gen, 2).check_in(1, 5, leaving=False,
                                          flavor="rollback")
        late = MembershipLedger(gen, 0)
        late.maybe_publish_plan(1, [0, 1, 2], train_epoch=0, timed_out=True)
        assert len(list(gen.glob("plan_e*.json"))) == 1
        plan = late.try_plan(1)
        assert [d["sid"] for d in plan.departed] == [1, 2]
        assert jel.MembershipLedger(gen, 2).try_plan(1).to_json() == \
            plan.to_json()
    assert tel._exclusive_write_json(tmp_path / "p.json", {"who": "a"})
    assert not tel._exclusive_write_json(tmp_path / "p.json", {"who": "b"})
    assert json.loads((tmp_path / "p.json").read_text()) == {"who": "a"}


def _rollback_files(ledger_cls, record_cls, gen):
    """A rollback transition written through one package: a suspect, the
    survivors' rollback check-ins, the timed-out plan and epoch 1."""
    leds = [ledger_cls(gen, s) for s in range(3)]
    leds[0].write_initial([0, 1, 2], "127.0.0.1:9999")
    leds[1].mark_suspect(1, 2, "rank 2 heartbeat stale: last beat at step 6")
    for s in (0, 1):
        leds[s].check_in(1, 6 + s, leaving=False, flavor="rollback")
    leds[0].maybe_publish_plan(1, [0, 1, 2], train_epoch=0, timed_out=True)
    plan = leds[0].try_plan(1)
    leds[0].publish_epoch(record_cls(
        epoch=1, members=(0, 1), coordinator="127.0.0.1:10001",
        departed=plan.departed, service_sid=0, reason="rollback", ts=5.0,
        resume={"epoch": 0, "steps_done": 4, "lineage": [[3, 4]],
                "global_step": 4, "snapshot_dir": "snap/step_0000000004"}))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rollback_ledger_files_are_the_same_bytes_both_ways(tmp_path,
                                                            writer):
    """Suspect files, rollback plans and rollback records: written by
    either package, read by the other, and equal file for file (the ``ts``
    stamps aside)."""
    _rollback_files(jel.MembershipLedger, jel.MembershipRecord,
                    tmp_path / "jax")
    _rollback_files(MembershipLedger, MembershipRecord, tmp_path / "port")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "suspect_e0001_r00002.json" in names
    for name in names:
        a, b = (json.loads((tmp_path / w / name).read_text())
                for w in ("jax", "port"))
        if "ts" in a:
            assert a.pop("ts") and b.pop("ts")
        assert a == b, name
    gen = tmp_path / writer
    for reader in (MembershipLedger, jel.MembershipLedger):
        led = reader(gen, 1)
        rec = led.current()
        assert rec.reason == "rollback" and rec.members == (0, 1)
        assert rec.departed == ({"sid": 2, "reason": "rank 2 heartbeat "
                                 "stale: last beat at step 6"},)
        assert led.suspects(1) == {2: "rank 2 heartbeat stale: last beat "
                                      "at step 6"}
        plan = led.try_plan(1)
        assert (plan.flavor, plan.stop_step, plan.survivors) == (
            "rollback", 7, (0, 1))


# ---------------------------------------------------------------------------
# the coordinator
# ---------------------------------------------------------------------------


def test_the_coordinator_suspects_rewinds_and_times_out(tmp_path):
    """``mark_suspect`` writes the accusation (dense rank → sid) and its
    ``elastic_suspect`` event; a member's next poll says "suspect" (rate
    limited; ``rewind_poll`` re-arms it); the collection window declares
    the silent member departed, and without a plan `quiesce_step` raises
    `ElasticError` after twice the window."""
    flightrec.recorder.configure(rank=0, dump_dir=tmp_path / "obs",
                                 capacity=64, fresh=True)
    rec = MembershipRecord(epoch=0, members=(0, 1, 2), coordinator=None)
    el0 = ElasticCoordinator.attach(tmp_path, "gen", 0, rec,
                                    regroup_timeout_s=0.3,
                                    poll_every_steps=4)
    el1 = ElasticCoordinator.attach(tmp_path, "gen", 1, rec,
                                    regroup_timeout_s=0.3,
                                    poll_every_steps=4)
    assert el1.poll(4) is None
    el0.mark_suspect(2, "rank 2 has no heartbeat yet")
    events = [e for e in flightrec.recorder.events()
              if e["kind"] == "elastic_suspect"]
    assert events and events[-1]["rank"] == 2
    assert el1.poll(5) is None  # the same cadence window: not globbed
    el1.rewind_poll(1)
    assert el1.poll(4) == "suspect"
    plan = None
    t0 = time.monotonic()
    while plan is None:
        el1.quiesce_step(0, 9, leaving=False, flavor="rollback")
        plan = el0.quiesce_step(0, 8, leaving=False, flavor="rollback")
        time.sleep(0.02)
    assert 0.3 <= time.monotonic() - t0 < 5
    assert plan.departed == ({"sid": 2,
                              "reason": "rank 2 has no heartbeat yet"},)
    assert (plan.flavor, plan.stop_step, plan.survivors) == (
        "rollback", 9, (0, 1))
    assert not el0.quiescing
    # A member whose acting leader never publishes: bounded.
    lone = ElasticCoordinator.attach(tmp_path, "gen2", 1, rec,
                                     regroup_timeout_s=0.2)
    MembershipLedger(tmp_path / "gen2", 0).check_in(1, 3, False, "rollback")
    t0 = time.monotonic()
    with pytest.raises(ElasticError, match="no plan published within"):
        lone.quiesce_blocking(0, 3, leaving=False, flavor="rollback")
    assert 0.4 <= time.monotonic() - t0 < 5


def test_an_accused_leaver_carries_the_accusation_into_the_record(
        tmp_path):
    """The SDC eviction's record: the suspect leaves (a live-membered
    rollback plan) and the record names the accusation as its reason, as
    the JAX package's `establish` writes it."""
    recs = {}
    for name, coord_cls, led_cls in (
            ("port", ElasticCoordinator, MembershipLedger),
            ("jax", jel.ElasticCoordinator, jel.MembershipLedger)):
        rec = (MembershipRecord if name == "port" else jel.MembershipRecord)(
            epoch=0, members=(0, 1, 2), coordinator="127.0.0.1:9")
        el = coord_cls.attach(tmp_path / name, "gen", 0, rec,
                              coordinator_host="127.0.0.1")
        el.mark_suspect(2, "sdc audit mismatch at step 4")
        for s in range(3):
            led_cls(tmp_path / name / "gen", s).check_in(
                1, 4, leaving=s == 2, flavor="rollback")
        el.ledger.maybe_publish_plan(1, [0, 1, 2], 0, timed_out=False)
        plan = el.ledger.try_plan(1)
        assert (plan.flavor, plan.leavers, plan.stop_step) == (
            "rollback", (2,), 7)
        recs[name] = el.establish(plan, {"epoch": 0}).to_json()
    for r in recs.values():
        r.pop("ts"), r.pop("coordinator")
    assert recs["port"] == recs["jax"]
    assert recs["port"]["departed"] == [
        {"sid": 2, "reason": "sdc audit mismatch at step 4"}]
    assert recs["port"]["reason"] == "rollback"


# ---------------------------------------------------------------------------
# the rollback resume
# ---------------------------------------------------------------------------


def test_the_rollback_resume_is_the_newest_complete_save_as_in_jax(
        tmp_path):
    """Snapshots at steps 2, 4 and 6 (elastic lineage stamps), step 6 torn
    (its payload gone) and a step-8 directory with an unreadable meta: the
    resume is step 4's, the JAX package's payload key for key; at world 2
    its re-split tail is `tpu_dp.data.sampler.elastic_resplit`'s, index for
    index, and its consumption continues the epoch exactly once."""
    ck = tmp_path / "ck"
    t = Trainer(parse_cli(_ELASTIC + [
        "--data.dataset=synthetic", "--data.synthetic_train_size=96",
        "--data.batch_size=4", "--train.ckpt_async=false",
        "--resilience.snapshot_keep=10", f"--train.ckpt_dir={ck}"]),
        device="cpu")
    for step in (2, 4, 6, 8):
        t.snap_mgr.snapshot(t.state, step, {
            "kind": "snapshot", "epoch": 0, "steps_done": step, "seed": 0,
            "membership": {"epoch": 0, "world": 3, "members": [0, 1, 2],
                           "lineage": [[3, step]]}})
    t.snap_mgr.wait()
    snap = Path(t.snapshot_dir)
    (snap / "step_0000000006" / "state.msgpack").unlink()  # torn
    (snap / "step_0000000008" / "meta.json").write_text("{not json")
    mine = t._rollback_resume()
    theirs = JaxTrainer._rollback_resume(SimpleNamespace(
        cfg=t.cfg, snapshot_dir=t.snapshot_dir))
    assert mine == theirs
    assert mine["snapshot_dir"].endswith("step_0000000004")
    assert (mine["epoch"], mine["steps_done"], mine["lineage"],
            mine["global_step"]) == (0, 4, [[3, 4]], 4)
    # The tail at world 2 (rank 0 of 2 here: the trainer's world is 1, so
    # both of world 2's streams are rebuilt from the same lineage).
    per_step = 4
    for world, rank in ((2, 0), (2, 1), (1, 0)):
        t.ctx = SimpleNamespace(world=world, rank=rank,
                                is_main_process=rank == 0)
        assert t._lineage_position(0, 4, mine["lineage"]) == (0, 0)
        got = t._elastic_tail.pipe.sampler.shard_indices()
        want = jax_resplit(96, True, 0, 0, per_step, [[3, 4]], world, rank)
        np.testing.assert_array_equal(got, want)
        assert t._elastic_tail.base == 4
    seen = np.concatenate(
        [jax_resplit(96, True, 0, 0, per_step, [[3, 4]], 2, r)
         for r in (0, 1)]).tolist()
    assert len(seen) == len(set(seen)) == 96 - 4 * 3 * per_step


def test_a_lineage_at_this_world_resumes_by_the_standard_skip(tmp_path):
    """A save whose epoch ran at this world alone continues by the
    standard skip (no tail), a last segment at this world after another
    world's continues on the tail less what it ran."""
    t = Trainer(parse_cli(_ELASTIC + [
        "--data.dataset=synthetic", "--data.synthetic_train_size=96",
        "--data.batch_size=4", f"--train.ckpt_dir={tmp_path}"]),
        device="cpu")
    assert t._lineage_position(1, 5, [[1, 5]]) == (1, 5)
    assert t._elastic_tail is None and t._epoch_lineage == []
    assert t._lineage_position(0, 7, [[2, 3], [1, 4]]) == (0, 0)
    assert t._elastic_tail.skip == 4 and t._elastic_tail.base == 3
    np.testing.assert_array_equal(
        t._elastic_tail.pipe.sampler.shard_indices(),
        jax_resplit(96, True, 0, 0, 4, [[2, 3]], 1, 0))


# ---------------------------------------------------------------------------
# health → ledger, peer failures, the config
# ---------------------------------------------------------------------------


def _beats(run_dir: Path, now: float) -> None:
    """Rank 0 and 1 fresh (rank 1 straggling 10x), rank 2 stale."""
    run_dir.mkdir(parents=True, exist_ok=True)
    for rank, (ts, ms) in enumerate(((now, 10.0), (now, 100.0),
                                     (now - 600, 10.0))):
        with open(run_dir / f"heartbeat_r{rank:05d}.jsonl", "w") as f:
            for step in range(1, 6):
                f.write(json.dumps({"rank": rank, "step": step, "ts": ts,
                                    "step_ms": ms}) + "\n")


def test_suspect_from_health_marks_stale_ranks_never_stragglers(tmp_path):
    now = time.time()
    _beats(tmp_path / "obs", now)
    kw = dict(world=3, straggler_factor=3.0, stale_after_s=60.0)
    issues = HealthMonitor(tmp_path / "obs", **kw).check(now=now)
    assert sorted((i.kind, i.rank) for i in issues) == [
        ("stale", 2), ("straggler", 1)]
    rec = MembershipRecord(epoch=0, members=(0, 1, 2), coordinator=None)
    el = ElasticCoordinator.attach(tmp_path / "port", "gen", 0, rec)
    Trainer._suspect_from_health(SimpleNamespace(elastic=el), issues)
    jissues = JaxHealthMonitor(tmp_path / "obs", **kw).check(now=now)
    jel_ = jel.ElasticCoordinator.attach(tmp_path / "jax", "gen", 0,
                                         jel.MembershipRecord(**{
                                             "epoch": 0, "members": (0, 1, 2),
                                             "coordinator": None}))
    JaxTrainer._suspect_from_health(SimpleNamespace(elastic=jel_), jissues)
    mine = MembershipLedger(tmp_path / "port" / "gen", 0).suspects(1)
    theirs = MembershipLedger(tmp_path / "jax" / "gen", 0).suspects(1)
    assert mine == theirs and list(mine) == [2]
    assert "heartbeat stale" in mine[2]
    # Without elastic nothing is written.
    Trainer._suspect_from_health(SimpleNamespace(elastic=None), issues)


@pytest.mark.parametrize("err,peer", [
    (RuntimeError("[/w/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:"
                  "537] Read error [127.0.0.1]:2975: Connection reset by "
                  "peer."), True),
    (RuntimeError("Got the following error when running the callback: "
                  "RuntimeError: [../third_party/gloo/gloo/transport/tcp/"
                  "pair.cc:553] Connection closed by peer"), True),
    (RuntimeError("[../gloo/gloo/transport/tcp/unbound_buffer.cc:78] Timed "
                  "out waiting 30000ms for recv operation to complete"),
     True),
    (PeerFailedError("window fence"), True),
    (torch.distributed.DistBackendError("NCCL error: remote process exited"),
     True),
    (RuntimeError("CUDA out of memory"), False),
    (ElasticError("gloo/transport/ in an ElasticError"), False),
    (ValueError("gloo/transport/"), False),
])
def test_peer_failures_are_told_from_every_other_error(err, peer):
    assert is_peer_failure(err) is peer


def test_the_guard_runs_with_elastic_and_the_grow_half_stays_refused(
        tmp_path):
    # The grow half runs since its port: its knobs and its relaunch fault
    # are taken under the guard too, and only drop (the host ring's) is
    # refused.
    cfg = parse_cli(_ELASTIC + ["--guard.enabled=true",
                                "--resilience.fault=sdc:step=3,rank=2",
                                f"--train.ckpt_dir={tmp_path}"])
    assert cfg.guard.enabled and cfg.resilience.elastic
    cfg = parse_cli(_ELASTIC + ["--guard.enabled=true",
                                "--resilience.elastic_join=never",
                                "--resilience.fault=relaunch:step=2,rank=1"])
    assert (cfg.resilience.elastic_join, cfg.resilience.fault) == (
        "never", "relaunch:step=2,rank=1")
    with pytest.raises(ValueError, match="host ring"):
        parse_cli(_ELASTIC + ["--guard.enabled=true",
                              "--resilience.fault=drop:step=2,rank=1"])


@pytest.mark.card
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_the_window_fence_gives_up_at_its_deadline():
    """`PeerFence` on the card: work that outlasts the deadline (a spin
    kernel standing in for a collective on a dead peer) raises
    `PeerFailedError` within it, polling, never blocking."""
    from tpu_dp_torch.parallel.dist import PeerFence

    fence = PeerFence("cuda:0", timeout_s=0.5)
    fence.step()
    fence.drain()  # idle card: at once
    torch.cuda._sleep(int(5e9))  # seconds of spinning
    t0 = time.monotonic()
    with pytest.raises(PeerFailedError, match="did not finish within"):
        fence.drain()
    assert 0.5 <= time.monotonic() - t0 < 2.0
    torch.cuda.synchronize()


def test_an_abort_that_never_returns_fails_at_its_deadline(monkeypatch):
    """`abort_communicators` is a bounded wait: an NCCL abort that never
    returns (its kernel spinning where the abort cannot reach it) raises
    `ElasticError` at the deadline instead of hanging the survivor."""
    import threading

    import torch.distributed as dist

    from tpu_dp_torch.parallel import dist as pdist

    release = threading.Event()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(dist.distributed_c10d, "_abort_process_group",
                        lambda group=None: release.wait(30))
    t0 = time.monotonic()
    with pytest.raises(ElasticError, match="did not return within 0.3 s"):
        pdist.abort_communicators(0.3)
    assert 0.3 <= time.monotonic() - t0 < 5
    release.set()
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    pdist.abort_communicators(0.3)  # gloo: nothing to abort
