"""The port's membership ledger, re-split and elastic knobs against the JAX
package's (`tpu_dp_torch/resilience/elastic.py`, `tpu_dp_torch/data/
sampler.py`; the shrink half of tests/test_elastic.py).

- `MembershipRecord` and `QuiescePlan` round-trip through each other's
  JSON, and a ledger one package writes (epoch record, check-ins, plan,
  acks, departure) the other reads; both packages publish the same plan
  from the same check-ins.
- The ledger protocol driven by plain threads: graceful convergence to one
  canonical plan, exclusive publish, records and epoch waits, the ack
  barrier; the IO retry, its exhaustion, absent reads and degraded reads.
- `elastic_resplit` and `ElasticTailSampler` equal the JAX functions index
  for index on the shrink cases, and a pipeline fed the tail consumes the
  rest of the uninterrupted epoch.
- ``leave:`` parses and gates by rank as in the JAX package; the elastic
  knobs are taken, and what stays unported is refused naming its item
  (the rollback flavour and the guard with elastic are
  tests/test_torch_elastic_rollback*.py, the grow
  tests/test_torch_elastic_grow*.py).
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import tpu_dp.config as jax_config
import tpu_dp.resilience.elastic as jel
from tpu_dp.data import sampler as jsampler
from tpu_dp.resilience import faultinject as jfi
from tpu_dp.train.trainer import Trainer as JaxTrainer
from tpu_dp_torch.config import NotPortedError, parse_cli
from tpu_dp_torch.data import sampler as tsampler
from tpu_dp_torch.data.cifar import make_synthetic
from tpu_dp_torch.data.pipeline import DataPipeline
from tpu_dp_torch.obs.counters import counters
from tpu_dp_torch.resilience import FaultInjector, FaultPlan
from tpu_dp_torch.resilience import elastic as tel
from tpu_dp_torch.resilience.elastic import (
    ElasticError,
    MembershipLedger,
    MembershipRecord,
    QuiescePlan,
)

pytestmark = pytest.mark.port

_RECORD = dict(
    epoch=1, members=(0, 2), coordinator="127.0.0.1:10000",
    departed=({"sid": 1, "reason": "preempted (graceful)"},),
    resume={"epoch": 0, "steps_done": 4, "lineage": [[3, 4]],
            "global_step": 4, "snapshot_dir": "snap"},
    reason="graceful", ts=123.0, service_sid=0)
_PLAN = dict(epoch=1, flavor="graceful", stop_step=9, train_epoch=0,
             leavers=(2,), departed=(), survivors=(0, 1))


# ---------------------------------------------------------------------------
# records and ledgers, both ways
# ---------------------------------------------------------------------------


def test_records_and_plans_round_trip_through_each_others_json():
    mine, theirs = MembershipRecord(**_RECORD), jel.MembershipRecord(**_RECORD)
    assert mine.to_json() == theirs.to_json()
    assert MembershipRecord.from_json(theirs.to_json()) == mine
    assert jel.MembershipRecord.from_json(mine.to_json()) == theirs
    assert mine.world == 2 and mine.rank_of(2) == 1
    p, jp = QuiescePlan(**_PLAN), jel.QuiescePlan(**_PLAN)
    assert p.to_json() == jp.to_json()
    assert QuiescePlan.from_json(jp.to_json()) == p
    assert jel.QuiescePlan.from_json(p.to_json()) == jp
    with pytest.raises(ElasticError, match="schema"):
        MembershipRecord.from_json({**mine.to_json(), "schema": 2})


def _graceful_transition(ledger_cls, gen_dir):
    """A three-member graceful transition (sid 2 leaves) written through
    ``ledger_cls``: epoch 0, the check-ins, the plan, the acks, the
    departure confirmation and the survivors' epoch 1."""
    leds = [ledger_cls(gen_dir, s) for s in range(3)]
    leds[0].write_initial([0, 1, 2], "127.0.0.1:9999")
    for s, led in enumerate(leds):
        led.check_in(1, 4 + s, leaving=s == 2, flavor="graceful", window=2)
    leds[0].maybe_publish_plan(1, [0, 1, 2], train_epoch=0, timed_out=False)
    for led in leds:
        led.ack_quiesced(1)
    leds[2].confirm_left(9)
    rec = jel.MembershipRecord(**_RECORD) if ledger_cls is jel.MembershipLedger \
        else MembershipRecord(**_RECORD)
    leds[0].publish_epoch(rec)
    return leds


@pytest.mark.parametrize("writer,reader", [
    (jel.MembershipLedger, MembershipLedger),
    (MembershipLedger, jel.MembershipLedger)], ids=["jax->port", "port->jax"])
def test_a_ledger_one_package_writes_the_other_reads(tmp_path, writer,
                                                     reader):
    _graceful_transition(writer, tmp_path)
    led = reader(tmp_path, 0)
    assert led.current().to_json() == MembershipRecord(**_RECORD).to_json()
    assert led.await_epoch(0, timeout_s=1).members == (0, 1, 2)
    plan = led.try_plan(1)
    assert plan.to_json() == {
        "schema": 1, "epoch": 1, "flavor": "graceful", "stop_step": 11,
        "train_epoch": 0, "leavers": [2], "departed": [],
        "survivors": [0, 1], "joiners": []}
    assert {s: d["step"] for s, d in led.check_ins(1).items()} == {
        0: 4, 1: 5, 2: 6}
    assert led.quiesce_triggered(1) and not led.quiesce_triggered(2)
    assert led.await_quiesced(1, [0, 1, 2], timeout_s=1) == []
    assert json.loads((tmp_path / "left_r00002.json").read_text())[
        "step"] == 9


def test_both_packages_publish_the_same_plan_from_the_same_check_ins(
        tmp_path):
    plans = {}
    for name, cls in (("jax", jel.MembershipLedger),
                      ("port", MembershipLedger)):
        leds = [cls(tmp_path / name, s) for s in range(4)]
        for s, led in enumerate(leds):
            led.check_in(1, 10 + 3 * s, leaving=s in (1, 3),
                         flavor="graceful", window=1 + s)
        leds[0].maybe_publish_plan(1, range(4), train_epoch=2,
                                   timed_out=False)
        plans[name] = (tmp_path / name / "plan_e0001.json").read_text()
    assert plans["jax"] == plans["port"]
    assert json.loads(plans["port"])["stop_step"] == 19 + 2 * 4 + 1


# ---------------------------------------------------------------------------
# the protocol, by threads (tests/test_elastic.py's twins)
# ---------------------------------------------------------------------------


def _converge(ledger, members, step0, leaving, deadline_s=20.0):
    start = time.monotonic()
    step = step0
    while time.monotonic() - start < deadline_s:
        ledger.check_in(1, step, leaving, "graceful", window=1)
        plan = ledger.try_plan(1)
        if plan is None:
            ledger.maybe_publish_plan(
                1, members, train_epoch=0,
                timed_out=time.monotonic() - start > 2.0)
            plan = ledger.try_plan(1)
        if plan is not None:
            return plan
        step += 1
        time.sleep(0.01)
    raise AssertionError("no plan within deadline")


def test_ledger_graceful_convergence_threads(tmp_path):
    members, plans = [0, 1, 2], {}

    def member(sid):
        led = MembershipLedger(tmp_path, sid)
        plans[sid] = _converge(led, members, step0=4 + sid,
                               leaving=sid == 2)

    threads = [threading.Thread(target=member, args=(s,)) for s in members]
    [t.start() for t in threads]
    [t.join(timeout=30) for t in threads]
    assert not any(t.is_alive() for t in threads)
    assert set(plans) == {0, 1, 2}
    assert len({json.dumps(p.to_json(), sort_keys=True)
                for p in plans.values()}) == 1
    plan = plans[0]
    assert plan.flavor == "graceful" and plan.leavers == (2,)
    assert plan.survivors == (0, 1) and plan.departed == ()
    assert plan.stop_step > max(4 + s for s in members)
    # The JAX package reads the same plan from the files.
    assert jel.MembershipLedger(tmp_path, 0).try_plan(1).to_json() == \
        plan.to_json()


def test_ledger_plan_publish_is_exclusive(tmp_path):
    path = tmp_path / "plan_e0001.json"
    assert tel._exclusive_write_json(path, {"who": "a"})
    assert not tel._exclusive_write_json(path, {"who": "b"})
    assert json.loads(path.read_text()) == {"who": "a"}


def test_membership_record_roundtrip_and_epoch_await(tmp_path):
    led = MembershipLedger(tmp_path, 0)
    rec = led.write_initial([0, 1, 2], "127.0.0.1:9999")
    assert rec.epoch == 0 and rec.world == 3 and rec.rank_of(1) == 1
    led.publish_epoch(MembershipRecord(**_RECORD))
    got = led.await_epoch(1, timeout_s=2)
    assert got.members == (0, 2) and got.rank_of(2) == 1
    with pytest.raises(ElasticError, match="not a member"):
        got.rank_of(1)
    assert led.current().epoch == 1
    with pytest.raises(ElasticError, match="did not appear"):
        led.await_epoch(5, timeout_s=0.2)


def test_quiesce_ack_barrier(tmp_path):
    led0, led1 = MembershipLedger(tmp_path, 0), MembershipLedger(tmp_path, 1)
    led0.ack_quiesced(1)
    assert led0.await_quiesced(1, [0, 1], timeout_s=0.3) == [1]
    led1.ack_quiesced(1)
    assert led0.await_quiesced(1, [0, 1], timeout_s=2) == []


def test_a_check_in_timeout_publishes_a_rollback_plan_the_port_refuses(
        tmp_path):
    """A member that never checks in: the JAX plan (rollback, departed)
    in the JAX format. The trainer carries it out since the rollback
    flavour was ported (tests/test_torch_elastic_rollback_ranks.py); the
    name is the graceful slice's."""
    led = MembershipLedger(tmp_path, 0)
    led.check_in(1, 3, leaving=False, flavor="graceful")
    led.maybe_publish_plan(1, [0, 1, 2], train_epoch=0, timed_out=True)
    plan = led.try_plan(1)
    jled = jel.MembershipLedger(tmp_path / "jax", 0)
    jled.check_in(1, 3, leaving=False, flavor="graceful")
    jled.maybe_publish_plan(1, [0, 1, 2], train_epoch=0, timed_out=True)
    assert plan.to_json() == jled.try_plan(1).to_json()
    assert plan.flavor == "rollback"
    assert [d["sid"] for d in plan.departed] == [1, 2]


def test_a_coordinator_attached_at_epoch_1_runs_the_next_transition(
        tmp_path):
    """`ElasticCoordinator.attach` adopts a live generation's record (no
    epoch 0 written or read); a lone member's departure then converges at
    once (`quiesce_blocking`) on the plan for epoch 2, in the JAX format."""
    from tpu_dp_torch.resilience.elastic import ElasticCoordinator

    rec = MembershipRecord(**{**_RECORD, "members": (2,)})
    MembershipLedger(tmp_path / "gen", 0).publish_epoch(rec)
    el = ElasticCoordinator.attach(tmp_path, "gen", 2, rec)
    assert el.record.epoch == 1 and el.record.world == 1
    assert not (tmp_path / "gen" / "epoch_0000.json").exists()
    assert el.poll(5) is None and el.poll(6, leave_requested=True) == "leave"
    plan = el.quiesce_blocking(0, 6, leaving=True, flavor="graceful")
    assert (plan.epoch, plan.leavers, plan.survivors, plan.stop_step) == (
        2, (2,), (), 6)
    assert jel.MembershipLedger(tmp_path / "gen", 0).try_plan(2).to_json() \
        == plan.to_json()


# ---------------------------------------------------------------------------
# ledger IO: bounded, jittered retry
# ---------------------------------------------------------------------------


def test_ledger_io_retries_transient_errors(tmp_path, monkeypatch):
    monkeypatch.setattr(tel, "_IO_BASE_DELAY_S", 0.001)
    fails = {"n": 2}
    real_replace = os.replace

    def flaky_replace(src, dst):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError(5, "Input/output error (injected)")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", flaky_replace)
    before = counters.get("retry.retries")
    led = MembershipLedger(tmp_path, 0)
    led.check_in(1, 7, leaving=False, flavor="graceful")
    assert led.check_ins(1)[0]["step"] == 7
    assert counters.get("retry.retries") - before >= 2


def test_ledger_io_exhaustion_raises_typed_error(tmp_path, monkeypatch):
    monkeypatch.setattr(tel, "_IO_BASE_DELAY_S", 0.001)

    def always_fails(src, dst):
        raise OSError(5, "Input/output error (injected, permanent)")

    monkeypatch.setattr(os, "replace", always_fails)
    before = counters.get("retry.exhausted")
    led = MembershipLedger(tmp_path, 0)
    with pytest.raises(ElasticError, match="failed after .* attempts"):
        led.check_in(1, 7, leaving=False, flavor="graceful")
    assert counters.get("retry.exhausted") - before >= 1


def test_ledger_read_absent_is_answer_not_error(tmp_path):
    led = MembershipLedger(tmp_path, 0)
    assert led.try_plan(4) is None
    assert led.check_ins(4) == {}


def test_ledger_read_exhaustion_degrades_to_none(tmp_path, monkeypatch):
    monkeypatch.setattr(tel, "_IO_BASE_DELAY_S", 0.001)
    led = MembershipLedger(tmp_path, 0)
    led.check_in(1, 7, leaving=False, flavor="graceful")
    led.maybe_publish_plan(1, [0], train_epoch=0, timed_out=False)

    def always_fails(self, *a, **kw):
        raise OSError(5, "Input/output error (injected, permanent)")

    monkeypatch.setattr(Path, "read_text", always_fails)
    assert led.try_plan(1) is None


# ---------------------------------------------------------------------------
# elastic_resplit and ElasticTailSampler, index for index
# ---------------------------------------------------------------------------

_RESPLIT_CASES = [
    # (E, shuffle, seed, epoch, per_step, lineage, new_world)
    (48, True, 7, 0, 4, [(3, 2)], 2),
    (48, True, 7, 0, 4, [(3, 2), (2, 1)], 1),
    (50, True, 1, 5, 4, [(3, 1)], 2),
    (47, True, 1, 5, 4, [(3, 2)], 2),
    (49, True, 1, 5, 2, [(4, 1)], 3),
    (31, True, 1, 5, 4, [(2, 3)], 1),
    (51, True, 3, 1, 4, [(2, 3)], 2),
    (96, False, 0, 2, 8, [(4, 1), (3, 1)], 2),
    (3840, True, 0, 0, 128, [(3, 3)], 2),
    (16, True, 0, 0, 4, [(2, 2)], 1),
]


@pytest.mark.parametrize("case", _RESPLIT_CASES)
def test_resplit_equals_the_jax_packages_index_for_index(case):
    e, shuffle, seed, epoch, per_step, lineage, world = case
    for shard in range(world):
        mine = tsampler.elastic_resplit(e, shuffle, seed, epoch, per_step,
                                        lineage, world, shard)
        theirs = jsampler.elastic_resplit(e, shuffle, seed, epoch, per_step,
                                          lineage, world, shard)
        assert mine.dtype == theirs.dtype
        np.testing.assert_array_equal(mine, theirs)
    for n, shards in ((7, 3), (9, 3), (8, 4), (5, 7)):
        np.testing.assert_array_equal(
            tsampler._pad_to_multiple(np.arange(n), shards),
            jsampler._pad_to_multiple(np.arange(n), shards))


def _consumed(e, world, steps, per_step, seed=7, epoch=0):
    out = []
    for r in range(world):
        s = tsampler.ShardedSampler(e, world, r, shuffle=True, seed=seed)
        s.set_epoch(epoch)
        out.append(s.shard_indices()[:steps * per_step])
    return np.concatenate(out)


def test_resplit_exact_coverage_and_lockstep():
    e, b = 48, 4
    tails = [tsampler.elastic_resplit(e, True, 7, 0, b, [(3, 2)], 2, m)
             for m in range(2)]
    everything = np.concatenate([_consumed(e, 3, 2, b), *tails])
    assert sorted(everything.tolist()) == list(range(e))
    assert len(tails[0]) == len(tails[1]) == 12
    for e, w0, s0, w1, b in [(50, 3, 1, 2, 4), (47, 3, 2, 2, 4),
                             (49, 4, 1, 3, 2), (31, 2, 3, 1, 4)]:
        tails = [tsampler.elastic_resplit(e, True, 1, 5, b, [(w0, s0)], w1,
                                          m) for m in range(w1)]
        assert len({len(t) for t in tails}) == 1
        assert len(tails[0]) % b == 0


def test_tail_sampler_and_bad_lineage_as_in_jax():
    s = tsampler.ElasticTailSampler(np.arange(8), epoch=3)
    s.set_epoch(3)
    assert len(s) == 8 and s.shard_indices().dtype == np.int64
    with pytest.raises(ValueError, match="pinned to epoch 3"):
        s.set_epoch(4)
    with pytest.raises(ValueError, match="consumes"):
        tsampler.elastic_resplit(16, True, 0, 0, 4, [(2, 99)], 1, 0)
    with pytest.raises(ValueError, match="out of range"):
        tsampler.elastic_resplit(16, True, 0, 0, 4, [], 2, 5)


@pytest.mark.parametrize("resident", [False, True],
                         ids=["streamed", "resident"])
def test_a_pipeline_fed_the_tail_consumes_the_rest_of_the_epoch(resident):
    """The re-split's model of what was consumed is what `DataPipeline`
    feeds: the first 2 of 12 steps, then the tail re-split onto world 1,
    equal the uninterrupted epoch (streamed windows and resident index
    windows alike)."""
    ds = make_synthetic(48, 10, seed=0, name="resplit")
    full = DataPipeline(ds, 4, "cpu", shuffle=True, seed=7, prefetch=0)
    idx = tsampler.elastic_resplit(48, True, 7, 0, 4, [(1, 2)], 1, 0)
    tail = DataPipeline(ds, 4, "cpu", shuffle=True, seed=7, prefetch=0,
                        sampler=tsampler.ElasticTailSampler(idx, 0))
    for p in (full, tail):
        p.set_epoch(0)
    assert len(tail) == 10

    def labels(pipe, k):
        if resident:
            return [ds.labels[item.numpy().reshape(-1)]
                    for _, item in pipe.index_windows(k)]
        return [item["label"].numpy().reshape(-1)
                for _, item in pipe.windows(k)]

    whole = np.concatenate(labels(full, 1))
    np.testing.assert_array_equal(
        np.concatenate([whole[:8]] + labels(tail, 4)), whole)


# ---------------------------------------------------------------------------
# the leave: fault and the knobs
# ---------------------------------------------------------------------------


def test_leave_parses_and_gates_by_rank_as_in_jax():
    plan = FaultPlan.parse("leave:step=4,rank=2")
    assert (plan.kind, plan.step, plan.rank) == ("leave", 4, 2)
    assert plan == FaultPlan(**vars(jfi.FaultPlan.parse(
        "leave:step=4,rank=2")))
    bystander = FaultInjector(plan, rank=0)
    bystander.on_step(9)
    assert not bystander.leave_requested and not bystander.fired
    target = FaultInjector(plan, rank=2)
    target.on_step(3)
    assert not target.leave_requested
    target.on_step(4)
    assert target.leave_requested and target.fired
    p2 = FaultPlan.parse("preempt:rank=2,step=9")
    assert (p2.kind, p2.rank, p2.step) == ("preempt", 2, 9)
    assert parse_cli(["--resilience.fault=leave:step=4,rank=2"])


_ELASTIC = ["--resilience.elastic=true",
            "--resilience.elastic_verify_fingerprint=false"]


def test_the_elastic_knobs_parse_and_round_trip_into_the_jax_config():
    cfg = parse_cli(_ELASTIC + [
        "--resilience.membership_dir=m", "--resilience.regroup_timeout_s=5",
        "--resilience.elastic_poll_every_steps=3",
        "--resilience.elastic_min_world=2",
        "--resilience.elastic_coordinator_host=127.0.0.1"])
    res = cfg.resilience
    assert (res.elastic, res.membership_dir, res.regroup_timeout_s,
            res.elastic_poll_every_steps, res.elastic_min_world,
            res.elastic_coordinator_host, res.elastic_verify_fingerprint) == (
        True, "m", 5.0, 3, 2, "127.0.0.1", False)
    dumped = cfg.to_dict()["resilience"]
    jcfg = jax_config.Config.from_dict({"resilience": dumped})
    assert {k: getattr(jcfg.resilience, k) for k in dumped} == dumped
    assert list(dumped) == list(jax_config.Config().to_dict()["resilience"])


def test_elastic_without_drop_remainder_is_refused_as_in_jax(tmp_path):
    args = _ELASTIC + ["--data.drop_remainder=false",
                       "--data.dataset=synthetic",
                       f"--train.ckpt_dir={tmp_path}"]
    jcfg = jax_config.parse_cli(args + ["--parallel.num_devices=1"])
    with pytest.raises(ValueError) as theirs:
        JaxTrainer(jcfg)
    with pytest.raises(ValueError) as mine:
        parse_cli(args)
    assert str(mine.value) == str(theirs.value)
    assert not isinstance(mine.value, NotPortedError)


@pytest.mark.parametrize("args,message", [
    (["--resilience.elastic=true"],
     "elastic_verify_fingerprint=true.*item 13"),
])
def test_what_stays_unported_is_refused_naming_its_item(args, message):
    with pytest.raises(NotPortedError, match=message):
        parse_cli(args)


@pytest.mark.parametrize("spec", ["drop:step=2"])
def test_the_grow_halfs_faults_are_refused_naming_9d_iii(spec):
    # Of the grow half's faults only drop stays refused, naming the host
    # ring it needs (relaunch and slowfs run:
    # tests/test_torch_elastic_grow.py).
    with pytest.raises(ValueError, match="host ring"):
        parse_cli(_ELASTIC + [f"--resilience.fault={spec}"])
