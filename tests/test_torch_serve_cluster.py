"""The port's self-healing serving tier (`tpu_dp_torch.serve.router.
ServeCluster`) on the CPU against the JAX package's (`tpu_dp.serve.
ServeCluster`, two replicas over the 8 virtual CPU devices of
tests/conftest.py; the port's replicas both on ``"cpu"``), the weights
carried across by `tpu_dp_torch.compat`:

- the same requests get the same answers: ``Net``'s predictions equal and
  its confidences within 1e-5; the narrow fused ResNet-18's predictions
  equal wherever JAX's top-2 logit margin exceeds 2e-2 x max|logits|
  (twice ROADMAP Queue 3 item 2's 1e-2 bound on fused logits) and its
  confidences within 1e-2;
- both packages' books are consistent, overall and per class; the
  report's keys are the JAX package's;
- a scripted drain, hot swap and rejoin publish the same membership
  records field for field (timestamps aside), and both packages'
  ``obsctl timeline`` and the JAX `FleetAggregator` read the port's run
  directory;
- a whole-tier death sheds typed and ``stop()`` raises the JAX message;
  a wedged replica is quarantined then restored; SIGTERM drains one
  replica; failover retries a dead replica's batch on the survivor;
- after a hot swap the served predictions equal a fresh model's holding
  the new weights (the kernel's packed weights refreshed in place);
- `parse_fault_specs`, `register_serve_costs`, `serve_report_core` and
  `from_serve_config` give what the JAX functions give (the engine's
  ``profile_batches``-needs-``profile_dir`` refusal its message); the
  engine beats per batch, traces its batch window, and a ``leave:``
  closes its queue;
- the kernels' launch books count exactly under concurrent threads.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from torch_port_util import jax_resnet18_variables
from tpu_dp.models import build_model as jax_build
from tpu_dp.serve import ServeCluster as JCluster
from tpu_dp_torch.compat import convert_variables, load_jax_variables
from tpu_dp_torch.models import build_model
from tpu_dp_torch.obs.counters import Counters
from tpu_dp_torch.serve import ServeCluster, run_load

pytestmark = pytest.mark.port

# The suite runs several pytest workers on one machine: keep each worker's
# PyTorch CPU pool small so the port's tests do not starve the others.
torch.set_num_threads(2)

FUSED = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def net_vars():
    model = jax_build("net")
    v = model.init(jax.random.PRNGKey(0),
                   np.zeros((1, 32, 32, 3), np.float32), train=False)
    return model, v


def _port_net(variables):
    return load_jax_variables(build_model("net"), variables)


def _cluster(model, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("devices", ["cpu", "cpu"])
    kw.setdefault("buckets", (1, 2, 4))
    kw.setdefault("slo_ms", 60_000.0)
    kw.setdefault("health_every_s", 0.02)
    kw.setdefault("registry", Counters())
    return ServeCluster(model, **kw)


def _jcluster(model, params, **kw):
    from tpu_dp.obs.counters import Counters as JCounters

    kw.setdefault("replicas", 2)
    kw.setdefault("buckets", (1, 2, 4))
    kw.setdefault("slo_ms", 60_000.0)
    kw.setdefault("health_every_s", 0.02)
    kw.setdefault("registry", JCounters())
    return JCluster(model, params, **kw)


def _wait_for(predicate, timeout_s=20.0, poll_s=0.01):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(poll_s)
    return False


def _requests(n, seed, sizes=(1, 2, 3)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (int(rng.choice(sizes)), 32, 32, 3),
                         dtype=np.uint8) for _ in range(n)]


class _Raising:
    """Stands in for a port bucket program's graph: calling it raises
    (a replica dying mid-serve); its other attributes are the graph's, so
    the replica's `RecompileGuard` and books stay as they were."""

    def __init__(self, real, message):
        self._real, self._message = real, message

    def __call__(self, *a, **k):
        raise RuntimeError(self._message)

    def __getattr__(self, item):
        return getattr(self._real, item)


def _poison(replica, message):
    """Make every bucket program of ``replica`` raise. The port swaps the
    program under each guard; the JAX replica's entries are replaced
    whole, as the JAX package's own tests do."""
    for bucket, prog in list(replica._programs.items()):
        if type(replica).__module__.startswith("tpu_dp_torch."):
            prog._fn = _Raising(prog._fn, message)
        else:
            def boom(*a, **k):
                raise RuntimeError(message)

            replica._programs[bucket] = boom


def _serve_all(cluster, reqs):
    with cluster:
        handles = [cluster.submit(r) for r in reqs]
        assert all(h.wait(120) for h in handles)
        report = cluster.report()
    assert all(h.ok for h in handles)
    return handles, report


# -- the same answers as the JAX cluster ------------------------------------

def test_net_cluster_answers_match_jax_cluster(net_vars):
    model, v = net_vars
    reqs = _requests(24, seed=7)
    theirs, jrep = _serve_all(_jcluster(model, v["params"]), reqs)
    mine, rep = _serve_all(_cluster(_port_net(v)), reqs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.predictions, b.predictions)
        np.testing.assert_allclose(a.confidence, b.confidence, rtol=0,
                                   atol=1e-5)
    images = sum(len(r) for r in reqs)
    for r in (rep, jrep):
        assert r["device_stats"]["served"] == images
        assert r["counters"]["serve.completed"] == len(reqs)
        assert r["retraces"] == 0
    assert set(rep) == set(jrep)
    assert set(rep["replicas"]["0"]) == set(jrep["replicas"]["0"])
    assert set(rep["device_stats"]) == set(jrep["device_stats"])
    assert rep["world"] == 1 and jrep["world"] == 8


def test_fused_resnet18_cluster_answers_match_jax_cluster():
    variables = jax_resnet18_variables(num_filters=8, seed=2)
    jm = jax_build("resnet18", num_filters=8, fused_stages=FUSED)
    reqs = _requests(6, seed=3, sizes=(1, 2))
    theirs, _ = _serve_all(_jcluster(
        jm, variables["params"], batch_stats=variables["batch_stats"],
        buckets=(2,)), reqs)
    port = load_jax_variables(build_model("resnet18", num_filters=8,
                                          fused_stages=FUSED), variables)
    mine, rep = _serve_all(_cluster(port, buckets=(2,)), reqs)
    assert rep["retraces"] == 0
    # JAX's logits of every request, for the decided-margin rule.
    from tpu_dp.train.state import TrainState
    from tpu_dp.train.step import _infer_forward

    state = TrainState(step=np.zeros((), np.int32),
                       params=variables["params"], opt_state={},
                       batch_stats=variables["batch_stats"])
    images = np.concatenate(reqs)
    logits, _ = _infer_forward(jm, state, {"image": images})
    logits = np.asarray(logits, np.float32)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2e-2 * np.abs(logits).max()
    assert decided.sum() >= len(decided) // 2
    got = np.concatenate([h.predictions for h in mine])
    want = np.concatenate([h.predictions for h in theirs])
    np.testing.assert_array_equal(got[decided], want[decided])
    np.testing.assert_allclose(
        np.concatenate([h.confidence for h in mine]),
        np.concatenate([h.confidence for h in theirs]), rtol=0, atol=1e-2)


def test_class_mix_books_consistent_in_both_packages(net_vars):
    model, v = net_vars
    from tpu_dp.serve import run_load as jrun_load

    kw = dict(n_requests=60, pattern="poisson", rate_rps=600.0,
              sizes=(1, 2, 3), seed=1, class_mix=(0.6, 0.4))
    slo = {0: 5000.0, 1: 8000.0}
    jc = _jcluster(model, v["params"], class_slo_ms=slo)
    with jc:
        jrep = jrun_load(jc, **kw)
    c = _cluster(_port_net(v), class_slo_ms=slo)
    with c:
        rep = run_load(c, **kw)
    for r in (rep, jrep):
        truth = r["ground_truth"]
        assert r["consistent"], (truth, r["counters"])
        assert truth["completed"] == truth["accepted"] == 60
        assert r["device_stats"]["served"] == truth["images_served"]
        assert sum(x["batches"] for x in r["replicas"].values()) \
            == r["batches"]
    assert rep["ground_truth"]["by_class"] == jrep["ground_truth"][
        "by_class"]
    assert rep["classes"].keys() == jrep["classes"].keys()
    assert {k: v["slo_ms"] for k, v in rep["classes"].items()} == {
        k: v["slo_ms"] for k, v in jrep["classes"].items()}


# -- drain / swap / rejoin, the ledger and the post-hoc tools ---------------

def _chaos(cluster, swap, tmp):
    """The JAX package's chaos matrix in process: 150 burst requests, a
    drain of replica 1 at 25, a swap at 60, a rejoin at 100, the flight
    recorder dumped into the run directory."""
    recorder = _recorder_of(cluster)
    recorder.reset()
    recorder.configure(rank=0, dump_dir=os.path.join(tmp, "obs"),
                       fresh=True, run={"kind": "serve-test"})

    def rejoin():
        assert _wait_for(lambda: cluster.replicas[1].status == "left")
        cluster.rejoin(1)

    try:
        with cluster:
            report = _run_load_of(cluster)(
                cluster, n_requests=150, pattern="burst", burst=10,
                rate_rps=500.0, sizes=(1, 2), seed=4, class_mix=(0.7, 0.3),
                events=[(25, "drain", lambda: cluster.drain(1)),
                        (60, "swap", swap), (100, "rejoin", rejoin)])
        recorder.dump(reason="test_exit")
    finally:
        recorder.reset()
    return report


def _recorder_of(cluster):
    if isinstance(cluster, JCluster):
        from tpu_dp.obs import flightrec
    else:
        from tpu_dp_torch.obs import flightrec
    return flightrec.recorder


def _run_load_of(cluster):
    if isinstance(cluster, JCluster):
        from tpu_dp.serve import run_load as jrun_load

        return jrun_load
    return run_load


def _epochs(run_dir):
    led = os.path.join(run_dir, "membership", "serve")
    out = []
    for name in sorted(os.listdir(led)):
        if name.startswith("epoch_"):
            with open(os.path.join(led, name), encoding="utf-8") as f:
                rec = json.load(f)
            rec.pop("ts", None)
            out.append(rec)
    return out


@pytest.fixture(scope="module")
def chaos_runs(net_vars, tmp_path_factory):
    model, v = net_vars
    fresh = model.init(jax.random.PRNGKey(11),
                       np.zeros((1, 32, 32, 3), np.float32), train=False)
    jdir = str(tmp_path_factory.mktemp("jchaos"))
    jc = _jcluster(model, v["params"], run_dir=jdir)
    jrep = _chaos(jc, lambda: jc.swap_model(fresh["params"]), jdir)
    pdir = str(tmp_path_factory.mktemp("pchaos"))
    pc = _cluster(_port_net(v), run_dir=pdir)
    new_state = convert_variables(fresh)
    rep = _chaos(pc, lambda: pc.swap_model(new_state), pdir)
    return {"jax": (jrep, jdir), "port": (rep, pdir), "fresh": fresh,
            "cluster": pc}


def test_chaos_matrix_books_and_versions(chaos_runs):
    for rep, _ in (chaos_runs["jax"], chaos_runs["port"]):
        truth = rep["ground_truth"]
        assert rep["consistent"], (truth, rep["counters"])
        assert truth["unresolved"] == 0
        assert rep["retraces"] == 0
        assert set(truth["served_by_version"]) == {"1", "2"}
        assert sum(truth["served_by_version"].values()) == truth["completed"]
        assert rep["model_version"] == 2
        assert rep["membership_epoch"] == 2


def test_chaos_membership_records_equal_jax(chaos_runs):
    mine = _epochs(chaos_runs["port"][1])
    theirs = _epochs(chaos_runs["jax"][1])
    assert [e["members"] for e in mine] == [[0, 1], [0], [0, 1]]
    assert mine == theirs


def test_jax_and_port_timelines_read_the_port_run(chaos_runs):
    from tpu_dp.obs.obsctl import RunArtifacts as JArt
    from tpu_dp.obs.obsctl import build_timeline as jbuild
    from tpu_dp_torch.obs.obsctl import RunArtifacts, build_timeline

    run_dir = chaos_runs["port"][1]
    for kinds in ([e["kind"] for e in jbuild(JArt(run_dir))["events"]],
                  [e["kind"] for e in build_timeline(
                      RunArtifacts(run_dir))["events"]]):
        for expected in ("membership_formed", "serve_dispatch",
                         "replica_drain", "eviction", "model_swap",
                         "replica_rejoin", "membership_epoch"):
            assert expected in kinds, (expected, sorted(set(kinds)))
        assert kinds.index("replica_drain") < kinds.index("replica_rejoin")


def test_fleet_streams_read_by_jax_aggregator(chaos_runs):
    from tpu_dp.obs import fleet as jfleet
    from tpu_dp_torch.obs import fleet

    run_dir = chaos_runs["port"][1]
    kinds = sorted(k for k, _, _ in jfleet.discover_streams(run_dir))
    assert kinds.count("replica") == 2 and "router" in kinds
    theirs = jfleet.FleetAggregator(run_dir).replay()
    assert theirs and theirs == fleet.FleetAggregator(run_dir).replay()


def test_swapped_weights_are_the_fresh_models(chaos_runs):
    """After the chaos matrix every replica (the drained and rejoined one
    too) holds the swapped-in weights."""
    fresh = _port_net(chaos_runs["fresh"])
    cluster = chaos_runs["cluster"]
    assert cluster.model_version == 2
    for r in cluster.replicas:
        assert r.model_version == 2
        for k, t in fresh.state_dict().items():
            assert torch.equal(r.model.state_dict()[k], t), k


@pytest.mark.parametrize("name", ["net", "resnet18"])
def test_hot_swap_serves_the_new_weights(name):
    """Predictions after a swap equal those of a fresh model holding the
    new weights, bit for bit (the fused model's packed kernel weights
    are refreshed in place, as a captured graph reads them)."""
    kw = {} if name == "net" else {"num_filters": 8,
                                   "fused_stages": FUSED}
    old = build_model(name, generator=torch.Generator().manual_seed(0), **kw)
    new = build_model(name, generator=torch.Generator().manual_seed(1), **kw)
    cluster = _cluster(old)
    reqs = _requests(8, seed=5, sizes=(1, 2))
    with cluster:
        before = [cluster.submit(r) for r in reqs]
        assert all(h.wait(60) for h in before)
        cluster.swap_model(new.state_dict())
        after = [cluster.submit(r) for r in reqs]
        assert all(h.wait(60) for h in after)
    from tpu_dp_torch.train.step import _maybe_normalize

    with torch.inference_mode():
        for reqs_, handles, ref, v in ((reqs, before, old, 1),
                                       (reqs, after, new, 2)):
            ref = ref.eval()
            for images, h in zip(reqs_, handles):
                assert h.model_version == v
                logits = ref(_maybe_normalize(torch.from_numpy(images)))
                np.testing.assert_array_equal(
                    h.predictions, torch.argmax(logits, -1).numpy())
    # Each replica serves its own copy: the caller's module is untouched.
    assert all(r.model is not old for r in cluster.replicas)
    assert cluster.replicas[0].model is not cluster.replicas[1].model


# -- failure, quarantine, SIGTERM -------------------------------------------

def test_all_replicas_dead_sheds_typed_and_stop_raises(net_vars):
    model, v = net_vars
    messages = []
    for cluster in (_cluster(_port_net(v), max_retries=0),
                    _jcluster(model, v["params"], max_retries=0)):
        cluster.start()
        for r in cluster.replicas:
            _poison(r, "tier wipeout")
        handles = [cluster.submit(np.zeros((1, 32, 32, 3), np.uint8))
                   for _ in range(6)]
        assert _wait_for(
            lambda: all(r.status == "dead" for r in cluster.replicas))
        for h in handles:
            assert h.wait(10.0)
            assert not h.ok and h.shed_reason == "replica_failed"
        with pytest.raises(RuntimeError) as e:
            cluster.stop()
        messages.append(str(e.value))
    assert messages[0] == messages[1] == "all 2 serve replicas failed"


def test_failover_retries_a_dead_replicas_batch(net_vars):
    _, v = net_vars
    cluster = _cluster(_port_net(v), fault="delay:step=2,ms=300,rank=0",
                       stale_after_s=30.0, max_retries=1)
    cluster.start()
    _poison(cluster.replicas[1], "injected replica death")
    report = run_load(cluster, n_requests=60, pattern="poisson",
                      rate_rps=400.0, sizes=(1, 2), seed=3)
    cluster.stop()  # must NOT raise: the survivor absorbed the failure
    truth = report["ground_truth"]
    assert report["replicas"]["1"]["status"] == "dead"
    assert "injected replica death" in report["replica_errors"][0]["error"]
    assert report["counters"].get("serve.failover.retried", 0) >= 1
    assert report["consistent"], (truth, report["counters"])
    assert set(truth["shed_by_reason"]) <= {"replica_failed"}
    assert truth["completed"] + truth["shed"] == 60
    assert report["device_stats"]["served"] == truth["images_served"]


def test_wedged_replica_quarantined_then_restored(net_vars, tmp_path):
    _, v = net_vars
    cluster = _cluster(_port_net(v), run_dir=str(tmp_path),
                       stale_after_s=0.25,
                       fault="delay:step=0,ms=1200,rank=0")
    with cluster:
        handles = []
        deadline = time.monotonic() + 8.0
        while time.monotonic() < deadline and \
                not cluster.replicas[0].quarantined:
            handles.append(
                cluster.submit(np.zeros((1, 32, 32, 3), np.uint8)))
            time.sleep(0.02)
        assert cluster.replicas[0].quarantined
        snap = cluster._counters.snapshot()
        assert snap.get("serve.replica_quarantine_events", 0) >= 1
        assert snap.get("serve.replica_health.0") == 0.0
        assert _wait_for(lambda: not cluster.replicas[0].quarantined)
        for h in handles:
            assert h.wait(30.0) and h.ok
    assert cluster._counters.snapshot().get("serve.replica_health.0") == 1.0
    assert (tmp_path / "obs" / "heartbeat_r00000.jsonl").exists()
    assert (tmp_path / "obs" / "heartbeat_r00001.jsonl").exists()


def test_sigterm_drains_one_replica(net_vars):
    _, v = net_vars
    cluster = _cluster(_port_net(v))
    cluster.install_sigterm_drain(sid=1)
    try:
        with cluster:
            h = cluster.submit(np.zeros((1, 32, 32, 3), np.uint8))
            assert h.wait(30.0) and h.ok
            os.kill(os.getpid(), signal.SIGTERM)
            assert _wait_for(lambda: cluster.replicas[1].status == "left")
            h2 = cluster.submit(np.zeros((1, 32, 32, 3), np.uint8))
            assert h2.wait(30.0) and h2.ok and h2.served_by == 0
    finally:
        cluster.restore_sigterm()
    assert cluster._counters.snapshot().get("preempt.signals", 0) >= 1


# -- the pieces against the JAX functions -----------------------------------

def test_cluster_from_serve_config_matches_jax(net_vars):
    from tpu_dp.config import ServeConfig as JServeConfig
    from tpu_dp_torch.config import ServeConfig

    model, v = net_vars
    fields = dict(replicas=2, buckets="1,2", slo_ms=99.0,
                  class_slo_ms="99,200", stale_after_s=1.25, max_retries=3,
                  max_queue=17, shed_headroom_ms=2.0)
    mine = ServeCluster.from_serve_config(
        _port_net(v), ServeConfig(**fields), devices=["cpu", "cpu"])
    theirs = JCluster.from_serve_config(model, v["params"],
                                        JServeConfig(**fields))
    for c in (mine, theirs):
        assert c.n_replicas == 2 and c.ladder.buckets == (1, 2)
        assert c.class_slo_ms == {0: 99.0, 1: 200.0}
        assert (c.stale_after_s, c.max_retries, c.slo_ms) == (
            1.25, 3, 99.0)
        assert (c.queue.max_depth, c.queue.shed_headroom_ms) == (17, 2.0)
    assert sorted(f.name for f in __import__("dataclasses").fields(
        ServeConfig)) == sorted(f.name for f in __import__(
            "dataclasses").fields(JServeConfig))


@pytest.mark.parametrize("spec", [
    "delay:step=3,ms=500,rank=0;leave:step=5,rank=1",
    "leave:step=2", "kill:step=4,rank=1; preempt:step=9",
    "", "delay:step=0,ms=1200,rank=0"])
@pytest.mark.parametrize("rank", [0, 1])
def test_parse_fault_specs_matches_jax(spec, rank, monkeypatch):
    from tpu_dp.serve.replica import parse_fault_specs as jparse
    from tpu_dp_torch.serve import parse_fault_specs

    monkeypatch.delenv("TPU_DP_FAULT", raising=False)
    mine, theirs = parse_fault_specs(spec, rank), jparse(spec, rank)
    assert [(i.rank, [p.__dict__ for p in i.plans]) for i in mine] == [
        (i.rank, [p.__dict__ for p in i.plans]) for i in theirs]


@pytest.mark.parametrize("model_name", ["net", "resnet18", "resnet50"])
@pytest.mark.parametrize("world", [1, 4])
def test_register_serve_costs_matches_jax(model_name, world):
    from tpu_dp.obs import costs as jcosts
    from tpu_dp.serve.batcher import BucketLadder as JLadder
    from tpu_dp.serve.engine import register_serve_costs as jreg
    from tpu_dp_torch.obs import costs
    from tpu_dp_torch.serve import BucketLadder, register_serve_costs

    jcosts.registry.reset()
    costs.registry.reset()
    try:
        mine = register_serve_costs(BucketLadder((1, 2, 4, 8)), world,
                                    model_name=model_name)
        theirs = jreg(JLadder((1, 2, 4, 8)), world, model_name=model_name)
        assert mine == theirs
        assert costs.serve_flops_per_image(model_name) == \
            jcosts.serve_flops_per_image(model_name)
        for b in (1, 2, 4, 8):
            a = costs.registry.get(f"serve_step@b{b}")
            t = jcosts.registry.get(f"serve_step@b{b}")
            assert (a is None) == (t is None)
            if a is not None:
                assert (a.flops_per_step_per_chip, a.source, a.check) == (
                    t.flops_per_step_per_chip, t.source, t.check)
    finally:
        jcosts.registry.reset()
        costs.registry.reset()


def test_serve_report_core_matches_jax():
    from tpu_dp.obs.counters import Counters as JCounters
    from tpu_dp.obs.spans import SpanRecorder as JRecorder
    from tpu_dp.serve.replica import LatencyBook as JBook
    from tpu_dp.serve.replica import serve_report_core as jcore
    from tpu_dp_torch.obs.spans import SpanRecorder
    from tpu_dp_torch.serve import LatencyBook, serve_report_core

    rng = np.random.default_rng(0)
    built = []
    for rec_cls, book_cls, reg_cls in ((SpanRecorder, LatencyBook, Counters),
                                       (JRecorder, JBook, JCounters)):
        rec, book, reg = rec_cls(capacity=64), book_cls(64), reg_cls()
        built.append((rec, book, reg))
    for i in range(40):
        spans = {k: float(rng.uniform(0.1, 9.0)) for k in (
            "queue_wait", "batch_form", "h2d", "device", "d2h")}
        spans["total"] = sum(spans.values())
        cls = int(rng.integers(0, 3))
        for rec, book, reg in built:
            rec.record(i, dict(spans), ts=1000.0 + i)
            book.note(cls, spans["total"])
            reg.inc("serve.completed")
            reg.gauge("serve.batch_occupancy", 0.5)
    slo = {0: 10.0, 1: 20.0}
    mine = serve_report_core(*built[0][:2], threading.Lock(), slo, 25.0,
                             built[0][2])
    theirs = jcore(*built[1][:2], threading.Lock(), slo, 25.0, built[1][2])
    assert json.loads(json.dumps(mine)) == json.loads(json.dumps(theirs))


def test_replica_devices_rule():
    from tpu_dp_torch.serve.router import replica_devices

    if not torch.cuda.is_available():
        with pytest.raises(ValueError,
                           match="2 replicas need at least 2 devices, "
                                 "have 0"):
            replica_devices(2)
    assert replica_devices(2, ["cpu"] * 3) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        replica_devices(0, ["cpu"])
    with pytest.raises(ValueError, match="3 replicas need at least 3"):
        replica_devices(3, ["cpu", "cpu"])


@pytest.mark.parametrize("module,args", [
    ("conv_block", ("eval",)), ("xent", ("forward",)), ("augment", ())])
def test_launch_books_exact_under_threads(module, args):
    import importlib

    mod = importlib.import_module(f"tpu_dp_torch.ops.{module}")
    mod.reset_launches()
    n = 20000

    def bump():
        for _ in range(n):
            mod.count_launch(*args)

    threads = [threading.Thread(target=bump) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        got = (mod.launches[args[0]] if module == "xent" else mod.launches)
        assert got == 2 * n
        if module == "conv_block":
            assert mod.launches_by_role["eval"] == 2 * n
    finally:
        mod.reset_launches()


# -- the engine's seams: config, heartbeats, profiler window, leave ---------

def test_engine_profile_batches_needs_a_dir_with_the_jax_message(net_vars):
    from tpu_dp.config import ServeConfig as JServeConfig
    from tpu_dp.serve import InferenceEngine as JEngine
    from tpu_dp_torch.config import ServeConfig
    from tpu_dp_torch.serve import InferenceEngine

    model, v = net_vars
    msgs = []
    with pytest.raises(ValueError) as e:
        InferenceEngine.from_serve_config(
            _port_net(v), ServeConfig(profile_batches="0:2"), device="cpu")
    msgs.append(str(e.value))
    with pytest.raises(ValueError) as e:
        JEngine.from_serve_config(model, v["params"],
                                  JServeConfig(profile_batches="0:2"))
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_engine_heartbeats_and_profile_window(net_vars, tmp_path):
    """``serve.obs_dir`` beats once per batch; ``serve.profile_batches``
    traces the batch range into ``<profile_dir>/r0`` with flight-recorder
    ``profile_start`` / ``profile_stop`` events labelled ``serve_r0``."""
    from tpu_dp_torch.config import ServeConfig
    from tpu_dp_torch.obs import flightrec
    from tpu_dp_torch.serve import InferenceEngine

    _, v = net_vars
    cfg = ServeConfig(buckets="1,2", obs_dir=str(tmp_path / "obs"),
                      profile_batches="1:3",
                      profile_dir=str(tmp_path / "prof"), slo_ms=60_000.0)
    engine = InferenceEngine.from_serve_config(
        _port_net(v), cfg, device="cpu", registry=Counters())
    flightrec.recorder.reset()
    try:
        with engine:
            for _ in range(5):
                h = engine.submit(np.zeros((1, 32, 32, 3), np.uint8))
                assert h.wait(60) and h.ok
        events = [e for e in flightrec.recorder.events()
                  if e.get("label") == "serve_r0"]
    finally:
        flightrec.recorder.reset()
    beats = (tmp_path / "obs" / "heartbeat_r00000.jsonl").read_text()
    assert len(beats.splitlines()) == 5
    assert (tmp_path / "prof" / "r0" / "trace_r00000.json").exists()
    assert [e["kind"] for e in events] == ["profile_start", "profile_stop"]
    assert (events[0]["start_step"], events[0]["end_step"]) == (1, 3)


def test_engine_leave_fault_closes_the_queue(net_vars):
    """A ``leave:`` on the single engine closes admission and serves out
    the queue: nobody absorbs its share, nothing is abandoned."""
    from tpu_dp_torch.serve import InferenceEngine, ShedError

    _, v = net_vars
    engine = InferenceEngine(_port_net(v), device="cpu", buckets=(1,),
                             slo_ms=60_000.0, fault="leave:step=2",
                             registry=Counters())
    with engine:
        for _ in range(2):
            h = engine.submit(np.zeros((1, 32, 32, 3), np.uint8))
            assert h.wait(60) and h.ok
        assert _wait_for(lambda: engine.queue.closed)
        with pytest.raises(ShedError, match="closed"):
            engine.submit(np.zeros((1, 32, 32, 3), np.uint8))
    assert engine.replica.status == "stopped"
    assert engine.report()["counters"]["serve.shed.closed"] == 1
