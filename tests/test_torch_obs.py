"""The port's telemetry modules (`tpu_dp_torch.obs`, `tpu_dp_torch.metrics`,
`tpu_dp_torch.utils.profiling`) against the JAX package's on the same
inputs:

- the Prometheus text (render, write, parse round trip) and the Perfetto
  trace events (rollback generations as their own track groups, counter
  points, instant events, merged traces, validation) equal the JAX
  package's, byte for byte;
- span percentiles and rollups, `CostRegistry.mfu`, `EfficiencyMeter`,
  `goodput` and `resolve_flops_per_step` agree to 1e-12 relative;
- the chip registry resolves the three H100 names to the data sheet's
  dense bf16 peaks and returns None for a TPU and the CPU;
- heartbeats written by either package are read by the other's
  `HealthMonitor`, and both flag the same stragglers and stale ranks;
- `FlopCounterMode`'s count of a narrow ResNet-18 step (the plain path)
  lies within `FLOPS_CHECK_RTOL` of the analytic count scaled to its
  width;
- `StepProfiler` arms and stops on the JAX profiler's windows;
- `Accuracy` and `Mean` behave as the JAX package's.
"""

from __future__ import annotations

import json
import math
import random
import time

import numpy as np
import pytest
import torch

from tpu_dp import metrics as jax_metrics
from tpu_dp.obs import chips as jax_chips
from tpu_dp.obs import costs as jax_costs
from tpu_dp.obs import export as jax_export
from tpu_dp.obs import health as jax_health
from tpu_dp.obs import promfile as jax_prom
from tpu_dp.obs import spans as jax_spans
from tpu_dp.obs.counters import Counters as JaxCounters
from tpu_dp.utils import profiling as jax_profiling
from tpu_dp_torch import metrics
from tpu_dp_torch.models import build_model
from tpu_dp_torch.obs import chips, costs, export, health, promfile, spans
from tpu_dp_torch.obs import flightrec
from tpu_dp_torch.obs.counters import Counters, update_device_memory_gauges
from tpu_dp_torch.utils import profiling

pytestmark = pytest.mark.port

torch.set_num_threads(2)


def _registries(seed: int):
    """The same seeded counters and gauges in a port and a JAX registry."""
    rng = np.random.default_rng(seed)
    mine, theirs = Counters(), JaxCounters()
    names = ["guard.quarantined", "retry.attempts", "snapshot.write_s",
             "quant.overflow", "ckpt.write_errors"]
    for name in names:
        for _ in range(int(rng.integers(1, 4))):
            v = float(rng.uniform(0, 10))
            mine.inc(name, v)
            theirs.inc(name, v)
    for name in ("obs.mfu", "obs.goodput", "obs.step_time_ms",
                 "device.mem_in_use_bytes.0", "throughput.images_per_sec"):
        v = float(rng.uniform(0, 2e9))
        mine.gauge(name, v)
        theirs.gauge(name, v)
    return mine, theirs


def _span_records(seed: int, gens=(0, 1, 2)):
    """Per-window span records, as both recorders split them, with a
    guard rollback between generations."""
    rng = np.random.default_rng(seed)
    mine, theirs = spans.SpanRecorder(64), jax_spans.SpanRecorder(64)
    step, ts = 1, 1.7e9
    for gen in gens:
        for _ in range(3):
            n = int(rng.integers(1, 5))
            window = {"data_wait": float(rng.uniform(0, 5)),
                      "dispatch": float(rng.uniform(0, 50))}
            if rng.uniform() < 0.5:
                window.update(h2d=float(rng.uniform(0, 1)),
                              device=float(rng.uniform(1, 200)))
            for rec in (mine, theirs):
                rec.record_window(step, n, window, ts=ts, gen=gen)
            step, ts = step + n, ts + 0.25
        if gen != gens[-1]:
            step -= 3  # the rollback rewinds the clock
            for rec in (mine, theirs):
                rec.record_window(step, 1, {"guard_rollback": 0.0},
                                  gen=gen + 1, ts=ts)
    return mine, theirs


@pytest.mark.parametrize("seed", range(3))
def test_prometheus_text_and_round_trip_equal_the_jax_package(tmp_path,
                                                              seed):
    mine, theirs = _registries(seed)
    labels = {"rank": str(seed), "job name": "dp"}
    text = promfile.render_prom(*mine.snapshot_typed(), labels=labels)
    assert text == jax_prom.render_prom(*theirs.snapshot_typed(),
                                        labels=labels)
    out = promfile.write_promfile(tmp_path / "m.prom", mine, labels=labels)
    jax_prom.write_promfile(tmp_path / "j.prom", theirs, labels=labels)
    assert out.read_text() == (tmp_path / "j.prom").read_text()
    parsed = promfile.parse_promfile(out.read_text())
    assert parsed == jax_prom.parse_promfile(text)
    counts, gauges = mine.snapshot_typed()
    assert {k: v["type"] for k, v in parsed.items()} == {
        **{f"tpu_dp_{k.replace('.', '_')}": "counter" for k in counts},
        **{f"tpu_dp_{k.replace('.', '_')}": "gauge" for k in gauges}}
    for rec in parsed.values():
        (value,) = rec["samples"].values()
        assert math.isfinite(value)
    assert promfile.render_prom({}, {}) == jax_prom.render_prom({}, {}) == ""


@pytest.mark.parametrize("gens", [(0,), (0, 1), (0, 1, 2)])
def test_perfetto_trace_equals_the_jax_package(tmp_path, gens):
    mine, theirs = _span_records(len(gens), gens)
    assert mine.records() == theirs.records()
    points = [{"ts": 1.7e9 + 3, "counters": {"obs.mfu": 0.25, "x": "str",
                                             "guard.rollbacks": 2}}]
    got = export.to_trace_events(mine.records(), rank=3,
                                 counter_points=points)
    want = jax_export.to_trace_events(theirs.records(), rank=3,
                                      counter_points=points)
    assert got == want
    assert export.validate_trace(got) == [] == jax_export.validate_trace(want)
    tids = {(e["name"], e["args"].get("gen", 0)) for e in got["traceEvents"]
            if e["ph"] == "X"}
    assert {g for _, g in tids} == set(gens)
    mark = export.instant_event("rollback", 1.7e9, pid=3, args={"gen": 1})
    assert mark == jax_export.instant_event("rollback", 1.7e9, pid=3,
                                            args={"gen": 1})
    merged = export.merge_traces([got, {"traceEvents": [mark]}])
    assert merged == jax_export.merge_traces([want,
                                              {"traceEvents": [mark]}])
    path = export.export_perfetto(tmp_path / "t.json", mine.records(),
                                  rank=3, counter_points=points)
    assert json.loads(path.read_text()) == got
    bad = {"traceEvents": [{"ph": "X", "name": "a", "ts": -1, "dur": 1,
                            "pid": 0, "tid": "x"}, {"ph": "?"}]}
    assert export.validate_trace(bad) == jax_export.validate_trace(bad)
    assert export.validate_trace([]) == jax_export.validate_trace([])
    with pytest.raises(ValueError, match="invalid trace"):
        export.write_trace(tmp_path / "bad.json", bad)


@pytest.mark.parametrize("seed", range(4))
def test_percentiles_and_rollups_equal_the_jax_package(seed):
    rng = random.Random(seed)
    values = sorted(rng.uniform(0, 100) for _ in range(rng.randint(1, 40)))
    for q in (0, 1, 50, 95, 99, 100):
        assert spans.percentile(values, q) == jax_spans.percentile(values, q)
    for fn in (spans.percentile, jax_spans.percentile):
        with pytest.raises(ValueError, match="empty"):
            fn([], 50)
    mine, theirs = _span_records(seed)
    assert mine.rollup() == theirs.rollup()
    assert mine.rollup(["dispatch"]) == theirs.rollup(["dispatch"])


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("model,batch", [("resnet18", 128), ("resnet50", 32),
                                         ("net", 4)])
def test_costs_agree_with_the_jax_package(model, batch):
    rng = np.random.default_rng(batch)
    mine, theirs = costs.CostRegistry(), jax_costs.CostRegistry()
    a = mine.register_analytic("train_step", model, batch)
    b = theirs.register_analytic("train_step", model, batch)
    assert (a is None) == (b is None)
    if a is None:  # no analytic yardstick: a measured count instead
        for reg in (mine, theirs):
            reg.register("train_step", 1.3e7 * batch, source="w1_step",
                         check="unchecked")
    for reg in (mine, theirs):
        reg.alias("multi_step", "train_step")
        # A later analytic estimate never overwrites a measured entry.
        reg.register("m", 5.0, source="w1_step_cost_analysis")
        reg.register("m", 7.0)
    assert mine.get("m").flops_per_step_per_chip == 5.0
    assert mine.tags() == theirs.tags()
    peak = 989.4e12
    for _ in range(20):
        n, wall = int(rng.integers(1, 30)), float(rng.uniform(1e-3, 5.0))
        assert _close(mine.mfu("multi_step", n, wall, peak),
                      theirs.mfu("multi_step", n, wall, peak))
    assert mine.mfu("nope", 1, 1.0, peak) is None
    assert mine.mfu("multi_step", 1, 1.0, None) is None
    em = costs.EfficiencyMeter(mine, peak=peak, capacity=8)
    ej = jax_costs.EfficiencyMeter(theirs, peak=peak, capacity=8)
    assert em.rollup() is None is ej.rollup()
    for _ in range(12):
        n = int(rng.integers(1, 11))
        wall, wait = float(rng.uniform(1, 500)), float(rng.uniform(0, 20))
        tag = "multi_step" if rng.uniform() < 0.7 else "unknown"
        assert em.observe(tag, n, wall, wait) == ej.observe(tag, n, wall,
                                                            wait)
    got, want = em.rollup(), ej.rollup()
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            assert all(_close(got[k][s], v[s]) for s in v)
        else:
            assert _close(float(got[k]), float(v))
    for wait, wall in ((0.0, 10.0), (3.0, 10.0), (20.0, 10.0), (1.0, 0.0)):
        assert costs.goodput(wait, wall) == jax_costs.goodput(wait, wall)
    per_image = costs.train_flops_per_image(model)
    assert per_image == jax_costs.train_flops_per_image(model)
    cases = [(None, 3.3e9 * batch, 1), (None, 9e9 * batch, 1),
             (3.1e9 * batch * 10, None, 10), (3.1e9 * batch, None, 10),
             (None, None, 1)]
    for program, step, window in cases:
        r = costs.resolve_flops_per_step(program, step, window, batch,
                                         per_image)
        j = jax_costs.resolve_flops_per_step(program, step, window, batch,
                                             per_image)
        assert r[1:] == j[1:]
        assert (r[0] is None and j[0] is None) or _close(r[0], j[0])
    assert costs.FLOPS_CHECK_RTOL == jax_costs.FLOPS_CHECK_RTOL
    assert costs.MODEL_TRAIN_FLOPS_PER_IMAGE == \
        jax_costs.MODEL_TRAIN_FLOPS_PER_IMAGE


@pytest.mark.parametrize("name,peak,hbm,link", [
    ("NVIDIA H100 80GB HBM3", 989.4e12, 3350.0, 900.0),
    ("NVIDIA H100 PCIe", 756e12, 2000.0, 600.0),
    ("NVIDIA H100 NVL", 835e12, 3900.0, 600.0),
    ("TPU v5 lite", None, None, None),
    ("cpu", None, None, None)])
def test_chip_registry_resolves_h100s_and_nothing_else(name, peak, hbm,
                                                      link):
    assert chips.peak_flops(name) == costs.peak_flops(name) == peak
    assert chips.hbm_gbs(name) == hbm
    assert chips.link_gbs(name) == link
    # The port holds NVIDIA cards only: a TPU's name finds no entry there
    # while the JAX package's registry knows it.
    if "TPU" in name:
        assert jax_chips.peak_flops(name) is not None
    assert all("h100" in sub for sub, _ in chips.CHIP_SPECS)


def _write_stream(writer_cls, run_dir, world, slow, dead, base):
    """Beats of ``world`` ranks over steps 1..6 (one writer per rank):
    20 ms a step, rank ``slow`` 150 ms at step 4; rank ``dead`` stops after
    step 2."""
    for rank in range(world):
        with writer_cls(run_dir, rank=rank) as hb:
            for step in range(1, 7):
                if rank == dead and step > 2:
                    break
                ms = 150.0 if (rank, step) == (slow, 4) else 20.0
                hb.beat(step, ms, ts=base + step)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_heartbeats_cross_read_and_flag_the_same_ranks(tmp_path, writer):
    base = time.time()
    writer_cls = (health.HeartbeatWriter if writer == "port"
                  else jax_health.HeartbeatWriter)
    _write_stream(writer_cls, tmp_path, world=4, slow=1, dead=3, base=base)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"heartbeat_r{r:05d}.jsonl" for r in range(4)]
    kw = dict(world=5, straggler_factor=3.0, stale_after_s=30.0)
    mine = health.HealthMonitor(tmp_path, **kw)
    theirs = jax_health.HealthMonitor(tmp_path, **kw)
    assert mine.read_beats() == theirs.read_beats()
    assert mine.latest() == theirs.latest()
    # 35 s on: ranks 0-2 beat 29 s ago, rank 3 (stopped after step 2) 33 s
    # ago, rank 4 never, past the 30 s startup grace.
    now = base + 35

    def as_dicts(issues):
        return [{f: getattr(i, f) for f in i.__dataclass_fields__}
                for i in issues]

    live = mine.check(now=now)
    assert as_dicts(live) == as_dicts(theirs.check(now=now))
    assert [(i.kind, i.rank) for i in live] == [("missing", 4),
                                                ("stale", 3)]
    scan = mine.scan()
    assert as_dicts(scan) == as_dicts(theirs.scan())
    assert [(i.kind, i.rank, i.step) for i in scan] == [("straggler", 1, 4)]
    assert [i.describe() for i in scan] == [i.describe()
                                            for i in theirs.scan()]
    logged = []
    health.HealthMonitor(tmp_path, world=4, logger=logged.append).report(scan)
    assert logged == [scan[0].describe()]
    with pytest.raises(health.HealthError) as err:
        health.HealthMonitor(tmp_path, world=4, on_flag="raise").report(scan)
    assert err.value.issues == tuple(scan)
    for bad in (dict(on_flag="page"), dict(straggler_factor=1.0)):
        with pytest.raises(ValueError):
            health.HealthMonitor(tmp_path, world=4, **bad)


def test_heartbeat_rewind_and_the_hang_dump_request(tmp_path):
    for cls in (health.HeartbeatWriter, jax_health.HeartbeatWriter):
        d = tmp_path / cls.__module__.split(".")[0]
        with cls(d, rank=0, every_steps=2) as hb:
            assert [hb.beat(s, 1.0, ts=float(s)) for s in range(1, 6)] == [
                True, True, False, True, False]
            hb.rewind(2)
            assert hb.beat(3, 1.0, ts=9.0)
    a = (tmp_path / "tpu_dp_torch" / "heartbeat_r00000.jsonl").read_text()
    b = (tmp_path / "tpu_dp" / "heartbeat_r00000.jsonl").read_text()
    assert a == b
    assert json.loads(a.splitlines()[-1])["gen"] == 1
    mon = health.HealthMonitor(tmp_path / "tpu_dp_torch", world=1)
    stale = mon.check(now=1000.0)
    assert [i.kind for i in stale] == ["stale"]
    path = mon.request_dump(stale, dump_dir=tmp_path / "dump")
    assert path.name == flightrec.DUMP_REQUEST
    assert "heartbeat stale" in json.loads(path.read_text())["reason"]
    assert mon.request_dump([]) is None


def test_flop_counter_count_of_a_narrow_resnet18_step():
    width, batch = 16, 4
    model = build_model("resnet18", num_classes=10, num_filters=width,
                        generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = costs.count_train_flops(model, torch.empty(batch, 32, 32, 3),
                                  torch.empty(batch, dtype=torch.int64))
    # The model is left as it was, on the CPU.
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())
    analytic = (costs.train_flops_per_image("resnet18") * (width / 64) ** 2
                * batch)
    ratio = got / analytic
    assert 1 / costs.FLOPS_CHECK_RTOL <= ratio <= costs.FLOPS_CHECK_RTOL
    flops, source, check = costs.resolve_flops_per_step(
        None, got, 1, batch, analytic / batch)
    assert (flops, source, check) == jax_costs.resolve_flops_per_step(
        None, got, 1, batch, analytic / batch)
    assert check == "ok"


_PROFILE_CASES = [(2, 3), (0, 1), (3, 9), (4, 8), (5, 6), (9, 30), (40, 50)]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("start,end", _PROFILE_CASES)
def test_step_profiler_arms_on_the_jax_profilers_windows(k, start, end):
    """Windows of ``k`` over 20 steps (a trailing single when k does not
    divide), then a resumed second pass; the trace arms and stops at the
    same boundaries as the JAX profiler's, once."""
    events = {"port": [], "jax": []}
    profs = {}
    for tag, cls in (("port", profiling.StepProfiler),
                     ("jax", jax_profiling.StepProfiler)):
        log = events[tag]
        profs[tag] = cls("d", start, end,
                         start_fn=lambda d, log=log: log.append("start"),
                         stop_fn=lambda log=log: log.append("stop"))
    for _ in range(2):  # the second pass does not re-trace
        step = 0
        while step < 20:
            n = k if step + k <= 20 else 1
            for tag, p in profs.items():
                p.on_window_start(step + 1, n)
                events[tag].append(("window", step + 1, p.active))
            step += n
            for tag, p in profs.items():
                p.on_step(step)
    for p in profs.values():
        p.close()
    assert events["port"] == events["jax"]
    assert events["port"].count("start") <= 1
    assert events["port"].count("start") == events["port"].count("stop")


def test_profile_steps_parse_and_refusals():
    for spec in ("", None, "1:2", " 3:10 "):
        assert profiling.parse_profile_steps(spec) == \
            jax_profiling.parse_profile_steps(spec)
    for spec in ("1", "a:b", "5:5", "-1:2"):
        with pytest.raises(ValueError) as mine:
            profiling.parse_profile_steps(spec)
        with pytest.raises(ValueError) as theirs:
            jax_profiling.parse_profile_steps(spec)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="profile_steps needs"):
        profiling.StepProfiler("", 1, 2, start_fn=lambda d: None,
                               stop_fn=lambda: None)


def test_chrome_trace_on_the_cpu_and_the_flight_recorder_events(tmp_path):
    flightrec.recorder.configure(rank=0, dump_dir=tmp_path, fresh=True)
    tracer = profiling.ChromeTrace(rank=2, cuda=False)
    prof = profiling.StepProfiler(str(tmp_path / "p"), 1, 3,
                                  start_fn=tracer.start, stop_fn=tracer.stop)
    prof.on_window_start(1, 2)
    torch.ones(64, 64) @ torch.ones(64, 64)
    prof.on_step(2)
    assert prof.done and tracer.path.name == "trace_r00002.json"
    trace = json.loads(tracer.path.read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    kinds = [e["kind"] for e in flightrec.recorder.events()]
    assert kinds[-2:] == ["profile_start", "profile_stop"]
    with profiling.profile_trace(str(tmp_path / "w"),
                                 profiling.ChromeTrace(cuda=False)):
        torch.ones(8).sum()
    assert (tmp_path / "w" / "trace_r00000.json").exists()
    flightrec.recorder.reset()


def test_memory_gauges_publish_nothing_on_the_cpu():
    reg = Counters()
    assert update_device_memory_gauges(reg, devices=["cpu"]) == {}
    assert reg.snapshot() == {}


@pytest.mark.parametrize("seed", range(2))
def test_accuracy_and_mean_behave_as_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    for mine, theirs in ((metrics.Accuracy(), jax_metrics.Accuracy()),
                         (metrics.Mean(), jax_metrics.Mean())):
        assert mine.compute() == theirs.compute()
        for _ in range(5):
            a, b = int(rng.integers(0, 9)), int(rng.integers(1, 9))
            v = np.float32(rng.uniform()) if isinstance(mine, metrics.Mean) \
                else a
            mine.update(v, b)
            theirs.update(v, b)
            assert mine.compute() == theirs.compute()
        mine.reset()
        theirs.reset()
        assert mine.compute() == theirs.compute() == 0.0
