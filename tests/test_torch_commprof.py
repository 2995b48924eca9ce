"""The port's comm/compute attribution (`tpu_dp_torch.obs.kineto`,
`tpu_dp_torch.obs.commprof`) against the JAX package's (`tpu_dp.obs.xplane`,
`tpu_dp.obs.commprof`), on the same inputs made from a seed with numpy:

- the interval math (`_merge`, `_total`, `_subtract_total`,
  `exposed_seconds`) on random interval lists: equal within 1e-12 s (sums
  of the same floats, in the same order);
- `reconcile`, `reconcile_wire`, `breakdown` (the port's books-derived
  wire record against the JAX package's schedule-derived one for the same
  collectives) and `parse_comm_profile_steps` (every accepted spec, and
  every refused one with the same message): equal outputs;
- `CommProfiler`'s window sequence under every:N, every:N:W, a range and
  a step jump: the same arms, stops and trace dirs as the JAX package's,
  with injected start and stop functions;
- the kineto classifier on hand-built Chrome traces: both NCCL kernel
  spellings, SendRecv as all-to-all, spin kernels at both ends left out,
  and comm on NCCL's stream that compute on another stream covers in
  part, with the exposed seconds exact (1e-12);
- a real CPU profile of gloo collectives (one rank): each ``c10d::`` op
  classified, the reduce-scatter as reduce-scatter although gloo runs it
  as ``gloo:all_reduce``;
- the books' per-kind mapping, and the JAX package's `read_comm_report`
  and obsctl reading a report the port wrote.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from tpu_dp.obs import commprof as jcp
from tpu_dp.obs import xplane as jxp
from tpu_dp_torch.obs import commprof as cp
from tpu_dp_torch.obs import kineto as kt

pytestmark = pytest.mark.port

torch.set_num_threads(2)


def _intervals(rng, n):
    starts = rng.uniform(0.0, 1.0, n)
    return [(float(s), float(s + d))
            for s, d in zip(starts, rng.uniform(0.0, 0.2, n))]


@pytest.mark.parametrize("seed", range(5))
def test_interval_math_equals_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    comm, compute = _intervals(rng, 30), _intervals(rng, 40)
    assert kt._merge(comm) == jxp._merge(comm)
    assert kt._merge(compute) == jxp._merge(compute)
    mc, mk = kt._merge(comm), kt._merge(compute)
    assert kt._total(mc) == pytest.approx(jxp._total(mc), abs=1e-12)
    assert kt._subtract_total(mc, mk) == pytest.approx(
        jxp._subtract_total(mc, mk), abs=1e-12)
    assert kt.exposed_seconds(comm, compute) == pytest.approx(
        jxp.exposed_seconds(comm, compute), abs=1e-12)
    assert kt.exposed_seconds(comm, []) == pytest.approx(
        jxp.exposed_seconds(comm, []), abs=1e-12)
    assert kt.exposed_seconds([], compute) == 0.0


def test_collective_kinds_are_the_jax_packages():
    assert kt.COLLECTIVE_KINDS == jxp.COLLECTIVE_KINDS
    # DDP's rebuild broadcasts: a kind of the port's traces the JAX
    # package's programs never run.
    assert set(cp.BOOK_KINDS.values()) <= set(kt.COLLECTIVE_KINDS) | {
        "broadcast"}


def test_reconcile_equals_the_jax_package():
    rng = np.random.default_rng(7)
    kinds = ("all-reduce", "reduce-scatter", "all-gather", "all-to-all")
    for _ in range(20):
        exp = {k: int(v) for k, v in zip(kinds, rng.integers(0, 9, 4)) if v}
        obs = dict(exp)
        if rng.random() < 0.5:
            k = kinds[int(rng.integers(0, 4))]
            obs[k] = obs.get(k, 0) + int(rng.integers(1, 3))
        steps = int(rng.integers(1, 5))
        assert cp.reconcile(exp, obs, steps, 1) == jcp.reconcile(
            exp, obs, steps, 1)
    exp = {"reduce-scatter": 20, "all-gather": 20, "all-reduce": 4}
    obs = {"reduce-scatter": 160, "all-gather": 160, "all-reduce": 32}
    assert cp.reconcile(exp, obs, 2, 8) == jcp.reconcile(exp, obs, 2, 8)
    assert cp.reconcile({}, {}, 2, 1) == jcp.reconcile({}, {}, 2, 1)


def test_reconcile_reports_an_absent_kind_never_ok_never_failed():
    exp = {"all-reduce": 4, "all-gather": 2}
    r = cp.reconcile(exp, {}, 2, 1, absent={"all-reduce": "why",
                                            "all-gather": "why"})
    assert r["ok"] is None
    assert r["by_kind"]["all-reduce"] == {
        "expected": 4.0, "observed": 0.0, "observed_raw": 0,
        "per_step_expected": 2.0, "per_step_observed": 0.0, "ok": None,
        "absent": "why"}
    # A kind that did run is compared, absent or not.
    r = cp.reconcile(exp, {"all-gather": 2}, 2, 1,
                     absent={"all-reduce": "why", "all-gather": "why"})
    assert r["ok"] is True and r["by_kind"]["all-gather"]["ok"] is True
    r = cp.reconcile(exp, {"all-gather": 3}, 2, 1, absent={"all-reduce": "x"})
    assert r["ok"] is False
    assert cp.absent_kinds("device", 1, exp) == {
        k: f"NCCL launches no kernel for a one-rank {k} (a device-to-device "
           f"copy)" for k in exp}
    assert cp.absent_kinds("device", 2, exp) == {}
    assert cp.absent_kinds("host", 1, exp) == {}


@pytest.mark.parametrize("dtype", ["", "f32", "bf16", "int8", "i8"])
def test_reconcile_wire_equals_the_jax_package(dtype):
    report = {"wire_bytes_per_step": {"f32": 4000, "bf16": 2000,
                                      "int8": 1064}}
    for sched in (4000, 2000, 1064, 5):
        wire = {"grad_exchange": sched}
        assert cp.reconcile_wire(wire, report, dtype) == jcp.reconcile_wire(
            wire, report, dtype)
    assert cp.reconcile_wire({"grad_exchange": 1}, {}, dtype) == \
        jcp.reconcile_wire({"grad_exchange": 1}, {}, dtype)


def _schedule(rng, world):
    """A sharded update's collectives as the JAX package's fingerprint op
    list, and the bytes the port's books give for them per update."""
    ops, nbytes = [], {}
    for kind, dt, width in (("reduce-scatter", "f32", 4),
                            ("all-gather", "f32", 4),
                            ("all-to-all", "s8", 1),
                            ("all-to-all", "f32", 4),
                            ("all-reduce", "f32", 4)):
        n = int(rng.integers(8, 4096))
        ops.append({"kind": kind, "shape": f"{dt}[{n}]"})
        # The books: a reduce-scatter's input (the result x world), the
        # others' tensors.
        b = n * width * (world if kind == "reduce-scatter" else 1)
        nbytes[kind] = nbytes.get(kind, 0) + b
    return ops, nbytes


@pytest.mark.parametrize("seed", range(4))
def test_breakdown_equals_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    world, steps = int(rng.choice([2, 4, 8])), int(rng.integers(1, 6))
    ops, nbytes = _schedule(rng, world)
    counts = {"reduce-scatter": steps, "all-gather": steps,
              "all-to-all": 2 * steps, "all-reduce": steps}
    summary = {"source": "device", "comm_s": float(rng.uniform(1e-3, 1e-2)),
               "compute_s": float(rng.uniform(1e-2, 5e-2)),
               "collectives": {"counts": counts, "dur_s": {
                   k: float(rng.uniform(1e-4, 1e-3)) for k in counts}}}
    summary["exposed_comm_s"] = summary["comm_s"] * float(rng.uniform())
    expected = {k: float(v) for k, v in counts.items()}
    report = {"wire_bytes_per_step": {"f32": nbytes["reduce-scatter"],
                                      "int8": nbytes["all-to-all"]}}
    for dtype in ("f32", "int8"):
        mine = cp.breakdown(summary, steps=steps, devices=1,
                            expected_total=expected,
                            wire=cp.wire_from_books(nbytes), world=world,
                            wire_report=report, wire_dtype=dtype,
                            link_gbs=900.0)
        theirs = jcp.breakdown(summary, steps=steps, devices=1,
                               expected_total=expected, collectives=ops,
                               world=world, wire_report=report,
                               wire_dtype=dtype, ici_gbs=900.0)
        assert mine == theirs
    # Nothing to compare against: both report nothing armed.
    assert cp.breakdown(summary, steps=steps, devices=1) == jcp.breakdown(
        summary, steps=steps, devices=1)


def test_breakdown_at_one_rank_has_no_link_rate():
    rng = np.random.default_rng(3)
    _, nbytes = _schedule(rng, 1)
    summary = {"source": "device", "comm_s": 1e-3, "compute_s": 1e-2,
               "exposed_comm_s": 5e-4,
               "collectives": {"counts": {"all-reduce": 2},
                               "dur_s": {"all-reduce": 1e-3}}}
    rep = cp.breakdown(summary, steps=2, devices=1,
                       expected_total={"all-reduce": 2.0,
                                       "reduce-scatter": 2.0},
                       wire=cp.wire_from_books(nbytes), world=1,
                       link_gbs=900.0)
    entry = rep["by_kind"]["all-reduce"]
    assert "wire_gbs" not in entry and "ici_util" not in entry
    assert entry["wire_bytes_per_step"] == nbytes["all-reduce"]
    recon = rep["reconciliation"]
    assert recon["by_kind"]["all-reduce"]["ok"] is True
    assert recon["by_kind"]["reduce-scatter"]["ok"] is None
    assert "one-rank" in recon["by_kind"]["reduce-scatter"]["absent"]
    assert recon["ok"] is True


def test_books_map_to_kinds():
    books = {"ddp_buckets": 3, "pmean_forward": 20, "pmean_backward": 20,
             "psum": 1, "reduce_scatter": 2, "all_to_all": 4,
             "all_gather": 2, "bytes:all-reduce": 100,
             "bytes:reduce-scatter": 64, "bytes:all-to-all": 32,
             "bytes:all-gather": 64}
    assert cp.books_by_kind(books) == {
        "counts": {"all-reduce": 44, "reduce-scatter": 2, "all-to-all": 4,
                   "all-gather": 2},
        "bytes": {"all-reduce": 100, "reduce-scatter": 64, "all-to-all": 32,
                  "all-gather": 64}}
    from tpu_dp_torch.parallel import collectives

    assert set(collectives.counts) | set(collectives.torch_issued) == set(
        cp.BOOK_KINDS)
    assert sorted(collectives.books()) == sorted(
        list(collectives.counts) + list(collectives.torch_issued)
        + [f"bytes:{k}" for k in collectives.wire_bytes])
    assert cp.books_by_kind({"ddp_rebuild_broadcasts": 2})["counts"] == {
        "broadcast": 2}


_SPECS_OK = ("", None, "4:6", "0:1", "every:100", "every:100:8", "every:1",
             " every:3:3 ")
_SPECS_BAD = ("nope", "6:4", "4", "every:0", "every:4:8", "every:1:2:3",
              "every:x", "every:", "-1:3")


@pytest.mark.parametrize("spec", _SPECS_OK)
def test_parse_comm_profile_steps_accepts_as_the_jax_package(spec):
    assert cp.parse_comm_profile_steps(spec) == \
        jcp.parse_comm_profile_steps(spec)


@pytest.mark.parametrize("spec", _SPECS_BAD)
def test_parse_comm_profile_steps_refuses_as_the_jax_package(spec):
    with pytest.raises(cp.CommProfileError) as mine:
        cp.parse_comm_profile_steps(spec)
    with pytest.raises(jcp.CommProfileError) as theirs:
        jcp.parse_comm_profile_steps(spec)
    assert str(mine.value) == str(theirs.value)


def _drive(mod, tmp, spec, dispatches, monkeypatch):
    """Drive ``mod``'s `CommProfiler` over ``dispatches`` ((first_step, n)
    windows, each followed by its on_step); returns the profiler's
    start/stop calls and the windows it published."""
    calls, published = [], []
    monkeypatch.setattr(mod.CommProfiler, "_publish_window",
                        lambda self, d, last, *a: published.append(
                            (self._win_first, last + 1, self._win_steps,
                             str(d))))
    prof = mod.CommProfiler(
        tmp, spec, devices=1, world=2,
        start_fn=lambda d: calls.append(("start", str(d))),
        stop_fn=lambda: calls.append(("stop",)))
    for first, n in dispatches:
        prof.on_window_start(first, n)
        prof.on_step(first + n - 1)
    prof.close()
    return calls, published


def _steps(*windows):
    """Consecutive dispatches of the given widths from step 1, with
    ``("jump", to)`` moving the clock."""
    out, at = [], 1
    for w in windows:
        if isinstance(w, tuple):
            at = w[1]
            continue
        out.append((at, w))
        at += w
    return out


@pytest.mark.parametrize("spec,dispatches,windows", [
    (("every", 5, 1), _steps(*[1] * 14), 2),
    (("every", 10, 3), _steps(*[1] * 34), 3),
    (("every", 4, 2), _steps(*[3] * 8), 5),
    (("range", 4, 6), _steps(*[1] * 9), 1),
    (("range", 4, 6), _steps(*[4] * 3), 1),
    (("range", 2, 3), _steps(1, ("jump", 11), 1, 1), 0),
    (("every", 4, 1), _steps(1, ("jump", 11), 8, 1), 1),
    (("every", 10, 3), _steps(1, ("jump", 11), 1, 1, 1, 1), 1),
])
def test_comm_profiler_windows_equal_the_jax_packages(tmp_path, monkeypatch,
                                                     spec, dispatches,
                                                     windows):
    mine = _drive(cp, tmp_path / "port", spec, dispatches, monkeypatch)
    theirs = _drive(jcp, tmp_path / "jax", spec, dispatches, monkeypatch)

    def rel(run, root):
        calls, pub = run
        return ([c if len(c) == 1 else (c[0], c[1].replace(str(root), ""))
                 for c in calls],
                [p[:3] + (p[3].replace(str(root), ""),) for p in pub])

    assert rel(mine, tmp_path / "port") == rel(theirs, tmp_path / "jax")
    assert len(mine[1]) == windows


def test_comm_profiler_expected_counts_from_the_books(tmp_path, monkeypatch):
    """The window's expected collectives are the books' difference between
    its arm and its stop, and its wire bytes that difference per update."""
    books = {"ddp_buckets": 0, "psum": 0, "bytes:all-reduce": 0}

    def dispatch(n):
        books["ddp_buckets"] += 3 * n
        books["psum"] += n
        books["bytes:all-reduce"] += 1000 * n

    monkeypatch.setattr(
        cp.kineto, "summarize",
        lambda d, source=None: {
            "source": "host", "comm_s": 8e-3, "compute_s": 1e-2,
            "exposed_comm_s": 2e-3,
            "collectives": {"counts": {"all-reduce": 12},
                            "dur_s": {"all-reduce": 8e-3}}})
    published = []
    prof = cp.CommProfiler(
        tmp_path, ("range", 3, 6), devices=1, world=2,
        books_fn=lambda: dict(books),
        publish=lambda rep, s, e, d: published.append((s, e, rep)),
        start_fn=lambda d: None, stop_fn=lambda: None)
    for first, n in ((1, 2), (3, 1), (4, 2), (6, 2)):
        prof.on_window_start(first, n)
        dispatch(n)
        prof.on_step(first + n - 1)
    [(start, end, rep)] = published
    assert (start, end, rep["steps"], rep["world"]) == (3, 6, 3, 2)
    assert rep["reconciliation"]["ok"] is True
    assert rep["reconciliation"]["by_kind"]["all-reduce"]["expected"] == 12
    assert rep["by_kind"]["all-reduce"]["wire_bytes_per_step"] == 1000
    assert rep["comm_ms"] == pytest.approx(8 / 3, abs=1e-4)
    assert rep["overlap_frac"] == pytest.approx(0.75)


# -- the kineto classifier ----------------------------------------------------

def _kernel(name, ts, dur, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
            "tid": stream, "ts": ts, "dur": dur,
            "args": {"stream": stream, "device": 0}}


def _write(tmp, events, name="trace_r00000.json"):
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / name).write_text(json.dumps({"traceEvents": events}))
    return tmp


def test_nccl_names_classify_in_both_spellings():
    cases = {
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
        "<4096ul>)": "all-reduce",
        "ncclKernel_AllReduce_RING_LL_Sum_float(ncclWorkElem)": "all-reduce",
        "ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL(x)": "reduce-scatter",
        "ncclKernel_ReduceScatter_RING_SIMPLE_Sum_float(x)":
            "reduce-scatter",
        "ncclDevKernel_AllGather_RING_LL(x)": "all-gather",
        "ncclKernel_AllGather_RING_LL_Sum_int8_t(x)": "all-gather",
        "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)":
            "all-to-all",
        "ncclKernel_SendRecv_RING_SIMPLE_Sum_int8_t(x)": "all-to-all",
        "ncclDevKernel_Broadcast_RING_LL(x)": "broadcast",
        "fused_affine_relu_conv_kernel<128, 64>": None,
        "void at::native::vectorized_elementwise_kernel<4>": None,
    }
    for name, kind in cases.items():
        assert kt.nccl_kind(name) == kind, name


def test_device_trace_exposed_seconds_are_exact(tmp_path):
    spin = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    conv = "fused_affine_relu_conv_kernel<128, 64>"
    xent = "xent_mean_fwd_kernel"
    events = (
        [_kernel(spin, 10.0 * i, 10.0) for i in range(4)]
        + [_kernel(conv, 100.0, 50.0),                     # [100, 150)
           _kernel(conv, 200.0, 50.0),                     # [200, 250)
           _kernel(xent, 240.0, 20.0, stream=9),           # [240, 260)
           # NCCL on its own stream: [120, 180) is covered by the conv to
           # 150; [230, 300) by compute to 260.
           _kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 120.0,
                   60.0, stream=20),
           _kernel("ncclKernel_ReduceScatter_RING_LL_Sum_float(x)", 230.0,
                   70.0, stream=20),
           _kernel("ncclDevKernel_SendRecv(x)", 400.0, 10.0, stream=20),
           {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "pid": 0,
            "tid": 7, "ts": 500.0, "dur": 100.0}]
        + [_kernel(spin, 1000.0 + 10.0 * i, 10.0) for i in range(4)])
    s = kt.summarize(_write(tmp_path, events))
    assert s["source"] == "device"
    assert s["skipped"] == {"spin": 8}
    assert s["collectives"]["counts"] == {"all-reduce": 1,
                                          "reduce-scatter": 1,
                                          "all-to-all": 1}
    ops = {r["name"]: r["count"] for r in s["ops"]}
    assert ops[conv] == 2 and ops[xent] == 1
    assert s["comm_s"] == pytest.approx(140e-6, abs=1e-12)
    assert s["compute_s"] == pytest.approx(110e-6, abs=1e-12)
    # exposed: [150, 180) + [260, 300) + [400, 410)
    assert s["exposed_comm_s"] == pytest.approx(80e-6, abs=1e-12)
    assert s["window_s"] == pytest.approx(310e-6, abs=1e-12)
    rep = cp.breakdown(s, steps=1, devices=1)
    assert rep["overlap_frac"] == pytest.approx(1 - 80 / 140, abs=1e-4)


def test_kineto_refuses_what_it_cannot_read(tmp_path):
    with pytest.raises(kt.KinetoError, match="no Chrome trace"):
        kt.summarize(tmp_path / "none")
    bad = _write(tmp_path / "bad", [{"ph": "X", "cat": "user_annotation",
                                     "name": "x", "ts": 0.0, "dur": 1.0}])
    with pytest.raises(kt.KinetoError, match="no CUDA kernel events"):
        kt.summarize(bad)
    spins = _write(tmp_path / "spins", [
        _kernel("spin_kernel(long)", 0.0, 1.0)])
    with pytest.raises(kt.KinetoError, match="no op events"):
        kt.summarize(spins)
    (tmp_path / "torn").mkdir()
    (tmp_path / "torn" / "trace_r00000.json").write_text("{")
    with pytest.raises(kt.KinetoError, match="cannot read"):
        kt.summarize(tmp_path / "torn")
    with pytest.raises(cp.CommProfileError, match="schema"):
        (tmp_path / "r.json").write_text(json.dumps({"schema": 9}))
        cp.read_comm_report(tmp_path / "r.json")


def test_host_trace_nesting(tmp_path):
    def op(name, ts, dur, tid=1, cat="cpu_op"):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
                "ts": ts, "dur": dur}

    events = [
        op("aten::conv2d", 0.0, 100.0), op("aten::convolution", 1.0, 90.0),
        op("c10d::allreduce_", 100.0, 20.0),
        op("aten::clone", 101.0, 5.0),          # inside the collective
        op("gloo:all_reduce", 110.0, 60.0, tid=2, cat="user_annotation"),
        op("aten::copy_", 111.0, 10.0, tid=2),  # gloo's own work
        op("aten::mul", 150.0, 40.0),           # under gloo's [110, 170)
        op("c10d::_reduce_scatter_base_", 200.0, 10.0),
        op("c10d::weird_", 220.0, 1.0),
    ]
    s = kt.summarize(_write(tmp_path, events))
    assert s["source"] == "host"
    assert {r["name"]: r["count"] for r in s["ops"]} == {
        "aten::conv2d": 1, "c10d::allreduce_": 1, "aten::mul": 1,
        "c10d::_reduce_scatter_base_": 1}
    assert s["collectives"]["counts"] == {"all-reduce": 1,
                                          "reduce-scatter": 1}
    assert s["skipped"] == {"c10d::weird_": 1}
    # comm [100, 170) + [200, 210); compute [0, 100) + [150, 190).
    assert s["comm_s"] == pytest.approx(80e-6, abs=1e-12)
    assert s["compute_s"] == pytest.approx(140e-6, abs=1e-12)
    assert s["exposed_comm_s"] == pytest.approx(60e-6, abs=1e-12)


def test_a_real_gloo_profile_classifies_by_dispatcher_op(tmp_path):
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from tpu_dp_torch.parallel import collectives

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        g = dist.group.WORLD
        x = torch.arange(64, dtype=torch.float32)
        collectives.reset_counts()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            collectives.psum(x * 2, g)  # identities at world 1: issue
            for _ in range(2):
                y = x.clone()
                dist.all_reduce(y)
                out = torch.empty(64)
                collectives._reduce_scatter_single()(out, y)
                collectives.all_gather(out, g, 1)
                collectives._all_to_all(y.view(1, 64), g)
        (tmp_path / "t").mkdir()
        prof.export_chrome_trace(str(tmp_path / "t" / "trace_r00000.json"))
    finally:
        dist.destroy_process_group()
    names = [e["name"] for e in kt.load_events(
        tmp_path / "t" / "trace_r00000.json")]
    assert "gloo:reduce_scatter" not in names  # gloo calls it all_reduce
    s = kt.summarize(tmp_path / "t", "host")
    assert s["collectives"]["counts"] == {
        "all-reduce": 2, "reduce-scatter": 2, "all-gather": 2,
        "all-to-all": 2}
    assert s["comm_s"] > 0 and s["compute_s"] > 0
    # Booked: the port's own issues (2 x 64 f32 each; psum at one rank
    # and the direct calls issue nothing the books see).
    assert collectives.wire_bytes == {"all-reduce": 0, "reduce-scatter": 0,
                                      "all-to-all": 512, "all-gather": 512}
    collectives.reset_counts()


def test_the_jax_package_reads_the_ports_report(tmp_path):
    from tpu_dp.obs import obsctl as jobsctl
    from tpu_dp_torch.obs import obsctl

    summary = {"source": "host", "comm_s": 8e-3, "compute_s": 1e-2,
               "exposed_comm_s": 2e-3,
               "collectives": {"counts": {"all-reduce": 8},
                               "dur_s": {"all-reduce": 8e-3}}}
    rep = cp.breakdown(summary, steps=2, devices=1,
                       expected_total={"all-reduce": 8.0})
    rep.update(start_step=4, end_step=6, trace_dir="t", ts=1.0, world=2)
    (tmp_path / "obs").mkdir()
    cp.write_comm_report(tmp_path / "obs" / "comm_report.json", rep)
    assert jcp.read_comm_report(tmp_path / "obs" / "comm_report.json") == rep
    assert cp.read_comm_report(tmp_path / "obs" / "comm_report.json") == rep
    (tmp_path / "metrics.jsonl").write_text("")
    mine = obsctl.run_efficiency(obsctl.RunArtifacts(tmp_path))
    theirs = jobsctl.run_efficiency(jobsctl.RunArtifacts(tmp_path))
    assert mine == theirs
    assert mine["exposed_comm_ms"] == rep["exposed_comm_ms"]
