"""The port's `Trainer` telemetry against the JAX package's `Trainer`.

Both start from the JAX `Trainer`'s init (the port resumes from its save,
meta epoch -1), on the reference `Net` and on a narrow ResNet-18 (8
filters, augmentation on), in one update a call and in windows of 4, the
resident feed, at ``train.obs`` off, basic and full:

- the ``metrics.jsonl`` records match in sequence and in keys (``ts`` and
  the timings aside), the span names and the efficiency rollup's keys
  and step counts included; epoch loss and accuracy and the eval agree
  within 1e-4;
- ``basic`` records no ``h2d`` or ``device`` span and no per-update
  record; ``full`` writes one record per update;
- the port's parameters after off, basic and full are bit-identical,
  and its books (the wrappers' launch counts) are the same;
- a guard ``nan:`` skip and a ``spike:`` rollback write the JAX
  package's ``guard_quarantine``, ``guard_spike`` and ``guard_rollback``
  events, and every record after the rollback carries
  ``rollback_generation``;
- the CLI takes the telemetry knobs (the artifacts land where the README
  says), and refuses a bad ``--obs.comm_profile_steps`` spec, a bad mode
  and a step range without a trace dir with the JAX package's messages.
"""

from __future__ import annotations

import functools
import json
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_dp.config as jax_config
from torch_port_util import ROOT
from tpu_dp import checkpoint as jck
from tpu_dp.obs import costs as jax_costs
from tpu_dp.obs.counters import counters as jax_counters
from tpu_dp.parallel import dist as jax_dist
from tpu_dp.train import trainer as jax_trainer_mod
from tpu_dp_torch.config import parse_cli
from tpu_dp_torch.obs import costs
from tpu_dp_torch.obs.counters import counters
from tpu_dp_torch.train import trainer as trainer_mod
from tpu_dp_torch.train.step import launch_books

pytestmark = pytest.mark.port

torch.set_num_threads(2)

_COMMON = ["--train.log_every=4", "--train.ckpt_async=false",
           "--resilience.handle_signals=false",
           "--obs.peak_flops_override=1e13", "--data.device_resident=on"]
_MODELS = {
    "net": (["--data.dataset=synthetic", "--data.synthetic_train_size=32",
             "--data.synthetic_test_size=8", "--train.epochs=2"], None),
    "resnet18": (["--preset=resnet18_cifar10", "--data.dataset=synthetic",
                  "--data.synthetic_train_size=16",
                  "--data.synthetic_test_size=4", "--data.batch_size=4",
                  "--train.epochs=1"], 8),
}
_MODES = ("off", "basic", "full")
#: the fields whose values are timings or wall clocks.
_TIMED = {"ts", "images_per_sec", "goodput", "mfu"}


@pytest.fixture(autouse=True)
def _fresh_registries():
    for reg in (counters, jax_counters, costs.registry,
                jax_costs.registry):
        reg.reset()
    yield


def _records(path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _jax_fit(tmp, args, num_filters):
    """The JAX `Trainer` on ``args``: its metrics records, final epoch
    stats and eval, and its init's save (for the port to resume from)."""
    cfg = jax_config.parse_cli(args + [f"--train.ckpt_dir={tmp / 'run'}"])
    real_build = jax_trainer_mod.build_model
    if num_filters is not None:
        jax_trainer_mod.build_model = functools.partial(
            real_build, num_filters=num_filters)
    try:
        trainer = jax_trainer_mod.Trainer(
            cfg, mesh=jax_dist.data_mesh(num_devices=1))
    finally:
        jax_trainer_mod.build_model = real_build
    init = tmp / "init"
    jck.CheckpointManager(init, async_save=False).save(
        trainer.state, {"epoch": -1, "config": cfg.to_dict(), "seed": 0})
    result = trainer.fit()
    return _records(trainer.metrics_path), result, init


def _port_fit(tmp, args, init, num_filters, monkeypatch):
    ckpt = tmp / "port"
    shutil.copytree(init, ckpt)
    if num_filters is not None:
        monkeypatch.setattr(trainer_mod, "build_model", functools.partial(
            trainer_mod.build_model, num_filters=num_filters))
    trainer = trainer_mod.Trainer(parse_cli(args + [
        f"--train.ckpt_dir={ckpt}", "--resume"]), device="cpu")
    assert (trainer.start_epoch, trainer.start_step) == (0, 0)
    before = launch_books()
    result = trainer.fit()
    after = launch_books()
    books = {k: after[k] - before[k] for k in after}
    state = {k: v.detach().clone() for k, v in
             trainer.model.state_dict().items()}
    return trainer, _records(trainer.metrics_path), result, state, books


def _shape(rec: dict) -> dict:
    """A record with its timings dropped: the keys everywhere, the values
    of the non-timed fields."""
    out = {}
    for k, v in rec.items():
        if k in _TIMED:
            out[k] = "<timed>"
        elif k == "spans":
            # Epoch records hold a rollup per span, per-update records ms.
            out[k] = {name: (sorted(s) if isinstance(s, dict) else "<ms>")
                      for name, s in v.items()}
        elif k == "efficiency":
            out[k] = {"keys": sorted(v), "windows": v["windows"],
                      "steps": v["steps"],
                      "flops": v.get("flops_per_step_per_chip")}
        elif k == "counters":
            # The telemetry's own gauges; the rest are each package's
            # subsystems (retries, snapshots, recompiles).
            out[k] = sorted(n for n in v
                            if n.startswith(("obs.", "throughput.")))
        elif k in ("loss", "accuracy", "eval"):
            out[k] = "<close>"
        else:
            out[k] = v
    return out


def _close_values(mine: dict, theirs: dict) -> None:
    for k in ("loss", "accuracy"):
        if k in theirs:
            assert abs(mine[k] - theirs[k]) <= 1e-4, (k, mine, theirs)
    if "eval" in theirs:
        assert mine["eval"].keys() == theirs["eval"].keys()
        for k, v in theirs["eval"].items():
            assert abs(mine["eval"][k] - v) <= 1e-4


@pytest.mark.parametrize("model", sorted(_MODELS))
@pytest.mark.parametrize("window", [1, 4])
def test_metrics_records_track_the_jax_trainer(tmp_path, monkeypatch, model,
                                               window):
    base, filters = _MODELS[model]
    states, books = {}, {}
    for mode in _MODES:
        args = base + _COMMON + [f"--train.obs={mode}",
                                 f"--train.steps_per_call={window}"]
        where = tmp_path / mode
        theirs, jres, init = _jax_fit(where / "jax", args, filters)
        trainer, mine, res, states[mode], books[mode] = _port_fit(
            where, args, init, filters, monkeypatch)
        assert [_shape(r) for r in mine] == [_shape(r) for r in theirs], mode
        for a, b in zip(mine, theirs):
            _close_values(a, b)
        for a, b in zip(res["history"], jres["history"]):
            _close_values(a, b)
        steps = trainer._host_step
        per_update = [r for r in mine if "spans" in r and "epoch" not in r]
        epochs = [r for r in mine if "epoch" in r]
        assert all(r["schema"] == 3 for r in mine)
        if mode == "off":
            assert trainer.spans is None and not per_update
            assert all("spans" not in r for r in epochs)
        elif mode == "basic":
            assert not per_update
            assert all(set(r["spans"]) == {"data_wait", "dispatch"}
                       for r in epochs)
            assert trainer.obs_dir.joinpath(
                "heartbeat_r00000.jsonl").exists()
        else:
            assert [r["step"] for r in per_update] == list(
                range(1, steps + 1))
            assert all(set(r["spans"]) == {"data_wait", "dispatch", "h2d",
                                           "device"} for r in per_update)
            # Net has no analytic count, so no MFU, in either package.
            assert all((model == "net") == ("mfu" not in r)
                       and (model == "net" or 0 < r["mfu"] <= 1)
                       for r in per_update)
        if mode != "off":
            trace = json.loads((trainer.obs_dir / "trace.perfetto.json")
                               .read_text())
            assert len([e for e in trace["traceEvents"]
                        if e["ph"] == "X" and e["name"] == "dispatch"]) \
                == steps
        assert set(mine[-1]["eval"]) == {"accuracy", "loss"}
        assert all(mine[-1]["eval"][k] == res["eval"][k]
                   for k in ("accuracy", "loss"))
    for mode in ("basic", "full"):
        assert states[mode].keys() == states["off"].keys()
        assert all(torch.equal(states[mode][k], v)
                   for k, v in states["off"].items()), mode
        assert books[mode] == books["off"]


_GUARD = ["--data.dataset=synthetic", "--data.synthetic_train_size=48",
          "--data.synthetic_test_size=8", "--train.epochs=1",
          "--train.log_every=100", "--data.augment=true",
          "--data.device_resident=on", "--train.ckpt_async=false",
          "--resilience.handle_signals=false", "--guard.enabled=true",
          "--train.obs=basic"]
_GUARD_RUNS = {
    "nan": ["--resilience.fault=nan:step=5", "--train.steps_per_call=4"],
    "rollback": ["--resilience.fault=spike:step=8,scale=1e6",
                 "--resilience.snapshot_every_steps=5",
                 "--guard.action=rollback", "--guard.spike_min_steps=4",
                 "--guard.spike_window=16", "--guard.spike_z=12",
                 "--train.epochs=2"],
}


@pytest.mark.parametrize("run", sorted(_GUARD_RUNS))
def test_guard_events_and_rollback_generations_track_the_jax_trainer(
        tmp_path, monkeypatch, run):
    args = _GUARD + _GUARD_RUNS[run]
    theirs, _, init = _jax_fit(tmp_path / "jax", args, None)
    trainer, mine, _, _, _ = _port_fit(tmp_path, args, init, None,
                                       monkeypatch)
    assert [_shape(r) for r in mine if "event" not in r] == [
        _shape(r) for r in theirs if "event" not in r]
    events = [r for r in mine if "event" in r]
    want = [r for r in theirs if "event" in r]
    assert [sorted(r) for r in events] == [sorted(r) for r in want]
    for a, b in zip(events, want):
        for k, v in b.items():
            if k in ("ts", "value", "z"):
                continue
            if k in ("trigger", "reason"):
                # The wording; the numbers in it are each package's f32.
                a[k], v = (re.sub(r"\d[\d.e+-]*", "#", x) for x in (a[k], v))
            assert a[k] == v, (k, a, b)
        if b["event"] == "guard_spike":
            assert abs(a["value"] - b["value"]) <= 1e-4 * abs(b["value"])
    kinds = [r["event"] for r in events]
    if run == "nan":
        assert kinds == ["guard_quarantine"] * 3
        assert [r["step"] for r in events] == [6, 7, 8]
        assert events[0]["sample_range"] == [20, 24]
    else:
        assert kinds == ["guard_spike", "guard_rollback"]
        rb = events[1]
        assert (rb["from_step"], rb["to_step"]) == (9, 5)
        after = mine[mine.index(rb):]
        assert all(r["rollback_generation"] == 1 for r in after)
        assert all("rollback_generation" not in r
                   for r in mine[:mine.index(events[0])])
        gens = {r.get("gen", 0) for r in trainer.spans.records()}
        assert gens == {0, 1}


def _cli(args, timeout=240):
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "tpu_dp_torch.train", "--device", "cpu",
         *args], cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env=env)


def test_cli_takes_the_telemetry_knobs(tmp_path):
    ck, prom, trace = tmp_path / "ck", tmp_path / "m.prom", tmp_path / "pf"
    out = _cli(["--data.dataset=synthetic", "--data.synthetic_train_size=32",
                "--data.synthetic_test_size=8", "--train.epochs=1",
                "--train.steps_per_call=2", "--train.obs=full",
                f"--train.metrics_path={tmp_path / 'm.jsonl'}",
                f"--obs.prom_path={prom}", "--obs.heartbeat_every_steps=2",
                "--train.profile_steps=3:5", f"--train.profile_dir={trace}",
                "--obs.measure_flops=true", "--obs.span_capacity=64",
                f"--obs.perfetto_path={tmp_path / 't.json'}",
                f"--train.ckpt_dir={ck}"])
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["obs"]["mode"] == "full"
    assert summary["efficiency"]["steps"] == 8
    recs = _records(tmp_path / "m.jsonl")
    assert [r.get("step") for r in recs if "spans" in r][:8] == list(
        range(1, 9))
    assert not (ck / "metrics.jsonl").exists()
    assert "tpu_dp_obs_step_time_ms" in prom.read_text()
    assert len((ck / "obs" / "heartbeat_r00000.jsonl").read_text()
               .splitlines()) == 4
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert (trace / "trace_r00000.json").exists()
    # Net has no analytic count: the measured one, unchecked.
    assert summary["efficiency"]["flops_per_step_per_chip"] > 0
    events = json.loads((ck / "obs" / "flightrec_r00000.json").read_text())
    kinds = [e["kind"] for e in events["events"]]
    assert kinds.count("profile_start") == kinds.count("profile_stop") == 1


def test_default_cli_run_writes_the_metrics_records(tmp_path):
    out = _cli(["--data.dataset=synthetic", "--data.synthetic_train_size=16",
                "--data.synthetic_test_size=4", "--train.epochs=2",
                f"--train.ckpt_dir={tmp_path}"])
    assert out.returncode == 0, out.stderr[-3000:]
    recs = _records(tmp_path / "metrics.jsonl")
    assert [sorted(r) for r in recs] == [
        ["accuracy", "epoch", "images_per_sec", "loss", "schema", "step",
         "ts"]] * 2 + [["eval", "schema", "step", "ts"]]
    assert [r["epoch"] for r in recs[:2]] == [1, 2]
    assert "obs" not in json.loads(out.stdout.strip().splitlines()[-1])
    assert not (tmp_path / "obs" / "heartbeat_r00000.jsonl").exists()


@pytest.mark.parametrize("knob,message", [
    ("--obs.comm_profile_steps=every:0",
     "obs.comm_profile_steps every:N:W needs 1 <= W <= N, got 'every:0'"),
    ("--obs.comm_profile_steps=4",
     "obs.comm_profile_steps must be START:END or every:N[:W], got '4'"),
    ("--train.obs=most", "train.obs must be off|basic|full, got 'most'"),
    ("--train.profile_steps=1:2",
     "profile_steps needs train.profile_dir for the trace output"),
    ("--train.profile_steps=4", "train.profile_steps must be START:END")])
def test_cli_refuses_what_is_not_ported_or_invalid(tmp_path, knob, message):
    out = _cli(["--data.dataset=synthetic", "--data.synthetic_train_size=8",
                knob, f"--train.ckpt_dir={tmp_path}"], timeout=120)
    assert out.returncode == 2
    assert message in out.stderr
    with pytest.raises(ValueError) as port_err:
        parse_cli([knob])
    with pytest.raises(ValueError) as jax_err:
        jax_cfg = jax_config.parse_cli([
            "--data.dataset=synthetic", "--data.synthetic_train_size=8",
            knob, f"--train.ckpt_dir={tmp_path / 'jax'}"])
        jax_trainer_mod.Trainer(jax_cfg,
                                mesh=jax_dist.data_mesh(num_devices=1))
    assert str(port_err.value) == str(jax_err.value)


def test_config_dumps_carry_the_telemetry_fields_both_ways():
    cfg = parse_cli(["--train.obs=full", "--obs.prom_path=p",
                     "--obs.min_step_ms=0.5", "--train.profile_dir=d",
                     "--train.profile_steps=1:3"])
    jax_cfg = jax_config.Config.from_dict(
        json.loads(json.dumps(cfg.to_dict())))
    assert (jax_cfg.train.obs, jax_cfg.obs.prom_path,
            jax_cfg.obs.min_step_ms, jax_cfg.train.profile_steps) == (
        "full", "p", 0.5, "1:3")
    back = type(cfg).from_dict(jax_cfg.to_dict())
    assert back.to_dict() == cfg.to_dict()
    assert np.isclose(back.obs.stale_after_s, 60.0)
