"""The port's flight recorder (`tpu_dp_torch.obs.flightrec`) against the
JAX package's (mirrors the applicable cases of tests/test_flightrec.py).

- The ring, the dump (atomic, schema-versioned, readable by either
  package's `read_dump`), the hang-dump sentinel, and the event-kind
  registry equal to the JAX package's.
- Every exit from the port's `Trainer.fit` leaves ``flightrec_r<rank>.
  json``: a clean run, `PreemptedError` from an injected SIGTERM and from
  a real external one (``python -m tpu_dp_torch.train`` exits 143), and an
  unhandled exception; ``obs.flightrec_capacity=0`` turns it off.
- For the same config and faults (a snapshot cadence, an injected EIO and
  a preemption), the port's dump holds the JAX `Trainer`'s event kinds in
  the JAX `Trainer`'s order (timestamps excluded).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

import tpu_dp.config as jax_config
from torch_port_util import ROOT
from tpu_dp.chaos.storage import shim as jax_shim
from tpu_dp.obs import flightrec as jfr
from tpu_dp.parallel import dist as jax_dist
from tpu_dp.resilience import PreemptedError as JaxPreemptedError
from tpu_dp.train.trainer import Trainer as JaxTrainer
from tpu_dp_torch.chaos.storage import shim
from tpu_dp_torch.config import parse_cli
from tpu_dp_torch.obs import flightrec
from tpu_dp_torch.resilience import PreemptedError
from tpu_dp_torch.train.hooks import StepHook
from tpu_dp_torch.train.trainer import Trainer

pytestmark = pytest.mark.port

torch.set_num_threads(2)

_NET = ["--data.dataset=synthetic", "--data.synthetic_train_size=32",
        "--data.synthetic_test_size=16", "--data.batch_size=8",
        "--train.epochs=1", "--train.log_every=100",
        "--train.eval_at_end=false", "--data.device_resident=off"]


@pytest.fixture(autouse=True)
def _fresh():
    flightrec.recorder.reset()
    jfr.recorder.reset()
    shim.reset()
    jax_shim.reset()
    yield
    flightrec.recorder.reset()
    jfr.recorder.reset()
    shim.reset()
    jax_shim.reset()


# -- ring and dump -------------------------------------------------------------


def test_ring_bounds_lifetime_count_and_kinds():
    fr = flightrec.FlightRecorder(capacity=4)
    for i in range(7):
        fr.record("step", step=i)
    assert len(fr) == 4 and fr.total_recorded == 7
    assert [e["step"] for e in fr.events()] == [3, 4, 5, 6]
    assert flightrec.KINDS == jfr.KINDS
    assert (flightrec.SCHEMA, flightrec.DUMP_GLOB, flightrec.DUMP_REQUEST) \
        == (jfr.SCHEMA, jfr.DUMP_GLOB, jfr.DUMP_REQUEST)


def test_dump_is_atomic_and_reads_in_both_packages(tmp_path):
    fr = flightrec.FlightRecorder(capacity=8)
    fr.configure(rank=3, dump_dir=tmp_path, run={"model": "net"})
    fr.record("preempt_signal", step=5, signum=15)
    out = fr.dump(reason="unit test")
    assert out == tmp_path / "flightrec_r00003.json"
    assert out == jfr.dump_path_for(tmp_path, 3)
    assert not list(tmp_path.glob("*.tmp*"))
    for read in (flightrec.read_dump, jfr.read_dump):
        payload = read(out)
        assert payload["rank"] == 3 and payload["reason"] == "unit test"
        assert payload["run"] == {"model": "net"}
        assert payload["events"][-1]["kind"] == "preempt_signal"
        assert isinstance(payload["counters"], dict)
    theirs = jfr.FlightRecorder(capacity=8)
    theirs.configure(rank=1, dump_dir=tmp_path)
    theirs.record("snapshot", step=3)
    assert flightrec.read_dump(theirs.dump(reason="jax"))["events"][0][
        "kind"] == "snapshot"
    bad = tmp_path / "flightrec_r00009.json"
    bad.write_text(json.dumps({"schema": 999}))
    with pytest.raises(ValueError, match="schema"):
        flightrec.read_dump(bad)
    assert flightrec.FlightRecorder().dump() is None  # no target, no dump


def test_rehome_keeps_the_ring_and_the_sentinel_fires_once(tmp_path):
    fr = flightrec.FlightRecorder(capacity=8)
    fr.configure(rank=0, dump_dir=tmp_path / "a", fresh=True)
    fr.record("step", step=1)
    fr.configure(rank=0, dump_dir=tmp_path / "b")
    assert [e["step"] for e in fr.events()] == [1]
    assert fr.poll_dump_request() is None
    flightrec.write_dump_request(tmp_path / "b", "rank 2 stale")
    out = fr.poll_dump_request()
    assert out is not None and "rank 2 stale" in flightrec.read_dump(
        out)["reason"]
    assert fr.poll_dump_request() is None  # once per sentinel write


# -- exit paths of fit -----------------------------------------------------------


def _trainer(tmp_path, *extra):
    return Trainer(parse_cli(_NET + [f"--train.ckpt_dir={tmp_path / 'ck'}",
                                     *extra]), device="cpu")


def _dump(tmp_path):
    return flightrec.read_dump(tmp_path / "ck" / "obs"
                               / "flightrec_r00000.json")


def test_dump_on_clean_exit_and_the_disable_knob(tmp_path):
    _trainer(tmp_path).fit()
    dump = _dump(tmp_path)
    assert dump["reason"] == "clean" and dump["events"][-1]["kind"] == "exit"
    assert {"epoch_start", "step", "exit"} <= {e["kind"]
                                              for e in dump["events"]}
    assert dump["run"]["model"] == "net" and dump["run"]["world"] == 1
    flightrec.recorder.reset()
    t = _trainer(tmp_path / "off", "--obs.flightrec_capacity=0")
    assert t.flightrec is None
    t.fit()
    assert not list((tmp_path / "off").rglob("flightrec_r*.json"))


def test_dump_on_unhandled_exception(tmp_path):
    t = _trainer(tmp_path)

    class Bomb(StepHook):
        def on_step_end(self, ev):
            if self.tr._host_step >= 2:
                raise RuntimeError("simulated data-loader corruption")

    t._hooks.insert(0, Bomb(t))
    with pytest.raises(RuntimeError, match="corruption"):
        t.fit()
    dump = _dump(tmp_path)
    assert "RuntimeError" in dump["reason"] and "corruption" in dump["reason"]
    assert dump["events"][-1]["kind"] == "exit"


def _cli(ckpt, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
    env.pop("TPU_DP_FAULT", None)
    return ([sys.executable, "-m", "tpu_dp_torch.train", "--device", "cpu",
             f"--train.ckpt_dir={ckpt}", *_NET, "--train.epochs=2",
             "--resilience.snapshot_every_steps=1", *extra], env)


def _assert_preempted_dump(ckpt):
    dump = flightrec.read_dump(ckpt / "obs" / "flightrec_r00000.json")
    assert "PreemptedError" in dump["reason"]
    kinds = [e["kind"] for e in dump["events"]]
    assert "preempt_signal" in kinds and "preempt_exit" in kinds
    assert kinds[-1] == "exit" and "PreemptedError" in dump["events"][-1][
        "reason"]
    # The last step event is the boundary the final snapshot was taken at.
    steps = [e["step"] for e in dump["events"] if e["kind"] == "step"]
    final = [e for e in dump["events"] if e["kind"] == "snapshot"][-1]
    assert steps[-1] == final["step"]
    return dump


def test_dump_on_injected_preemption(tmp_path):
    argv, env = _cli(tmp_path / "ck", "--resilience.fault=preempt:step=3")
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 143, proc.stderr[-3000:]
    _assert_preempted_dump(tmp_path / "ck")


def test_dump_on_external_sigterm(tmp_path):
    """A real SIGTERM from outside: the delay fault parks the run at a
    boundary long enough for the signal to land mid-train."""
    ckpt = tmp_path / "ck"
    argv, env = _cli(ckpt, "--resilience.fault=delay:step=2,ms=3000")
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    first = ckpt / "snapshots" / "step_0000000002"
    deadline = time.monotonic() + 180
    while time.monotonic() < deadline and proc.poll() is None:
        if (first / "meta.json").exists():
            break
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=240)
    assert proc.returncode == 143, out[-3000:]
    dump = _assert_preempted_dump(ckpt)
    assert [e["signum"] for e in dump["events"]
            if e["kind"] == "preempt_signal"] == [int(signal.SIGTERM)]


# -- the same events as the JAX Trainer ------------------------------------------


def _kinds(dump) -> list[str]:
    return [e["kind"] for e in dump["events"]]


def test_event_kinds_in_order_equal_the_jax_trainers(tmp_path):
    args = _NET + ["--train.ckpt_async=false", "--train.epochs=2",
                   "--resilience.snapshot_every_steps=3",
                   "--resilience.fault=ioerr:step=2;preempt:step=5",
                   "--resilience.io_retry_s=0.5"]
    jt = JaxTrainer(jax_config.parse_cli(
        args + [f"--train.ckpt_dir={tmp_path / 'jax'}"]),
        mesh=jax_dist.data_mesh(num_devices=1))
    with pytest.raises(JaxPreemptedError):
        jt.fit()
    theirs = jfr.read_dump(tmp_path / "jax" / "obs"
                           / "flightrec_r00000.json")
    t = Trainer(parse_cli(args + [f"--train.ckpt_dir={tmp_path / 'port'}"]),
                device="cpu")
    with pytest.raises(PreemptedError):
        t.fit()
    mine = flightrec.read_dump(tmp_path / "port" / "obs"
                               / "flightrec_r00000.json")
    assert _kinds(mine) == _kinds(theirs)
    assert "storage_fault" in _kinds(mine)
    for a, b in zip(mine["events"], theirs["events"]):
        assert a.get("step") == b.get("step"), (a, b)
    assert mine["reason"].split(":")[0] == theirs["reason"].split(":")[0]
