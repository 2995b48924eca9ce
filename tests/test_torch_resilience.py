"""The port's resilience defaults against the JAX package's
(`tpu_dp_torch/resilience/`, `tpu_dp_torch/chaos/storage.py`; mirrors
the applicable cases of tests/test_resilience.py).

- Fault plans parse as the JAX package parses them (fields, round trip,
  errors); the kinds the run cannot fire are refused before it starts,
  ``nan``/``spike`` without the guard with the JAX package's own message
  and ``drop`` naming the host ring it needs, which the port does not
  carry (``relaunch`` and ``slowfs`` run: tests/test_torch_elastic_grow.py).
- Retry: the backoff schedule, retries then success, exhaustion, terminal
  errors, and the IO budget's schedule equal to the JAX package's.
- Snapshots: cadence crossing, double-buffer isolation and retention; the
  preemption handler's flag and restore.
- A mid-epoch preemption (``preempt:step=K``, in process) resumed from its
  final snapshot ends bit-identical to the uninterrupted run: one update a
  call, windows of 4 and the resident feed.
- The CLI: ``kill:step=11`` exits 137 and ``preempt:step=5`` (cadence off)
  exits 143, each resumed with ``--resume`` to final parameters
  bit-identical to a control run.
- Storage faults: ``ioerr`` is absorbed by the retry, ``enospc`` degrades
  to ``snapshot.write_errors`` while training finishes, ``torn`` and
  ``bitrot`` are caught by the checksums and the resume falls back to the
  previous save.
- A snapshot written by either package restores in the other.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import tpu_dp.config as jax_config
from torch_ddp_worker import run_trainer
from torch_port_util import ROOT
from tpu_dp import checkpoint as jck
from tpu_dp.parallel import dist as jax_dist
from tpu_dp.resilience import faultinject as jfi
from tpu_dp.resilience import preempt as jpreempt
from tpu_dp.resilience import retry as jretry
from tpu_dp.resilience import snapshot as jsnap
from tpu_dp.train.trainer import Trainer as JaxTrainer
from tpu_dp_torch import checkpoint as ck
from tpu_dp_torch.config import parse_cli
from tpu_dp_torch.obs.counters import counters
from tpu_dp_torch.resilience import (
    KILL_EXIT_CODE,
    PREEMPTED_EXIT_CODE,
    FaultInjector,
    FaultPlan,
    PeerFailedError,
    PreemptedError,
    PreemptionHandler,
    SnapshotManager,
    configure_io_retry,
    resume_latest,
    retry_call,
)
from tpu_dp_torch.resilience import retry as pretry
from tpu_dp_torch.train.trainer import Trainer

pytestmark = pytest.mark.port

torch.set_num_threads(2)

#: the reference `Net`, batch 4: 12 updates an epoch, 2 epochs.
_NET = ["--data.dataset=synthetic", "--data.synthetic_train_size=48",
        "--data.synthetic_test_size=8", "--train.epochs=2",
        "--train.log_every=100", "--data.augment=true"]


@pytest.fixture(autouse=True)
def _io_budget_and_shim():
    """The IO budget and the storage shim are per process: each test
    starts and ends with the defaults and nothing armed."""
    from tpu_dp_torch.chaos.storage import shim

    shim.reset()
    yield
    shim.reset()
    configure_io_retry(pretry.DEFAULT_IO_RETRY_S)


# -- fault plans ---------------------------------------------------------------

_SPECS = ["kill:step=13", "kill:step=13,rank=1", "delay:step=5,ms=250",
          "preempt:rank=2,step=9", "ioerr:step=6,n=2", "enospc:step=6",
          "torn:step=6", "bitrot:step=6", "spike:step=4,scale=1e4",
          "sdc:step=4,rank=2,leaf=conv1/*", "slowfs:step=6,ms=100",
          "bitrot:step=4;spike:step=8,scale=1e6", " ;kill:step=3;"]


@pytest.mark.parametrize("spec", _SPECS)
def test_fault_plans_parse_as_in_jax(spec):
    mine = FaultPlan.parse_schedule(spec)
    theirs = jfi.FaultPlan.parse_schedule(spec)
    assert [dataclasses.asdict(p) for p in mine] == [
        dataclasses.asdict(p) for p in theirs]
    assert [p.to_spec() for p in mine] == [p.to_spec() for p in theirs]


@pytest.mark.parametrize("spec,message", [
    ("explode:step=1", "unknown fault kind"), ("kill:rank=1", "needs step"),
    ("kill:step=1,when=now", "bad fault field"),
    ("spike:step=1", "needs scale")])
def test_bad_fault_specs_fail_as_in_jax(spec, message):
    for plan in (FaultPlan, jfi.FaultPlan):
        with pytest.raises(ValueError, match=message):
            plan.parse(spec)


def test_fault_injector_rank_filter_one_shot_and_env(monkeypatch):
    inj = FaultInjector(FaultPlan(kind="kill", step=0, rank=1), rank=0)
    inj.on_step(100)  # a kill for rank 1 never fires on rank 0
    assert not inj.fired
    inj = FaultInjector(FaultPlan(kind="delay", step=5, delay_ms=1), rank=0)
    inj.on_step(4)
    assert not inj.fired
    inj.on_step(6)
    assert inj.fired and inj.fired_kind("delay")
    assert FaultInjector.from_spec("", rank=0) is None
    monkeypatch.setenv("TPU_DP_FAULT", "delay:step=3,ms=1")
    inj = FaultInjector.from_spec("", rank=2)
    assert inj.plan.kind == "delay" and inj.rank == 2
    assert (KILL_EXIT_CODE, PREEMPTED_EXIT_CODE) == (
        jfi.KILL_EXIT_CODE, jpreempt.PREEMPTED_EXIT_CODE) == (137, 143)


def test_nan_fault_is_refused_with_the_jax_packages_message(tmp_path):
    spec = "nan:step=4"
    cfg = jax_config.parse_cli(["--data.dataset=synthetic",
                                "--data.synthetic_train_size=16",
                                f"--train.ckpt_dir={tmp_path}",
                                f"--resilience.fault={spec}"])
    with pytest.raises(ValueError) as theirs:
        JaxTrainer(cfg, mesh=jax_dist.data_mesh(num_devices=1))
    with pytest.raises(ValueError) as mine:
        parse_cli([f"--resilience.fault={spec}"])
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("spec,item", [
    ("spike:step=4,scale=10", "guard.enabled=true"),
    ("drop:step=2,rank=1", "host ring"), ("drop:step=4", "host ring"),
    ("kill:step=9;drop:step=4", "host ring")])
def test_faults_of_later_items_are_refused(tmp_path, monkeypatch, spec,
                                           item):
    with pytest.raises(ValueError, match=item):
        parse_cli([f"--resilience.fault={spec}"])
    # From the environment too, at the Trainer.
    monkeypatch.setenv("TPU_DP_FAULT", spec)
    with pytest.raises(ValueError, match=item):
        Trainer(parse_cli(_NET + [f"--train.ckpt_dir={tmp_path}"]),
                device="cpu")


@pytest.mark.parametrize("spec", [
    "kill:step=3", "preempt:step=3", "delay:step=3,ms=1", "ioerr:step=3",
    "enospc:step=3", "torn:step=3", "bitrot:step=3"])
def test_step_boundary_and_storage_faults_are_taken(spec):
    assert parse_cli([f"--resilience.fault={spec}"]).resilience.fault == spec


def test_resilience_and_obs_fields_parse_and_round_trip():
    args = ["--resilience.snapshot_every_steps=10",
            "--resilience.snapshot_keep=3", "--resilience.snapshot_dir=s",
            "--resilience.handle_signals=false",
            "--resilience.max_retries=4",
            "--resilience.retry_base_delay_s=0.2",
            "--resilience.fault=kill:step=7", "--resilience.io_retry_s=0.5",
            "--obs.flightrec_capacity=64", "--obs.run_dir=o"]
    mine, theirs = parse_cli(args), jax_config.parse_cli(args)
    d = mine.to_dict()
    for section in ("resilience", "obs"):
        assert d[section] == dataclasses.asdict(getattr(theirs, section))
    assert type(mine).from_dict(d) == mine
    with pytest.raises(ValueError, match="is not a int"):
        type(mine).from_dict({"resilience": {"snapshot_keep": 2.5}})
    with pytest.raises(ValueError, match="is not a bool"):
        type(mine).from_dict({"resilience": {"handle_signals": 1}})


# -- retry ---------------------------------------------------------------------


def test_backoff_and_io_schedule_are_jaxs():
    assert pretry.backoff_delays(4, 0.05, 2.0) == [0.05, 0.1, 0.2, 0.4]
    assert pretry.backoff_delays(8, 0.05, 2.0)[-1] == 2.0
    for total in (0.01, 0.5, 3.1, 10.0, 60.0):
        assert pretry.io_retry_schedule(total) == \
            jretry.io_retry_schedule(total)
    configure_io_retry(0.5)
    assert pretry.io_retry_params() == jretry.io_retry_schedule(0.5)


def test_retry_call_retries_exhausts_and_stops_at_terminal_errors():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert retry_call(flaky, retries=3, base_delay=0.05,
                      sleep=slept.append) == "ok"
    assert slept == [0.05, 0.1]
    slept.clear()
    with pytest.raises(RuntimeError, match="gone"):
        retry_call(lambda: (_ for _ in ()).throw(RuntimeError("gone")),
                   retries=2, base_delay=0.01, sleep=slept.append)
    assert len(slept) == 2
    calls.clear()

    def typed():
        calls.append(1)
        raise PeerFailedError("attributed", rank=0, world=2,
                              suspect_ranks=(1,))

    with pytest.raises(PeerFailedError) as e:
        retry_call(typed, retries=5, sleep=lambda s: None)
    assert len(calls) == 1 and e.value.suspect_ranks == (1,)
    with pytest.raises(ValueError):
        retry_call(lambda: int("x"), retries=5, sleep=lambda s: None)


# -- snapshots and the handler -------------------------------------------------


@pytest.fixture()
def net_trainer(tmp_path):
    t = Trainer(parse_cli(_NET + [f"--train.ckpt_dir={tmp_path / 'ck'}",
                                  "--train.epochs=1"]), device="cpu")
    return t


def test_snapshot_cadence_crossing_semantics(tmp_path, net_trainer):
    state = net_trainer.state
    snap = SnapshotManager(tmp_path / "s", every_steps=50)
    assert not snap.due(49) and snap.due(50) and snap.due(72)
    snap.snapshot(state, 72)
    assert not snap.due(99) and snap.due(100)
    snap.close()
    off = SnapshotManager(tmp_path / "off", every_steps=0)
    assert not off.due(10_000)
    assert off.maybe(state, 10_000) is None
    assert off.snapshot(state, 7) is not None  # explicit still works
    off.close()
    # The same decisions as the JAX package's manager along a run.
    mine, theirs = (SnapshotManager(tmp_path / "m", every_steps=10),
                    jsnap.SnapshotManager(tmp_path / "j", every_steps=10))
    for step in (3, 9, 10, 14, 20, 24, 48, 49, 50, 7, 12):
        assert mine.due(step) == theirs.due(step), step
        if mine.due(step) or step == 7:  # 7: a rewound clock
            mine.rewind(step)
            theirs.rewind(step)


def test_snapshot_double_buffer_isolation_and_gc(tmp_path, net_trainer):
    state, model = net_trainer.state, net_trainer.model
    w = model.conv1.weight
    with torch.no_grad():
        w.fill_(1.0)
    with SnapshotManager(tmp_path, every_steps=1, keep=2) as snap:
        snap.snapshot(state, 1)
        with torch.no_grad():
            w.fill_(2.0)  # after the snapshot: the buffer must not alias
        snap.snapshot(state, 2)
        snap.wait()
        raw1, _ = ck.read_checkpoint(tmp_path / "step_0000000001")
        raw2, meta2 = ck.read_checkpoint(tmp_path / "step_0000000002")
        assert float(raw1["params"]["conv1"]["kernel"].flat[0]) == 1.0
        assert float(raw2["params"]["conv1"]["kernel"].flat[0]) == 2.0
        assert meta2["kind"] == "snapshot" and meta2["global_step"] == 2
        with torch.no_grad():
            w.fill_(3.0)
        snap.snapshot(state, 3)  # slot 0 again, after its write was joined
        snap.wait()
        assert sorted(p.name for p in tmp_path.glob("step_*")) == [
            "step_0000000002", "step_0000000003"]
        assert snap.latest_dir().name == "step_0000000003"
        raw3, _ = ck.read_checkpoint(tmp_path / "step_0000000003")
        assert float(raw3["params"]["conv1"]["kernel"].flat[0]) == 3.0
        with torch.no_grad():
            w.fill_(0.0)
        snap.restore(state)
        assert float(w.detach().flatten()[0]) == 3.0


def test_preemption_handler_flag_and_restore():
    prev = signal.getsignal(signal.SIGTERM)
    before = counters.get("preempt.signals")
    with PreemptionHandler() as h:
        assert not h.requested
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not h.requested and time.monotonic() < deadline:
            time.sleep(0.01)
        assert h.requested and h.last_signal == signal.SIGTERM
        os.kill(os.getpid(), signal.SIGTERM)  # repeated: still a flag
        time.sleep(0.05)
        assert h.requested
    assert signal.getsignal(signal.SIGTERM) is prev
    assert counters.get("preempt.signals") == before + 2


# -- preempt and resume, in process ---------------------------------------------


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.parametrize("extra", [
    [], ["--train.steps_per_call=4"],
    ["--train.steps_per_call=4", "--data.device_resident=on"]],
    ids=["windows_1", "windows_4", "resident"])
def test_mid_epoch_preempt_resumes_bit_identical(tmp_path, extra):
    feed = extra or ["--data.device_resident=off"]
    args = _NET + feed + ["--resilience.snapshot_every_steps=3"]
    full = run_trainer(args + [f"--train.ckpt_dir={tmp_path / 'full'}"])
    run = [f"--train.ckpt_dir={tmp_path / 'run'}"]
    part = run_trainer(args + run + ["--resilience.fault=preempt:step=15"])
    assert part["preempted"] and "epoch 1" in part["preempted"]
    step = 15 if not extra else 16  # the first boundary at or past 15
    snaps = sorted(p.name for p in (tmp_path / "run" / "snapshots").glob(
        "step_*"))
    assert snaps[-1] == f"step_{step:010d}"
    resumed = run_trainer(args + run + ["--resume"])
    assert resumed["start"] == (1, step - 12)
    assert "snapshots" in resumed["resumed_from"]
    assert _same(resumed["restored"], part["final"])
    assert resumed["losses"] == full["losses"][step:]
    assert _same(resumed["final"], full["final"])
    assert resumed["eval"] == full["eval"]


# -- the CLI: kill and preempt, then --resume ------------------------------------

_CLI = ["--data.dataset=synthetic", "--data.synthetic_train_size=64",
        "--data.synthetic_test_size=16", "--data.batch_size=8",
        "--train.epochs=2", "--train.log_every=100",
        "--train.eval_at_end=false", "--optim.lr=0.05",
        "--data.augment=true", "--resilience.snapshot_every_steps=3"]


def _cli(ckpt, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
    env.pop("TPU_DP_FAULT", None)
    return subprocess.run(
        [sys.executable, "-m", "tpu_dp_torch.train", "--device", "cpu",
         f"--train.ckpt_dir={ckpt}", *_CLI, *extra], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)


@pytest.fixture(scope="module")
def cli_control(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("control") / "ck"
    proc = _cli(ckpt)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return (ckpt / "final_params.msgpack").read_bytes()


def test_cli_kill_exits_137_and_resumes_bit_identical(tmp_path, cli_control):
    ckpt = tmp_path / "ck"
    killed = _cli(ckpt, "--resilience.fault=kill:step=11")
    assert killed.returncode == KILL_EXIT_CODE, killed.stderr[-3000:]
    assert not (ckpt / "final_params.msgpack").exists()
    # Cadence 3: the step-9 snapshot landed, the kill came after step 11.
    assert (ckpt / "snapshots" / "step_0000000009").exists()
    resumed = _cli(ckpt, "--resume")
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert "snapshots" in resumed.stdout.strip().splitlines()[-1]
    assert (ckpt / "final_params.msgpack").read_bytes() == cli_control


def test_cli_preempt_exits_143_and_resumes_bit_identical(tmp_path,
                                                         cli_control):
    ckpt = tmp_path / "ck"
    pre = _cli(ckpt, "--resilience.fault=preempt:step=5",
               "--resilience.snapshot_every_steps=0")
    assert pre.returncode == PREEMPTED_EXIT_CODE, pre.stderr[-3000:]
    assert "preempted: preempted at epoch 0, step-in-epoch 5" in pre.stdout
    # With the cadence off the final snapshot still landed.
    assert [p.name for p in (ckpt / "snapshots").glob("step_*")] == [
        "step_0000000005"]
    resumed = _cli(ckpt, "--resume")
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert (ckpt / "final_params.msgpack").read_bytes() == cli_control


# -- storage faults --------------------------------------------------------------


def _fit(tmp_path, *extra, name="run", snapshot_commits_first=False):
    """A `Trainer` of ``_NET`` fitted. ``snapshot_commits_first``: the
    snapshot writes in flight are joined before each epoch save is
    enqueued, so a save-corrupting fault armed before both hits the
    snapshot (two writer threads would otherwise race to commit first)."""
    t = Trainer(parse_cli(_NET + ["--data.device_resident=off",
                                  f"--train.ckpt_dir={tmp_path / name}",
                                  *extra]), device="cpu")
    if snapshot_commits_first:
        save_epoch = t._save_epoch

        def ordered(epoch):
            t.snap_mgr.wait()
            save_epoch(epoch)

        t._save_epoch = ordered
    t.fit()
    return t


def test_ioerr_is_absorbed_by_the_retry(tmp_path):
    before = {k: counters.get(k) for k in ("retry.retries",
                                           "snapshot.write_errors",
                                           "chaos.storage_faults")}
    t = _fit(tmp_path, "--resilience.snapshot_every_steps=4",
             "--resilience.snapshot_keep=0",
             "--resilience.fault=ioerr:step=6,n=2",
             "--resilience.io_retry_s=0.5")
    assert counters.get("chaos.storage_faults") - before[
        "chaos.storage_faults"] == 2
    assert counters.get("retry.retries") - before["retry.retries"] >= 2
    assert counters.get("snapshot.write_errors") == before[
        "snapshot.write_errors"]
    # The snapshot after the arming (step 8) committed all the same.
    raw, meta = ck.read_checkpoint(tmp_path / "run" / "snapshots"
                                   / "step_0000000008")
    assert meta["steps_done"] == 8 and int(raw["step"]) == 8
    assert t.state.step == 24


def test_enospc_degrades_to_write_errors_and_training_finishes(tmp_path):
    before = counters.get("snapshot.write_errors")
    ck_before = counters.get("ckpt.write_errors")
    t = _fit(tmp_path, "--resilience.snapshot_every_steps=4",
             "--resilience.fault=enospc:step=6",
             "--resilience.io_retry_s=0.01")
    assert t.state.step == 24  # the run finished
    assert counters.get("snapshot.write_errors") > before
    assert counters.get("ckpt.write_errors") > ck_before  # epoch saves too
    snaps = sorted(p.name for p in (tmp_path / "run" / "snapshots").glob(
        "step_*") if not ck.missing_save_files(p))
    assert snaps == ["step_0000000004"]  # nothing committed after arming


@pytest.mark.parametrize("kind", ["torn", "bitrot"])
def test_torn_and_bitrot_are_caught_and_resume_falls_back(tmp_path, kind):
    _fit(tmp_path, "--resilience.snapshot_every_steps=4",
         "--train.epochs=1", f"--resilience.fault={kind}:step=9",
         snapshot_commits_first=True)
    snaps = tmp_path / "run" / "snapshots"
    victim = snaps / "step_0000000012"  # the first commit after arming
    with pytest.raises(ck.CorruptCheckpointError):
        ck.read_checkpoint(victim)
    # The epoch checkpoint of step 12 outranks the snapshot; remove it to
    # make the corrupt snapshot the newest candidate.
    import shutil

    shutil.rmtree(tmp_path / "run" / "step_0000000012")
    (tmp_path / "run" / "latest").unlink()
    t = Trainer(parse_cli(_NET + ["--data.device_resident=off",
                                  f"--train.ckpt_dir={tmp_path / 'run'}",
                                  "--train.epochs=1"]), device="cpu")
    _, meta, source = resume_latest(t.state, tmp_path / "run", snaps)
    assert source == snaps / "step_0000000008" and meta["steps_done"] == 8
    assert (victim / ck.QUARANTINED_MARKER).exists()


# -- snapshots across the two packages -------------------------------------------


def test_snapshots_restore_across_packages(tmp_path):
    args = ["--data.dataset=synthetic", "--data.synthetic_train_size=16",
            "--data.synthetic_test_size=4", "--train.epochs=1",
            "--data.device_resident=off", "--resilience.handle_signals=false"]
    jt = JaxTrainer(jax_config.parse_cli(
        args + [f"--train.ckpt_dir={tmp_path / 'j'}"]),
        mesh=jax_dist.data_mesh(num_devices=1))
    # The JAX package's snapshot → the port's resume.
    jm = jsnap.SnapshotManager(tmp_path / "jsnap", every_steps=0)
    jm.snapshot(jt.state, 0, {"kind": "snapshot", "epoch": 0,
                              "steps_done": 2, "seed": 0})
    jm.close()
    pt = Trainer(parse_cli(args + [f"--train.ckpt_dir={tmp_path / 'p'}"]),
                 device="cpu")
    _, meta, source = resume_latest(pt.state, tmp_path / "p",
                                    tmp_path / "jsnap")
    assert meta["kind"] == "snapshot" and source.parent.name == "jsnap"
    assert pt._resume_position(meta) == (0, 2)
    theirs = dict(ck._walk_state_dict(
        __import__("flax").serialization.to_state_dict(
            jck._to_host(jt.state))))
    mine = dict(ck._walk_state_dict(ck.state_dict_of(pt.state)))
    for k, v in theirs.items():
        if k.startswith(("params/", "opt_state/", "batch_stats/")):
            np.testing.assert_array_equal(mine[k], v)
    # The port's snapshot → the JAX package's resume.
    with torch.no_grad():
        for p in pt.model.parameters():
            p.add_(0.5)
    pm = SnapshotManager(tmp_path / "psnap", every_steps=0)
    pm.snapshot(pt.state, 3, pt._snapshot_meta(0, 3))
    pm.close()
    restored, jmeta, jsource = jpreempt.resume_latest(
        jt.state, tmp_path / "j_none", tmp_path / "psnap")
    assert jmeta["kind"] == "snapshot" and jmeta["steps_done"] == 3
    mine = dict(ck._walk_state_dict(ck.state_dict_of(pt.state)))
    back = dict(ck._walk_state_dict(
        __import__("flax").serialization.to_state_dict(
            jck._to_host(restored))))
    for k, v in mine.items():
        if k.startswith(("params/", "opt_state/", "batch_stats/")):
            np.testing.assert_array_equal(back[k], v)
