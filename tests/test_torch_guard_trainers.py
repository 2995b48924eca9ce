"""The port's guarded `Trainer` against the JAX package's guarded
`Trainer` (mirrors the Trainer cases of tests/test_guard.py).

Both start from the JAX `Trainer`'s init (the port resumes from its save)
on the reference `Net`, batch 4, the resident feed, augmentation on:

- ``nan:step=5`` under ``action=skip``, one update a call and windows of
  4 (where the frozen counter quarantines the rest of the window): per
  update losses and final parameters within 1e-4, the same quarantine
  records (epoch, step, sample range, rank, reason), the same update
  counter;
- the armed device cap under ``action=skip``: a ``spike:`` caught before
  its update applied, the same records;
- ``spike:`` under ``action=rollback`` with snapshots every 5 and the LR
  ease: the same spike and tombstone records (rolled back from 9 to 5,
  generation 1), the same learning-rate scales fed to the sentinel, the
  final parameters within 1e-4, a post-rollback snapshot naming its
  generation;
- ``action=halt`` raises `DivergedError`; the CLI prints ``diverged:`` and
  exits 65;
- an ``sdc:`` fault flips exactly one element of the glob's one leaf, the
  bits the JAX package flips; with the audit on (world 1) the run goes on;
- the guard's knobs are refused with the JAX package's messages, a
  ``nan:`` fault without the guard too, and a ``--config`` meta with guard
  fields loads.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import tpu_dp.config as jax_config
from torch_port_util import ROOT
from tpu_dp import checkpoint as jck
from tpu_dp.parallel import dist as jax_dist
from tpu_dp.resilience import faultinject as jfi
from tpu_dp.train.trainer import Trainer as JaxTrainer
from tpu_dp_torch.compat import convert_grads
from tpu_dp_torch.config import parse_cli
from tpu_dp_torch.resilience import (
    DivergedError,
    FaultPlan,
    QuarantineLog,
    live_records,
)
from tpu_dp_torch.train.trainer import Trainer

pytestmark = pytest.mark.port

torch.set_num_threads(2)

_NET = ["--data.dataset=synthetic", "--data.synthetic_train_size=48",
        "--data.synthetic_test_size=8", "--train.epochs=1",
        "--train.log_every=100", "--train.eval_at_end=false",
        "--data.augment=true", "--data.device_resident=on",
        "--train.ckpt_async=false", "--resilience.handle_signals=false",
        "--guard.enabled=true"]
_CAP = ["--resilience.fault=spike:step=8,scale=1e3", "--guard.action=skip",
        "--guard.spike_min_steps=4", "--guard.spike_window=8",
        "--guard.spike_z=6"]
_ROLLBACK = ["--resilience.fault=spike:step=8,scale=1e6",
             "--resilience.snapshot_every_steps=5", "--guard.action=rollback",
             "--guard.spike_min_steps=4", "--guard.spike_window=16",
             "--guard.spike_z=12", "--train.epochs=2",
             "--guard.lr_ease_steps=4", "--guard.lr_ease_start=0.25"]
_RUNS = {
    "nan-1": ["--resilience.fault=nan:step=5"],
    "nan-window4": ["--resilience.fault=nan:step=5",
                    "--train.steps_per_call=4"],
    "cap": _CAP,
    "rollback": _ROLLBACK,
}


def _records(path):
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in QuarantineLog(path).read()]


def _jax_fit(tmp, extra):
    """The JAX guarded `Trainer` on ``_NET + extra``: its per-update
    losses, its guard inputs' lr scales, its records, final parameters and
    counter, and its init's save (meta epoch -1)."""
    cfg = jax_config.parse_cli(_NET + extra + [
        f"--train.ckpt_dir={tmp / 'run'}"])
    trainer = JaxTrainer(cfg, mesh=jax_dist.data_mesh(num_devices=1))
    init = tmp / "init"
    jck.CheckpointManager(init, async_save=False).save(
        trainer.state, {"epoch": -1, "config": cfg.to_dict(), "seed": 0})
    losses, scales = [], []
    real_loop, real_in = trainer._resident_loop, trainer._guard_hook.guard_in

    def loop_of(n):
        loop = real_loop(n)

        def run(state, data, idx, *a):
            state, stacked = loop(state, data, idx, *a)
            losses.extend(np.asarray(stacked["loss"]).tolist())
            return state, stacked
        return run

    def guard_in(first, n):
        gi = real_in(first, n)
        scales.append(float(gi["lr_scale"]))
        return gi

    trainer._resident_loop = loop_of
    trainer._guard_hook.guard_in = guard_in
    trainer.fit()
    params = convert_grads(jax.tree_util.tree_map(np.asarray,
                                                  trainer.state.params))
    return {"losses": losses, "scales": scales, "init": init,
            "records": _records(tmp / "run" / "quarantine.jsonl"),
            "params": {k: v.numpy() for k, v in params.items()},
            "step": int(np.asarray(trainer.state.step)),
            "host_step": trainer._host_step,
            "generation": trainer._rollback_gen}


def _port_fit(tmp, extra, init):
    ckpt = tmp / "port"
    shutil.copytree(init, ckpt)
    trainer = Trainer(parse_cli(_NET + extra + [
        f"--train.ckpt_dir={ckpt}", "--resume"]), device="cpu")
    assert (trainer.start_epoch, trainer.start_step) == (0, 0)
    scales = []
    real_in = trainer._guard_hook.guard_in

    def guard_in(first, n):
        gi = real_in(first, n)
        scales.append(float(gi["lr_scale"]))
        return gi

    trainer._guard_hook.guard_in = guard_in
    trainer.fit()
    return trainer, scales


@pytest.mark.parametrize("run", sorted(_RUNS))
def test_guarded_trainer_tracks_the_jax_guarded_trainer(tmp_path, run):
    extra = _RUNS[run]
    theirs = _jax_fit(tmp_path / "jax", extra)
    mine, scales = _port_fit(tmp_path, extra, theirs["init"])
    got = _records(mine.quarantine_path)
    assert [r["kind"] for r in got] == [r["kind"] for r in theirs["records"]]
    keys = ("epoch", "step", "sample_range", "rank", "from_step", "to_step",
            "rollback_generation", "field", "action")
    for a, b in zip(got, theirs["records"]):
        assert {k: a.get(k) for k in keys} == {k: b.get(k) for k in keys}
        if a["kind"] == "quarantine" and "non-finite" in b["reason"]:
            assert a["reason"] == b["reason"]
        elif a["kind"] == "quarantine":
            # "loss X over the armed device cap at step N": X is each
            # package's own f32 loss.
            assert a["reason"].split()[2:] == b["reason"].split()[2:]
    assert scales == theirs["scales"]
    assert mine.state.step == theirs["step"]
    assert mine._host_step == theirs["host_step"]
    assert mine._rollback_gen == theirs["generation"]
    params = {k: p.detach().numpy() for k, p in
              mine.model.named_parameters()}
    for k, v in theirs["params"].items():
        np.testing.assert_allclose(params[k], v, atol=1e-4, rtol=0,
                                   err_msg=k)
    if run != "rollback":
        # The JAX loop's losses include no rolled-back pass here.
        assert len(mine.step_losses) == len(theirs["losses"])
        diffs = [abs(a - b) for a, b in zip(mine.step_losses,
                                            theirs["losses"])]
        assert max(diffs) <= 1e-4
    if run.startswith("nan"):
        want = [6] if run == "nan-1" else [6, 7, 8]
        assert [r["step"] for r in got] == want
        assert mine.state.step == 12 - len(want)
    if run == "cap":
        assert [r["step"] for r in got] == [9]
        assert "armed device cap" in got[0]["reason"]
    if run == "rollback":
        tomb = [r for r in got if r["kind"] == "tombstone"]
        assert [(r["from_step"], r["to_step"]) for r in tomb] == [(9, 5)]
        # The ease from the rewind at step 5 over 4 steps, from 0.25.
        assert mine.state.step == 24
        assert [v for v in scales if v != 1.0] == [0.4375, 0.625, 0.8125]
        assert {"tombstone", "spike"} == {r["kind"] for r in got}
        assert all(r["kind"] != "spike" for r in live_records(got))
        meta = json.loads((mine.snap_mgr.latest_dir() / "meta.json")
                          .read_text())
        assert meta["rollback_generation"] == 1
        # The JAX loop saw the rolled-back pass (batches 5..8) too.
        want = theirs["losses"][:5] + theirs["losses"][9:]
        assert len(mine.step_losses) == len(want) == 24
        diffs = [abs(a - b) for a, b in zip(mine.step_losses, want)]
        assert max(diffs) <= 1e-4
        assert all(math.isfinite(v) for v in mine.step_losses)


def test_rollback_rearms_the_snapshot_and_audit_cadences(tmp_path):
    """As tests/test_guard.py's case: rewound from 9 to the step-6
    snapshot, the replay is snapshotted again (step 9, generation 1) and
    audited again (12 steps at cadence 4 with one rewind: 4, 8, 8, 12)."""
    from tpu_dp_torch.obs.counters import counters

    audits = counters.get("guard.sdc_audits")
    trainer = Trainer(parse_cli(_NET + [
        f"--train.ckpt_dir={tmp_path}", "--data.device_resident=off",
        "--resilience.fault=spike:step=8,scale=1e6",
        "--resilience.snapshot_every_steps=3", "--guard.action=rollback",
        "--guard.spike_min_steps=4", "--guard.spike_window=16",
        "--guard.spike_z=12", "--guard.sdc_every_steps=4"]), device="cpu")
    trainer.fit()
    assert trainer._rollback_gen == 1
    meta = json.loads((tmp_path / "snapshots" / "step_0000000009" /
                       "meta.json").read_text())
    assert meta["rollback_generation"] == 1
    assert counters.get("guard.sdc_audits") - audits == 4


def test_halt_raises_diverged_error(tmp_path):
    trainer = Trainer(parse_cli(_NET + [
        f"--train.ckpt_dir={tmp_path}", "--resilience.fault=nan:step=3",
        "--guard.action=halt"]), device="cpu")
    with pytest.raises(DivergedError, match="non-finite update at step 4"):
        trainer.fit()
    assert trainer._host_step == 4 and trainer.state.step == 3


def test_cli_halt_exits_65(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_dp_torch.train", "--device", "cpu",
         *_NET, f"--train.ckpt_dir={tmp_path}", "--guard.action=halt",
         "--resilience.fault=nan:step=2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 65, proc.stderr[-2000:]
    assert "diverged: guard halt: non-finite update at step 3" in proc.stdout


def test_sdc_flips_the_bits_the_jax_package_flips(tmp_path):
    spec = "sdc:step=3,rank=0,leaf=*conv1*kernel*"
    cfg = jax_config.parse_cli(_NET + [f"--train.ckpt_dir={tmp_path / 'j'}",
                                       f"--resilience.fault={spec}"])
    theirs = JaxTrainer(cfg, mesh=jax_dist.data_mesh(num_devices=1))
    jck.CheckpointManager(tmp_path / "p", async_save=False).save(
        theirs.state, {"epoch": -1, "config": cfg.to_dict(), "seed": 0})
    mine = Trainer(parse_cli(_NET + [
        f"--train.ckpt_dir={tmp_path / 'p'}", "--resume",
        f"--resilience.fault={spec}", "--guard.sdc_every_steps=4",
        "--guard.sdc_action=warn"]), device="cpu")
    before = {k: v.clone() for k, v in mine.model.state_dict().items()}
    plan = FaultPlan.parse(spec)
    mine._inject_sdc(plan)
    theirs._inject_sdc(jfi.FaultPlan.parse(spec))
    after = mine.model.state_dict()
    changed = {k: int((after[k].view(-1).view(torch.int32)
                       != before[k].view(-1).view(torch.int32)).sum())
               for k in after}
    assert {k: n for k, n in changed.items() if n} == {"conv1.weight": 1}
    flipped = (after["conv1.weight"].view(-1).view(torch.int32)
               ^ before["conv1.weight"].view(-1).view(torch.int32))
    assert int(flipped.abs().max()) == 1 << 30
    want = convert_grads(jax.tree_util.tree_map(np.asarray,
                                                theirs.state.params))
    for k, v in want.items():
        assert after[k].numpy().tobytes() == v.numpy().tobytes(), k
    # A run with the fault and the audit (world 1: always consistent).
    from tpu_dp_torch.obs.counters import counters

    audits = counters.get("guard.sdc_audits")
    run = Trainer(parse_cli(_NET + [
        f"--train.ckpt_dir={tmp_path / 'run'}", f"--resilience.fault={spec}",
        "--guard.sdc_every_steps=4", "--guard.sdc_action=halt"]),
        device="cpu")
    run.fit()
    assert counters.get("guard.sdc_audits") - audits == 3
    assert run.fault.fired_kind("sdc")


@pytest.mark.parametrize("knob", [
    "--guard.action=explode", "--guard.sdc_action=evict",
    "--guard.spike_window=3", "--guard.spike_z=0"])
def test_guard_knobs_are_refused_with_the_jax_messages(tmp_path, knob):
    args = _NET + [knob]
    with pytest.raises(ValueError) as theirs:
        JaxTrainer(jax_config.parse_cli(args + [
            f"--train.ckpt_dir={tmp_path}"]),
            mesh=jax_dist.data_mesh(num_devices=1))
    with pytest.raises(ValueError) as mine:
        parse_cli(args)
    assert str(mine.value) == str(theirs.value)


def test_guard_fields_parse_round_trip_and_load_from_a_jax_meta(tmp_path):
    args = ["--preset=resnet18_cifar10", "--guard.enabled=true",
            "--guard.action=rollback", "--guard.spike_window=32",
            "--guard.spike_z=6.5", "--guard.spike_min_steps=8",
            "--guard.device_cap=false", "--guard.max_rollbacks=2",
            "--guard.lr_ease_steps=10", "--guard.lr_ease_start=0.2",
            "--guard.sdc_every_steps=50", "--guard.sdc_action=warn",
            "--guard.quarantine_path=q.jsonl",
            "--resilience.fault=spike:step=4,scale=10;sdc:step=2"]
    mine, theirs = parse_cli(args), jax_config.parse_cli(args)
    assert mine.to_dict()["guard"] == theirs.to_dict()["guard"]
    assert jax_config.Config.from_dict(
        json.loads(json.dumps(mine.to_dict()))) == theirs
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps({"epoch": 0, "config": theirs.to_dict()}))
    assert parse_cli([f"--config={meta}", "--train.ckpt_dir=x"]).guard == (
        mine.guard)
    # nan/spike still need the guard, with the JAX package's message.
    with pytest.raises(ValueError, match="requires guard.enabled=true"):
        parse_cli(["--resilience.fault=spike:step=4,scale=10"])
    assert parse_cli(["--resilience.fault=sdc:step=2"]).resilience.fault
