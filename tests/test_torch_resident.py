"""The device-resident feed of the port (``data.device_resident``,
``data.resident_max_bytes``, ``data.sync_placement``) against its streamed
feed and against the JAX package's resident feed.

- `DataPipeline.index_windows` names, window for window and element for
  element, the examples `windows` ships, and its indices equal the JAX
  package's `index_windows` (with accumulation and a ``skip_steps``
  resume); `dataset_bytes` is the JAX package's measure.
- The feed knobs parse with the JAX package's checks and messages, and the
  auto decision is the JAX package's at three budgets.
- Training on the resident feed is bit-identical to the streamed feed in
  the port (losses, parameters, BatchNorm statistics, momentum, eval): one
  update a call, windows of 4, accumulation 2, the sharded update in f32,
  the fused ResNet-18 with augmentation, a mid-epoch resume, and two gloo
  ranks against each other. On the CPU both feeds run the same update body
  on the same uint8 batches, so nothing but equality is allowed.
- The port's resident `Trainer` tracks the JAX package's resident
  `Trainer` (windows of 4, shuffled, augmentation on: the port's crop and
  flip draws are `jax.random`'s bits) within 1e-4 per update loss
  (tests/test_torch_net.py's bound for the two Trainers).
- Two gloo ranks on the resident feed against one process on the
  concatenated batch: per update loss within 1e-5 (the same mean summed
  in another order; `Net` has no BatchNorm).
"""

from __future__ import annotations

import json
import logging
import re
import shutil

import numpy as np
import pytest
import torch

import tpu_dp.config as jax_config
from torch_ddp_worker import flat_state, run_trainer
from torch_port_util import run_worker_ranks
from tpu_dp import checkpoint as jck
from tpu_dp.data.cifar import make_synthetic as jax_make_synthetic
from tpu_dp.data.pipeline import DataPipeline as JaxPipeline
from tpu_dp.parallel import dist as jax_dist
from tpu_dp.train.trainer import Trainer as JaxTrainer
from tpu_dp_torch.config import Config, parse_cli
from tpu_dp_torch.data import pipeline as pl
from tpu_dp_torch.data.cifar import ArrayDataset
from tpu_dp_torch.data.pipeline import DataPipeline
from tpu_dp_torch.train.step import ResidentMultiStep, gather_batch
from tpu_dp_torch.train.trainer import Trainer

pytestmark = pytest.mark.port

torch.set_num_threads(2)

#: the reference preset (`Net`, batch 4), 12 updates an epoch.
_NET = ["--data.dataset=synthetic", "--data.synthetic_train_size=48",
        "--data.synthetic_test_size=8", "--train.epochs=1",
        "--train.log_every=100"]
_RESNET = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
           "--model.fused_bwd=true", "--train.pallas_xent=true",
           "--data.dataset=synthetic", "--data.synthetic_train_size=16",
           "--data.synthetic_test_size=4", "--data.batch_size=4",
           "--train.epochs=1"]


def _port_dataset(n, seed=0):
    ds = jax_make_synthetic(n, 10, seed=seed, name="synthetic")
    return ds, ArrayDataset(ds.images, ds.labels, "synthetic", 10, True)


# -- the feed ------------------------------------------------------------------


@pytest.mark.parametrize("k,accum,skip", [(4, 1, 0), (3, 1, 2), (1, 1, 3),
                                          (2, 2, 1)])
def test_index_windows_name_the_streamed_examples(mesh1, k, accum, skip):
    jds, ds = _port_dataset(9 * 8 + 3)
    pipe = DataPipeline(ds, 8, "cpu", shuffle=True, seed=3, prefetch=0,
                        accum_steps=accum)
    pipe.set_epoch(1)
    streamed = list(pipe.windows(k, skip_steps=skip))
    indexed = list(pipe.index_windows(k, skip_steps=skip))
    table = pipe.resident_data()
    lead = (accum, 8) if accum > 1 else (8,)
    assert [n for n, _ in indexed] == [n for n, _ in streamed]
    assert sum(n for n, _ in indexed) == len(pipe) - skip
    for (n, batch), (_, idx) in zip(streamed, indexed):
        assert idx.dtype == torch.int32 and tuple(idx.shape) == (n, *lead)
        got = gather_batch(table, idx if n > 1 else idx[0])
        for key in ("image", "label"):
            assert got[key].dtype == batch[key].dtype
            assert torch.equal(got[key], batch[key]), key
    jpipe = JaxPipeline(jds, 8, mesh1, shuffle=True, seed=3, prefetch=0,
                        accum_steps=accum)
    jpipe.set_epoch(1)
    theirs = list(jpipe.index_windows(k, skip_steps=skip))
    assert [n for n, _ in theirs] == [n for n, _ in indexed]
    for (_, a), (_, b) in zip(indexed, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_index_windows_need_drop_remainder():
    _, ds = _port_dataset(20)
    pipe = DataPipeline(ds, 8, "cpu", drop_remainder=False)
    with pytest.raises(ValueError, match="requires drop_remainder"):
        pipe.index_windows(4)


def test_staged_table_and_its_budget_measure(mesh1):
    jds, ds = _port_dataset(24)
    pipe = DataPipeline(ds, 8, "cpu")
    assert pipe.dataset_bytes() == JaxPipeline(
        jds, 8, mesh1).dataset_bytes() == 24 * 3072 + 24 * 4
    table = pipe.resident_data()
    assert table["image"].dtype == torch.uint8
    assert table["label"].dtype == torch.int64  # the streamed batches'
    np.testing.assert_array_equal(table["image"].numpy(), ds.images)
    np.testing.assert_array_equal(table["label"].numpy(), ds.labels)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_sync_placement_blocks_once_per_placed_batch(monkeypatch, prefetch):
    blocks = []
    monkeypatch.setattr(pl, "_wait_placed", lambda dev: blocks.append(dev))
    _, ds = _port_dataset(64)

    def placed(sync):
        blocks.clear()
        pipe = DataPipeline(ds, 8, "cpu", shuffle=False, prefetch=prefetch,
                            sync_placement=sync)
        n = len(list(pipe)) + len(list(pipe.windows(3)))
        return n, len(blocks)

    # 8 batches, then windows of 3: two pools and two single steps.
    assert placed(True) == (12, 12)
    assert placed(False) == (12, 0)


# -- the knobs -----------------------------------------------------------------


@pytest.mark.parametrize("knob,field,value", [
    ("--data.resident_max_bytes=1", "resident_max_bytes", 1),
    ("--data.device_resident=on", "device_resident", "on"),
    ("--data.sync_placement=true", "sync_placement", True)])
def test_cli_takes_the_feed_knobs(knob, field, value):
    port = parse_cli(["--preset=resnet18_cifar10", knob])
    theirs = jax_config.parse_cli(["--preset=resnet18_cifar10", knob])
    assert getattr(port.data, field) == getattr(theirs.data, field) == value
    assert jax_config.Config.from_dict(
        json.loads(json.dumps(port.to_dict()))) == theirs
    assert Config.from_dict(theirs.to_dict()) == port


def test_feed_mode_outside_auto_on_off_is_refused_as_in_jax(tmp_path):
    msg = re.escape(
        "data.device_resident must be auto|on|off, got 'sometimes'")
    with pytest.raises(ValueError, match=msg):
        parse_cli(["--data.device_resident=sometimes"])
    cfg = jax_config.parse_cli(["--data.device_resident=sometimes",
                                f"--train.ckpt_dir={tmp_path}"])
    with pytest.raises(ValueError, match=msg):
        JaxTrainer(cfg, mesh=jax_dist.data_mesh(num_devices=1))


def test_resident_on_needs_drop_remainder_as_in_jax(tmp_path):
    args = ["--data.device_resident=on", "--data.drop_remainder=false"]
    msg = "data.device_resident=on requires data.drop_remainder=true"
    with pytest.raises(ValueError, match=msg):
        parse_cli(args)
    cfg = jax_config.parse_cli(args + [f"--train.ckpt_dir={tmp_path}"])
    with pytest.raises(ValueError, match=msg):
        JaxTrainer(cfg, mesh=jax_dist.data_mesh(num_devices=1))


@pytest.mark.parametrize("knobs,resident", [
    ([], True),  # auto, the tiny set fits
    (["--data.resident_max_bytes=1"], False),
    (["--data.device_resident=off"], False),
    (["--data.device_resident=on", "--data.resident_max_bytes=1"], True)])
def test_auto_decision_is_the_jax_packages(tmp_path, caplog, knobs,
                                           resident):
    args = _NET + knobs
    port = Trainer(parse_cli(args + [f"--train.ckpt_dir={tmp_path / 'p'}"]),
                   device="cpu")
    theirs = JaxTrainer(
        jax_config.parse_cli(args + [f"--train.ckpt_dir={tmp_path / 'j'}",
                                     "--resilience.handle_signals=false"]),
        mesh=jax_dist.data_mesh(num_devices=1))
    assert (port.resident_train is not None) == resident
    assert (theirs.resident_train is not None) == resident
    warned = "data.device_resident=on stages 147648 bytes, over " \
             "data.resident_max_bytes=1"
    assert (warned in caplog.text) == ("--data.device_resident=on" in knobs)


def test_trainer_windows_gather_from_the_table(tmp_path):
    cfg = parse_cli(_NET + ["--train.steps_per_call=4",
                            f"--train.ckpt_dir={tmp_path}"])
    trainer = Trainer(cfg, device="cpu")
    assert isinstance(trainer.multi_step, ResidentMultiStep)
    assert trainer._resident_train is None  # staged at the first epoch
    trainer.fit()
    assert trainer.resident_train["image"].shape == (48, 32, 32, 3)
    assert trainer.train_pipe.sync_placement is False


# -- training: resident against streamed ---------------------------------------


def _fit(args, tmp_path, tag):
    trainer = Trainer(parse_cli(args + [f"--train.ckpt_dir={tmp_path / tag}"]),
                      device="cpu")
    result = trainer.fit()
    return trainer, result


@pytest.mark.parametrize("args", [
    _NET + ["--data.augment=true"],
    _NET + ["--train.steps_per_call=4", "--data.augment=true"],
    _NET + ["--optim.grad_accum_steps=2", "--train.steps_per_call=2"],
    _NET + ["--train.update_sharding=sharded", "--train.steps_per_call=4"],
    _RESNET + ["--train.steps_per_call=2"]],
    ids=["net-1", "net-window4", "net-accum2", "net-sharded", "resnet18"])
def test_resident_training_is_the_streamed_training(tmp_path, args):
    res, res_out = _fit(args + ["--data.device_resident=on"], tmp_path, "r")
    flow, flow_out = _fit(args + ["--data.device_resident=off"], tmp_path,
                          "s")
    assert res.resident_train is not None and flow.resident_train is None
    assert res.step_losses == flow.step_losses
    a, b = flat_state(res), flat_state(flow)
    assert a.keys() == b.keys()
    assert any("momentum" in k or "opt_state" in k for k in a)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    assert res_out["eval"] == flow_out["eval"]


def test_mid_epoch_resume_from_a_resident_run_is_bit_identical(tmp_path):
    """Interrupted two updates into epoch 2 (a snapshot-kind save),
    resumed in windows of 4 re-formed from there: the continuation and the
    final state are the uninterrupted run's."""
    args = _NET + ["--train.epochs=2", "--data.augment=true"]
    full = run_trainer(args + [f"--train.ckpt_dir={tmp_path / 'full'}"])
    part_dir = f"--train.ckpt_dir={tmp_path / 'part'}"
    part = run_trainer(args + [part_dir], stop_at_step=14, snapshot=True)
    resumed = run_trainer(args + [part_dir, "--resume",
                                  "--train.steps_per_call=4"])
    assert resumed["start"] == (1, 2)
    assert "snapshots" in resumed["resumed_from"]
    for k, v in part["final"].items():
        assert resumed["restored"][k].tobytes() == v.tobytes(), k
    assert resumed["losses"] == full["losses"][14:]
    for k, v in full["final"].items():
        assert resumed["final"][k].tobytes() == v.tobytes(), k
    assert resumed["eval"] == full["eval"]


# -- against the JAX package and across ranks ---------------------------------


@pytest.fixture(scope="module")
def jax_resident_run(tmp_path_factory):
    """The JAX package's `Trainer` on the reference preset with the
    resident feed forced on, windows of 4 (12 updates, shuffled,
    augmentation on): its
    per-update losses, and its init saved for the port to resume from
    (meta epoch -1: a resume starts at epoch 0)."""
    tmp = tmp_path_factory.mktemp("jax_resident")
    cfg = jax_config.parse_cli(_NET + [
        "--data.device_resident=on", "--train.steps_per_call=4",
        "--data.augment=true",
        f"--train.ckpt_dir={tmp / 'run'}",
        "--resilience.handle_signals=false"])
    trainer = JaxTrainer(cfg, mesh=jax_dist.data_mesh(num_devices=1))
    init = tmp / "init"
    jck.CheckpointManager(init, async_save=False).save(
        trainer.state, {"epoch": -1, "config": cfg.to_dict(), "seed": 0})
    losses = []
    real = trainer._resident_loop

    def loop_of(n):
        loop = real(n)

        def run(state, data, idx, *a):
            state, stacked = loop(state, data, idx, *a)
            losses.extend(np.asarray(stacked["loss"]).tolist())
            return state, stacked
        return run

    trainer._resident_loop = loop_of
    trainer.fit()
    assert trainer.resident_train is not None and len(losses) == 12
    return losses, init


@pytest.mark.parametrize("steps_per_call", [1, 4])
def test_resident_trainer_tracks_the_jax_resident_trainer(
        jax_resident_run, tmp_path, steps_per_call):
    losses, init = jax_resident_run
    ckpt = tmp_path / "ck"
    shutil.copytree(init, ckpt)
    out = run_trainer(_NET + [
        "--data.device_resident=on", "--data.augment=true", "--resume",
        f"--train.ckpt_dir={ckpt}",
        f"--train.steps_per_call={steps_per_call}"])
    assert out["start"] == (0, 0) and len(out["losses"]) == 12
    diffs = [abs(a - b) for a, b in zip(out["losses"], losses)]
    assert max(diffs) <= 1e-4, (out["losses"], losses)


def test_two_gloo_ranks_resident_equal_one_process(tmp_path):
    args = _NET + ["--data.device_resident=on", "--train.steps_per_call=2",
                   "--train.epochs=2", "--train.eval_at_end=false"]
    one = run_trainer(args + ["--data.batch_size=4",
                              f"--train.ckpt_dir={tmp_path / 'one'}"])
    ranks = run_worker_ranks(
        tmp_path / "ranks", {"job": "trainer", "args": args + [
            "--data.batch_size=2", f"--train.ckpt_dir={tmp_path / 'two'}"]},
        2)
    for r in ranks:
        assert len(r["losses"]) == len(one["losses"]) == 24
        diffs = [abs(a - b) for a, b in zip(r["losses"], one["losses"])]
        assert max(diffs) <= 1e-5, (r["losses"], one["losses"])
    for k, v in ranks[0]["final"].items():
        assert ranks[1]["final"][k].tobytes() == v.tobytes(), k


def test_log_names_the_feed(tmp_path, caplog):
    caplog.set_level(logging.INFO, logger="tpu_dp_torch.train")
    _fit(_NET, tmp_path, "log")
    assert "resident feed" in caplog.text
