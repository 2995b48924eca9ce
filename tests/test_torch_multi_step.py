"""``train.steps_per_call`` in the port: `make_multi_step`'s windows of K
updates against K single steps and against the JAX package's
`make_multi_step`, the `windows` feed against the JAX feed's, the
device-keyed augmentation and learning-rate table the window reads, and
the momentum restored in place that a captured window needs (the card's
half, the capture itself, is tests/test_torch_capture.py).

Tolerances: on the CPU a window runs the per-step body K times, so it
equals K single steps bit for bit. Against JAX, those of
`test_sgd_steps_track_jax` (tests/test_torch_train_step.py): per-update
loss within 1e-3 unfused in f32, 0.05 fused (each fused conv rounds
through bf16)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from torch_port_util import jax_resnet18_variables
from tpu_dp.data.cifar import make_synthetic
from tpu_dp.data.pipeline import DataPipeline as JaxPipeline
from tpu_dp.models import build_model as jax_build
from tpu_dp.train import SGD as JaxSGD
from tpu_dp.train import make_multi_step as jax_multi_step
from tpu_dp.train import make_schedule as jax_schedule
from tpu_dp.train.state import TrainState as JaxState
from tpu_dp_torch import checkpoint as ck
from tpu_dp_torch.compat import load_jax_variables
from tpu_dp_torch.config import parse_cli
from tpu_dp_torch.data.augment import make_augment_fn
from tpu_dp_torch.data.cifar import ArrayDataset
from tpu_dp_torch.data.pipeline import DataPipeline
from tpu_dp_torch.models import build_model
from tpu_dp_torch.train.optim import make_sgd
from tpu_dp_torch.train.schedule import lr_table, make_schedule
from tpu_dp_torch.train.step import (
    TrainState,
    make_multi_step,
    make_train_step,
)
from tpu_dp_torch.train.trainer import Trainer

pytestmark = pytest.mark.port

torch.set_num_threads(2)

SCHED = ("cosine", 0.1, 10, 1, 0.0)  # name, lr, total, warmup, final
K, B = 3, 8


@pytest.fixture(scope="module")
def variables():
    return jax_resnet18_variables(num_filters=8, seed=4)


@pytest.fixture(scope="module")
def pool():
    ds = make_synthetic(K * 2 * B, 10, seed=3)
    return ds.images.reshape(K, 2, B, 32, 32, 3), ds.labels.reshape(K, 2, B)


def _port_model(variables, fused):
    kw = dict(fused_stages=(0, 1, 2, 3), fused_bwd=True) if fused else {}
    return load_jax_variables(build_model("resnet18", num_filters=8, **kw),
                              variables)


def _port_run(variables, images, labels, fused, window, accum=1,
              augment=False):
    model = _port_model(variables, fused)
    opt = make_sgd(model, momentum=0.9, weight_decay=5e-4)
    step = make_train_step(model, opt, make_schedule(*SCHED),
                           use_pallas_xent=fused, device="cpu",
                           accum_steps=accum,
                           augment_fn=make_augment_fn(1) if augment else None)
    state = TrainState(step=0, model=model, optimizer=opt)
    images = torch.from_numpy(images)
    labels = torch.from_numpy(labels).long()
    if window:
        m = make_multi_step(step, K)(state, {"image": images,
                                             "label": labels})
        losses, correct, lrs = m["loss"].tolist(), m["correct"].tolist(), \
            m["lr"]
    else:
        ms = [step(state, {"image": images[i], "label": labels[i]})
              for i in range(K)]
        losses = [float(m["loss"]) for m in ms]
        correct = [int(m["correct"]) for m in ms]
        lrs = [m["lr"] for m in ms]
    assert state.step == K and int(step.step_t) == K
    return {"losses": losses, "correct": correct, "lrs": lrs,
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "momentum": [opt.state[p]["momentum_buffer"].clone()
                         for p in model.parameters()]}


@pytest.mark.parametrize("fused,accum,augment", [
    (False, 1, False), (True, 1, True), (True, 2, True)])
def test_window_equals_single_steps_bit_for_bit(variables, pool, fused,
                                                 accum, augment):
    images, labels = pool
    if accum == 1:
        images, labels = images[:, 0], labels[:, 0]
    eager = _port_run(variables, images, labels, fused, False, accum,
                      augment)
    window = _port_run(variables, images, labels, fused, True, accum,
                       augment)
    assert window["losses"] == eager["losses"]
    assert window["correct"] == eager["correct"]
    assert window["lrs"] == eager["lrs"]
    for k, v in eager["state"].items():
        assert torch.equal(window["state"][k], v), k
    for a, b in zip(window["momentum"], eager["momentum"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True])
def test_window_tracks_jax_multi_step(variables, pool, mesh1, fused):
    images, labels = pool[0][:, 0], pool[1][:, 0]
    kw = dict(fused_stages=(0, 1, 2, 3), fused_bwd=True) if fused else {}
    model = jax_build("resnet18", num_filters=8, **kw)
    opt = JaxSGD(momentum=0.9, weight_decay=5e-4)
    params = jax.tree_util.tree_map(jax.numpy.asarray, variables["params"])
    state = JaxState(step=jax.numpy.zeros((), jax.numpy.int32),
                     params=params, opt_state=opt.init(params),
                     batch_stats=jax.tree_util.tree_map(
                         jax.numpy.asarray, variables["batch_stats"]))
    loop = jax_multi_step(model, opt, mesh1, jax_schedule(*SCHED),
                          num_steps=K, use_pallas_xent=fused)
    state, stacked = loop(state, {"image": images, "label": labels})
    ref = np.asarray(stacked["loss"]).tolist()
    got = _port_run(variables, images, labels, fused, True)
    tol = 0.05 if fused else 1e-3
    for k, (g, r) in enumerate(zip(got["losses"], ref)):
        assert abs(g - r) <= tol, (k, g, r)
    assert got["correct"] == np.asarray(stacked["correct"]).tolist()
    assert int(state.step) == K


def _datasets(n):
    jds = make_synthetic(n, 10, seed=2, name="w")
    ours = ArrayDataset(jds.images, jds.labels, jds.name, jds.num_classes,
                        jds.synthetic)
    return ours, jds


@pytest.mark.parametrize("steps,accum,skip", [
    (6, 1, 0), (7, 1, 0), (8, 1, 0), (8, 1, 1), (7, 2, 2), (8, 2, 0)])
def test_windows_feed_equals_jax_feed(mesh1, steps, accum, skip):
    k, b = 3, 4
    ours, jds = _datasets(steps * accum * b)
    pipe = DataPipeline(ours, b, "cpu", seed=5, prefetch=0,
                        accum_steps=accum)
    theirs = JaxPipeline(jds, b, mesh1, seed=5, prefetch=0,
                         accum_steps=accum)
    for epoch in (0, 1):
        pipe.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = list(pipe.windows(k, skip_steps=skip))
        want = list(theirs.windows(k, skip_steps=skip))
        assert [n for n, _ in got] == [n for n, _ in want]
        remaining = steps - skip
        assert [n for n, _ in got] == ([k] * (remaining // k)
                                       + [1] * (remaining % k))
        for (n, g), (_, w) in zip(got, want):
            lead = (n,) if n > 1 else ()
            lead += (accum,) if accum > 1 else ()
            assert tuple(g["image"].shape) == lead + (b, 32, 32, 3)
            np.testing.assert_array_equal(g["image"].numpy(),
                                          np.asarray(w["image"]))
            np.testing.assert_array_equal(g["label"].numpy(),
                                          np.asarray(w["label"]))


def test_windows_need_drop_remainder():
    ours, _ = _datasets(16)
    pipe = DataPipeline(ours, 4, "cpu", drop_remainder=False, prefetch=0)
    with pytest.raises(ValueError, match="drop_remainder"):
        pipe.windows(2)
    assert [n for n, _ in pipe.windows(1)] == [1] * 4


def test_device_keyed_augmentation_replays_and_varies():
    images = torch.rand(64, 8, 8, 3) * 2 - 1
    aug = make_augment_fn(seed=3, row0=0, global_n=128)
    key = torch.tensor(7)
    out = aug(key, images)
    # The same key on the device replays the draws; an int key is the same.
    assert torch.equal(out, aug(torch.tensor(7), images))
    assert torch.equal(out, aug(7, images))
    assert not torch.equal(out, aug(8, images))
    assert not torch.equal(out, make_augment_fn(seed=3, row0=64,
                                                global_n=128)(7, images))
    assert not torch.equal(out, make_augment_fn(seed=4, row0=0,
                                                global_n=128)(7, images))
    # Rows of one step differ from each other (not one crop for all).
    assert len({tuple(out[i].flatten()[:40].tolist())
                for i in range(64)}) > 32


def test_lr_table_equals_schedule_at_every_step():
    spe, epochs = 39, 5
    schedule = make_schedule("cosine", 0.1, spe * epochs, spe)
    table = lr_table(schedule)
    n = table.numel()
    assert n == spe * epochs + 1
    for k in range(spe * epochs + 20):
        assert float(table[min(k, n - 1)]) == float(np.float32(schedule(k)))
    assert lr_table(make_schedule("constant", 0.05)).tolist() == [
        float(np.float32(0.05))]


def test_restore_into_a_live_trainer_keeps_its_momentum_tensors(tmp_path):
    cfg = parse_cli(["--data.dataset=synthetic",
                     "--data.synthetic_train_size=20",
                     "--data.synthetic_test_size=4", "--train.epochs=1",
                     "--train.eval_at_end=false", "--train.steps_per_call=2",
                     f"--train.ckpt_dir={tmp_path}"])
    trainer = Trainer(cfg, device="cpu")
    trainer.fit()
    trainer.ckpt_mgr.wait()
    bufs = [trainer.optimizer.state[p]["momentum_buffer"]
            for p in trainer.model.parameters()]
    ptrs = [b.data_ptr() for b in bufs]
    saved = [b.clone() for b in bufs]
    assert any(bool(b.abs().sum() > 0) for b in saved)
    for b in bufs:
        b.mul_(2.0).add_(1.0)
    trainer.state.step = 0
    ck.load_checkpoint(ck.CheckpointManager(tmp_path).latest_dir(),
                       trainer.state)
    now = [trainer.optimizer.state[p]["momentum_buffer"]
           for p in trainer.model.parameters()]
    assert [b.data_ptr() for b in now] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(now, saved))
    assert trainer.state.step == 5
