"""``optim.grad_accum_steps`` in the port (`make_train_step(accum_steps=a)`,
the port of `_make_accum_body`): a microbatches against one batch of
their union, against the JAX package's accumulating step and `Trainer`,
the feed's grouping against the JAX feed's, and one gradient all-reduce
set per update across ranks.

Tolerances (f32 on the CPU): `Net` has no BatchNorm, so a microbatches of
B and one batch of a·B give the same gradient up to the order of the
sums: loss rel 1e-5, parameters within 2e-6 (tests/test_grad_accum.py's
bounds); against the JAX package's step, loss and parameters within 1e-5;
its `Trainer`, per-update losses within 1e-4 (tests/test_torch_net.py's
bound); ranks against the concatenated batch within 1e-3 (ResNet with
sync-BN, tests/test_torch_ddp.py's unfused bound)."""

from __future__ import annotations

import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ddp_worker import run_trainer
from torch_port_util import jax_resnet18_variables, run_worker_ranks
from tpu_dp import checkpoint as jck
from tpu_dp.config import parse_cli as jax_parse_cli
from tpu_dp.data.cifar import make_synthetic
from tpu_dp.data.pipeline import DataPipeline as JaxPipeline
from tpu_dp.models import Net as JaxNet
from tpu_dp.parallel import dist as jax_dist
from tpu_dp.train import SGD as JaxSGD
from tpu_dp.train import constant_lr, create_train_state
from tpu_dp.train import make_train_step as jax_train_step
from tpu_dp.train.trainer import Trainer as JaxTrainer
from tpu_dp_torch.compat import load_jax_variables
from tpu_dp_torch.data.cifar import ArrayDataset
from tpu_dp_torch.data.pipeline import DataPipeline
from tpu_dp_torch.models import build_model
from tpu_dp_torch.train.optim import make_sgd
from tpu_dp_torch.train.schedule import make_schedule
from tpu_dp_torch.train.step import TrainState, make_train_step

pytestmark = pytest.mark.port

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_init():
    """A JAX `Net` state and 32 synthetic uint8 examples."""
    state = create_train_state(JaxNet(), jax.random.PRNGKey(0),
                               np.zeros((1, 32, 32, 3), np.float32),
                               JaxSGD(momentum=0.9))
    ds = make_synthetic(64, 10, seed=0, name="ga")
    return state, ds.images, ds.labels


def _port_net(jstate):
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    return load_jax_variables(build_model("net"), {"params": params})


def _port_steps(jstate, images, labels, accum, updates=1):
    net = _port_net(jstate)
    opt = make_sgd(net, momentum=0.9)
    step = make_train_step(net, opt, make_schedule("constant", 0.05),
                           device="cpu", accum_steps=accum)
    state = TrainState(step=0, model=net, optimizer=opt)
    per = len(labels) // updates
    out = []
    for u in range(updates):
        img = torch.from_numpy(images[u * per:(u + 1) * per])
        lab = torch.from_numpy(labels[u * per:(u + 1) * per]).long()
        if accum > 1:
            img = img.reshape(accum, -1, *img.shape[1:])
            lab = lab.reshape(accum, -1)
        m = step(state, {"image": img, "label": lab})
        out.append((float(m["loss"]), int(m["correct"]), m["count"]))
    return out, net


def test_microbatches_equal_one_big_batch(jax_init):
    jstate, images, labels = jax_init
    big, net_big = _port_steps(jstate, images[:32], labels[:32], 1)
    acc, net_acc = _port_steps(jstate, images[:32], labels[:32], 4)
    (lb, cb, nb), (la, ca, na) = big[0], acc[0]
    assert la == pytest.approx(lb, rel=1e-5)
    assert ca == cb and na == nb == 32
    for (name, p), q in zip(net_acc.named_parameters(),
                            net_big.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=2e-6, err_msg=name)


def test_accumulation_tracks_the_jax_accumulating_step(jax_init, mesh1):
    jstate, images, labels = jax_init
    step = jax_train_step(JaxNet(), JaxSGD(momentum=0.9), mesh1,
                          constant_lr(0.05), accum_steps=4)
    state = jax.tree_util.tree_map(jnp.array, jstate)
    ref = []
    for u in range(2):
        sl = slice(u * 32, (u + 1) * 32)
        state, m = step(state, {
            "image": images[sl].reshape(4, 8, 32, 32, 3),
            "label": labels[sl].reshape(4, 8)})
        ref.append((float(m["loss"]), int(m["correct"]), int(m["count"])))
    got, net = _port_steps(jstate, images, labels, 4, updates=2)
    for (gl, gc, gn), (rl, rc, rn) in zip(got, ref):
        assert abs(gl - rl) <= 1e-5 * abs(rl)
        assert (gc, gn) == (rc, rn) == (rc, 32)
    want = _port_net(state)
    for (name, p), q in zip(net.named_parameters(), want.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_pipeline_groups_microbatches_as_the_jax_feed(mesh8):
    jds = make_synthetic(128, 10, seed=1, name="ga")
    ours = ArrayDataset(jds.images, jds.labels, jds.name, jds.num_classes,
                        jds.synthetic)
    pipe = DataPipeline(ours, batch_size=16, device="cpu", accum_steps=2,
                        prefetch=0, seed=3)
    theirs = JaxPipeline(jds, batch_size=16, mesh=mesh8, accum_steps=2,
                         prefetch=0, seed=3)
    assert len(pipe) == len(theirs) == 4  # 128 / (16·2)
    for epoch in (0, 2):
        pipe.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(pipe), list(theirs._host_batches())
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert tuple(g["image"].shape) == (2, 16, 32, 32, 3)
            assert tuple(g["label"].shape) == (2, 16)
            np.testing.assert_array_equal(g["image"].numpy(), w["image"])
            np.testing.assert_array_equal(g["label"].numpy(), w["label"])
    # skip_steps counts updates.
    pipe.set_epoch(0)
    theirs.set_epoch(0)
    tail = list(pipe.__iter__(skip_steps=3))
    assert len(tail) == 1
    np.testing.assert_array_equal(tail[0]["label"].numpy(),
                                  list(theirs._host_batches())[3]["label"])
    with pytest.raises(ValueError, match="drop_remainder"):
        DataPipeline(ours, 16, "cpu", drop_remainder=False, accum_steps=2)


def test_two_ranks_reduce_gradients_once_per_update(tmp_path):
    """At world 2 on gloo: one DDP gradient all-reduce set and one metrics
    all-reduce per update, whatever the microbatches (the first a - 1 run
    under ``no_sync``); the ranks track the concatenated batch."""
    a, steps, b = 2, 2, 4
    variables = jax_resnet18_variables(num_filters=8, seed=6)
    ds = make_synthetic(steps * a * 2 * b, 10, seed=8)
    images = ds.images.reshape(steps, a, 2 * b, 32, 32, 3)
    labels = ds.labels.reshape(steps, a, 2 * b)
    var_path, data_path = tmp_path / "vars.pkl", tmp_path / "batches.npz"
    with open(var_path, "wb") as f:
        pickle.dump(variables, f)
    np.savez(data_path, images=images, labels=labels)
    sched = ("cosine", 0.1, 10, 1, 0.0)
    spec = {"variables": str(var_path), "batches": str(data_path),
            "fused": False, "mutate": False, "schedule": sched,
            "num_filters": 8, "accum_steps": a}
    ranks = run_worker_ranks(tmp_path / "ranks", spec, 2)
    # One process on the concatenated microbatches.
    model = load_jax_variables(build_model("resnet18", num_filters=8),
                               variables)
    opt = make_sgd(model, momentum=0.9, weight_decay=5e-4)
    step = make_train_step(model, opt, make_schedule(*sched), device="cpu",
                           accum_steps=a)
    state = TrainState(step=0, model=model, optimizer=opt)
    ref = [float(step(state, {"image": torch.from_numpy(i),
                              "label": torch.from_numpy(lab).long()})["loss"])
           for i, lab in zip(images, labels)]
    for out in ranks:
        for (loss, _, count, _), r in zip(out["metrics"], ref):
            assert abs(loss - r) <= 1e-3
            assert count == a * 2 * b
        for books in out["books"]:
            # ResNet-18 at 8 filters is one DDP bucket; sync-BN reduces
            # in every microbatch's forward and backward (20 BatchNorms).
            assert books["ddp_buckets"] == 1
            assert books["psum"] == 1
            assert books["pmean_forward"] == books["pmean_backward"] == 20 * a
    assert all(np.array_equal(ranks[0]["state"][k], ranks[1]["state"][k])
               for k in ranks[0]["state"])


_REF_ARGS = ["--data.dataset=synthetic", "--data.synthetic_train_size=48",
             "--data.synthetic_test_size=8", "--train.epochs=1",
             "--train.eval_at_end=false", "--optim.grad_accum_steps=2"]


@pytest.fixture(scope="module")
def jax_accum_run(tmp_path_factory):
    """The JAX package's `Trainer` on the reference preset with two
    microbatches of 4 per update (6 updates): its per-update losses, and
    its init saved for the port to resume from."""
    tmp = tmp_path_factory.mktemp("jax_accum")
    cfg = jax_parse_cli(_REF_ARGS + [
        "--data.device_resident=off", f"--train.ckpt_dir={tmp / 'run'}",
        "--resilience.handle_signals=false"])
    trainer = JaxTrainer(cfg, mesh=jax_dist.data_mesh(num_devices=1))
    init = tmp / "init"
    jck.CheckpointManager(init, async_save=False).save(
        trainer.state, {"epoch": -1, "config": cfg.to_dict(), "seed": 0})
    losses = []
    real = trainer.train_step

    def step(state, item, *a):
        state, m = real(state, item, *a)
        losses.append(float(m["loss"]))
        return state, m

    trainer.train_step = step
    trainer.fit()
    assert len(losses) == 6
    return losses, init


@pytest.mark.parametrize("steps_per_call", [1, 4])
def test_trainer_with_accumulation_tracks_the_jax_trainer(
        jax_accum_run, tmp_path, steps_per_call):
    losses, init = jax_accum_run
    ckpt = tmp_path / "ck"
    shutil.copytree(init, ckpt)
    out = run_trainer(_REF_ARGS + [
        "--resume", f"--train.ckpt_dir={ckpt}",
        f"--train.steps_per_call={steps_per_call}"])
    assert out["start"] == (0, 0) and out["spe"] == 6
    assert len(out["losses"]) == 6
    diffs = [abs(a - b) for a, b in zip(out["losses"], losses)]
    assert max(diffs) <= 1e-4, (out["losses"], losses)
