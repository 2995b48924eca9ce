"""The reference's `Net` in the port (`tpu_dp_torch.models.net`) and the
system's default command, ``python -m tpu_dp_torch.train`` (the reference
preset: `Net`, batch 4), against the JAX package on the CPU.

Tolerances (f32, no BatchNorm, no bf16, TF32 irrelevant on the CPU):

- forward logits and parameter gradients of one batch from the same
  converted parameters: within 1e-5 · max|·| (the same f32 math, summed
  in other orders);
- the JAX package's `Trainer` at global batch 4 against the port's
  `Trainer` at world 1 × batch 4 and at 2 gloo ranks × batch 2, from the
  same init (the JAX trainer's own, saved by `tpu_dp.checkpoint` and
  resumed by the port), 5 steps: per-step losses within 1e-4.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from torch_port_util import ROOT, run_worker_ranks
from tpu_dp import checkpoint as jck
from tpu_dp.compat.torch_compat import (
    export_net_state_dict,
    import_net_state_dict,
)
from tpu_dp.config import parse_cli as jax_parse_cli
from tpu_dp.models import build_model as jax_build
from tpu_dp.parallel import dist as jax_dist
from tpu_dp.train.trainer import Trainer as JaxTrainer
from tpu_dp_torch.checkpoint import load_params
from tpu_dp_torch.compat import (
    convert_grads,
    convert_variables,
    export_variables,
    load_jax_variables,
)
from tpu_dp_torch.models import build_model
from tpu_dp_torch.train.step import cross_entropy_loss
from torch_ddp_worker import run_trainer

pytestmark = pytest.mark.port

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_default_checkpoints_dir():
    existed = (ROOT / "checkpoints").exists()
    yield
    assert existed or not (ROOT / "checkpoints").exists()


@pytest.fixture(scope="module")
def jax_net():
    model = jax_build("net")
    params = model.init(jax.random.PRNGKey(5),
                        np.zeros((1, 32, 32, 3), np.float32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    # Non-zero biases, so the bias map is exercised too.
    rng = np.random.default_rng(5)
    for name in params:
        params[name]["bias"] = (0.1 * rng.standard_normal(
            params[name]["bias"].shape)).astype(np.float32)
    return model, params


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    return (rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, 8).astype(np.int32))


def test_net_has_the_reference_parameter_count():
    model = build_model("net")
    assert sum(p.numel() for p in model.parameters()) == 62006
    assert [k for k, _ in model.named_parameters()] == [
        f"{m}.{w}" for m in ("conv1", "conv2", "fc1", "fc2", "fc3")
        for w in ("weight", "bias")]


def test_logits_and_grads_match_jax(jax_net, batch):
    model, params = jax_net
    images, labels = batch

    def loss_fn(p):
        logits = model.apply({"params": p}, images)
        logz = jax.nn.logsumexp(logits, axis=-1)
        true = jnp.take_along_axis(logits, labels[:, None], -1)[:, 0]
        return jnp.mean(logz - true), logits

    (ref_loss, ref_logits), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    net = load_jax_variables(build_model("net"), {"params": params})
    logits = net(torch.from_numpy(images))
    loss = cross_entropy_loss(logits, torch.from_numpy(labels).long())
    loss.backward()
    loss = loss.detach()
    scale = float(np.abs(ref_logits).max())
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, rtol=0,
                               atol=1e-5 * scale)
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    want = convert_grads(jax.tree_util.tree_map(np.asarray, ref_grads))
    for name, p in net.named_parameters():
        g, r = p.grad.numpy(), want[name].numpy()
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-5 * float(np.abs(r).max()),
                                   err_msg=name)


class _ReferenceNet(nn.Module):
    """The reference tutorial's `Net`, NCHW, as it is written there."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 6, 5)
        self.pool = nn.MaxPool2d(2, 2)
        self.conv2 = nn.Conv2d(6, 16, 5)
        self.fc1 = nn.Linear(16 * 5 * 5, 120)
        self.fc2 = nn.Linear(120, 84)
        self.fc3 = nn.Linear(84, 10)

    def forward(self, x):
        x = self.pool(F.relu(self.conv1(x)))
        x = self.pool(F.relu(self.conv2(x)))
        x = torch.flatten(x, 1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


@pytest.mark.parametrize("prefix", ["", "module."])
def test_reference_state_dict_loads_and_maps_to_jax(jax_net, batch, prefix):
    torch.manual_seed(3)
    ref = _ReferenceNet()
    sd = {prefix + k: v for k, v in ref.state_dict().items()}
    net = build_model("net")
    net.load_state_dict(sd)
    images = torch.from_numpy(batch[0])
    with torch.no_grad():
        np.testing.assert_array_equal(
            net(images).numpy(), ref(images.permute(0, 3, 1, 2)).numpy())
    # The port's map to the JAX package's NHWC `Net` is the JAX package's
    # own (tpu_dp.compat.torch_compat), both ways, bit for bit.
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    got = export_variables(sd)
    want = import_net_state_dict(numpy_sd)
    assert got["batch_stats"] == {}
    for m in want:
        for leaf in want[m]:
            np.testing.assert_array_equal(got["params"][m][leaf],
                                          want[m][leaf])
    back = convert_variables(got)
    for k, v in export_net_state_dict(want).items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    # And the JAX `Net` on those params computes the reference's logits.
    model, _ = jax_net
    logits = model.apply({"params": got["params"]}, batch[0])
    with torch.no_grad():
        expect = ref(images.permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(np.asarray(logits), expect, rtol=0,
                               atol=1e-5 * float(np.abs(expect).max()))


_REF_ARGS = ["--data.dataset=synthetic", "--data.synthetic_train_size=20",
             "--data.synthetic_test_size=8", "--train.epochs=1",
             "--train.eval_at_end=false"]


@pytest.fixture(scope="module")
def jax_reference_run(tmp_path_factory):
    """The JAX package's `Trainer` on the reference preset (global batch
    4, 5 steps, one device): its per-step losses, and its init saved for
    the port to resume from (meta epoch -1: a resume starts at epoch 0)."""
    tmp = tmp_path_factory.mktemp("jax_ref")
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
    assert len(losses) == 5
    return losses, init


@pytest.mark.parametrize("world", [1, 2])
def test_reference_preset_trainer_matches_jax_trainer(jax_reference_run,
                                                      tmp_path, world):
    losses, init = jax_reference_run
    ckpt = tmp_path / "ck"
    shutil.copytree(init, ckpt)
    args = _REF_ARGS + [f"--data.batch_size={4 // world}", "--resume",
                        f"--train.ckpt_dir={ckpt}"]
    if world == 1:
        out = run_trainer(args)
    else:
        out = run_worker_ranks(tmp_path / "ranks",
                               {"job": "trainer", "args": args}, world)[0]
    assert out["resumed_from"] == str(ckpt / "step_0000000000")
    assert out["start"] == (0, 0)
    assert len(out["losses"]) == 5
    diffs = [abs(a - b) for a, b in zip(out["losses"], losses)]
    assert max(diffs) <= 1e-4, (out["losses"], losses)


def test_cli_default_is_the_reference_net(tmp_path):
    ckpt = tmp_path / "ck"
    common = [sys.executable, "-m", "tpu_dp_torch.train", "--device", "cpu",
              "--data.dataset=synthetic", "--data.synthetic_train_size=40",
              "--data.synthetic_test_size=12", "--train.log_every=5",
              f"--train.ckpt_dir={ckpt}"]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
    run = subprocess.run(common + ["--train.epochs=1"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240,
                         env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.strip().splitlines()
    assert "[1,     5] loss:" in run.stdout
    assert "[1,    10] loss:" in run.stdout
    assert "Finished Training" in lines
    assert any(ln.startswith("Accuracy of the network on the 12 test images")
               for ln in lines)
    first = json.loads(lines[-1])
    assert (first["model"], first["start_epoch"], first["resumed_from"]) == (
        "net", 0, None)
    net = load_params(ckpt / "final_params.msgpack", build_model("net"))
    assert sum(p.numel() for p in net.parameters()) == 62006
    again = subprocess.run(common + ["--train.epochs=2", "--resume"],
                           cwd=tmp_path, capture_output=True, text=True,
                           timeout=240, env=env)
    assert again.returncode == 0, again.stderr[-3000:]
    second = json.loads(again.stdout.strip().splitlines()[-1])
    assert second["start_epoch"] == 1
    assert second["resumed_from"] == str(ckpt / "step_0000000010")
    assert "[2,     5] loss:" in again.stdout
    assert "[1,     5] loss:" not in again.stdout
