"""The port's train step against the JAX package's, and the pieces around
it: schedule, SGD, sampler, augmentation and the CLI's refusals.

Three SGD updates (momentum 0.9, weight decay 5e-4, cosine with one warmup
step) from converted weights (num_filters=8, BN randomized) on the same
uint8 batches, augmentation off, against `tpu_dp.train.make_train_step` on
a one-device mesh. Per-step loss tolerance: 1e-3 unfused in f32 (the same
f32 math summed in other orders), 0.05 fused with the xent kernel
(tests/test_models.py's bound for fused training: each fused conv rounds
through bf16)."""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

from torch_port_util import jax_resnet18_variables
from tpu_dp.data.cifar import make_synthetic
from tpu_dp.data.sampler import ShardedSampler as JaxSampler
from tpu_dp.models import build_model as jax_build
from tpu_dp.train import SGD as JaxSGD
from tpu_dp.train import make_schedule as jax_schedule
from tpu_dp.train import make_train_step as jax_train_step
from tpu_dp.train.state import TrainState as JaxState
from tpu_dp_torch.compat import load_jax_variables
from tpu_dp_torch.config import NotPortedError, parse_cli
from tpu_dp_torch.data.augment import make_augment_fn
from tpu_dp_torch.data.sampler import ShardedSampler
from tpu_dp_torch.models import build_model
from tpu_dp_torch.models.resnet import BatchNorm
from tpu_dp_torch.train.optim import make_sgd
from tpu_dp_torch.train.schedule import make_schedule
from tpu_dp_torch.train.step import TrainState, make_train_step

pytestmark = pytest.mark.port

# The suite runs several pytest workers on one machine: keep each worker's
# PyTorch CPU pool small so the port's tests do not starve the others.
torch.set_num_threads(2)

SCHED = ("cosine", 0.1, 10, 1, 0.0)  # name, lr, total, warmup, final
STEPS, B = 3, 8


@pytest.fixture(scope="module")
def variables():
    return jax_resnet18_variables(num_filters=8, seed=4)


@pytest.fixture(scope="module")
def batches():
    ds = make_synthetic(STEPS * B, 10, seed=3)
    return [(ds.images[i * B:(i + 1) * B], ds.labels[i * B:(i + 1) * B])
            for i in range(STEPS)]


def _jax_run(variables, batches, fused, mesh):
    kw = dict(fused_stages=(0, 1, 2, 3), fused_bwd=True) if fused else {}
    model = jax_build("resnet18", num_filters=8, **kw)
    opt = JaxSGD(momentum=0.9, weight_decay=5e-4)
    params = jax.tree_util.tree_map(jax.numpy.asarray, variables["params"])
    state = JaxState(step=jax.numpy.zeros((), jax.numpy.int32),
                     params=params, opt_state=opt.init(params),
                     batch_stats=jax.tree_util.tree_map(
                         jax.numpy.asarray, variables["batch_stats"]))
    step = jax_train_step(model, opt, mesh, jax_schedule(*SCHED),
                          use_pallas_xent=fused)
    out = []
    for images, labels in batches:
        state, m = step(state, {"image": images, "label": labels})
        out.append((float(m["loss"]), float(m["lr"]), int(m["correct"])))
    return out


def _port_run(variables, batches, fused):
    kw = dict(fused_stages=(0, 1, 2, 3), fused_bwd=True) if fused else {}
    model = load_jax_variables(build_model("resnet18", num_filters=8, **kw),
                               variables)
    opt = make_sgd(model, momentum=0.9, weight_decay=5e-4)
    step = make_train_step(model, opt, make_schedule(*SCHED),
                           use_pallas_xent=fused, device="cpu")
    state = TrainState(step=0, model=model, optimizer=opt)
    out = []
    for images, labels in batches:
        m = step(state, {"image": torch.from_numpy(images),
                         "label": torch.from_numpy(labels).long()})
        out.append((float(m["loss"]), m["lr"], int(m["correct"])))
    assert state.step == len(batches)
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_sgd_steps_track_jax(variables, batches, mesh1, fused):
    ref = _jax_run(variables, batches, fused, mesh1)
    got = _port_run(variables, batches, fused)
    tol = 0.05 if fused else 1e-3
    for k, ((gl, glr, _), (rl, rlr, _)) in enumerate(zip(got, ref)):
        assert abs(gl - rl) <= tol, (k, gl, rl)
        # The port evaluates the schedule's f32 arithmetic as written; the
        # JAX step's jit turns its divisions by constants into reciprocal
        # multiplies, one f32 rounding apart.
        assert abs(glr - rlr) <= 2.0 ** -23 * abs(rlr), (k, glr, rlr)
    assert [round(r[1], 7) for r in got] == [0.0, 0.1, 0.0969846]
    # The loss falls once the model has taken a real step.
    assert got[-1][0] < got[0][0]


def test_schedule_equals_jax_schedule():
    for args in (SCHED, ("cosine", 0.1, 30, 3, 0.0),
                 ("cosine", 0.05, 7, 3, 0.001), ("constant", 0.1)):
        ours, theirs = make_schedule(*args), jax_schedule(*args)
        total = args[2] if len(args) > 2 else 5
        for k in range(total + 3):
            assert ours(k) == float(theirs(k)), (args, k)


def test_weight_decay_exclusion_picks_bn_and_biases():
    model = build_model("resnet18", num_filters=8)
    opt = make_sgd(model, weight_decay=5e-4, decay_exclude_bias_and_norm=True)
    decayed, kept = opt.param_groups
    assert decayed["weight_decay"] == 5e-4 and kept["weight_decay"] == 0.0
    names = {id(p): n for n, p in model.named_parameters()}
    kept_names = {names[id(p)] for p in kept["params"]}
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert len(kept_names) == 2 * n_bn + 1  # γ, β of each BN + the head bias
    assert "classifier.bias" in kept_names
    assert all(n.endswith(("bias", "weight")) and (
        "norm" in n.lower() or n == "classifier.bias") for n in kept_names)
    assert len(make_sgd(model, weight_decay=5e-4).param_groups) == 1


@pytest.mark.parametrize("n,shards,shuffle,drop", [
    (50, 1, True, False), (50, 3, True, False), (50, 3, True, True),
    (7, 4, False, False), (1000, 8, True, False)])
def test_sampler_indices_equal_jax(n, shards, shuffle, drop):
    for sid in range(shards):
        ours = ShardedSampler(n, shards, sid, shuffle, seed=5,
                              drop_remainder=drop)
        theirs = JaxSampler(n, shards, sid, shuffle, seed=5,
                            drop_remainder=drop)
        for epoch in (0, 1, 7):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert len(ours) == len(theirs)
            np.testing.assert_array_equal(ours.shard_indices(),
                                          theirs.shard_indices())


def test_augmentation_statistics():
    n, h = 9000, 16
    # Pixel (r, c) holds r*h + c + 1: the crop offset and the flip of each
    # output can be read back from two neighbouring pixels.
    img = (torch.arange(h * h, dtype=torch.float32) + 1).reshape(1, h, h, 1)
    images = img.expand(n, h, h, 1).contiguous()
    aug = make_augment_fn(seed=7)
    out = aug(3, images)
    assert out.shape == images.shape and out.dtype == images.dtype
    assert torch.equal(out, aug(3, images))  # same (seed, step), same draw
    assert not torch.equal(out, aug(4, images))
    v0, v1 = out[:, 8, 8, 0].long() - 1, out[:, 8, 9, 0].long() - 1
    flipped = v1 < v0
    oy = v0 // h - 4
    ox = torch.where(flipped, v0 % h - 3, v0 % h - 4)
    for o in (oy, ox):
        counts = torch.bincount(o, minlength=9)
        assert len(counts) == 9
        # Uniform over 0..8: n/9 = 1000 each, sd ~31.
        assert int((counts - n / 9).abs().max()) < 150, counts
    assert abs(float(flipped.float().mean()) - 0.5) < 0.03
    # The pad is -1 and covers exactly the rows and columns shifted in.
    fills = (out == -1).sum(dim=(1, 2, 3))
    want = h * h - (h - (oy - 4).abs()) * (h - (ox - 4).abs())
    assert torch.equal(fills, want)
    kept = out[out != -1]
    assert bool(((kept >= 1) & (kept <= h * h)).all())


@pytest.mark.parametrize("knob", [
    "--train.verify_fingerprint=true",
    "--train.profile=t.json",
    "--model.fused_block_b=4",
    "--profile=t.json",
    "--parallel.num_devices=2"])
def test_cli_refuses_unported_knobs(knob):
    with pytest.raises(NotPortedError):
        parse_cli(["--preset=resnet18_cifar10", knob])


@pytest.mark.parametrize("knob,field,value", [
    ("--train.recompile_guard=raise", "train.recompile_guard", "raise"),
    ("--train.recompile_guard=off", "train.recompile_guard", "off"),
    ("--serve.max_queue=8", "serve.max_queue", 8),
    ("--serve.profile_batches=2:4", "serve.profile_batches", "2:4"),
    ("--serve.max_wait_ms=1", "serve.max_wait_ms", 1.0),
    ("--serve.replicas=2", "serve.replicas", 2)])
def test_cli_takes_the_serve_section_and_the_recompile_guard(knob, field,
                                                            value):
    cfg = parse_cli(["--preset=resnet18_cifar10", knob])
    section, name = field.split(".")
    assert getattr(getattr(cfg, section), name) == value
    assert cfg.to_dict()[section][name] == value


@pytest.mark.parametrize("knobs,message", [
    (["--train.collective_dtype=bf16"],
     "train.collective_dtype applies to the sharded update"),
    (["--train.collective_dtype=int8"],
     "train.collective_dtype applies to the sharded update"),
    (["--train.bucket_mb=4"], "train.bucket_mb applies to the sharded"),
    (["--train.update_sharding=diagonal"],
     "train.update_sharding must be replicated|sharded"),
    (["--train.update_sharding=sharded", "--train.quant_block_size=0"],
     "train.quant_block_size must be >= 1"),
    (["--train.update_sharding=sharded", "--train.collective_dtype=int4"],
     "collective_dtype must be one of"),
    (["--train.update_sharding=sharded", "--train.bucket_mb=-1"],
     "train.bucket_mb must be >= 0")])
def test_cli_refuses_the_sharded_update_as_the_jax_package_does(knobs,
                                                               message):
    with pytest.raises(ValueError, match=message) as e:
        parse_cli(["--preset=resnet18_cifar10", *knobs])
    assert not isinstance(e.value, NotPortedError)


def test_cli_takes_the_sharded_update_knobs():
    cfg = parse_cli(["--preset=resnet18_cifar10",
                     "--train.update_sharding=sharded",
                     "--train.collective_dtype=int8",
                     "--train.quant_block_size=128", "--train.bucket_mb=25"])
    assert (cfg.train.update_sharding, cfg.train.collective_dtype,
            cfg.train.quant_block_size, cfg.train.bucket_mb) == (
        "sharded", "int8", 128, 25.0)
    d = cfg.to_dict()["train"]
    assert (d["update_sharding"], d["bucket_mb"]) == ("sharded", 25.0)


def test_cli_presets_defaults_and_errors():
    cfg = parse_cli(["--preset=resnet18_cifar10", "--model.fused_stages=all",
                     "--model.fused_bwd=true", "--train.pallas_xent=true",
                     "--train.steps_per_call=1"])
    assert (cfg.model.name, cfg.data.batch_size, cfg.optim.lr,
            cfg.optim.weight_decay, cfg.optim.schedule,
            cfg.optim.warmup_epochs, cfg.data.augment) == (
        "resnet18", 128, 0.1, 5e-4, "cosine", 1.0, True)
    assert cfg.model.fused_stages == "all" and cfg.model.fused_bwd
    ref = parse_cli(["--preset=reference"])
    assert (ref.model.name, ref.data.batch_size, ref.train.epochs,
            ref.optim.lr) == ("net", 4, 2, 0.001)
    assert parse_cli([]) == ref
    assert parse_cli(["--preset=reference",
                      "--model.name=resnet18"]).data.batch_size == 4
    with pytest.raises(ValueError, match="no field"):
        parse_cli(["--train.bogus=1"])
    with pytest.raises(ValueError, match="unknown preset"):
        parse_cli(["--preset=nope"])
    assert math.isclose(parse_cli(["--preset=resnet18_cifar10",
                                   "--optim.lr=0.2"]).optim.lr, 0.2)
