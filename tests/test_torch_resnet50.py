"""The port's ResNet-50 (`--preset=resnet50_cifar100`) against the JAX
package's on converted weights: eval and train forwards, running
statistics, parameter gradients and an SGD step, for the unfused model and
the fused one (every stride-1 bottleneck's 3x3 on the conv kernel); the
fusion plan; the state dict, checkpoints both ways and the preset; the
CLI on the CPU at full width, and serving.

Narrow model (num_filters=8), B=4, 32x32 inputs, 100 classes, BN
randomized (a fresh init zeroes each block's last γ). The JAX fused model
runs its Pallas kernel in interpret mode, as its own tests run it here.

Tolerances and what was measured (this file's inputs):
- Eval logits, relative to max|logits|: 5e-3 unfused (measured 7e-7),
  1e-2 fused (measured 1.9e-3).
- Train forward, unfused: logits within 5e-3 of max|logits| (measured
  6e-5), running statistics within 5e-3 (measured 8e-5).
- Parameter gradients, unfused: within 2e-2 * max|g| per leaf of the JAX
  package's gradient computed in f64 (measured 1.2e-2). Against its f32
  gradient the gap reaches 0.20 on BottleneckBlock_13's shortcut conv,
  and that is the JAX package's own f32 error: its f32 gradient is 0.20
  from its f64 one there, the port's 0.005.
- Fused train mode, block by block (each fused bottleneck alone, the same
  input and output cotangent on both sides, both input-grad routes):
  output within 1e-2 of max|out| (measured 2.7e-3, under one bf16 ulp),
  running statistics within 5e-3 (measured 1.1e-5), parameter gradients
  within 5e-2 * max|g| per leaf (measured 1.5e-2) and 2e-2 relative L2
  over the block (measured 7.4e-3), the input gradient within 5e-2
  relative L2 (measured 8.0e-3). Dropping the stats cotangent from the
  kernel's backward fails these checks (a mutation run).
- Fused train mode, whole model: the bounds of ResNet-18 (ROADMAP Queue
  3 items 1-2) do not hold in the JAX package itself at this size. Its
  own fused train logits are 8.2e-2 of max|logits| from its unfused ones
  (ResNet-18: 0.9-1.6e-2); its fused gradients are 1.16 relative L2 from
  its f64 unfused gradient, with a leaf at cosine -0.47, and move by 0.38
  relative L2 when only its kernel's block_b changes from auto to 1. One
  bf16 rounding that flips in a conv's output moves that channel's
  batch statistics, and 16 train-mode bottlenecks on batches of 4 carry
  it to the logits. So the whole-model fused checks hold the port to the
  reference's own noise: logits and running statistics no farther from
  the JAX fused model's than the JAX fused model is from its unfused one
  (measured 3.4e-2 against 8.2e-2 of max|logits|, 0.055 against 0.134 in
  the statistics), and a gradient no
  farther from the f64 gradient than the JAX fused gradient is, to 10%
  (measured 1.150 against 1.157). Against the JAX fused gradient leaf by
  leaf (`_near`): relative L2 <= 0.8 (measured 0.655), every leaf at
  cosine >= 0.3 (0.51) and norm ratio in [0.4, 2.5] (0.59-1.67), which a
  zero, detached or sign-flipped gradient fails. ROADMAP Queue 3 item 5
  records this.
- Fused, whole model, BatchNorm on its running statistics: no batch
  statistic carries a flipped rounding, so the gradient through all 13
  fused blocks and `ResNet.forward` is held tightly. Against the JAX
  package's f64 unfused gradient, ROADMAP Queue 3 item 1's criterion:
  relative L2 <= 0.25 (measured 0.039), cosine >= 0.85 per leaf (0.960),
  norm ratio in [0.8, 1.25] (0.93-1.07). Against the JAX fused gradient:
  0.05 (0.020), 0.98 (0.993), [0.9, 1.1] (0.974-1.021).
- One SGD step (constant lr 0.05, momentum 0.9, weight decay 5e-4, uint8
  batches normalized): its loss within 1e-3 unfused, 0.05 fused with the
  xent kernel (tests/test_torch_train_step.py's bounds), its rate equal.
  The parameters it leaves are held against the JAX step run in f64:
  unfused, each parameter within 5% of its move (measured 1.5%) and 2%
  relative L2 over the moves (measured 0.74%; the JAX package's own f32
  step: 2.6%); fused, no farther than the JAX fused step, to 10%
  (measured 1.175 against 1.195; loss within 0.008), and its moves
  against the JAX fused step's leaf by leaf: 0.8 (0.644), 0.3 (0.598),
  [0.4, 2.5] (0.63-1.32); a step that moves nothing fails. Losses
  after the step are not compared: at this size the loss is rough in the
  parameters (along the segment from the f64 step's parameters to the
  port's it reads 5.265, 5.251, 5.259, 5.264, 5.174), so the JAX
  package's own f32 and f64 steps already disagree there by 0.028.
- Mutation runs: detaching each fused block's input in `ResNet.forward`,
  or zeroing the kernel backward's input gradient, fails every fused
  gradient, step and two-rank test above."""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
from functools import partial

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_dp.config as jax_config
from torch_port_util import ROOT, jax_resnet50_variables
from tpu_dp import checkpoint as jck
from tpu_dp.data.cifar import load_dataset as jax_load_dataset
from tpu_dp.models import build_model as jax_build
from tpu_dp.models.resnet import BatchNormCoeffs, FusedBottleneckBlock
from tpu_dp.train import SGD as JaxSGD
from tpu_dp.train import make_schedule as jax_schedule
from tpu_dp.train import make_train_step as jax_train_step
from tpu_dp.train.state import TrainState as JaxState
from tpu_dp.train.step import cross_entropy_loss as jax_xent
from tpu_dp_torch import checkpoint as ck
from tpu_dp_torch.compat import (
    convert_grads,
    convert_variables,
    export_variables,
    load_jax_variables,
)
from tpu_dp_torch.config import Config, parse_cli
from tpu_dp_torch.data.cifar import load_dataset
from tpu_dp_torch.models import build_model
from tpu_dp_torch.ops import conv_block
from tpu_dp_torch.train.optim import make_sgd
from tpu_dp_torch.train.schedule import make_schedule
from tpu_dp_torch.train.step import (
    TrainState,
    cross_entropy_loss,
    make_train_step,
)

pytestmark = pytest.mark.port

# The suite runs several pytest workers on one machine: keep each worker's
# PyTorch CPU pool small so the port's tests do not starve the others.
torch.set_num_threads(2)

FUSED = (0, 1, 2, 3)
B, CLASSES, WIDTH = 4, 100, 8
#: the stride-1 bottlenecks of stages 0..3: every block but each later
#: stage's first (ResNet-50's 3, 4, 6, 3 blocks).
FUSED_BLOCKS = [f"BottleneckBlock_{i}" for i in
                (0, 1, 2, 4, 5, 6, 8, 9, 10, 11, 12, 14, 15)]
SLICE = ["--preset=resnet50_cifar100", "--model.fused_stages=all",
         "--model.fused_bwd=true", "--train.pallas_xent=true"]


@pytest.fixture(scope="module")
def variables():
    return jax_resnet50_variables(num_filters=WIDTH, seed=4)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            rng.integers(0, CLASSES, B).astype(np.int32))


def _port(variables, fused_stages=(), fused_bwd=False):
    m = build_model("resnet50", num_classes=CLASSES, num_filters=WIDTH,
                    fused_stages=fused_stages, fused_bwd=fused_bwd)
    return load_jax_variables(m, variables)


def _jax(fused_stages=(), fused_bwd=False, dtype=jnp.float32):
    return jax_build("resnet50", num_classes=CLASSES, num_filters=WIDTH,
                     fused_stages=fused_stages, fused_bwd=fused_bwd,
                     dtype=dtype)


def _jax_train(variables, images, fused_stages):
    logits, mutated = _jax(fused_stages).apply(
        variables, images, train=True, mutable=["batch_stats"])
    stats = convert_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, dict(mutated["batch_stats"]))})
    return np.asarray(logits, np.float32), stats


def _jax_grads(variables, images, labels, fused_stages=(), fused_bwd=False,
               dtype=jnp.float32, train=True):
    model = _jax(fused_stages, fused_bwd, dtype)
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables)

    def loss(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": v["batch_stats"]},
                             jnp.asarray(images, dtype), train=train,
                             mutable=["batch_stats"])
        return jax_xent(out.astype(dtype), jnp.asarray(labels))

    return convert_grads(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jax.grad(loss)(v["params"])))


def _port_grads(variables, batch, fused_stages=(), fused_bwd=False,
                train=True):
    images, labels = batch
    tm = _port(variables, fused_stages, fused_bwd).train(train)
    cross_entropy_loss(tm(torch.from_numpy(images)),
                       torch.from_numpy(labels)).backward()
    return {n: p.grad for n, p in tm.named_parameters()}


def _rel_l2(got, ref) -> float:
    num = sum(float((got[n] - r).square().sum()) for n, r in ref.items())
    return (num / sum(float(r.square().sum()) for r in ref.values())) ** 0.5


def _leaves(got, ref) -> tuple[float, float, float]:
    """Per leaf of ``ref``: the least cosine between ``got`` and ``ref``
    and the least and largest norm ratio |got| / |ref|. A zero or missing
    leaf scores cosine 0 and ratio 0."""
    cos, ratio = [], []
    for n, r in ref.items():
        g, r = got[n].flatten().double(), r.flatten().double()
        gn, rn = float(g.norm()), float(r.norm())
        assert rn > 0, n
        cos.append(float(g @ r) / max(gn * rn, 1e-300))
        ratio.append(gn / rn)
    return min(cos), min(ratio), max(ratio)


def _near(got, ref, rel_l2, cos, ratio) -> None:
    """``got`` within ``rel_l2`` of ``ref`` over all leaves, every leaf at
    cosine >= ``cos`` and with a norm ratio inside ``ratio``: a zero,
    detached (zero upstream) or sign-flipped gradient fails."""
    assert set(got) == set(ref)
    assert all(g is not None for g in got.values()), "a leaf has no grad"
    least_cos, lo, hi = _leaves(got, ref)
    assert _rel_l2(got, ref) <= rel_l2, _rel_l2(got, ref)
    assert least_cos >= cos, least_cos
    assert ratio[0] <= lo and hi <= ratio[1], (lo, hi)


@pytest.fixture(scope="module")
def f64_grads(variables, batch):
    """The JAX package's unfused gradient computed in f64: the reference
    the f32 gradients of both packages are measured against."""
    with jax.enable_x64(True):
        return _jax_grads(variables, *batch, dtype=jnp.float64)


# -- the plan ----------------------------------------------------------------

def test_fusion_plan_equals_the_jax_packages(monkeypatch, variables, batch):
    # JAX: the names of the blocks that run as FusedBottleneckBlock, and
    # the stem's norm module (plain BatchNorm: no chain at the stem).
    _, state = _jax(FUSED).apply(
        variables, batch[0], train=False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(
            mdl, (FusedBottleneckBlock, nn.BatchNorm)))
    captured = state["intermediates"]
    # An unfused block appears too, holding its BatchNorms' captures.
    jax_fused = sorted(k for k, v in captured.items()
                       if k.startswith("Bottleneck") and "__call__" in v)
    assert "__call__" in captured["stem_norm"]  # a plain nn.BatchNorm
    tm = _port(variables, FUSED).eval()
    ours = sorted(name for name, _, fusable in tm._plan if fusable)
    assert ours == jax_fused == sorted(FUSED_BLOCKS)
    assert len(ours) == 13 and "BottleneckBlock_0" in ours
    # The stem is normalized in plain torch, never deferred into a chain.
    monkeypatch.setattr(tm.stem_norm, "coeffs", None)
    with torch.no_grad():
        tm(torch.from_numpy(batch[0]))
    # Unfused and one-stage plans: only the named stage's stride-1 blocks.
    assert not any(f for _, _, f in _port(variables)._plan)
    assert [n for n, _, f in _port(variables, (2,))._plan if f] == [
        f"BottleneckBlock_{i}" for i in (8, 9, 10, 11, 12)]


@pytest.mark.parametrize("train", [False, True])
def test_fused_forward_runs_13_kernel_calls(monkeypatch, variables, batch,
                                            train):
    # Eval: 13 eval-variant calls; train: 13 emit_stats calls; f32 x from
    # the 1x1 conv, no residual, no emit_z, never the other variant.
    calls = []
    names = ("fused_conv_bn", "fused_affine_relu_conv",
             "fused_affine_relu_conv_emit")
    for name in names:
        real = getattr(conv_block, name)

        def spy(*a, _real=real, _name=name, **kw):
            res = a[4] if len(a) > 4 else kw.get("residual")
            calls.append((_name, a[0].dtype, res is not None,
                          kw.get("emit_z", False), tuple(a[0].shape[1:])))
            return _real(*a, **kw)

        monkeypatch.setattr("tpu_dp_torch.models.resnet." + name, spy)
    tm = _port(variables, FUSED, fused_bwd=True).train(train)
    out = tm(torch.from_numpy(batch[0]))
    if train:
        out.sum().backward()
    want = "fused_conv_bn" if train else "fused_affine_relu_conv"
    shapes = [(32, 32, 8)] * 3 + [(16, 16, 16)] * 3 + [(8, 8, 32)] * 5 + [
        (4, 4, 64)] * 2
    assert sorted(calls) == sorted((want, torch.float32, False, False, s)
                                   for s in shapes)
    assert conv_block.launches == 0  # CPU tensors: the plain version


# -- eval and train forwards -------------------------------------------------

@pytest.mark.parametrize("fused_stages", [(), FUSED])
def test_eval_logits_match_jax(variables, batch, fused_stages):
    images = batch[0]
    ref = np.asarray(_jax(fused_stages).apply(variables, images,
                                              train=False), np.float32)
    tm = _port(variables, fused_stages).eval()
    with torch.inference_mode():
        got = tm(torch.from_numpy(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, CLASSES)
    rel = 1e-2 if fused_stages else 5e-3
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


def test_unfused_train_forward_and_batch_stats_match_jax(variables, batch):
    ref, ref_stats = _jax_train(variables, batch[0], ())
    tm = _port(variables).train()
    with torch.no_grad():
        got = tm(torch.from_numpy(batch[0]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=5e-3 * float(np.abs(ref).max()))
    own = tm.state_dict()
    assert len(ref_stats) == 2 * 53  # 53 BatchNorms x (mean, var)
    for key, v in ref_stats.items():
        np.testing.assert_allclose(own[key].numpy(), v.numpy(), rtol=0,
                                   atol=5e-3, err_msg=key)


def test_fused_train_forward_within_the_references_own_noise(variables,
                                                            batch):
    jf, jf_stats = _jax_train(variables, batch[0], FUSED)
    ju, ju_stats = _jax_train(variables, batch[0], ())
    tm = _port(variables, FUSED).train()
    with torch.no_grad():
        got = tm(torch.from_numpy(batch[0])).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - jf).max() <= np.abs(jf - ju).max()
    own = tm.state_dict()
    gap = max(float((jf_stats[k] - ju_stats[k]).abs().max())
              for k in jf_stats)
    assert max(float((own[k] - v).abs().max())
               for k, v in jf_stats.items()) <= gap


# -- gradients ---------------------------------------------------------------

def test_unfused_param_grads_match_jax(variables, batch, f64_grads):
    got = _port_grads(variables, batch)
    assert set(got) == set(f64_grads)
    for name, r in f64_grads.items():
        scale = float(r.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=0,
                                   atol=2e-2 * scale, err_msg=name)


@pytest.mark.parametrize("fused_bwd", [False, True])
def test_fused_param_grads_within_the_references_own_noise(
        variables, batch, f64_grads, fused_bwd):
    ref = _jax_grads(variables, *batch, FUSED, fused_bwd)
    got = _port_grads(variables, batch, FUSED, fused_bwd)
    assert set(got) == set(ref)
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in got.values())
    assert _rel_l2(got, f64_grads) <= 1.1 * _rel_l2(ref, f64_grads)
    # Against the JAX fused gradient, leaf by leaf.
    _near(got, ref, rel_l2=0.8, cos=0.3, ratio=(0.4, 2.5))


@pytest.fixture(scope="module")
def f64_eval_grads(variables, batch):
    """The JAX package's unfused gradient in f64 with BatchNorm on its
    running statistics."""
    with jax.enable_x64(True):
        return _jax_grads(variables, *batch, dtype=jnp.float64, train=False)


@pytest.mark.parametrize("fused_bwd", [False, True])
def test_fused_eval_mode_param_grads_match_jax(variables, batch,
                                               f64_eval_grads, fused_bwd):
    # BatchNorm on running statistics: no batch statistic carries a
    # flipped bf16 rounding onward, so the whole fused model's gradient,
    # through all 13 fused blocks and ResNet.forward, is held tightly.
    ref = _jax_grads(variables, *batch, FUSED, fused_bwd, train=False)
    got = _port_grads(variables, batch, FUSED, fused_bwd, train=False)
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in got.values())
    # ROADMAP Queue 3 item 1's criterion against the f64 gradient.
    _near(got, f64_eval_grads, rel_l2=0.25, cos=0.85, ratio=(0.8, 1.25))
    _near(got, ref, rel_l2=0.05, cos=0.98, ratio=(0.9, 1.1))


def _jax_block(filters, fused_bwd):
    """A standalone `FusedBottleneckBlock` with the JAX ResNet's modules."""
    conv = partial(nn.Conv, use_bias=False, dtype=jnp.float32,
                   kernel_init=nn.initializers.variance_scaling(
                       2.0, "fan_out", "normal"))
    norm = partial(nn.BatchNorm, use_running_average=False, momentum=0.9,
                   epsilon=1e-5, dtype=jnp.float32)
    norm_c = partial(BatchNormCoeffs, use_running_average=False,
                     momentum=0.9, epsilon=1e-5)
    return FusedBottleneckBlock(filters=filters, conv=conv, norm=norm,
                                norm_coeffs=norm_c, pallas_bwd=fused_bwd,
                                train=True)


@pytest.mark.parametrize("fused_bwd", [False, True])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_fused_blocks_match_jax_block_by_block(variables, stage, fused_bwd):
    tm = _port(variables, FUSED, fused_bwd).train()
    rng = np.random.default_rng(20 + stage)
    h = 32 >> stage
    blocks = [n for n, st, f in tm._plan if f and st == stage]
    assert blocks
    for name in blocks:
        block = copy.deepcopy(getattr(tm, name))
        cin, f = block.Conv_0.weight.shape[1], block.Conv_1.weight.shape[0]
        x = np.maximum(rng.standard_normal((B, h, h, cin)), 0).astype(
            np.float32)
        ct = rng.standard_normal((B, h, h, 4 * f)).astype(np.float32)
        jblock = _jax_block(f, fused_bwd)
        stats = variables["batch_stats"][name]
        out, mutated = jblock.apply(
            {"params": variables["params"][name], "batch_stats": stats}, x,
            mutable=["batch_stats"])

        def fwd(p, xx):
            return jblock.apply({"params": p, "batch_stats": stats}, xx,
                                mutable=["batch_stats"])[0]

        _, vjp = jax.vjp(fwd, variables["params"][name], jnp.asarray(x))
        gp, gx = vjp(jnp.asarray(ct))
        gp = convert_grads(jax.tree_util.tree_map(np.asarray, gp))
        out, gx = np.asarray(out), torch.from_numpy(np.array(gx))
        xt = torch.from_numpy(x).requires_grad_()
        got = block.fused(xt)
        got.backward(torch.from_numpy(ct))
        assert np.abs(got.detach().numpy() - out).max() <= 1e-2 * np.abs(
            out).max(), name
        new_stats = convert_variables({"batch_stats": jax.tree_util.tree_map(
            np.asarray, dict(mutated["batch_stats"]))})
        own = block.state_dict()
        for key, v in new_stats.items():
            np.testing.assert_allclose(own[key].numpy(), v.numpy(), rtol=0,
                                       atol=5e-3, err_msg=f"{name}.{key}")
        grads = {n: p.grad for n, p in block.named_parameters()}
        assert set(grads) == set(gp)
        for n, r in gp.items():
            assert float((grads[n] - r).abs().max()) <= 5e-2 * float(
                r.abs().max()), (name, n)
        assert _rel_l2(grads, gp) <= 2e-2, name
        assert float((xt.grad - gx).norm() / gx.norm()) <= 5e-2, name


# -- one SGD step --------------------------------------------------------------

SCHED = ("constant", 0.05, 10, 0, 0.0)  # name, lr, total, warmup, final


@pytest.fixture(scope="module")
def sgd_batch():
    rng = np.random.default_rng(3)
    return (rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, CLASSES, B).astype(np.int32))


def _jax_step(variables, batch, mesh, dtype=jnp.float32, **kw):
    """One step of the JAX package's train step: ``(loss, lr, params)``,
    the parameters after it keyed like the port's."""
    opt = JaxSGD(momentum=0.9, weight_decay=5e-4)
    cast = partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, dtype))
    params = cast(variables["params"])
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     opt_state=opt.init(params),
                     batch_stats=cast(variables["batch_stats"]))
    step = jax_train_step(_jax(dtype=dtype, **kw), opt, mesh,
                          jax_schedule(*SCHED),
                          use_pallas_xent=bool(kw))
    state, m = step(state, {"image": batch[0], "label": batch[1]})
    return float(m["loss"]), float(m["lr"]), convert_grads(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                               state.params))


@pytest.fixture(scope="module")
def f64_step(variables, sgd_batch, mesh1):
    with jax.enable_x64(True):
        return _jax_step(variables, sgd_batch, mesh1, jnp.float64)


@pytest.mark.parametrize("fused", [False, True])
def test_sgd_step_tracks_jax(variables, sgd_batch, mesh1, f64_step, fused):
    kw = dict(fused_stages=FUSED, fused_bwd=True) if fused else {}
    loss, lr, params = _jax_step(variables, sgd_batch, mesh1, **kw)
    model = _port(variables, **kw)
    sgd = make_sgd(model, momentum=0.9, weight_decay=5e-4)
    step = make_train_step(model, sgd, make_schedule(*SCHED),
                           use_pallas_xent=fused, device="cpu")
    state = TrainState(step=0, model=model, optimizer=sgd)
    m = step(state, {"image": torch.from_numpy(sgd_batch[0]),
                     "label": torch.from_numpy(sgd_batch[1]).long()})
    assert state.step == 1 and m["lr"] == lr == np.float32(0.05)
    assert abs(float(m["loss"]) - loss) <= (0.05 if fused else 1e-3)
    got = {n: p.detach() for n, p in model.named_parameters()}
    start = convert_grads(variables["params"])
    truth = f64_step[2]
    # Each parameter's move against the f64 step's move.
    moved = {n: truth[n] - start[n] for n in truth}

    def off(p):  # relative L2 of the moves
        return _rel_l2({n: p[n] - start[n] for n in p}, moved)

    if not fused:
        for n, d in moved.items():
            assert float((got[n] - truth[n]).norm()) <= 5e-2 * float(
                d.norm()), n
        assert off(got) <= 2e-2
    else:
        assert all(bool(torch.isfinite(p).all()) for p in got.values())
        assert off(got) <= 1.1 * off(params)
        # Against the JAX fused step's moves, leaf by leaf.
        _near({n: got[n] - start[n] for n in start},
              {n: params[n] - start[n] for n in start},
              rel_l2=0.8, cos=0.3, ratio=(0.4, 2.5))


# -- state dict, checkpoints, preset, data -------------------------------------

def test_compat_round_trip_is_bit_exact_and_covers_the_state_dict(variables):
    state = convert_variables(variables)
    for fused_stages in ((), FUSED):
        own = build_model("resnet50", num_classes=CLASSES, num_filters=WIDTH,
                          fused_stages=fused_stages).state_dict()
        assert set(own) == set(state)
        assert all(own[k].shape == state[k].shape for k in own)
    back = export_variables(state)
    flat = dict(ck._walk_state_dict(back))
    ref = dict(ck._walk_state_dict(variables))
    assert sorted(flat) == sorted(ref)
    for k, a in ref.items():
        assert flat[k].tobytes() == np.asarray(a, np.float32).tobytes(), k


def test_fused_and_unfused_models_share_one_state_dict():
    gen = torch.Generator().manual_seed(1)
    fused = build_model("resnet50", num_classes=CLASSES, num_filters=WIDTH,
                        fused_stages=FUSED, fused_bwd=True, generator=gen)
    plain = build_model("resnet50", num_classes=CLASSES, num_filters=WIDTH)
    plain.load_state_dict(fused.state_dict(), strict=True)
    a, b = fused.state_dict(), plain.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    # The packed-weight cache is no state: nothing of it is saved.
    with torch.no_grad():
        fused.eval()(torch.zeros(1, 32, 32, 3))
    assert list(fused.state_dict()) == list(b)


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_load_in_the_other_package(tmp_path, variables, mesh1,
                                               writer):
    jmodel = _jax()
    opt = JaxSGD(momentum=0.9, weight_decay=5e-4)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=opt.init(params),
                      batch_stats=jax.tree_util.tree_map(
                          jnp.asarray, variables["batch_stats"]))
    model = _port(variables, FUSED, fused_bwd=True)
    sgd = make_sgd(model, 0.9, 5e-4)
    state = TrainState(step=0, model=model, optimizer=sgd)
    labels = np.random.default_rng(1).integers(0, CLASSES, B).astype(
        np.int32)
    cfg = parse_cli(SLICE)
    keys = ("params", "opt_state", "batch_stats")
    if writer == "jax":
        jstep = jax_train_step(jmodel, opt, mesh1, jax_schedule(*SCHED))
        jstate, _ = jstep(jstate, {"image": _images(B, 0), "label": labels})
        jck.CheckpointManager(tmp_path, async_save=False).save(
            jstate, {"epoch": 0, "config": jax_config.parse_cli(
                SLICE).to_dict(), "seed": 0})
        _, meta = ck.CheckpointManager(tmp_path).restore(state)
        assert state.step == 1 and Config.from_dict(meta["config"]) == cfg
    else:
        step = make_train_step(model, sgd, make_schedule(*SCHED),
                               device="cpu")
        step(state, {"image": torch.from_numpy(_images(B, 0)),
                     "label": torch.from_numpy(labels).long()})
        mgr = ck.CheckpointManager(tmp_path, async_save=True)
        mgr.save(state, {"epoch": 0, "config": cfg.to_dict(), "seed": 0})
        mgr.wait()
        jstate, meta = jck.load_checkpoint(tmp_path / "step_0000000001",
                                           jstate, verify=True)
        assert int(jstate.step) == 1
        assert jax_config.Config.from_dict(meta["config"]) == (
            jax_config.parse_cli(SLICE))
    ours = ck.state_dict_of(state)
    theirs = jax.tree_util.tree_map(np.asarray, jstate)
    for key in keys:
        a = dict(ck._walk_state_dict(ours[key]))
        b = dict(ck._walk_state_dict(getattr(theirs, key)))
        assert sorted(a) == sorted(b), key
        assert all(np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()
                   for k in a), key
    # Both models give the same eval logits from the one saved state.
    from tpu_dp_torch.data.cifar import normalize

    images = _images(B, 9)
    ref = np.asarray(jmodel.apply(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        np.asarray(normalize(torch.from_numpy(images))), train=False))
    with torch.no_grad():
        got = model.eval()(normalize(torch.from_numpy(images))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-2 * float(np.abs(ref).max()))


def test_preset_equals_the_jax_preset():
    port = parse_cli(["--preset=resnet50_cifar100"])
    theirs = jax_config.parse_cli(["--preset=resnet50_cifar100"])
    assert jax_config.Config.from_dict(
        json.loads(json.dumps(port.to_dict()))) == theirs
    assert (port.model.name, port.model.num_classes, port.data.dataset) == (
        "resnet50", 100, "cifar100")
    for section in ("model", "data", "optim", "train"):
        for name, value in vars(getattr(port, section)).items():
            assert getattr(getattr(theirs, section), name) == value, (
                section, name)


def test_cifar100_falls_back_to_the_jax_packages_synthetic_set(tmp_path):
    for train in (True, False):
        ours = load_dataset("cifar100", tmp_path, train=train,
                            synthetic_num_examples=40, seed=3)
        theirs = jax_load_dataset("cifar100", tmp_path, train=train,
                                  synthetic_num_examples=40, seed=3)
        assert ours.num_classes == theirs.num_classes == 100
        assert ours.synthetic and theirs.synthetic
        np.testing.assert_array_equal(ours.images, theirs.images)
        np.testing.assert_array_equal(ours.labels, theirs.labels)


def test_trainer_refuses_a_head_that_disagrees_with_the_dataset(tmp_path):
    from tpu_dp_torch.train.trainer import Trainer

    cfg = parse_cli(SLICE + ["--model.num_classes=10",
                             f"--data.root={tmp_path}",
                             "--data.synthetic_train_size=8",
                             f"--train.ckpt_dir={tmp_path / 'ck'}"])
    with pytest.raises(ValueError, match="num_classes=10 conflicts"):
        Trainer(cfg, device="cpu")


# -- two gloo ranks: sync-BN on every BatchNorm -------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_two_gloo_ranks_sync_every_batchnorm(tmp_path, variables, fused):
    """Two ranks of B=2 against one process on the concatenated batch of
    4, two SGD steps: both losses within 1e-4 unfused; fused, the first
    within 0.05 (phase 7's bound on the card; measured 0.012), the second
    not compared (after a step the loss is rough in the parameters, see
    `test_sgd_step_tracks_jax`; measured 0.18). The two steps' parameter
    moves against the one process's, leaf by leaf (`_near`): unfused
    relative L2 <= 0.1 (measured 0.040), cosine >= 0.98 (0.995), norm
    ratio in [0.9, 1.1] (0.982-1.048); fused 0.8 (0.587), 0.2 (0.342),
    [0.4, 2.5] (0.67-1.90). Per step one all-reduce
    each way for each of the
    53 BatchNorms (the stem, 3 per bottleneck, 4 shortcuts: the fused
    blocks' plain BatchNorm_0 moments and the kernel's [2, C] moments
    alike), one metrics all-reduce and DDP's buckets."""
    import pickle

    from torch_port_util import run_worker_ranks

    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (2, B, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, (2, B)).astype(np.int32)
    with open(tmp_path / "vars.pkl", "wb") as f:
        pickle.dump(variables, f)
    np.savez(tmp_path / "batches.npz", images=images, labels=labels)
    ranks = run_worker_ranks(tmp_path, {
        "variables": str(tmp_path / "vars.pkl"),
        "batches": str(tmp_path / "batches.npz"), "fused": fused,
        "schedule": SCHED, "num_filters": WIDTH, "model": "resnet50",
        "num_classes": CLASSES}, world=2)
    kw = dict(fused_stages=FUSED, fused_bwd=True) if fused else {}
    model = _port(variables, **kw)
    sgd = make_sgd(model, momentum=0.9, weight_decay=5e-4)
    step = make_train_step(model, sgd, make_schedule(*SCHED),
                           use_pallas_xent=fused, device="cpu")
    state = TrainState(step=0, model=model, optimizer=sgd)
    single = [float(step(state, {"image": torch.from_numpy(i),
                                 "label": torch.from_numpy(lab).long()})
                    ["loss"]) for i, lab in zip(images, labels)]
    for out in ranks:
        got = [m[0] for m in out["metrics"]]
        n = 1 if fused else 2
        assert max(abs(a - b) for a, b in zip(got[:n], single[:n])) <= (
            0.05 if fused else 1e-4), (got, single)
        assert len(got) == 2 and all(math.isfinite(v) for v in got)
        assert out["all_params_have_grads"]
        for books in out["books"]:
            assert books["pmean_forward"] == books["pmean_backward"] == 53
            assert books["psum"] == 1 and books["ddp_buckets"] >= 1
    assert all(np.array_equal(ranks[0]["state"][k], ranks[1]["state"][k])
               for k in ranks[0]["state"])
    # Both steps' parameter moves against the one process's, leaf by leaf.
    start = convert_grads(variables["params"])
    moved = {n: p.detach() - start[n] for n, p in model.named_parameters()}
    ours = {n: torch.from_numpy(ranks[0]["state"][n]) - start[n]
            for n in moved}
    if fused:
        _near(ours, moved, rel_l2=0.8, cos=0.2, ratio=(0.4, 2.5))
    else:
        _near(ours, moved, rel_l2=0.1, cos=0.98, ratio=(0.9, 1.1))


# -- the entry points on the CPU, full width -----------------------------------

def _run(module, args, timeout=300):
    # Two threads: the suite runs several pytest workers on one machine.
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_cli_trains_the_preset_and_serves_its_checkpoint_on_cpu(tmp_path):
    ckpt = tmp_path / "ck"
    out = _run("tpu_dp_torch.train", [
        "--device", "cpu", *SLICE, f"--data.root={tmp_path / 'data'}",
        f"--train.ckpt_dir={ckpt}", "--data.synthetic_train_size=6",
        "--data.synthetic_test_size=3", "--data.batch_size=2",
        "--data.augment=false", "--train.epochs=1", "--train.log_every=1"])
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    losses = [float(ln.rpartition(":")[2]) for ln in lines
              if ln.startswith("[1,")]
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    assert "Finished Training" in lines
    assert any(ln.startswith("Accuracy of the network on the 3 test images")
               for ln in lines)
    summary = json.loads(lines[-1])
    assert summary["model"] == "resnet50" and summary["synthetic"] is True
    assert summary["dataset"] == "cifar100" and summary["eval"]["count"] == 3
    meta = json.loads((ckpt / "step_0000000003" / "meta.json").read_text())
    assert meta["config"]["model"]["num_classes"] == 100
    # Serve that save: ResNet-50 at 100 classes from the checkpoint's meta.
    served = _run("tpu_dp_torch.serve", [
        "--device", "cpu", f"--ckpt={ckpt}", "--requests", "4",
        "--sizes", "1,2", "--buckets", "1,2", "--slo-ms", "600000"])
    assert served.returncode == 0, served.stderr[-4000:]
    report = json.loads(served.stdout)
    assert report["verdict"]["ok"] and len(
        report["device_stats"]["class_counts"]) == CLASSES


def test_cli_refuses_the_preset_without_a_card_or_cpu_flag(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would run on it")
    out = _run("tpu_dp_torch.train", SLICE + [
        f"--data.root={tmp_path / 'data'}", "--data.synthetic_train_size=4",
        f"--train.ckpt_dir={tmp_path / 'ck'}"], timeout=120)
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr
    assert "Finished Training" not in out.stdout


def test_serve_cli_runs_resnet50_on_cpu():
    out = _run("tpu_dp_torch.serve", [
        "--device", "cpu", "--model=resnet50", "--requests", "4",
        "--sizes", "1,2", "--buckets", "1,2", "--slo-ms", "600000"])
    assert out.returncode == 0, out.stderr[-4000:]
    report = json.loads(out.stdout)
    assert report["verdict"]["ok"] and report["ground_truth"][
        "images_served"] >= 4
    assert len(report["device_stats"]["class_counts"]) == 10
