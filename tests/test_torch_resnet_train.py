"""Train mode of the port's ResNet-18 against the JAX package's on converted
weights: logits and updated BatchNorm statistics of
``model.apply(train=True, mutable=["batch_stats"])``, and the parameter
gradients of the loss, for the unfused model and the fully fused one (with
the kernel's stats path and both input-grad routes).

Narrow model (num_filters=8), B=8, 32x32 inputs, BN randomized (a fresh
init zeroes each block's last γ, which would zero half the gradients).
Tolerances: running statistics within 5e-3 (tests/test_models.py's);
logits within 5e-3 of max|logits| unfused, 1e-2 fused. The fused convs
round y through bf16 on both sides after summing in different orders;
about 3e-5 of the values land one ulp apart, and batch statistics carry
each flip through the remaining ~18 convs. On these inputs the JAX
package's own fused and unfused train forwards differ by 0.9-1.6e-2 of
max|logits|, the port's fused forward differs from the JAX package's by
0.4-0.7e-2, so 1e-2 is the fused bound (tests/test_torch_resnet.py's for
fused eval).

Gradients: unfused, max|g - g_jax| <= 2e-2 * max|g_jax| per parameter
(measured 3e-3). Fused, that bound is below the reference's own noise: the
JAX package's fused gradients move by 13% (relative L2 over all
parameters; up to 41% of max|g| in one leaf) when only its kernel's
block_b changes from 8 to 1. The fused comparison therefore bounds the
relative L2 over all parameters by 0.25 and every leaf's cosine similarity
from below by 0.85 (measured 0.157 and 0.93; dropping the stats cotangent
gives 0.49 and 0.35). The two input-grad routes, which share one forward,
are held to the per-parameter 2e-2 bound against each other."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_resnet18_variables
from tpu_dp.models import build_model as jax_build
from tpu_dp.train.step import cross_entropy_loss as jax_xent
from tpu_dp_torch.compat import convert_grads, convert_variables, \
    load_jax_variables
from tpu_dp_torch.models import build_model
from tpu_dp_torch.ops import conv_block
from tpu_dp_torch.train.step import cross_entropy_loss

pytestmark = pytest.mark.port

# The suite runs several pytest workers on one machine: keep each worker's
# PyTorch CPU pool small so the port's tests do not starve the others.
torch.set_num_threads(2)

FUSED = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def variables():
    return jax_resnet18_variables(num_filters=8, seed=2)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, 8).astype(np.int32))


def _port(variables, fused_stages, fused_bwd=False):
    m = build_model("resnet18", num_filters=8, fused_stages=fused_stages,
                    fused_bwd=fused_bwd)
    return load_jax_variables(m, variables).train()


@pytest.mark.parametrize("fused_stages", [(), FUSED])
def test_train_forward_and_batch_stats_match_jax(variables, batch,
                                                 fused_stages):
    images, _ = batch
    jm = jax_build("resnet18", num_filters=8, fused_stages=fused_stages)
    ref, mutated = jm.apply(variables, images, train=True,
                            mutable=["batch_stats"])
    ref = np.asarray(ref, np.float32)
    tm = _port(variables, fused_stages)
    with torch.no_grad():
        got = tm(torch.from_numpy(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 10)
    scale = float(np.abs(ref).max())
    rel = 1e-2 if fused_stages else 5e-3
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=rel * scale)
    new_stats = convert_variables(
        {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                               dict(mutated["batch_stats"]))})
    own = tm.state_dict()
    assert len(new_stats) == 40  # 20 BatchNorms x (mean, var)
    for key, v in new_stats.items():
        np.testing.assert_allclose(own[key].numpy(), v.numpy(), rtol=0,
                                   atol=5e-3, err_msg=key)


def _port_grads(variables, batch, fused_stages, fused_bwd=False):
    images, labels = batch
    tm = _port(variables, fused_stages, fused_bwd)
    cross_entropy_loss(tm(torch.from_numpy(images)),
                       torch.from_numpy(labels)).backward()
    out = {}
    for name, p in tm.named_parameters():
        assert p.grad is not None, f"{name} got no gradient"
        out[name] = p.grad
    return out


@pytest.mark.parametrize("fused_stages,fused_bwd", [
    ((), False), (FUSED, False), (FUSED, True)])
def test_param_grads_match_jax(variables, batch, fused_stages, fused_bwd):
    images, labels = batch
    jm = jax_build("resnet18", num_filters=8, fused_stages=fused_stages,
                   fused_bwd=fused_bwd)

    def loss(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          images, train=True, mutable=["batch_stats"])
        return jax_xent(out, jnp.asarray(labels))

    ref = convert_grads(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(variables["params"])))
    got = _port_grads(variables, batch, fused_stages, fused_bwd)
    assert set(got) == set(ref)
    if not fused_stages:
        for name, r in ref.items():
            scale = float(r.abs().max())
            assert scale > 0, name
            np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=0,
                                       atol=2e-2 * scale, err_msg=name)
        return
    num = sum(float((got[n] - r).square().sum()) for n, r in ref.items())
    den = sum(float(r.square().sum()) for r in ref.values())
    assert (num / den) ** 0.5 <= 0.25
    for name, r in ref.items():
        g = got[name].flatten()
        cos = float(g @ r.flatten() / (g.norm() * r.norm()))
        assert cos >= 0.85, (name, cos)


def test_input_grad_routes_agree(variables, batch):
    # fused_bwd changes only the backward's input-grad launch.
    lib = _port_grads(variables, batch, FUSED, fused_bwd=False)
    reuse = _port_grads(variables, batch, FUSED, fused_bwd=True)
    for name, r in lib.items():
        scale = float(r.abs().max())
        np.testing.assert_allclose(reuse[name].numpy(), r.numpy(), rtol=0,
                                   atol=2e-2 * scale, err_msg=name)


def test_fused_train_forward_uses_the_stats_variant(monkeypatch, variables,
                                                    batch):
    # 4 x emit_z without residual, 1 x emit_z with residual, 5 x plain,
    # all emitting stats; no eval-variant call in train mode.
    calls = []
    real = conv_block.fused_conv_bn

    def spy(*a, **kw):
        res = a[4] if len(a) > 4 else kw.get("residual")
        calls.append((kw.get("emit_z", False), res is not None))
        return real(*a, **kw)

    monkeypatch.setattr("tpu_dp_torch.models.resnet.fused_conv_bn", spy)
    for name in ("fused_affine_relu_conv", "fused_affine_relu_conv_emit"):
        monkeypatch.setattr("tpu_dp_torch.models.resnet." + name, None)
    tm = _port(variables, FUSED)
    tm(torch.from_numpy(batch[0])).sum().backward()
    assert sorted(calls) == sorted(
        [(True, False)] * 4 + [(True, True)] + [(False, False)] * 5)
    assert tm.BasicBlock_0.Conv_0.weight.grad is not None
