"""Eval logits of the port's ResNet-18 equal the JAX package's on converted
weights, for fused and unfused models at f32 and bf16.

Narrow model (num_filters=8), B=4, 32x32 inputs, BN randomized. Tolerance
relative to max|logits|: 1e-4 for unfused f32 (the same f32 math, summed
in another order); 1e-2 for fused models or bf16, where about 20 convs
round through bf16 and a rounding that flips on one side propagates."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_resnet18_variables
from tpu_dp.models import build_model as jax_build
from tpu_dp_torch.compat import load_jax_variables
from tpu_dp_torch.models import build_model, parse_fused_stages
from tpu_dp_torch.models.resnet import _same_pad
from tpu_dp_torch.ops import conv_block

pytestmark = pytest.mark.port

# The suite runs several pytest workers on one machine: keep each worker's
# PyTorch CPU pool small so the port's tests do not starve the others.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def variables():
    return jax_resnet18_variables(num_filters=8, seed=1)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(7).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused_stages", [(), (0,), (0, 1, 2, 3)])
def test_eval_logits_match_jax(variables, images, fused_stages, dtype):
    jm = jax_build("resnet18", num_filters=8, dtype=getattr(jnp, dtype),
                   fused_stages=fused_stages)
    ref = np.asarray(jm.apply(variables, images, train=False), np.float32)
    tm = build_model("resnet18", num_filters=8, dtype=getattr(torch, dtype),
                     fused_stages=fused_stages)
    load_jax_variables(tm, variables).eval()
    with torch.inference_mode():
        got = tm(torch.from_numpy(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 10)
    rel = 1e-4 if (dtype == "float32" and not fused_stages) else 1e-2
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=rel * scale)


def test_full_fused_forward_runs_ten_kernel_calls(monkeypatch, images):
    # 4 x emit_z without residual, 1 x emit_z with residual, 5 x plain —
    # the wrappers' call pattern on a card (here they run the plain
    # version, so the launch counter itself stays at 0).
    calls = []
    for name, kind in (("fused_affine_relu_conv", "plain"),
                       ("fused_affine_relu_conv_emit", "emit")):
        real = getattr(conv_block, name)

        def spy(*a, _real=real, _kind=kind, **kw):
            res = a[4] if len(a) > 4 else kw.get("residual")
            calls.append((_kind, res is not None))
            return _real(*a, **kw)

        monkeypatch.setattr("tpu_dp_torch.models.resnet." + name, spy)
    conv_block.reset_launches()
    model = build_model("resnet18", num_filters=8, fused_stages=(0, 1, 2, 3))
    with torch.inference_mode():
        model(torch.from_numpy(images))
    assert sorted(calls) == sorted(
        [("emit", False)] * 4 + [("emit", True)] + [("plain", False)] * 5)
    assert conv_block.launches == 0


def test_same_padding_is_flax_same():
    assert _same_pad(32, 3, 2) == (0, 1)   # asymmetric, not torch's (1, 1)
    assert _same_pad(32, 3, 1) == (1, 1)
    assert _same_pad(32, 1, 2) == (0, 0)
    assert _same_pad(7, 3, 2) == (1, 1)


def test_parse_fused_stages_and_unknown_model():
    assert parse_fused_stages("") == ()
    assert parse_fused_stages("all") == (0, 1, 2, 3)
    assert parse_fused_stages("2,0") == (0, 2)
    with pytest.raises(ValueError):
        parse_fused_stages("4")
    with pytest.raises(ValueError, match="unknown model"):
        build_model("resnet50")


def test_seeded_init_is_deterministic_and_fresh_init_zeroes_last_bn():
    a = build_model("resnet18", num_filters=8,
                    generator=torch.Generator().manual_seed(3))
    b = build_model("resnet18", num_filters=8,
                    generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.count_nonzero(a.BasicBlock_0.BatchNorm_1.weight) == 0
    w = a.BasicBlock_1.Conv_0.weight.detach()
    assert abs(float(w.std()) - (2.0 / (9 * 8)) ** 0.5) < 0.05
