"""`tpu_dp_torch.compat`: every leaf of a JAX ResNet-18 maps into the port's
state dict with the right layout and shape, and nothing else does."""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest
import torch

from torch_port_util import jax_resnet18_variables
from tpu_dp_torch.compat import convert_variables, load_jax_variables
from tpu_dp_torch.models import build_model

pytestmark = pytest.mark.port

# The suite runs several pytest workers on one machine: keep each worker's
# PyTorch CPU pool small so the port's tests do not starve the others.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def variables():
    return jax_resnet18_variables(num_filters=8)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_every_leaf_maps_with_its_layout(variables):
    state = convert_variables(variables)
    n_leaves = len(_leaves(variables))
    assert len(state) == n_leaves == 102
    p, bs = variables["params"], variables["batch_stats"]
    k = p["BasicBlock_2"]["Conv_0"]["kernel"]            # HWIO (3,3,8,16)
    w = state["BasicBlock_2.Conv_0.weight"].numpy()      # OIHW
    assert w.shape == (16, 8, 3, 3)
    np.testing.assert_array_equal(w[5, 3, 1, 2], k[1, 2, 3, 5])
    sc = state["BasicBlock_2.shortcut_conv.weight"].numpy()
    assert sc.shape == (16, 8, 1, 1)
    d = p["classifier"]["kernel"]                        # (in, out)
    np.testing.assert_array_equal(state["classifier.weight"].numpy(), d.T)
    np.testing.assert_array_equal(state["classifier.bias"].numpy(),
                                  p["classifier"]["bias"])
    bn = p["BasicBlock_5"]["BatchNorm_1"]
    np.testing.assert_array_equal(
        state["BasicBlock_5.BatchNorm_1.weight"].numpy(), bn["scale"])
    np.testing.assert_array_equal(
        state["BasicBlock_5.BatchNorm_1.bias"].numpy(), bn["bias"])
    st = bs["stem_norm"]
    np.testing.assert_array_equal(
        state["stem_norm.running_mean"].numpy(), st["mean"])
    np.testing.assert_array_equal(
        state["stem_norm.running_var"].numpy(), st["var"])
    assert all(v.dtype == torch.float32 for v in state.values())


@pytest.mark.parametrize("fused_stages", [(), (0, 1, 2, 3)])
def test_state_matches_model_tree_both_ways(variables, fused_stages):
    model = build_model("resnet18", num_filters=8, fused_stages=fused_stages)
    own = model.state_dict()
    state = convert_variables(variables)
    assert set(own) == set(state)
    for key, v in state.items():
        assert tuple(v.shape) == tuple(own[key].shape), key
    load_jax_variables(model, variables)
    for key, v in model.state_dict().items():
        assert torch.equal(v, state[key]), key


@pytest.mark.parametrize("mutate", [
    "unknown_leaf", "unknown_collection", "unknown_module", "missing_leaf",
    "bad_shape",
])
def test_bad_variables_raise(variables, mutate):
    v = copy.deepcopy(variables)
    model = build_model("resnet18", num_filters=8)
    if mutate == "unknown_leaf":
        v["params"]["stem_conv"]["kernal"] = v["params"]["stem_conv"]["kernel"]
        with pytest.raises(KeyError, match="kernal"):
            convert_variables(v)
    elif mutate == "unknown_collection":
        v["cache"] = {}
        with pytest.raises(KeyError, match="cache"):
            convert_variables(v)
    elif mutate == "unknown_module":
        v["params"]["BasicBlock_99"] = v["params"]["BasicBlock_0"]
        with pytest.raises(KeyError, match="BasicBlock_99"):
            load_jax_variables(model, v)
    elif mutate == "missing_leaf":
        del v["batch_stats"]["BasicBlock_3"]["BatchNorm_0"]["var"]
        with pytest.raises(KeyError, match="BasicBlock_3.BatchNorm_0"):
            load_jax_variables(model, v)
    else:
        v["params"]["classifier"]["bias"] = np.zeros(11, np.float32)
        with pytest.raises(ValueError, match="classifier.bias"):
            load_jax_variables(model, v)
