"""Shared inputs of the port's parity tests (tests/test_torch_*.py): JAX
ResNet variables with randomized BatchNorm, as nested numpy dicts."""

from __future__ import annotations

import jax
import numpy as np


def randomize_bn(tree, rng, _path=()):
    """Random BN γ, β, running mean and var (a fresh init zeroes each
    block's last γ, which would hide half the convs from the logits)."""
    out = {}
    for k, a in tree.items():
        if isinstance(a, dict):
            out[k] = randomize_bn(a, rng, _path + (k,))
        elif k == "scale":
            out[k] = (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(
                np.float32)
        elif k == "bias" and "classifier" not in _path:
            out[k] = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif k == "mean":
            out[k] = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        else:
            out[k] = np.asarray(a)
    return out


def jax_resnet18_variables(num_filters=8, seed=0, num_classes=10):
    """``{"params", "batch_stats"}`` of a JAX ResNet-18 as numpy dicts,
    BN randomized from ``seed``."""
    from tpu_dp.models import build_model

    model = build_model("resnet18", num_classes=num_classes,
                        num_filters=num_filters)
    v = model.init(jax.random.PRNGKey(seed),
                   np.zeros((1, 32, 32, 3), np.float32), train=False)
    v = _plain({k: v[k] for k in ("params", "batch_stats")})
    return randomize_bn(v, np.random.default_rng(seed + 100))


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else v
            for k, v in tree.items()}
