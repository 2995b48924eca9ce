"""JAX package variables → the port's state dict.

Takes ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays (a Flax ResNet's variables passed through ``np.asarray``) and
returns a flat state dict for `tpu_dp_torch.models.resnet.ResNet`:

- conv ``kernel`` HWIO ``[kh, kw, in, out]`` → ``weight`` OIHW;
- Dense ``kernel`` ``(in, out)`` → ``weight`` ``(out, in)``, ``bias`` as is;
- BatchNorm ``scale``/``bias`` → ``weight``/``bias``; batch_stats
  ``mean``/``var`` → ``running_mean``/``running_var``.

Module paths are kept as they are (``BasicBlock_3/Conv_0`` becomes
``BasicBlock_3.Conv_0``): the port's module tree mirrors the Flax tree,
and fused and unfused JAX models share one tree. An unknown leaf name or
collection raises; `load_jax_variables` also raises on a key the model
lacks or a model key the variables lack, and on any shape mismatch.
"""

from __future__ import annotations

import numpy as np
import torch

_PARAM_LEAVES = {"kernel", "bias", "scale"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def convert_variables(variables) -> dict[str, torch.Tensor]:
    """The port's state dict (f32 CPU tensors) of JAX ResNet variables."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown variable collections: {sorted(unknown)}")
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _walk(variables.get("params", {})):
        *mod, leaf_name = path
        if leaf_name not in _PARAM_LEAVES or not mod:
            raise KeyError(f"unknown parameter {'/'.join(path)}")
        a = np.asarray(leaf, np.float32)
        if leaf_name == "kernel" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif leaf_name == "kernel" and a.ndim == 2:
            a = a.T
        elif leaf_name == "kernel":
            raise ValueError(f"kernel {'/'.join(path)} has shape {a.shape}")
        name = "bias" if leaf_name == "bias" else "weight"
        out[".".join(mod + [name])] = torch.from_numpy(np.array(a))
    for path, leaf in _walk(variables.get("batch_stats", {})):
        *mod, leaf_name = path
        if leaf_name not in _STAT_LEAVES or not mod:
            raise KeyError(f"unknown batch stat {'/'.join(path)}")
        out[".".join(mod + [_STAT_LEAVES[leaf_name]])] = torch.from_numpy(
            np.array(leaf, np.float32))
    return out


def load_jax_variables(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Load JAX variables into ``model`` in place (on the model's device);
    every key must match both ways, with equal shapes."""
    state = convert_variables(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, unknown {extra}")
    for k, v in state.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != model's "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(state, strict=True)
    return model
