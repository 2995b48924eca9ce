"""JAX package variables ↔ the port's state dict, both directions.

`convert_variables` takes ``{"params": ..., "batch_stats": ...}`` as
nested dicts of numpy arrays (a Flax model's variables passed through
``np.asarray``) and returns a flat state dict for the port's model;
`export_variables` is its exact inverse, bit for bit:

- conv ``kernel`` HWIO ``[kh, kw, in, out]`` ↔ ``weight`` OIHW;
- Dense ``kernel`` ``(in, out)`` ↔ ``weight`` ``(out, in)``, ``bias`` as is;
- BatchNorm ``scale``/``bias`` ↔ ``weight``/``bias``; batch_stats
  ``mean``/``var`` ↔ ``running_mean``/``running_var``.

ResNet module paths are kept as they are (``BasicBlock_3/Conv_0`` becomes
``BasicBlock_3.Conv_0``): the port's module tree mirrors the Flax tree,
and fused and unfused JAX models share one tree.

The reference's ``Net`` (params ``conv1``, ``conv2``, ``fc1``, ``fc2``,
``fc3``, no batch_stats) takes one more map: the JAX package's NHWC ``Net``
flattens conv2's 16×5×5 output as (H, W, C), torch's as (C, H, W), so
fc1's input rows are permuted (the map of `tpu_dp.compat.torch_compat`,
kept here as the port's own copy). DDP's ``module.`` prefix is stripped on
the way in and never written.

An unknown leaf name or collection raises; `load_jax_variables` also
raises on a key the model lacks or a model key the variables lack, and on
any shape mismatch. `convert_grads` applies the params map to a
params-shaped tree (gradients, the optimizer's momentum), and
`export_params` the inverse to a ``{name: tensor}`` dict keyed like
``model.named_parameters()``.
"""

from __future__ import annotations

import numpy as np
import torch

_PARAM_LEAVES = {"kernel", "bias", "scale"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_STAT_NAMES = {v: k for k, v in _STAT_LEAVES.items()}
_NET_MODULES = {"conv1", "conv2", "fc1", "fc2", "fc3"}
# conv2's output feeding fc1: 16 channels × 5 × 5 pixels.
_C, _H, _W = 16, 5, 5


def _fc1_permutation() -> np.ndarray:
    """perm[flax_row] = torch_column for ``Net``'s fc1 400-dim input."""
    perm = np.empty(_C * _H * _W, dtype=np.int64)
    for h in range(_H):
        for w in range(_W):
            for c in range(_C):
                perm[(h * _W + w) * _C + c] = (c * _H + h) * _W + w
    return perm


def strip_module_prefix(state_dict: dict) -> dict:
    """DDP's ``module.`` wrapper prefix removed, if every key has it."""
    if state_dict and all(k.startswith("module.") for k in state_dict):
        return {k.removeprefix("module."): v for k, v in state_dict.items()}
    return state_dict


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _is_net(top_level_names) -> bool:
    return set(top_level_names) == _NET_MODULES


def convert_variables(variables) -> dict[str, torch.Tensor]:
    """The port's state dict (f32 CPU tensors) of JAX model variables."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown variable collections: {sorted(unknown)}")
    params = variables.get("params", {})
    net = _is_net(params)
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _walk(params):
        *mod, leaf_name = path
        if leaf_name not in _PARAM_LEAVES or not mod:
            raise KeyError(f"unknown parameter {'/'.join(path)}")
        a = np.asarray(leaf, np.float32)
        if leaf_name == "kernel" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif leaf_name == "kernel" and a.ndim == 2:
            if net and mod == ["fc1"]:
                a = a[np.argsort(_fc1_permutation())]
            a = a.T
        elif leaf_name == "kernel":
            raise ValueError(f"kernel {'/'.join(path)} has shape {a.shape}")
        name = "bias" if leaf_name == "bias" else "weight"
        # A C-order copy: a transposed view would give the tensor
        # transposed strides, which a collective sends in storage order.
        out[".".join(mod + [name])] = torch.from_numpy(
            np.array(a, order="C"))
    for path, leaf in _walk(variables.get("batch_stats", {})):
        *mod, leaf_name = path
        if leaf_name not in _STAT_LEAVES or not mod:
            raise KeyError(f"unknown batch stat {'/'.join(path)}")
        out[".".join(mod + [_STAT_LEAVES[leaf_name]])] = torch.from_numpy(
            np.array(leaf, np.float32))
    return out


def convert_grads(jax_param_grads) -> dict[str, torch.Tensor]:
    """A params-shaped JAX tree (gradients, momentum) keyed and laid out
    like the port's parameters: ``{name: tensor}`` for every name of
    ``model.named_parameters()``."""
    return convert_variables({"params": jax_param_grads})


def nest(tree: dict, path: tuple[str, ...], value) -> None:
    """Set ``tree[path[0]]...[path[-1]] = value``, making the dicts."""
    node = tree
    for m in path[:-1]:
        node = node.setdefault(m, {})
    if path[-1] in node:
        raise KeyError(f"two leaves map to {'/'.join(path)}")
    node[path[-1]] = value


def jax_leaves(state_dict) -> list[tuple[str, tuple[str, ...], torch.Tensor]]:
    """``(collection, path, tensor)`` for every entry of the port's state
    dict: the JAX package's collection (``params`` / ``batch_stats``),
    leaf path and layout, as views of the entries (on their device) where
    a view does it. A 1-d ``weight`` is a BatchNorm scale; ``bias`` is a
    bias (Conv, Dense and BatchNorm alike)."""
    sd = {k: torch.as_tensor(v) for k, v in
          strip_module_prefix(dict(state_dict)).items()}
    net = _is_net({k.split(".")[0] for k in sd})
    out = []
    for key, t in sd.items():
        mod, _, leaf = key.rpartition(".")
        if not mod:
            raise KeyError(f"unknown state-dict entry {key!r}")
        mod = tuple(mod.split("."))
        if leaf in _STAT_NAMES:
            out.append(("batch_stats", mod + (_STAT_NAMES[leaf],), t))
            continue
        if leaf == "bias":
            out.append(("params", mod + ("bias",), t))
        elif leaf != "weight":
            raise KeyError(f"unknown state-dict entry {key!r}")
        elif t.ndim == 4:
            out.append(("params", mod + ("kernel",), t.permute(2, 3, 1, 0)))
        elif t.ndim == 2:
            k = t.t()
            if net and key == "fc1.weight":
                k = k[torch.from_numpy(_fc1_permutation()).to(t.device)]
            out.append(("params", mod + ("kernel",), k))
        elif t.ndim == 1:
            out.append(("params", mod + ("scale",), t))
        else:
            raise ValueError(f"{key} has shape {tuple(t.shape)}")
    return out


def param_leaves(named) -> list[tuple[str, str, torch.Tensor]]:
    """``(flax key, name, index)`` for every parameter of ``named`` (``{name:
    tensor}`` keyed like ``model.named_parameters()``), in the JAX pytree
    order (dict keys sorted as strings at every level, the order the JAX
    package's sharded update and bucket plan walk). The key is the flax
    path '/'-joined (``BasicBlock_0/Conv_0/kernel``); ``index[j]`` is the
    position, in the torch tensor's C-order flatten, of element j of the
    JAX leaf's (HWIO for a conv, ``(in, out)`` for a Dense)."""
    sd = strip_module_prefix(dict(named))
    idx = {k: torch.arange(v.numel()).view(tuple(v.shape))
           for k, v in sd.items()}
    out = [("/".join(path), name, t.reshape(-1))
           for name, (_, path, t) in zip(idx, jax_leaves(idx))]
    return sorted(out, key=lambda e: tuple(e[0].split("/")))


def leaf_sizes(named) -> list[tuple[str, int]]:
    """``(flax key, elements)`` of every parameter of ``named``, in the JAX
    pytree order (`param_leaves` without the index maps; meta tensors
    do)."""
    leaves = jax_leaves(strip_module_prefix(dict(named)))
    return sorted((("/".join(path), t.numel()) for _, path, t in leaves),
                  key=lambda e: tuple(e[0].split("/")))


def export_variables(state_dict) -> dict[str, dict]:
    """The JAX package's ``{"params", "batch_stats"}`` (nested dicts of
    float32 numpy arrays) of the port's state dict: the exact inverse of
    `convert_variables`."""
    out: dict = {"params": {}, "batch_stats": {}}
    for collection, path, t in jax_leaves(state_dict):
        a = t.detach().to("cpu", torch.float32).numpy()
        nest(out[collection], path, np.array(a, order="C"))
    return out


def export_params(named) -> dict:
    """A params-shaped JAX tree of ``{name: tensor}`` keyed like
    ``model.named_parameters()`` (parameters, gradients, momentum)."""
    return export_variables(named)["params"]


def load_jax_variables(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Load JAX variables into ``model`` in place (on the model's device);
    every key must match both ways, with equal shapes."""
    state = convert_variables(variables)
    check_state_dict(model, state)
    model.load_state_dict(state, strict=True)
    return model


def check_state_dict(model: torch.nn.Module, state: dict) -> None:
    """Raise unless ``state`` has exactly ``model``'s keys and shapes."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, unknown {extra}")
    for k, v in state.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != model's "
                             f"{tuple(own[k].shape)}")
