"""SGD with momentum for the port (of `tpu_dp.train.optim.SGD`).

`torch.optim.SGD` already has the JAX package's update rule: the momentum
buffer starts at the first gradient (``0.9·0 + g`` there, a copy of g
here), and weight decay is ``g + wd·p`` before the momentum accumulation.
The learning rate is set per update by the trainer's schedule.

``decay_exclude_bias_and_norm`` keeps BatchNorm scales and biases and
every bias out of the decay. The JAX package picks them by Flax leaf name
(``bias``/``scale``); here they are picked by module type, which names
the same set of parameters without depending on torch's attribute names.
"""

from __future__ import annotations

import torch

from tpu_dp_torch.models.resnet import BatchNorm


def _no_decay(model: torch.nn.Module) -> set[int]:
    """ids of the parameters kept out of weight decay."""
    out = set()
    for m in model.modules():
        if isinstance(m, BatchNorm):
            out.update({id(m.weight), id(m.bias)})
        bias = getattr(m, "bias", None)
        if isinstance(bias, torch.nn.Parameter):
            out.add(id(bias))
    return out


def make_sgd(model: torch.nn.Module, momentum: float = 0.9,
             weight_decay: float = 0.0,
             decay_exclude_bias_and_norm: bool = False) -> torch.optim.SGD:
    """`torch.optim.SGD` over ``model``'s parameters with the JAX package's
    semantics; the learning rate starts at 0 (the schedule sets it)."""
    params = list(model.parameters())
    if weight_decay and decay_exclude_bias_and_norm:
        skip = _no_decay(model)
        groups = [
            {"params": [p for p in params if id(p) not in skip]},
            {"params": [p for p in params if id(p) in skip],
             "weight_decay": 0.0},
        ]
    else:
        groups = [{"params": params}]
    return torch.optim.SGD(groups, lr=0.0, momentum=momentum,
                           weight_decay=weight_decay)
