"""SGD with momentum for the port (of `tpu_dp.train.optim.SGD`).

The JAX package's update rule, as ``torch._foreach_*`` ops over each
parameter group: weight decay ``d = g + wd·p`` before the momentum
accumulation, ``buf = m·buf + d``, ``p = p - lr·buf`` — the same rule as
`torch.optim.SGD`, whose first step copies g into the buffer where this
one, like the JAX opt state, starts the buffer at zeros (``0.9·0 + g`` is
g bit for bit).

The learning rate is a tensor on the parameters' device, read by the
update (`SGD.step`): the train step looks it up in its device table at its
device step counter, so the update runs without the host and a CUDA graph
can capture and replay it. (`torch.optim.SGD` takes a tensor lr only by
calling ``.item()`` on it, which waits for the device.) The update rounds
``lr·buf`` before the subtraction, where torch's ``add_(buf, alpha=-lr)``
rounds once: an ulp apart at most.

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


class SGD(torch.optim.Optimizer):
    """Momentum SGD whose ``step`` takes the learning rate as a 0-dim
    tensor on the parameters' device. The momentum buffers exist from the
    start (zeros, in ``state[p]["momentum_buffer"]``, where
    `tpu_dp_torch.checkpoint` reads and restores them)."""

    def __init__(self, params, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=0.0, momentum=momentum,
                                      weight_decay=weight_decay))
        for group in self.param_groups:
            if group["momentum"]:
                for p in group["params"]:
                    self.state[p]["momentum_buffer"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, lr: torch.Tensor) -> None:
        """One update of every parameter that has a gradient, at ``lr``."""
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            d = [p.grad for p in params]
            if group["weight_decay"]:
                d = torch._foreach_add(d, params, alpha=group["weight_decay"])
            if group["momentum"]:
                bufs = [self.state[p]["momentum_buffer"] for p in params]
                torch._foreach_mul_(bufs, group["momentum"])
                torch._foreach_add_(bufs, d)
                d = bufs
            torch._foreach_sub_(params, torch._foreach_mul(d, lr))


def make_sgd(model: torch.nn.Module, momentum: float = 0.9,
             weight_decay: float = 0.0,
             decay_exclude_bias_and_norm: bool = False) -> SGD:
    """`SGD` over ``model``'s parameters with the JAX package's semantics
    (the learning rate is the train step's, per update)."""
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
    return SGD(groups, momentum=momentum, weight_decay=weight_decay)
