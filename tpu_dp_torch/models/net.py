"""`Net`: the reference's LeNet-style CIFAR CNN (port of `tpu_dp.models.net`)
with the reference's own module names:

    conv1: 3→6, 5×5, valid padding        (456 params)
    maxpool 2×2 stride 2
    conv2: 6→16, 5×5, valid padding       (2 416 params)
    maxpool 2×2 stride 2
    flatten → fc1: 400→120 (48 120) → fc2: 120→84 (10 164) → fc3: 84→10 (850)

62 006 parameters. ReLU follows each conv and fc1/fc2; fc3 gives logits.
It takes the port's NHWC batches, permutes them to NCHW at entry and
flattens in torch's (C, H, W) order, so a reference ``cifar_net.pth``
state dict (with or without DDP's ``module.``) loads with
`load_state_dict` as it is; `tpu_dp_torch.compat` maps it to and from the
JAX package's NHWC-flattened ``Net``. The init is Flax's (lecun_normal
kernels, zero biases) from a seeded ``generator``. Under ``dtype=bfloat16``
the convs, fc1 and fc2 compute in bf16 and fc3 in f32, as in the JAX
package. The convs and denses are cuDNN's and cuBLAS's on the card: the
JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_dp_torch.compat import strip_module_prefix


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator) -> None:
    """Flax's default kernel init: normal(0, 1/fan_in) truncated at 2σ."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        weight.copy_(torch.nn.init.trunc_normal_(
            torch.empty_like(weight, device="cpu"), 0.0, std, -2 * std,
            2 * std, generator=generator))


class Net(nn.Module):
    """The reference CNN; NHWC images in, f32 logits out."""

    def __init__(self, num_classes: int = 10, dtype=torch.float32,
                 generator=None, device=None, process_group=None):
        super().__init__()
        del process_group  # no BatchNorm: nothing to sync
        self.num_classes = int(num_classes)
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 6, 5, device=device)
        self.pool = nn.MaxPool2d(2, 2)
        self.conv2 = nn.Conv2d(6, 16, 5, device=device)
        self.fc1 = nn.Linear(16 * 5 * 5, 120, device=device)
        self.fc2 = nn.Linear(120, 84, device=device)
        self.fc3 = nn.Linear(84, self.num_classes, device=device)
        for m in (self.conv1, self.conv2, self.fc1, self.fc2, self.fc3):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            with torch.no_grad():
                m.bias.zero_()

    def _layer(self, x, m, dtype):
        w, b = m.weight.to(dtype), m.bias.to(dtype)
        x = x.to(dtype)
        if isinstance(m, nn.Conv2d):
            return F.conv2d(x, w, b)
        return F.linear(x, w, b)

    def forward(self, x):
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW
        x = self.pool(F.relu(self._layer(x, self.conv1, dt)))
        x = self.pool(F.relu(self._layer(x, self.conv2, dt)))
        x = torch.flatten(x, 1)  # (C, H, W), torch's order
        x = F.relu(self._layer(x, self.fc1, dt))
        x = F.relu(self._layer(x, self.fc2, dt))
        return self._layer(x, self.fc3, torch.float32)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """`nn.Module.load_state_dict` of a state dict with or without
        DDP's ``module.`` prefix (the reference's DDP run saves it)."""
        return super().load_state_dict(strip_module_prefix(state_dict),
                                       strict=strict, assign=assign)
