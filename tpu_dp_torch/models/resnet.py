"""CIFAR ResNet-18 for the port (of `tpu_dp.models.resnet`), NHWC, eval.

The module tree mirrors the JAX package's parameter tree name for name
(``stem_conv``, ``stem_norm``, ``BasicBlock_i/{Conv_j, BatchNorm_j,
shortcut_conv, shortcut_norm}``, ``classifier``), so `tpu_dp_torch.compat`
maps every leaf one to one, and a fused and an unfused model share one
state dict.

Activations are NHWC-contiguous tensors ``[B, H, W, C]`` from end to end
(the JAX package's layout, and the layout the conv kernel reads). The
convs outside the kernel (stem, stride-2, 1x1 shortcut) go to
``F.conv2d`` on an NCHW view of them with channels-last strides, which
cuDNN takes without a copy.

``fused_stages`` selects stages whose stride-1, channel-preserving blocks
run as `FusedBasicBlock` chains on the hand-written kernel
(`tpu_dp_torch.ops.conv_block`): each block's BN-apply + residual + ReLU
tail is deferred into the next block's first conv, so the normalized
activation is made in the kernel's shared memory and never stored apart
from the skip connection's copy. A full-fused ResNet-18 forward launches
the kernel 10 times. This slice ports the eval forward only.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_dp_torch.ops.conv_block import (
    _reference_z,
    fused_affine_relu_conv,
    fused_affine_relu_conv_emit,
    pack_weight,
)


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """Flax/XLA ``SAME`` padding (lo, hi): asymmetric when odd, e.g. (0, 1)
    for a 3x3 stride-2 conv over 32 pixels."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Bias-free conv over NHWC tensors with ``SAME`` padding, computed in
    ``dtype`` (Flax ``nn.Conv(use_bias=False, dtype=...)``). The weight is
    OIHW, PyTorch's layout; init is variance_scaling(2.0, fan_out, normal)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype=torch.float32, generator=None, device=None):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        std = math.sqrt(2.0 / (k * k * cout))
        w = torch.empty(cout, cin, k, k, device=device)
        self.weight = nn.Parameter(w.normal_(0.0, std, generator=generator))

    def forward(self, x):
        _, h, w, _ = x.shape
        ph, pw = _same_pad(h, self.k, self.stride), _same_pad(w, self.k,
                                                             self.stride)
        xc = x.to(self.dtype).permute(0, 3, 1, 2)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
            pad = 0
        y = F.conv2d(xc, self.weight.to(self.dtype), stride=self.stride,
                     padding=pad)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Eval BatchNorm with Flax's parameter set (``weight`` = scale γ,
    ``bias`` = β, running ``mean``/``var``), momentum 0.9 / eps 1e-5."""

    def __init__(self, c: int, zero_scale: bool = False, dtype=torch.float32,
                 device=None, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(
            torch.zeros(c, device=device) if zero_scale
            else torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def forward(self, x):
        """Flax's `_normalize` with running stats, in f32, cast to dtype."""
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean) * mul + self.bias
        return y.to(self.dtype)

    def coeffs(self):
        """`BatchNormCoeffs` (eval): ``(scale, shift)`` in f32 with
        ``bn(x) == x * scale + shift``."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut (ResNet-18/34)."""

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype=torch.float32, generator=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(cin, filters, 3, stride, generator=generator, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, 3, generator=generator, **kw)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True, **kw)
        if stride != 1 or cin != filters:
            self.shortcut_conv = Conv(cin, filters, 1, stride,
                                      generator=generator, **kw)
            self.shortcut_norm = BatchNorm(filters, **kw)
        else:
            self.shortcut_conv = self.shortcut_norm = None
        self._packed = {}

    def forward(self, x):
        residual = x
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.shortcut_conv is not None:
            residual = self.shortcut_norm(self.shortcut_conv(residual))
        return torch.relu(y + residual)

    def packed(self, name: str) -> torch.Tensor:
        """The conv's weight in the kernel's layout, repacked only when the
        parameter changed (a new tensor, or an in-place write)."""
        wt = getattr(self, name).weight
        key = (wt.data_ptr(), wt._version, wt.device)
        hit = self._packed.get(name)
        if hit is None or hit[0] != key:
            hit = (key, pack_weight(wt.detach().permute(2, 3, 1, 0)))
            self._packed[name] = hit
        return hit[1]

    def fused(self, x_raw, in_scale, in_shift, in_res):
        """`FusedBasicBlock` (eval): takes the block input in deferred form,
        ``a_in = relu(x_raw * in_scale + in_shift [+ in_res])``, and returns
        ``(y2_raw, out_scale, out_shift, a_in)`` in the same form."""
        if self.shortcut_conv is not None:
            raise ValueError("only stride-1 channel-preserving blocks fuse")
        y1, a_in = fused_affine_relu_conv_emit(
            x_raw, self.packed("Conv_0"), in_scale, in_shift, in_res)
        s1, b1 = self.BatchNorm_0.coeffs()
        y2 = fused_affine_relu_conv(y1, self.packed("Conv_1"), s1, b1)
        s2, b2 = self.BatchNorm_1.coeffs()
        return y2, s2, b2, a_in.to(self.BatchNorm_1.dtype)


def _materialize(x_raw, scale, shift, res, dtype):
    """Chain exit: the kernel's own transform (f32 affine + residual +
    ReLU, rounded through bf16 even at f32), so chain interior and exit
    never drift numerically."""
    z = _reference_z(x_raw, scale, shift, res, True)
    return z.to(torch.bfloat16).to(dtype)


class ResNet(nn.Module):
    """CIFAR-variant ResNet over NHWC inputs: 3x3 stride-1 stem, no pool,
    stages ``num_filters * [1, 2, 4, 8]`` with stride 2 from stage 1 on,
    global average pool, f32 classifier. Eval forward only."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 10, num_filters: int = 64,
                 dtype=torch.float32, fused_stages: Sequence[int] = (),
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.num_classes = int(num_classes)
        self.stage_sizes = tuple(stage_sizes)
        self.fused_stages = frozenset(fused_stages)
        kw = dict(dtype=dtype, device=device)
        self.stem_conv = Conv(3, num_filters, 3, generator=generator, **kw)
        self.stem_norm = BatchNorm(num_filters, **kw)
        cin = num_filters
        self._plan = []  # (block name, stage, fusable)
        idx = 0
        for i, count in enumerate(self.stage_sizes):
            filters = num_filters * 2 ** i
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"BasicBlock_{idx}"
                self.add_module(name, BasicBlock(cin, filters, stride,
                                                 generator=generator, **kw))
                fusable = (i in self.fused_stages and stride == 1
                           and cin == filters)
                self._plan.append((name, i, fusable))
                cin = filters
                idx += 1
        self.classifier = nn.Linear(cin, num_classes, device=device)
        # Flax Dense default: lecun_normal (truncated at 2 sigma), zero bias.
        std = math.sqrt(1.0 / cin) / 0.87962566103423978
        with torch.no_grad():
            self.classifier.weight.copy_(
                torch.nn.init.trunc_normal_(
                    torch.empty(num_classes, cin, device=device), 0.0, std,
                    -2 * std, 2 * std, generator=generator))
            self.classifier.bias.zero_()

    def forward(self, x):
        """Eval logits ``[B, num_classes]`` (f32) of NHWC images."""
        x = self.stem_conv(x.to(self.dtype))
        chain = None  # (x_raw, scale, shift, residual) while chaining
        if 0 in self.fused_stages:
            sc, sh = self.stem_norm.coeffs()
            chain = (x.contiguous(), sc, sh, None)
        else:
            x = torch.relu(self.stem_norm(x))
        for name, _, fusable in self._plan:
            block = getattr(self, name)
            if fusable:
                if chain is None:
                    # Enter from a plain activation A: relu(A) == A.
                    c = x.shape[-1]
                    chain = (x.contiguous(),
                             torch.ones(c, device=x.device),
                             torch.zeros(c, device=x.device), None)
                chain = block.fused(*chain)
            else:
                if chain is not None:
                    x = _materialize(*chain, self.dtype)
                    chain = None
                x = block(x)
        if chain is not None:
            x = _materialize(*chain, self.dtype)
        x = x.float().mean(dim=(1, 2)).to(self.dtype)  # global average pool
        return self.classifier(x.float())


def ResNet18(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), **kwargs)
