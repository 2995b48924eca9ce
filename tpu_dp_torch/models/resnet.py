"""CIFAR ResNet-18 and ResNet-50 for the port (of `tpu_dp.models.resnet`),
NHWC.

The module tree mirrors the JAX package's parameter tree name for name
(``stem_conv``, ``stem_norm``, ``BasicBlock_i`` or ``BottleneckBlock_i``
``/{Conv_j, BatchNorm_j, shortcut_conv, shortcut_norm}``, ``classifier``),
so `tpu_dp_torch.compat` maps every leaf one to one, and a fused and an
unfused model share one state dict.

Activations are NHWC-contiguous tensors ``[B, H, W, C]`` from end to end
(the JAX package's layout, and the layout the conv kernel reads). The
convs outside the kernel (stem, stride-2, 1x1) go to ``F.conv2d`` on an
NCHW view of them with channels-last strides, which cuDNN takes without a
copy.

``fused_stages`` selects stages whose blocks run on the hand-written
kernel (`tpu_dp_torch.ops.conv_block`). ResNet-18: the stride-1,
channel-preserving blocks run as `FusedBasicBlock` chains, each block's
BN-apply + residual + ReLU tail deferred into the next block's first conv,
so the normalized activation is made in the kernel's shared memory and
never stored apart from the skip connection's copy; a full-fused forward
launches the kernel 10 times. ResNet-50: every stride-1 bottleneck runs
its middle 3x3 as `FusedBottleneckBlock` (block-local: the 1x1 convs
bound the kernel's shape, so there is no chain and the stem is not
deferred); a full-fused forward launches the kernel 13 times.

The forward follows ``module.training``: in train mode BatchNorm
normalizes with the batch's statistics and updates its running ones
(flax ``nn.BatchNorm(use_running_average=False, momentum=0.9)``), and the
fused convs run `fused_conv_bn`, whose kernel also emits each conv
output's moments, so no pass re-reads y for them. With a
``process_group`` of more than one rank BatchNorm is sync-BN: every
train-mode BatchNorm (the kernel's moments and the plain path's: the stem,
the shortcuts, the 1x1 convs, unfused blocks) takes the mean of its
``[2, C]`` moments over the ranks, one differentiable all-reduce each way
(`tpu_dp_torch.parallel.collectives.pmean`). Gradients reach every
fused conv's weight through the autograd rule of `tpu_dp_torch.ops.
conv_block`; ``fused_bwd`` routes its input-grad conv through the kernel.
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
    fused_conv_bn,
    pack_weight,
)
from tpu_dp_torch.parallel import collectives


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
    """BatchNorm with Flax's parameter set (``weight`` = scale γ, ``bias`` =
    β, running ``mean``/``var``), momentum 0.9 / eps 1e-5.

    Train mode (``self.training``) mirrors flax ``nn.BatchNorm(
    use_running_average=False)``: batch mean and *biased* variance
    ``E[x²] - E[x]²`` in f32, clamped at 0, and running stats updated as
    ``0.9·old + 0.1·batch`` in place. (``F.batch_norm`` would update the
    running variance with the unbiased estimate, so it is not used.)

    With a ``process_group`` of more than one rank, the batch moments
    ``[E[x], E[x²]]`` are averaged over its ranks before use (the JAX
    package's ``axis_name``): every rank normalizes with the global
    batch's statistics, and its running stats stay identical to the
    others'. Eval never syncs."""

    def __init__(self, c: int, zero_scale: bool = False, dtype=torch.float32,
                 device=None, eps: float = 1e-5, momentum: float = 0.9,
                 process_group=None):
        super().__init__()
        self.dtype, self.eps, self.momentum = dtype, eps, momentum
        self.process_group = process_group
        self.weight = nn.Parameter(
            torch.zeros(c, device=device) if zero_scale
            else torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def _moments(self, x, stats=None):
        """``(mean, var)`` per channel: running stats in eval; in train the
        batch's, from the kernel's ``stats = [sum, sum of squares]`` when
        given (x is then read for its shape only), synced over the process
        group, updating the running stats."""
        if not self.training:
            return self.running_mean, self.running_var
        if stats is not None:
            count = x.shape[0] * x.shape[1] * x.shape[2]
            moments = stats / count
        else:
            xf = x.float()
            moments = torch.stack([xf.mean(dim=(0, 1, 2)),
                                   xf.square().mean(dim=(0, 1, 2))])
        # One [2, C] all-reduce each way (identity without a group).
        mean, mean2 = collectives.pmean(moments, self.process_group)
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        return mean, var

    def forward(self, x):
        """Flax's `_normalize`, in f32, cast to dtype."""
        mean, var = self._moments(x)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean) * mul + self.bias
        return y.to(self.dtype)

    def coeffs(self, x=None, stats=None):
        """`BatchNormCoeffs`: ``(scale, shift)`` in f32 with
        ``bn(x) == x * scale + shift``. Eval reads the running stats; train
        needs ``x`` (or its kernel-emitted ``stats``)."""
        mean, var = self._moments(x, stats)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return scale, self.bias - mean * scale


class _KernelBlock(nn.Module):
    """A residual block with convs on the kernel: the packed-weight cache
    of its fused path. ``expansion``: output channels per filter;
    ``chains``: whether its fused path takes and returns the deferred
    form (`ResNet.forward`)."""

    expansion = 1
    chains = False

    def __init__(self):
        super().__init__()
        self._packed = {}

    def conv_weight(self, name: str) -> torch.Tensor:
        """The conv's weight for the kernel: the HWIO view of the parameter
        while autograd records (so the weight gets its gradient), else the
        kernel's packed layout, cached and repacked only when the parameter
        changed (a new tensor, or an in-place write)."""
        wt = getattr(self, name).weight
        if torch.is_grad_enabled() and wt.requires_grad:
            return wt.permute(2, 3, 1, 0)
        key = (wt.data_ptr(), wt._version, wt.device)
        hit = self._packed.get(name)
        if hit is None or hit[0] != key:
            hit = (key, pack_weight(wt.detach().permute(2, 3, 1, 0)))
            self._packed[name] = hit
        return hit[1]

    @torch.inference_mode()
    def refresh_packed(self) -> None:
        """Repack every cached weight from its parameter INTO the cached
        tensor: a CUDA graph that captured the kernel reads the packed
        weight at its address, and a replay never runs `conv_weight`'s
        version check (a serve replica's hot swap). Under inference mode:
        the serve step made its packed weights there."""
        for name, (_, packed) in list(self._packed.items()):
            wt = getattr(self, name).weight
            packed.copy_(pack_weight(wt.detach().permute(2, 3, 1, 0)))
            self._packed[name] = ((wt.data_ptr(), wt._version, wt.device),
                                  packed)


def refresh_packed_weights(model: nn.Module) -> None:
    """`_KernelBlock.refresh_packed` on every block of ``model`` (a no-op
    for a model without the kernel)."""
    for m in model.modules():
        if isinstance(m, _KernelBlock):
            m.refresh_packed()


class BasicBlock(_KernelBlock):
    """Two 3x3 convs + identity/projection shortcut (ResNet-18/34)."""

    chains = True

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype=torch.float32, generator=None, device=None,
                 fused_bwd: bool = False, process_group=None):
        super().__init__()
        self.fused_bwd = fused_bwd
        kw = dict(dtype=dtype, device=device)
        bn = dict(kw, process_group=process_group)
        self.Conv_0 = Conv(cin, filters, 3, stride, generator=generator, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **bn)
        self.Conv_1 = Conv(filters, filters, 3, generator=generator, **kw)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True, **bn)
        if stride != 1 or cin != filters:
            self.shortcut_conv = Conv(cin, filters, 1, stride,
                                      generator=generator, **kw)
            self.shortcut_norm = BatchNorm(filters, **bn)
        else:
            self.shortcut_conv = self.shortcut_norm = None

    def forward(self, x):
        residual = x
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.shortcut_conv is not None:
            residual = self.shortcut_norm(self.shortcut_conv(residual))
        return torch.relu(y + residual)

    def fused(self, x_raw, in_scale, in_shift, in_res):
        """`FusedBasicBlock`: takes the block input in deferred form,
        ``a_in = relu(x_raw * in_scale + in_shift [+ in_res])``, and returns
        ``(y2_raw, out_scale, out_shift, a_in)`` in the same form."""
        if self.shortcut_conv is not None:
            raise ValueError("only stride-1 channel-preserving blocks fuse")
        w1, w2 = self.conv_weight("Conv_0"), self.conv_weight("Conv_1")
        bwd = self.fused_bwd
        if self.training:
            y1, a_in, st1 = fused_conv_bn(x_raw, w1, in_scale, in_shift,
                                          in_res, pallas_bwd=bwd, emit_z=True)
            s1, b1 = self.BatchNorm_0.coeffs(y1, st1)
            y2, st2 = fused_conv_bn(y1, w2, s1, b1, pallas_bwd=bwd)
            s2, b2 = self.BatchNorm_1.coeffs(y2, st2)
        else:
            y1, a_in = fused_affine_relu_conv_emit(
                x_raw, w1, in_scale, in_shift, in_res, pallas_bwd=bwd)
            s1, b1 = self.BatchNorm_0.coeffs()
            y2 = fused_affine_relu_conv(y1, w2, s1, b1, pallas_bwd=bwd)
            s2, b2 = self.BatchNorm_1.coeffs()
        return y2, s2, b2, a_in.to(self.BatchNorm_1.dtype)


def _materialize(x_raw, scale, shift, res, dtype):
    """Chain exit: the kernel's own transform (f32 affine + residual +
    ReLU, rounded through bf16 even at f32), so chain interior and exit
    never drift numerically."""
    z = _reference_z(x_raw, scale, shift, res, True)
    return z.to(torch.bfloat16).to(dtype)


class BottleneckBlock(_KernelBlock):
    """1x1 reduce -> 3x3 with the block's stride -> 1x1 expand (x4), plus
    an identity/projection shortcut (ResNet-50)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype=torch.float32, generator=None, device=None,
                 fused_bwd: bool = False, process_group=None):
        super().__init__()
        self.fused_bwd = fused_bwd
        kw = dict(dtype=dtype, device=device)
        bn = dict(kw, process_group=process_group)
        cout = filters * self.expansion
        self.Conv_0 = Conv(cin, filters, 1, generator=generator, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **bn)
        self.Conv_1 = Conv(filters, filters, 3, stride, generator=generator,
                           **kw)
        self.BatchNorm_1 = BatchNorm(filters, **bn)
        self.Conv_2 = Conv(filters, cout, 1, generator=generator, **kw)
        self.BatchNorm_2 = BatchNorm(cout, zero_scale=True, **bn)
        if stride != 1 or cin != cout:
            self.shortcut_conv = Conv(cin, cout, 1, stride,
                                      generator=generator, **kw)
            self.shortcut_norm = BatchNorm(cout, **bn)
        else:
            self.shortcut_conv = self.shortcut_norm = None

    def _tail(self, y, residual):
        """``relu(bn2(conv2(y)) + shortcut(residual))``."""
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.shortcut_conv is not None:
            residual = self.shortcut_norm(self.shortcut_conv(residual))
        return torch.relu(y + residual)

    def forward(self, x):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y)))
        return self._tail(y, x)

    def fused(self, x):
        """`FusedBottleneckBlock`: the 3x3 on the kernel, bn1's apply + ReLU
        in its input transform and, in train mode, bn2's moments emitted
        by it; its output leaves through the kernel's own transform
        (`_materialize`). Stride-1 blocks only."""
        if self.Conv_1.stride != 1:
            raise ValueError("only stride-1 bottleneck blocks fuse")
        y = self.Conv_0(x).contiguous()
        s1, b1 = self.BatchNorm_0.coeffs(y)
        w2 = self.conv_weight("Conv_1")
        if self.training:
            y2, st2 = fused_conv_bn(y, w2, s1, b1,
                                    pallas_bwd=self.fused_bwd)
            s2, b2 = self.BatchNorm_1.coeffs(y2, st2)
        else:
            y2 = fused_affine_relu_conv(y, w2, s1, b1,
                                        pallas_bwd=self.fused_bwd)
            s2, b2 = self.BatchNorm_1.coeffs()
        return self._tail(_materialize(y2, s2, b2, None, y2.dtype), x)


class ResNet(nn.Module):
    """CIFAR-variant ResNet over NHWC inputs: 3x3 stride-1 stem, no pool,
    stages of ``block_cls`` with ``num_filters * [1, 2, 4, 8]`` filters and
    stride 2 from stage 1 on, global average pool, f32 classifier.
    ``fused_stages`` picks the stages whose blocks fuse (the JAX package's
    plan: basic blocks when stride-1 and channel-preserving, bottlenecks
    whenever stride-1); ``fused_bwd`` sends the fused convs' backward
    input-grad through the kernel too; ``process_group`` makes every
    BatchNorm sync-BN over its ranks."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block_cls: type = BasicBlock,
                 num_classes: int = 10, num_filters: int = 64,
                 dtype=torch.float32, fused_stages: Sequence[int] = (),
                 generator: torch.Generator | None = None, device=None,
                 fused_bwd: bool = False, process_group=None):
        super().__init__()
        self.dtype = dtype
        self.num_classes = int(num_classes)
        self.stage_sizes = tuple(stage_sizes)
        self.fused_stages = frozenset(fused_stages)
        kw = dict(dtype=dtype, device=device)
        self.stem_conv = Conv(3, num_filters, 3, generator=generator, **kw)
        self.stem_norm = BatchNorm(num_filters, process_group=process_group,
                                   **kw)
        cin = num_filters
        #: whether a fused stage 0 enters a chain at the stem.
        self._chains = block_cls.chains
        self._plan = []  # (block name, stage, fusable)
        idx = 0
        for i, count in enumerate(self.stage_sizes):
            filters = num_filters * 2 ** i
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"{block_cls.__name__}_{idx}"
                self.add_module(name, block_cls(cin, filters, stride,
                                                generator=generator,
                                                fused_bwd=fused_bwd,
                                                process_group=process_group,
                                                **kw))
                fusable = (i in self.fused_stages and stride == 1
                           and (cin == filters or not self._chains))
                self._plan.append((name, i, fusable))
                cin = filters * block_cls.expansion
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
        """Logits ``[B, num_classes]`` (f32) of NHWC images; train or eval
        as ``self.training`` says."""
        x = self.stem_conv(x.to(self.dtype))
        chain = None  # (x_raw, scale, shift, residual) while chaining
        if self._chains and 0 in self.fused_stages:
            sc, sh = self.stem_norm.coeffs(x)
            chain = (x.contiguous(), sc, sh, None)
        else:
            x = torch.relu(self.stem_norm(x))
        for name, _, fusable in self._plan:
            block = getattr(self, name)
            if fusable and self._chains:
                if chain is None:
                    # Enter from a plain activation A: relu(A) == A.
                    c = x.shape[-1]
                    chain = (x.contiguous(),
                             torch.ones(c, device=x.device),
                             torch.zeros(c, device=x.device), None)
                chain = block.fused(*chain)
                continue
            if chain is not None:
                x = _materialize(*chain, self.dtype)
                chain = None
            x = block.fused(x) if fusable else block(x)
        if chain is not None:
            x = _materialize(*chain, self.dtype)
        x = x.float().mean(dim=(1, 2)).to(self.dtype)  # global average pool
        return self.classifier(x.float())


def ResNet18(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock, **kwargs)


def ResNet50(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock,
                  **kwargs)
