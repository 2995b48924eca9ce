"""Fused affine + residual + ReLU + 3x3 conv: the Hopper kernel and its
plain PyTorch version (port of `tpu_dp.ops.conv_block`, eval variants).

    z = act(x * scale + shift [+ residual])     # f32, rounded to bf16
    y = conv3x3_SAME(z, W)                      # stride 1, C -> C, bf16 x bf16,
                                                # f32 accumulate, y rounded to bf16
    returns y as x's dtype (and z, as x's dtype, from the ``_emit`` variant)

The kernel is `csrc/conv_block.cu`, a hand-written CUDA C++ kernel for
``sm_90a`` built with nvcc at first use and bound with ctypes
(`tpu_dp_torch.ops._build`). It replaces the TPU kernel `_conv_kernel` in
``tpu_dp/ops/conv_block.py`` (plain, ``emit_z`` and ``emit_z`` + residual
variants; the ``emit_stats`` variant and the backward reuse belong to the
training slice). The source states its bound and design.

Dispatch is by where the tensor lies, nothing else: a CPU tensor goes to
`reference_affine_relu_conv` (the plain version, used by the CPU tests);
a CUDA tensor launches the kernel or raises — no fallback. Layout at the
public functions is the JAX package's: NHWC ``x``/``residual``, HWIO
``w``. ``w`` may also be the kernel's packed layout from `pack_weight`
(``[9, C_out, C_in]`` bf16), which the model caches so that no call
repacks its weights.

``launches`` counts kernel launches (a plain integer, CUDA only).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

#: kernel launches since import or the last `reset_launches` (CUDA only).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64  # the kernel's pixel tile and channel block (csrc/conv_block.cu)
_fn = None


def reset_launches() -> None:
    global launches
    launches = 0


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, C_in, C_out]`` → the kernel's ``[9, C_out, C_in]`` bf16."""
    if w.dim() != 4 or w.shape[:2] != (3, 3):
        raise ValueError(f"expected an HWIO 3x3 weight, got {tuple(w.shape)}")
    ci, co = w.shape[2], w.shape[3]
    return (w.to(torch.bfloat16).reshape(9, ci, co).transpose(1, 2)
            .contiguous())


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """HWIO view of ``w`` in either accepted layout (plain version only)."""
    if w.dim() == 3:
        c = w.shape[1]
        return w.transpose(1, 2).reshape(3, 3, w.shape[2], c)
    return w


def _reference_z(x, scale, shift, residual=None, activate=True):
    z = x.float() * scale.float() + shift.float()
    if residual is not None:
        z = z + residual.float()
    return torch.relu(z) if activate else z


def _conv3x3(z, w):
    """conv3x3_SAME of bf16-rounded operands, accumulated in f32, output
    rounded to bf16 — the JAX package's `_conv3x3` statement. NHWC in,
    NHWC bf16 out."""
    zq = z.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wq = _hwio(w).to(torch.bfloat16).float().permute(3, 2, 0, 1)
    y = F.conv2d(zq, wq, padding=1)
    return y.permute(0, 2, 3, 1).to(torch.bfloat16)


def reference_affine_relu_conv(x, w, scale, shift, residual=None,
                               activate=True, emit_z=False):
    """The plain version: same math and the same two bf16 roundings, in
    f32 PyTorch ops. Returns ``y`` (or ``(y, z)`` with ``emit_z``).

    On a card, f32 convs must run without TF32
    (``torch.backends.cudnn.allow_tf32 = False``) for this to be the
    f32-accumulated statement."""
    z = _reference_z(x, scale, shift, residual, activate)
    y = _conv3x3(z, w).to(x.dtype).contiguous()
    if emit_z:
        return y, z.to(torch.bfloat16).to(x.dtype).contiguous()
    return y


def _kernel():
    global _fn
    if _fn is None:
        from tpu_dp_torch.ops import _build

        fn = _build.load("conv_block").tpu_dp_conv_block
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, t, dev, dtype=None, shape=None):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (NHWC for images)")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _launch(x, w, scale, shift, residual, activate, emit_z):
    global launches
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B,H,W,C], got {tuple(x.shape)}")
    b, h, wd, c = x.shape
    hw = h * wd
    if c % _TILE or _TILE % wd or not (
            (hw % _TILE == 0 and h % (_TILE // wd) == 0) or _TILE % hw == 0):
        raise ValueError(
            f"conv_block kernel takes C % 64 == 0, W dividing 64 and H*W a "
            f"multiple or divisor of 64; got [B,H,W,C] = {tuple(x.shape)}")
    dev = x.device
    _check("x", x, dev)
    if w.dim() == 4:
        if tuple(w.shape) != (3, 3, c, c):
            raise ValueError(f"w must be [3,3,{c},{c}], got {tuple(w.shape)}")
        w = pack_weight(w)
    _check("w", w, dev, torch.bfloat16, (9, c, c))
    _check("scale", scale, dev, torch.float32, (c,))
    _check("shift", shift, dev, torch.float32, (c,))
    if residual is not None:
        _check("residual", residual, dev, x.dtype, x.shape)
    y = torch.empty_like(x)
    z = torch.empty_like(x) if emit_z else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _kernel()(
            _DTYPES[x.dtype], residual is not None, bool(emit_z),
            bool(activate), x.data_ptr(), w.data_ptr(), scale.data_ptr(),
            shift.data_ptr(),
            None if residual is None else residual.data_ptr(),
            y.data_ptr(), None if z is None else z.data_ptr(),
            b, h, wd, c, stream)
    if rc != 0:
        raise RuntimeError(f"conv_block kernel launch failed: error {rc}")
    launches += 1
    return (y, z) if emit_z else y


def _run(x, w, scale, shift, residual, activate, emit_z):
    if x.device.type == "cpu":
        return reference_affine_relu_conv(x, w, scale, shift, residual,
                                          activate, emit_z)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block runs on cpu or cuda, got {x.device}")
    return _launch(x, w, scale, shift, residual, activate, emit_z)


def fused_affine_relu_conv(x, w, scale, shift, residual=None, activate=True):
    """``y = conv3x3_SAME(act(x*scale + shift [+ residual]), w)``.

    x: ``[B,H,W,C]`` f32 or bf16; w: HWIO ``[3,3,C,C]`` (or `pack_weight`'s
    layout); scale/shift: ``[C]`` f32; residual: like x, or None; act = ReLU
    when ``activate``. Returns y with x's dtype. Inference only (no
    autograd: the backward kernel comes with the training slice).
    """
    return _run(x, w, scale, shift, residual, activate, False)


def fused_affine_relu_conv_emit(x, w, scale, shift, residual=None,
                                activate=True):
    """Like `fused_affine_relu_conv`, and also returns the transformed
    activation ``z = act(x*scale + shift [+ residual])`` (bf16-rounded, as
    x's dtype), written by the same kernel pass: ``(y, z)``."""
    return _run(x, w, scale, shift, residual, activate, True)
