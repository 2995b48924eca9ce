"""Fused affine + residual + ReLU + 3x3 conv: the Hopper kernel, its plain
PyTorch version and its gradient (port of `tpu_dp.ops.conv_block`).

    z = act(x * scale + shift [+ residual])     # f32, rounded to bf16
    y = conv3x3_SAME(z, W)                      # stride 1, C -> C, bf16 x bf16,
                                                # f32 accumulate, y rounded to bf16
    returns y as x's dtype; the ``_emit`` variant also returns z (as x's
    dtype), and `fused_conv_bn` also returns the BatchNorm moments
    ``stats = [sum(y), sum(y^2)]`` per channel of the rounded y, in f32

The kernel is `csrc/conv_block.cu`, a hand-written CUDA C++ kernel for
``sm_90a`` built with nvcc at first use and bound with ctypes
(`tpu_dp_torch.ops._build`). It replaces the TPU kernel `_conv_kernel` in
``tpu_dp/ops/conv_block.py`` in every variant: plain, ``emit_z``,
``emit_z`` + residual, and ``emit_stats``, whose cross-block sum of the
moments finishes in the same launch: the last blocks to arrive sum the
blocks' rows in index order (`ordered_stats_sum` replays that order). The
source states its bound and design.

All three public functions are differentiable through one
`torch.autograd.Function`, the port of the JAX package's custom VJP
(`_fwd_rule` / `_bwd_rule` / `_bwd_core`): z is recomputed in the
backward; the stats cotangent joins y's in f32 before one rounding to
bf16; the weight-grad contraction is a library conv on bf16 operands
(cuDNN on a card), as it is XLA's in the JAX package; the input-grad conv
is the library's too, or — with ``pallas_bwd`` — this same kernel on the
spatially flipped, io-swapped weight (`flip_packed`).

Dispatch is by where the tensor lies, nothing else: a CPU tensor goes to
the plain version (`reference_affine_relu_conv`, used by the CPU tests);
a CUDA tensor launches the kernel or raises — no fallback. Layout at the
public functions is the JAX package's: NHWC ``x``/``residual``, HWIO
``w``. ``w`` may also be the kernel's packed layout from `pack_weight`
(``[9, C_out, C_in]`` bf16), which the model caches for its forwards
without gradient.

``launches`` counts conv kernel launches (a plain integer, CUDA only);
``launches_by_role`` splits them into ``eval`` (no stats), ``stats``
(`fused_conv_bn`) and ``input_grad`` (the backward reuse). A stats launch
is one launch: there is no separate reduce.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from tpu_dp_torch.ops import _tickets

#: conv kernel launches since import or the last `reset_launches` (CUDA
#: only), every variant.
launches = 0
#: the same launches by role: "eval", "stats", "input_grad".
launches_by_role = {"eval": 0, "stats": 0, "input_grad": 0}
#: serializes the books' increments: serve replicas launch from their own
#: dispatch threads.
_books_lock = threading.Lock()
#: blocks per level-1 group of the kernel's stats fold (`ordered_stats_sum`).
STATS_GROUP = 32
#: the smallest tile's pixels: the most partial rows a launch can write are
#: ceil(B*H*W / this).
_MIN_TILE_PIXELS = 64
_MIN_TILE_CHANNELS = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_lib = None


def reset_launches() -> None:
    global launches
    with _books_lock:
        launches = 0
        for role in launches_by_role:
            launches_by_role[role] = 0


def count_launch(role: str) -> None:
    """Book one launch of ``role`` (exact under concurrent threads)."""
    global launches
    with _books_lock:
        launches += 1
        launches_by_role[role] += 1


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, C_in, C_out]`` → the kernel's ``[9, C_out, C_in]`` bf16."""
    if w.dim() != 4 or w.shape[:2] != (3, 3):
        raise ValueError(f"expected an HWIO 3x3 weight, got {tuple(w.shape)}")
    ci, co = w.shape[2], w.shape[3]
    return (w.to(torch.bfloat16).reshape(9, ci, co).transpose(1, 2)
            .contiguous())


def flip_packed(w: torch.Tensor) -> torch.Tensor:
    """The packed weight of the input-grad conv: ``pack_weight(flip_hw(w)
    .swap_io)`` from ``w`` in either accepted layout. Tap ``t`` of the
    flipped kernel is tap ``8 - t`` of ``w`` with input and output
    channels swapped."""
    wk = w if w.dim() == 3 else pack_weight(w)
    return wk.flip(0).transpose(1, 2).contiguous()


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


def _stats_of(y):
    """[sum, sum of squares] per channel of a (rounded) conv output, f32."""
    yf = y.float()
    return torch.stack([yf.sum(dim=(0, 1, 2)), yf.square().sum(dim=(0, 1, 2))])


def ordered_stats_sum(partials, group=STATS_GROUP):
    """The kernel's cross-block sum of the stats rows ``partials``
    ``[nb, 2, C]`` (f32), in its order: the rows of each group of ``group``
    consecutive blocks added one at a time from 0, then the group sums
    added one at a time from 0 (one group: its sum). Bit-exact with the
    kernel on the rows its launch wrote; the CPU tests and chip_smoke.py
    replay it, the main path never calls it."""
    rows = partials.float()

    def in_order(rs):
        acc = torch.zeros_like(rows[0])
        for r in rs:
            acc = acc + r
        return acc
    groups = [in_order(rows[g:g + group])
              for g in range(0, rows.shape[0], group)]
    return groups[0] if len(groups) == 1 else in_order(groups)


def reference_affine_relu_conv(x, w, scale, shift, residual=None,
                               activate=True, emit_z=False, emit_stats=False):
    """The plain version: same math and the same two bf16 roundings, in
    f32 PyTorch ops. Returns ``y``, or the tuple ``(y, [z,] [stats])``
    when ``emit_z`` or ``emit_stats`` asks for more.

    On a card, f32 convs must run without TF32
    (``torch.backends.cudnn.allow_tf32 = False``) for this to be the
    f32-accumulated statement."""
    z = _reference_z(x, scale, shift, residual, activate)
    yq = _conv3x3(z, w)
    y = yq.to(x.dtype).contiguous()
    if not (emit_z or emit_stats):
        return y
    out = (y,)
    if emit_z:
        out += (z.to(torch.bfloat16).to(x.dtype).contiguous(),)
    if emit_stats:
        out += (_stats_of(yq),)
    return out


def _kernel():
    global _fn, _lib
    if _fn is None:
        from tpu_dp_torch.ops import _build

        lib = _build.load("conv_block")
        fn = lib.tpu_dp_conv_block
        fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.tpu_dp_conv_block_tile.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.tpu_dp_conv_block_tile.restype = ctypes.c_int
        _fn, _lib = fn, lib
    return _fn


def stats_scratch(b, h, w, c, group=STATS_GROUP):
    """``(rows, tickets)`` that cover a stats launch of ``[b,h,w,c]`` with
    any tile: partial rows plus group rows of the scratch, and ticket
    counters (`_tickets`). Upper bounds from the smallest tile, so the
    wrapper needs no call into the library to size them."""
    rows = -(-b * h * w // _MIN_TILE_PIXELS)
    groups = -(-rows // group)
    return rows + groups, (c // _MIN_TILE_CHANNELS) * (groups + 1)


def tile_of(b, h, w, c) -> dict:
    """The kernel's tile for ``[b,h,w,c]``: pixels ``bm`` and output
    channels ``bn`` per block, and the grid's ``blocks`` (``blocks //
    (c // bn)`` of them along x: the rows of the stats partials)."""
    _kernel()
    out = (ctypes.c_int * 3)()
    if _lib.tpu_dp_conv_block_tile(b, h, w, c, out) != 0:
        raise ValueError(f"conv_block kernel refuses [B,H,W,C] = "
                         f"{(b, h, w, c)}")
    return {"bm": out[0], "bn": out[1], "blocks": out[2]}


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


def _launch(x, w, scale, shift, residual, activate, emit_z,
            emit_stats=False, role="eval"):
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B,H,W,C], got {tuple(x.shape)}")
    b, h, wd, c = x.shape
    hw = h * wd
    if c % 64 or 64 % wd or not (
            (hw % 64 == 0 and h % (64 // wd) == 0) or 64 % hw == 0):
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
    partials = stats = tick = None
    rows = n_tick = 0
    if emit_stats:
        rows, n_tick = stats_scratch(b, h, wd, c)
        partials = torch.empty((rows, 2, c), dtype=torch.float32, device=dev)
        stats = torch.empty((2, c), dtype=torch.float32, device=dev)
        tick = _tickets.tickets(dev, n_tick)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _kernel()(
            _DTYPES[x.dtype], residual is not None, bool(emit_z),
            bool(activate), bool(emit_stats), x.data_ptr(), w.data_ptr(),
            scale.data_ptr(), shift.data_ptr(),
            None if residual is None else residual.data_ptr(),
            y.data_ptr(), None if z is None else z.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if stats is None else stats.data_ptr(),
            None if tick is None else tick.data_ptr(),
            b, h, wd, c, rows, n_tick, STATS_GROUP, stream)
    if rc != 0:
        raise RuntimeError(f"conv_block kernel launch failed: error {rc}")
    count_launch(role)
    out = (y,) + ((z,) if emit_z else ()) + ((stats,) if emit_stats else ())
    return out if len(out) > 1 else y


def _run(x, w, scale, shift, residual, activate, emit_z, emit_stats=False,
         role="eval"):
    if x.device.type == "cpu":
        return reference_affine_relu_conv(x, w, scale, shift, residual,
                                          activate, emit_z, emit_stats)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block runs on cpu or cuda, got {x.device}")
    return _launch(x, w, scale, shift, residual, activate, emit_z,
                   emit_stats, role)


def _conv_grads(z, w, ct, input_grad, weight_grad):
    """Grads of ``conv3x3_SAME(bf16(z), bf16(w))`` for the bf16 cotangent
    ``ct``: ``(dz, dw)``, each rounded to bf16 and returned as f32 (dz NHWC,
    dw in ``w``'s HWIO layout), or None where not asked for. On a card the
    operands go to cuDNN in bf16 (f32 accumulate); on the CPU the same
    bf16 values are convolved in f32."""
    dt = torch.bfloat16 if ct.is_cuda else torch.float32
    zq = z.to(torch.bfloat16).to(dt).permute(0, 3, 1, 2)
    wq = _hwio(w).to(torch.bfloat16).to(dt).permute(3, 2, 0, 1)
    g = ct.to(dt).permute(0, 3, 1, 2)
    gi, gw, _ = torch.ops.aten.convolution_backward(
        g, zq, wq, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [input_grad, weight_grad, False])
    dz = (gi.to(torch.bfloat16).float().permute(0, 2, 3, 1)
          if input_grad else None)
    dw = (gw.to(torch.bfloat16).float().permute(2, 3, 1, 0)
          if weight_grad else None)
    return dz, dw


def _bwd_core(needs, x, w, scale, shift, residual, activate, pallas_bwd, ct,
              ct_z):
    """`_bwd_core` of the JAX package: ``(dx, dw, dscale, dshift, dres)``
    from y's cotangent ``ct`` (any float dtype, rounded to bf16 here once)
    and the emitted z's ``ct_z`` (or None)."""
    z = _reference_z(x, scale, shift, residual, activate)
    ctc = ct.to(torch.bfloat16).contiguous()
    dz, dw = _conv_grads(z, w, ctc, input_grad=not pallas_bwd,
                         weight_grad=needs[1])
    if pallas_bwd:
        c = x.shape[-1]
        ones = torch.ones(c, dtype=torch.float32, device=x.device)
        zeros = torch.zeros(c, dtype=torch.float32, device=x.device)
        dz = _run(ctc, flip_packed(w), ones, zeros, None, False, False,
                  role="input_grad").float()
    if ct_z is not None:
        dz = dz + ct_z.float()
    # Through act and affine: gate on the post-act sign (z > 0 iff pre > 0).
    dpre = dz * (z > 0) if activate else dz
    dx = (dpre * scale.float()).to(x.dtype)
    dscale = (dpre * x.float()).sum(dim=(0, 1, 2)).to(scale.dtype)
    dshift = dpre.sum(dim=(0, 1, 2)).to(shift.dtype)
    dres = dpre.to(residual.dtype) if residual is not None else None
    if dw is not None and w.dim() == 3:
        # Gradient in the packed layout the caller passed.
        ci = w.shape[2]
        dw = dw.reshape(9, ci, -1).transpose(1, 2).to(w.dtype)
    return dx, dw, dscale, dshift, dres


class _FusedConv(torch.autograd.Function):
    """One autograd rule for every variant (`_fused_conv_vjp`). Always
    returns a tuple ``(y, [z,] [stats])``."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, residual, activate, pallas_bwd,
                emit_z, emit_stats):
        out = _run(x, w, scale, shift, residual, activate, emit_z,
                   emit_stats, "stats" if emit_stats else "eval")
        out = out if isinstance(out, tuple) else (out,)
        ctx.flags = (activate, pallas_bwd, emit_z, emit_stats)
        # y is kept only for the stats backward (it exists anyway).
        ctx.save_for_backward(x, w, scale, shift, residual,
                              out[0] if emit_stats else None)
        return out

    @staticmethod
    def backward(ctx, *cts):
        activate, pallas_bwd, emit_z, emit_stats = ctx.flags
        x, w, scale, shift, residual, y = ctx.saved_tensors
        ct_y = cts[0]
        ct_z = cts[1] if emit_z else None
        if emit_stats:
            # stats = [sum(y), sum(y^2)]: their cotangent joins y's in f32,
            # rounded once into the bf16 cotangent of the conv.
            ct_s = cts[-1]
            ct_y = ct_y.float() + ct_s[0] + 2.0 * y.float() * ct_s[1]
        grads = _bwd_core(ctx.needs_input_grad, x, w, scale, shift, residual,
                          activate, pallas_bwd, ct_y, ct_z)
        return grads + (None,) * 4


def fused_affine_relu_conv(x, w, scale, shift, residual=None, activate=True,
                           pallas_bwd=False):
    """``y = conv3x3_SAME(act(x*scale + shift [+ residual]), w)``.

    x: ``[B,H,W,C]`` f32 or bf16; w: HWIO ``[3,3,C,C]`` (or `pack_weight`'s
    layout); scale/shift: ``[C]`` f32; residual: like x, or None; act = ReLU
    when ``activate``. Returns y with x's dtype. Differentiable in x, w,
    scale, shift and residual; ``pallas_bwd`` routes the backward
    input-grad conv through this kernel too.
    """
    return _FusedConv.apply(x, w, scale, shift, residual, activate,
                            pallas_bwd, False, False)[0]


def fused_affine_relu_conv_emit(x, w, scale, shift, residual=None,
                                activate=True, pallas_bwd=False):
    """Like `fused_affine_relu_conv`, and also returns the transformed
    activation ``z = act(x*scale + shift [+ residual])`` (bf16-rounded, as
    x's dtype), written by the same kernel pass: ``(y, z)``."""
    return _FusedConv.apply(x, w, scale, shift, residual, activate,
                            pallas_bwd, True, False)


def fused_conv_bn(x, w, scale, shift, residual=None, activate=True,
                  pallas_bwd=False, emit_z=False):
    """Fused conv that also emits the BatchNorm moments of its output:
    ``(y, [z,] stats)`` with ``stats = [sum(y), sum(y^2)]`` per channel of
    the rounded y, in f32 — what `BatchNorm.coeffs` needs in train mode,
    without a pass that re-reads y. Bit-identical from launch to launch
    (no float atomics)."""
    return _FusedConv.apply(x, w, scale, shift, residual, activate,
                            pallas_bwd, emit_z, True)
