"""Fused softmax cross-entropy: the Hopper kernels, their plain PyTorch
versions and the autograd rule (port of `tpu_dp.ops.xent`).

`softmax_xent(logits, labels)` is the per-example loss ``(B,)`` in f32 —
``logsumexp(logits) - logits[label]`` per row — and differentiable in the
logits: the backward is ``(softmax - onehot) * ct`` in the logits' dtype.
Both directions are hand-written CUDA C++ kernels for ``sm_90a``
(`csrc/xent.cu`, built with nvcc at first use and bound with ctypes),
replacing the TPU kernels `_fwd_kernel` and `_bwd_kernel` in
``tpu_dp/ops/xent.py``. The source states their bound and design.

`mean_softmax_xent(logits, labels)` is the batch mean — the training
loss — in one launch each way: the forward kernel's mean variant sums the
rows in a fixed order and divides by B in the same launch (no ``.mean()``
launch after it), and the backward kernel reads the scalar cotangent from
the device and scales it by 1/B itself (no ``MeanBackward`` launch before
it). Up to ``ONE_CTA_MAX_ROWS`` rows (C at most ``ONE_CTA_MAX_CLASSES``)
each is one block: no scratch, no ticket, nothing allocated but the output,
so a CUDA graph captures it as one kernel node; above that the forward
sums across blocks with the last block's ordered fold (`_tickets`). The
weighted mean stays the per-example kernel and torch ops, as in the JAX
package.

Dispatch is by where the tensor lies: CPU tensors go to the plain versions
`_plain_fwd` / `_plain_bwd` (the ports of `_jnp_fwd` / `_jnp_bwd`), CUDA
tensors launch the kernels or raise — no fallback. Labels are int64 or
int32. The one-hot compares class indices, as the TPU kernels do, so a
label outside ``[0, C)`` matches no class on both routes: its loss is the
row's logsumexp and its gradient ``softmax * ct`` (no range check on the
host, which would stall every step on a device-to-host copy).

``launches`` counts kernel launches by direction (CUDA only); the mean
variant counts as a forward launch.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpu_dp_torch.ops import _tickets

#: kernel launches since import or the last `reset_launches` (CUDA only).
launches = {"forward": 0, "backward": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_DTYPES = {torch.int32: 0, torch.int64: 1}
_ROWS_PER_BLOCK = 8  # the multi-block kernels' warps: one row each
#: the batch mean runs as one block up to this many rows (at C = 10 on an
#: H100 the one-block forward + backward pair is the faster up to 256-512
#: rows: `chip_smoke.py` phase 9's ``by_batch``) ...
ONE_CTA_MAX_ROWS = 256
#: ... and this many classes (a thread holds its row in registers).
ONE_CTA_MAX_CLASSES = 32
_fns = None


#: serializes the books' increments across threads.
_books_lock = threading.Lock()


def reset_launches() -> None:
    with _books_lock:
        for k in launches:
            launches[k] = 0


def count_launch(direction: str) -> None:
    """Book one launch of ``direction`` (exact under concurrent
    threads)."""
    with _books_lock:
        launches[direction] += 1


def _onehot(labels, c):
    """``[B, C]`` f32 one-hot by class-index compare: a zero row for a
    label outside ``[0, C)``, as ``jax.nn.one_hot`` and the TPU kernels'
    iota compare give."""
    classes = torch.arange(c, device=labels.device)
    return (classes[None, :] == labels.long()[:, None]).float()


def _plain_fwd(logits, labels):
    """Per-example loss in f32 (`_jnp_fwd`): max, logsumexp, label gather;
    an out-of-range label gathers nothing (its true logit is 0)."""
    logits = logits.float()
    c = logits.shape[-1]
    m = logits.max(dim=-1, keepdim=True).values
    lse = torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True)) + m
    lab = labels.long()[:, None]
    true_logit = torch.where((lab >= 0) & (lab < c),
                             torch.gather(logits, -1, lab.clamp(0, c - 1)),
                             0.0)
    return (lse - true_logit)[:, 0]


def _plain_bwd(logits, labels, ct):
    """``(softmax - onehot) * ct`` in the logits' dtype (`_jnp_bwd`)."""
    logits32 = logits.float()
    m = logits32.max(dim=-1, keepdim=True).values
    e = torch.exp(logits32 - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    d = (probs - _onehot(labels, logits.shape[-1])) * ct.float()[:, None]
    return d.to(logits.dtype)


def _kernels():
    global _fns
    if _fns is None:
        from tpu_dp_torch.ops import _build

        lib = _build.load("xent")
        fwd, bwd = lib.tpu_dp_xent_fwd, lib.tpu_dp_xent_bwd
        fwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        bwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fwd.restype = bwd.restype = ctypes.c_int
        _fns = fwd, bwd
    return _fns


def _check(logits, labels):
    if logits.dtype not in _DTYPES:
        raise TypeError(f"logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    if logits.dim() != 2 or logits.shape[0] < 1 or logits.shape[1] < 1:
        raise ValueError(f"logits must be [B, C], got {tuple(logits.shape)}")
    if labels.dtype not in _LABEL_DTYPES:
        raise TypeError(f"labels must be int64 or int32, got {labels.dtype}")
    if tuple(labels.shape) != (logits.shape[0],):
        raise ValueError(f"labels must have shape ({logits.shape[0]},), got "
                         f"{tuple(labels.shape)}")
    if labels.device != logits.device:
        raise ValueError(f"labels are on {labels.device}, logits on "
                         f"{logits.device}")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"xent runs on cpu or cuda, got {logits.device}")


def _one_cta(b, c) -> bool:
    """Whether the batch mean of ``[b, c]`` runs as one block."""
    return b <= ONE_CTA_MAX_ROWS and c <= ONE_CTA_MAX_CLASSES


def _fwd(logits, labels, mean=False):
    """Per-example losses ``(B,)``, or with ``mean`` their mean (a 0-dim
    f32 tensor) from the kernel's mean variant, on the CPU
    ``_plain_fwd(...).mean()``."""
    _check(logits, labels)
    if logits.device.type == "cpu":
        loss = _plain_fwd(logits, labels)
        return loss.mean() if mean else loss
    logits, labels = logits.contiguous(), labels.contiguous()
    b, c = logits.shape
    dev = logits.device
    partials = ticket = out = None
    one_cta = mean and _one_cta(b, c)
    if one_cta:
        out, loss = torch.empty((), dtype=torch.float32, device=dev), None
    elif mean:
        # out[0] is the loss, out[1:] the blocks' partials.
        nblk = -(-b // _ROWS_PER_BLOCK)
        buf = torch.empty(1 + nblk, dtype=torch.float32, device=dev)
        out, partials, ticket = buf[0], buf[1:], _tickets.tickets(dev, 1)
        loss = None
    else:
        loss = torch.empty(b, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _kernels()[0](
            _DTYPES[logits.dtype], _LABEL_DTYPES[labels.dtype],
            logits.data_ptr(), labels.data_ptr(),
            None if loss is None else loss.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if ticket is None else ticket.data_ptr(),
            None if out is None else out.data_ptr(), int(one_cta), b, c,
            stream)
    if rc != 0:
        raise RuntimeError(f"xent forward kernel launch failed: error {rc}")
    count_launch("forward")
    return out if mean else loss


def _bwd(logits, labels, ct, mean=False):
    """``dlogits`` for the per-example cotangent ``ct`` ``(B,)``, or with
    ``mean`` for the batch mean's scalar cotangent ``ct`` (0-dim): each
    row's is ``ct / B``, as MeanBackward gives it."""
    _check(logits, labels)
    b = logits.shape[0]
    want = () if mean else (b,)
    if ct.device != logits.device or tuple(ct.shape) != want:
        raise ValueError(f"ct must be {want} on {logits.device}, got "
                         f"{tuple(ct.shape)} on {ct.device}")
    if logits.device.type == "cpu":
        return _plain_bwd(logits, labels, (ct / b).expand(b) if mean else ct)
    logits, labels = logits.contiguous(), labels.contiguous()
    ct = ct.to(torch.float32).contiguous()
    c = logits.shape[1]
    d = torch.empty_like(logits)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    with torch.cuda.device(logits.device):
        rc = _kernels()[1](_DTYPES[logits.dtype], _LABEL_DTYPES[labels.dtype],
                           logits.data_ptr(), labels.data_ptr(),
                           ct.data_ptr(), 0 if mean else 1, b if mean else 1,
                           d.data_ptr(), int(mean and _one_cta(b, c)), b, c,
                           stream)
    if rc != 0:
        raise RuntimeError(f"xent backward kernel launch failed: error {rc}")
    count_launch("backward")
    return d


class _SoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return _fwd(logits, labels)

    @staticmethod
    def backward(ctx, ct):
        logits, labels = ctx.saved_tensors
        return _bwd(logits, labels, ct), None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy ``(B,)`` in f32, differentiable in
    ``logits`` (``[B, C]`` f32 or bf16); ``labels`` int64 or int32."""
    return _SoftmaxXent.apply(logits, labels)


class _MeanSoftmaxXent(torch.autograd.Function):
    """The batch-mean loss: one kernel launch each way."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return _fwd(logits, labels, mean=True)

    @staticmethod
    def backward(ctx, ct):
        logits, labels = ctx.saved_tensors
        return _bwd(logits, labels, ct, mean=True), None


def mean_softmax_xent(logits, labels, weight=None):
    """(Weighted) mean loss over the fused kernel — drop-in for
    `tpu_dp_torch.train.step.cross_entropy_loss`. Unweighted: one launch
    forward and one backward (`_MeanSoftmaxXent`); weighted: the
    per-example kernel and torch ops."""
    if weight is None:
        return _MeanSoftmaxXent.apply(logits, labels)
    per_example = softmax_xent(logits, labels)
    return (per_example * weight).sum() / weight.sum().clamp(min=1.0)
