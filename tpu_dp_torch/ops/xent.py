"""Fused softmax cross-entropy: the Hopper kernels, their plain PyTorch
versions and the autograd rule (port of `tpu_dp.ops.xent`).

`softmax_xent(logits, labels)` is the per-example loss ``(B,)`` in f32 —
``logsumexp(logits) - logits[label]`` per row — and differentiable in the
logits: the backward is ``(softmax - onehot) * ct`` in the logits' dtype.
Both directions are hand-written CUDA C++ kernels for ``sm_90a``
(`csrc/xent.cu`, built with nvcc at first use and bound with ctypes),
replacing the TPU kernels `_fwd_kernel` and `_bwd_kernel` in
``tpu_dp/ops/xent.py``. The source states their bound and design.
`mean_softmax_xent` is the (weighted) mean over the batch in plain torch,
as in the JAX package.

Dispatch is by where the tensor lies: CPU tensors go to the plain versions
`_plain_fwd` / `_plain_bwd` (the ports of `_jnp_fwd` / `_jnp_bwd`), CUDA
tensors launch the kernels or raise — no fallback. Labels are int64 or
int32. The one-hot compares class indices, as the TPU kernels do, so a
label outside ``[0, C)`` matches no class on both routes: its loss is the
row's logsumexp and its gradient ``softmax * ct`` (no range check on the
host, which would stall every step on a device-to-host copy).

``launches`` counts kernel launches by direction (CUDA only).
"""

from __future__ import annotations

import ctypes

import torch

#: kernel launches since import or the last `reset_launches` (CUDA only).
launches = {"forward": 0, "backward": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_DTYPES = {torch.int32: 0, torch.int64: 1}
_fns = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
        fwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        bwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
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


def _fwd(logits, labels):
    _check(logits, labels)
    if logits.device.type == "cpu":
        return _plain_fwd(logits, labels)
    logits, labels = logits.contiguous(), labels.contiguous()
    b, c = logits.shape
    loss = torch.empty(b, dtype=torch.float32, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    with torch.cuda.device(logits.device):
        rc = _kernels()[0](_DTYPES[logits.dtype], _LABEL_DTYPES[labels.dtype],
                           logits.data_ptr(), labels.data_ptr(),
                           loss.data_ptr(), b, c, stream)
    if rc != 0:
        raise RuntimeError(f"xent forward kernel launch failed: error {rc}")
    launches["forward"] += 1
    return loss


def _bwd(logits, labels, ct):
    _check(logits, labels)
    if ct.device != logits.device or tuple(ct.shape) != (logits.shape[0],):
        raise ValueError(f"ct must be ({logits.shape[0]},) on "
                         f"{logits.device}, got {tuple(ct.shape)} on "
                         f"{ct.device}")
    if logits.device.type == "cpu":
        return _plain_bwd(logits, labels, ct)
    logits, labels = logits.contiguous(), labels.contiguous()
    ct = ct.to(torch.float32).contiguous()
    b, c = logits.shape
    d = torch.empty_like(logits)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    with torch.cuda.device(logits.device):
        rc = _kernels()[1](_DTYPES[logits.dtype], _LABEL_DTYPES[labels.dtype],
                           logits.data_ptr(), labels.data_ptr(),
                           ct.data_ptr(), d.data_ptr(), b, c, stream)
    if rc != 0:
        raise RuntimeError(f"xent backward kernel launch failed: error {rc}")
    launches["backward"] += 1
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


def mean_softmax_xent(logits, labels, weight=None):
    """(Weighted) mean loss over the fused kernel — drop-in for
    `tpu_dp_torch.train.step.cross_entropy_loss`."""
    per_example = softmax_xent(logits, labels)
    if weight is None:
        return per_example.mean()
    return (per_example * weight).sum() / weight.sum().clamp(min=1.0)
