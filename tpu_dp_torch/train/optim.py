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

import numpy as np
import torch
import torch.distributed as dist

from tpu_dp_torch.compat import param_leaves
from tpu_dp_torch.models.resnet import BatchNorm
from tpu_dp_torch.parallel import collectives, quant


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


class ShardedUpdate:
    """The cross-replica sharded weight update of ``model`` (port of
    `tpu_dp.train.optim.ShardedUpdate`, Xu et al.): each of ``world``
    ranks keeps 1/world of the momentum and updates 1/world of every
    parameter; `tpu_dp_torch.train.step`'s reduce hook hands it the
    reduce-scattered gradient shard and `update` slices this rank's
    parameter shard, runs `SGD`'s rule on it op for op, all-gathers the
    updated parameters and writes them back into the model in place (the
    conv kernel's packed-weight cache and a captured CUDA graph keep the
    same storage).

    Layout (the JAX package's, so a shard crosses to and from its
    checkpoints): every leaf is flattened in the JAX leaf's element order
    (`tpu_dp_torch.compat.param_leaves`: HWIO for convs, ``(in, out)``
    for Dense), zero-padded to a multiple of the world, and rank r owns
    elements ``[r*pchunk, (r+1)*pchunk)``. The gradient exchanges are
    `collectives.exchange_plan`'s for ``codec`` and ``bucket_bytes``; this
    rank's shard of every leaf lies in one flat buffer of Σ `shard_size`
    elements, exchange by exchange (the momentum: ``momentum_shard``,
    about 1/world of the replicated buffers). The gathers from the model's
    tensors into that layout and back are precomputed index maps, one
    ``index_select`` each way. Under int8 the error-feedback residuals are
    one ``[world, chunk]`` buffer per quantizing exchange (``residual_rows``;
    `residuals` views them per key).

    ``group`` is the process group of the exchange (None: one process, the
    collectives are identities); its parameters and buffers are broadcast
    from rank 0 here, as DDP's constructor does.
    """

    is_sharded_update = True

    def __init__(self, model: torch.nn.Module, world: int = 1, rank: int = 0,
                 group=None, momentum: float = 0.9,
                 weight_decay: float = 0.0,
                 decay_exclude_bias_and_norm: bool = False, codec=None,
                 bucket_bytes: int = 0):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if group is None and world != 1:
            raise ValueError(f"world {world} needs a process group")
        self.world, self.rank, self.group = int(world), int(rank), group
        self.momentum, self.weight_decay = float(momentum), float(
            weight_decay)
        self.codec = codec
        self.int8 = isinstance(codec, quant.Int8BlockCodec)
        named = dict(model.named_parameters())
        layout = param_leaves(named)
        self.keys = [k for k, _, _ in layout]
        self.params = [named[name] for _, name, _ in layout]
        self.sizes = [p.numel() for p in self.params]
        self.leaves = list(zip(self.keys, self.sizes))
        skip = (_no_decay(model) if weight_decay and
                decay_exclude_bias_and_norm else set())
        decay = [id(p) not in skip for p in self.params]
        self.exchanges = collectives.exchange_plan(
            self.leaves, self.world, codec=codec, bucket_bytes=bucket_bytes)
        dev = self.params[0].device
        w = self.world
        # Leaf l's elements start at src_off[l] of the concatenation of
        # the model's tensors in JAX leaf order; `zero` is the appended 0.
        src_off = np.concatenate([[0], np.cumsum(self.sizes)])
        zero = int(src_off[-1])
        src_of = {k: src_off[i] + ix.numpy()
                  for i, (k, _, ix) in enumerate(layout)}
        pos = {k: i for i, k in enumerate(self.keys)}
        #: this rank's shard of leaf key: [soff, soff + pchunk) of the
        #: flat shard buffer, in exchange order.
        self.shard_of: dict[str, tuple[int, int]] = {}
        wire, keep = [], []
        at = 0
        for ex in self.exchanges:
            idx = np.full((w, ex.chunk), zero, np.int64)
            kept, col = [], 0
            for seg in ex.segments:
                a = 0
                for key, n in zip(seg.keys, seg.sizes):
                    pchunk = collectives.shard_size(n, w)
                    js = np.arange(w * pchunk).reshape(w, pchunk)
                    idx[:, col + a:col + a + pchunk] = np.where(
                        js < n, src_of[key][np.minimum(js, n - 1)], zero)
                    self.shard_of[key] = (at, pchunk)
                    at += pchunk
                    a += pchunk
                kept.append(np.arange(col, col + a))
                col += seg.cpad
            wire.append(torch.from_numpy(idx.reshape(-1)).to(dev))
            keep.append(torch.from_numpy(np.concatenate(kept)).to(dev)
                        if ex.quantizes else None)
        self._wire_index, self._keep_index = wire, keep
        pidx = np.full(at, zero, np.int64)
        back = np.empty(zero, np.int64)
        for key, (soff, pchunk) in self.shard_of.items():
            n = self.sizes[pos[key]]
            js = self.rank * pchunk + np.arange(pchunk)
            pidx[soff:soff + pchunk] = np.where(
                js < n, src_of[key][np.minimum(js, n - 1)], zero)
            j = np.arange(n)
            back[src_of[key]] = (j // pchunk) * at + soff + j % pchunk
        self._param_index = torch.from_numpy(pidx).to(dev)
        self._back_index = torch.from_numpy(back).to(dev)
        self._zero = torch.zeros(1, device=dev)
        #: the shard-order position of each leaf, split by decay class.
        ranked = sorted(range(len(self.keys)),
                        key=lambda i: self.shard_of[self.keys[i]][0])
        self._shard_sizes = [self.shard_of[self.keys[i]][1] for i in ranked]
        self._groups = [
            (self.weight_decay if d else 0.0,
             [s for s, i in enumerate(ranked) if decay[i] == d])
            for d in (True, False) if any(decay[i] == d for i in ranked)]
        self.momentum_shard = (torch.zeros(at, device=dev)
                               if self.momentum else None)
        self.residual_rows = {g: torch.zeros(w, ex.chunk, device=dev)
                              for g, ex in enumerate(self.exchanges)
                              if ex.quantizes}
        #: the global ``(opt_state, residuals)`` of the last restore
        #: (`tpu_dp_torch.checkpoint`), which a resume broadcasts.
        self.restored: tuple[dict, dict] | None = None
        if group is not None and w > 1:
            _broadcast_module(model, group)

    @property
    def residuals(self) -> dict[str, torch.Tensor]:
        """This rank's residual row of each quantizing segment, by key, as
        ``[world, cpad]`` views of `residual_rows` (row-major it is the
        JAX package's ``[qpad]`` row)."""
        out = {}
        for g, rows in self.residual_rows.items():
            col = 0
            for seg in self.exchanges[g].segments:
                out[seg.key] = rows[:, col:col + seg.cpad]
                col += seg.cpad
        return out

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    def wire_rows(self, flat: torch.Tensor, g: int) -> torch.Tensor:
        """Exchange ``g``'s ``[world, chunk]`` wire rows of the leaf-order
        concatenation ``flat`` (`flat_grads`)."""
        return flat.index_select(0, self._wire_index[g]).view(
            self.world, self.exchanges[g].chunk)

    def compact(self, shard: torch.Tensor, g: int) -> torch.Tensor:
        """Exchange ``g``'s reduced chunk without its block padding: this
        rank's shard of its leaves, as `update` takes them."""
        keep = self._keep_index[g]
        return shard if keep is None else shard.index_select(0, keep)

    def flat_grads(self) -> torch.Tensor:
        """The parameters' gradients concatenated in JAX leaf order (each
        in its torch layout), with the 0 that pads the wire appended."""
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("the sharded update needs a gradient for "
                               "every parameter")
        return torch.cat([g.reshape(-1) for g in grads] + [self._zero])

    @torch.no_grad()
    def update(self, grad_shard: torch.Tensor, lr: torch.Tensor) -> None:
        """`SGD.step`'s rule on this rank's shards at ``lr`` (a 0-dim
        device tensor), then the all-gather and the write-back."""
        src = torch.cat([p.detach().reshape(-1) for p in self.params]
                        + [self._zero])
        pshard = src.index_select(0, self._param_index)
        g = grad_shard.split(self._shard_sizes)
        p = pshard.split(self._shard_sizes)
        m = (self.momentum_shard.split(self._shard_sizes)
             if self.momentum else None)
        for wd, members in self._groups:
            params = [p[i] for i in members]
            d = [g[i] for i in members]
            if wd:
                d = torch._foreach_add(d, params, alpha=wd)
            if self.momentum:
                bufs = [m[i] for i in members]
                torch._foreach_mul_(bufs, self.momentum)
                torch._foreach_add_(bufs, d)
                d = bufs
            torch._foreach_sub_(params, torch._foreach_mul(d, lr))
        full = collectives.all_gather(pshard, self.group, self.world)
        new = full.index_select(0, self._back_index)
        torch._foreach_copy_(self.params, [
            v.view_as(q) for v, q in zip(new.split(self.sizes), self.params)])

    # -- checkpoints: the JAX package's global layout ------------------------

    def gather_state(self) -> tuple[dict, dict]:
        """``(opt_state, residuals)`` in the JAX package's global layout,
        on every rank (a collective): each momentum leaf flat of
        ``padded_size(n, world)`` in the JAX leaf's element order, each
        residual ``[world, qpad]`` (row r = rank r's)."""
        w = self.world
        opt = {}
        if self.momentum:
            mom = collectives.all_gather(self.momentum_shard, self.group, w,
                                         book=False).view(w, -1)
            opt = {k: mom[:, s:s + c].reshape(-1)
                   for k, (s, c) in self.shard_of.items()}
        res = {}
        for g, rows in self.residual_rows.items():
            every = collectives.all_gather(rows.reshape(-1), self.group, w,
                                           book=False).view(w, w, -1)
            col = 0
            for seg in self.exchanges[g].segments:
                res[seg.key] = every[:, :, col:col + seg.cpad].reshape(w, -1)
                col += seg.cpad
        return opt, res

    @torch.no_grad()
    def load_state(self, opt: dict, residuals: dict) -> None:
        """Take this rank's slice of a global ``(opt_state, residuals)``
        (`gather_state`'s layout for this world: momentum leaves of at
        least ``padded_size(n, world)``, zeros past the true elements;
        residuals ``[world, qpad]`` for every key of `residuals`)."""
        if self.momentum:
            for k, (s, c) in self.shard_of.items():
                flat = torch.tensor(np.asarray(opt[k])).reshape(-1)
                self.momentum_shard[s:s + c].copy_(
                    flat[self.rank * c:(self.rank + 1) * c])
        for k, view in self.residuals.items():
            row = np.asarray(residuals[k])[self.rank]
            view.copy_(torch.tensor(row).view_as(view))


def _broadcast_module(model: torch.nn.Module, group) -> None:
    """Rank 0's parameters and buffers on every rank, one broadcast per
    dtype (what DDP's constructor does)."""
    by_dtype: dict = {}
    for t in model.state_dict().values():
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src=0, group=group)
            torch._foreach_copy_(ts, [v.view_as(t) for v, t in zip(
                flat.split([t.numel() for t in ts]), ts)])


def shard_optimizer(model: torch.nn.Module, world: int = 1, rank: int = 0,
                    group=None, momentum: float = 0.9,
                    weight_decay: float = 0.0,
                    decay_exclude_bias_and_norm: bool = False, codec=None,
                    bucket_bytes: int = 0) -> ShardedUpdate:
    """`ShardedUpdate` of ``model`` (the JAX package's `shard_optimizer`
    over its `SGD`). World 1 is the same code path with identity
    collectives: one layout everywhere, so a sharded checkpoint written
    under one world restores under any other."""
    return ShardedUpdate(model, world, rank, group, momentum, weight_decay,
                         decay_exclude_bias_and_norm, codec, bucket_bytes)
