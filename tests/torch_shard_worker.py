"""One rank of the sharded-update parity runs
(tests/test_torch_shard_update.py).

    python tests/torch_shard_worker.py SPEC.json

Imports only the port, never JAX (the ranks run as plain subprocesses of
a pytest process that holds JAX). SPEC holds ``rank``, ``world``,
``init`` (a ``file://`` rendezvous), ``out`` (a pickle path), ``inputs``
(a pickle of the test's numpy inputs: ``net`` and ``resnet18`` JAX-layout
variables, ``net_batches`` f32 ``[steps, 16, 32, 32, 3]`` with labels,
``resnet18_batches`` uint8 with labels) and ``cases``, a list of
``{"name": ..., ...}`` run in order inside the one gloo group; the output
maps each case's ``label`` (its name by default) to what it recorded
(`CASES`).
"""

from __future__ import annotations

import json
import pickle
import sys

import numpy as np
import torch


def _model(name, variables, group=None):
    from tpu_dp_torch.compat import load_jax_variables
    from tpu_dp_torch.models import build_model

    kw = ({} if name == "net" else
          dict(num_classes=10, num_filters=8, process_group=group))
    return load_jax_variables(build_model(name, **kw), variables)


def _state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _rows(ctx, batches, i, a=1):
    """This rank's rows of global batch ``i`` (``a`` microbatches)."""
    images, labels = batches
    if a > 1:
        images = images[a * i:a * (i + 1)]
        labels = labels[a * i:a * (i + 1)]
    else:
        images, labels = images[i], labels[i]
    b = labels.shape[-1] // ctx.world
    rows = slice(ctx.rank * b, (ctx.rank + 1) * b)
    return {"image": torch.from_numpy(np.ascontiguousarray(
        images[..., rows, :, :, :])),
        "label": torch.from_numpy(np.ascontiguousarray(
            labels[..., rows])).long()}


def _trainer_run(ctx, inputs, model_name, wire="", bucket_mb=0.0, steps=6,
                 lr=("constant", 0.05, 100, 0, 0.0), replicated=False,
                 error_feedback=True, block=256, accum=1, window=1,
                 weight_decay=0.0):
    """``steps`` updates of ``model_name`` from the test's variables on
    this rank's rows: the sharded update with ``wire`` (or DDP's replicated
    one); per-update losses, the final state, the sharded state
    (`ShardedUpdate.gather_state`) and the step's books."""
    from tpu_dp_torch.parallel import bucketing, collectives, quant
    from tpu_dp_torch.train.optim import make_sgd, shard_optimizer
    from tpu_dp_torch.train.schedule import make_schedule
    from tpu_dp_torch.train.step import (
        TrainState,
        data_parallel,
        make_multi_step,
        make_train_step,
    )

    group = ctx.process_group
    model = _model(model_name, inputs[model_name], group)
    if replicated:
        opt = make_sgd(model, 0.9, weight_decay)
        runs = data_parallel(model, ctx) if ctx.world > 1 else model
    else:
        opt = shard_optimizer(
            model, ctx.world, ctx.rank,
            torch.distributed.group.WORLD, 0.9, weight_decay, False,
            quant.make_wire_codec(wire, block, error_feedback),
            bucketing.parse_bucket_mb(bucket_mb))
        runs = model
    step = make_train_step(runs, opt, make_schedule(*lr), device="cpu",
                           process_group=group, accum_steps=accum)
    state = TrainState(step=0, model=model, optimizer=opt)
    batches = inputs[f"{model_name}_batches"]
    losses, books, metrics = [], [], []
    multi = make_multi_step(step, window) if window > 1 else None
    for i in range(0, steps, window):
        collectives.reset_counts()
        if multi is None:
            m = step(state, _rows(ctx, batches, i, accum))
            vals = [m]
        else:
            pool = [_rows(ctx, batches, i + j, accum) for j in range(window)]
            m = multi(state, {k: torch.stack([p[k] for p in pool])
                              for k in ("image", "label")})
            vals = [{k: v[j] for k, v in m.items() if k in
                     step.metric_names} for j in range(window)]
        books.append(dict(collectives.counts))
        for v in vals:
            losses.append(float(v["loss"]))
            metrics.append({k: int(v[k]) for k in v
                            if k.startswith("quant_")})
    out = {"losses": losses, "state": _state(model), "books": books,
           "metrics": metrics}
    if not replicated:
        mom, res = opt.gather_state()
        out["opt_state"] = {k: v.numpy().copy() for k, v in mom.items()}
        out["residuals"] = {k: v.numpy().copy() for k, v in res.items()}
        out["momentum_bytes"] = opt.momentum_shard.numel() * 4
    return out


def case_exchange(ctx, inputs, spec):
    """The reduce hook alone on `Net` under int8 (``block``, unbucketed and
    at ``bucket_mb``): seeded per-rank gradients and residuals in, this
    rank's gradient shard per leaf and the residuals out."""
    from tpu_dp_torch.compat import export_params
    from tpu_dp_torch.parallel import bucketing, quant
    from tpu_dp_torch.train.optim import shard_optimizer
    from tpu_dp_torch.train.step import _sharded_reduce

    out = {}
    for bucket_mb in (0.0, spec["bucket_mb"]):
        model = _model("net", inputs["net"])
        codec = quant.make_wire_codec("int8", spec["block"])
        opt = shard_optimizer(model, ctx.world, ctx.rank,
                              torch.distributed.group.WORLD, 0.9,
                              codec=codec,
                              bucket_bytes=bucketing.parse_bucket_mb(
                                  bucket_mb))
        gen = torch.Generator().manual_seed(1000 + ctx.rank)
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        for rows in opt.residual_rows.values():
            rows.copy_(1e-2 * torch.randn(rows.shape, generator=gen))
        _, before = opt.gather_state()
        grad, stats = _sharded_reduce(opt)
        _, after = opt.gather_state()
        out[bucket_mb] = {
            "grads": {k: np.asarray(v).reshape(-1).copy() for k, v in
                      _flat_tree(export_params(
                          {n: p.grad for n, p in
                           model.named_parameters()})).items()},
            "shards": {k: grad[s:s + c].numpy().copy()
                       for k, (s, c) in opt.shard_of.items()},
            "before": {k: v.numpy().copy() for k, v in before.items()},
            "after": {k: v.numpy().copy() for k, v in after.items()},
            "stats": [int(v) for v in stats],
            "exchanges": len(opt.exchanges),
        }
    return out


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat_tree(v, key) if isinstance(v, dict) else {key: v})
    return out


def case_trainer(ctx, inputs, spec):
    """The port's `Trainer` on CLI ``args`` in this group."""
    from torch_ddp_worker import run_trainer

    return run_trainer(spec["args"])


def case_wire(ctx, inputs, spec):
    """`Net`, 6 updates at constant lr 0.05, momentum 0.9: every wire of
    ``spec["wires"]`` (``[wire, bucket_mb]``) sharded, and DDP's
    replicated update."""
    out = {"replicated": _trainer_run(ctx, inputs, "net", replicated=True)}
    for wire, bucket_mb in spec["wires"]:
        out[(wire, bucket_mb)] = _trainer_run(ctx, inputs, "net", wire,
                                              bucket_mb)
    return out


def case_ablation(ctx, inputs, spec):
    """24 updates of `Net` at lr 0.01 on the f32 sharded update; each
    update's gradients also go through the int8 exchange with error
    feedback and without it (each with its own residuals), and this
    rank's drift of the summed int8 gradient shards from the summed f32
    ones is recorded per leaf (the applied update's drift, whatever the
    trajectory does)."""
    from tpu_dp_torch.parallel import quant
    from tpu_dp_torch.train.optim import shard_optimizer
    from tpu_dp_torch.train.step import _sharded_reduce, cross_entropy_loss

    group = torch.distributed.group.WORLD
    model = _model("net", inputs["net"])
    opts = {name: shard_optimizer(model, ctx.world, ctx.rank, group, 0.9,
                                  codec=codec)
            for name, codec in (
                ("f32", None),
                ("ef", quant.make_wire_codec("int8")),
                ("no_ef", quant.make_wire_codec("int8",
                                                error_feedback=False)))}
    drift = {name: {} for name in ("ef", "no_ef")}
    lr = torch.tensor(0.01)
    for i in range(24):
        batch = _rows(ctx, inputs["net_batches"], i)
        model.zero_grad(set_to_none=True)
        cross_entropy_loss(model(batch["image"]), batch["label"]).backward()
        shards = {name: _sharded_reduce(opt)[0]
                  for name, opt in opts.items()}
        for name in drift:
            for k, (s, c) in opts[name].shard_of.items():
                f, (s0, _) = shards["f32"], opts["f32"].shard_of[k]
                d = shards[name][s:s + c] - f[s0:s0 + c]
                drift[name][k] = drift[name].get(k, 0) + d
        opts["f32"].update(shards["f32"], lr)
    return {name: {k: v.numpy().copy() for k, v in d.items()}
            for name, d in drift.items()} | {
        "residuals": {name: {k: v.clone().numpy() for k, v in
                             opts[name].residuals.items()}
                      for name in drift}}


def case_windows(ctx, inputs, spec):
    """int8 bucketed: 6 single updates against windows of 3; the same with
    2 microbatches an update; f32 with 2 microbatches sharded against
    DDP's replicated update."""
    kw = dict(wire="int8", bucket_mb=spec["bucket_mb"], block=64)
    return {
        "single": _trainer_run(ctx, inputs, "net", **kw),
        "windowed": _trainer_run(ctx, inputs, "net", window=3, **kw),
        "accum_single": _trainer_run(ctx, inputs, "net", steps=3, accum=2,
                                     **kw),
        "accum_windowed": _trainer_run(ctx, inputs, "net", steps=3, accum=2,
                                       window=3, **kw),
        "accum_f32": _trainer_run(ctx, inputs, "net", steps=3, accum=2),
        "accum_replicated": _trainer_run(ctx, inputs, "net", steps=3,
                                         accum=2, replicated=True),
    }


def case_syncbn(ctx, inputs, spec):
    """ResNet-18 (narrow, sync-BN over the group), 3 updates with weight
    decay: sharded f32 and int8 against DDP's replicated update."""
    lr = ("cosine", 0.1, 10, 1, 0.0)
    kw = dict(steps=3, lr=lr, weight_decay=5e-4)
    return {"replicated": _trainer_run(ctx, inputs, "resnet18",
                                       replicated=True, **kw),
            "sharded": _trainer_run(ctx, inputs, "resnet18", **kw),
            "int8": _trainer_run(ctx, inputs, "resnet18", "int8", **kw)}


def case_save(ctx, inputs, spec):
    """`Net` sharded int8 (block 64), 2 updates, then a save into
    ``spec["dir"]`` (every rank calls it; rank 0 writes): the sharded
    state gathered."""
    from tpu_dp_torch.checkpoint import save_checkpoint
    from tpu_dp_torch.parallel import quant
    from tpu_dp_torch.train.optim import shard_optimizer
    from tpu_dp_torch.train.schedule import make_schedule
    from tpu_dp_torch.train.step import TrainState, make_train_step

    model = _model("net", inputs["net"])
    opt = shard_optimizer(model, ctx.world, ctx.rank,
                          torch.distributed.group.WORLD, 0.9,
                          codec=quant.make_wire_codec("int8", 64))
    step = make_train_step(model, opt, make_schedule("constant", 0.05, 10, 0,
                                                     0.0), device="cpu",
                           process_group=ctx.process_group)
    state = TrainState(step=0, model=model, optimizer=opt)
    for i in range(2):
        step(state, _rows(ctx, inputs["net_batches"], i))
    save_checkpoint(spec["dir"], state, {"epoch": 0})
    mom, res = opt.gather_state()
    return {"opt_state": {k: v.numpy().copy() for k, v in mom.items()},
            "residuals": {k: v.numpy().copy() for k, v in res.items()},
            "params": _state(model)}


def case_load(ctx, inputs, spec):
    """A save (``spec["dir"]``) loaded into `Net` sharded at this world
    under int8 (``spec["block"]``, ``spec["bucket_mb"]``): the sharded
    state gathered."""
    from tpu_dp_torch.checkpoint import load_checkpoint
    from tpu_dp_torch.parallel import bucketing, quant
    from tpu_dp_torch.train.optim import shard_optimizer
    from tpu_dp_torch.train.step import TrainState

    model = _model("net", inputs["net"])
    opt = shard_optimizer(model, ctx.world, ctx.rank,
                          torch.distributed.group.WORLD, 0.9,
                          codec=quant.make_wire_codec("int8", spec["block"]),
                          bucket_bytes=bucketing.parse_bucket_mb(
                              spec.get("bucket_mb", 0.0)))
    state = TrainState(step=0, model=model, optimizer=opt)
    load_checkpoint(spec["dir"], state)
    mom, res = opt.gather_state()
    return {"opt_state": {k: v.numpy().copy() for k, v in mom.items()},
            "residuals": {k: v.numpy().copy() for k, v in res.items()},
            "step": state.step}


CASES = {"exchange": case_exchange, "trainer": case_trainer,
         "wire": case_wire, "ablation": case_ablation,
         "windows": case_windows, "syncbn": case_syncbn, "save": case_save,
         "load": case_load}


def main(spec_path: str) -> int:
    from tpu_dp_torch.parallel.dist import initialize, shutdown

    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    with open(spec["inputs"], "rb") as f:
        inputs = pickle.load(f)
    ctx = initialize(backend="gloo", init_method=spec["init"],
                     world_size=spec["world"], rank=spec["rank"],
                     device="cpu", timeout_s=120)
    out = {}
    try:
        for case in spec["cases"]:
            out[case.get("label", case["name"])] = CASES[case["name"]](
                ctx, inputs, case)
    finally:
        shutdown()
    with open(spec["out"], "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
