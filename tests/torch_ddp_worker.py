"""One rank of the port's data-parallel parity runs (tests/test_torch_ddp.py,
tests/test_torch_checkpoint.py, tests/test_torch_net.py).

    python tests/torch_ddp_worker.py SPEC.json

Imports only the port, never JAX (tests/conftest.py imports JAX into every
pytest process, so the ranks run as plain subprocesses). SPEC holds
``rank``, ``world``, ``init`` (a ``file://`` rendezvous), ``variables``
(a pickle of JAX-layout numpy variables), ``batches`` (an ``.npz`` of the
GLOBAL batches, ``images [steps, W*B, 32, 32, 3]`` uint8 and ``labels``),
``fused``, ``schedule``, ``num_filters``, ``model`` (optional, default
``resnet18``; ``num_classes`` with it), ``out`` (a pickle path),
``accum_steps`` (optional; the batches are then ``[steps, a, W*B, ...]``)
and ``mutate``: with it, sync-BN's backward skips the cross-rank reduce
of the cotangent (a deliberate fault the tests must be able to see). The
rank trains on rows ``[rank*B, (rank+1)*B)`` of each global (micro)batch
through the port's DDP step and writes its per-step global metrics, the
collective books and its final state dict.

With ``"job": "trainer"`` the rank instead runs the port's `Trainer` on
the CLI arguments ``args`` (`run_trainer`), and with ``"job": "eval"`` it
evaluates a fresh `Trainer` once per test-set size of ``sizes``
(`run_evals`); ``rank_args`` (``{rank: [...]}``) appends arguments for
one rank.
"""

from __future__ import annotations

import json
import pickle
import sys

import numpy as np
import torch


class _Stop(Exception):
    """The simulated interruption of `run_trainer`."""


def flat_state(trainer) -> dict:
    """The trainer's state as the checkpoint's flax tree, flattened to
    ``{"/"-path: numpy array}``."""
    from tpu_dp_torch.checkpoint import _walk_state_dict, state_dict_of

    return dict(_walk_state_dict(state_dict_of(trainer.state)))


def run_trainer(args, init=None, world=None, rank=None, stop_at_step=None,
                snapshot=False) -> dict:
    """The port's `Trainer` on CLI ``args`` (in a group when ``init`` is
    given). ``stop_at_step``: the run is interrupted just before that
    global step, after the pending epoch save is written; with
    ``snapshot`` a snapshot-kind save of that position (the JAX package's
    meta keys) goes to the trainer's snapshot root. Returns the state right
    after construction (after any resume), the start position, the
    per-step losses, the final state and the eval."""
    from tpu_dp_torch.checkpoint import CheckpointManager
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer

    cfg = parse_cli(args)
    if init is not None:
        cfg.parallel.coordinator_address = init
        cfg.parallel.num_processes, cfg.parallel.process_id = world, rank
    trainer = Trainer(cfg, device="cpu")
    out = {"restored": flat_state(trainer), "resumed_from":
           trainer.resumed_from,
           "start": (trainer.start_epoch, trainer.start_step)}
    if stop_at_step is not None:
        real = trainer.train_step

        def step(state, batch):
            if state.step == stop_at_step:
                raise _Stop
            return real(state, batch)

        trainer.train_step = step
    result = None
    try:
        result = trainer.fit()
    except _Stop:
        trainer.ckpt_mgr.wait()
        if snapshot:
            spe = len(trainer.train_pipe)
            meta = {"kind": "snapshot", "epoch": stop_at_step // spe,
                    "steps_done": stop_at_step % spe,
                    "config": cfg.to_dict(), "seed": cfg.train.seed}
            CheckpointManager(trainer.snapshot_dir, async_save=False).save(
                trainer.state, meta)
    out.update(losses=list(trainer.step_losses), final=flat_state(trainer),
               eval=None if result is None else result.get("eval"),
               spe=len(trainer.train_pipe))
    return out


def run_evals(args, sizes, init=None, world=None, rank=None) -> list:
    """``evaluate()`` of a fresh `Trainer` for each test-set size."""
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer

    out = []
    for n in sizes:
        cfg = parse_cli(args + [f"--data.synthetic_test_size={n}"])
        if init is not None:
            cfg.parallel.coordinator_address = init
            cfg.parallel.num_processes, cfg.parallel.process_id = world, rank
        out.append(Trainer(cfg, device="cpu").evaluate())
    return out


def main(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    if spec.get("job") in ("trainer", "eval"):
        from tpu_dp_torch.parallel.dist import shutdown

        group = dict(init=spec["init"], world=spec["world"],
                     rank=spec["rank"])
        args = spec["args"] + spec.get("rank_args", {}).get(
            str(spec["rank"]), [])
        try:
            if spec["job"] == "trainer":
                out = run_trainer(args, **group,
                                  stop_at_step=spec.get("stop_at_step"),
                                  snapshot=spec.get("snapshot", False))
            else:
                out = run_evals(args, spec["sizes"], **group)
        finally:
            shutdown()
        with open(spec["out"], "wb") as f:
            pickle.dump(out, f)
        return 0
    from tpu_dp_torch.compat import load_jax_variables
    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.parallel import collectives
    from tpu_dp_torch.parallel.dist import initialize, shutdown
    from tpu_dp_torch.train.optim import make_sgd
    from tpu_dp_torch.train.schedule import make_schedule
    from tpu_dp_torch.train.step import (
        TrainState,
        data_parallel,
        make_train_step,
    )

    if spec.get("mutate"):
        collectives._PMean.backward = staticmethod(lambda ctx, ct: (ct, None))
    ctx = initialize(backend="gloo", init_method=spec["init"],
                     world_size=spec["world"], rank=spec["rank"],
                     device="cpu", timeout_s=120)
    try:
        with open(spec["variables"], "rb") as f:
            variables = pickle.load(f)
        kw = (dict(fused_stages=(0, 1, 2, 3), fused_bwd=True)
              if spec["fused"] else {})
        model = load_jax_variables(
            build_model(spec.get("model", "resnet18"),
                        num_classes=spec.get("num_classes", 10),
                        num_filters=spec["num_filters"],
                        process_group=ctx.process_group, **kw), variables)
        ddp = data_parallel(model, ctx)
        opt = make_sgd(model, momentum=0.9, weight_decay=5e-4)
        step = make_train_step(ddp, opt, make_schedule(*spec["schedule"]),
                               use_pallas_xent=spec["fused"], device="cpu",
                               process_group=ctx.process_group,
                               accum_steps=spec.get("accum_steps", 1))
        state = TrainState(step=0, model=model, optimizer=opt)
        data = np.load(spec["batches"])
        b = data["labels"].shape[-1] // ctx.world
        rows = slice(ctx.rank * b, (ctx.rank + 1) * b)
        metrics, books = [], []
        for images, labels in zip(data["images"], data["labels"]):
            collectives.reset_counts()
            m = step(state, {
                "image": torch.from_numpy(images[..., rows, :, :, :]),
                "label": torch.from_numpy(labels[..., rows]).long()})
            metrics.append((float(m["loss"]), int(m["correct"]),
                            m["count"], m["lr"]))
            books.append(dict(collectives.counts))
        out = {
            "metrics": metrics, "books": books,
            "all_params_have_grads": all(
                p.grad is not None for p in model.parameters()),
            "state": {k: v.detach().numpy().copy()
                      for k, v in model.state_dict().items()},
        }
        with open(spec["out"], "wb") as f:
            pickle.dump(out, f)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
