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
the CLI arguments ``args`` (`run_trainer`); ``"job": "elastic"`` is the
same run, exiting 143 (after writing its output) when it ends in
`PreemptedError`, as the CLI does for an elastic leaver; with ``"job":
"eval"`` it
evaluates a fresh `Trainer` once per test-set size of ``sizes``
(`run_evals`); ``rank_args`` (``{rank: [...]}``) appends arguments for
one rank, and ``drop`` batches whose update never runs (`run_trainer`).
Two seams of the elastic rollback's tests (`run_trainer`): ``raise_at``
(``[rank, step]``) raises `PeerFailedError` on that rank just before its
update at that global step, every member still alive; with
``no_final_snapshot`` no snapshot commits at or past an adopted elastic
plan's stop step (the final snapshot is lost). An elastic rank runs
`run_elastic`, as the CLI does: after a fired ``relaunch:`` it rejoins
in-process, and its output is the rejoined incarnation's (``adopted``: a
joiner's model state right after it restored the admitting snapshot). A
spec without ``init`` is a process that forms no group of its own (a
joiner: ``--resilience.elastic_join=always --parallel.process_id=S``);
with ``await_ledger`` (a membership directory) it starts its `Trainer`
once a generation there has its epoch-0 record.
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


def _failing_at(trainer, step: int):
    """``trainer.train_step`` raising `PeerFailedError` before the update
    at global ``step``."""
    from tpu_dp_torch.resilience import PeerFailedError

    real = trainer.train_step

    def failing(state, batch):
        if trainer._host_step + 1 == step:
            raise PeerFailedError("injected failure, every member alive",
                                  rank=trainer.ctx.rank,
                                  world=trainer.ctx.world)
        return real(state, batch)

    return failing


def run_trainer(args, init=None, world=None, rank=None, stop_at_step=None,
                snapshot=False, drop=(), raise_at=None,
                no_final_snapshot=False) -> dict:
    """The port's `Trainer` on CLI ``args`` (in a group when ``init`` is
    given). ``stop_at_step``: the run is interrupted just before that
    global step, after the pending epoch save is written; with
    ``snapshot`` a snapshot-kind save of that position (the JAX package's
    meta keys) goes to the trainer's snapshot root. Returns the state right
    after construction (after any resume), the start position, the
    per-step losses, the final state and the eval. A run that ends in
    `PreemptedError` (``resilience.fault=preempt:...``) returns with
    ``preempted`` set to its message, one that ends in `DivergedError`
    (the guard's halt) with ``diverged`` set to its. ``drop``: indices,
    in feed order, of batches whose update is never run (the guard's
    never-saw-it oracle; one update a call): they count no loss and leave
    the state and the update counter alone. Also returned: the host's
    batch clock (``host_step``), the guard's counters and the issues rank
    0's health monitor reported (``train.obs`` on; dicts)."""
    import dataclasses

    from tpu_dp_torch.checkpoint import CheckpointManager
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.obs.counters import counters
    from tpu_dp_torch.resilience import DivergedError, PreemptedError
    from tpu_dp_torch.train.trainer import Trainer, run_elastic

    cfg = parse_cli(args)
    if init is not None:
        cfg.parallel.coordinator_address = init
        cfg.parallel.num_processes, cfg.parallel.process_id = world, rank
    adopted: dict = {}
    adopt = Trainer._adopt_join_resume

    def adopting(self, record):
        # A joiner's model state and step right after it restored the
        # admitting record's snapshot.
        adopt(self, record)
        adopted.update({k: v.detach().numpy().copy()
                        for k, v in self.model.state_dict().items()})
        adopted["step"] = int(self.state.step)

    Trainer._adopt_join_resume = adopting
    trainer = Trainer(cfg, device="cpu")
    out = {"restored": flat_state(trainer), "resumed_from":
           trainer.resumed_from,
           "start": (trainer.start_epoch, trainer.start_step),
           "health_issues": []}
    from tpu_dp_torch.obs.health import HealthMonitor

    real_report = HealthMonitor.report

    def report(self, issues):
        # Every monitor of the run (rank 0's, rebuilt at each regroup).
        out["health_issues"] += [dataclasses.asdict(i) for i in issues]
        return real_report(self, issues)

    HealthMonitor.report = report
    if stop_at_step is not None:
        real = trainer.train_step

        def step(state, batch):
            if state.step == stop_at_step:
                raise _Stop
            return real(state, batch)

        trainer.train_step = step
    if drop:
        real_step, seen = trainer.train_step, [0]

        def dropping(state, batch):
            seen[0] += 1
            if seen[0] - 1 in drop:
                zero = torch.zeros(())
                return {"loss": zero, "correct": zero.long(),
                        "count": trainer.step_body.count(batch["label"])}
            return real_step(state, batch)

        trainer.train_step = dropping
    if raise_at is not None and raise_at[0] == rank:
        trainer.train_step = _failing_at(trainer, raise_at[1])
    if no_final_snapshot:
        real_take = trainer._take_snapshot

        def take(epoch, steps_done, wait=False):
            # Nothing commits at or past an adopted plan's stop step.
            plan = trainer._quiesce_plan
            if plan is not None and trainer._host_step >= plan.stop_step:
                return False
            return real_take(epoch, steps_done, wait)

        trainer._take_snapshot = take
    result = None
    out["preempted"] = out["diverged"] = None
    try:
        if trainer.elastic is not None:
            # As the CLI runs it: a fired relaunch: rejoins in process.
            trainer, result = run_elastic(cfg, device="cpu",
                                          trainer=trainer)
        else:
            result = trainer.fit()
    except PreemptedError as e:
        out["preempted"] = str(e)
    except DivergedError as e:
        out["diverged"] = str(e)
    except _Stop:
        trainer.ckpt_mgr.wait()
        if snapshot:
            spe = len(trainer.train_pipe)
            meta = {"kind": "snapshot", "epoch": stop_at_step // spe,
                    "steps_done": stop_at_step % spe,
                    "config": cfg.to_dict(), "seed": cfg.train.seed}
            CheckpointManager(trainer.snapshot_dir, async_save=False).save(
                trainer.state, meta)
    # An elastic leaver is out of the group: under the sharded update its
    # state's gather would be a collective no survivor joins.
    departed = trainer.elastic is not None and out["preempted"] is not None
    out.update(losses=list(trainer.step_losses),
               final=None if departed else flat_state(trainer),
               eval=None if result is None else result.get("eval"),
               spe=len(trainer.train_pipe), host_step=trainer._host_step,
               step=trainer.state.step,
               counters={k: v for k, v in counters.snapshot().items()
                         if k.startswith(("guard.", "elastic."))},
               adopted=adopted or None)
    if trainer.elastic is not None:
        out.update(record=trainer.elastic.record.to_json(),
                   sid=trainer.stable_rank, new_rank=trainer.ctx.rank,
                   world=trainer.ctx.world)
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


def _await_ledger(root: str, deadline_s: float = 120.0) -> None:
    """Wait until a membership generation under ``root`` has its epoch-0
    record (a joiner relaunched into a run that is live)."""
    import glob
    import time

    deadline = time.monotonic() + deadline_s
    while not glob.glob(f"{root}/*/epoch_0000.json"):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no membership generation under {root}")
        time.sleep(0.05)


def main(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    if spec.get("job") in ("trainer", "elastic", "eval"):
        from tpu_dp_torch.parallel.dist import shutdown

        group = dict(init=spec.get("init"), world=spec.get("world"),
                     rank=spec.get("rank"))
        args = spec["args"] + spec.get("rank_args", {}).get(
            str(spec["rank"]), [])
        if spec.get("await_ledger"):
            _await_ledger(spec["await_ledger"])
        try:
            if spec["job"] != "eval":
                out = run_trainer(
                    args, **group, stop_at_step=spec.get("stop_at_step"),
                    snapshot=spec.get("snapshot", False),
                    drop=set(spec.get("drop", ())),
                    raise_at=spec.get("raise_at"),
                    no_final_snapshot=spec.get("no_final_snapshot", False))
            else:
                out = run_evals(args, spec["sizes"], **group)
        finally:
            shutdown()
        with open(spec["out"], "wb") as f:
            pickle.dump(out, f)
        if spec["job"] == "elastic" and out["preempted"]:
            from tpu_dp_torch.resilience import PreemptedError

            return PreemptedError.exit_code
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
