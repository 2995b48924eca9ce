"""One rank of the port's data-parallel parity runs (tests/test_torch_ddp.py).

    python tests/torch_ddp_worker.py SPEC.json

Imports only the port, never JAX (tests/conftest.py imports JAX into every
pytest process, so the ranks run as plain subprocesses). SPEC holds
``rank``, ``world``, ``init`` (a ``file://`` rendezvous), ``variables``
(a pickle of JAX-layout numpy variables), ``batches`` (an ``.npz`` of the
GLOBAL batches, ``images [steps, W*B, 32, 32, 3]`` uint8 and ``labels``),
``fused``, ``schedule``, ``num_filters``, ``out`` (a pickle path) and
``mutate``: with it, sync-BN's backward skips the cross-rank reduce of the
cotangent (a deliberate fault the tests must be able to see). The rank
trains on rows ``[rank*B, (rank+1)*B)`` of each global batch through the
port's DDP step and writes its per-step global metrics, the collective
books and its final state dict.
"""

from __future__ import annotations

import json
import pickle
import sys

import numpy as np
import torch


def main(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
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
            build_model("resnet18", num_filters=spec["num_filters"],
                        process_group=ctx.process_group, **kw), variables)
        ddp = data_parallel(model, ctx)
        opt = make_sgd(model, momentum=0.9, weight_decay=5e-4)
        step = make_train_step(ddp, opt, make_schedule(*spec["schedule"]),
                               use_pallas_xent=spec["fused"], device="cpu",
                               process_group=ctx.process_group)
        state = TrainState(step=0, model=model, optimizer=opt)
        data = np.load(spec["batches"])
        b = data["images"].shape[1] // ctx.world
        rows = slice(ctx.rank * b, (ctx.rank + 1) * b)
        metrics, books = [], []
        for images, labels in zip(data["images"], data["labels"]):
            collectives.reset_counts()
            m = step(state, {"image": torch.from_numpy(images[rows]),
                             "label": torch.from_numpy(labels[rows]).long()})
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
