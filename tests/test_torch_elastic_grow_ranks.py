"""The port's elastic grow across three gloo ranks (the twin of
tests/test_multiprocess.py::test_three_process_elastic_grow_relaunch_rank2,
without the JAX package's fingerprint check): ``relaunch:step=2,rank=2``.

Rank 2 departs like ``leave:`` (the survivors shrink to world 2), then
rejoins in its own process through `run_elastic`: it finds the live
generation, publishes a fenced join request, the members run a grow
quiesce and everyone forms world 3 again. The checks: every rank exits 0;
the ledger tells 3 → 2 (graceful, sid 2 departed) → 3 (grow, ``joined``
echoing the token of rank 2's own request, ``service_sid`` 0); the
joiner's state right after its restore equals the grow snapshot's; all
three ranks end bit-identical (parameters, statistics, momentum), equal
within 2e-5 (the JAX package's bound) to a one-process oracle trained on
the global batches rebuilt from the records alone with the JAX package's
`ShardedSampler` and `elastic_resplit`; no sample runs twice in an epoch;
the counters tell both transitions. Under the sharded update (the
momentum resharded 3 → 2 → 3) with telemetry on, rank 0's health check
never marks the joiner missing or suspect after the grow. The ranks are
subprocesses (tests/torch_ddp_worker.py, ``"job": "elastic"``, which runs
`run_elastic` as the CLI does)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_elastic_ranks import _args, _finish, _start, _unflatten
from tpu_dp.data.sampler import ShardedSampler, elastic_resplit
from tpu_dp_torch import checkpoint as ck
from tpu_dp_torch.config import parse_cli
from tpu_dp_torch.data.cifar import load_dataset
from tpu_dp_torch.train.trainer import Trainer

pytestmark = pytest.mark.port

torch.set_num_threads(2)

_B, _EPOCHS, _N = 4, 2, 96


def _records(ck_dir: Path) -> list[dict]:
    gens = sorted((ck_dir / "membership").iterdir())
    assert len(gens) == 1, gens
    return [json.loads(p.read_text())
            for p in sorted(gens[0].glob("epoch_*.json"))]


def _oracle(records: list[dict], tmp: Path):
    """The one-process oracle of any chain of graceful and grow records:
    for each dataset epoch the newest record whose resume names it gives
    the whole consumption lineage (segment i: ``steps_i`` updates at
    ``world_i`` on the re-split of the segments before it), the rest runs
    re-split at that record's world; an epoch no transition touched runs
    at the world current when it started. Returns the oracle's parameters
    and how often each sample ran in each epoch."""
    assert all(r["reason"] in ("initial", "graceful", "grow")
               for r in records)
    ds = load_dataset("synthetic", "./data", train=True,
                      allow_synthetic=True, synthetic_num_examples=_N,
                      seed=0)

    def streams(epoch, prior, world):
        if not prior:
            out = []
            for r in range(world):
                s = ShardedSampler(len(ds), world, r, shuffle=True, seed=0)
                s.set_epoch(epoch)
                out.append(s.shard_indices())
            return out
        return [elastic_resplit(len(ds), True, 0, epoch, _B, prior, world,
                                r) for r in range(world)]

    def segments(epoch):
        touching = [r for r in records[1:]
                    if (r.get("resume") or {}).get("epoch") == epoch]
        if touching:
            lineage = [list(map(int, s))
                       for s in touching[-1]["resume"]["lineage"]]
            return ([(lineage[:i], w, n) for i, (w, n) in enumerate(lineage)]
                    + [(lineage, int(touching[-1]["world"]), None)])
        world = int(records[0]["world"])
        for r in records[1:]:
            if (r.get("resume") or {}).get("epoch", 10**9) < epoch:
                world = int(r["world"])
        return [([], world, None)]

    tr = Trainer(parse_cli(_args(tmp / "oracle", _N)[:-4]), device="cpu")
    counts = np.zeros((_EPOCHS, len(ds)), np.int64)
    for epoch in range(_EPOCHS):
        for prior, world, steps in segments(epoch):
            ss = streams(epoch, prior, world)
            n = min(len(s) for s in ss) // _B if steps is None else steps
            for k in range(n):
                sel = np.concatenate([s[k * _B:(k + 1) * _B] for s in ss])
                counts[epoch, sel] += 1
                tr.train_step(tr.state, {
                    "image": torch.from_numpy(ds.images[sel]),
                    "label": torch.from_numpy(ds.labels[sel]).long()})
    return ({k: p.detach().numpy() for k, p in tr.model.named_parameters()},
            counts)


def _grow_run(tmp: Path, *extra) -> tuple[dict, list[dict]]:
    ck_dir = tmp / "ck"
    procs = _start(tmp, _args(ck_dir, _N,
                              "--resilience.fault=relaunch:step=2,rank=2",
                              "--resilience.snapshot_every_steps=2",
                              "--resilience.snapshot_keep=0", *extra))
    results = _finish(tmp, procs, victim=-1)  # every rank exits 0
    records = _records(ck_dir)
    # The ledger tells 3 -> 2 (graceful) -> 3 (grow).
    assert [r["world"] for r in records] == [3, 2, 3]
    assert records[1]["reason"] == "graceful"
    assert [d["sid"] for d in records[1]["departed"]] == [2]
    grow = records[2]
    gen = next((ck_dir / "membership").iterdir())
    request = json.loads((gen / "join_e0002_r00002.json").read_text())
    assert grow["reason"] == "grow" and grow["members"] == [0, 1, 2]
    assert grow["joined"] == [{"sid": 2, "token": request["token"]}]
    assert grow["service_sid"] == 0
    assert json.loads((gen / "grow_verdict_e0002.json").read_text())[
        "commit"] is True
    for sid in range(3):
        r = results[sid]
        assert (r["sid"], r["new_rank"], r["world"]) == (sid, sid, 3)
        assert r["preempted"] is None and r["record"] == grow
    for sid in (0, 1):
        c = results[sid]["counters"]
        assert (c["elastic.regroups"], c["elastic.lost_ranks"],
                c["elastic.joined_ranks"], c["elastic.membership_epoch"]) \
            == (2, 1, 1, 2)
    c2 = results[2]["counters"]
    assert (c2["elastic.departures"], c2["elastic.joins"],
            c2["elastic.membership_epoch"]) == (1, 1, 2)
    # The joiner restored the grow snapshot, nothing else.
    snap = Path(grow["resume"]["snapshot_dir"])
    fresh = Trainer(parse_cli(_args(tmp / "restore", _N)[:-4]),
                    device="cpu")
    ck.load_checkpoint(snap, fresh.state)
    adopted = results[2]["adopted"]
    assert adopted["step"] == fresh.state.step == grow["resume"][
        "global_step"]
    for k, v in fresh.model.state_dict().items():
        assert adopted[k].tobytes() == v.numpy().tobytes(), k
    # All three ranks end bit-identical ...
    a = results[0]["final"]
    for r in (1, 2):
        assert results[r]["final"].keys() == a.keys()
        for k in a:
            assert results[r]["final"][k].tobytes() == a[k].tobytes(), (r, k)
    # ... equal to the oracle rebuilt from the records alone.
    params, counts = _oracle(records, tmp)
    from tpu_dp_torch.compat import convert_grads

    final = {k.split("/", 1)[1]: v for k, v in a.items()
             if k.startswith("params/")}
    mine = {k: v.numpy() for k, v in convert_grads(_unflatten(final)).items()}
    assert mine.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(mine[k], v, atol=2e-5, rtol=0, err_msg=k)
    # Exactly once an epoch across the three segments; each re-split sheds
    # at most its seam (two re-splits).
    assert (counts <= 1).all(), "a sample was consumed twice in an epoch"
    assert int((counts < 1).sum()) < 2 * 3 * _B * 2
    return results, records


def test_relaunch_on_rank_2_shrinks_then_grows_back_to_three(tmp_path):
    _grow_run(tmp_path)


def test_relaunch_under_the_sharded_update_with_telemetry(tmp_path):
    """The momentum resharded upward (2 -> 3) through the resharding load;
    heartbeats on: rank 0's health monitor, rebuilt at the admission,
    never flags the joiner."""
    results, records = _grow_run(tmp_path, "--train.update_sharding=sharded",
                                 "--train.obs=basic")
    gen = next((tmp_path / "ck" / "membership").iterdir())
    assert not list(gen.glob("suspect_*"))
    assert not [i for i in results[0]["health_issues"]
                if i["kind"] in ("missing", "stale")]
    beats = tmp_path / "ck" / "obs" / "me0002" / "heartbeat_r00002.jsonl"
    assert all(json.loads(line)["me"] == 2
               for line in beats.read_text().splitlines())
    assert results[2]["counters"]["elastic.joins"] == 1
