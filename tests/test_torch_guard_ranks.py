"""The port's guard across gloo ranks on the CPU (`tests/torch_ddp_
worker.py` ranks running the port's `Trainer`; mirrors the guard cases of
tests/test_multiprocess.py without the elastic regroup, ROADMAP Queue 1
item 9d).

- Two ranks, ``nan:step=3,rank=1``: the fault on one rank reaches both
  through the gradient all-reduce and the global loss, both skip the same
  update, the ranks end bit-identical and within 1e-5 of one process on
  the concatenated batch with the same fault; rank 0 writes the record.
- Two ranks, a spike under ``action=rollback``: rank 0 picks the step-5
  snapshot and broadcasts it, both ranks replay to the end bit-identical,
  within 1e-5 of one process.
- The sharded update (f32, and int8 in buckets) with a rank-gated
  skipped step: the gathered momentum shards and int8 residuals, and the
  parameters, are bit-identical to the port's own sharded run that never
  saw the batch.
- Three ranks, ``sdc:`` on rank 2: the audit names rank 2 and the flipped
  leaf, every rank halts (`DivergedError`), and the saves newer than the
  last clean audit are quarantined: none at ``sdc:step=2`` with the audit
  at every boundary (the guard runs before the snapshot, as in the JAX
  package), the step-3 snapshot at ``sdc:step=3`` with the audit every 2;
  rank 0's ``metrics.jsonl`` holds the JAX package's ``guard_sdc`` event.
- On a card: the checksum of CUDA tensors equals that of their CPU copy.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torch_ddp_worker import run_trainer
from torch_port_util import run_worker_ranks
from tpu_dp_torch.checkpoint import QUARANTINED_MARKER
from tpu_dp_torch.resilience import QuarantineLog, params_checksum

pytestmark = pytest.mark.port

torch.set_num_threads(2)

_NET = ["--data.dataset=synthetic", "--data.synthetic_train_size=48",
        "--data.synthetic_test_size=8", "--train.epochs=1",
        "--train.log_every=100", "--train.eval_at_end=false",
        "--resilience.handle_signals=false", "--train.ckpt_async=false"]
_GUARD = ["--guard.enabled=true", "--guard.action=skip"]
_WIRES = {"f32": ["--train.update_sharding=sharded"],
          "int8-buckets": ["--train.update_sharding=sharded",
                           "--train.collective_dtype=int8",
                           "--train.quant_block_size=64",
                           "--train.bucket_mb=0.01"]}
_ROLLBACK = ["--guard.enabled=true", "--guard.action=rollback",
             "--resilience.fault=spike:step=8,scale=1e6",
             "--resilience.snapshot_every_steps=5",
             "--guard.spike_min_steps=4", "--guard.spike_window=16",
             "--guard.spike_z=12", "--train.epochs=2"]
_SDC = {"every-boundary": ("sdc:step=2,rank=2", 1, []),
        "every-2": ("sdc:step=3,rank=2", 2, ["step_0000000003"])}


def _job(tmp, tag, args, world, **spec):
    where = tmp / tag
    return where, {"job": "trainer", "args": args + [
        f"--train.ckpt_dir={where / 'ck'}", f"--obs.run_dir={where / 'obs'}"],
        **spec}, world


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group of ranks of this file, two groups at a time."""
    tmp = tmp_path_factory.mktemp("guard_ranks")
    jobs = {"nan": _job(tmp, "nan", _NET + _GUARD + [
        "--data.batch_size=2", "--resilience.fault=nan:step=3,rank=1"], 2),
            "rollback": _job(tmp, "rollback", _NET + _ROLLBACK + [
                "--data.batch_size=2"], 2)}
    for wire, knobs in _WIRES.items():
        args = _NET + knobs + ["--data.batch_size=2"]
        jobs[f"{wire}-guarded"] = _job(
            tmp, f"{wire}-guarded", args + _GUARD + [
                "--resilience.fault=nan:step=3,rank=1"], 2)
        jobs[f"{wire}-oracle"] = _job(tmp, f"{wire}-oracle", args, 2,
                                      drop=[3])
    for case, (fault, every, _) in _SDC.items():
        jobs[f"sdc-{case}"] = _job(tmp, f"sdc-{case}", _NET + [
            "--data.synthetic_train_size=96", "--guard.enabled=true",
            f"--guard.sdc_every_steps={every}", "--guard.sdc_action=halt",
            "--resilience.snapshot_every_steps=1",
            f"--resilience.fault={fault}"], 3)

    def go(item):
        name, (where, spec, world) = item
        return name, (where, run_worker_ranks(where, spec, world,
                                              timeout=300))

    with ThreadPoolExecutor(max_workers=2) as pool:
        return dict(pool.map(go, jobs.items()))


def test_a_rank_gated_nan_skips_on_every_rank(runs, tmp_path):
    where, ranks = runs["nan"]
    for r in ranks:
        assert r["diverged"] is None
        assert (r["step"], r["host_step"]) == (11, 12)
        assert r["losses"][3] == 0.0
        assert r["counters"]["guard.quarantined"] == 1
    for k, v in ranks[0]["final"].items():
        assert ranks[1]["final"][k].tobytes() == v.tobytes(), k
    recs = QuarantineLog(where / "ck" / "quarantine.jsonl").read()
    assert [(r["step"], r["sample_range"], r["rank"]) for r in recs] == [
        (4, [12, 16], 0)]
    assert recs[0]["reason"] == ("non-finite update at step 4 (loss=nan, "
                                 "grad_norm=nan)")
    one = run_trainer(_NET + _GUARD + [
        "--data.batch_size=4", "--resilience.fault=nan:step=3",
        f"--train.ckpt_dir={tmp_path}"])
    assert one["step"] == 11
    assert max(abs(a - b) for a, b in zip(one["losses"],
                                          ranks[0]["losses"])) <= 1e-5
    for k, v in one["final"].items():
        np.testing.assert_allclose(ranks[0]["final"][k], v, atol=1e-5,
                                   rtol=0, err_msg=k)


def test_a_rollback_across_ranks_is_decided_by_rank_0(runs, tmp_path):
    where, ranks = runs["rollback"]
    for r in ranks:
        assert r["diverged"] is None
        assert (r["step"], r["host_step"]) == (24, 24)
        assert r["counters"]["guard.rollbacks"] == 1
    for k, v in ranks[0]["final"].items():
        assert ranks[1]["final"][k].tobytes() == v.tobytes(), k
    recs = QuarantineLog(where / "ck" / "quarantine.jsonl").read()
    assert [(r["from_step"], r["to_step"]) for r in recs
            if r["kind"] == "tombstone"] == [(9, 5)]
    one = run_trainer(_NET + _ROLLBACK + ["--data.batch_size=4",
                                          f"--train.ckpt_dir={tmp_path}"])
    assert one["step"] == 24 and one["counters"]["guard.rollbacks"] >= 1
    for k, v in one["final"].items():
        np.testing.assert_allclose(ranks[0]["final"][k], v, atol=1e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("wire", sorted(_WIRES))
def test_sharded_skip_is_the_never_saw_it_oracle(runs, wire):
    _, guarded = runs[f"{wire}-guarded"]
    _, oracle = runs[f"{wire}-oracle"]
    keys = guarded[0]["final"].keys()
    assert any("opt_state" in k for k in keys)
    assert any("residuals" in k for k in keys) == (wire != "f32")
    for g, o in zip(guarded, oracle):
        assert (g["step"], g["host_step"]) == (11, 12) == (o["step"], 12)
        assert g["final"].keys() == o["final"].keys()
        for k, v in o["final"].items():
            assert g["final"][k].tobytes() == v.tobytes(), (wire, k)


@pytest.mark.parametrize("case", sorted(_SDC))
def test_sdc_audit_names_rank_2_and_halts(runs, case):
    where, ranks = runs[f"sdc-{case}"]
    fault, every, marked = _SDC[case]
    for r in ranks:
        assert "SDC audit mismatch" in r["diverged"]
        assert "suspect rank(s) [2]" in r["diverged"]
        assert r["counters"]["guard.sdc_mismatches"] == 1
    recs = [r for r in QuarantineLog(where / "ck" / "quarantine.jsonl")
            .read() if r["kind"] == "sdc"]
    assert len(recs) == 1
    flip = int(fault.split("step=")[1].split(",")[0])
    audit = (flip // every + 1) * every
    assert recs[0]["step"] == audit == ranks[0]["host_step"]
    assert recs[0]["suspects"] == [2] and recs[0]["majority"] == [0, 1]
    assert recs[0]["leaves"] == {"2": ["conv1/bias"]}
    assert recs[0]["last_clean_step"] == audit - every
    snaps = where / "ck" / "snapshots"
    assert sorted(d.name for d in snaps.iterdir()
                  if (d / QUARANTINED_MARKER).exists()) == marked


@pytest.mark.parametrize("case", sorted(_SDC))
def test_sdc_audit_writes_the_jax_packages_metrics_event(runs, case):
    """Rank 0 writes the audit's finding into metrics.jsonl as the JAX
    package's ``guard_sdc`` event: the quarantine record's fields."""
    where, _ = runs[f"sdc-{case}"]
    recs = [json.loads(line) for line in
            (where / "ck" / "metrics.jsonl").read_text().splitlines()]
    events = [r for r in recs if r.get("event") == "guard_sdc"]
    assert len(events) == 1
    (sdc,) = [r for r in QuarantineLog(where / "ck" / "quarantine.jsonl")
              .read() if r["kind"] == "sdc"]
    assert sorted(events[0]) == ["digest", "event", "last_clean_step",
                                 "leaves", "majority", "schema", "step",
                                 "suspects", "ts"]
    for k in ("step", "suspects", "majority", "leaves", "last_clean_step",
              "digest"):
        assert events[0][k] == sdc[k], k


@pytest.mark.card
def test_checksum_on_the_card_equals_the_cpu_copy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpu_dp_torch.models import build_model

    model = build_model("resnet18", generator=torch.Generator().manual_seed(
        0))
    named = {k: v.detach() for k, v in model.named_parameters()}
    for dtype in (torch.float32, torch.bfloat16):
        cpu = {k: v.to(dtype) for k, v in named.items()}
        card = {k: v.cuda() for k, v in cpu.items()}
        np.testing.assert_array_equal(params_checksum(card),
                                      params_checksum(cpu))
