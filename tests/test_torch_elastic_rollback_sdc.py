"""The guard's SDC eviction through the port's membership ledger, on three
gloo ranks (the twin of tests/test_multiprocess.py's
``test_three_process_sdc_audit_names_rank2_and_regroups``, all but its
``obsctl`` timeline, which is ROADMAP Queue 1 item 10b): a single-bit
parameter flip on rank 2 at step 2 (``sdc:step=2,rank=2``), the audit at
every step, snapshots at every step.

The audit at step 3 names rank 2, down to the leaf; rank 2 leaves with
rollback flavour and exits 143 (``guard_evict`` in its flight recorder);
ranks 0 and 1 accuse it on the ledger, so the record's departure reason
names the SDC audit; rank 0 quarantine-marks the saves since the last
clean audit; the survivors regroup at world 2 from the newest save that
predates the corruption and finish both epochs bit-identical, within 2e-5
of the one-process oracle of the record, every remaining sample once."""

from __future__ import annotations

import json

import numpy as np
import pytest

from test_torch_elastic_ranks import _args, _oracle, _unflatten
from test_torch_elastic_rollback_ranks import _finish, _ledger, _start
from tpu_dp_torch.compat import convert_grads

pytestmark = pytest.mark.port

_SDC = ["--train.obs=basic", "--guard.enabled=true", "--guard.action=skip",
        "--guard.sdc_every_steps=1", "--guard.spike_min_steps=64",
        "--resilience.snapshot_every_steps=1",
        "--resilience.regroup_timeout_s=10",
        "--resilience.fault=sdc:step=2,rank=2"]


def test_the_sdc_suspect_is_evicted_through_the_ledger(tmp_path):
    ck = tmp_path / "ck"
    procs = _start(tmp_path, _args(ck, 96, *_SDC))
    rcs, logs, outs = _finish(tmp_path, procs)
    assert rcs == [0, 0, 143], "\n".join(x[-3000:] for x in logs)
    assert "elastic departure" in outs[2]["preempted"]
    a, b = outs[0], outs[1]
    record = a["record"]
    assert b["record"] == record
    # A rollback regroup (a graceful final snapshot would keep the state
    # the audit condemned), resumed at or before the flip.
    assert (record["epoch"], record["reason"], record["members"]) == (
        1, "rollback", [0, 1])
    assert record["resume"]["lineage"][0][1] <= 2
    assert [d["sid"] for d in record["departed"]] == [2]
    assert "sdc" in record["departed"][0]["reason"].lower()
    gen, plan = _ledger(tmp_path)
    assert (plan["flavor"], plan["leavers"], plan["departed"]) == (
        "rollback", [2], [])
    assert (gen / "suspect_e0001_r00002.json").exists()
    # Every rank's audit found it; the survivors' counters carry it.
    for r in (0, 1):
        c = outs[r]["counters"]
        assert c["guard.sdc_mismatches"] >= 1 and c["guard.sdc_audits"] >= 1
        assert c["elastic.regroups"] == 1
        assert outs[r]["world"] == 2
    # The quarantine log names rank 2, down to its leaves; the metrics
    # stream has the finding.
    recs = [json.loads(line) for line in
            (ck / "quarantine.jsonl").read_text().splitlines()]
    sdc = [r for r in recs if r["kind"] == "sdc"]
    assert sdc and sdc[0]["suspects"] == [2] and sdc[0]["leaves"]["2"]
    metrics = [json.loads(line) for line in
               (ck / "metrics.jsonl").read_text().splitlines()]
    ev = [m for m in metrics if m.get("event") == "guard_sdc"]
    assert ev and ev[0]["suspects"] == [2]
    regroups = [m for m in metrics if m.get("event") == "elastic_regroup"]
    assert len(regroups) == 1 and regroups[0]["flavor"] == "rollback"
    # The step-3 snapshot was suppressed (the finding came first in that
    # boundary's sweep): the resume is step 2's, taken before the flip.
    assert record["resume"]["global_step"] == 2
    # Black boxes: the evicted rank's records its eviction; the survivors
    # end clean.
    dumps = {json.loads(p.read_text())["rank"]: json.loads(p.read_text())
             for p in (ck / "obs").glob("flightrec_r*.json")}
    assert "PreemptedError" in dumps[2]["reason"]
    assert any(e["kind"] == "guard_evict" for e in dumps[2]["events"])
    assert all(dumps[r]["reason"] == "clean" for r in (0, 1))
    # Bit-identical survivors, on the oracle of the record.
    for k in a["final"]:
        assert a["final"][k].tobytes() == b["final"][k].tobytes(), k
    params, counts = _oracle(record, 96, tmp_path)
    final = {k.split("/", 1)[1]: v for k, v in a["final"].items()
             if k.startswith("params/")}
    mine = {k: v.numpy() for k, v in convert_grads(_unflatten(final)).items()}
    for k, v in params.items():
        np.testing.assert_allclose(mine[k], v, atol=2e-5, rtol=0, err_msg=k)
    assert (counts <= 2).all(), "a sample was consumed twice"
    assert int((counts < 2).sum()) < 2 * 4 * 2
