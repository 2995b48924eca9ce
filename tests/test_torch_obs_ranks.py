"""The port's telemetry across gloo ranks (the JAX package's multi-process
heartbeat and straggler cases, tests/test_multiprocess.py):

- two ranks at ``--train.obs=basic`` each write their own heartbeat file
  (one beat per update) and their own ``.r<rank>`` Prometheus file into
  one shared directory; rank 0 alone writes ``metrics.jsonl`` and the
  Perfetto trace;
- a ``delay:step=3,rank=1`` fault is named as rank 1's straggler at step 3
  by rank 0's live monitor (the epoch-end pass, after the eval's
  collective has ordered the ranks), and the post-hoc scans of both
  packages' monitors over the same files name it too.
"""

from __future__ import annotations

import json

import pytest
import torch

from torch_port_util import run_worker_ranks
from tpu_dp.obs.health import HealthMonitor as JaxHealthMonitor
from tpu_dp_torch.obs.health import HealthMonitor
from tpu_dp_torch.obs.promfile import parse_promfile

pytestmark = pytest.mark.port

torch.set_num_threads(2)

_DELAY_MS = 600
_NET = ["--data.dataset=synthetic", "--data.synthetic_train_size=24",
        "--data.synthetic_test_size=8", "--data.batch_size=4",
        "--train.epochs=1", "--train.log_every=100",
        "--train.eval_every_epochs=1", "--resilience.handle_signals=false",
        "--train.ckpt_async=false", "--train.obs=basic",
        "--obs.min_step_ms=0.01", "--obs.straggler_factor=3",
        f"--resilience.fault=delay:step=3,rank=1,ms={_DELAY_MS}"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_ranks")
    args = _NET + [f"--train.ckpt_dir={tmp / 'ck'}",
                   f"--obs.run_dir={tmp / 'obs'}",
                   f"--obs.prom_path={tmp / 'prom' / 'm.prom'}"]
    return tmp, run_worker_ranks(tmp / "ranks",
                                 {"job": "trainer", "args": args}, 2,
                                 timeout=300)


def test_each_rank_writes_its_own_heartbeats_and_promfile(ranks):
    tmp, outs = ranks
    assert all(o["host_step"] == 3 for o in outs)
    for rank in range(2):
        beats = [json.loads(line) for line in
                 (tmp / "obs" / f"heartbeat_r{rank:05d}.jsonl")
                 .read_text().splitlines()]
        assert [(b["rank"], b["step"]) for b in beats] == [
            (rank, s) for s in (1, 2, 3)]
        prom = parse_promfile((tmp / "prom" / f"m.prom.r{rank}")
                              .read_text())
        step_ms = prom["tpu_dp_obs_step_time_ms"]
        assert step_ms["type"] == "gauge"
        assert list(step_ms["samples"]) == [f'{{rank="{rank}"}}']
    assert not (tmp / "prom" / "m.prom").exists()
    recs = [json.loads(line) for line in
            (tmp / "ck" / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in recs] == [
        ["accuracy", "counters", "efficiency", "epoch", "images_per_sec",
         "loss", "schema", "spans", "step", "ts"],
        ["eval", "schema", "step", "ts"]]
    names = sorted(p.name for p in (tmp / "obs").iterdir())
    assert "trace.perfetto.json" in names


def test_rank_0s_monitor_names_the_delayed_rank(ranks):
    tmp, outs = ranks
    live = [i for i in outs[0]["health_issues"] if i["kind"] == "straggler"]
    assert [(i["rank"], i["step"]) for i in live] == [(1, 3)]
    assert live[0]["step_ms"] >= _DELAY_MS
    assert live[0]["ratio"] >= 3
    assert outs[1]["health_issues"] == []  # rank 1 runs no monitor
    for cls in (HealthMonitor, JaxHealthMonitor):
        scan = cls(tmp / "obs", world=2, min_step_ms=0.01).scan()
        worst = max(scan, key=lambda i: i.ratio)
        assert (worst.kind, worst.rank, worst.step) == ("straggler", 1, 3)
