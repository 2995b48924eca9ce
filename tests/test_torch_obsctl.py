"""The port's post-hoc tools (`tpu_dp_torch.obs.obsctl`, ``python -m
tpu_dp_torch.obs``; `tail`, `objective`) against the JAX package's
(`tpu_dp.obs.obsctl`, `tail`, `objective`) over run directories the
port's Trainer wrote on the CPU (the reference ``Net``, ``--train.obs=
full``, snapshots every 2 updates, a comm window over steps [6, 8)):

- a run preempted at step 5 (exit 143) and resumed to its end;
- a one-process elastic departure (``leave:step=3``, exit 143) resumed
  to its end;

and, on each directory, field for field (paths aside, which are the
same): the timeline (with and without steps), ``run_efficiency``, the
minted baseline and ``diff_verdict`` against it (clean, and a tampered
baseline that regresses), ``stragglers``, ``build_merged_trace``, the
``watch --replay`` exit codes of the same rules (clean 0, tripped 1, no
data 2), the ``--json`` output of the CLI commands, and `JsonlTail`'s
incremental reads of the metrics sink. `objective`'s table is equal on
the same records; ``watch --profile`` exits 2 naming ROADMAP item 12.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from torch_port_util import ROOT
from tpu_dp.obs import objective as jobjective
from tpu_dp.obs import obsctl as jobsctl
from tpu_dp.obs import tail as jtail
from tpu_dp_torch.obs import objective, obsctl, tail

pytestmark = pytest.mark.port

_NET = ["--device", "cpu", "--data.dataset=synthetic",
        "--data.synthetic_train_size=48", "--data.synthetic_test_size=8",
        "--data.batch_size=4", "--train.epochs=1", "--train.log_every=100",
        "--train.obs=full", "--train.ckpt_async=false",
        "--resilience.snapshot_every_steps=2",
        "--obs.comm_profile_steps=6:8"]
_RUNS = {
    "preempt": (["--resilience.fault=preempt:step=5"], []),
    "leave": (["--resilience.elastic=true",
               "--resilience.elastic_verify_fingerprint=false",
               "--resilience.elastic_join=never",
               "--resilience.fault=leave:step=3"],
              ["--resilience.elastic=true",
               "--resilience.elastic_verify_fingerprint=false",
               "--resilience.elastic_join=never"]),
}


def _cli(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("TPU_DP_FAULT", None)
    return subprocess.run([sys.executable, "-m", "tpu_dp_torch.train",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=240)


@pytest.fixture(scope="module", params=sorted(_RUNS))
def run_dir(request, tmp_path_factory):
    ck = tmp_path_factory.mktemp(f"obsctl_{request.param}") / "ck"
    first, resume = _RUNS[request.param]
    out = _cli(_NET + first + [f"--train.ckpt_dir={ck}"])
    assert out.returncode == 143, out.stderr[-3000:]
    out = _cli(_NET + resume + [f"--train.ckpt_dir={ck}", "--resume"])
    assert out.returncode == 0, out.stderr[-3000:]
    return request.param, ck


def _both(capsys, argv):
    """(rc, stdout) of the port's obsctl, then of the JAX package's."""
    out = []
    for main in (obsctl.main, jobsctl.main):
        rc = main(argv)
        out.append((rc, capsys.readouterr().out))
    return out


def test_the_run_holds_the_story(run_dir):
    kind, ck = run_dir
    tl = obsctl.build_timeline(obsctl.RunArtifacts(ck))
    kinds = [e["kind"] for e in tl["events"]]
    for k in ("profile_start", "profile_stop", "comm_profile", "snapshot",
              "exit"):
        assert k in kinds, (k, kinds)
    if kind == "leave":
        assert "membership_formed" in kinds
    # One process: the window holds compute and no collective.
    rep = json.loads((ck / "obs" / "comm_report.json").read_text())
    assert (rep["start_step"], rep["end_step"], rep["comm_ms"]) == (6, 8, 0)
    assert rep["compute_ms"] > 0


@pytest.mark.parametrize("steps", [False, True])
def test_timeline_equals_the_jax_packages(run_dir, steps):
    _, ck = run_dir
    assert obsctl.build_timeline(obsctl.RunArtifacts(ck), steps) == \
        jobsctl.build_timeline(jobsctl.RunArtifacts(ck), steps)


def test_efficiency_and_diff_equal_the_jax_packages(run_dir, tmp_path,
                                                    capsys):
    _, ck = run_dir
    mine = obsctl.run_efficiency(obsctl.RunArtifacts(ck))
    assert mine == jobsctl.run_efficiency(jobsctl.RunArtifacts(ck))
    assert mine["comm_ms"] is not None and mine["goodput"] is not None
    bases = []
    for main, name in ((obsctl.main, "port"), (jobsctl.main, "jax")):
        path = tmp_path / f"{name}.json"
        assert main(["diff", str(ck), "--write-baseline", str(path)]) == 0
        bases.append(json.loads(path.read_text()))
    assert bases[0] == bases[1]
    base = tmp_path / "port.json"
    assert obsctl.diff_verdict(mine, obsctl.load_baseline(base), 0.1) == \
        jobsctl.diff_verdict(mine, jobsctl.load_baseline(base), 0.1)
    tampered = tmp_path / "tampered.json"
    tampered.write_text(json.dumps(dict(bases[0],
                                        p95_ms=bases[0]["p95_ms"] / 10)))
    capsys.readouterr()
    for argv, rc in ((["diff", str(ck), "--baseline", str(base), "--json"],
                      0),
                     (["diff", str(ck), "--baseline", str(tampered),
                       "--json"], 1)):
        (rc_p, out_p), (rc_j, out_j) = _both(capsys, argv)
        assert rc_p == rc_j == rc
        assert json.loads(out_p) == json.loads(out_j)


@pytest.mark.parametrize("cmd", [["timeline", "--json"],
                                 ["timeline", "--json", "--steps"],
                                 ["timeline"],
                                 ["stragglers", "--json"],
                                 ["stragglers", "--json", "--factor", "1.01",
                                  "--min-step-ms", "0.001"]])
def test_cli_output_equals_the_jax_packages(run_dir, capsys, cmd):
    _, ck = run_dir
    (rc_p, out_p), (rc_j, out_j) = _both(capsys, [cmd[0], str(ck),
                                                  *cmd[1:]])
    assert rc_p == rc_j == 0
    assert out_p == out_j
    assert out_p.strip()


def test_merged_trace_equals_the_jax_packages(run_dir, tmp_path):
    _, ck = run_dir
    mine = obsctl.build_merged_trace(obsctl.RunArtifacts(ck))
    assert mine == jobsctl.build_merged_trace(jobsctl.RunArtifacts(ck))
    assert mine["traceEvents"]
    assert obsctl.main(["merge-trace", str(ck), "-o",
                        str(tmp_path / "m.json")]) == 0
    assert json.loads((tmp_path / "m.json").read_text()) == mine


@pytest.mark.parametrize("rules,rc", [
    (["goodput<0.0001", "exposed_comm_ms>1e9"], 0),
    (["exposed_comm_ms>-1"], 1),
    (["goodput<2*baseline"], 1),
    (["quant_overflow_per_step>0"], 2),
])
def test_watch_exit_codes_equal_the_jax_packages(run_dir, tmp_path, capsys,
                                                 rules, rc):
    _, ck = run_dir
    base = tmp_path / "base.json"
    assert obsctl.main(["diff", str(ck), "--write-baseline",
                        str(base)]) == 0
    argv = ["watch", str(ck), "--replay", "--baseline", str(base)]
    for r in rules:
        argv += ["--rule", r]
    capsys.readouterr()
    (rc_p, out_p), (rc_j, out_j) = _both(capsys, argv)
    assert rc_p == rc_j == rc
    assert out_p == out_j


def test_watch_profile_waits_for_item_12(run_dir, capsys):
    _, ck = run_dir
    assert obsctl.main(["watch", str(ck), "--replay", "--profile",
                        str(ck / "tuned.json")]) == 2
    assert "ROADMAP Queue 1 item 12" in capsys.readouterr().err


def test_the_module_cli_runs(run_dir):
    _, ck = run_dir
    out = subprocess.run([sys.executable, "-m", "tpu_dp_torch.obs",
                          "timeline", str(ck), "--json"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["events"]


def test_tail_reads_equal_the_jax_packages(run_dir, tmp_path):
    _, ck = run_dir
    lines = (ck / "metrics.jsonl").read_text().splitlines(keepends=True)
    path = tmp_path / "m.jsonl"
    path.write_text("")
    mine, theirs = tail.JsonlTail(path), jtail.JsonlTail(path)
    # Appended in pieces, a torn last line among them: each poll returns
    # the whole lines written so far, once.
    cut = len(lines) // 2
    for chunk in ("".join(lines[:cut]) + lines[cut][:7],
                  lines[cut][7:] + "".join(lines[cut + 1:]), "garbage\n"):
        with path.open("a") as f:
            f.write(chunk)
        assert mine.poll() == theirs.poll()
    assert tail.read_jsonl(ck / "metrics.jsonl") == jtail.read_jsonl(
        ck / "metrics.jsonl")


def test_objective_table_equals_the_jax_packages():
    records = [
        {"value": 1000.0, "mfu": 0.3, "goodput": 0.9,
         "latency": {"p95_ms": 12.0},
         "comm": {"comm_ms": 1.0, "exposed_comm_ms": 0.25,
                  "overlap_frac": 0.75}},
        {"value": 990.0, "goodput": 0.95, "comm": {}},
        {"value": None, "goodput": None},
        {},
    ]
    assert objective.OBJECTIVES == jobjective.OBJECTIVES
    assert objective.TIE_FRAC == jobjective.TIE_FRAC
    for rec in records:
        assert objective.trial_signals(rec) == jobjective.trial_signals(rec)
        assert objective.tiebreak_value(rec) == jobjective.tiebreak_value(
            rec)
        for obj in objective.OBJECTIVES:
            assert objective.objective_value(rec, obj) == \
                jobjective.objective_value(rec, obj)
    for a, b in ((1000.0, 990.0), (1000.0, 900.0), (0.0, 0.0)):
        assert objective.is_tied(a, b) == jobjective.is_tied(a, b)
    with pytest.raises(ValueError) as mine:
        objective.objective_value(records[0], "speed")
    with pytest.raises(ValueError) as theirs:
        jobjective.objective_value(records[0], "speed")
    assert str(mine.value) == str(theirs.value)
