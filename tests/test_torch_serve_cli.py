"""``python -m tpu_dp_torch.serve``'s cluster flags against ``python -m
tpu_dp.serve``'s: every usage error exits 2 with the JAX CLI's message,
``--profile`` exits 2 naming ROADMAP item 12, no card without
``--device`` exits 2, and the chaos scenario on the CPU (two replicas,
drain, swap, rejoin; a swap from a JAX checkpoint) exits 0 with an ok
verdict, its run directory read by both packages' ``obs timeline``."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpu_dp.serve.__main__ import main as jmain
from tpu_dp_torch.serve.__main__ import main

pytestmark = pytest.mark.port

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _stderr_of(fn, argv, capsys):
    capsys.readouterr()
    rc = fn(argv)
    return rc, capsys.readouterr().err.strip()


@pytest.mark.parametrize("argv", [
    ["--drain-at", "5:1"],
    ["--drain-at", "5:1", "--run-dir", "D"],
    ["--rejoin-at", "x"],
    ["--replicas", "2", "--drain-at", "5"],
    ["--replicas", "2", "--rejoin-at", "a:b"],
    ["--replicas", "0"],
    ["--sigterm-drains", "1"],
    ["--run-dir", "D"],
    ["--rejoin-at", "3:0", "--sigterm-drains", "0"],
    ["--replicas", "3", "--drain-at", "x:1"],
])
def test_usage_errors_exit_2_with_the_jax_message(argv, capsys):
    theirs = _stderr_of(jmain, argv + ["--requests", "1"], capsys)
    mine = _stderr_of(main, argv + ["--requests", "1", "--device", "cpu"],
                      capsys)
    assert theirs[0] == mine[0] == 2
    assert mine[1] == theirs[1] and mine[1].startswith("serve: ")


def test_profile_is_refused_naming_item_12(capsys):
    rc, err = _stderr_of(main, ["--profile", "x", "--device", "cpu"], capsys)
    assert rc == 2 and "item 12" in err and "--profile x" in err


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
@pytest.mark.parametrize("replicas", ["1", "2"])
def test_no_card_without_device_exits_2(replicas, capsys):
    rc, err = _stderr_of(main, ["--replicas", replicas, "--requests", "1"],
                         capsys)
    assert rc == 2
    assert ("2 replicas need at least 2 devices, have 0" in err
            if replicas == "2" else "no CUDA device" in err)


def _timelines(run_dir):
    rcs, outs = {}, {}
    for pkg in ("tpu_dp_torch", "tpu_dp"):
        p = subprocess.run(
            [sys.executable, "-m", f"{pkg}.obs", "timeline", str(run_dir),
             "--json"], cwd=ROOT, capture_output=True, text=True,
            timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        rcs[pkg], outs[pkg] = p.returncode, p.stdout
    return rcs, outs


def _run(argv, capsys):
    from tpu_dp_torch.obs import flightrec

    capsys.readouterr()
    try:
        rc = main(argv)
    finally:
        flightrec.recorder.reset()
    return rc, json.loads(capsys.readouterr().out)


def test_cluster_cli_chaos_on_the_cpu(tmp_path, capsys):
    run_dir = tmp_path / "sv"
    rc, report = _run(["--device", "cpu", "--replicas", "2", "--run-dir",
                       str(run_dir), "--model", "net", "--requests", "200",
                       "--slo-ms", "60000", "--drain-at", "40:1",
                       "--rejoin-at", "160:1", "--swap-at", "120",
                       "--class-mix", "0.6,0.4", "--class-slo-ms",
                       "60000,60000", "--floors", "0:0.5"], capsys)
    assert rc == 0 and report["verdict"]["ok"]
    assert report["retraces"] == 0 and report["world"] == 1
    assert report["membership_epoch"] == 2 and report["model_version"] == 2
    assert set(report["ground_truth"]["served_by_version"]) == {"1", "2"}
    assert all(r["status"] == "running" and r["batches"] > 0
               for r in report["replicas"].values())
    for name in ("heartbeat_r00000.jsonl", "heartbeat_r00001.jsonl",
                 "replica_r00000.jsonl", "serve_router.jsonl",
                 "flightrec_r00000.json"):
        assert (run_dir / "obs" / name).exists(), name
    rcs, outs = _timelines(run_dir)
    assert rcs == {"tpu_dp_torch": 0, "tpu_dp": 0}
    for out in outs.values():
        kinds = [e["kind"] for e in json.loads(out)["events"]]
        assert kinds.index("replica_drain") < kinds.index("replica_rejoin")
        assert "model_swap" in kinds


@pytest.fixture(scope="module")
def jax_net_ckpt(tmp_path_factory):
    """A JAX checkpoint of the reference Net (seed 11), params-only
    servable, and its params."""
    from tpu_dp import checkpoint as jck
    from tpu_dp import config as jax_config
    from tpu_dp.models import build_model as jax_build
    from tpu_dp.train.state import TrainState

    model = jax_build("net")
    v = model.init(jax.random.PRNGKey(11),
                   np.zeros((1, 32, 32, 3), np.float32), train=False)
    state = TrainState(step=np.zeros((), np.int32), params=v["params"],
                       opt_state={}, batch_stats={})
    root = tmp_path_factory.mktemp("jax_net")
    cfg = jax_config.Config()
    cfg.model.name = "net"
    jck.CheckpointManager(root, async_save=False).save(
        state, {"epoch": 0, "config": cfg.to_dict(), "seed": 0})
    return root, model, v


def test_cluster_cli_swaps_from_a_checkpoint(jax_net_ckpt, tmp_path,
                                             capsys):
    root, _, _ = jax_net_ckpt
    rc, report = _run(["--device", "cpu", "--replicas", "2", "--model",
                       "net", "--requests", "60", "--slo-ms", "60000",
                       "--swap-at", "30", "--swap-ckpt", str(root)], capsys)
    assert rc == 0 and report["verdict"]["ok"]
    assert set(report["ground_truth"]["served_by_version"]) == {"1", "2"}


def test_engine_swap_from_checkpoint_serves_its_weights(jax_net_ckpt):
    from tpu_dp.train.state import TrainState
    from tpu_dp.train.step import _infer_forward
    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.obs.counters import Counters
    from tpu_dp_torch.serve import InferenceEngine

    root, jmodel, v = jax_net_ckpt
    engine = InferenceEngine(build_model("net"), device="cpu",
                             buckets=(1, 2, 4), slo_ms=60_000.0,
                             registry=Counters())
    images = np.random.default_rng(3).integers(0, 256, (4, 32, 32, 3),
                                               dtype=np.uint8)
    with engine:
        assert engine.swap_from_checkpoint(root) == 2
        h = engine.submit(images)
        assert h.wait(60) and h.ok and h.model_version == 2
    state = TrainState(step=np.zeros((), np.int32), params=v["params"],
                       opt_state={}, batch_stats={})
    logits, pred = _infer_forward(jmodel, state, {"image": images})
    np.testing.assert_array_equal(h.predictions, np.asarray(pred))
