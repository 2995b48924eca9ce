"""The port's training entry point end to end on the CPU:
``python -m tpu_dp_torch.train`` at full width (ResNet-18, num_filters 64)
with the slice's configuration, on a tiny synthetic set, in a subprocess —
and its refusal to run without a card unless asked for the CPU."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
SLICE = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
         "--model.fused_bwd=true", "--train.pallas_xent=true",
         "--data.dataset=synthetic"]


def _run(args, timeout=240):
    # Two threads: the suite runs several pytest workers on one machine.
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "tpu_dp_torch.train", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout, env=env)


def test_cli_trains_and_evaluates_on_cpu(tmp_path):
    out = _run(["--device", "cpu", *SLICE, f"--train.ckpt_dir={tmp_path}",
                "--data.synthetic_train_size=16",
                "--data.synthetic_test_size=16", "--data.batch_size=8",
                "--train.epochs=1", "--train.log_every=1"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "[1,     1] loss:" in out.stdout
    assert "[1,     2] loss:" in out.stdout
    assert "Finished Training" in lines
    assert any(ln.startswith("Accuracy of the network on the 16 test images")
               for ln in lines)
    summary = json.loads(lines[-1])
    assert summary["model"] == "resnet18" and summary["synthetic"] is True
    assert summary["devices"] == 1
    assert math.isfinite(summary["final_train_loss"])
    assert 0.0 <= summary["eval"]["accuracy"] <= 1.0
    assert math.isfinite(summary["eval"]["loss"])
    assert (tmp_path / "step_0000000002" / "meta.json").exists()
    assert (tmp_path / "final_params.msgpack").exists()


def test_cli_refuses_without_a_card_or_cpu_flag(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would run on it")
    out = _run(SLICE + ["--data.synthetic_train_size=16",
                        f"--train.ckpt_dir={tmp_path}"], timeout=120)
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr
    assert "Finished Training" not in out.stdout


def test_meter_counts_images_after_warmup_to_the_fence(monkeypatch):
    from tpu_dp_torch.utils import meter

    clock = iter([0.0, 1.0, 2.0, 3.0, 5.0])
    monkeypatch.setattr(meter.time, "perf_counter", lambda: next(clock))
    m = meter.ThroughputMeter(warmup_steps=2, device="cpu")
    assert m.images_per_sec == 0.0
    for _ in range(4):  # dispatched at t = 0, 1, 2, 3; the window opens at 1
        m.step(8)
    m.mark()  # fenced at t = 5: steps 3 and 4 counted over 4 s
    assert m.images_per_sec == 16 / 4


def test_cli_refuses_an_unported_knob(tmp_path):
    out = _run(["--device", "cpu", *SLICE, "--train.verify_fingerprint=true",
                f"--train.ckpt_dir={tmp_path}"], timeout=120)
    assert out.returncode == 2
    assert "not ported" in out.stderr


@pytest.mark.parametrize("knob,message", [
    ("--train.steps_per_call=-1", "train.steps_per_call must be >= 0"),
    ("--optim.grad_accum_steps=0", "optim.grad_accum_steps must be >= 1")])
def test_cli_refuses_an_invalid_window_or_accumulation(tmp_path, knob,
                                                       message):
    out = _run(["--device", "cpu", *SLICE, knob,
                f"--train.ckpt_dir={tmp_path}"], timeout=120)
    assert out.returncode == 2
    assert message in out.stderr
    assert "Finished Training" not in out.stdout
