"""``python -m tpu_dp_torch.train --preset=resnet18_cifar10`` (the main
path's exit test through the CLI) against the JAX package's `Trainer` on
the same config: full width, unfused, augmentation on (the crop/flip
draws are `jax.random`'s bits in both packages), B=4, 2 updates, resumed
from the JAX `Trainer`'s init. Final parameters, momentum and statistics
within 1e-4 (the bound of tests/test_torch_augment.py's Trainers), the
epoch loss within that plus the summary's 4-decimal rounding."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from test_torch_augment import _R18, _close, _jax_run
from torch_port_util import ROOT
from tpu_dp_torch import serialization
from tpu_dp_torch.checkpoint import _walk_state_dict, read_checkpoint

pytestmark = pytest.mark.port

torch.set_num_threads(2)


def test_preset_cli_tracks_the_jax_trainer(tmp_path):
    """``python -m tpu_dp_torch.train --preset=resnet18_cifar10`` (full
    width, unfused, augmentation on, B=4, 2 updates), resumed from the JAX
    `Trainer`'s init: its final parameters, momentum and statistics and
    its epoch loss against the JAX `Trainer` on the same config."""
    args = _R18 + ["--data.synthetic_train_size=8"]
    losses, init, final = _jax_run(tmp_path / "jax", args)
    ckpt = tmp_path / "ck"
    shutil.copytree(init, ckpt)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
    run = subprocess.run(
        [sys.executable, "-m", "tpu_dp_torch.train", "--device", "cpu",
         *args, "--resume", f"--train.ckpt_dir={ckpt}"],
        cwd=tmp_path, capture_output=True, text=True, timeout=240, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    summary = json.loads(run.stdout.strip().splitlines()[-1])
    assert summary["start_epoch"] == 0 and len(losses) == 2
    # The summary's loss is the epoch mean, rounded to 4 decimals.
    assert abs(summary["final_train_loss"] - sum(losses) / 2) <= 1.5e-4
    raw, meta = read_checkpoint(ckpt / "step_0000000002")
    assert meta["epoch"] == 0
    _close(dict(_walk_state_dict(raw)), final)
    params = serialization.msgpack_restore(
        (ckpt / "final_params.msgpack").read_bytes())
    _close({f"params/{k}": v for k, v in _walk_state_dict(params)}, final,
           collections=("params/",))
