"""Shared inputs of the port's parity tests (tests/test_torch_*.py): JAX
ResNet variables with randomized BatchNorm, as nested numpy dicts; and
`run_worker_ranks`, which runs gloo ranks of `torch_ddp_worker.py`."""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_ddp_worker.py"


def run_worker_ranks(tmp_path, spec: dict, world: int, timeout=240,
                     worker=WORKER) -> list:
    """Run ``world`` ranks of ``worker`` (torch_ddp_worker.py by default)
    on ``spec`` (plus each rank's ``rank``, ``world``, ``init`` — a
    ``file://`` rendezvous in ``tmp_path`` — and ``out``), each under
    ``timeout``; returns each rank's unpickled output."""
    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs, outs = [], []
    for rank in range(world):
        full = dict(spec, rank=rank, world=world,
                    init=f"file://{tmp_path / 'rendezvous'}",
                    out=str(tmp_path / f"rank{rank}.pkl"))
        path = tmp_path / f"spec{rank}.json"
        path.write_text(json.dumps(full))
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(path)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        for rank, p in enumerate(procs):
            log, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
            with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
                outs.append(pickle.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return outs


def randomize_bn(tree, rng, _path=()):
    """Random BN γ, β, running mean and var (a fresh init zeroes each
    block's last γ, which would hide half the convs from the logits)."""
    out = {}
    for k, a in tree.items():
        if isinstance(a, dict):
            out[k] = randomize_bn(a, rng, _path + (k,))
        elif k == "scale":
            out[k] = (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(
                np.float32)
        elif k == "bias" and "classifier" not in _path:
            out[k] = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif k == "mean":
            out[k] = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        else:
            out[k] = np.asarray(a)
    return out


def _jax_resnet_variables(name, num_filters, seed, num_classes):
    from tpu_dp.models import build_model

    model = build_model(name, num_classes=num_classes,
                        num_filters=num_filters)
    v = model.init(jax.random.PRNGKey(seed),
                   np.zeros((1, 32, 32, 3), np.float32), train=False)
    v = _plain({k: v[k] for k in ("params", "batch_stats")})
    return randomize_bn(v, np.random.default_rng(seed + 100))


def jax_resnet18_variables(num_filters=8, seed=0, num_classes=10):
    """``{"params", "batch_stats"}`` of a JAX ResNet-18 as numpy dicts,
    BN randomized from ``seed``."""
    return _jax_resnet_variables("resnet18", num_filters, seed, num_classes)


def jax_resnet50_variables(num_filters=8, seed=0, num_classes=100):
    """``{"params", "batch_stats"}`` of a JAX ResNet-50 as numpy dicts,
    BN randomized from ``seed``."""
    return _jax_resnet_variables("resnet50", num_filters, seed, num_classes)


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else v
            for k, v in tree.items()}
