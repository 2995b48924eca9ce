"""The port (`tpu_dp_torch`) and `chip_smoke.py` never reach JAX, the JAX
package, flax or msgpack, and its entry points refuse to fall back to the
CPU.

tests/conftest.py imports jax into every test process, so the runtime
check runs in a fresh subprocess."""

from __future__ import annotations

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.port

# The suite runs several pytest workers on one machine: keep each worker's
# PyTorch CPU pool small so the port's tests do not starve the others.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "tpu_dp_torch"
# msgpack too: the machine with the card has no msgpack package, so the
# port carries its own codec (tpu_dp_torch/serialization.py).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpu_dp", "msgpack")


#: The telemetry modules: standard library only at import (post-hoc
#: tools and watchers load them without torch or a card).
_TELEMETRY = ("tpu_dp_torch.metrics", "tpu_dp_torch.metrics.metrics",
              "tpu_dp_torch.obs", "tpu_dp_torch.obs.chips",
              "tpu_dp_torch.obs.costs", "tpu_dp_torch.obs.health",
              "tpu_dp_torch.obs.promfile", "tpu_dp_torch.obs.export",
              "tpu_dp_torch.utils.profiling", "tpu_dp_torch.obs.kineto",
              "tpu_dp_torch.obs.commprof", "tpu_dp_torch.obs.obsctl",
              "tpu_dp_torch.obs.fleet", "tpu_dp_torch.obs.tail",
              "tpu_dp_torch.obs.objective")


def _modules() -> list[str]:
    import tpu_dp_torch

    return sorted(
        m.name for m in pkgutil.walk_packages(tpu_dp_torch.__path__,
                                              "tpu_dp_torch.")
    )


def test_every_module_imports_without_jax_or_tpu_dp():
    mods = _modules()
    for m in ("tpu_dp_torch.ops.conv_block", "tpu_dp_torch.ops.xent",
              "tpu_dp_torch.serve.__main__", "tpu_dp_torch.train.trainer",
              "tpu_dp_torch.train.__main__", "tpu_dp_torch.parallel.dist",
              "tpu_dp_torch.parallel.collectives",
              "tpu_dp_torch.checkpoint", "tpu_dp_torch.serialization",
              "tpu_dp_torch.resilience.preempt", "tpu_dp_torch.models.net",
              "tpu_dp_torch.resilience.elastic", "tpu_dp_torch.data.sampler",
              "tpu_dp_torch.train.hooks", "tpu_dp_torch.config",
              "tpu_dp_torch.serve.router", "tpu_dp_torch.serve.replica",
              "tpu_dp_torch.analysis.recompile", *_TELEMETRY):
        assert m in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=240, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module", _TELEMETRY)
def test_telemetry_module_imports_alone_without_torch_or_jax(module):
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0]"
        f" in {FORBIDDEN + ('torch', 'numpy')!r})))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_static_scan_finds_no_jax_or_tpu_dp_import():
    files = sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "port_serve_warmup_ab.py",
        ROOT / "tools" / "port_resident_multicard.py",
        ROOT / "tools" / "port_profiler_loss.py",
        ROOT / "tools" / "port_profiler_drops.py",
        ROOT / "tools" / "port_nccl_abort_probe.py",
        ROOT / "tools" / "port_elastic_multicard.py",
        ROOT / "tools" / "port_commprof_multicard.py",
        ROOT / "tools" / "port_nccl_world1_probe.py",
        ROOT / "tools" / "port_serve_multicard.py"]
    assert len(files) > 15
    bad = {
        str(f.relative_to(ROOT)): n
        for f in files for n in _imports(f)
        if n.split(".")[0] in FORBIDDEN
    }
    assert bad == {}


#: The elastic rollback's test files: the ranks they start run
#: tests/torch_ddp_worker.py, which imports the port alone.
_ROLLBACK_TESTS = ("test_torch_elastic_rollback.py",
                   "test_torch_elastic_rollback_ranks.py",
                   "test_torch_elastic_rollback_sdc.py")


@pytest.mark.parametrize("name", _ROLLBACK_TESTS)
def test_the_rollback_tests_are_port_tests_whose_ranks_import_no_jax(name):
    """Each rollback test file is a port test; a file that starts rank
    processes gives each run a deadline (a hang fails the test, not the
    suite), and the rank worker and the modules the slice changed import
    nothing of JAX or the JAX package."""
    path = ROOT / "tests" / name
    text = path.read_text()
    assert "pytestmark = pytest.mark.port" in text
    if "_start(" in text:
        assert "_TIMEOUT_S" in text or "_finish(" in text
    files = [ROOT / "tests" / "torch_ddp_worker.py"] + [
        PKG / f for f in ("resilience/elastic.py", "parallel/dist.py",
                          "obs/health.py", "train/trainer.py",
                          "train/hooks.py", "config.py")]
    bad = {str(f.relative_to(ROOT)): n for f in files for n in _imports(f)
           if n.split(".")[0] in FORBIDDEN}
    assert bad == {}


#: The elastic grow's test files.
_GROW_TESTS = ("test_torch_elastic_grow.py",
               "test_torch_elastic_grow_ranks.py",
               "test_torch_elastic_grow_join.py")


@pytest.mark.parametrize("name", _GROW_TESTS)
def test_the_grow_tests_are_port_tests_whose_ranks_import_no_jax(name):
    """Each grow test file is a port test; one that starts rank processes
    gives each run a deadline; the rank worker and every module the grow
    changed import nothing of JAX or the JAX package."""
    text = (ROOT / "tests" / name).read_text()
    assert "pytestmark = pytest.mark.port" in text
    if "_start(" in text:
        assert "_finish(" in text
    files = [ROOT / "tests" / "torch_ddp_worker.py"] + [
        PKG / f for f in ("resilience/elastic.py", "parallel/dist.py",
                          "resilience/faultinject.py", "chaos/storage.py",
                          "obs/health.py", "train/trainer.py",
                          "train/__main__.py", "config.py")]
    bad = {str(f.relative_to(ROOT)): n for f in files for n in _imports(f)
           if n.split(".")[0] in FORBIDDEN}
    assert bad == {}


def test_resolve_device_raises_without_cuda(monkeypatch):
    from tpu_dp_torch.parallel.dist import describe, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        describe()
    assert resolve_device("cpu") == torch.device("cpu")
    assert describe("cpu")["platform"] == "cpu"


def test_engine_and_cli_refuse_without_cuda(monkeypatch):
    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.serve import InferenceEngine
    from tpu_dp_torch.serve.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model("resnet18", num_filters=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model)
    assert main(["--requests", "1"]) == 2


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    # Without a card the script must fail and print no result, from the
    # repo and from a directory holding nothing else.
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True,
            text=True, timeout=240,
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_cluster_and_cli_refuse_without_cuda(monkeypatch, capsys):
    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.serve import ServeCluster
    from tpu_dp_torch.serve.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError,
                       match="2 replicas need at least 2 devices, have 0"):
        ServeCluster(build_model("net"), replicas=2)
    assert main(["--requests", "1", "--replicas", "2"]) == 2
    assert "2 replicas need at least 2 devices" in capsys.readouterr().err
