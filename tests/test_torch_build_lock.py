"""The kernel build's cross-process lock (`tpu_dp_torch.ops._build`): N
ranks started together on a cold cache run one compile, and the others
wait for it and load its library.

Two processes call `build_all` on a fake source with a fake ``nvcc`` (a
script that books each call and takes a second to write its output)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]


def test_two_processes_see_one_build_and_one_wait(tmp_path):
    calls = tmp_path / "nvcc_calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, time
        with open({str(calls)!r}, "a") as f:
            f.write("call\\n")
        time.sleep(1.0)
        out = sys.argv[sys.argv.index("-o") + 1]
        with open(out, "w") as f:
            f.write("library")
        print("ptxas info    : fake")
        """))
    nvcc.chmod(0o755)
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "fake.cu").write_text("// fake kernel\n")
    go = tmp_path / "go"
    code = textwrap.dedent(f"""\
        import json, sys, time
        from pathlib import Path
        from tpu_dp_torch.ops import _build
        _build.CSRC = Path({str(tmp_path / 'csrc')!r})
        _build.BUILD_DIR = Path({str(tmp_path / 'build')!r})
        _build.SOURCES = {{"fake": "fake.cu"}}
        _build.find_nvcc = lambda: {str(nvcc)!r}
        Path({str(tmp_path)!r}, "ready" + sys.argv[1]).touch()
        while not Path({str(go)!r}).exists():  # start both together
            time.sleep(0.01)
        info = _build.build_all()["fake"]
        print(json.dumps({{k: info[k] for k in ("cached", "waited_s")}}))
        """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    results = []
    try:
        deadline = time.monotonic() + 120
        while not all((tmp_path / f"ready{i}").exists() for i in range(2)):
            assert time.monotonic() < deadline and all(
                p.poll() is None for p in procs), "workers did not start"
            time.sleep(0.01)
        go.touch()
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert calls.read_text().splitlines() == ["call"]  # one compile
    built = [r for r in results if not r["cached"]]
    waited = [r for r in results if r["cached"]]
    assert len(built) == len(waited) == 1
    # The second process took the lock after the compile's second.
    assert waited[0]["waited_s"] >= 0.5, results
    libs = list((tmp_path / "build").glob("fake-*.so"))
    assert len(libs) == 1 and libs[0].read_text() == "library"
