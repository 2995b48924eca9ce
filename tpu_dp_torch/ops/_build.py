"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``tpu_dp_torch/ops/csrc/`` is compiled on first use into
``build/kernels/`` at the repository root (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <src>

The library exposes a plain C interface and is loaded with `ctypes`, so a
build takes seconds (no PyTorch headers). No ``-lcuda`` either: the conv
kernel's TMA tensor map (``cuTensorMapEncodeTiled``, a driver-API call) is
reached through the runtime's ``cudaGetDriverEntryPoint`` (its
``ByVersion`` form from CUDA 12.5), and ``cuda.h`` is used for its types
only. The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``: ``ordered_reduce.cuh``, the cross-block ordered sum both
kernels include) and the flags: an edited source or header is rebuilt, an
unchanged one is loaded as it is. ``ptxas`` reports (registers, shared
memory, spills) are kept beside the library as ``<name>-<hash>.log``.

Builds are serialized across processes by an exclusive ``flock`` on
``build/kernels/build.lock`` (and across threads by a lock): when N ranks
start on a cold cache, one runs nvcc and the others wait, then load its
library. The kernel drops the lock when a process dies, so a lock file
left behind blocks nobody.

Nothing here runs at import time: the CPU tests import every module of
the package, and this machine-dependent work happens only when a kernel
is first launched (or `build_all` is called).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

#: kernel name -> source file under csrc/
SOURCES = {"conv_block": "conv_block.cu", "xent": "xent.cu",
           "augment": "augment.cu"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: kernel name -> {"seconds": build wall time, "log": ptxas report,
#: "cached", "waited_s": time spent waiting for another process's build}
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.exists():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the "
            "port's CUDA kernels are built from source on first use")
    return found


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / SOURCES[name]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; (proc, so, tmp)."""
    src, so = _target(name)
    if so.exists():
        return None, so, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, so, tmp


def _finish(name: str, proc, so: Path, tmp: Path | None, t0: float) -> None:
    if proc is None:
        log_path = so.with_suffix(".log")
        build_info[name] = {
            "seconds": 0.0, "cached": True,
            "log": log_path.read_text() if log_path.exists() else "",
        }
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)
    so.with_suffix(".log").write_text(out)
    build_info[name] = {"seconds": round(time.perf_counter() - t0, 3),
                        "cached": False, "log": out}


@contextlib.contextmanager
def _process_lock():
    """Exclusive across the processes that share ``BUILD_DIR``; yields the
    seconds spent waiting for it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(BUILD_DIR / "build.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield time.perf_counter() - t0
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names=None) -> dict[str, dict]:
    """Build every kernel (or ``names``), one nvcc per source, all started
    together; returns `build_info`. Loading still happens in `load`."""
    names = list(SOURCES if names is None else names)
    with _lock, _process_lock() as waited:
        t0 = time.perf_counter()
        started = [(n, *_start(n)) for n in names]
        for n, proc, so, tmp in started:
            _finish(n, proc, so, tmp, t0)
            build_info[n]["waited_s"] = round(waited, 3)
    return {n: build_info[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)[1]))
        return _libs[name]
