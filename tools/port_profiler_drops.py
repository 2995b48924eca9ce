"""Where `torch.profiler` loses kernel records of long CUDA-graph replays
on the card, and what keeps them.

A window of ten ResNet-50 updates replays as one CUDA graph of some 32,000
kernels; `chip_smoke.py`'s by-name books profile two such replays in a
session, and a session now and then counted fewer of the port's kernels
than the books. Each case is a child process: the fused ResNet-50 in
windows of 10 (as phase 10 (c) of `chip_smoke.py` builds it), then
``--sessions`` sessions of two replays each through
`chip_smoke.profile_forward`, counted by kernel name against the books
(260 conv, 10 + 10 xent per replay) and by all device records against the
most any session of the case counted. For a session short of records, the
missing run of kernels is located in the kernels' order of start against
the case's fullest session (its offset from the start and from the end).

A case is ``SIZING:EDGES:LOAD``:

- ``SIZING``: ``defaults``, or ``sized`` (CUPTI's device buffer for
  timestamps raised from 3,200,000 bytes to `CUPTI_SIZES`, before the
  process makes its CUDA context; CUPTI's documentation warns that records
  lose their timestamps when too many kernels are replayed at one go);
- ``EDGES``: ``in`` (`chip_smoke.PROFILE_LEAD_IN` spin kernels of 100
  cycles before the counted calls: what `chip_smoke.py` did until this
  tool) or ``inout`` (as many spin kernels of
  `chip_smoke.PROFILE_SPIN_CYCLES` before them and again after them, once
  they are waited for: what `chip_smoke.py` does now);
- ``LOAD``: 0, or 1 for one spinning process per CPU core beside it.

The child runs with ``KINETO_LOG_LEVEL=2`` and the lines of its standard
error that report dropped records are counted. One JSON line per case and
a summary; the card's name and power limit head the output; the record
goes to ``chiprun_out/profiler_drops.json``. Run from the repository root
on a machine with an H100:

    python3 tools/port_profiler_drops.py [--sessions 10] \\
        [--cases defaults:in:1,defaults:inout:1]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: CUPTI's activity attributes (``CUpti_ActivityAttribute`` in
#: ``cupti_activity.h``) and the size the ``sized`` cases give the device
#: buffer that takes each kernel record's timestamps (default 3,200,000
#: bytes, three buffers allocated ahead).
CUPTI_ATTRS = {"DEVICE_BUFFER_SIZE": 0, "DEVICE_BUFFER_POOL_LIMIT": 2,
               "DEVICE_BUFFER_PRE_ALLOCATE_VALUE": 6}
CUPTI_SIZES = {"DEVICE_BUFFER_SIZE": 32 << 20}


def _cupti_library():
    """``(ctypes library, path)`` of the CUPTI this process's PyTorch
    loaded (a shared ``libcupti`` among the process's mappings, else the
    ``libtorch_cuda`` that holds it), or ``(None, None)``."""
    import ctypes

    import torch  # noqa: F401 -- loads the libraries searched below

    with open("/proc/self/maps", encoding="utf-8") as f:
        paths = {ln.split()[-1] for ln in f if ln.rstrip().endswith(".so")
                 or ".so." in ln}
    for want in ("libcupti", "libtorch_cuda"):
        for path in sorted(p for p in paths
                           if os.path.basename(p).startswith(want)):
            lib = ctypes.CDLL(path)
            if hasattr(lib, "cuptiActivitySetAttribute"):
                return lib, path
    return None, None


def cupti_attributes() -> dict:
    """CUPTI's activity attributes of `CUPTI_ATTRS` as this process reads
    them, the library they came from, and their numbers in the toolkit's
    ``cupti_activity.h`` where it is found."""
    import ctypes
    import re

    lib, path = _cupti_library()
    rec = {"library": path, "values": {}}
    if lib is not None:
        for name, attr in CUPTI_ATTRS.items():
            v, size = ctypes.c_size_t(0), ctypes.c_size_t(8)
            rc = lib.cuptiActivityGetAttribute(attr, ctypes.byref(size),
                                               ctypes.byref(v))
            rec["values"][name] = v.value if rc == 0 else f"rc {rc}"
    for root in ("/usr/local/cuda/extras/CUPTI/include",
                 "/usr/local/cuda/include"):
        header = os.path.join(root, "cupti_activity.h")
        if os.path.exists(header):
            with open(header, encoding="utf-8", errors="replace") as f:
                found = dict(re.findall(
                    r"CUPTI_ACTIVITY_ATTR_(\w+)\s*=\s*(\d+)", f.read()))
            rec["header"] = {n: int(found[n]) if n in found else None
                             for n in CUPTI_ATTRS}
            break
    return rec


def size_cupti_buffers() -> dict:
    """Gives CUPTI the sizes of `CUPTI_SIZES` before the process makes its
    CUDA context (they apply to the buffers CUPTI allocates after), so that
    a session over long graph replays keeps every kernel record; raises if
    CUPTI refuses. Returns `cupti_attributes` after."""
    import ctypes

    lib, path = _cupti_library()
    if lib is None:
        raise RuntimeError("port_profiler_drops: no CUPTI in this process")
    for name, value in CUPTI_SIZES.items():
        v, size = ctypes.c_size_t(value), ctypes.c_size_t(8)
        rc = lib.cuptiActivitySetAttribute(CUPTI_ATTRS[name],
                                           ctypes.byref(size),
                                           ctypes.byref(v))
        if rc != 0:
            raise RuntimeError(f"port_profiler_drops: CUPTI refused "
                               f"{name}={value} (CUptiResult {rc}, {path})")
    return cupti_attributes()


def _gap(order, full):
    """Where ``order`` lacks records of ``full``: the length of their
    common head and common tail, and whether the missing records are one
    run between them."""
    head = 0
    while head < min(len(order), len(full)) and order[head] == full[head]:
        head += 1
    tail = 0
    while (tail < min(len(order), len(full)) - head
           and order[-1 - tail] == full[-1 - tail]):
        tail += 1
    return {"missing": len(full) - len(order), "head": head, "tail": tail,
            "one_run": head + tail == len(order)}


def child(case: str, sessions: int) -> int:
    sizing, edges, _ = case.split(":")
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    cupti = size_cupti_buffers() if sizing == "sized" else (
        cupti_attributes())
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    k = cs.R50_K
    books = {"conv_block_kernel": 26 * k, "xent_fwd": k, "xent_bwd": k}
    with tempfile.TemporaryDirectory(prefix="profiler_drops_") as tmp:
        win = Trainer(parse_cli(cs._r50_args(tmp, 2 * k, k, [
            "--data.augment=false", f"--train.ckpt_dir={tmp}/ck"])),
            device="cuda")
        win.fit()
        _, pool = cs._first_window(win.train_pipe, k)
        rows = []
        for _ in range(sessions):
            t0 = time.perf_counter()
            p = cs.profile_forward(
                lambda: win.multi_step(win.state, pool), 2, cuda_only=True,
                keep_all=True, keep_order=True, lead_in=cs.PROFILE_LEAD_IN,
                **({"lead_out": cs.PROFILE_LEAD_IN,
                    "spin_cycles": cs.PROFILE_SPIN_CYCLES}
                   if edges == "inout" else {"spin_cycles": 100}))
            rows.append({
                "by_name": {n: sum(v["count_per_call"]
                                   for key, v in p["all"].items()
                                   if n in key.lower()) for n in books},
                "records_per_call": p["kernel_launches_per_call"],
                "session_s": time.perf_counter() - t0,
                "order": p["order"]})
        win.multi_step.close()
    full = max((r["order"] for r in rows), key=len)
    for r in rows:
        r["gap"] = _gap(r.pop("order"), full)
    print(json.dumps({"cupti": cupti, "books": books, "sessions": rows}),
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=10)
    ap.add_argument("--cases", default="defaults:in:1,defaults:inout:1")
    ap.add_argument("--child", nargs=2, metavar=("CASE", "SESSIONS"))
    args = ap.parse_args()
    if args.child:
        return child(args.child[0], int(args.child[1]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(card, flush=True)
    cases = []
    for spec in args.cases.split(","):
        loaded = int(spec.split(":")[2])
        spinners = [subprocess.Popen([sys.executable, "-c",
                                      "while True: pass"])
                    for _ in range(os.cpu_count() or 1)] if loaded else []
        try:
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 spec, str(args.sessions)], capture_output=True,
                text=True, timeout=600, check=False,
                env={**os.environ, "KINETO_LOG_LEVEL": "2"})
        finally:
            for s in spinners:
                s.kill()
                s.wait()
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        res = json.loads(lines[-1]) if r.returncode == 0 and lines else {}
        drops = [ln for ln in r.stderr.splitlines() if "ropped" in ln]
        case = {"case": spec, "rc": r.returncode,
                "case_s": time.perf_counter() - t0,
                "dropped_lines": len(drops), "dropped_first": drops[:3],
                **res}
        if r.returncode:
            case["stderr_tail"] = r.stderr[-3000:]
        cases.append(case)
        print(json.dumps(case), flush=True)
    most = max((s["records_per_call"] for c in cases
                for s in c.get("sessions", [])), default=0)
    summary = {}
    for c in cases:
        rows = c.get("sessions", [])
        summary[c["case"]] = {
            "sessions": len(rows),
            "sessions_short_by_name": sum(
                1 for s in rows if s["by_name"] != c["books"]),
            "sessions_short_records": sum(
                1 for s in rows if s["records_per_call"] < most),
            "records_short_per_call": [most - s["records_per_call"]
                                       for s in rows],
            "gaps": [s["gap"] for s in rows if s["gap"]["missing"]],
            "dropped_lines": c["dropped_lines"], "rc": c["rc"]}
    print(json.dumps({"summary": summary, "most_records_per_call": most}),
          flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profiler_drops.json"), "w",
              encoding="utf-8") as f:
        json.dump({"card": card, "cases": cases, "summary": summary}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
