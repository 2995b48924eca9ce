"""A/B of the conv kernel's stats-fold epilogue on the card: variants of
`tpu_dp_torch/ops/csrc/conv_block.cu` made by patching its source, built
side by side, timed in turns through the C entry at the B=128 training
shapes. Run from the repository root on a machine with an H100:

    python3 tools/port_stats_fold_ab.py [--reps 3] [--parent DIR]

``--parent DIR`` also builds DIR/tpu_dp_torch/ops/csrc/conv_block.cu, the
kernel before the fold (a checkout of the parent commit, e.g. unpacked
with ``git archive`` into the gitignored ``build/parent``), and times its
stats launch followed by its separate reduce launch ("parent"), in the
same turns.

Each variant changes only how a block ends a stats launch (the tickets and
sums of the one-launch cross-block fold, `csrc/ordered_reduce.cuh`):

    fold            the kernel as committed
    no_ticket       partial rows only, no tickets, stats not summed
    ticket_no_tail  tickets drawn and waited for, sums skipped
    no_y_stores     y not stored by stats launches (the tail without y's
                    drain in the memory system)
    timed           fold with clock64 stamps of the block that finishes
                    the sum (printed as ``timed_cycles``)
    group64         fold with 64 blocks per level-1 group instead of 32
    early_level2    the last group-finisher, seeing every other group
                    arrived (a relaxed read beside its row loads), sums
                    level 2 without its group row and second ticket

no_ticket and ticket_no_tail leave stats wrong and serve only to split the
fold's cost into its parts; the others are checked bit-exact against
`ordered_stats_sum` over the rows they left. Prints one JSON line per
(stage, variant) and a summary, and writes the record to
``chiprun_out/stats_fold_ab.json``. The card's name and power limit head
the output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ((32, 64), (16, 128), (8, 256), (4, 512))  # (H = W, C)
B = 128
CONV, HDR = "conv_block.cu", "ordered_reduce.cuh"
DRAW = "    ticket = tpu_dp::draw_ticket(tick + grp);\n"
LAST = "  if (!tpu_dp::drew_last(ticket, g_rows)) return;\n"
NEVER_LAST = ("  if (__syncthreads_or(tid == 0 && ticket == -5)) return;\n"
              "  return;\n")
# Clock stamps (SM cycles) in the block that finishes the fold, written to
# tickets[DBG:DBG + 10]: block start -> epilogue, then from the epilogue
# start: ticket drawn, y stored, level-1 ticket read, level-1 sum stored,
# level-2 ticket read, level-2 sum stored; the block, the groups, and the
# return of one probe load of a level-1 row.
DBG = 8192
_DUMP = ("    int* dbg = a.tickets + %d;\n    dbg[0] = (int)(ts[0] - t_start);\n"
         "    for (int i = 1; i < 7; ++i) dbg[i] = (int)(ts[i] - ts[0]);\n"
         "    dbg[7] = blockIdx.x;\n    dbg[8] = n_groups;\n"
         "    dbg[9] = (int)(t_probe - ts[0]);\n" % DBG)
TIMED = [
    (CONV, "  const int tid = threadIdx.x;\n",
     "  const int tid = threadIdx.x;\n  const long long t_start = clock64();\n"),
    (CONV, "  int ticket = 0;\n",
     "  int ticket = 0;\n  long long ts[7] = {clock64(), 0, 0, 0, 0, 0, 0};\n"),
    (CONV, DRAW, DRAW + "    ts[1] = clock64();\n"),
    (CONV, "  if (!a.stats_on) return;\n",
     "  ts[2] = clock64();\n  if (!a.stats_on) return;\n"),
    (CONV, LAST, LAST + "  ts[3] = clock64();\n"
     "  long long t_probe = 0;\n  if (tid == 0) {\n"
     "    const float f0 = tpu_dp::load_relaxed_gpu_if(a.partials + first * "
     "row_len, true);\n    if (f0 == 1234.5f) a.stats[0] = 0.f;\n"
     "    t_probe = clock64();\n  }\n"),
    (CONV, "  if (tid == 0) tpu_dp::reset_counter(tick + grp);\n",
     "  ts[4] = clock64();\n  if (tid == 0) tpu_dp::reset_counter(tick + grp);\n"
     "  if (n_groups == 1 && tid == 0) {\n" + _DUMP + "  }\n"),
    (CONV, "n_groups))\n    return;\n",
     "n_groups))\n    return;\n  ts[5] = clock64();\n"),
    (CONV, "  if (tid == 0) tpu_dp::reset_counter(tick + n_groups);\n",
     "  ts[6] = clock64();\n  if (tid == 0) {\n" + _DUMP + "  }\n"
     "  if (tid == 0) tpu_dp::reset_counter(tick + n_groups);\n"),
]

# The last group-finisher, when it sees every other group already arrived,
# finishes level 2 without its group row and second ticket.
_TAIL = "  // Level 1: the last block of this group sums the group's rows in order.\n  if (!tpu_dp::drew_last(ticket, g_rows)) return;\n  float* group_rows = a.partials + nbx * row_len;\n  if (tid < 2 * BN) {\n    const float t = tpu_dp::ordered_sum(\n        a.partials + first * row_len + m * C + n0 + col, row_len, g_rows);\n    if (n_groups == 1)\n      a.stats[m * C + n0 + col] = t;\n    else\n      group_rows[grp * row_len + m * C + n0 + col] = t;\n  }\n  if (tid == 0) tpu_dp::reset_counter(tick + grp);\n  if (n_groups == 1) return;\n  // Level 2: the last group-finisher of this column sums the group rows.\n  if (!tpu_dp::drew_last(tpu_dp::draw_ticket(tick + n_groups), n_groups))\n    return;\n  if (tid < 2 * BN)\n    a.stats[m * C + n0 + col] = tpu_dp::ordered_sum(\n        group_rows + m * C + n0 + col, row_len, n_groups);\n  if (tid == 0) tpu_dp::reset_counter(tick + n_groups);\n}\n\n"
_EARLY_TAIL = "  // Level 1: the last block of this group sums the group's rows in order.\n  if (!tpu_dp::drew_last(ticket, g_rows)) return;\n  float* group_rows = a.partials + nbx * row_len;\n  // How many other groups have finished, read beside the row loads: if all\n  // have, this block finishes level 2 as well, without writing its group\n  // row or drawing a second ticket.\n  int arrived = 0;\n  if (tid == 0 && n_groups > 1)\n    arrived = tpu_dp::load_relaxed_gpu(tick + n_groups);\n  float t = 0.f;\n  if (tid < 2 * BN)\n    t = tpu_dp::ordered_sum(a.partials + first * row_len + m * C + n0 + col,\n                            row_len, g_rows);\n  if (tid == 0) tpu_dp::reset_counter(tick + grp);\n  if (n_groups == 1) {\n    if (tid < 2 * BN) a.stats[m * C + n0 + col] = t;\n    return;\n  }\n  if (!tpu_dp::drew_last(arrived, n_groups)) {\n    if (tid < 2 * BN) group_rows[grp * row_len + m * C + n0 + col] = t;\n    // Level 2: the last group-finisher of this column sums the group rows.\n    if (!tpu_dp::drew_last(tpu_dp::draw_ticket(tick + n_groups), n_groups))\n      return;\n  }\n  if (tid < 2 * BN)\n    a.stats[m * C + n0 + col] = tpu_dp::ordered_sum(\n        group_rows + m * C + n0 + col, row_len, n_groups, grp, t);\n  if (tid == 0) tpu_dp::reset_counter(tick + n_groups);\n}\n\n"
_H1, _H1_NEW = "template <int kU = 32>\n__device__ __forceinline__ float ordered_sum(const float* p, long long stride,\n                                             int n) {", "__device__ __forceinline__ int load_relaxed_gpu(const int* p) {\n  int v;\n  asm volatile(\"ld.relaxed.gpu.global.b32 %0, [%1];\\n\"\n               : \"=r\"(v)\n               : \"l\"(p)\n               : \"memory\");\n  return v;\n}\n\ntemplate <int kU = 32>\n__device__ __forceinline__ float ordered_sum(const float* p, long long stride,\n                                             int n, int own = -1,\n                                             float own_value = 0.f) {"
_H2, _H2_NEW = "      v[u] = load_relaxed_gpu_if(p + (long long)(r0 + u) * stride,\n                                 r0 + u < n);", "      v[u] = load_relaxed_gpu_if(p + (long long)(r0 + u) * stride,\n                                 r0 + u < n && r0 + u != own);"
_H3, _H3_NEW = "      if (r0 + u < n) t = __fadd_rn(t, v[u]);", "      if (r0 + u < n) t = __fadd_rn(t, r0 + u == own ? own_value : v[u]);"

#: variant -> {"patches": [(file, old, new)], "group": rows per group}
VARIANTS = {
    "fold": {"patches": []},
    # Partial rows only, as before the fold (stats not summed).
    "no_ticket": {"patches": [(CONV, DRAW, ""), (CONV, LAST, "  return;\n")]},
    # The ticket drawn and waited for, never last: no tail.
    "ticket_no_tail": {"patches": [(CONV, LAST, NEVER_LAST)]},
    # y not stored in stats launches: the tail without y's drain.
    "no_y_stores": {"patches": [
        (CONV, "      if (p < total_px)\n        store_pair(",
         "      if (p < total_px && !a.stats_on)\n        store_pair(")]},
    "timed": {"patches": TIMED},
    "group64": {"patches": [], "group": 64},
    "early_level2": {"patches": [
        (CONV, _TAIL, _EARLY_TAIL), (HDR, _H1, _H1_NEW), (HDR, _H2, _H2_NEW),
        (HDR, _H3, _H3_NEW)]},
}


def _build(variants, out_dir):
    from tpu_dp_torch.ops import _build as tb

    src_dir = os.path.join(ROOT, "tpu_dp_torch", "ops", "csrc")
    procs = {}
    for name, spec in variants.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        for f in os.listdir(src_dir):
            shutil.copy(os.path.join(src_dir, f), vdir)
        for fname, old, new in spec["patches"]:
            fpath = os.path.join(vdir, fname)
            text = open(fpath).read()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: patch target not found once in "
                                 f"{fname}:\n{old}")
            open(fpath, "w").write(text.replace(old, new))
        path = os.path.join(vdir, "conv_block.cu")
        so = os.path.join(vdir, "conv_block.so")
        procs[name] = (so, subprocess.Popen(
            [tb.find_nvcc(), *tb.NVCC_FLAGS, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        fn = lib.tpu_dp_conv_block
        fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _build_parent(root):
    """The parent's kernel library: ``(conv, reduce, partials_rows)``."""
    from tpu_dp_torch.ops import _build as tb

    src = os.path.join(root, "tpu_dp_torch", "ops", "csrc", "conv_block.cu")
    so = os.path.join(ROOT, "build", "stats_fold_ab", "parent.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    subprocess.run([tb.find_nvcc(), *tb.NVCC_FLAGS, "-o", so, src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    conv, red = lib.tpu_dp_conv_block, lib.tpu_dp_conv_stats_reduce
    conv.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p] * 8
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    red.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    rows = lib.tpu_dp_conv_block_partials_rows
    rows.argtypes = [ctypes.c_int] * 4
    conv.restype = red.restype = rows.restype = ctypes.c_int
    return conv, red, rows


def _parent_launches(parent, x, wk, scale, shift, y, stream):
    """The parent's stats launch + its reduce launch, and its stats-off
    launch, keyed like the variants' launches."""
    import torch

    conv, red, rows = parent
    b, h, w, c = x.shape
    nb = rows(b, h, w, c)
    part = torch.empty((nb, 2, c), device="cuda")
    stats = torch.empty((2, c), device="cuda")
    out = {}
    for on in (True, False):
        a = (0, 0, 0, 1, int(on), x.data_ptr(), wk.data_ptr(),
             scale.data_ptr(), shift.data_ptr(), None, y.data_ptr(), None,
             part.data_ptr() if on else None, b, h, w, c, stream)

        def launch(a=a, on=on):
            if conv(*a) != 0 or (on and red(part.data_ptr(), stats.data_ptr(),
                                            nb, c, stream) != 0):
                raise RuntimeError("parent launch failed")
        out[("parent", on)] = (launch, None, part)
    return out


def _loop_ms(fn, n=20, reps=7, warm=3):
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3,
                    help="turns over the variants per stage")
    ap.add_argument("--parent", default=None,
                    help="checkout of the kernel before the fold")
    args = ap.parse_args()
    import torch

    from tpu_dp_torch.ops import conv_block as cb

    if not torch.cuda.is_available():
        raise SystemExit("port_stats_fold_ab: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    libs = _build(VARIANTS, os.path.join(ROOT, "build", "stats_fold_ab"))
    parent = _build_parent(args.parent) if args.parent else None
    print(f"built {len(libs) + (parent is not None)} variants in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows_out = []
    for stage, (h, c) in enumerate(STAGES):
        x = torch.randn(B, h, h, c, generator=gen, device="cuda")
        w = torch.randn(3, 3, c, c, generator=gen, device="cuda") * math.sqrt(
            2.0 / (9 * c))
        wk = cb.pack_weight(w)
        scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
        shift = 0.1 * torch.randn(c, generator=gen, device="cuda")
        y = torch.empty_like(x)
        stats = torch.empty((2, c), device="cuda")
        launches = {}
        for name, fn in libs.items():
            group = VARIANTS[name].get("group", cb.STATS_GROUP)
            rows, n_tick = cb.stats_scratch(B, h, h, c, group)
            part = torch.empty((rows, 2, c), device="cuda")
            tick = torch.zeros(max(n_tick, DBG + 16), dtype=torch.int32,
                               device="cuda")
            for on in (True, False):
                a = (0, 0, 0, 1, int(on), x.data_ptr(), wk.data_ptr(),
                     scale.data_ptr(), shift.data_ptr(), None, y.data_ptr(),
                     None, part.data_ptr(), stats.data_ptr(),
                     tick.data_ptr(), B, h, h, c, rows, n_tick, group,
                     stream)

                def launch(fn=fn, a=a):
                    if fn(*a) != 0:
                        raise RuntimeError("launch failed")
                launches[(name, on)] = (launch, tick, part)
        if parent is not None:
            launches.update(_parent_launches(parent, x, wk, scale, shift, y,
                                             stream))
        times = {k: [] for k in launches}
        for _ in range(args.reps):
            for k, (launch, _, _) in launches.items():
                times[k].append(_loop_ms(launch))
        # Stats of the variants that sum them: bit-exact with the
        # plain replay of their order over the rows they left.
        exact = {}
        for name in libs:
            if name in ("no_ticket", "ticket_no_tail"):
                continue
            launch, _, part = launches[(name, True)]
            launch()
            torch.cuda.synchronize()
            group = VARIANTS[name].get("group", cb.STATS_GROUP)
            tile = cb.tile_of(B, h, h, c)
            nbx = tile["blocks"] // (c // tile["bn"])
            exact[name] = bool(torch.equal(
                stats, cb.ordered_stats_sum(part[:nbx], group)))
            if name.endswith("timed"):
                stamps = launches[(name, True)][1][DBG:DBG + 10].tolist()
                print(json.dumps({"stage": stage, "variant": name,
                                  "timed_cycles": dict(zip(
                    ("start_to_epilogue", "ticket_drawn", "y_stored",
                     "level1_ticket_read", "level1_stored",
                     "level2_ticket_read", "level2_stored", "block",
                     "groups", "level1_first_load"), stamps))}))
        for name in list(libs) + (["parent"] if parent else []):
            on = min(times[(name, True)])
            off = min(times[(name, False)])
            rec = {"stage": stage, "shape": [B, h, h, c], "variant": name,
                   "stats_ms": on, "nostats_ms": off, "extra_ms": on - off,
                   "stats_eq_ordered_sum": exact.get(name), "card": card}
            print(json.dumps(rec))
            rows_out.append(rec)
    summary = {}
    for name in list(libs) + (["parent"] if parent else []):
        summary[name] = {
            "extra_ms_by_stage": [r["extra_ms"] for r in rows_out
                                  if r["variant"] == name],
            # one train forward: stage 0 x4, 1 x2, 2 x2, 3 x2
            "stats_ms_forward": sum(
                r["stats_ms"] * (4 if r["stage"] == 0 else 2)
                for r in rows_out if r["variant"] == name)}
    print(json.dumps({"summary": summary, "card": card}))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "stats_fold_ab.json"), "w",
              encoding="utf-8") as f:
        json.dump({"card": card, "rows": rows_out, "summary": summary}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
