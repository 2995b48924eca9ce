"""On-card smoke of the PyTorch/CUDA port (`tpu_dp_torch`): run from the
repository root on a machine with one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. header: the card (torch and ``nvidia-smi``); no CUDA → exit 1;
2. build: every kernel of the port (conv_block.cu, xent.cu), one nvcc per
   source, started together; each conv instance's registers, spills and
   static shared memory from the ptxas report;
3. kernel vs plain, eval: the conv kernel's public wrappers against its
   plain PyTorch version on the card, at B=32 for the four ResNet-18 shapes
   x the three eval variants x f32/bf16 inputs (tolerance: one bf16 ulp at
   the output's magnitude), with CUDA-event times of the kernel
   (back-to-back launches through its C entry; ``wrapper_ms`` is one
   public-wrapper call per event pair), the plain version and one cuDNN
   conv of the same size (``library_ms``) beside the bound and the tile
   the kernel picked; then the same checks,
   untimed, at the serve ladder's other buckets (1, 2, 4, 8, 16), where
   tiles are only partly filled;
4. kernel vs plain, train, at the training batch B=128 for the four
   stages: the ``emit_stats`` conv (emit_z and residual on or off, f32; y
   within one ulp, stats within 1e-5 * sum|y| of the plain sums of the
   kernel's own y), and its stats fold three ways: bit-exact against
   ``ordered_stats_sum`` replayed on the card over the partial rows the
   same launch left in its scratch, and bit-identical across two launches,
   across three replays of a CUDA graph of one ``fused_conv_bn`` call and
   on a launch made while a large matmul runs on a side stream (blocks
   finish in another order); the fold's cost (``emit_stats`` time minus
   the stats-off time of the same shape, both through the C entry); the
   input-grad reuse (bf16 ct, flipped weight, no activation; one ulp), the
   autograd rule's five gradients against the plain version's autograd
   (max|g - g_plain| <= 2e-2 * max|g_plain|), and the xent kernels: per
   example forward and backward at C = 10 and 100 (f32 within 1e-6), the
   batch-mean variants at B = 1, 7, 128, 1000 (within 1e-6 of the plain
   versions, loss bit-identical across launches, gradient bit-identical to
   the per-example kernel + torch mean + MeanBackward route) and, untimed,
   labels outside [0, C) (the JAX kernels' logsumexp loss and softmax * ct
   gradient); ragged batches B = 1, 3, 127 at every stage (emit_stats: y
   one ulp, z equal, the same three fold checks; input-grad one ulp); the
   host microseconds of one wrapper call and of the C entry alone;
   each timed beside its bound, its plain version and one library call
   (cuDNN bf16 conv2d / conv2d_input, torch.sum, F.cross_entropy) — the
   convs by CUDA events over back-to-back launches, the microsecond xent
   kernels and sums by their device time under the profiler (an event
   loop would time the host's launch rate, which is also recorded);
5. serve: the full-width fused CIFAR ResNet-18 (f32, random weights and
   random BN statistics from a seed) behind `InferenceEngine` with
   buckets 1..32, 200 Poisson requests of 1-4 images: audited books, the
   device class histogram equal to the handles' predictions, exactly 10
   kernel launches per forward, and bucket-32 logits equal to the same
   weights run unfused (cuDNN) within 1e-2 of their magnitude;
6. train: `Trainer` on ``--preset=resnet18_cifar10 --model.fused_stages=all
   --model.fused_bwd=true --train.pallas_xent=true`` at full width (f32,
   batch 128, synthetic data), 30 steps and one eval: finite losses that
   fall, exactly 20 conv-kernel launches and 2 xent launches per step
   (and the same 20 + 2 by kernel name under the profiler, with no stats
   reduce kernel) and 10 per eval forward, the first 5 losses within
   0.05 of the same init and batches run unfused without kernels, a
   number for the accuracy; step time, device-busy share, top kernels and
   peak memory;
7. data parallel (`tpu_dp_torch.parallel`), full width, f32, B=128 per
   rank, against one process on the concatenated batch (per-step global
   loss within 0.05, the fused bound of phase 6) with the ranks'
   parameters and buffers bit-identical and each rank's books per step
   (20 conv launches, 1 + 1 xent, 20 + 20 sync-BN pmeans, one metrics
   all-reduce, DDP's buckets): (a) two ranks on the one card through
   gloo on CUDA tensors (NCCL refuses two ranks on one card; a
   correctness run, its step time no DDP figure); (b) `Trainer` at world 1
   on NCCL through `initialize()` and the env contract, 30 steps and one
   eval (falling loss, eval count = test set), its step beside phase 6's
   and, in turns on one model, the step with and without DDP's wrapper;
   (c) with two or more cards, NCCL with one rank per card (two, and every
   visible card), else ``ddp_nccl_multi_card: not run, 1 card visible``;
8. the kernels' JSON line, then ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --only ddp_nccl_world1,ddp_nccl_multi_card`` runs
the header, the build and the named phases alone (a four-card machine's
multi-card check), without the kernels' line. ``--ddp-worker SPEC`` is
phase 7's rank process.

Every timed case also prints ``bound_share`` (bound_ms / ms) and
``vs_library`` (ms / library_ms).

TF32 is off for every phase (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``): f32 means f32 in the plain
version and in the unfused reference. The full record also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
#: outside the tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
B = 32
#: the serve ladder's other buckets, checked against the plain version.
SMALL_BUCKETS = (1, 2, 4, 8, 16)
STAGES = ((32, 64), (16, 128), (8, 256), (4, 512))  # (H = W, C)
VARIANTS = ("plain", "emit_z", "emit_z+res")
#: one B=32 full-fused ResNet-18 forward: (stage, variant) per launch.
FORWARD_CALLS = ((0, "emit_z"), (0, "plain"), (0, "emit_z+res"),
                 (0, "plain"), (1, "emit_z"), (1, "plain"),
                 (2, "emit_z"), (2, "plain"), (3, "emit_z"), (3, "plain"))
KERNEL = "conv_block.fused_affine_relu_conv"
#: the training batch, and the variants of one train forward's 10
#: emit_stats launches (the same pattern as FORWARD_CALLS).
TRAIN_B = 128
TRAIN_VARIANTS = ("plain", "emit_z", "res", "emit_z+res")
#: ragged batches: the new tile's partly filled edges (untimed checks).
RAGGED_B = (1, 3, 127)
#: one train step's 10 input-grad launches, by stage.
INPUT_GRAD_STAGES = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3)
XENT_CLASSES = (10, 100)
#: batches of the xent batch-mean checks (C = 10); timed at TRAIN_B.
XENT_MEAN_B = (1, 7, TRAIN_B, 1000)
TRAIN_STEPS = 30
#: phase 7: updates of the two-rank parity runs, their ranks, and the
#: schedule of the preset's first steps (cosine, 1 warmup step of 30).
DDP_STEPS = 5
DDP_WORLD = 2
DDP_SCHED = ("cosine", 0.1, 30, 1, 0.0)
#: the fused bound of tests/test_models.py and PERF.md §2.
DDP_LOSS_TOL = 0.05
TRAIN_ARGS = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
              "--model.fused_bwd=true", "--train.pallas_xent=true",
              "--data.dataset=synthetic", f"--data.batch_size={TRAIN_B}",
              f"--data.synthetic_train_size={TRAIN_STEPS * TRAIN_B}",
              f"--data.synthetic_test_size={2 * TRAIN_B}",
              "--train.epochs=1", "--train.log_every=10"]


def bf16_ulp(mag: float) -> float:
    """One bf16 ulp at magnitude ``mag`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(mag)) - 7) if mag > 0 else 2.0 ** -133


def cuda_median_ms(fn, reps: int = 30, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_loop_ms(fn, n: int = 20, reps: int = 7, warm: int = 3) -> float:
    """Median over ``reps`` of the CUDA-event time of ``n`` back-to-back
    calls, per call: for kernels short enough that one call per event
    pair would time the host."""
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


def device_ms(fn, n: int = 20) -> float:
    """Device time per call of ``fn``: the time of every device kernel its
    ``n`` calls launch, from the profiler, over ``n``. For microsecond
    kernels, where a CUDA-event loop times the host's launch rate."""
    return profile_forward(fn, n)["device_busy_us_per_call"] / 1e3


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    """``(bound_ms, bound_by)``: the larger of bytes over HBM rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def with_ratios(rec: dict) -> dict:
    """Adds ``bound_share`` (bound_ms / ms: the share of the card's least
    time the kernel reaches) and ``vs_library`` (ms / library_ms: above 1
    the kernel is slower than the one PyTorch call) where both exist."""
    if rec.get("ms") and rec.get("bound_ms") is not None:
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    if rec.get("ms") and rec.get("library_ms"):
        rec["vs_library"] = rec["ms"] / rec["library_ms"]
    return rec


def phase_header(out):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from tpu_dp_torch.parallel.dist import describe

    out["card"] = smi
    out["describe"] = describe()
    print(f"[header] {json.dumps(out['describe'])}")
    print(f"[header] nvidia-smi: {smi}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_build(out):
    from tpu_dp_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    out["build_s"] = round(time.perf_counter() - t0, 3)
    for name, rec in info.items():
        print(f"[build] {name}: {rec['seconds']} s "
              f"(cached={rec['cached']})")
    out["conv_instances"] = conv_instances(info["conv_block"]["log"])
    for inst in out["conv_instances"]:
        print("[build] " + json.dumps(inst))
    spills = [i for i in out["conv_instances"] if i["spill_bytes"]]
    print(f"[build] total {out['build_s']} s; "
          f"{len(out['conv_instances'])} conv instances, "
          f"{len(spills)} with spills")


def conv_instances(log: str) -> list:
    """Registers, spills and static shared memory of each conv kernel
    instance, from the ptxas report (``-Xptxas -v``)."""
    import re

    insts, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = None
            if "conv_block_kernel" in m.group(1):
                t = re.search(r"conv_block_kernelI(\w+?)Li(\d+)ELi(\d+)E",
                              m.group(1))
                cur = {"instance": m.group(1),
                       "dtype": "float32" if t and t.group(1) == "f"
                       else "bfloat16",
                       "bm": int(t.group(2)) if t else None,
                       "bn": int(t.group(3)) if t else None,
                       "spill_bytes": 0}
                insts.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return insts


def _case_inputs(gen, b, h, c, dtype, with_res):
    import torch

    dev = "cuda"
    x = torch.randn(b, h, h, c, generator=gen, device=dev).to(dtype)
    w = torch.randn(3, 3, c, c, generator=gen, device=dev) * math.sqrt(
        2.0 / (9 * c))
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=dev)
    shift = 0.1 * torch.randn(c, generator=gen, device=dev)
    res = (torch.randn(b, h, h, c, generator=gen, device=dev).to(dtype)
           if with_res else None)
    return x, w, scale, shift, res


def _compare(cb, b, stage, dtype, variant, gen):
    """One kernel-vs-plain case through the public wrappers; returns the
    record and the inputs (the packed weight, as the model passes it)."""
    import torch

    h, c = STAGES[stage]
    emit = variant != "plain"
    x, w, scale, shift, res = _case_inputs(
        gen, b, h, c, dtype, variant == "emit_z+res")
    wk = cb.pack_weight(w)
    wrapper = (cb.fused_affine_relu_conv_emit if emit
               else cb.fused_affine_relu_conv)
    got = wrapper(x, wk, scale, shift, res)
    ref = cb.reference_affine_relu_conv(x, w, scale, shift, res, True, emit)
    torch.cuda.synchronize()
    gy, ry = (got[0], ref[0]) if emit else (got, ref)
    ry32, gy32 = ry.float(), gy.float()
    tol = bf16_ulp(ry32.abs().max().item())
    err = (gy32 - ry32).abs().max().item()
    rec = {
        "stage": stage, "shape": [b, h, h, c],
        "dtype": str(dtype).replace("torch.", ""),
        "variant": variant,
        "max_abs_err": err, "tol": tol,
        "bit_equal_share": (gy32 == ry32).float().mean().item(),
        "finite": bool(torch.isfinite(gy32).all()),
    }
    if emit:
        zerr = (got[1].float() - ref[1].float()).abs().max()
        rec["z_max_abs_err"] = zerr.item()
        rec["z_tol"] = bf16_ulp(ref[1].float().abs().max().item())
    rec["ok"] = (rec["finite"] and err <= tol
                 and rec.get("z_max_abs_err", 0.0) <= rec.get("z_tol", 1.0))
    return rec, (wrapper, x, w, wk, scale, shift, res, ref)


def phase_kernels(out):
    import torch
    import torch.nn.functional as F

    from tpu_dp_torch.ops import conv_block as cb

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        for stage, (h, c) in enumerate(STAGES):
            for variant in VARIANTS:
                emit = variant != "plain"
                rec, (wrapper, x, w, wk, scale, shift, res, ref) = _compare(
                    cb, B, stage, dtype, variant, gen)
                ok &= rec["ok"]
                z = ref[1] if emit else cb._reference_z(
                    x, scale, shift, res).to(dtype)
                zl = z.to(torch.bfloat16).permute(0, 3, 1, 2)
                wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                # Kernel time: back-to-back launches through the C entry,
                # as in phase 4. `wrapper_ms` is one public-wrapper call
                # per event pair, which also counts the wrapper's host
                # time whenever that exceeds the kernel's.
                launch, _ = _direct_conv(cb, x, wk, scale, shift, res, emit,
                                         False)
                rec["ms"] = cuda_loop_ms(launch)
                rec["wrapper_ms"] = cuda_median_ms(
                    lambda: wrapper(x, wk, scale, shift, res))
                rec["plain_ms"] = cuda_median_ms(
                    lambda: cb.reference_affine_relu_conv(
                        x, w, scale, shift, res, True, emit))
                rec["library_ms"] = cuda_loop_ms(
                    lambda: F.conv2d(zl, wl, padding=1))
                esize = x.element_size()
                n = B * h * h * c
                nbytes = (n * esize * (2 + emit + (res is not None))
                          + wk.numel() * 2 + 2 * c * 4)
                flops = 2.0 * B * h * h * 9 * c * c
                t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
                rec["bytes"], rec["flops"] = nbytes, flops
                rec["bound_ms"] = max(t_bytes, t_ops) * 1e3
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                rec["tile"] = cb.tile_of(B, h, h, c)
                print("[kernel] " + json.dumps(with_ratios(rec)))
                cases.append(rec)
    # The serve ladder's smaller buckets: the same checks, untimed. At
    # stage 3 a 64-pixel tile holds four 4x4 images, so B=1 and B=2 leave
    # image slots of the last tile empty.
    small = []
    for b in SMALL_BUCKETS:
        for dtype in (torch.float32, torch.bfloat16):
            for stage in range(len(STAGES)):
                for variant in VARIANTS:
                    rec, _ = _compare(cb, b, stage, dtype, variant, gen)
                    ok &= rec["ok"]
                    if not rec["ok"]:
                        print("[kernel] FAILED " + json.dumps(rec))
                    small.append(rec)
        worst = max((r for r in small if r["shape"][0] == b),
                    key=lambda r: r["max_abs_err"] / r["tol"])
        print(f"[kernel] B={b}: {2 * len(STAGES) * len(VARIANTS)} "
              f"cases, worst max_abs_err {worst['max_abs_err']} "
              f"(tol {worst['tol']}, {worst['dtype']} stage "
              f"{worst['stage']} {worst['variant']})")
    out["kernel_cases"] = cases
    out["kernel_small_bucket_cases"] = small
    if not ok:
        raise AssertionError("conv kernel disagrees with its plain version")
    print(f"[kernel] all {len(cases)} B={B} cases and {len(small)} "
          f"small-bucket cases within one bf16 ulp")


def _direct_conv(cb, x, wk, scale, shift, res, emit_z, stats, act=True):
    """One launch of the conv kernel alone through its C entry, on buffers
    allocated once (no wrapper): for timing and, with ``stats``, to read
    the partial rows the launch leaves in its scratch. Returns ``(launch,
    scratch)``: scratch is None, or ``{"partials": the launch's [nbx, 2,
    C] block rows, "stats": [2, C]}``."""
    import torch

    from tpu_dp_torch.ops import _tickets

    b, h, w, c = x.shape
    y = torch.empty_like(x)
    z = torch.empty_like(x) if emit_z else None
    rows, n_tick = cb.stats_scratch(b, h, w, c)
    part = st = tick = scratch = None
    if stats:
        tile = cb.tile_of(b, h, w, c)
        part = torch.empty((rows, 2, c), device=x.device)
        st = torch.empty((2, c), device=x.device)
        tick = _tickets.tickets(x.device, n_tick)
        scratch = {"partials": part[:tile["blocks"] // (c // tile["bn"])],
                   "stats": st}
    conv = cb._kernel()
    stream = torch.cuda.current_stream().cuda_stream
    ptr = (lambda t: None if t is None else t.data_ptr())
    args = (cb._DTYPES[x.dtype], res is not None, emit_z, act, stats,
            x.data_ptr(), wk.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            ptr(res), y.data_ptr(), ptr(z), ptr(part), ptr(st), ptr(tick),
            b, h, w, c, rows, n_tick, cb.STATS_GROUP, stream)

    def launch():
        if conv(*args) != 0:
            raise RuntimeError("conv_block launch failed")
    return launch, scratch


def _fold_checks(cb, x, wk, scale, shift, res, emit, st, big, side):
    """The stats fold of one ``emit_stats`` case whose wrapper call gave
    ``st``: bit-exact against `ordered_stats_sum` over the rows a launch
    through the C entry left in its scratch, and bit-identical over three
    replays of a CUDA graph of one wrapper call (captured on the stream
    ``side``) and on a wrapper call made while ``big @ big`` runs on
    ``side``. One side stream serves every case: cuBLAS keeps a workspace
    per stream for the life of the process."""
    import torch

    launch, scr = _direct_conv(cb, x, wk, scale, shift, res, emit, True)
    launch()
    torch.cuda.synchronize()
    rec = {"stats_eq_ordered_sum": bool(torch.equal(
               scr["stats"], cb.ordered_stats_sum(scr["partials"]))),
           "c_entry_eq_wrapper": bool(torch.equal(scr["stats"], st)),
           "partial_rows": scr["partials"].shape[0]}
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the stream's tickets, outside capture
        cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)
    same = []
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        same.append(bool(torch.equal(out[-1], st)))
    rec["graph_replays_identical"] = all(same)
    del graph, out
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        busy = big @ big
    got = cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)[-1]
    torch.cuda.synchronize()
    rec["side_stream_identical"] = bool(torch.equal(got, st))
    del busy
    rec["fold_ok"] = all(rec[k] for k in (
        "stats_eq_ordered_sum", "c_entry_eq_wrapper",
        "graph_replays_identical", "side_stream_identical"))
    return rec


def _grad_check(cb, x, w, scale, shift, res, gen):
    """The autograd rule's five gradients (fused_conv_bn, emit_z, residual,
    pallas_bwd) against autograd through the plain version."""
    import torch

    b, h, _, c = x.shape
    probes = [torch.randn(x.shape, generator=gen, device="cuda"),
              torch.randn(x.shape, generator=gen, device="cuda"),
              torch.randn(2, c, generator=gen, device="cuda") / (b * h * h)]
    grads = []
    for fn in ("kernel", "plain"):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, w, scale, shift, res)]
        if fn == "kernel":
            out = cb.fused_conv_bn(*leaves, pallas_bwd=True, emit_z=True)
        else:
            out = cb.reference_affine_relu_conv(*leaves, emit_z=True,
                                                emit_stats=True)
        sum((o * p).sum() for o, p in zip(out, probes)).backward()
        grads.append([t.grad for t in leaves])
    errs = {}
    for name, g, r in zip(("x", "w", "scale", "shift", "res"), *grads):
        errs[name] = ((g - r).abs().max() / r.abs().max()).item()
    return errs


def _ragged_cases(cb, gen, big, side):
    """Untimed emit_stats (emit_z + residual, f32) and input-grad (bf16)
    cases at the ragged batches, every stage: the tile's partly filled
    edges. y within one ulp, z equal, stats bit-identical over two
    launches, the fold's checks (`_fold_checks`) and within 1e-5 * sum|y|
    of the plain sums of the kernel's own y; input-grad within one ulp."""
    import torch

    recs = []
    for b in RAGGED_B:
        for stage, (h, c) in enumerate(STAGES):
            x, w, scale, shift, res = _case_inputs(gen, b, h, c,
                                                   torch.float32, True)
            got = cb.fused_conv_bn(x, w, scale, shift, res, emit_z=True)
            again = cb.fused_conv_bn(x, w, scale, shift, res, emit_z=True)
            ref = cb.reference_affine_relu_conv(x, w, scale, shift, res,
                                                emit_z=True, emit_stats=True)
            ct = torch.randn(b, h, h, c, generator=gen,
                             device="cuda").to(torch.bfloat16)
            wf = cb.flip_packed(w)
            one = torch.ones(c, device="cuda")
            zero = torch.zeros(c, device="cuda")
            dz = cb._run(ct, wf, one, zero, None, False, False,
                         role="input_grad")
            dzr = cb.reference_affine_relu_conv(ct, wf, one, zero,
                                                activate=False)
            torch.cuda.synchronize()
            y, st = got[0], got[-1]
            yabs = torch.stack([y.abs().sum((0, 1, 2)),
                                (y * y).sum((0, 1, 2))])
            rec = {"kind": "ragged", "stage": stage, "shape": [b, h, h, c],
                   "tile": cb.tile_of(b, h, h, c),
                   "max_abs_err": (y - ref[0]).abs().max().item(),
                   "tol": bf16_ulp(ref[0].abs().max().item()),
                   "z_equal": bool(torch.equal(got[1], ref[1])),
                   "stats_rel_err": ((st - cb._stats_of(y)).abs()
                                     / yabs.clamp(min=1e-30)).max().item(),
                   "stats_bit_identical": bool(torch.equal(st, again[-1])),
                   "input_grad_max_abs_err":
                       (dz.float() - dzr.float()).abs().max().item(),
                   "input_grad_tol": bf16_ulp(dzr.float().abs().max().item())}
            rec.update(_fold_checks(cb, x, cb.pack_weight(w), scale, shift,
                                    res, True, st, big, side))
            rec["ok"] = (rec["max_abs_err"] <= rec["tol"] and rec["z_equal"]
                         and rec["stats_rel_err"] <= 1e-5
                         and rec["stats_bit_identical"] and rec["fold_ok"]
                         and rec["input_grad_max_abs_err"]
                         <= rec["input_grad_tol"])
            print("[ragged] " + json.dumps(rec))
            recs.append(rec)
    return recs


def _host_us(fn, n: int = 50) -> float:
    """Median host microseconds of one call of ``fn`` (no synchronise: the
    time the caller's thread spends to enqueue it)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def phase_train_kernels(out):
    import torch
    import torch.nn.functional as F

    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx

    gen = torch.Generator(device="cuda").manual_seed(1)
    # Side-stream load for the fold's concurrency check: ~1 ms of bf16
    # tensor-core work on every SM.
    big = torch.randn(8192, 8192, generator=gen, device="cuda").to(
        torch.bfloat16)
    side = torch.cuda.Stream()
    cases, ok = [], True
    for stage, (h, c) in enumerate(STAGES):
        n = TRAIN_B * h * h * c
        flops = 2.0 * TRAIN_B * h * h * 9 * c * c
        for variant in TRAIN_VARIANTS:
            emit, with_res = "emit_z" in variant, "res" in variant
            x, w, scale, shift, res = _case_inputs(
                gen, TRAIN_B, h, c, torch.float32, with_res)
            wk = cb.pack_weight(w)
            got = cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)
            again = cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)
            ref = cb.reference_affine_relu_conv(x, w, scale, shift, res,
                                                emit_z=emit, emit_stats=True)
            torch.cuda.synchronize()
            y, st = got[0], got[-1]
            tol = bf16_ulp(ref[0].abs().max().item())
            own = cb._stats_of(y)
            yabs = torch.stack([y.abs().sum((0, 1, 2)),
                                (y * y).sum((0, 1, 2))])
            rec = {
                "kind": "emit_stats", "stage": stage,
                "shape": [TRAIN_B, h, h, c], "variant": variant,
                "max_abs_err": (y - ref[0]).abs().max().item(), "tol": tol,
                "stats_rel_err": ((st - own).abs() / yabs).max().item(),
                "stats_bit_identical": bool(torch.equal(st, again[-1])),
                "y_bit_identical": bool(torch.equal(y, again[0])),
                "tile": cb.tile_of(TRAIN_B, h, h, c),
            }
            if emit:
                rec["z_equal"] = bool(torch.equal(got[1], ref[1]))
            rec.update(_fold_checks(cb, x, wk, scale, shift, res, emit, st,
                                    big, side))
            rec["ok"] = (rec["max_abs_err"] <= tol
                         and rec["stats_rel_err"] <= 1e-5
                         and rec["stats_bit_identical"]
                         and rec["y_bit_identical"]
                         and rec.get("z_equal", True) and rec["fold_ok"])
            launch, scratch = _direct_conv(cb, x, wk, scale, shift, res,
                                           emit, True)
            off, _ = _direct_conv(cb, x, wk, scale, shift, res, emit, False)
            zl = ref[1] if emit else cb._reference_z(x, scale, shift, res)
            zl = zl.to(torch.bfloat16).permute(0, 3, 1, 2)
            wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            # The fold's cost: the same launch with stats on and off, in
            # turns (on, off, on, off), the faster of each pair.
            on1, off1 = cuda_loop_ms(launch), cuda_loop_ms(off)
            on2, off2 = cuda_loop_ms(launch), cuda_loop_ms(off)
            rec["ms"], rec["nostats_ms"] = min(on1, on2), min(off1, off2)
            rec["fold_ms"] = rec["ms"] - rec["nostats_ms"]
            rec["plain_ms"] = cuda_median_ms(
                lambda: cb.reference_affine_relu_conv(
                    x, w, scale, shift, res, emit_z=emit, emit_stats=True),
                reps=10)
            rec["library_ms"] = cuda_loop_ms(
                lambda: F.conv2d(zl, wl, padding=1))
            nbytes = (n * 4 * (2 + emit + with_res) + wk.numel() * 2
                      + 2 * c * 4 + 2 * c * 4)
            rec["bytes"], rec["flops"] = nbytes, flops
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
            ok &= rec["ok"]
            print("[train-kernel] " + json.dumps(with_ratios(rec)))
            cases.append(rec)
        # The stats fold of this stage (its cost per variant is in the
        # emit_stats records): the sum it replaces, on the last case's
        # partial rows, timed as the plain version and the library call.
        partials = scratch["partials"]
        launch()
        torch.cuda.synchronize()
        nb = partials.shape[0]
        plain_sum = partials.sum(0)
        rbytes = partials.numel() * 4 + 2 * c * 4
        rec = {"kind": "stats_fold", "stage": stage, "partials": [nb, 2, c],
               "groups": -(-nb // cb.STATS_GROUP),
               "max_abs_err": (scratch["stats"] - cb.ordered_stats_sum(
                   partials)).abs().max().item(),
               "vs_sum_max_rel_err": ((scratch["stats"] - plain_sum).abs()
                                      / partials.abs().sum(0).clamp(
                                          min=1e-30)).max().item(),
               "fold_ms_by_variant": {r["variant"]: r["fold_ms"]
                                      for r in cases
                                      if r["kind"] == "emit_stats"
                                      and r["stage"] == stage},
               "plain_ms": device_ms(lambda: partials.sum(dim=0)),
               "library_ms": device_ms(lambda: torch.sum(partials, 0)),
               "bytes": rbytes, "flops": partials.numel()}
        rec["ok"] = (rec["max_abs_err"] == 0.0
                     and rec["vs_sum_max_rel_err"] <= 1e-6)
        rec["bound_ms"], rec["bound_by"] = bound(
            rbytes, partials.numel(), PEAK_F32_FLOPS)
        ok &= rec["ok"]
        print("[train-kernel] " + json.dumps(with_ratios(rec)))
        cases.append(rec)
        # The input-grad reuse: bf16 ct, flipped weight, no activation.
        ct = torch.randn(TRAIN_B, h, h, c, generator=gen,
                         device="cuda").to(torch.bfloat16)
        w = torch.randn(3, 3, c, c, generator=gen, device="cuda") * 0.05
        wf = cb.flip_packed(w)
        one = torch.ones(c, device="cuda")
        zero = torch.zeros(c, device="cuda")
        dz = cb._run(ct, wf, one, zero, None, False, False,
                     role="input_grad")
        ref = cb.reference_affine_relu_conv(ct, wf, one, zero,
                                            activate=False)
        torch.cuda.synchronize()
        tol = bf16_ulp(ref.float().abs().max().item())
        err = (dz.float() - ref.float()).abs().max().item()
        launch, _ = _direct_conv(cb, ct, wf, one, zero, None, False, False,
                                 act=False)
        ctl = ct.permute(0, 3, 1, 2)
        wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
        nbytes = n * 2 * 2 + wf.numel() * 2
        rec = {"kind": "input_grad", "stage": stage,
               "shape": [TRAIN_B, h, h, c], "max_abs_err": err, "tol": tol,
               "tile": cb.tile_of(TRAIN_B, h, h, c),
               "ok": err <= tol, "ms": cuda_loop_ms(launch),
               "plain_ms": cuda_median_ms(
                   lambda: cb.reference_affine_relu_conv(
                       ct, wf, one, zero, activate=False), reps=10),
               "library_ms": cuda_loop_ms(
                   lambda: torch.nn.grad.conv2d_input(
                       ctl.shape, wl, ctl, padding=1)),
               "bytes": nbytes, "flops": flops}
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        ok &= rec["ok"]
        print("[train-kernel] " + json.dumps(with_ratios(rec)))
        cases.append(rec)
        # The autograd rule against the plain version's autograd.
        x, w, scale, shift, res = _case_inputs(
            gen, TRAIN_B, h, c, torch.float32, True)
        errs = _grad_check(cb, x, w, scale, shift, res, gen)
        rec = {"kind": "grads", "stage": stage, "shape": [TRAIN_B, h, h, c],
               "normalized_err": errs, "tol": 2e-2,
               "ok": max(errs.values()) <= 2e-2}
        ok &= rec["ok"]
        print("[train-kernel] " + json.dumps(with_ratios(rec)))
        cases.append(rec)
    ragged = _ragged_cases(cb, gen, big, side)
    del big, side
    ok &= all(r["ok"] for r in ragged)
    out["ragged_cases"] = ragged
    print(f"[ragged] {len(ragged)} cases at B={list(RAGGED_B)}: "
          f"{'all ok' if all(r['ok'] for r in ragged) else 'FAILED'}")
    # Host cost of one call: the public wrapper (checks, allocation, the
    # one launch) and the C entry alone, stage 3.
    h, c = STAGES[3]
    x, w, scale, shift, res = _case_inputs(gen, TRAIN_B, h, c,
                                           torch.float32, False)
    wk = cb.pack_weight(w)
    launch, _ = _direct_conv(cb, x, wk, scale, shift, res, False, True)
    out["host_us"] = {
        "fused_conv_bn_wrapper": _host_us(
            lambda: cb.fused_conv_bn(x, wk, scale, shift)),
        "conv_c_entry": _host_us(launch),
        "shape": [TRAIN_B, h, h, c]}
    print("[host] " + json.dumps(out["host_us"]))
    for c in XENT_CLASSES:
        logits = 3.0 * torch.randn(TRAIN_B, c, generator=gen, device="cuda")
        labels = torch.randint(0, c, (TRAIN_B,), generator=gen,
                               device="cuda")
        ct = torch.rand(TRAIN_B, generator=gen, device="cuda") + 0.5
        loss, d = tx._fwd(logits, labels), tx._bwd(logits, labels, ct)
        rl, rd = tx._plain_fwd(logits, labels), tx._plain_bwd(logits, labels,
                                                             ct)
        torch.cuda.synchronize()
        lref = logits.clone().requires_grad_()
        nbytes = TRAIN_B * c * 4 + TRAIN_B * 8
        for kind, got, ref, kern, plain, lib, nb in (
                ("xent_fwd", loss, rl, lambda: tx._fwd(logits, labels),
                 lambda: tx._plain_fwd(logits, labels),
                 lambda: F.cross_entropy(logits, labels, reduction="none"),
                 nbytes + TRAIN_B * 4),
                ("xent_bwd", d, rd, lambda: tx._bwd(logits, labels, ct),
                 lambda: tx._plain_bwd(logits, labels, ct),
                 lambda: torch.autograd.grad(
                     F.cross_entropy(lref, labels, reduction="none"), lref,
                     ct), nbytes + TRAIN_B * 4 + TRAIN_B * c * 4)):
            err = ((got - ref).abs() / ref.abs().clamp(min=1e-30)).max()
            rec = {"kind": kind, "shape": [TRAIN_B, c],
                   "max_abs_err": (got - ref).abs().max().item(),
                   "max_rel_err": err.item(),
                   "ok": bool(torch.allclose(got, ref, rtol=1e-6,
                                             atol=1e-6)),
                   "ms": device_ms(kern), "launch_loop_ms": cuda_loop_ms(kern),
                   "plain_ms": device_ms(plain), "library_ms": device_ms(lib),
                   "bytes": nb}
            # ~10 operations per element (exp, max, add, divide), f32.
            rec["bound_ms"], rec["bound_by"] = bound(
                nb, 10.0 * TRAIN_B * c, PEAK_F32_FLOPS)
            ok &= rec["ok"]
            print("[train-kernel] " + json.dumps(with_ratios(rec)))
            cases.append(rec)
    # The batch mean, the training loss: one launch each way. Timed at
    # the training batch, beside the route it replaces (per-example kernel
    # + torch mean; MeanBackward's scale + per-example backward kernel).
    for b in XENT_MEAN_B:
        c = XENT_CLASSES[0]
        logits = 3.0 * torch.randn(b, c, generator=gen, device="cuda")
        labels = torch.randint(0, c, (b,), generator=gen, device="cuda")
        ct = torch.tensor(1.7, device="cuda")
        loss, again = tx._fwd(logits, labels, True), tx._fwd(logits, labels,
                                                             True)
        d = tx._bwd(logits, labels, ct, mean=True)
        rl = tx._plain_fwd(logits, labels).mean()
        rd = tx._plain_bwd(logits, labels, (ct / b).expand(b))
        old = logits.clone().requires_grad_()
        tx.softmax_xent(old, labels).mean().backward(ct)
        torch.cuda.synchronize()
        lref = logits.clone().requires_grad_()
        nbytes = b * c * 4 + b * 8 + 4
        fwd = {"kind": "xent_mean_fwd", "shape": [b, c],
               "max_abs_err": (loss - rl).abs().item(),
               "max_rel_err": ((loss - rl).abs() / rl.abs()).item(),
               "bit_identical_across_launches": bool(torch.equal(loss,
                                                                 again)),
               "bytes": nbytes}
        fwd["ok"] = (fwd["max_rel_err"] <= 1e-6
                     and fwd["bit_identical_across_launches"])
        bwd = {"kind": "xent_mean_bwd", "shape": [b, c],
               "max_abs_err": (d - rd).abs().max().item(),
               "max_rel_err": ((d - rd).abs().max()
                               / rd.abs().max()).item(),
               "bit_identical_to_mean_backward_route": bool(
                   torch.equal(d, old.grad)),
               "bytes": nbytes + b * c * 4}
        bwd["ok"] = (bwd["max_rel_err"] <= 1e-6
                     and bwd["bit_identical_to_mean_backward_route"])
        for rec in (fwd, bwd):
            # ~10 operations per element (exp, max, add, divide), f32.
            rec["bound_ms"], rec["bound_by"] = bound(
                rec["bytes"], 10.0 * b * c, PEAK_F32_FLOPS)
        if b == TRAIN_B:
            fwd.update({
                "ms": device_ms(lambda: tx._fwd(logits, labels, True)),
                "launch_loop_ms": cuda_loop_ms(
                    lambda: tx._fwd(logits, labels, True)),
                "old_route_ms": device_ms(
                    lambda: tx._fwd(logits, labels).mean()),
                "plain_ms": device_ms(
                    lambda: tx._plain_fwd(logits, labels).mean()),
                "library_ms": device_ms(
                    lambda: F.cross_entropy(logits, labels))})
            bwd.update({
                "ms": device_ms(lambda: tx._bwd(logits, labels, ct, True)),
                "launch_loop_ms": cuda_loop_ms(
                    lambda: tx._bwd(logits, labels, ct, True)),
                "old_route_ms": device_ms(
                    lambda: tx._bwd(logits, labels, ct.expand(b) / b)),
                "plain_ms": device_ms(lambda: tx._plain_bwd(
                    logits, labels, (ct / b).expand(b))),
                "library_ms": device_ms(lambda: torch.autograd.grad(
                    F.cross_entropy(lref, labels), lref, ct))})
        for rec in (fwd, bwd):
            ok &= rec["ok"]
            print("[train-kernel] " + json.dumps(with_ratios(rec)))
            cases.append(rec)
    # Labels outside [0, C), untimed: both kernels give the JAX kernels'
    # values (loss = the row's logsumexp, gradient = softmax * ct), as the
    # plain versions do.
    logits = 3.0 * torch.randn(4, 10, generator=gen, device="cuda")
    labels = torch.tensor([0, 10, -1, 9], device="cuda")
    ct = torch.rand(4, generator=gen, device="cuda") + 0.5
    loss, d = tx._fwd(logits, labels), tx._bwd(logits, labels, ct)
    rl, rd = tx._plain_fwd(logits, labels), tx._plain_bwd(logits, labels, ct)
    lse = torch.logsumexp(logits, dim=-1)
    soft = torch.softmax(logits, dim=-1) * ct[:, None]
    torch.cuda.synchronize()
    rec = {"kind": "xent_out_of_range_labels", "labels": [0, 10, -1, 9],
           "loss_max_abs_err": (loss - rl).abs().max().item(),
           "grad_max_abs_err": (d - rd).abs().max().item(),
           "loss_vs_logsumexp": (loss[1:3] - lse[1:3]).abs().max().item(),
           "grad_vs_softmax_ct": (d[1:3] - soft[1:3]).abs().max().item(),
           "finite": bool(torch.isfinite(loss).all()
                          and torch.isfinite(d).all())}
    rec["ok"] = (rec["finite"] and rec["loss_max_abs_err"] <= 1e-5
                 and rec["grad_max_abs_err"] <= 1e-6
                 and rec["loss_vs_logsumexp"] <= 1e-5
                 and rec["grad_vs_softmax_ct"] <= 1e-6)
    ok &= rec["ok"]
    print("[train-kernel] " + json.dumps(with_ratios(rec)))
    out["xent_out_of_range"] = rec
    out["train_kernel_cases"] = cases
    if not ok:
        raise AssertionError("a train kernel disagrees with its plain "
                             "version")
    print(f"[train-kernel] all {len(cases)} cases within tolerance; stats "
          f"bit-exact with ordered_stats_sum and bit-identical across "
          f"launches, graph replays and a busy side stream")


def profile_forward(fn, n: int = 5, cuda_only: bool = False,
                    keep_all: bool = False) -> dict:
    """Device time by kernel over ``n`` calls of ``fn`` (torch.profiler),
    and the device's busy share of the wall time they took. ``cuda_only``
    traces the CUDA activity alone (with the CPU's too, the profiler loses
    device records now and then: `tools/port_profiler_loss.py`);
    ``keep_all`` also returns every kernel's record under ``all``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([] if cuda_only
                                      else [ProfilerActivity.CPU])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for ev in prof.key_averages():
        # Device-side events only: a CPU op (aten::conv2d) also carries
        # the device time of the kernels it launched.
        if str(getattr(ev, "device_type", "")) != "DeviceType.CUDA":
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            kernels[ev.key] = {"us_per_call": dev_us / n,
                               "count_per_call": ev.count / n}
    busy_us = sum(k["us_per_call"] for k in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us_per_call"])
               [:12])
    # The port's own kernels, by name: their device time per launch, which
    # for microsecond kernels a host-side loop cannot see.
    ours = {k: v for k, v in kernels.items()
            if any(s in k for s in ("conv_block_kernel", "xent_"))}
    return {"wall_us_per_call": wall_us / n, "device_busy_us_per_call":
            busy_us, "device_busy_share": busy_us * n / wall_us,
            "kernel_launches_per_call": sum(
                k["count_per_call"] for k in kernels.values()),
            "top": top, "ours": ours, "kernel_names": sorted(kernels),
            **({"all": kernels} if keep_all else {})}


def _randomize_bn(model, gen):
    import torch

    from tpu_dp_torch.models.resnet import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.numel()
                m.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))


class _Recorder:
    """Engine proxy that keeps every handle `run_load` submits."""

    def __init__(self, engine):
        self._engine, self.handles = engine, []

    def submit(self, *a, **kw):
        h = self._engine.submit(*a, **kw)
        self.handles.append(h)
        return h

    def __getattr__(self, name):
        return getattr(self._engine, name)


def phase_serve(out):
    import numpy as np
    import torch

    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.serve import InferenceEngine, run_load
    from tpu_dp_torch.train.step import _maybe_normalize

    gen = torch.Generator().manual_seed(0)
    model = build_model("resnet18", num_filters=64, num_classes=10,
                        fused_stages=(0, 1, 2, 3), generator=gen)
    _randomize_bn(model, gen)
    plain = build_model("resnet18", num_filters=64, num_classes=10)
    plain.load_state_dict(model.state_dict())
    plain = plain.to("cuda").eval()

    engine = InferenceEngine(model, device="cuda",
                             buckets=(1, 2, 4, 8, 16, 32), slo_ms=250.0)
    cb.reset_launches()
    engine.start()  # warms every bucket on the dispatch thread
    warm = engine.replica.warmup_ms
    rec = _Recorder(engine)
    try:
        report = run_load(rec, n_requests=200, pattern="poisson",
                          rate_rps=400.0, sizes=(1, 2, 3, 4), seed=0)
    finally:
        engine.stop()
    launches = cb.launches
    forwards = len(warm) + report["batches"]

    truth = report["ground_truth"]
    dev = report["device_stats"]
    hist = np.zeros(engine.num_classes, np.int64)
    for h in rec.handles:
        if h.ok:
            np.add.at(hist, np.asarray(h.predictions, np.int64), 1)
    checks = {
        "consistent": report["consistent"],
        "served_eq_images": dev["served"] == truth["images_served"],
        "completed_eq_submitted": truth["completed"] == truth["submitted"],
        "histogram_eq_handles": dev["class_counts"] == hist.tolist(),
        "launches_eq_10_per_forward": launches == 10 * forwards,
    }

    # Bucket-32 parity: the fused model (kernel) vs the same weights run
    # unfused on cuDNN, on one seeded batch.
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(
        rng.integers(0, 256, (32, 32, 32, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        x = _maybe_normalize(imgs)
        got = engine.model(x)
        ref = plain(x)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        checks["logits_shape"] = tuple(got.shape) == (32, 10)
        checks["logits_finite"] = bool(torch.isfinite(got).all())
        checks["logits_match_unfused"] = err <= 1e-2 * scale
        fwd_ms = cuda_median_ms(lambda: engine.model(x), reps=20)
        plain_fwd_ms = cuda_median_ms(lambda: plain(x), reps=20)
        breakdown = profile_forward(lambda: engine.model(x))

    lat = report["latency_ms"] or {}
    out["serve"] = {
        "checks": checks, "launches": launches, "forwards": forwards,
        "warmup_ms": warm, "batches": report["batches"],
        "bucket_counts": report["bucket_counts"],
        "p50_ms": lat.get("p50_ms"), "p95_ms": lat.get("p95_ms"),
        "p99_ms": lat.get("p99_ms"),
        "images_served": truth["images_served"],
        "wall_s": report["load"]["wall_s"],
        "images_per_s": truth["images_served"] / report["load"]["wall_s"],
        "spans": report["spans"],
        "logits_max_abs_err": err, "logits_max_abs": scale,
        "b32_forward_ms": fwd_ms, "b32_unfused_forward_ms": plain_fwd_ms,
        "b32_images_per_s": 32 / (fwd_ms / 1e3),
        "b32_profile": breakdown,
        "card": out["card"],
    }
    print("[serve] " + json.dumps(out["serve"]))
    print(f"[serve] {out['card']}: p50 {lat.get('p50_ms')} ms, "
          f"p95 {lat.get('p95_ms')} ms, "
          f"{out['serve']['images_per_s']:.1f} images/s offered-load "
          f"(200 Poisson requests at 400/s); bucket-32 forward "
          f"{fwd_ms:.3f} ms = {out['serve']['b32_images_per_s']:.0f} "
          f"images/s")
    print(f"[serve] bucket-32 forward under the profiler: "
          f"{breakdown['wall_us_per_call']:.1f} us wall, device busy "
          f"{breakdown['device_busy_us_per_call']:.1f} us "
          f"({100 * breakdown['device_busy_share']:.1f}%), "
          f"{breakdown['kernel_launches_per_call']:.0f} device ops")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"serve checks failed: {failed}")


def phase_train(out):
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx
    from tpu_dp_torch.train.trainer import Trainer

    trainer = Trainer(parse_cli(TRAIN_ARGS), device="cuda")
    steps, evals = len(trainer.train_pipe), len(trainer.test_pipe)
    held = torch.cuda.memory_allocated()  # by the earlier phases
    torch.cuda.reset_peak_memory_stats()
    cb.reset_launches()
    tx.reset_launches()
    result = trainer.fit()
    torch.cuda.synchronize()
    counts = {"conv": dict(cb.launches_by_role), "conv_total": cb.launches,
              "xent": dict(tx.launches)}
    peak = torch.cuda.max_memory_allocated()
    losses = trainer.step_losses
    acc = result["eval"]["accuracy"]
    checks = {
        "steps": steps == TRAIN_STEPS and len(losses) == steps,
        "losses_finite": all(math.isfinite(v) for v in losses),
        "loss_falls": statistics.mean(losses[-5:])
        < statistics.mean(losses[:5]),
        "conv_stats_10_per_step": counts["conv"]["stats"] == 10 * steps,
        "conv_input_grad_10_per_step":
            counts["conv"]["input_grad"] == 10 * steps,
        "conv_eval_10_per_eval_forward":
            counts["conv"]["eval"] == 10 * evals,
        "xent_1_and_1_per_step":
            counts["xent"] == {"forward": steps, "backward": steps},
        "accuracy_is_number": isinstance(acc, float) and math.isfinite(acc),
    }
    # The same init, batches, augmentation and schedule, unfused and
    # without kernels (cuDNN convs, cross_entropy_loss, TF32 off).
    ref = Trainer(parse_cli(TRAIN_ARGS + [
        "--model.fused_stages=", "--model.fused_bwd=false",
        "--train.pallas_xent=false"]), device="cuda")
    before = (cb.launches, dict(tx.launches))
    ref.train_pipe.set_epoch(0)
    ref_losses = []
    for batch in ref.train_pipe:
        ref_losses.append(ref.train_step(ref.state, batch)["loss"])
        if len(ref_losses) == 5:
            break
    ref_losses = torch.stack(ref_losses).tolist()
    diffs = [abs(a - b) for a, b in zip(losses[:5], ref_losses)]
    checks["first5_track_unfused"] = max(diffs) <= 0.05
    checks["reference_runs_no_kernel"] = before == (cb.launches,
                                                    dict(tx.launches))

    batch = next(iter(trainer.train_pipe))
    step_ms = cuda_median_ms(lambda: trainer.train_step(trainer.state, batch),
                             reps=20)
    ref_step_ms = cuda_median_ms(lambda: ref.train_step(ref.state, batch),
                                 reps=10)
    # The same books by kernel name on the device: 20 conv launches, 1 + 1
    # xent launches and no stats-reduce kernel per step (it is folded into
    # the conv launch). The profiler now and then loses device records
    # (`tools/port_profiler_loss.py` counts how many), so a session can
    # count fewer launches than ran but never more: a count above the books
    # fails at once, one below is profiled again, in at most three
    # sessions, all of them recorded.
    books = {"conv_block_kernel": 20, "xent_fwd": 1, "xent_bwd": 1}
    sessions = []
    for _ in range(3):
        breakdown = profile_forward(
            lambda: trainer.train_step(trainer.state, batch))
        ours = breakdown["ours"]
        by_name = {k: sum(v["count_per_call"] for n, v in ours.items()
                          if k in n) for k in books}
        sessions.append({"by_name": by_name, "device_ops_per_step":
                         breakdown["kernel_launches_per_call"],
                         "kernel_names": breakdown["kernel_names"]})
        if by_name == books or any(by_name[k] > v for k, v in books.items()):
            break
    checks["profiled_20_conv_1_1_xent_per_step"] = by_name == books
    checks["no_stats_reduce_kernel"] = not any(
        "stats_reduce" in n for s in sessions for n in s["kernel_names"])
    out["train"] = {
        "checks": checks, "steps": steps, "eval_forwards": evals,
        "launches": counts, "profiled_launches_per_step": by_name,
        "profiled_sessions": [{k: v for k, v in s.items()
                               if k != "kernel_names"} for s in sessions],
        "losses": losses, "unfused_losses": ref_losses,
        "first5_max_abs_diff": max(diffs), "eval": result["eval"],
        "fit_wall_s": result["wall_time_s"],
        "fit_images_per_s": result["images_per_sec"],
        "step_ms": step_ms, "images_per_s": TRAIN_B / (step_ms / 1e3),
        "unfused_step_ms": ref_step_ms,
        "peak_memory_bytes": peak, "held_before_fit_bytes": held,
        "step_profile": breakdown,
        "card": out["card"],
    }
    print("[train] " + json.dumps(out["train"]))
    print(f"[train] {out['card']}: {steps} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, eval accuracy {acc:.4f}; step "
          f"{step_ms:.3f} ms = {TRAIN_B / (step_ms / 1e3):.0f} images/s "
          f"(unfused, no kernels: {ref_step_ms:.3f} ms); device busy "
          f"{100 * breakdown['device_busy_share']:.1f}% of "
          f"{breakdown['wall_us_per_call']:.1f} us under the profiler, "
          f"{breakdown['kernel_launches_per_call']:.0f} device ops per "
          f"step; peak memory {peak / 2**20:.1f} MiB")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"train checks failed: {failed}")


def _ddp_batches(world: int):
    """The parity runs' global batches: ``DDP_STEPS`` of ``world *
    TRAIN_B`` uint8 images and labels, from seed 7 (rank r trains on rows
    ``[r*TRAIN_B, (r+1)*TRAIN_B)``)."""
    import numpy as np

    rng = np.random.default_rng(7)
    n = world * TRAIN_B
    return (rng.integers(0, 256, (DDP_STEPS, n, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, (DDP_STEPS, n)).astype(np.int64))


def _ddp_train(ctx, world: int, profile: bool = False) -> dict:
    """``DDP_STEPS`` fused full-width updates (f32, the slice's kernels)
    from the seed-0 init on this rank's rows of `_ddp_batches`: per-step
    global losses, the books of each step (kernel launches by the
    wrappers' counters, the collectives by `collectives.counts`) and its
    CUDA-event time. ``ctx`` None: one process on the whole batch, no
    group. ``profile``: then 5 more steps on the last batch under the
    profiler (CUDA activity alone): wall and device-busy time per step and
    the NCCL kernels' share."""
    import torch

    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx
    from tpu_dp_torch.parallel import collectives
    from tpu_dp_torch.train.optim import make_sgd
    from tpu_dp_torch.train.schedule import make_schedule
    from tpu_dp_torch.train.step import (
        TrainState,
        data_parallel,
        make_train_step,
    )

    dev = torch.device("cuda", 0) if ctx is None else ctx.device
    group = None if ctx is None else ctx.process_group
    model = build_model(
        "resnet18", num_filters=64, num_classes=10,
        fused_stages=(0, 1, 2, 3), fused_bwd=True, process_group=group,
        generator=torch.Generator().manual_seed(0)).to(dev)
    runs = model if ctx is None else data_parallel(model, ctx)
    opt = make_sgd(model, 0.9, 5e-4)
    step = make_train_step(runs, opt, make_schedule(*DDP_SCHED),
                           use_pallas_xent=True, device=dev,
                           process_group=group)
    state = TrainState(step=0, model=model, optimizer=opt)
    images, labels = _ddp_batches(world)
    rows = (slice(None) if ctx is None
            else slice(ctx.rank * TRAIN_B, (ctx.rank + 1) * TRAIN_B))
    losses, books, ms = [], [], []
    for img, lab in zip(images, labels):
        batch = {"image": torch.from_numpy(img[rows]).to(dev),
                 "label": torch.from_numpy(lab[rows]).to(dev)}
        torch.cuda.synchronize(dev)
        cb.reset_launches()
        tx.reset_launches()
        collectives.reset_counts()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        m = step(state, batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
        books.append({"conv": dict(cb.launches_by_role),
                      "xent": dict(tx.launches), **collectives.counts})
    prof = None
    if profile:
        p = profile_forward(lambda: step(state, batch), cuda_only=True,
                            keep_all=True)
        prof = {k: p[k] for k in ("wall_us_per_call",
                                  "device_busy_us_per_call",
                                  "kernel_launches_per_call")}
        prof["nccl"] = {k: v for k, v in p["all"].items()
                        if "nccl" in k.lower()}
    return {"losses": losses, "books": books, "step_ms": ms, "profile": prof,
            "device": str(next(model.parameters()).device),
            "state": {k: v.detach().cpu() for k, v in
                      model.state_dict().items()}}


def ddp_worker(spec_path: str) -> int:
    """One rank of phase 7's two-rank runs (``chip_smoke.py --ddp-worker
    SPEC``): joins the group SPEC names, runs `_ddp_train`, and saves what
    it recorded to ``SPEC["out"]`` (``torch.save``)."""
    sys.path.insert(0, HERE)
    import torch

    from tpu_dp_torch.parallel.dist import initialize, shutdown

    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = initialize(backend=spec["backend"], init_method=spec["init"],
                     world_size=spec["world"], rank=spec["rank"],
                     device=spec["device"], timeout_s=300)
    try:
        rec = _ddp_train(ctx, spec["world"], spec["profile"])
        rec["backend"] = ctx.backend
        torch.save(rec, spec["out"])
    finally:
        shutdown()
    return 0


def _ddp_ranks(world: int, backend, devices, profile: bool) -> list:
    """Run ``world`` ranks of `ddp_worker` as processes of this script,
    rank r on ``devices[r]``; returns each rank's record."""
    import shutil

    import torch

    work = os.path.join(HERE, "build", "ddp_smoke", str(os.getpid()))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs = []
    try:
        for rank in range(world):
            spec = {"rank": rank, "world": world, "backend": backend,
                    "device": devices[rank], "profile": profile,
                    "init": "file://" + os.path.join(work, "rendezvous"),
                    "out": os.path.join(work, f"rank{rank}.pt")}
            path = os.path.join(work, f"spec{rank}.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump(spec, f)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ddp-worker",
                 path], cwd=HERE, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        recs = []
        for rank, p in enumerate(procs):
            log, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"ddp rank {rank} exited "
                                     f"{p.returncode}:\n{log[-4000:]}")
            recs.append(torch.load(os.path.join(work, f"rank{rank}.pt")))
        return recs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        shutil.rmtree(work, ignore_errors=True)


def _ddp_parity(out, key: str, world: int, backend, devices,
                profile: bool = False) -> dict:
    """``world`` ranks against one process on the concatenated batch:
    per-step global loss within ``DDP_LOSS_TOL``, parameters and buffers
    bit-identical across the ranks, and each rank's books per step: 20
    conv launches (10 ``emit_stats``, 10 input-grad), 1 + 1 xent, 20 + 20
    sync-BN pmeans, one metrics all-reduce, DDP's buckets (printed)."""
    import torch

    ranks = _ddp_ranks(world, backend, devices, profile)
    ref = _ddp_train(None, world)
    diffs = [max(abs(a - b) for a, b in zip(r["losses"], ref["losses"]))
             for r in ranks]
    same = all(torch.equal(ranks[0]["state"][k], r["state"][k])
               for r in ranks[1:] for k in ranks[0]["state"])
    want = {"conv": {"eval": 0, "stats": 10, "input_grad": 10},
            "xent": {"forward": 1, "backward": 1}, "pmean_forward": 20,
            "pmean_backward": 20, "psum": 1}
    books_ok = all({k: b[k] for k in want} == want and b["ddp_buckets"] >= 1
                   for r in ranks for b in r["books"])
    rec = {
        "world": world, "backend": [r["backend"] for r in ranks],
        "devices": [r["device"] for r in ranks],
        "losses": [r["losses"] for r in ranks],
        "concatenated_losses": ref["losses"], "max_abs_diff": max(diffs),
        "books_per_step": ranks[0]["books"],
        "ddp_buckets_per_step": [b["ddp_buckets"] for b in
                                 ranks[0]["books"]],
        # Steps 2.. (the first builds cuDNN plans and DDP's buckets).
        "step_ms_median": [statistics.median(r["step_ms"][1:])
                           for r in ranks],
        "concatenated_step_ms_median": statistics.median(ref["step_ms"][1:]),
        "profile": [r["profile"] for r in ranks],
        "checks": {
            "losses_within_tol": max(diffs) <= DDP_LOSS_TOL,
            "losses_finite": all(math.isfinite(v) for r in ranks
                                 for v in r["losses"]),
            "ranks_bit_identical": same,
            "books_20_conv_1_1_xent_20_20_pmean": books_ok,
            "backend_as_asked": all(r["backend"] == (backend or "nccl")
                                    for r in ranks),
            "on_the_card": all(r["device"].startswith("cuda")
                               for r in ranks),
        },
        "card": out["card"],
    }
    step = rec["step_ms_median"][0]
    rec["global_images_per_s"] = world * TRAIN_B / (step / 1e3)
    out[key] = rec
    print(f"[{key}] " + json.dumps(rec))
    print(f"[{key}] {out['card']}: {world} ranks ({rec['backend'][0]}) on "
          f"{rec['devices']}, B={TRAIN_B} per rank: losses "
          f"{[round(v, 4) for v in rec['losses'][0]]} vs concatenated "
          f"B={world * TRAIN_B} {[round(v, 4) for v in ref['losses']]} "
          f"(max diff {max(diffs):.3g}); ranks bit-identical: {same}; DDP "
          f"buckets per step {rec['ddp_buckets_per_step']}; step "
          f"{step:.3f} ms")
    failed = [k for k, v in rec["checks"].items() if not v]
    if failed:
        raise AssertionError(f"{key} checks failed: {failed}")
    return rec


def phase_ddp_gloo_one_card(out):
    """7a: two ranks on the one card through gloo on CUDA tensors (NCCL
    refuses two ranks on one card). A correctness run: gloo copies every
    all-reduce through the host, so its step time is no DDP figure."""
    print("[ddp_gloo_one_card] backend gloo, asked for explicitly: two "
          "ranks share cuda:0")
    _ddp_parity(out, "ddp_gloo_one_card", DDP_WORLD, "gloo",
                ["cuda:0"] * DDP_WORLD)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_ddp_nccl_world1(out):
    """7b: `Trainer` at world 1 on NCCL through `initialize()` and the env
    contract (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
    DDP's machinery on the card, 30 steps and one eval; its step beside
    phase 6's single-process step, and, in turns on the same model and
    batch (plain, DDP, DDP, plain; augmentation off in both), the step
    without and with DDP's wrapper: what DDP adds, in ms and device ops
    (CUDA activity alone under the profiler)."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx
    from tpu_dp_torch.parallel import collectives
    from tpu_dp_torch.parallel.dist import shutdown
    from tpu_dp_torch.train.step import make_train_step
    from tpu_dp_torch.train.trainer import Trainer

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        trainer = Trainer(parse_cli(TRAIN_ARGS))
        ctx = trainer.ctx
        steps = len(trainer.train_pipe)
        cb.reset_launches()
        tx.reset_launches()
        collectives.reset_counts()
        result = trainer.fit()
        torch.cuda.synchronize()
        books = {"conv": dict(cb.launches_by_role),
                 "xent": dict(tx.launches), **collectives.counts}
        losses = trainer.step_losses
        batch = next(iter(trainer.train_pipe))
        step_ms = cuda_median_ms(
            lambda: trainer.train_step(trainer.state, batch), reps=20)
        prof = profile_forward(
            lambda: trainer.train_step(trainer.state, batch), cuda_only=True,
            keep_all=True)
        ab = {}
        for name in ("plain", "ddp", "ddp", "plain"):
            fn = make_train_step(
                trainer.ddp if name == "ddp" else trainer.model,
                trainer.optimizer, trainer.schedule, use_pallas_xent=True,
                device=trainer.device)
            ms = cuda_median_ms(lambda: fn(trainer.state, batch), reps=20)
            ops = profile_forward(lambda: fn(trainer.state, batch),
                                  cuda_only=True)["kernel_launches_per_call"]
            ab.setdefault(name, []).append({"step_ms": ms,
                                            "device_ops_per_step": ops})
    finally:
        shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ev = result["eval"]
    plain_ms = out.get("train", {}).get("step_ms")
    rec = {
        "backend": ctx.backend, "world": ctx.world, "device": str(ctx.device),
        "steps": steps, "losses": losses, "eval": ev,
        "launches": books, "step_ms": step_ms,
        "single_process_step_ms": plain_ms,
        "ddp_added_ms": None if plain_ms is None else step_ms - plain_ms,
        "device_ops_per_step": prof["kernel_launches_per_call"],
        "device_busy_share": prof["device_busy_share"],
        "nccl_kernels": {k: v for k, v in prof["all"].items()
                         if "nccl" in k.lower()},
        "plain_vs_ddp_in_turns": ab,
        "fit_images_per_s": result["images_per_sec"],
        "card": out["card"],
    }
    rec["checks"] = {
        "nccl_world_1": (ctx.backend, ctx.world) == ("nccl", 1)
        and ctx.device.type == "cuda",
        "steps": steps == TRAIN_STEPS and len(losses) == steps,
        "losses_finite": all(math.isfinite(v) for v in losses),
        "loss_falls": statistics.mean(losses[-5:])
        < statistics.mean(losses[:5]),
        "eval_count_is_test_set": ev["count"] == len(trainer.test_ds),
        "conv_20_per_step": books["conv"]["stats"] == 10 * steps
        and books["conv"]["input_grad"] == 10 * steps,
        "xent_1_and_1_per_step":
            books["xent"] == {"forward": steps, "backward": steps},
        "ddp_buckets_reduced": books["ddp_buckets"] >= steps,
        "world_1_issues_no_sync_bn": books["pmean_forward"] == 0,
    }
    out["ddp_nccl_world1"] = rec
    print("[ddp_nccl_world1] " + json.dumps(rec))
    print(f"[ddp_nccl_world1] {out['card']}: NCCL world 1 via initialize() "
          f"and the env contract: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"eval {ev['count']} images, step {step_ms:.3f} ms (single "
          f"process, phase 6: {plain_ms}); "
          f"{prof['kernel_launches_per_call']:.0f} device ops per step; in "
          f"turns, plain vs DDP: " + json.dumps(ab))
    failed = [k for k, v in rec["checks"].items() if not v]
    if failed:
        raise AssertionError(f"ddp_nccl_world1 checks failed: {failed}")


def phase_ddp_nccl_multi_card(out):
    """7c: NCCL, one rank per card, when two or more cards are visible:
    the same parity against the concatenated batch, and global images/s
    (with every visible card too, when there are more than two)."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"ddp_nccl_multi_card: not run, {n} card visible")
        out["ddp_nccl_multi_card"] = {"run": False, "cards": n}
        return
    recs = {}
    for world in sorted({2, n}):
        recs[world] = _ddp_parity(out, f"ddp_nccl_world{world}", world,
                                  None, [f"cuda:{r}" for r in range(world)],
                                  profile=True)
    one = out.get("ddp_nccl_world1", {}).get("step_ms")
    out["ddp_nccl_multi_card"] = {
        "run": True, "cards": n,
        "global_images_per_s": {w: r["global_images_per_s"]
                                for w, r in recs.items()},
        "world1_images_per_s": None if one is None else TRAIN_B / (one / 1e3),
    }
    print("[ddp_nccl_multi_card] " + json.dumps(out["ddp_nccl_multi_card"]))


def _summed(name, source, replaces, launches, recs, peak=PEAK_BF16_FLOPS):
    """One kernels-line entry whose times sum ``recs`` (one per launch of
    a step or forward)."""
    total = {k: sum(r[k] for r in recs)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    if all("wrapper_ms" in r for r in recs):
        total["wrapper_ms"] = sum(r["wrapper_ms"] for r in recs)
    t_bytes = sum(r["bytes"] for r in recs) / PEAK_BYTES
    t_ops = sum(r["flops"] for r in recs) / peak
    return with_ratios({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in recs), **total,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"})


def kernels_line(out):
    cases = {(r["stage"], r["variant"]): r for r in out["kernel_cases"]
             if r["dtype"] == "float32"}
    train = out["train"]["launches"]
    src = "tpu_dp_torch/ops/csrc/"
    # Times sum the 10 calls of one B=32 f32 forward; launches are the
    # serve path's forwards plus the train path's eval forwards.
    eval_entry = _summed(KERNEL, src + "conv_block.cu",
                         "tpu_dp/ops/conv_block.py:113",
                         out["serve"]["launches"] + train["conv"]["eval"],
                         [cases[c] for c in FORWARD_CALLS])
    eval_entry["max_abs_err"] = max(
        r["max_abs_err"] for r in out["kernel_cases"]
        + out["kernel_small_bucket_cases"])
    tk = out["train_kernel_cases"]
    stats = {(r["stage"], r["variant"]): r for r in tk
             if r["kind"] == "emit_stats"}
    by_stage = {kind: {r["stage"]: r for r in tk if r["kind"] == kind}
                for kind in ("stats_fold", "input_grad")}
    # The fold's cost per launch of one forward: its stage's sum record
    # (plain, library, bound) with the measured emit_stats - stats-off time
    # of that launch's variant.
    fold = [{**by_stage["stats_fold"][st], "ms": stats[(st, v)]["fold_ms"]}
            for st, v in FORWARD_CALLS]
    xent = {(r["kind"], r["shape"][0]): r for r in tk
            if r["kind"].startswith("xent_mean")}
    entries = [
        eval_entry,
        # Sums over the 10 launches of one B=128 train forward / step.
        _summed("conv_block.fused_conv_bn (emit_stats)", src + "conv_block.cu",
                "tpu_dp/ops/conv_block.py:153", train["conv"]["stats"],
                [stats[c] for c in FORWARD_CALLS]),
        _summed("conv_block input-grad (pallas_bwd)", src + "conv_block.cu",
                "tpu_dp/ops/conv_block.py:418", train["conv"]["input_grad"],
                [by_stage["input_grad"][s] for s in INPUT_GRAD_STAGES]),
        # Runs inside each emit_stats launch: its launches are theirs.
        _summed("conv_block.fused_conv_bn stats fold (folded epilogue)",
                src + "conv_block.cu", "tpu_dp/ops/conv_block.py:167",
                train["conv"]["stats"], fold, PEAK_F32_FLOPS),
    ]
    for kind, name, line, key in (
            ("xent_mean_fwd", "xent.mean_softmax_xent forward (mean)", 71,
             "forward"),
            ("xent_mean_bwd", "xent.mean_softmax_xent backward (mean)", 82,
             "backward")):
        r = xent[(kind, TRAIN_B)]  # the main path's [128, 10]
        every = [x for x in tk if x["kind"] in (kind, kind.replace("_mean",
                                                                   ""))]
        entries.append(with_ratios({
            "name": name, "route": "cuda", "source": src + "xent.cu",
            "replaces": f"tpu_dp/ops/xent.py:{line}",
            "launches": train["xent"][key],
            "max_abs_err": max(x["max_abs_err"] for x in every),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]}))
    return {"kernels": entries}


PHASES = (phase_header, phase_build, phase_kernels, phase_train_kernels,
          phase_serve, phase_train, phase_ddp_gloo_one_card,
          phase_ddp_nccl_world1, phase_ddp_nccl_multi_card)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--ddp-worker"]:
        return ddp_worker(argv[1])
    # ``--only a,b``: header, build and the named phases (e.g. the
    # multi-card phase alone on a four-card machine); no kernels line.
    only = None
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = set(argv[1].split(","))
        known = {p.__name__.removeprefix("phase_") for p in PHASES}
        if not only <= known:
            raise SystemExit(f"chip_smoke: unknown phases {only - known}")
    elif argv:
        raise SystemExit(f"chip_smoke: unexpected arguments {argv}")
    sys.path.insert(0, HERE)
    import torch  # fails here, not mid-phase, if missing

    out: dict = {"allocated_bytes_before": {}}
    try:
        for phase in PHASES:
            name = phase.__name__.removeprefix("phase_")
            if only is not None and name not in only | {"header", "build"}:
                continue
            if torch.cuda.is_available():
                out["allocated_bytes_before"][phase.__name__] = (
                    torch.cuda.memory_allocated())
            phase(out)
        line = None if only is not None else kernels_line(out)
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        _save(out)
        return 1
    _save(out)
    print(out["card"])
    if line is not None:
        out["kernels"] = line["kernels"]
        _save(out)
        print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _save(out) -> None:
    try:
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
                  "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1, default=str)
    except OSError as e:
        print(f"chip_smoke: could not save the record: {e}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
