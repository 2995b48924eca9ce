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
   peak memory (its epoch save and final export go to a temporary
   directory);
7. data parallel (`tpu_dp_torch.parallel`), full width, f32, B=128 per
   rank, against one process on the concatenated batch (per-step global
   loss within 0.05, the fused bound of phase 6) with the ranks'
   parameters and buffers bit-identical and each rank's books per step
   (20 conv launches, 1 + 1 xent, 20 + 20 sync-BN pmeans, one metrics
   all-reduce, DDP's buckets): (a) two ranks on the one card through
   gloo on CUDA tensors (NCCL refuses two ranks on one card; a
   correctness run, its step time no DDP figure); (b) `Trainer` at world 1
   on NCCL through `initialize()` and the env contract, 30 steps and one
   eval, against the same run in one process (losses within 0.05, falling;
   books per update; eval count = test set), its step beside the one
   process's and, in turns on one model, the step with and without DDP's
   wrapper;
   (c) with two or more cards, NCCL with one rank per card (two, and every
   visible card), else ``ddp_nccl_multi_card: not run, 1 card visible``;
8. checkpoint (run between phases 6 and 7): the same fused full-width
   path, f32, cuDNN deterministic, B=128, 10 steps an epoch: 3 epochs
   uninterrupted; the same run interrupted at the start of epoch 3 and resumed by a fresh
   `Trainer` with ``--resume``: the restored state bit-identical to the
   interrupted run's and to the uninterrupted run's epoch-2 state, epoch
   3's losses, the final state and the eval bit-identical to the
   uninterrupted run's, 20 conv + 1 + 1 xent launches every step; the
   costs (the save's blocking ms on the training thread, its background
   write ms, the payload MB, a verified load, the first resumed step
   against a steady one); `InferenceEngine.from_checkpoint` of the
   epoch-3 save with buckets 1..32 and 50 Poisson requests (audited books,
   10 conv launches per forward, bucket-32 logits bit-identical to the
   trained model's eval forward); the reference workload (`Net`, batch 4,
   ``python -m tpu_dp_torch.train`` with synthetic data, 200 steps an
   epoch, 2 epochs) as a subprocess on the card (exit 0, falling finite
   losses, ``Finished Training``, its final params loaded back), a
   card-vs-CPU `Net` forward and gradient from one seed within 1e-4 of
   max|.|, and 1 + 1 xent launches a step with ``--train.pallas_xent=
   true``; every save goes to a temporary directory;
9. windows (``train.steps_per_call``) and ``optim.grad_accum_steps``, run
   last: (f) the xent kernels' one-CTA route at [128, 10] within 1e-6 of
   the plain versions, the mean bit-identical across 100 launches and 3
   CUDA-graph replays, an empty kernel's device time (the launch floor),
   and both routes' device time by batch; on the fused full-width
   ResNet-18, f32, B=128, cuDNN deterministic: (a) 40 eager updates against
   windows of 10 (an eager warm-up window, then one capture replayed 3
   times), per-update losses, final state (parameters, BN statistics,
   momentum) and eval bit-identical, the books per update from the captured
   counts × replays and per replay by kernel name under the profiler; (c)
   eager step ms against windowed ms per update, images/s by the fenced
   meter, device busy share and ops per update, host ms per window, the
   capture's ms and bytes; at world 1 on NCCL: (d) phase 7b's run with
   windows of 10, bit-identical to its eager run, and DDP's added ms per
   update both ways; (b) ``grad_accum_steps=2`` at B=64, eager against
   windowed, bit-identical, 2 × (20 + 1 + 1) launches and one DDP
   all-reduce set per update; (e) phase 8's interrupted and resumed run with
   windows of 5, bit-identical to the uninterrupted one;
10. ResNet-50 on synthetic CIFAR-100 (``--preset=resnet50_cifar100
   --model.fused_stages=all --model.fused_bwd=true
   --train.pallas_xent=true``, f32, B=128; every stride-1 bottleneck's
   3x3 on the conv kernel, 13 per forward): (a) ``resnet50_kernels``: the
   conv kernel at the four bottleneck shapes with f32 x from a cuDNN 1x1
   conv, no residual, no emit_z (eval and ``emit_stats`` variants, y one
   ulp, stats bit-exact with ``ordered_stats_sum`` and across launches,
   graph replays and a busy side stream; the input-grad, one ulp), each
   timed beside its bound, plain version and cuDNN bf16; the xent mean
   pair at [128, 100] on its multi-block route (1e-6, bit-identical over
   100 launches and 3 graph replays, device time beside
   ``F.cross_entropy``'s and the launch floor); (b) ``resnet50``:
   `Trainer` for 30 steps and one eval (finite losses, 13 + 13 conv and
   1 + 1 xent launches a step by counter and by kernel name, 13 per eval
   forward, the first 5 losses and all 30 within 0.05 of the unfused run
   without kernels, the eval count the test set, step ms, images/s, device busy
   share, top kernels, peak memory), its epoch save served by
   `InferenceEngine.from_checkpoint` (bucket-32 logits bit-identical to
   the trained model's), the same 30 steps with augmentation off (the
   loss falls), and phase 5's serve on the random-weight ResNet-50; (c)
   ``resnet50_windows``: phase 9's (a) and (c) with augmentation off, 40
   eager updates against windows of 10 bit-identical, losses falling,
   books per replay by kernel name, ms per update both ways, host ms per
   window, the capture's ms and bytes, and auto windows of 24; (d)
   ``resnet50_ddp``: phase 7b's run, 5 steps with augmentation off, within
   0.05 of one process, with its books;
11. ``sharded``: the sharded weight update (``--train.update_sharding=
   sharded``) on the fused full-width ResNet-18, f32 weights, B=128,
   cuDNN deterministic, at world 1 on NCCL through `initialize()` and the
   env contract (the exchange's collectives issued): (a) 30 updates and
   one eval per wire (f32, bf16, int8; unbucketed and at
   ``--train.bucket_mb=25``) against the replicated run: f32 bit-identical
   to it (losses, parameters, BN statistics, momentum), bf16 and int8
   finite and falling, their parameters after 6 updates within 4e-3 and
   6e-3 of f32's and not equal to them, ``quant_overflow`` 0; the books
   per update (10 + 10 conv, 1 + 1 xent; reduce-scatters, all-to-alls and
   all-gathers as the exchange plan says) by counter, and by kernel name
   under the profiler for one update, with its NCCL kernels; step ms;
   momentum and residual bytes per rank and the fit's peak memory; (b)
   windows of 10 against 40 eager updates for f32, bf16, int8 and int8 at
   25 MB (phase 9's checks and times), beside the replicated windows run
   without a group; (c) phase 8's interrupted and resumed run under int8
   at 25 MB, bit-identical to the uninterrupted one (residuals included);
   (d) ResNet-50 int8 at 25 MB, 10 updates: books and finite losses.
   Phase 7a also runs the sharded update (f32 and int8) on its two gloo
   ranks, and prints ``not run`` with gloo's error if gloo refuses a
   collective on CUDA tensors; phase 7c adds sharded f32 and int8 at
   world 2 and every card;
12. ``resident``: the device-resident feed (``data.device_resident``) on
   ``--preset=resnet18_cifar10`` with the kernel knobs, augmentation on,
   f32, B=128, cuDNN deterministic, over a 50,000-image synthetic train
   set (the CIFAR-10 table, 153.8 MB): one epoch resident and streamed,
   eager and in windows of 24, bit-identical (losses, parameters, BN
   statistics, momentum, eval) with the same books per update (10 + 10
   conv, 1 + 1 xent); the windowed pair under ``update_sharding=sharded``
   f32 at NCCL world 1 (four windows); a resident run interrupted 240
   updates in and resumed, bit-identical; a re-staged table recaptures
   the window; the staging ms and table bytes, H2D bytes per window, host
   ms per window (the feed's placement and the window call), windowed ms
   per update in turns, epoch images/s, device busy share and each fit's
   added peak memory, beside the streamed feed's;
13. ``presets``: the kernels at ``bf16_cosine_gb4096``'s call pattern
   (``emit_stats`` with bf16 x at B=512 for every stage and variant of a
   train forward: y one bf16 ulp, stats bit-exact with
   ``ordered_stats_sum``; the input-grad at B=512, one ulp; the xent mean
   pair at [512, 10] on its multi-block route, 1e-6), each timed beside
   its bound, plain version and library call; ``--preset=
   bf16_cosine_gb4096`` with the kernel knobs (bf16 compute, f32
   parameters, per-card batch 512), 30 updates, eager and in windows of
   10, augmentation off: finite falling losses, windows bit-identical,
   books, every conv launch on bf16 x at B=512, step ms and images/s;
   ``--preset=resnet18_8chip_gb1024`` (per-card batch 128), 10 updates:
   books and finite losses;
14. the kernels' JSON line, then ``{"ok": true, "device": {...}}``.

Phases 1-11 keep the streamed feed (``--data.device_resident=off``), so
their numbers stay comparable with earlier runs.

``python3 chip_smoke.py --only ddp_nccl_world1,ddp_nccl_multi_card`` runs
the header, the build and the named phases alone (a four-card machine's
multi-card check), without the kernels' line; ``--only
resnet50_kernels,resnet50,resnet50_windows,resnet50_ddp`` runs phase 10
alone, ``--only sharded`` phase 11 and ``--only resident,presets`` phases
12 and 13. ``--ddp-worker SPEC`` is phase 7's rank process.

Every timed case also prints ``bound_share`` (bound_ms / ms) and
``vs_library`` (ms / library_ms).

TF32 is off for every phase (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``): f32 means f32 in the plain
version and in the unfused reference. The full record also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
#: batches of the xent batch-mean checks (C = 10; the last above the
#: one-CTA route's rows); timed at TRAIN_B.
XENT_MEAN_B = (1, 7, TRAIN_B, 1000, 4096)
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
              "--train.epochs=1", "--train.log_every=10",
              "--data.device_resident=off"]
#: phase 8: the resume runs (B=128, 10 steps an epoch, 3 epochs; the
#: interrupted run stops before step 20, at the start of epoch 3), the
#: served requests and the reference workload's sizes.
CKPT_EPOCHS, CKPT_SPE = 3, 10
CKPT_ARGS = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
             "--model.fused_bwd=true", "--train.pallas_xent=true",
             "--data.dataset=synthetic", f"--data.batch_size={TRAIN_B}",
             f"--data.synthetic_train_size={CKPT_SPE * TRAIN_B}",
             f"--data.synthetic_test_size={2 * TRAIN_B}",
             f"--train.epochs={CKPT_EPOCHS}", "--train.log_every=100",
             "--data.device_resident=off"]
CKPT_SERVE_REQUESTS = 50
REF_ARGS = ["--data.dataset=synthetic", "--data.synthetic_train_size=800",
            "--data.synthetic_test_size=200", "--train.epochs=2",
            "--train.log_every=50", "--data.device_resident=off"]
#: phase 10, ResNet-50 on synthetic CIFAR-100: its classes, the train
#: run's steps, the windows' updates and window, and the stage of each of
#: one forward's 13 kernel launches (every stride-1 bottleneck's 3x3).
R50_CLASSES = 100
R50_STEPS = 30
R50_WIN_UPDATES, R50_K = 40, 10
R50_FORWARD_STAGES = (0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3)
#: phase 11: the sharded update's wires (``train.collective_dtype``,
#: ``train.bucket_mb``), and the wire contract's bounds on the parameters
#: after 6 updates against f32 (tests/test_quant.py's ``WIRE_CONTRACT``).
SHARDED_WIRES = (("", 0.0), ("bf16", 0.0), ("int8", 0.0), ("", 25.0),
                 ("bf16", 25.0), ("int8", 25.0))
WIRE_TOL = {"bf16": 4e-3, "int8": 6e-3}
#: phase 12: the resident feed's run (the preset, augmentation on, a
#: synthetic train set of CIFAR-10's 50,000 images) and its window.
RES_K = 24
RES_ARGS = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
            "--model.fused_bwd=true", "--train.pallas_xent=true",
            "--data.dataset=synthetic", "--data.synthetic_train_size=50000",
            f"--data.synthetic_test_size={2 * TRAIN_B}", "--train.epochs=1",
            "--train.log_every=100"]
#: phase 13: bf16_cosine_gb4096's per-card batch, its runs' updates and
#: window; resnet18_8chip_gb1024's updates.
P16_B, P16_UPDATES, P16_K = 512, 30, 10
P1024_UPDATES = 10


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


def device_ms(fn, n: int = 20, sessions: int = 2) -> float:
    """Device time per call of ``fn``: the time of every device kernel its
    ``n`` calls launch, from the profiler, over ``n``. For microsecond
    kernels, where a CUDA-event loop times the host's launch rate. The
    profiler (CUDA activity alone) now and then loses device records and
    never adds any (`tools/port_profiler_loss.py`), so this is the largest
    reading of ``sessions`` sessions; while every session read nothing,
    up to two more run, and then it fails."""
    best = 0.0
    for i in range(sessions + 2):
        us = profile_forward(fn, n, cuda_only=True)["device_busy_us_per_call"]
        best = max(best, us)
        if best > 0 and i + 1 >= sessions:
            return best / 1e3
    raise RuntimeError("the profiler recorded no device time")


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
    out["xent_ptxas"] = ptxas_lines(info["xent"]["log"], "xent_")
    for name, lines in out["xent_ptxas"].items():
        print(f"[build] {name}: {' | '.join(lines)}")
    spills = [i for i in out["conv_instances"] if i["spill_bytes"]]
    print(f"[build] total {out['build_s']} s; "
          f"{len(out['conv_instances'])} conv instances, "
          f"{len(spills)} with spills")


def ptxas_lines(log: str, key: str) -> dict:
    """ptxas's report lines (registers, stack frame, spills) of each entry
    function whose name holds ``key``."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1) if key in m.group(1) else None
            if cur:
                out[cur] = []
        elif cur and ("registers" in line or "stack frame" in line):
            out[cur].append(line.split("ptxas info    :")[-1].strip())
    return out


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


def _serve_run(name: str, num_classes: int, per_forward: int,
               card: str) -> dict:
    """The fused full-width ``name`` (f32, random weights and BN statistics
    from seed 0) behind `InferenceEngine` with buckets 1..32, 200 Poisson
    requests of 1-4 images at 400/s: its record, with ``checks`` (audited
    books, the device class histogram equal to the handles' predictions,
    ``per_forward`` kernel launches per forward, bucket-32 logits equal to
    the same weights run unfused on cuDNN within 1e-2 of their
    magnitude)."""
    import numpy as np
    import torch

    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.serve import InferenceEngine, run_load
    from tpu_dp_torch.train.step import _maybe_normalize

    gen = torch.Generator().manual_seed(0)
    model = build_model(name, num_filters=64, num_classes=num_classes,
                        fused_stages=(0, 1, 2, 3), generator=gen)
    _randomize_bn(model, gen)
    plain = build_model(name, num_filters=64, num_classes=num_classes)
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
        f"launches_eq_{per_forward}_per_forward":
            launches == per_forward * forwards,
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
        checks["logits_shape"] = tuple(got.shape) == (32, num_classes)
        checks["logits_finite"] = bool(torch.isfinite(got).all())
        checks["logits_match_unfused"] = err <= 1e-2 * scale
        fwd_ms = cuda_median_ms(lambda: engine.model(x), reps=20)
        plain_fwd_ms = cuda_median_ms(lambda: plain(x), reps=20)
        breakdown = profile_forward(lambda: engine.model(x))

    lat = report["latency_ms"] or {}
    return {
        "model": name, "num_classes": num_classes,
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
        "card": card,
    }


def _print_serve(tag: str, rec: dict) -> None:
    lat, breakdown = rec, rec["b32_profile"]
    print(f"[{tag}] " + json.dumps(rec))
    print(f"[{tag}] {rec['card']}: {rec['model']} p50 {lat['p50_ms']} ms, "
          f"p95 {lat['p95_ms']} ms, "
          f"{rec['images_per_s']:.1f} images/s offered-load "
          f"(200 Poisson requests at 400/s); bucket-32 forward "
          f"{rec['b32_forward_ms']:.3f} ms = {rec['b32_images_per_s']:.0f} "
          f"images/s")
    print(f"[{tag}] bucket-32 forward under the profiler: "
          f"{breakdown['wall_us_per_call']:.1f} us wall, device busy "
          f"{breakdown['device_busy_us_per_call']:.1f} us "
          f"({100 * breakdown['device_busy_share']:.1f}%), "
          f"{breakdown['kernel_launches_per_call']:.0f} device ops")


def phase_serve(out):
    out["serve"] = _serve_run("resnet18", 10, 10, out["card"])
    _print_serve("serve", out["serve"])
    failed = [k for k, v in out["serve"]["checks"].items() if not v]
    if failed:
        raise AssertionError(f"serve checks failed: {failed}")


def phase_train(out):
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx
    from tpu_dp_torch.train.trainer import Trainer

    # The epoch save and the final export go to a temporary directory.
    ckpt = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    args = TRAIN_ARGS + [f"--train.ckpt_dir={ckpt.name}"]
    trainer = Trainer(parse_cli(args), device="cuda")
    steps, evals = len(trainer.train_pipe), len(trainer.test_pipe)
    held = torch.cuda.memory_allocated()  # by the earlier phases
    torch.cuda.reset_peak_memory_stats()
    cb.reset_launches()
    tx.reset_launches()
    result = trainer.fit()
    torch.cuda.synchronize()
    ckpt.cleanup()
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
    ref = Trainer(parse_cli(args + [
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


class _Stop(Exception):
    """Phase 8's simulated interruption."""


def _ckpt_trainer(ckpt_dir, extra=(), stop_at=None):
    """A phase-8 `Trainer` whose train step records, per step, the
    kernel launches (the wrappers' counters, set to 0 just before the
    step and read just after) and the step's wall ms (synchronized); with
    ``stop_at`` the step before global step ``stop_at`` raises `_Stop`."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx
    from tpu_dp_torch.train.trainer import Trainer

    trainer = Trainer(parse_cli(CKPT_ARGS + [f"--train.ckpt_dir={ckpt_dir}",
                                             *extra]), device="cuda")
    real = trainer.train_step
    trainer.books, trainer.step_ms = [], []

    def step(state, batch):
        if stop_at is not None and state.step == stop_at:
            raise _Stop
        torch.cuda.synchronize()
        cb.reset_launches()
        tx.reset_launches()
        t0 = time.perf_counter()
        m = real(state, batch)
        torch.cuda.synchronize()
        trainer.step_ms.append(1e3 * (time.perf_counter() - t0))
        trainer.books.append({"conv": dict(cb.launches_by_role),
                              "xent": dict(tx.launches)})
        return m

    trainer.train_step = step
    return trainer


def _flat_state(trainer) -> dict:
    from tpu_dp_torch.checkpoint import _walk_state_dict, state_dict_of

    return dict(_walk_state_dict(state_dict_of(trainer.state)))


def _same_state(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def _books_ok(books) -> bool:
    return all(b == {"conv": {"eval": 0, "stats": 10, "input_grad": 10},
                     "xent": {"forward": 1, "backward": 1}} for b in books)


def phase_checkpoint(out):
    """8: checkpoints on the card. (a) the fused full-width main path, f32,
    cuDNN deterministic: 3 epochs uninterrupted; the same run interrupted
    at the start of epoch 3, then resumed by a fresh `Trainer` with
    ``--resume``: the restored state equals the interrupted run's (and the
    uninterrupted run's epoch-2 state) bit for bit, epoch 3's losses, the
    final state and the eval equal the uninterrupted run's, 20 conv + 1 + 1
    xent launches each step; (b) the save's blocking and background ms,
    the payload, a verified load and the first resumed step against a
    steady one; (c) `InferenceEngine.from_checkpoint` of the epoch-3 save:
    audited books, 10 conv launches per forward, bucket-32 logits equal to
    the trained model's eval forward; (d) the reference workload (`Net`,
    batch 4) through ``python -m tpu_dp_torch.train`` on the card, its
    final params loaded back, a card-vs-CPU `Net` forward and gradient
    within 1e-4 of max|.|, and 1 + 1 xent launches a step with
    ``--train.pallas_xent=true``."""
    import tempfile

    import numpy as np
    import torch

    from tpu_dp_torch import checkpoint as ck
    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.serve import InferenceEngine, run_load
    from tpu_dp_torch.train.step import _maybe_normalize
    from tpu_dp_torch.train.trainer import Trainer

    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    checks, rec = {}, {"card": out["card"]}
    stop = (CKPT_EPOCHS - 1) * CKPT_SPE
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
            # (a) uninterrupted; the state at the end of epoch 2 kept.
            full = _ckpt_trainer(os.path.join(tmp, "full"))
            epoch2 = {}
            real_epoch = full.train_epoch

            def train_epoch(epoch, start_step=0):
                stats = real_epoch(epoch, start_step)
                if epoch == CKPT_EPOCHS - 2:
                    epoch2.update(_flat_state(full))
                return stats

            full.train_epoch = train_epoch
            res_full = full.fit()
            part = _ckpt_trainer(os.path.join(tmp, "part"), stop_at=stop)
            try:
                part.fit()
            except _Stop:
                pass
            part.ckpt_mgr.wait()
            at_stop = _flat_state(part)
            resumed = _ckpt_trainer(os.path.join(tmp, "part"), ["--resume"])
            restored = _flat_state(resumed)
            res_resumed = resumed.fit()
            torch.cuda.synchronize()
            # Each run's newest epoch save: the epoch-3 saves waited for
            # the epoch-2 write still in flight, if any (wait_ms).
            saves = {"full_epoch_3": full.ckpt_mgr.last_save,
                     "interrupted_epoch_2": part.ckpt_mgr.last_save,
                     "resumed_epoch_3": resumed.ckpt_mgr.last_save}
            checks.update({
                "resumed_at_epoch_3": (resumed.start_epoch,
                                       resumed.start_step) == (2, 0),
                "restored_eq_interrupted_state": _same_state(restored,
                                                             at_stop),
                "restored_step": int(restored["step"]) == stop,
                "interrupted_eq_uninterrupted_epoch_2": _same_state(
                    at_stop, epoch2),
                "epoch_3_losses_bit_identical": resumed.step_losses
                == full.step_losses[stop:],
                "final_state_bit_identical": _same_state(
                    _flat_state(resumed), _flat_state(full)),
                "eval_identical": res_resumed["eval"] == res_full["eval"],
                "books_20_conv_1_1_xent_every_step": _books_ok(
                    full.books + part.books + resumed.books)
                and len(resumed.books) == CKPT_SPE,
                "losses_finite": all(math.isfinite(v)
                                     for v in full.step_losses),
            })
            # (b) costs: the save that blocks the training thread, its
            # background write, a verified load into a fresh state.
            step_dir = ck.CheckpointManager(
                os.path.join(tmp, "full")).latest_dir()
            target = _ckpt_trainer(os.path.join(tmp, "probe")).state
            torch.cuda.synchronize()
            load_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                ck.load_checkpoint(step_dir, target)
                torch.cuda.synchronize()
                load_ms.append(1e3 * (time.perf_counter() - t0))
            steady = statistics.median(full.step_ms[2:])
            rec.update({
                "saves": saves,
                "payload_mb": saves["full_epoch_3"]["payload_bytes"] / 1e6,
                "load_verified_ms": load_ms,
                "first_step_ms_fresh": full.step_ms[0],
                "first_resumed_step_ms": resumed.step_ms[0],
                "steady_step_ms": steady,
                "steady_step_ms_resumed": statistics.median(
                    resumed.step_ms[2:]),
                "losses_full": full.step_losses,
                "losses_resumed": resumed.step_losses,
                "eval": res_full["eval"],
            })

            # (c) serve the epoch-3 save: the model rebuilt from its meta.
            engine = InferenceEngine.from_checkpoint(
                step_dir, device="cuda", buckets=(1, 2, 4, 8, 16, 32),
                slo_ms=250.0)
            cb.reset_launches()
            engine.start()
            rq = _Recorder(engine)
            try:
                report = run_load(rq, n_requests=CKPT_SERVE_REQUESTS,
                                  pattern="poisson", rate_rps=400.0,
                                  sizes=(1, 2, 3, 4), seed=3)
            finally:
                engine.stop()
            served_launches = cb.launches_by_role["eval"]
            forwards = len(engine.replica.warmup_ms) + report["batches"]
            truth, dev = report["ground_truth"], report["device_stats"]
            imgs = torch.from_numpy(np.random.default_rng(4).integers(
                0, 256, (32, 32, 32, 3), dtype=np.uint8)).cuda()
            full.model.eval()
            with torch.inference_mode():
                x = _maybe_normalize(imgs)
                served = engine.model(x)
                trained = full.model(x)
            checks.update({
                "serve_consistent": report["consistent"],
                "serve_served_eq_images":
                    dev["served"] == truth["images_served"],
                "serve_10_launches_per_forward":
                    served_launches == 10 * forwards,
                "serve_b32_logits_bit_identical_to_trained": torch.equal(
                    served, trained),
            })
            rec["serve"] = {"batches": report["batches"],
                            "forwards": forwards,
                            "conv_launches": served_launches,
                            "p50_ms": (report["latency_ms"] or {}).get(
                                "p50_ms"),
                            "images_served": truth["images_served"]}
            del engine, full, part, resumed, target

            # (d) the reference workload, the system's default command.
            ref_dir = os.path.join(tmp, "ref")
            run = subprocess.run(
                [sys.executable, "-m", "tpu_dp_torch.train", *REF_ARGS,
                 f"--train.ckpt_dir={ref_dir}"], cwd=HERE,
                capture_output=True, text=True, timeout=600)
            lines = run.stdout.strip().splitlines()
            step_losses = [float(ln.rpartition(":")[2]) for ln in lines
                           if ln.startswith("[")]
            summary = json.loads(lines[-1]) if run.returncode == 0 else {}
            net = ck.load_params(os.path.join(ref_dir, "final_params.msgpack"),
                                 build_model("net"))
            checks.update({
                "reference_exit_0": run.returncode == 0,
                "reference_losses_finite_and_fall": bool(step_losses)
                and all(math.isfinite(v) for v in step_losses)
                and statistics.mean(step_losses[-2:])
                < statistics.mean(step_losses[:2]),
                "reference_finished": "Finished Training" in lines
                and any(ln.startswith("Accuracy of the network on the 200")
                        for ln in lines),
                "reference_model_net": summary.get("model") == "net",
                "reference_final_params_load": sum(
                    p.numel() for p in net.parameters()) == 62006,
            })
            rec["reference"] = {"returncode": run.returncode,
                                "step_losses": step_losses,
                                "summary": summary,
                                "stderr_tail": run.stderr[-2000:]}
            # Card vs CPU, one seeded Net, forward and gradient.
            gen = torch.Generator().manual_seed(0)
            cpu = build_model("net", generator=gen)
            card = build_model("net").cuda()
            card.load_state_dict(cpu.state_dict())
            rng = np.random.default_rng(5)
            xb = torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3)).astype(
                np.float32))
            yb = torch.from_numpy(rng.integers(0, 10, 4))
            errs = {}
            for name, m in (("cpu", cpu), ("card", card)):
                where = next(m.parameters()).device
                logits = m(xb.to(where))
                torch.nn.functional.cross_entropy(
                    logits, yb.to(where)).backward()
                errs[name] = [logits.detach().cpu()] + [
                    p.grad.cpu() for p in m.parameters()]
            rel = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(errs["card"], errs["cpu"]))
            checks["net_card_vs_cpu_within_1e-4"] = rel <= 1e-4
            rec["net_card_vs_cpu_rel_err"] = rel
            # --train.pallas_xent=true: 1 + 1 xent launches each step.
            from tpu_dp_torch.config import parse_cli
            from tpu_dp_torch.ops import xent as tx

            xt = Trainer(parse_cli(REF_ARGS + [
                "--train.epochs=1", "--train.pallas_xent=true",
                "--train.eval_at_end=false",
                f"--train.ckpt_dir={os.path.join(tmp, 'ref_xent')}"]),
                device="cuda")
            tx.reset_launches()
            xt.fit()
            torch.cuda.synchronize()
            n = len(xt.train_pipe)
            checks["reference_xent_1_and_1_per_step"] = dict(
                tx.launches) == {"forward": n, "backward": n}
            rec["reference_xent_launches"] = dict(tx.launches)
            rec["reference_xent_steps"] = n
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
    rec["checks"] = checks
    out["checkpoint"] = rec
    print("[checkpoint] " + json.dumps(rec, default=str))
    last = saves["full_epoch_3"]
    print(f"[checkpoint] {out['card']}: ResNet-18 save "
          f"{rec['payload_mb']:.1f} MB, blocking the training thread "
          f"{last['blocking_ms']:.1f} ms (of which snapshot "
          f"{last['snapshot_ms']:.1f} ms, waiting for the previous write "
          f"{last['wait_ms']:.1f} ms), background write "
          f"{last['write_ms']:.1f} ms; verified load "
          f"{statistics.median(load_ms):.1f} ms; first resumed step "
          f"{rec['first_resumed_step_ms']:.2f} ms vs steady "
          f"{rec['steady_step_ms']:.2f} ms (fresh run's first step "
          f"{rec['first_step_ms_fresh']:.2f} ms)")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"checkpoint checks failed: {failed}")


def _ddp_batches(world: int):
    """The parity runs' global batches: ``DDP_STEPS`` of ``world *
    TRAIN_B`` uint8 images and labels, from seed 7 (rank r trains on rows
    ``[r*TRAIN_B, (r+1)*TRAIN_B)``)."""
    import numpy as np

    rng = np.random.default_rng(7)
    n = world * TRAIN_B
    return (rng.integers(0, 256, (DDP_STEPS, n, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, (DDP_STEPS, n)).astype(np.int64))


def _ddp_train(ctx, world: int, profile: bool = False,
               wire: str | None = None) -> dict:
    """``DDP_STEPS`` fused full-width updates (f32, the slice's kernels)
    from the seed-0 init on this rank's rows of `_ddp_batches`: per-step
    global losses, the books of each step (kernel launches by the
    wrappers' counters, the collectives by `collectives.counts`) and its
    CUDA-event time. ``ctx`` None: one process on the whole batch, no
    group. ``profile``: then 5 more steps on the last batch under the
    profiler (CUDA activity alone): wall and device-busy time per step and
    the NCCL kernels' share. ``wire`` ("" f32, "bf16", "int8"): the
    sharded update over the group instead of DDP, with the exchange's
    collectives per update it should issue (``exchange_books``)."""
    import torch

    import torch.distributed as dist

    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx
    from tpu_dp_torch.parallel import collectives, quant
    from tpu_dp_torch.train.optim import make_sgd, shard_optimizer
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
    exchange = None
    if wire is None:
        runs = model if ctx is None else data_parallel(model, ctx)
        opt = make_sgd(model, 0.9, 5e-4)
    else:
        runs = model
        opt = shard_optimizer(model, world, ctx.rank, dist.group.WORLD,
                              0.9, 5e-4, codec=quant.make_wire_codec(wire))
        exchange = _exchange_books(opt, 1)
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
            "exchange_books": exchange,
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
        rec = _ddp_train(ctx, spec["world"], spec["profile"],
                         spec.get("wire"))
        rec["backend"] = ctx.backend
        torch.save(rec, spec["out"])
    finally:
        shutdown()
    return 0


def _ddp_ranks(world: int, backend, devices, profile: bool,
               wire: str | None = None) -> list:
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
                    "wire": wire,
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
                profile: bool = False, wire: str | None = None) -> dict:
    """``world`` ranks against one process on the concatenated batch:
    per-step global loss within ``DDP_LOSS_TOL``, parameters and buffers
    bit-identical across the ranks, and each rank's books per step: 20
    conv launches (10 ``emit_stats``, 10 input-grad), 1 + 1 xent, 20 + 20
    sync-BN pmeans, one metrics all-reduce, DDP's buckets (printed); with
    ``wire`` the sharded update instead of DDP, its exchange's
    reduce-scatters, all-to-alls and all-gather as planned and no DDP
    bucket."""
    import torch

    ranks = _ddp_ranks(world, backend, devices, profile, wire)
    ref = _ddp_train(None, world)
    diffs = [max(abs(a - b) for a, b in zip(r["losses"], ref["losses"]))
             for r in ranks]
    same = all(torch.equal(ranks[0]["state"][k], r["state"][k])
               for r in ranks[1:] for k in ranks[0]["state"])
    want = {"conv": {"eval": 0, "stats": 10, "input_grad": 10},
            "xent": {"forward": 1, "backward": 1}, "pmean_forward": 20,
            "pmean_backward": 20, "psum": 1}
    if wire is None:
        books_ok = all({k: b[k] for k in want} == want
                       and b["ddp_buckets"] >= 1
                       for r in ranks for b in r["books"])
    else:
        books_ok = all({k: b[k] for k in want} == want
                       and b["ddp_buckets"] == 0
                       and all(b[k] == v for k, v in
                               r["exchange_books"].items())
                       for r in ranks for b in r["books"])
    rec = {
        "world": world, "wire": wire,
        "backend": [r["backend"] for r in ranks],
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
    print(f"[{key}] {out['card']}: {world} ranks ({rec['backend'][0]}"
          + ("" if wire is None else f", sharded {wire or 'f32'}") + ") on "
          f"{rec['devices']}, B={TRAIN_B} per rank: losses "
          f"{[round(v, 4) for v in rec['losses'][0]]} vs concatenated "
          f"B={world * TRAIN_B} {[round(v, 4) for v in ref['losses']]} "
          f"(max diff {max(diffs):.3g}); ranks bit-identical: {same}; DDP "
          f"buckets per step {rec['ddp_buckets_per_step']}; step "
          f"{step:.3f} ms")
    failed = [k for k, v in rec["checks"].items() if not v]
    if failed:
        raise AssertionError(f"{key} checks failed: {failed}")
    return rec, ranks[0]["state"]


def phase_ddp_gloo_one_card(out):
    """7a: two ranks on the one card through gloo on CUDA tensors (NCCL
    refuses two ranks on one card). A correctness run: gloo copies every
    all-reduce through the host, so its step time is no DDP figure."""
    print("[ddp_gloo_one_card] backend gloo, asked for explicitly: two "
          "ranks share cuda:0")
    _ddp_parity(out, "ddp_gloo_one_card", DDP_WORLD, "gloo",
                ["cuda:0"] * DDP_WORLD)
    # The sharded update on the same two ranks. gloo may not implement a
    # reduce-scatter or an all-to-all of CUDA tensors: then the run is
    # reported as not run, with gloo's error (nothing stages through the
    # host instead).
    for wire in ("", "int8"):
        key = f"ddp_gloo_one_card_sharded_{wire or 'f32'}"
        try:
            _ddp_parity(out, key, DDP_WORLD, "gloo", ["cuda:0"] * DDP_WORLD,
                        wire=wire)
        except AssertionError as e:
            if "exited" not in str(e):
                raise
            err = [ln for ln in str(e).splitlines() if "Error" in ln
                   or "not supported" in ln or "unsupported" in ln]
            out[key] = {"run": False, "error": err[-3:] or str(e)[-600:]}
            print(f"[{key}] not run: gloo refused the sharded update on "
                  f"CUDA tensors: {out[key]['error']}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _nccl_world1_env(**extra):
    """One NCCL rank's env contract (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT at a free port, and ``extra``) around a
    block; after it the group is shut down and the env restored."""
    from tpu_dp_torch.parallel.dist import shutdown

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           **extra}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _world1_vs_one_process(out, key, args, steps, convs, turns=False):
    """Phase 7b for one model: `Trainer` at world 1 on NCCL through
    `initialize()` and the env contract against the same run in one
    process without a group (``args``: the CLI arguments, ``steps``
    updates and one eval): per-step losses within 0.05 of it, finite and
    falling; the books per update (``convs`` + ``convs`` conv and 1 + 1
    xent launches, ``convs`` a eval forward, DDP's buckets, and no sync-BN
    all-reduce, which world 1 does not issue); the eval count the test
    set; both steps' ms and the DDP step's device ops and busy share
    (CUDA activity alone under the profiler). With ``turns``, also the
    step without and with DDP's wrapper in turns on the same model and
    batch (plain, DDP, DDP, plain): what DDP adds, in ms and device ops.
    Records ``out[key]``."""
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.step import make_train_step
    from tpu_dp_torch.train.trainer import Trainer

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_world1_")
    try:
        one = Trainer(parse_cli(args + [
            f"--train.ckpt_dir={os.path.join(tmp.name, 'one')}"]),
            device="cuda")
        one.fit()
        batch = next(iter(one.train_pipe))
        one_ms = cuda_median_ms(lambda: one.train_step(one.state, batch),
                                reps=20)
        with _nccl_world1_env():
            trainer = Trainer(parse_cli(args + [
                f"--train.ckpt_dir={os.path.join(tmp.name, 'ddp')}"]))
            ctx = trainer.ctx
            result, ran = _fit_books(trainer)

            def step():
                return trainer.train_step(trainer.state, batch)

            step_ms = cuda_median_ms(step, reps=20)
            prof = profile_forward(step, cuda_only=True, keep_all=True)
            ab = {}
            for name in ("plain", "ddp", "ddp", "plain") if turns else ():
                fn = make_train_step(
                    trainer.ddp if name == "ddp" else trainer.model,
                    trainer.optimizer, trainer.schedule,
                    use_pallas_xent=True, device=trainer.device)
                ms = cuda_median_ms(lambda: fn(trainer.state, batch), reps=20)
                ops = profile_forward(lambda: fn(trainer.state, batch),
                                      cuda_only=True)[
                    "kernel_launches_per_call"]
                ab.setdefault(name, []).append({"step_ms": ms,
                                                "device_ops_per_step": ops})
    finally:
        tmp.cleanup()
    losses, ev = trainer.step_losses, result["eval"]
    diffs = [abs(a - b) for a, b in zip(losses, one.step_losses)]
    h = max(1, min(5, len(losses) // 2))
    rec = {
        "backend": ctx.backend, "world": ctx.world, "device": str(ctx.device),
        "steps": len(losses), "losses": losses,
        "single_losses": one.step_losses, "max_abs_diff": max(diffs),
        "eval": ev, "books": ran,
        "pmeans_per_update": {k: ran[k] / len(losses)
                              for k in ("pmean_forward", "pmean_backward")},
        "ddp_buckets_per_update": ran["ddp_buckets"] / len(losses),
        "step_ms": step_ms, "single_process_step_ms": one_ms,
        "ddp_added_ms": step_ms - one_ms,
        "device_ops_per_step": prof["kernel_launches_per_call"],
        "device_busy_share": prof["device_busy_share"],
        "nccl_kernels": {k: v for k, v in prof["all"].items()
                         if "nccl" in k.lower()},
        "plain_vs_ddp_in_turns": ab,
        "fit_images_per_s": result["images_per_sec"], "card": out["card"],
    }
    rec["checks"] = {
        "nccl_world_1": (ctx.backend, ctx.world) == ("nccl", 1)
        and ctx.device.type == "cuda",
        "steps": len(losses) == steps == len(one.step_losses),
        "losses_finite": all(math.isfinite(v) for v in losses),
        "loss_falls": statistics.mean(losses[-h:])
        < statistics.mean(losses[:h]),
        "losses_track_one_process": max(diffs) <= DDP_LOSS_TOL,
        "eval_count_is_test_set": ev["count"] == len(trainer.test_ds),
        "books": _per_update_ok(ran, steps, len(trainer.test_pipe),
                                convs=convs),
        "ddp_buckets_reduced": ran["ddp_buckets"] >= steps,
        "world_1_issues_no_sync_bn":
            ran["pmean_forward"] == ran["pmean_backward"] == 0,
    }
    out[key] = rec
    print(f"[{key}] " + json.dumps(rec))
    print(f"[{key}] {out['card']}: NCCL world 1 via initialize() and the "
          f"env contract: loss {losses[0]:.4f} -> {losses[-1]:.4f} (one "
          f"process within {max(diffs):.3g}), eval {ev['count']} images, "
          f"step {step_ms:.3f} ms (one process {one_ms:.3f}); "
          f"{prof['kernel_launches_per_call']:.0f} device ops per step"
          + ("; in turns, plain vs DDP: " + json.dumps(ab) if turns else ""))
    del one, trainer, batch
    failed = [k for k, v in rec["checks"].items() if not v]
    if failed:
        raise AssertionError(f"{key} checks failed: {failed}")
    return rec


def phase_ddp_nccl_world1(out):
    """7b: DDP's machinery on the card: `_world1_vs_one_process` on the
    fused full-width ResNet-18, 30 steps and one eval, with the plain and
    DDP steps in turns."""
    _world1_vs_one_process(out, "ddp_nccl_world1", TRAIN_ARGS, TRAIN_STEPS,
                           convs=10, turns=True)


def phase_ddp_nccl_multi_card(out):
    """7c: NCCL, one rank per card, when two or more cards are visible:
    the same parity against the concatenated batch, and global images/s
    (with every visible card too, when there are more than two), for DDP
    and for the sharded update in f32 and int8."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"ddp_nccl_multi_card: not run, {n} card visible")
        out["ddp_nccl_multi_card"] = {"run": False, "cards": n}
        return
    recs, sharded, vs_ddp = {}, {}, {}
    for world in sorted({2, n}):
        devs = [f"cuda:{r}" for r in range(world)]
        recs[world], ddp_state = _ddp_parity(
            out, f"ddp_nccl_world{world}", world, None, devs, profile=True)
        for wire in ("", "int8"):
            name = wire or "f32"
            sharded[(world, name)], state = _ddp_parity(
                out, f"ddp_nccl_world{world}_sharded_{name}", world, None,
                devs, profile=True, wire=wire)
            if not wire:
                # Sharded f32 against DDP, recorded, not required: phase 7
                # leaves cuDNN's nondeterministic algorithms on, so two
                # runs may part from the third update on whatever order
                # NCCL's reduce-scatter sums in.
                vs_ddp[world] = {
                    "losses_bit_identical": sharded[(world, name)]["losses"]
                    == recs[world]["losses"],
                    "max_abs_diff_state": max(
                        float((state[k].double() - ddp_state[k].double())
                              .abs().max()) for k in state)}
    one = out.get("ddp_nccl_world1", {}).get("step_ms")
    out["ddp_nccl_multi_card"] = {
        "run": True, "cards": n,
        "global_images_per_s": {w: r["global_images_per_s"]
                                for w, r in recs.items()},
        "sharded_global_images_per_s": {
            f"{w}_{name}": r["global_images_per_s"]
            for (w, name), r in sharded.items()},
        "sharded_f32_vs_ddp": vs_ddp,
        "world1_images_per_s": None if one is None else TRAIN_B / (one / 1e3),
    }
    print("[ddp_nccl_multi_card] " + json.dumps(out["ddp_nccl_multi_card"]))


def _first_window(pipe, k):
    """The first ``(n, pool)`` of ``pipe.windows(k)``, its prefetcher
    stopped."""
    it = pipe.windows(k)
    try:
        return next(it)
    finally:
        it.close()


def _fit_books(trainer) -> tuple[dict, dict]:
    """``trainer.fit()`` with every book set to 0 just before; returns the
    result and the launches and collectives that RAN: the wrappers'
    counts, which tick at capture, less the capture's own ticks, plus the
    captured window's books once per replay (`MultiStep`)."""
    import torch

    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx
    from tpu_dp_torch.parallel import collectives
    from tpu_dp_torch.train.step import launch_books

    cb.reset_launches()
    tx.reset_launches()
    collectives.reset_counts()
    result = trainer.fit()
    torch.cuda.synchronize()
    ran = launch_books()
    ms = trainer.multi_step
    if ms is not None and ms.captured is not None:
        for k, v in ms.captured.items():
            ran[k] += v * (ms.replays - 1)
    return result, ran


def _per_update_ok(ran, updates, evals, accum=1, convs=10) -> bool:
    """The launches that ran equal ``updates`` updates' books: 2 x
    ``convs`` conv (``convs`` ``emit_stats`` + ``convs`` input-grad; 10 in
    ResNet-18, 13 in ResNet-50) and 1 + 1 xent per microbatch, ``convs``
    conv per eval forward."""
    want = {"conv.stats": convs * accum * updates,
            "conv.input_grad": convs * accum * updates,
            "xent.forward": accum * updates,
            "xent.backward": accum * updates, "conv.eval": convs * evals}
    return all(ran[k] == v for k, v in want.items())


def _profiled_books(fn, books, n=2):
    """Kernels by name per call of ``fn`` under the profiler (CUDA activity
    alone), in up to three sessions while a count falls below ``books``
    (the profiler loses records now and then, never adds them)."""
    sessions = []
    for _ in range(3):
        p = profile_forward(fn, n, cuda_only=True, keep_all=True)
        by_name = {k: sum(v["count_per_call"] for name, v in p["all"].items()
                          if k in name.lower()) for k in books}
        sessions.append({"by_name": by_name,
                         "nccl_per_call": sum(
                             v["count_per_call"] for name, v in
                             p["all"].items() if "nccl" in name.lower()),
                         "device_ops_per_call": p["kernel_launches_per_call"],
                         "device_busy_share": p["device_busy_share"],
                         "wall_us_per_call": p["wall_us_per_call"],
                         "device_busy_us_per_call":
                             p["device_busy_us_per_call"]})
        if by_name == books or any(by_name[k] > v for k, v in books.items()):
            break
    return by_name == books, sessions


def _xent_mean_parity(lg, lb, ct) -> dict:
    """The batch-mean xent pair on logits ``lg``, labels ``lb`` and the
    scalar cotangent ``ct``: relative errors against the plain versions,
    and whether loss and gradient are bit-identical across 100 launches
    and across 3 replays of a CUDA graph of forward + backward (captured
    on a side stream that ran the pair once before, outside the capture,
    where its ticket counters are made)."""
    import torch

    from tpu_dp_torch.ops import xent as tx

    b = lg.shape[0]
    loss, d = tx._fwd(lg, lb, True), tx._bwd(lg, lb, ct, True)
    losses = [tx._fwd(lg, lb, True) for _ in range(100)]
    grads = [tx._bwd(lg, lb, ct, True) for _ in range(100)]
    rl = tx._plain_fwd(lg, lb).mean()
    rd = tx._plain_bwd(lg, lb, (ct / b).expand(b))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tx._fwd(lg, lb, True)
        tx._bwd(lg, lb, ct, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        g_loss = tx._fwd(lg, lb, True)
        g_d = tx._bwd(lg, lb, ct, True)
    replays = []
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(torch.equal(g_loss, loss) and torch.equal(g_d, d))
    torch.cuda.synchronize()
    return {"shape": list(lg.shape),
            "fwd_abs_err": (loss - rl).abs().item(),
            "bwd_abs_err": (d - rd).abs().max().item(),
            "fwd_rel_err": ((loss - rl).abs() / rl.abs()).item(),
            "bwd_rel_err": ((d - rd).abs().max() / rd.abs().max()).item(),
            "fwd_bit_identical_100_launches": all(torch.equal(v, loss)
                                                  for v in losses),
            "bwd_bit_identical_100_launches": all(torch.equal(v, d)
                                                  for v in grads),
            "graph_replays_bit_identical": replays}


def _launch_floor(threads_b: int):
    """An empty kernel on one block of the one-CTA xent launch's size at
    ``threads_b`` rows: the least any launch costs on the device."""
    import ctypes

    import torch

    from tpu_dp_torch.ops import _build

    empty = _build.load("xent").tpu_dp_empty_kernel
    empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    empty.restype = ctypes.c_int

    def floor():
        if empty(threads_b, torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("empty kernel launch failed")
    return floor


def _windows_xent(out, rec, checks):
    """9(f): the xent kernels' one-CTA route at [128, 10]: within 1e-6 of
    the plain versions, the mean bit-identical across 100 launches and 3
    replays of a CUDA graph of forward + backward, the launch floor (an
    empty kernel's device time), and forward and backward device time by
    batch on both routes (the one-CTA threshold)."""
    import torch

    from tpu_dp_torch.ops import xent as tx

    gen = torch.Generator(device="cuda").manual_seed(9)
    b, c = TRAIN_B, XENT_CLASSES[0]
    lg = 3.0 * torch.randn(b, c, generator=gen, device="cuda")
    lb = torch.randint(0, c, (b,), generator=gen, device="cuda")
    ct = torch.tensor(1.3, device="cuda")
    x = _xent_mean_parity(lg, lb, ct)
    replays = x["graph_replays_bit_identical"]
    # One block of the one-CTA launches' size at [128, 10].
    floor = _launch_floor(b)
    x.update({"floor_ms": device_ms(floor),
              "floor_launch_loop_ms": cuda_loop_ms(floor),
              "fwd_ms": device_ms(lambda: tx._fwd(lg, lb, True)),
              "bwd_ms": device_ms(lambda: tx._bwd(lg, lb, ct, True))})
    sweep = {}
    saved = tx.ONE_CTA_MAX_ROWS
    try:
        for nb in (128, 256, 512, 1024, 4096):
            lgb = 3.0 * torch.randn(nb, c, generator=gen, device="cuda")
            lbb = torch.randint(0, c, (nb,), generator=gen, device="cuda")
            row = {}
            for route, limit in (("one_cta", 1 << 30), ("multi_block", 0)):
                tx.ONE_CTA_MAX_ROWS = limit
                row[route] = {
                    "fwd_ms": device_ms(lambda: tx._fwd(lgb, lbb, True)),
                    "bwd_ms": device_ms(lambda: tx._bwd(lgb, lbb, ct,
                                                        True))}
            sweep[nb] = row
    finally:
        tx.ONE_CTA_MAX_ROWS = saved
    x["by_batch"] = sweep
    # The ticket counters refuse to be made inside a capture (a fresh
    # stream has none yet).
    from tpu_dp_torch.ops import _tickets

    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph(),
                              stream=torch.cuda.Stream()):
            _tickets.tickets(torch.device("cuda", 0), 1)
        x["tickets_refused_inside_capture"] = False
    except RuntimeError as e:
        x["tickets_refused_inside_capture"] = (
            "inside a CUDA graph capture" in str(e))
    rec["xent"] = x
    out["xent_floor_ms"] = x["floor_ms"]
    checks.update({
        "xent_one_cta_within_1e-6": x["fwd_rel_err"] <= 1e-6
        and x["bwd_rel_err"] <= 1e-6,
        "xent_mean_bit_identical_100_launches":
            x["fwd_bit_identical_100_launches"]
            and x["bwd_bit_identical_100_launches"],
        "xent_bit_identical_3_graph_replays": all(replays),
        "tickets_refused_inside_capture":
            x["tickets_refused_inside_capture"],
    })
    print("[windows] xent " + json.dumps(x))


def _win_args(updates, batch=TRAIN_B, k=1, extra=()):
    return ["--preset=resnet18_cifar10", "--model.fused_stages=all",
            "--model.fused_bwd=true", "--train.pallas_xent=true",
            "--data.dataset=synthetic", f"--data.batch_size={batch}",
            f"--data.synthetic_train_size={updates * TRAIN_B}",
            f"--data.synthetic_test_size={2 * TRAIN_B}",
            "--train.epochs=1", "--train.log_every=10",
            f"--train.steps_per_call={k}", "--data.device_resident=off",
            *extra]


def _windows_vs_eager(out, args, k, updates, convs, where):
    """Phase 9's (a) and (c) for one model, cuDNN deterministic set by the
    caller: ``updates`` eager updates against windows of ``k`` from the
    same init (``args(n, k)``: the CLI arguments of ``n`` updates in
    windows of ``k``; saves under ``where``): one eager warm-up window,
    then one capture replayed; per-update losses, final state (parameters,
    BN statistics, momentum) and eval bit-identical, losses finite and
    falling, the books per update (``convs`` + ``convs`` conv, 1 + 1 xent)
    from the captured counts x replays and per replay by kernel name under
    the profiler; then speed in the same call: eager step ms against
    windowed ms per update (CUDA events over whole windows), images/s by
    the fenced meter, device busy share and ops per update, host ms per
    window, the capture's ms and the bytes it holds, peak memory. Returns
    ``(checks, rec)``."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer
    from tpu_dp_torch.utils.meter import ThroughputMeter

    torch.cuda.reset_peak_memory_stats()
    peak0 = torch.cuda.max_memory_allocated()
    win = Trainer(parse_cli(args(updates, k) + [
        f"--train.ckpt_dir={os.path.join(where, 'win')}"]), device="cuda")
    res_w, ran_w = _fit_books(win)
    peak_w = torch.cuda.max_memory_allocated()
    eager = Trainer(parse_cli(args(updates, 1) + [
        f"--train.ckpt_dir={os.path.join(where, 'eager')}"]), device="cuda")
    res_e, ran_e = _fit_books(eager)
    ms = win.multi_step
    evals = len(win.test_pipe)
    losses = win.step_losses
    checks = {
        "windowed": ms is not None and ms.graph is not None
        and ms.eager_windows == 1 and ms.replays == updates // k - 1,
        "losses_bit_identical": losses == eager.step_losses
        and len(losses) == updates,
        "state_bit_identical": _same_state(_flat_state(win),
                                           _flat_state(eager)),
        "eval_identical": res_w["eval"] == res_e["eval"],
        "losses_finite_and_fall": all(math.isfinite(v) for v in losses)
        and statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
        "books_windowed": _per_update_ok(ran_w, updates, evals, convs=convs),
        "books_eager": _per_update_ok(ran_e, updates, evals, convs=convs),
        "captured_is_one_window": ms.captured is not None and {
            n: ms.captured[n] for n in ("conv.stats", "conv.input_grad",
                                        "xent.forward", "xent.backward")}
        == {"conv.stats": convs * k, "conv.input_grad": convs * k,
            "xent.forward": k, "xent.backward": k},
    }
    rec = {"losses": losses, "eval": res_w["eval"], "ran_windowed": ran_w,
           "ran_eager": ran_e, "captured": dict(ms.captured),
           "replays": ms.replays, "eager_windows": ms.eager_windows}
    # Books per replay by kernel name, and speed, same models.
    _, pool = _first_window(win.train_pipe, k)
    batch = next(iter(eager.train_pipe))
    ok, sessions = _profiled_books(
        lambda: win.multi_step(win.state, pool),
        {"conv_block_kernel": 2 * convs * k, "xent_fwd": k, "xent_bwd": k})
    checks["profiled_books_per_replay"] = ok
    eager_prof = profile_forward(
        lambda: eager.train_step(eager.state, batch), 5, cuda_only=True)
    win_prof = sessions[-1]
    eager_ms = cuda_median_ms(
        lambda: eager.train_step(eager.state, batch), reps=20)
    win_ms = cuda_median_ms(lambda: win.multi_step(win.state, pool),
                            reps=8) / k
    host = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        win.multi_step(win.state, pool)
        host.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    meters = {}
    for name, fn, n, imgs in (
            ("eager", lambda: eager.train_step(eager.state, batch), 22,
             TRAIN_B),
            ("windowed", lambda: win.multi_step(win.state, pool), 5,
             k * TRAIN_B)):
        meter = ThroughputMeter(warmup_steps=2, device="cuda")
        for _ in range(n):
            fn()
            meter.step(imgs)
        meter.mark()
        meters[name] = meter.images_per_sec
    rec.update({
        "eager_step_ms": eager_ms, "windowed_ms_per_update": win_ms,
        "images_per_s_meter": meters,
        "fit_images_per_s": {"eager": res_e["images_per_sec"],
                             "windowed": res_w["images_per_sec"]},
        "eager_device_busy_share": eager_prof["device_busy_share"],
        "eager_device_ops_per_update": eager_prof["kernel_launches_per_call"],
        "windowed_device_busy_share": win_prof["device_busy_share"],
        "windowed_device_ops_per_update": win_prof["device_ops_per_call"] / k,
        "windowed_device_busy_us_per_update":
            win_prof["device_busy_us_per_call"] / k,
        "eager_device_busy_us_per_update":
            eager_prof["device_busy_us_per_call"],
        "host_ms_per_window": statistics.median(host),
        "host_ms_per_window_all": host,
        "capture_ms": ms.capture_ms, "capture_bytes": ms.capture_bytes,
        "max_memory_allocated_before_fit": peak0,
        "max_memory_allocated_after_windowed_fit": peak_w,
        "profiled_sessions": sessions,
    })
    ms.close()
    return checks, rec


def _print_windows(tag, card, k, c, extra=""):
    print(f"[{tag}] {card}: windows of {k}: eager step "
          f"{c['eager_step_ms']:.3f} ms, windowed "
          f"{c['windowed_ms_per_update']:.3f} ms per update; images/s "
          f"{json.dumps(c['images_per_s_meter'])}; device busy "
          f"{100 * c['eager_device_busy_share']:.1f}% eager, "
          f"{100 * c['windowed_device_busy_share']:.1f}% windowed; ops per "
          f"update {c['eager_device_ops_per_update']:.0f} / "
          f"{c['windowed_device_ops_per_update']:.0f}; host "
          f"{c['host_ms_per_window']:.3f} ms per window; capture "
          f"{c['capture_ms']:.1f} ms holding "
          f"{c['capture_bytes'] / 2**20:.1f} MiB" + extra)


def phase_windows(out):
    """9: ``train.steps_per_call`` as CUDA-graph windows, and
    ``optim.grad_accum_steps``, on the fused full-width ResNet-18 (Train
    configuration, f32, B=128, cuDNN deterministic): (f) the xent kernels'
    one-CTA route; (a) 40 eager updates against windows of 10 (one eager
    warm-up window, then one capture replayed 3 times) from the same init:
    per-update losses, final parameters, BN statistics, momentum and the
    eval bit-identical, the books per update from the captured counts ×
    replays, and by kernel name under the profiler per replay; (c) speed in
    the same call: eager step ms and windowed ms per update (CUDA events
    over whole windows), images/s by the fenced meter, device busy share
    and ops per update under the profiler, host ms per window, capture ms
    and the bytes it holds; then at world 1 on NCCL through `initialize()`
    and the env contract: (d) phase 7b's `Trainer` with windows of 10
    against its eager run, bit-identical, and DDP's added ms per update
    eager and windowed; (b) ``grad_accum_steps=2`` at B=64, eager against
    windowed, bit-identical, 2 × (20 + 1 + 1) launches and one DDP
    all-reduce set per update; (e) phase 8's interrupted and resumed run
    with windows of 5, bit-identical to the uninterrupted one."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.step import make_multi_step, make_train_step
    from tpu_dp_torch.train.trainer import Trainer

    k, updates = 10, 40
    checks, rec = {}, {"card": out["card"], "k": k}
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_windows_")
    try:
        _windows_xent(out, rec, checks)
        # (a) parity and books, one card, no group; (c) speed.
        a_checks, rec["a"] = _windows_vs_eager(
            out, lambda n, kk: _win_args(n, k=kk), k, updates, 10, tmp.name)
        checks.update({"a_" + n: v for n, v in a_checks.items()})
        print("[windows] (c) " + json.dumps(
            {n: v for n, v in rec["a"].items() if n not in (
                "losses", "ran_windowed", "ran_eager", "captured")}))
        # (d) and (b): world 1 on NCCL through initialize() and the env
        # contract (the env var before the group, as the Trainer sets it).
        with _nccl_world1_env(TORCH_NCCL_ASYNC_ERROR_HANDLING="0"):
            dw = Trainer(parse_cli(TRAIN_ARGS + [
                "--train.steps_per_call=10",
                f"--train.ckpt_dir={os.path.join(tmp.name, 'dw')}"]))
            res_dw, ran_dw = _fit_books(dw)
            de = Trainer(parse_cli(TRAIN_ARGS + [
                f"--train.ckpt_dir={os.path.join(tmp.name, 'de')}"]))
            res_de, ran_de = _fit_books(de)
            steps = len(de.train_pipe)
            dms = dw.multi_step
            buckets = dms.captured["ddp_buckets"] // k
            checks.update({
                "d_nccl_world_1": (dw.ctx.backend, dw.ctx.world) == (
                    "nccl", 1),
                "d_windowed": dms.graph is not None and dms.replays >= 1,
                "d_losses_bit_identical": dw.step_losses == de.step_losses,
                "d_state_bit_identical": _same_state(_flat_state(dw),
                                                     _flat_state(de)),
                "d_eval_identical": res_dw["eval"] == res_de["eval"],
                # DDP's first update reduces in its first bucket layout;
                # the windowed run reduces as often as the eager one, and
                # a replay as many buckets per update as the capture saw.
                "d_books": _per_update_ok(ran_dw, steps, len(dw.test_pipe))
                and ran_dw["ddp_buckets"] == ran_de["ddp_buckets"]
                and buckets >= 1 and dms.captured["ddp_buckets"]
                == buckets * k,
            })
            _, dpool = _first_window(dw.train_pipe, k)
            dbatch = next(iter(de.train_pipe))
            dbooks = {"conv_block_kernel": 20 * k, "xent_fwd": k,
                      "xent_bwd": k}
            ok, dsessions = _profiled_books(
                lambda: dw.multi_step(dw.state, dpool), dbooks)
            # NCCL's one-rank all-reduce in place may launch no kernel at
            # all; where it does, one per bucket per update.
            checks["d_profiled_books_per_replay"] = ok and dsessions[-1][
                "nccl_per_call"] in (0, buckets * k)
            # DDP's cost per update, eager and windowed, in turns on one
            # model (plain, DDP, DDP, plain): the same step without the
            # wrapper, per step and in its own windows.
            plain = make_train_step(dw.model, dw.optimizer, dw.schedule,
                                    use_pallas_xent=True, device=dw.device)
            plain_win = make_multi_step(plain, k)
            calls = {
                "plain_eager": (lambda: plain(dw.state, dbatch), 1),
                "ddp_eager": (lambda: dw.train_step(dw.state, dbatch), 1),
                "plain_windowed": (lambda: plain_win(dw.state, dpool), k),
                "ddp_windowed": (lambda: dw.multi_step(dw.state, dpool), k)}
            turns = {}
            for name in ("plain_eager", "ddp_eager", "ddp_eager",
                         "plain_eager", "plain_windowed", "ddp_windowed",
                         "ddp_windowed", "plain_windowed"):
                fn, per = calls[name]
                turns.setdefault(name, []).append(
                    cuda_median_ms(fn, reps=20 if per == 1 else 8) / per)
            de_ms, dw_ms = min(turns["ddp_eager"]), min(turns["ddp_windowed"])
            rec["d"] = {"losses": dw.step_losses, "eval": res_dw["eval"],
                        "ran_windowed": ran_dw, "buckets_per_update": buckets,
                        "replays": dms.replays,
                        "eager_windows": dms.eager_windows,
                        "ms_per_update_in_turns": turns,
                        "ddp_eager_step_ms": de_ms,
                        "ddp_windowed_ms_per_update": dw_ms,
                        "ddp_added_ms_eager":
                            de_ms - min(turns["plain_eager"]),
                        "ddp_added_ms_windowed":
                            dw_ms - min(turns["plain_windowed"]),
                        "profiled_sessions": dsessions}
            print("[windows] (d) " + json.dumps(rec["d"]))
            dw.multi_step.close()
            plain_win.close()
            del dw, de, dpool, dbatch, plain, plain_win, calls
            # (b) accumulation: 2 microbatches of 64 per update.
            acc = ["--optim.grad_accum_steps=2"]
            aw = Trainer(parse_cli(_win_args(30, 64, k, acc) + [
                f"--train.ckpt_dir={os.path.join(tmp.name, 'aw')}"]))
            res_aw, ran_aw = _fit_books(aw)
            ae = Trainer(parse_cli(_win_args(30, 64, 1, acc) + [
                f"--train.ckpt_dir={os.path.join(tmp.name, 'ae')}"]))
            res_ae, ran_ae = _fit_books(ae)
            n_up = len(ae.train_pipe)
            checks.update({
                "b_updates": n_up == 30 and aw.global_batch_size == 128,
                "b_windowed": aw.multi_step.graph is not None,
                "b_losses_bit_identical": aw.step_losses == ae.step_losses,
                "b_state_bit_identical": _same_state(_flat_state(aw),
                                                     _flat_state(ae)),
                # One gradient all-reduce set per update: as many bucket
                # all-reduces as (d)'s 30 updates of one microbatch.
                "b_books": _per_update_ok(ran_aw, n_up, len(aw.test_pipe),
                                          accum=2)
                and _per_update_ok(ran_ae, n_up, len(ae.test_pipe), accum=2)
                and ran_aw["ddp_buckets"] == ran_ae["ddp_buckets"]
                == ran_de["ddp_buckets"]
                and aw.multi_step.captured["ddp_buckets"] == buckets * k,
            })
            _, apool = _first_window(aw.train_pipe, k)
            abatch = next(iter(ae.train_pipe))
            rec["b"] = {"losses": aw.step_losses, "ran_windowed": ran_aw,
                        "ran_eager": ran_ae, "eval": res_aw["eval"],
                        "eager_ms_per_update": cuda_median_ms(
                            lambda: ae.train_step(ae.state, abatch),
                            reps=10),
                        "windowed_ms_per_update": cuda_median_ms(
                            lambda: aw.multi_step(aw.state, apool),
                            reps=5) / k}
            print("[windows] (b) " + json.dumps(
                {n: rec["b"][n] for n in ("eager_ms_per_update",
                                          "windowed_ms_per_update")}))
            for t in (aw, ae):
                if t.multi_step is not None:
                    t.multi_step.close()
            del aw, ae, apool, abatch
        # (e) phase 8's interrupted and resumed run, windows of 5.
        ck_args = CKPT_ARGS + ["--train.steps_per_call=5"]
        runs = {}
        for name in ("full", "part", "resumed"):
            extra = ["--resume"] if name == "resumed" else []
            where = os.path.join(tmp.name, "e_full" if name == "full"
                                 else "e_part")
            t = Trainer(parse_cli(ck_args + extra + [
                f"--train.ckpt_dir={where}"]), device="cuda")
            if name == "part":
                real = t.train_epoch

                def train_epoch(epoch, start_step=0, _real=real):
                    if epoch == CKPT_EPOCHS - 1:
                        raise _Stop
                    return _real(epoch, start_step)

                t.train_epoch = train_epoch
            try:
                res, ran = _fit_books(t)
            except _Stop:
                t.ckpt_mgr.wait()
                res, ran = None, None
            runs[name] = (t, res, ran)
        full, part, resumed = (runs[n][0] for n in ("full", "part",
                                                    "resumed"))
        stop = (CKPT_EPOCHS - 1) * CKPT_SPE
        checks.update({
            "e_resumed_at_epoch_3": (resumed.start_epoch,
                                     resumed.start_step) == (2, 0),
            "e_epoch_3_losses_bit_identical":
                resumed.step_losses == full.step_losses[stop:],
            "e_final_state_bit_identical": _same_state(
                _flat_state(resumed), _flat_state(full)),
            "e_eval_identical": runs["resumed"][1]["eval"]
            == runs["full"][1]["eval"],
            "e_windowed": full.multi_step.graph is not None
            and resumed.multi_step.graph is not None,
            "e_books": _per_update_ok(runs["full"][2], CKPT_EPOCHS * CKPT_SPE,
                                      len(full.test_pipe))
            and _per_update_ok(runs["resumed"][2], CKPT_SPE,
                               len(resumed.test_pipe)),
        })
        rec["e"] = {"losses_full": full.step_losses,
                    "losses_resumed": resumed.step_losses,
                    "ran_full": runs["full"][2],
                    "ran_resumed": runs["resumed"][2]}
        del runs, full, part, resumed
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    rec["checks"] = checks
    out["windows"] = rec
    _print_windows("windows", out["card"], k, rec["a"],
                   f"; DDP added {rec['d']['ddp_added_ms_eager']:.3f} ms "
                   f"eager, {rec['d']['ddp_added_ms_windowed']:.3f} ms "
                   "windowed")
    failed = [n for n, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"windows checks failed: {failed}")


def _r50_args(tmp, updates=R50_STEPS, k=1, extra=()):
    """The ResNet-50 preset with the slice's kernel knobs on synthetic
    CIFAR-100 (a data root without files), B=128, ``updates`` steps in one
    epoch, windows of ``k``."""
    return ["--preset=resnet50_cifar100", "--model.fused_stages=all",
            "--model.fused_bwd=true", "--train.pallas_xent=true",
            f"--data.root={os.path.join(tmp, 'no_cifar_files')}",
            f"--data.batch_size={TRAIN_B}",
            f"--data.synthetic_train_size={updates * TRAIN_B}",
            f"--data.synthetic_test_size={2 * TRAIN_B}",
            "--train.epochs=1", "--train.log_every=10",
            f"--train.steps_per_call={k}", "--data.device_resident=off",
            *extra]


def _bottleneck_input(gen, b, h, c):
    """What a ResNet-50 bottleneck hands the kernel: the f32 output of a
    cuDNN 1x1 conv (4c -> c channels) of a post-ReLU activation, NHWC."""
    import torch
    import torch.nn.functional as F

    a = torch.relu(torch.randn(b, 4 * c, h, h, generator=gen,
                               device="cuda")).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(c, 4 * c, 1, 1, generator=gen, device="cuda") * (
        math.sqrt(2.0 / c))
    return F.conv2d(a, w).permute(0, 2, 3, 1).contiguous()


def phase_resnet50_kernels(out):
    """10a: the kernels at ResNet-50's call pattern, B=128: the conv
    kernel at the four bottleneck shapes with f32 x from a 1x1 conv, no
    residual, no emit_z: the eval variant (y within one ulp) and
    ``emit_stats`` (y within one ulp, stats bit-exact with
    `ordered_stats_sum`, bit-identical across launches, graph replays and
    a busy side stream), the input-grad (one ulp); each timed by CUDA
    events through its C entry beside its bound, its plain version and
    cuDNN bf16 (``conv2d`` / ``conv2d_input``). Then the xent mean pair at
    [128, 100], the multi-block route: within 1e-6 of the plain versions,
    bit-identical across 100 launches and 3 graph replays, device time
    beside ``F.cross_entropy``'s and the launch floor."""
    import torch
    import torch.nn.functional as F

    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx

    gen = torch.Generator(device="cuda").manual_seed(10)
    big = torch.randn(8192, 8192, generator=gen, device="cuda").to(
        torch.bfloat16)
    side = torch.cuda.Stream()
    cases, ok = [], True
    for stage, (h, c) in enumerate(STAGES):
        n = TRAIN_B * h * h * c
        flops = 2.0 * TRAIN_B * h * h * 9 * c * c
        x = _bottleneck_input(gen, TRAIN_B, h, c)
        _, w, scale, shift, _ = _case_inputs(gen, 1, h, c, torch.float32,
                                             False)
        wk = cb.pack_weight(w)
        z = cb._reference_z(x, scale, shift).to(torch.bfloat16)
        zl = z.permute(0, 3, 1, 2)
        wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        library = cuda_loop_ms(lambda: F.conv2d(zl, wl, padding=1))
        # Eval (serve and eval forwards).
        y = cb.fused_affine_relu_conv(x, wk, scale, shift)
        ref = cb.reference_affine_relu_conv(x, w, scale, shift)
        torch.cuda.synchronize()
        launch, _ = _direct_conv(cb, x, wk, scale, shift, None, False, False)
        nbytes = n * 4 * 2 + wk.numel() * 2 + 2 * c * 4
        rec = {"kind": "r50_eval", "stage": stage,
               "shape": [TRAIN_B, h, h, c], "x_dtype": "float32",
               "max_abs_err": (y - ref).abs().max().item(),
               "tol": bf16_ulp(ref.abs().max().item()),
               "tile": cb.tile_of(TRAIN_B, h, h, c),
               "ms": cuda_loop_ms(launch),
               "plain_ms": cuda_median_ms(
                   lambda: cb.reference_affine_relu_conv(x, w, scale, shift),
                   reps=10),
               "library_ms": library, "bytes": nbytes, "flops": flops}
        rec["ok"] = (bool(torch.isfinite(y).all())
                     and rec["max_abs_err"] <= rec["tol"])
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        cases.append(with_ratios(rec))
        # emit_stats (train forwards).
        got = cb.fused_conv_bn(x, wk, scale, shift)
        again = cb.fused_conv_bn(x, wk, scale, shift)
        ref = cb.reference_affine_relu_conv(x, w, scale, shift,
                                            emit_stats=True)
        torch.cuda.synchronize()
        y, st = got
        yabs = torch.stack([y.abs().sum((0, 1, 2)), (y * y).sum((0, 1, 2))])
        launch, _ = _direct_conv(cb, x, wk, scale, shift, None, False, True)
        nbytes += 2 * c * 4
        rec = {"kind": "r50_emit_stats", "stage": stage,
               "shape": [TRAIN_B, h, h, c], "x_dtype": "float32",
               "max_abs_err": (y - ref[0]).abs().max().item(),
               "tol": bf16_ulp(ref[0].abs().max().item()),
               "stats_rel_err": ((st - cb._stats_of(y)).abs()
                                 / yabs).max().item(),
               "stats_bit_identical": bool(torch.equal(st, again[-1])),
               "y_bit_identical": bool(torch.equal(y, again[0])),
               "tile": cb.tile_of(TRAIN_B, h, h, c),
               "ms": cuda_loop_ms(launch),
               "plain_ms": cuda_median_ms(
                   lambda: cb.reference_affine_relu_conv(
                       x, w, scale, shift, emit_stats=True), reps=10),
               "library_ms": library, "bytes": nbytes, "flops": flops}
        rec.update(_fold_checks(cb, x, wk, scale, shift, None, False, st,
                                big, side))
        rec["ok"] = (rec["max_abs_err"] <= rec["tol"]
                     and rec["stats_rel_err"] <= 1e-5
                     and rec["stats_bit_identical"]
                     and rec["y_bit_identical"] and rec["fold_ok"])
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        cases.append(with_ratios(rec))
        # The input-grad (the backward of every train step).
        ct = torch.randn(TRAIN_B, h, h, c, generator=gen,
                         device="cuda").to(torch.bfloat16)
        wf = cb.flip_packed(w)
        one = torch.ones(c, device="cuda")
        zero = torch.zeros(c, device="cuda")
        dz = cb._run(ct, wf, one, zero, None, False, False,
                     role="input_grad")
        ref = cb.reference_affine_relu_conv(ct, wf, one, zero,
                                            activate=False)
        torch.cuda.synchronize()
        launch, _ = _direct_conv(cb, ct, wf, one, zero, None, False, False,
                                 act=False)
        ctl = ct.permute(0, 3, 1, 2)
        wl2 = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
        nbytes = n * 2 * 2 + wf.numel() * 2
        rec = {"kind": "r50_input_grad", "stage": stage,
               "shape": [TRAIN_B, h, h, c],
               "max_abs_err": (dz.float() - ref.float()).abs().max().item(),
               "tol": bf16_ulp(ref.float().abs().max().item()),
               "ms": cuda_loop_ms(launch),
               "plain_ms": cuda_median_ms(
                   lambda: cb.reference_affine_relu_conv(
                       ct, wf, one, zero, activate=False), reps=10),
               "library_ms": cuda_loop_ms(
                   lambda: torch.nn.grad.conv2d_input(
                       ctl.shape, wl2, ctl, padding=1)),
               "bytes": nbytes, "flops": flops}
        rec["ok"] = rec["max_abs_err"] <= rec["tol"]
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        cases.append(with_ratios(rec))
        for r in cases[-3:]:
            ok &= r["ok"]
            print("[resnet50-kernel] " + json.dumps(r))
    del big, side
    # The xent mean pair at [128, 100]: the multi-block route.
    b, c = TRAIN_B, R50_CLASSES
    lg = 3.0 * torch.randn(b, c, generator=gen, device="cuda")
    lb = torch.randint(0, c, (b,), generator=gen, device="cuda")
    ct = torch.tensor(1.3, device="cuda")
    x = _xent_mean_parity(lg, lb, ct)
    lref = lg.clone().requires_grad_()
    floor = _launch_floor(b)
    nbytes = b * c * 4 + b * 8 + 4
    x.update({
        "route": "one_cta" if tx._one_cta(b, c) else "multi_block",
        "fwd_ms": device_ms(lambda: tx._fwd(lg, lb, True)),
        "bwd_ms": device_ms(lambda: tx._bwd(lg, lb, ct, True)),
        "fwd_plain_ms": device_ms(lambda: tx._plain_fwd(lg, lb).mean()),
        "bwd_plain_ms": device_ms(lambda: tx._plain_bwd(
            lg, lb, (ct / b).expand(b))),
        "fwd_library_ms": device_ms(lambda: F.cross_entropy(lg, lb)),
        "bwd_library_ms": device_ms(lambda: torch.autograd.grad(
            F.cross_entropy(lref, lb), lref, ct)),
        "floor_ms": device_ms(floor), "fwd_bytes": nbytes,
        "bwd_bytes": nbytes + b * c * 4})
    # ~10 operations per element (exp, max, add, divide), f32.
    for d in ("fwd", "bwd"):
        x[f"{d}_bound_ms"], x[f"{d}_bound_by"] = bound(
            x[f"{d}_bytes"], 10.0 * b * c, PEAK_F32_FLOPS)
    x["ok"] = (x["route"] == "multi_block" and x["fwd_rel_err"] <= 1e-6
               and x["bwd_rel_err"] <= 1e-6
               and x["fwd_bit_identical_100_launches"]
               and x["bwd_bit_identical_100_launches"]
               and all(x["graph_replays_bit_identical"]))
    ok &= x["ok"]
    print("[resnet50-kernel] xent " + json.dumps(x))
    out["resnet50_kernels"] = {"conv": cases, "xent": x,
                               "card": out["card"]}
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version at "
                             "ResNet-50's call pattern")
    print(f"[resnet50-kernel] {out['card']}: all {len(cases)} conv cases "
          f"within one bf16 ulp, stats bit-exact with ordered_stats_sum; "
          f"xent [128, 100] ({x['route']}) forward {1e3 * x['fwd_ms']:.2f} "
          f"us, backward {1e3 * x['bwd_ms']:.2f} us, floor "
          f"{1e3 * x['floor_ms']:.2f} us")


def phase_resnet50(out):
    """10b: ResNet-50 on synthetic CIFAR-100 (``--preset=resnet50_cifar100
    --model.fused_stages=all --model.fused_bwd=true
    --train.pallas_xent=true``, f32, B=128): `Trainer` for 30 steps and
    one eval (finite losses; 13 + 13 conv and 1 + 1 xent launches a step
    by the wrappers' counters and by kernel name under the profiler, 13
    per eval forward; the first 5 losses, and all 30, within 0.05 of the
    same init and batches run unfused without kernels; the eval
    count the test set; step ms, images/s, device busy share, ops, top
    kernels, peak memory); its epoch save served by
    `InferenceEngine.from_checkpoint` (buckets 1..32, 50 Poisson requests:
    audited books, 13 conv launches a forward, bucket-32 logits
    bit-identical to the trained model's eval forward, cuDNN
    deterministic); the same 30 steps with augmentation off, whose loss
    falls (with the preset's augmentation the synthetic set's loss rises
    over the 30 warm-up steps, fused and unfused alike); and the
    random-weight ResNet-50 behind the engine (phase 5's traffic and
    checks, 13 launches a forward)."""
    import numpy as np
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx
    from tpu_dp_torch.serve import InferenceEngine, run_load
    from tpu_dp_torch.train.step import _maybe_normalize
    from tpu_dp_torch.train.trainer import Trainer

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_r50_")
    try:
        ckpt = os.path.join(tmp.name, "train")
        args = _r50_args(tmp.name, extra=[f"--train.ckpt_dir={ckpt}"])
        trainer = Trainer(parse_cli(args), device="cuda")
        steps, evals = len(trainer.train_pipe), len(trainer.test_pipe)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cb.reset_launches()
        tx.reset_launches()
        result = trainer.fit()
        torch.cuda.synchronize()
        trainer.ckpt_mgr.wait()
        counts = {"conv": dict(cb.launches_by_role),
                  "conv_total": cb.launches, "xent": dict(tx.launches)}
        peak = torch.cuda.max_memory_allocated()
        losses = trainer.step_losses
        ev = result["eval"]
        checks = {
            "synthetic_cifar100": trainer.train_ds.synthetic
            and trainer.train_ds.num_classes == R50_CLASSES
            and trainer.model.num_classes == R50_CLASSES,
            "xent_multi_block_route": not tx._one_cta(TRAIN_B, R50_CLASSES),
            "steps": steps == R50_STEPS and len(losses) == steps,
            "losses_finite": all(math.isfinite(v) for v in losses),
            "conv_stats_13_per_step": counts["conv"]["stats"] == 13 * steps,
            "conv_input_grad_13_per_step":
                counts["conv"]["input_grad"] == 13 * steps,
            "conv_eval_13_per_eval_forward":
                counts["conv"]["eval"] == 13 * evals,
            "xent_1_and_1_per_step":
                counts["xent"] == {"forward": steps, "backward": steps},
            "eval_count_is_test_set": ev["count"] == len(trainer.test_ds),
        }
        # The epoch save, served, before the trained model takes another
        # step (cuDNN deterministic: the same algorithms for the served
        # and the trained forward).
        det = (torch.backends.cudnn.deterministic,
               torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            engine = InferenceEngine.from_checkpoint(
                ckpt, device="cuda", buckets=(1, 2, 4, 8, 16, 32),
                slo_ms=250.0)
            cb.reset_launches()
            engine.start()
            try:
                report = run_load(engine, n_requests=CKPT_SERVE_REQUESTS,
                                  pattern="poisson", rate_rps=400.0,
                                  sizes=(1, 2, 3, 4), seed=3)
            finally:
                engine.stop()
            served_launches = cb.launches
            forwards = len(engine.replica.warmup_ms) + report["batches"]
            imgs = torch.from_numpy(np.random.default_rng(4).integers(
                0, 256, (32, 32, 32, 3), dtype=np.uint8)).cuda()
            trainer.model.eval()
            with torch.inference_mode():
                x = _maybe_normalize(imgs)
                served = engine.model(x)
                trained = trainer.model(x)
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = det
        truth, dev = report["ground_truth"], report["device_stats"]
        checks.update({
            "serve_ckpt_resnet50_100_classes":
                engine.num_classes == R50_CLASSES
                and type(engine.model.BottleneckBlock_0).__name__
                == "BottleneckBlock",
            "serve_ckpt_consistent": report["consistent"],
            "serve_ckpt_served_eq_images":
                dev["served"] == truth["images_served"],
            "serve_ckpt_13_launches_per_forward":
                served_launches == 13 * forwards,
            "serve_ckpt_b32_logits_bit_identical_to_trained":
                torch.equal(served, trained),
        })
        serve_ckpt = {"batches": report["batches"], "forwards": forwards,
                      "conv_launches": served_launches,
                      "p50_ms": (report["latency_ms"] or {}).get("p50_ms"),
                      "images_served": truth["images_served"],
                      "b32_max_abs_diff":
                          (served - trained).abs().max().item()}
        del engine
        # The same init, batches, augmentation and schedule, unfused and
        # without kernels (cuDNN convs, cross_entropy_loss, TF32 off).
        ref = Trainer(parse_cli(args + [
            "--model.fused_stages=", "--model.fused_bwd=false",
            "--train.pallas_xent=false"]), device="cuda")
        before = (cb.launches, dict(tx.launches))
        ref.train_pipe.set_epoch(0)
        ref_losses = torch.stack([ref.train_step(ref.state, batch)["loss"]
                                  for batch in ref.train_pipe]).tolist()
        diffs = [abs(a - b) for a, b in zip(losses, ref_losses)]
        checks["first5_track_unfused"] = max(diffs[:5]) <= DDP_LOSS_TOL
        # All 30: the warm-up lr moves little in 5 steps, and a run that
        # stopped updating would stay near its first losses while the
        # unfused run's climb by about 0.4 under the preset's augmentation.
        checks["all_steps_track_unfused"] = max(diffs) <= DDP_LOSS_TOL
        checks["reference_runs_no_kernel"] = before == (cb.launches,
                                                        dict(tx.launches))
        # Augmentation off: the loss falls within the 30 steps.
        noaug = Trainer(parse_cli(_r50_args(tmp.name, extra=[
            "--data.augment=false",
            f"--train.ckpt_dir={os.path.join(tmp.name, 'noaug')}"])),
            device="cuda")
        noaug_result = noaug.fit()
        nl = noaug.step_losses
        checks["augment_off_losses_finite_and_fall"] = (
            len(nl) == R50_STEPS and all(math.isfinite(v) for v in nl)
            and statistics.mean(nl[-5:]) < statistics.mean(nl[:5]))
        batch = next(iter(trainer.train_pipe))
        trainer.model.train()
        step = lambda: trainer.train_step(trainer.state, batch)  # noqa: E731
        step_ms = cuda_median_ms(step, reps=20)
        ref_step_ms = cuda_median_ms(lambda: ref.train_step(ref.state,
                                                            batch), reps=10)
        ok, sessions = _profiled_books(
            step, {"conv_block_kernel": 26, "xent_fwd": 1, "xent_bwd": 1})
        checks["profiled_26_conv_1_1_xent_per_step"] = ok
        prof = profile_forward(step, 5, cuda_only=True)
        checks["no_stats_reduce_kernel"] = not any(
            "stats_reduce" in n for n in prof["kernel_names"])
        rec = {
            "steps": steps, "eval_forwards": evals, "launches": counts,
            "losses": losses, "unfused_losses": ref_losses,
            "first5_max_abs_diff": max(diffs[:5]),
            "all_steps_max_abs_diff": max(diffs), "eval": ev,
            "augment_off_losses": nl,
            "augment_off_eval": noaug_result["eval"],
            "fit_wall_s": result["wall_time_s"],
            "fit_images_per_s_meter": result["images_per_sec"],
            "step_ms": step_ms, "images_per_s": TRAIN_B / (step_ms / 1e3),
            "unfused_step_ms": ref_step_ms,
            "device_busy_share": prof["device_busy_share"],
            "device_busy_us_per_step": prof["device_busy_us_per_call"],
            "device_ops_per_step": prof["kernel_launches_per_call"],
            "top_kernels": prof["top"], "profiled_sessions": sessions,
            "peak_memory_bytes": peak, "held_before_fit_bytes": held,
            "serve_ckpt": serve_ckpt, "card": out["card"]}
        print(f"[resnet50] {out['card']}: {steps} steps, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} (unfused within "
              f"{max(diffs[:5]):.4f} over 5 steps, {max(diffs):.4f} over "
              f"{steps}; augmentation off {nl[0]:.4f} -> {nl[-1]:.4f}), "
              f"eval {ev['count']} images accuracy {ev['accuracy']:.4f}; "
              f"step {step_ms:.3f} ms = {rec['images_per_s']:.0f} images/s "
              f"(fit's meter {result['images_per_sec']:.1f}; unfused, no "
              f"kernels: {ref_step_ms:.3f} ms); device busy "
              f"{100 * prof['device_busy_share']:.1f}%, "
              f"{prof['kernel_launches_per_call']:.0f} device ops a step; "
              f"peak memory {peak / 2**20:.1f} MiB")
        del trainer, ref, noaug
    finally:
        tmp.cleanup()
    # The random-weight ResNet-50 behind the engine (phase 5's traffic).
    rec["serve"] = _serve_run("resnet50", R50_CLASSES, 13, out["card"])
    _print_serve("resnet50-serve", rec["serve"])
    checks.update({f"serve_{k}": v for k, v in rec["serve"]["checks"].items()})
    rec["checks"] = checks
    out["resnet50"] = rec
    print("[resnet50] " + json.dumps(rec, default=str))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"resnet50 checks failed: {failed}")


def phase_resnet50_windows(out):
    """10c: ResNet-50 windows, phase 9's (a) and (c) (`_windows_vs_eager`)
    with augmentation off, under cuDNN deterministic: 40 eager updates
    against ``--train.steps_per_call=10`` (the xent mean at [128, 100] on
    its multi-block route, ticket counters and all, inside the graph),
    13 + 13 conv launches an update; and ``--train.steps_per_call=0``
    (auto: windows of 24) over 48 updates, which must fit."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer

    k, updates = R50_K, R50_WIN_UPDATES
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_r50_win_")
    noaug = ["--data.augment=false"]
    try:
        checks, rec = _windows_vs_eager(
            out, lambda n, kk: _r50_args(tmp.name, n, kk, noaug), k,
            updates, 13, tmp.name)
        rec.update({"card": out["card"], "k": k})
        # Auto windows: min(24, steps per epoch) = 24 over 48 updates.
        torch.cuda.reset_peak_memory_stats()
        auto = Trainer(parse_cli(_r50_args(tmp.name, 48, 0, noaug) + [
            f"--train.ckpt_dir={os.path.join(tmp.name, 'auto')}"]),
            device="cuda")
        res_a, ran_a = _fit_books(auto)
        am = auto.multi_step
        checks.update({
            "auto_windows_of_24": auto.steps_per_call == 24
            and am.graph is not None and am.replays == 1,
            "auto_books": _per_update_ok(ran_a, 48, len(auto.test_pipe),
                                         convs=13),
            "auto_losses_finite": all(math.isfinite(v)
                                      for v in auto.step_losses),
        })
        rec["auto"] = {"k": auto.steps_per_call,
                       "capture_ms": am.capture_ms,
                       "capture_bytes": am.capture_bytes,
                       "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                       "eval": res_a["eval"]}
        am.close()
        del auto, am
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    rec["checks"] = checks
    out["resnet50_windows"] = rec
    print("[resnet50-windows] " + json.dumps(rec, default=str))
    _print_windows("resnet50-windows", out["card"], k, rec,
                   f"; windows of 24: capture "
                   f"{rec['auto']['capture_bytes'] / 2**20:.1f} MiB, peak "
                   f"{rec['auto']['peak_memory_bytes'] / 2**20:.1f} MiB")
    failed = [n for n, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"resnet50 windows checks failed: {failed}")


def phase_resnet50_ddp(out):
    """10d: ResNet-50 data-parallel in phase 7b's form
    (`_world1_vs_one_process`): 5 steps with augmentation off, 13 + 13
    conv launches an update."""
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_r50_ddp_")
    try:
        _world1_vs_one_process(
            out, "resnet50_ddp",
            _r50_args(tmp.name, DDP_STEPS, extra=["--data.augment=false"]),
            DDP_STEPS, convs=13)
    finally:
        tmp.cleanup()


def _exchange_books(opt, updates: int) -> dict[str, int]:
    """The sharded update's collectives for ``updates`` updates of the
    optimizer ``opt``'s exchange plan: a reduce-scatter per f32/bf16
    exchange, two all-to-alls (payload, scales) per int8 one, one
    all-gather of the parameters."""
    q = sum(ex.quantizes for ex in opt.exchanges)
    return {"reduce_scatter": (len(opt.exchanges) - q) * updates,
            "all_to_all": 2 * q * updates, "all_gather": updates}


def _sharded_args(wire: str, bucket_mb: float) -> list[str]:
    return (["--train.update_sharding=sharded"]
            + ([f"--train.collective_dtype={wire}"] if wire else [])
            + ([f"--train.bucket_mb={bucket_mb:g}"] if bucket_mb else []))


def _wire_name(wire: str, bucket_mb: float) -> str:
    return (wire or "f32") + (f"@{bucket_mb:g}MB" if bucket_mb else "")


def _same_values(a: dict, b: dict) -> bool:
    """`_same_state` up to the momentum's layout (a replicated save keeps
    each leaf's shape, a sharded one at world 1 the same values flat)."""
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].size == b[k].size
        and a[k].tobytes() == b[k].tobytes() for k in a)


def _sharded_fit(args, where, snapshot_at=6):
    """A `Trainer` on ``args`` run to the end with its books
    (`_fit_books`); its parameters just before update ``snapshot_at``,
    its state, one update's books by kernel name and step ms after."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t = Trainer(parse_cli(args + [f"--train.ckpt_dir={where}"]))
    snap = {}
    real = t.train_step

    def step(state, batch):
        if state.step == snapshot_at:
            snap.update({k: p.detach().clone() for k, p in
                         t.model.named_parameters()})
        return real(state, batch)

    t.train_step = step
    res, ran = _fit_books(t)
    # What this run added at its peak (earlier runs' trainers stay).
    peak = torch.cuda.max_memory_allocated() - before
    batch = next(iter(t.train_pipe))
    ok, sessions = _profiled_books(
        lambda: real(t.state, batch),
        {"conv_block_kernel": 20, "xent_fwd": 1, "xent_bwd": 1})
    rec = {"t": t, "res": res, "ran": ran, "params6": snap,
           "state": _flat_state(t), "profiled_ok": ok,
           "profiled": sessions[-1], "peak_memory_bytes": peak,
           "step_ms": cuda_median_ms(lambda: real(t.state, batch), reps=20)}
    return rec


def phase_sharded(out):
    """11: the sharded weight update on the card (see the module
    docstring): (a) each wire's 30 updates against the replicated run,
    books and memory, (b) windows of 10 under each wire beside the
    replicated windows, (c) an int8 resume, (d) ResNet-50 int8."""
    import torch

    from tpu_dp_torch.compat import leaf_sizes
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.parallel import collectives, quant
    from tpu_dp_torch.train.trainer import Trainer

    k, updates = 10, 40
    checks, rec = {}, {"card": out["card"], "k": k}
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_")
    try:
        # (b, replicated) windows without a group: phase 9a's run.
        _, rec["windows_replicated"] = _windows_vs_eager(
            out, lambda n, kk: _win_args(n, k=kk), k, updates, 10,
            os.path.join(tmp.name, "wr"))
        with _nccl_world1_env(TORCH_NCCL_ASYNC_ERROR_HANDLING="0"):
            # (a) 30 updates per wire against the replicated (DDP) run.
            runs = {"replicated": _sharded_fit(
                TRAIN_ARGS, os.path.join(tmp.name, "a_rep"))}
            for wire, mb in SHARDED_WIRES:
                runs[(wire, mb)] = _sharded_fit(
                    TRAIN_ARGS + _sharded_args(wire, mb),
                    os.path.join(tmp.name, f"a_{wire}_{mb:g}"))
            rep = runs["replicated"]
            f32 = {mb: runs[("", mb)] for mb in (0.0, 25.0)}
            a = {}
            for (wire, mb), r in ((key, v) for key, v in runs.items()
                                  if key != "replicated"):
                t, name = r["t"], _wire_name(wire, mb)
                losses = t.step_losses
                opt = t.optimizer
                hist = r["res"]["history"][-1]
                c = {"nccl_world_1": (t.ctx.backend, t.ctx.world) == (
                        "nccl", 1) and opt.group is not None,
                     "losses_finite_and_fall": all(
                         math.isfinite(v) for v in losses)
                     and statistics.mean(losses[-5:])
                     < statistics.mean(losses[:5]),
                     "books": _per_update_ok(r["ran"], TRAIN_STEPS,
                                             len(t.test_pipe))
                     and all(r["ran"][n] == v for n, v in _exchange_books(
                         opt, TRAIN_STEPS).items())
                     and r["ran"]["ddp_buckets"] == r["ran"]["psum"] == 0,
                     "profiled_books": r["profiled_ok"]}
                if not wire:
                    c["bit_identical_to_replicated"] = (
                        losses == rep["t"].step_losses
                        and _same_values(r["state"], rep["state"]))
                else:
                    ref = f32[mb]["params6"]
                    diff = max(float((r["params6"][n] - ref[n]).abs().max())
                               for n in ref)
                    c["within_wire_contract_after_6"] = diff <= WIRE_TOL[wire]
                    c["not_f32"] = diff > 0
                    if wire == "int8":
                        c["quant_overflow_0"] = hist["quant_overflow"] == 0
                mom = (opt.momentum_shard.numel()
                       * opt.momentum_shard.element_size())
                res_bytes = sum(v.numel() * v.element_size()
                                for v in opt.residual_rows.values())
                a[name] = {
                    "losses": losses, "eval": r["res"]["eval"],
                    "ran": r["ran"], "exchanges": len(opt.exchanges),
                    "quant": {n: hist.get(n) for n in ("quant_overflow",
                                                       "quant_clip")},
                    "max_abs_diff_after_6": None if not wire else diff,
                    "step_ms": r["step_ms"],
                    "profiled_per_update": r["profiled"],
                    "momentum_bytes_per_rank": mom,
                    "residual_bytes_per_rank": res_bytes,
                    "peak_memory_bytes": r["peak_memory_bytes"],
                    "checks": c}
                checks.update({f"a_{name}_{n}": v for n, v in c.items()})
            leaves = leaf_sizes(rep["t"].model.named_parameters())
            rec["a"] = {
                "replicated": {"losses": rep["t"].step_losses,
                               "step_ms": rep["step_ms"],
                               "profiled_per_update": rep["profiled"],
                               "momentum_bytes_per_rank": 4 * sum(
                                   n for _, n in leaves),
                               "peak_memory_bytes": rep["peak_memory_bytes"]},
                **a,
                # Counted from the layout (not measured): what a rank of a
                # larger group holds.
                "momentum_bytes_per_rank_by_world": {
                    w: 4 * sum(collectives.shard_size(n, w)
                               for _, n in leaves) for w in (1, 2, 4, 8)},
                "int8_residual_bytes_per_rank_by_world": {
                    w: 4 * sum(v.shape[1] for v in quant.init_residuals(
                        leaves, w).values()) for w in (1, 2, 4, 8)},
                "wire_report_world_4": quant.wire_report(leaves, 4)}
            print("[sharded] (a) " + json.dumps(
                {n: {m: v[m] for m in ("step_ms", "max_abs_diff_after_6",
                                       "quant", "exchanges",
                                       "momentum_bytes_per_rank",
                                       "residual_bytes_per_rank",
                                       "peak_memory_bytes")}
                 for n, v in a.items()}))
            for r in runs.values():
                if r["t"].multi_step is not None:
                    r["t"].multi_step.close()
            del runs, rep, f32
            # (b) windows of 10 against eager, per wire.
            rec["b"] = {}
            for wire, mb in (("", 0.0), ("bf16", 0.0), ("int8", 0.0),
                             ("int8", 25.0)):
                name = _wire_name(wire, mb)
                extra = _sharded_args(wire, mb)
                w_checks, w_rec = _windows_vs_eager(
                    out, lambda n, kk, e=extra: _win_args(n, k=kk, extra=e),
                    k, updates, 10, os.path.join(tmp.name, f"b_{name}"))
                checks.update({f"b_{name}_{n}": v
                               for n, v in w_checks.items()})
                rec["b"][name] = {n: v for n, v in w_rec.items()
                                  if n not in ("ran_eager",)}
                print(f"[sharded] (b) {name}: " + json.dumps(
                    {n: w_rec[n] for n in ("eager_step_ms",
                                           "windowed_ms_per_update",
                                           "images_per_s_meter",
                                           "capture_bytes")}))
            # (c) phase 8's interrupted and resumed run under int8 at 25 MB.
            ck_args = CKPT_ARGS + _sharded_args("int8", 25.0)
            cruns = {}
            for name in ("full", "part", "resumed"):
                extra = ["--resume"] if name == "resumed" else []
                where = os.path.join(tmp.name, "c_full" if name == "full"
                                     else "c_part")
                t = Trainer(parse_cli(ck_args + extra + [
                    f"--train.ckpt_dir={where}"]))
                if name == "part":
                    real = t.train_epoch

                    def train_epoch(epoch, start_step=0, _real=real):
                        if epoch == CKPT_EPOCHS - 1:
                            raise _Stop
                        return _real(epoch, start_step)

                    t.train_epoch = train_epoch
                try:
                    res, ran = _fit_books(t)
                except _Stop:
                    t.ckpt_mgr.wait()
                    res, ran = None, None
                cruns[name] = (t, res, ran)
            full, resumed = cruns["full"][0], cruns["resumed"][0]
            stop = (CKPT_EPOCHS - 1) * CKPT_SPE
            fstate = _flat_state(full)
            checks.update({
                "c_resumed_at_epoch_3": (resumed.start_epoch,
                                         resumed.start_step) == (2, 0),
                "c_epoch_3_losses_bit_identical":
                    resumed.step_losses == full.step_losses[stop:],
                "c_final_state_bit_identical": _same_state(
                    _flat_state(resumed), fstate),
                "c_residuals_saved": any(n.startswith("residuals/")
                                         for n in fstate),
                "c_eval_identical": cruns["resumed"][1]["eval"]
                == cruns["full"][1]["eval"],
            })
            rec["c"] = {"losses_full": full.step_losses,
                        "losses_resumed": resumed.step_losses}
            del cruns, full, resumed
            # (d) ResNet-50, int8 at 25 MB, 10 updates.
            r50 = Trainer(parse_cli(_r50_args(
                tmp.name, 10, extra=["--data.augment=false"]
                + _sharded_args("int8", 25.0)
                + [f"--train.ckpt_dir={os.path.join(tmp.name, 'd')}"])))
            res50, ran50 = _fit_books(r50)
            checks.update({
                "d_r50_losses_finite": len(r50.step_losses) == 10 and all(
                    math.isfinite(v) for v in r50.step_losses),
                "d_r50_books": _per_update_ok(ran50, 10, len(r50.test_pipe),
                                              convs=13)
                and all(ran50[n] == v for n, v in _exchange_books(
                    r50.optimizer, 10).items()),
                "d_r50_exchanges_4_buckets": len(r50.optimizer.exchanges)
                == 4})
            rec["d"] = {"losses": r50.step_losses, "ran": ran50,
                        "exchanges": [ex.quantizes for ex in
                                      r50.optimizer.exchanges],
                        "quant": {n: res50["history"][-1].get(n) for n in
                                  ("quant_overflow", "quant_clip")}}
            del r50
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    rec["checks"] = checks
    out["sharded"] = rec
    b = rec["b"]
    print(f"[sharded] {out['card']}: eager step / windowed ms per update: "
          f"replicated {rec['windows_replicated']['eager_step_ms']:.3f} / "
          f"{rec['windows_replicated']['windowed_ms_per_update']:.3f}; "
          + "; ".join(f"{n} {v['eager_step_ms']:.3f} / "
                      f"{v['windowed_ms_per_update']:.3f}"
                      for n, v in b.items()))
    failed = [n for n, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"sharded checks failed: {failed}")


@contextlib.contextmanager
def _shared_datasets():
    """Each synthetic set made once for the `Trainer`s built inside the
    block: a 50,000-image set takes seconds of host work per build, and
    the trainers only read it."""
    from tpu_dp_torch.train import trainer as trainer_mod

    real, made = trainer_mod.load_dataset, {}

    def load(*args, **kwargs):
        key = json.dumps([args, sorted(kwargs.items())], default=str)
        if key not in made:
            made[key] = real(*args, **kwargs)
        return made[key]

    trainer_mod.load_dataset = load
    try:
        yield
    finally:
        trainer_mod.load_dataset = real


def _res_args(feed, k, extra=()):
    return RES_ARGS + [f"--data.device_resident={feed}",
                       f"--train.steps_per_call={k}", *extra]


def _feed_run(args, where):
    """A `Trainer` on ``args`` (saves under ``where``) fit once with its
    books (`_fit_books`), the device memory its fit added at its peak, and
    its staging: the first touch of `resident_train`, synchronized."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer

    t = Trainer(parse_cli(args + [f"--train.ckpt_dir={where}"]))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    table = t.resident_train
    torch.cuda.synchronize()
    stage_ms = 1e3 * (time.perf_counter() - t0) if table is not None else None
    res, ran = _fit_books(t)
    return {"t": t, "res": res, "ran": ran, "stage_ms": stage_ms,
            "peak_added_bytes": torch.cuda.max_memory_allocated() - before,
            "state": _flat_state(t)}


def _placed_bytes(item) -> int:
    ts = [item] if not isinstance(item, dict) else list(item.values())
    return sum(t.numel() * t.element_size() for t in ts)


def phase_resident(out):
    """12: the device-resident feed (``data.device_resident``) on the
    fused full-width ResNet-18 (`RES_ARGS`: the preset, augmentation on,
    f32, B=128, a 50,000-image synthetic train set, the real CIFAR-10
    table's 153.8 MB), cuDNN deterministic. One epoch (390 updates)
    resident and streamed, eager and in windows of 24: losses, parameters,
    BN statistics, momentum and the eval bit-identical, the same launch
    books per update (10 + 10 conv, 1 + 1 xent); the same pair in four
    windows under ``update_sharding=sharded`` f32 at NCCL world 1; a
    resident run interrupted 240 updates in (a snapshot-kind save) and
    resumed in windows re-formed from there, bit-identical to the
    uninterrupted run;
    a call with a re-staged table recaptures the window. Printed: staging
    ms and table bytes, H2D bytes per window, the feed's and the step
    call's host ms per window, windowed ms per update in turns, epoch
    images/s, device busy share, each fit's added peak memory."""
    import torch

    from tpu_dp_torch.checkpoint import CheckpointManager
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.step import _table_key
    from tpu_dp_torch.train.trainer import Trainer

    k = RES_K
    checks, rec = {}, {"card": out["card"], "k": k}
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_resident_")
    try:
        with _shared_datasets():
            runs = {}
            for feed in ("on", "off"):
                for kk in (k, 1):
                    runs[(feed, kk)] = _feed_run(
                        _res_args(feed, kk),
                        os.path.join(tmp.name, f"{feed}{kk}"))
            rw, sw = runs[("on", k)]["t"], runs[("off", k)]["t"]
            updates, evals = len(rw.train_pipe), len(rw.test_pipe)
            table = rw.resident_train
            ref = runs[("on", k)]
            for (feed, kk), r in runs.items():
                tag = f"{'resident' if feed == 'on' else 'streamed'}_{kk}"
                checks[f"{tag}_feed"] = ((r["t"].resident_train is not None)
                                         == (feed == "on"))
                checks[f"{tag}_books"] = _per_update_ok(r["ran"], updates,
                                                        evals)
                checks[f"{tag}_losses_bit_identical"] = (
                    r["t"].step_losses == ref["t"].step_losses)
                checks[f"{tag}_state_bit_identical"] = _same_state(
                    r["state"], ref["state"])
                checks[f"{tag}_eval_identical"] = (r["res"]["eval"]
                                                   == ref["res"]["eval"])
            losses = rw.step_losses
            checks.update({
                "epoch_is_390_updates": updates == 390
                and len(losses) == updates,
                "table_is_the_cifar10_size": rw.train_pipe.dataset_bytes()
                == 153_800_000,
                "windowed": rw.multi_step.graph is not None
                and sw.multi_step.graph is not None,
                "losses_finite": all(math.isfinite(v) for v in losses),
            })
            # Speed, in one call: windowed ms per update in turns
            # (streamed, resident, resident, streamed), host ms per call
            # of the window, the feed's host ms to place one window.
            _, idx = next(iter(rw.train_pipe.index_windows(k)))
            _, pool = _first_window(sw.train_pipe, k)
            calls = {"resident": lambda: rw.multi_step(rw.state, table, idx),
                     "streamed": lambda: sw.multi_step(sw.state, pool)}
            turns = {}
            for name in ("streamed", "resident", "resident", "streamed"):
                turns.setdefault(name, []).append(
                    cuda_median_ms(calls[name], reps=6) / k)
            host, feed_ms, busy = {}, {}, {}
            take = rw.train_pipe.sampler.shard_indices()[:k * TRAIN_B]
            place = {
                "resident": lambda: rw.train_pipe._place_indices(take, k),
                "streamed": lambda: sw.train_pipe._place(
                    take, None, (k, TRAIN_B))}
            for name, fn in calls.items():
                ts = []
                for _ in range(7):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    ts.append(1e3 * (time.perf_counter() - t0))
                host[name] = statistics.median(ts)
                fs = []
                for _ in range(7):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    place[name]()
                    torch.cuda.synchronize()
                    fs.append(1e3 * (time.perf_counter() - t0))
                feed_ms[name] = statistics.median(fs)
                busy[name] = profile_forward(fn, 2, cuda_only=True)[
                    "device_busy_share"]
            # A re-staged table (another address) releases the graph and
            # captures anew.
            clone = {n: t.clone() for n, t in table.items()}
            rw.multi_step(rw.state, clone, idx)
            torch.cuda.synchronize()
            checks["restaged_table_recaptures"] = (
                rw.multi_step.graph is not None
                and rw.multi_step._captured_key == _table_key(clone))
            del clone
            rec.update({
                "updates": updates, "losses": losses,
                "eval": ref["res"]["eval"],
                "ran": {f"{f}_{kk}": r["ran"] for (f, kk), r in runs.items()},
                "staging_ms": ref["stage_ms"],
                "table_device_bytes": sum(t.numel() * t.element_size()
                                          for t in table.values()),
                "table_host_bytes": rw.train_pipe.dataset_bytes(),
                "h2d_bytes_per_window": {"resident": _placed_bytes(idx),
                                         "streamed": _placed_bytes(pool)},
                "windowed_ms_per_update_in_turns": turns,
                "windowed_ms_per_update": {n: min(v)
                                           for n, v in turns.items()},
                "host_ms_per_window_call": host,
                "feed_host_ms_per_window": feed_ms,
                "device_busy_share_windowed": busy,
                "epoch_images_per_s": {
                    f"{'resident' if f == 'on' else 'streamed'}_"
                    f"{'windowed' if kk > 1 else 'eager'}":
                        r["res"]["images_per_sec"]
                    for (f, kk), r in runs.items()},
                "fit_peak_added_bytes": {
                    f"{'resident' if f == 'on' else 'streamed'}_{kk}":
                        r["peak_added_bytes"] for (f, kk), r in runs.items()},
                "capture_ms": rw.multi_step.capture_ms,
            })
            for r in runs.values():
                if r["t"].multi_step is not None:
                    r["t"].multi_step.close()
            del runs, rw, sw, table, idx, pool, calls, place
            # A mid-epoch resident resume: interrupted before update 240
            # (a snapshot-kind save there), resumed in windows re-formed
            # from it; against the uninterrupted resident windowed run
            # (its losses, state and eval as its fit left them).
            stop = 10 * k
            full = {"losses": list(ref["t"].step_losses),
                    "state": ref["state"], "eval": ref["res"]["eval"]}
            del ref
            where = os.path.join(tmp.name, "part")
            part = Trainer(parse_cli(_res_args("on", k) + [
                f"--train.ckpt_dir={where}"]))
            real = part.multi_step

            def window(state, table, idx):
                if state.step == stop:
                    raise _Stop
                return real(state, table, idx)

            part.multi_step = window
            try:
                part.fit()
            except _Stop:
                part.ckpt_mgr.wait()
            cfg = part.cfg
            CheckpointManager(part.snapshot_dir, async_save=False).save(
                part.state, {"kind": "snapshot", "epoch": 0,
                             "steps_done": stop, "config": cfg.to_dict(),
                             "seed": cfg.train.seed})
            real.close()
            resumed = Trainer(parse_cli(_res_args("on", k) + [
                f"--train.ckpt_dir={where}", "--resume"]))
            res_r, ran_r = _fit_books(resumed)
            checks.update({
                "resume_at_update_240": (resumed.start_epoch,
                                         resumed.start_step) == (0, stop),
                "resume_losses_bit_identical":
                    resumed.step_losses == full["losses"][stop:],
                "resume_state_bit_identical": _same_state(
                    _flat_state(resumed), full["state"]),
                "resume_eval_identical": res_r["eval"] == full["eval"],
                "resume_books": _per_update_ok(
                    ran_r, updates - stop, len(resumed.test_pipe)),
            })
            resumed.multi_step.close()
            del full, part, resumed, real
            # The sharded update (f32) at NCCL world 1, both feeds.
            with _nccl_world1_env(TORCH_NCCL_ASYNC_ERROR_HANDLING="0"):
                # Four windows (96 updates) of the same run.
                sh = {feed: _feed_run(
                    _res_args(feed, k, ["--train.update_sharding=sharded",
                                        "--data.synthetic_train_size="
                                        f"{4 * k * TRAIN_B}"]),
                    os.path.join(tmp.name, f"sharded_{feed}"))
                    for feed in ("on", "off")}
                sh_updates = len(sh["on"]["t"].train_pipe)
                a, b = sh["on"], sh["off"]
                checks.update({
                    "sharded_nccl_world_1": (a["t"].ctx.backend,
                                             a["t"].ctx.world) == ("nccl", 1)
                    and a["t"].sharded,
                    "sharded_feeds": a["t"].resident_train is not None
                    and b["t"].resident_train is None,
                    "sharded_losses_bit_identical":
                        a["t"].step_losses == b["t"].step_losses,
                    "sharded_state_bit_identical": _same_state(a["state"],
                                                               b["state"]),
                    "sharded_books": sh_updates == 4 * k
                    and _per_update_ok(a["ran"], sh_updates, evals)
                    and _per_update_ok(b["ran"], sh_updates, evals)
                    and {n: a["ran"][n] for n in ("reduce_scatter",
                                                  "all_gather")}
                    == {n: b["ran"][n] for n in ("reduce_scatter",
                                                 "all_gather")},
                })
                rec["sharded"] = {
                    "ran": {f: r["ran"] for f, r in sh.items()},
                    "epoch_images_per_s": {f: r["res"]["images_per_sec"]
                                           for f, r in sh.items()}}
                for r in sh.values():
                    r["t"].multi_step.close()
                del sh, a, b
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    rec["checks"] = checks
    out["resident"] = rec
    print("[resident] " + json.dumps({n: v for n, v in rec.items()
                                      if n not in ("losses", "ran")}))
    w = rec["windowed_ms_per_update"]
    ips = rec["epoch_images_per_s"]
    print(f"[resident] {out['card']}: table {rec['table_device_bytes']} B "
          f"staged in {rec['staging_ms']:.1f} ms; H2D per window "
          f"{rec['h2d_bytes_per_window']['resident']} B resident, "
          f"{rec['h2d_bytes_per_window']['streamed']} B streamed; windowed "
          f"{w['resident']:.3f} / {w['streamed']:.3f} ms per update "
          f"(resident / streamed); epoch images/s "
          f"{json.dumps(ips)}")
    failed = [n for n, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"resident checks failed: {failed}")


def _preset_args(name, updates, batch, k, extra=()):
    """``--preset=name`` with the slice's kernel knobs on synthetic data:
    ``updates`` updates of the preset's per-card ``batch`` in one epoch,
    windows of ``k``."""
    return [f"--preset={name}", "--model.fused_stages=all",
            "--model.fused_bwd=true", "--train.pallas_xent=true",
            "--data.dataset=synthetic",
            f"--data.synthetic_train_size={updates * batch}",
            f"--data.synthetic_test_size={2 * batch}", "--train.epochs=1",
            "--train.log_every=10", f"--train.steps_per_call={k}", *extra]


def _p16_kernel_cases(out) -> list:
    """The kernels at ``bf16_cosine_gb4096``'s call pattern: the
    ``emit_stats`` conv with bf16 x at B=512 for every (stage, variant) of
    a train forward (y and z within one bf16 ulp, stats within 1e-5 of the
    plain sums of the kernel's own y and bit-exact with `ordered_stats_sum`,
    across launches, graph replays and a busy side stream), the input-grad
    at B=512 for every stage (one ulp), and the xent mean pair at [512,
    10] on its multi-block route (1e-6, bit-identical over 100 launches and
    3 replays); each timed beside its bound, its plain version and the
    library call (cuDNN bf16 conv2d / conv2d_input, F.cross_entropy)."""
    import torch
    import torch.nn.functional as F

    from tpu_dp_torch.ops import conv_block as cb
    from tpu_dp_torch.ops import xent as tx

    gen = torch.Generator(device="cuda").manual_seed(13)
    big = torch.randn(8192, 8192, generator=gen, device="cuda").to(
        torch.bfloat16)
    side = torch.cuda.Stream()
    b, cases = P16_B, []
    for stage, variant in dict.fromkeys(FORWARD_CALLS):
        h, c = STAGES[stage]
        emit, with_res = "emit_z" in variant, "res" in variant
        x, w, scale, shift, res = _case_inputs(gen, b, h, c, torch.bfloat16,
                                               with_res)
        wk = cb.pack_weight(w)
        got = cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)
        again = cb.fused_conv_bn(x, wk, scale, shift, res, emit_z=emit)
        ref = cb.reference_affine_relu_conv(x, w, scale, shift, res,
                                            emit_z=emit, emit_stats=True)
        torch.cuda.synchronize()
        y, st = got[0], got[-1]
        yf = y.float()
        own = cb._stats_of(y)
        yabs = torch.stack([yf.abs().sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])
        rec = {"kind": "p16_emit_stats", "stage": stage, "variant": variant,
               "shape": [b, h, h, c], "dtype": "bfloat16",
               "max_abs_err": (yf - ref[0].float()).abs().max().item(),
               "tol": bf16_ulp(ref[0].float().abs().max().item()),
               "stats_rel_err": ((st - own).abs() / yabs).max().item(),
               "stats_bit_identical": bool(torch.equal(st, again[-1])),
               "y_bit_identical": bool(torch.equal(y, again[0])),
               "tile": cb.tile_of(b, h, h, c)}
        if emit:
            rec["z_max_abs_err"] = (got[1].float()
                                    - ref[1].float()).abs().max().item()
            rec["z_tol"] = bf16_ulp(ref[1].float().abs().max().item())
        rec.update(_fold_checks(cb, x, wk, scale, shift, res, emit, st, big,
                                side))
        rec["ok"] = (rec["max_abs_err"] <= rec["tol"]
                     and rec.get("z_max_abs_err", 0.0) <= rec.get("z_tol",
                                                                  1.0)
                     and rec["stats_rel_err"] <= 1e-5
                     and rec["stats_bit_identical"] and rec["y_bit_identical"]
                     and rec["fold_ok"])
        launch, _ = _direct_conv(cb, x, wk, scale, shift, res, emit, True)
        zl = cb._reference_z(x, scale, shift, res).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        rec["ms"] = cuda_loop_ms(launch)
        rec["plain_ms"] = cuda_median_ms(
            lambda: cb.reference_affine_relu_conv(
                x, w, scale, shift, res, emit_z=emit, emit_stats=True),
            reps=5)
        rec["library_ms"] = cuda_loop_ms(lambda: F.conv2d(zl, wl, padding=1))
        n = b * h * h * c
        rec["bytes"] = (n * 2 * (2 + emit + with_res) + wk.numel() * 2
                        + 4 * c * 4)
        rec["flops"] = 2.0 * b * h * h * 9 * c * c
        rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"])
        print("[presets-kernel] " + json.dumps(with_ratios(rec)))
        cases.append(rec)
    for stage, (h, c) in enumerate(STAGES):
        ct = torch.randn(b, h, h, c, generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.randn(3, 3, c, c, generator=gen, device="cuda") * 0.05
        wf = cb.flip_packed(w)
        one = torch.ones(c, device="cuda")
        zero = torch.zeros(c, device="cuda")
        dz = cb._run(ct, wf, one, zero, None, False, False,
                     role="input_grad")
        ref = cb.reference_affine_relu_conv(ct, wf, one, zero,
                                            activate=False)
        again = cb._run(ct, wf, one, zero, None, False, False,
                        role="input_grad")
        torch.cuda.synchronize()
        launch, _ = _direct_conv(cb, ct, wf, one, zero, None, False, False,
                                 act=False)
        ctl = ct.permute(0, 3, 1, 2)
        wl = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
        rec = {"kind": "p16_input_grad", "stage": stage,
               "shape": [b, h, h, c],
               "max_abs_err": (dz.float() - ref.float()).abs().max().item(),
               "tol": bf16_ulp(ref.float().abs().max().item()),
               "bit_identical": bool(torch.equal(dz, again)),
               "tile": cb.tile_of(b, h, h, c), "ms": cuda_loop_ms(launch),
               "plain_ms": cuda_median_ms(
                   lambda: cb.reference_affine_relu_conv(
                       ct, wf, one, zero, activate=False), reps=5),
               "library_ms": cuda_loop_ms(
                   lambda: torch.nn.grad.conv2d_input(
                       ctl.shape, wl, ctl, padding=1)),
               "bytes": b * h * h * c * 2 * 2 + wf.numel() * 2,
               "flops": 2.0 * b * h * h * 9 * c * c}
        rec["ok"] = rec["max_abs_err"] <= rec["tol"] and rec["bit_identical"]
        rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"])
        print("[presets-kernel] " + json.dumps(with_ratios(rec)))
        cases.append(rec)
    del big, side
    c = XENT_CLASSES[0]
    lg = 3.0 * torch.randn(b, c, generator=gen, device="cuda")
    lb = torch.randint(0, c, (b,), generator=gen, device="cuda")
    ct = torch.tensor(1.3, device="cuda")
    x = _xent_mean_parity(lg, lb, ct)
    lref = lg.clone().requires_grad_()
    nbytes = b * c * 4 + b * 8 + 4
    x.update({
        "route": "one_cta" if b <= tx.ONE_CTA_MAX_ROWS else "multi_block",
        "floor_ms": out.get("xent_floor_ms"),
        "fwd_ms": device_ms(lambda: tx._fwd(lg, lb, True)),
        "bwd_ms": device_ms(lambda: tx._bwd(lg, lb, ct, True)),
        "fwd_plain_ms": device_ms(lambda: tx._plain_fwd(lg, lb).mean()),
        "bwd_plain_ms": device_ms(lambda: tx._plain_bwd(
            lg, lb, (ct / b).expand(b))),
        "fwd_library_ms": device_ms(lambda: F.cross_entropy(lg, lb)),
        "bwd_library_ms": device_ms(lambda: torch.autograd.grad(
            F.cross_entropy(lref, lb), lref, ct))})
    for d, nb in (("fwd", nbytes), ("bwd", nbytes + b * c * 4)):
        # ~10 operations per element (exp, max, add, divide), f32.
        x[f"{d}_bound_ms"], x[f"{d}_bound_by"] = bound(
            nb, 10.0 * b * c, PEAK_F32_FLOPS)
    x["ok"] = (x["route"] == "multi_block" and x["fwd_rel_err"] <= 1e-6
               and x["bwd_rel_err"] <= 1e-6
               and x["fwd_bit_identical_100_launches"]
               and x["bwd_bit_identical_100_launches"]
               and all(x["graph_replays_bit_identical"]))
    x["kind"] = "p16_xent"
    print("[presets-kernel] " + json.dumps(x))
    cases.append(x)
    return cases


def _kernel_inputs_of_one_update(trainer, batch) -> list:
    """``(role, dtype, B)`` of every conv kernel launch of one eager update
    of ``trainer`` on ``batch`` (a spy on the launch)."""
    from tpu_dp_torch.ops import conv_block as cb

    real, seen = cb._launch, []

    def spy(x, *a):  # `_run` passes the role last, by position
        seen.append((a[-1], str(x.dtype).replace("torch.", ""), x.shape[0]))
        return real(x, *a)

    cb._launch = spy
    try:
        trainer.train_step(trainer.state, batch)
    finally:
        cb._launch = real
    return seen


def phase_presets(out):
    """13: the last two presets on the card, cuDNN deterministic: (a) the
    kernels at ``bf16_cosine_gb4096``'s call pattern (`_p16_kernel_cases`);
    (b) ``--preset=bf16_cosine_gb4096`` (bf16 compute, per-card batch 512,
    lr 1.6 with its warm-up) with the kernel knobs, 30 updates, eager and
    in windows of 10, augmentation off: losses finite and falling, windows
    bit-identical to eager (losses, state, eval), the books per update,
    every conv launch of an update on bf16 x at B=512, parameters f32; its
    eager step ms and windowed ms per update, images/s, device busy share;
    (c) ``--preset=resnet18_8chip_gb1024`` (per-card batch 128, lr 0.4),
    10 updates: books, finite losses."""
    import torch

    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.step import gather_batch
    from tpu_dp_torch.train.trainer import Trainer

    checks, rec = {}, {"card": out["card"]}
    cases = _p16_kernel_cases(out)
    rec["kernel_cases"] = cases
    checks["kernel_cases_within_tolerance"] = all(r["ok"] for r in cases)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_presets_")
    try:
        runs = {}
        for kk in (1, P16_K):
            t = Trainer(parse_cli(_preset_args(
                "bf16_cosine_gb4096", P16_UPDATES, P16_B, kk,
                ["--data.augment=false",
                 f"--train.ckpt_dir={os.path.join(tmp.name, str(kk))}"])))
            runs[kk] = (t, *_fit_books(t))
        (e, res_e, ran_e), (w, res_w, ran_w) = runs[1], runs[P16_K]
        evals = len(e.test_pipe)
        losses = e.step_losses
        checks.update({
            "bf16_model_f32_parameters": e.model.dtype == torch.bfloat16
            and all(p.dtype == torch.float32 for p in e.model.parameters()),
            "per_card_batch_512": e.cfg.data.batch_size == P16_B
            and e.global_batch_size == P16_B and e.cfg.optim.lr == 1.6,
            "resident_feed": e.resident_train is not None,
            "updates": len(losses) == P16_UPDATES,
            "losses_finite_and_fall": all(math.isfinite(v) for v in losses)
            and statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
            "windows_losses_bit_identical": w.step_losses == losses,
            "windows_state_bit_identical": _same_state(_flat_state(w),
                                                       _flat_state(e)),
            "windows_eval_identical": res_w["eval"] == res_e["eval"],
            "windowed": w.multi_step.graph is not None,
            "books_eager": _per_update_ok(ran_e, P16_UPDATES, evals),
            "books_windowed": _per_update_ok(ran_w, P16_UPDATES, evals),
        })
        _, idx = next(iter(e.train_pipe.index_windows(1)))
        batch = gather_batch(e.resident_train, idx[0])
        seen = _kernel_inputs_of_one_update(e, batch)
        checks["kernel_sees_bf16_x_at_b512"] = len(seen) == 20 and all(
            (dt, nb) == ("bfloat16", P16_B) for _, dt, nb in seen) and sorted(
            r for r, _, _ in seen) == ["input_grad"] * 10 + ["stats"] * 10
        _, widx = next(iter(w.train_pipe.index_windows(P16_K)))
        table = w.resident_train
        step_ms = cuda_median_ms(lambda: e.train_step(e.state, batch),
                                 reps=10)
        win_ms = cuda_median_ms(
            lambda: w.multi_step(w.state, table, widx), reps=4) / P16_K
        busy = {"eager": profile_forward(
                    lambda: e.train_step(e.state, batch), 3,
                    cuda_only=True)["device_busy_share"],
                "windowed": profile_forward(
                    lambda: w.multi_step(w.state, table, widx), 1,
                    cuda_only=True)["device_busy_share"]}
        rec["gb4096"] = {
            "losses": losses, "eval": res_e["eval"], "ran_eager": ran_e,
            "ran_windowed": ran_w, "kernel_inputs_one_update": seen,
            "eager_step_ms": step_ms, "windowed_ms_per_update": win_ms,
            "images_per_s": {"eager": P16_B / (step_ms / 1e3),
                             "windowed": P16_B / (win_ms / 1e3)},
            "fit_images_per_s": {"eager": res_e["images_per_sec"],
                                 "windowed": res_w["images_per_sec"]},
            "device_busy_share": busy}
        # The main path's launches: the eager run's (the preset's
        # steps_per_call), set to 0 just before it and read just after.
        rec["launches"] = ran_e
        w.multi_step.close()
        del runs, e, w, batch, table, widx
        t = Trainer(parse_cli(_preset_args(
            "resnet18_8chip_gb1024", P1024_UPDATES, TRAIN_B, 1,
            [f"--train.ckpt_dir={os.path.join(tmp.name, 'gb1024')}"])))
        res, ran = _fit_books(t)
        checks.update({
            "gb1024_per_card_batch_128": t.cfg.data.batch_size == TRAIN_B
            and t.cfg.optim.lr == 0.4 and t.cfg.model.bf16 is False,
            "gb1024_losses_finite": len(t.step_losses) == P1024_UPDATES
            and all(math.isfinite(v) for v in t.step_losses),
            "gb1024_books": _per_update_ok(ran, P1024_UPDATES,
                                           len(t.test_pipe)),
        })
        rec["gb1024"] = {"losses": t.step_losses, "eval": res["eval"],
                         "ran": ran,
                         "fit_images_per_s": res["images_per_sec"]}
        del t
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)
        tmp.cleanup()
    rec["checks"] = checks
    out["presets"] = rec
    g = rec["gb4096"]
    print("[presets] " + json.dumps({n: v for n, v in rec.items()
                                     if n != "kernel_cases"}))
    print(f"[presets] {out['card']}: bf16_cosine_gb4096 at B={P16_B}: loss "
          f"{g['losses'][0]:.4f} -> {g['losses'][-1]:.4f}; eager step "
          f"{g['eager_step_ms']:.3f} ms, windowed "
          f"{g['windowed_ms_per_update']:.3f} ms per update; images/s "
          f"{json.dumps(g['images_per_s'])}; device busy "
          f"{json.dumps(g['device_busy_share'])}")
    failed = [n for n, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"presets checks failed: {failed}")


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
            "library_ms": r["library_ms"],
            # An empty kernel's device time: the floor of any launch.
            "floor_ms": out.get("xent_floor_ms")}))
    # ResNet-50 (phase 10): the same kernels at its call pattern, times
    # summed over the 13 launches of one B=128 forward or step.
    r50, rk = out["resnet50"], out["resnet50_kernels"]
    by = {(r["kind"], r["stage"]): r for r in rk["conv"]}
    conv = r50["launches"]["conv"]
    for kind, name, line, launches in (
            ("r50_eval", "conv_block.fused_affine_relu_conv (ResNet-50, f32 "
             "x, no residual)", 113, r50["serve"]["launches"]
             + r50["serve_ckpt"]["conv_launches"] + conv["eval"]),
            ("r50_emit_stats", "conv_block.fused_conv_bn (emit_stats, "
             "ResNet-50)", 153, conv["stats"]),
            ("r50_input_grad", "conv_block input-grad (pallas_bwd, "
             "ResNet-50)", 418, conv["input_grad"])):
        entries.append(_summed(name, src + "conv_block.cu",
                               f"tpu_dp/ops/conv_block.py:{line}", launches,
                               [by[(kind, st)] for st in R50_FORWARD_STAGES]))
    x = rk["xent"]
    for d, name, line, key in (
            ("fwd", "xent.mean_softmax_xent forward (mean, [128, 100], "
             "multi-block)", 71, "forward"),
            ("bwd", "xent.mean_softmax_xent backward (mean, [128, 100], "
             "multi-block)", 82, "backward")):
        entries.append(with_ratios({
            "name": name, "route": "cuda", "source": src + "xent.cu",
            "replaces": f"tpu_dp/ops/xent.py:{line}",
            "launches": r50["launches"]["xent"][key],
            "max_abs_err": x[f"{d}_abs_err"], "ms": x[f"{d}_ms"],
            "plain_ms": x[f"{d}_plain_ms"], "bound_ms": x[f"{d}_bound_ms"],
            "bound_by": x[f"{d}_bound_by"],
            "library_ms": x[f"{d}_library_ms"], "floor_ms": x["floor_ms"]}))
    # bf16_cosine_gb4096 (phase 13): bf16 x at B=512, times summed over
    # one forward's / one step's 10 launches; xent at [512, 10].
    p = out["presets"]
    pk, ran = p["kernel_cases"], p["launches"]
    stats16 = {(r["stage"], r["variant"]): r for r in pk
               if r["kind"] == "p16_emit_stats"}
    grad16 = {r["stage"]: r for r in pk if r["kind"] == "p16_input_grad"}
    entries += [
        _summed("conv_block.fused_conv_bn (emit_stats, bf16 x, B=512)",
                src + "conv_block.cu", "tpu_dp/ops/conv_block.py:153",
                ran["conv.stats"], [stats16[c] for c in FORWARD_CALLS]),
        _summed("conv_block input-grad (pallas_bwd, bf16, B=512)",
                src + "conv_block.cu", "tpu_dp/ops/conv_block.py:418",
                ran["conv.input_grad"],
                [grad16[s] for s in INPUT_GRAD_STAGES])]
    x = next(r for r in pk if r["kind"] == "p16_xent")
    for d, name, line, key in (
            ("fwd", "xent.mean_softmax_xent forward (mean, [512, 10], "
             "multi-block)", 71, "forward"),
            ("bwd", "xent.mean_softmax_xent backward (mean, [512, 10], "
             "multi-block)", 82, "backward")):
        entries.append(with_ratios({
            "name": name, "route": "cuda", "source": src + "xent.cu",
            "replaces": f"tpu_dp/ops/xent.py:{line}",
            "launches": ran[f"xent.{key}"],
            "max_abs_err": x[f"{d}_abs_err"], "ms": x[f"{d}_ms"],
            "plain_ms": x[f"{d}_plain_ms"], "bound_ms": x[f"{d}_bound_ms"],
            "bound_by": x[f"{d}_bound_by"],
            "library_ms": x[f"{d}_library_ms"], "floor_ms": x["floor_ms"]}))
    return {"kernels": entries}


PHASES = (phase_header, phase_build, phase_kernels, phase_train_kernels,
          phase_serve, phase_train, phase_checkpoint, phase_ddp_gloo_one_card,
          phase_ddp_nccl_world1, phase_ddp_nccl_multi_card, phase_windows,
          phase_resnet50_kernels, phase_resnet50, phase_resnet50_windows,
          phase_resnet50_ddp, phase_sharded, phase_resident, phase_presets)


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

    out: dict = {"allocated_bytes_before": {}, "phase_s": {}}
    try:
        for phase in PHASES:
            name = phase.__name__.removeprefix("phase_")
            if only is not None and name not in only | {"header", "build"}:
                continue
            if torch.cuda.is_available():
                out["allocated_bytes_before"][phase.__name__] = (
                    torch.cuda.memory_allocated())
            t0 = time.perf_counter()
            phase(out)
            out["phase_s"][name] = time.perf_counter() - t0
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
