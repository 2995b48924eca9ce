"""On-card smoke of the PyTorch/CUDA port (`tpu_dp_torch`): run from the
repository root on a machine with one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. header: the card (torch and ``nvidia-smi``); no CUDA → exit 1;
2. build: every kernel of the serving path, one nvcc per source;
3. kernel vs plain: the conv kernel's public wrappers against its plain
   PyTorch version on the card, at B=32 for the four ResNet-18 shapes x
   the three eval variants x f32/bf16 inputs (tolerance: one bf16 ulp at
   the output's magnitude), with CUDA-event medians of the kernel, the
   plain version and one cuDNN conv of the same size (``library_ms``)
   beside the bound; then the same checks, untimed, at the serve ladder's
   other buckets (1, 2, 4, 8, 16), where tiles are only partly filled;
4. serve: the full-width fused CIFAR ResNet-18 (f32, random weights and
   random BN statistics from a seed) behind `InferenceEngine` with
   buckets 1..32, 200 Poisson requests of 1-4 images: audited books, the
   device class histogram equal to the handles' predictions, exactly 10
   kernel launches per forward, and bucket-32 logits equal to the same
   weights run unfused (cuDNN) within 1e-2 of their magnitude;
5. the kernels' JSON line, then ``{"ok": true, "device": {...}}``.

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

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
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
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] total {out['build_s']} s")


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
                rec["ms"] = cuda_median_ms(
                    lambda: wrapper(x, wk, scale, shift, res))
                rec["plain_ms"] = cuda_median_ms(
                    lambda: cb.reference_affine_relu_conv(
                        x, w, scale, shift, res, True, emit))
                rec["library_ms"] = cuda_median_ms(
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
                print("[kernel] " + json.dumps(rec))
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


def profile_forward(fn, n: int = 5) -> dict:
    """Device time by kernel over ``n`` calls of ``fn`` (torch.profiler),
    and the device's busy share of the wall time they took."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    return {"wall_us_per_call": wall_us / n, "device_busy_us_per_call":
            busy_us, "device_busy_share": busy_us * n / wall_us,
            "kernel_launches_per_call": sum(
                k["count_per_call"] for k in kernels.values()),
            "top": top}


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


def kernels_line(out):
    cases = {(r["stage"], r["variant"]): r for r in out["kernel_cases"]
             if r["dtype"] == "float32"}
    calls = [cases[c] for c in FORWARD_CALLS]
    total = {k: sum(r[k] for r in calls)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    t_bytes = sum(r["bytes"] for r in calls) / PEAK_BYTES
    t_ops = sum(r["flops"] for r in calls) / PEAK_BF16_FLOPS
    return {"kernels": [{
        "name": KERNEL,
        "route": "cuda",
        "source": "tpu_dp_torch/ops/csrc/conv_block.cu",
        "replaces": "tpu_dp/ops/conv_block.py:113",
        "launches": out["serve"]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in out["kernel_cases"]
                           + out["kernel_small_bucket_cases"]),
        # Times are the sum over the 10 calls of one B=32 f32 forward.
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": total["library_ms"],
    }]}


def main() -> int:
    sys.path.insert(0, HERE)
    import torch  # noqa: F401  (fails here, not mid-phase, if missing)

    out: dict = {}
    try:
        phase_header(out)
        phase_build(out)
        phase_kernels(out)
        phase_serve(out)
        line = kernels_line(out)
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        _save(out)
        return 1
    out["kernels"] = line["kernels"]
    _save(out)
    import torch

    print(out["card"])
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
