"""The port's training conv (`tpu_dp_torch.ops.conv_block.fused_conv_bn`
and the autograd rule of every variant) against the JAX package's
(`tpu_dp.ops.conv_block`, its Pallas kernel in interpret mode on the CPU)
on the same numpy inputs.

On the CPU the port's wrappers run the plain version; the kernel itself is
held against it on the card (`test_train_kernels_match_plain_on_card`,
skipped without CUDA, and chip_smoke.py at full width).

Tolerances: y and z within one bf16 ulp at y's magnitude (both sides round
y through bf16 after summing the taps in another order). The stats sum
the rounded y, so a one-ulp flip moves sum(y) by at most one ulp per pixel
and sum(y^2) by 2*max|y|*ulp per pixel: ``count * ulp`` and
``count * 2 * max|y| * ulp``. Gradients: max|g - g_jax| <= 2e-2 * max|g_jax|
(tests/test_models.py's normalized bound — bf16 cotangents and operands
on both sides)."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dp.ops import conv_block as jcb
from tpu_dp_torch.ops import conv_block as tcb

pytestmark = pytest.mark.port

# The suite runs several pytest workers on one machine: keep each worker's
# PyTorch CPU pool small so the port's tests do not starve the others.
torch.set_num_threads(2)


def bf16_ulp(mag: float) -> float:
    return 2.0 ** (math.floor(math.log2(mag)) - 7)


def _inputs(b=3, h=8, w=8, c=16, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((b, h, w, c)).astype(np.float32),
        w=(rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32),
        scale=(1.0 + 0.5 * rng.standard_normal(c)).astype(np.float32),
        shift=(0.1 * rng.standard_normal(c)).astype(np.float32),
        res=rng.standard_normal((b, h, w, c)).astype(np.float32),
    )


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("emit_z", [False, True])
@pytest.mark.parametrize("with_res", [False, True])
def test_fused_conv_bn_matches_jax(with_res, emit_z, dtype):
    a = _inputs()
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    res_t = torch.from_numpy(a["res"]).to(tdt) if with_res else None
    res_j = jnp.asarray(a["res"]).astype(jdt) if with_res else None
    tcb.reset_launches()
    got = tcb.fused_conv_bn(
        torch.from_numpy(a["x"]).to(tdt), torch.from_numpy(a["w"]),
        torch.from_numpy(a["scale"]), torch.from_numpy(a["shift"]), res_t,
        emit_z=emit_z)
    ref = jcb.fused_conv_bn(
        jnp.asarray(a["x"]).astype(jdt), jnp.asarray(a["w"]),
        jnp.asarray(a["scale"]), jnp.asarray(a["shift"]), res_j,
        emit_z=emit_z)
    assert tcb.launches == tcb.reduce_launches == 0  # CPU: plain version
    assert len(got) == len(ref) == (3 if emit_z else 2)
    y, ry = _f32(got[0]), _f32(ref[0])
    assert got[0].dtype == tdt and y.shape == ry.shape
    ymax = float(np.abs(ry).max())
    ulp = bf16_ulp(ymax)
    np.testing.assert_allclose(y, ry, rtol=0, atol=ulp)
    if emit_z:
        np.testing.assert_allclose(_f32(got[1]), _f32(ref[1]), rtol=0,
                                   atol=bf16_ulp(float(np.abs(ref[1]).max())))
    stats, rstats = _f32(got[-1]), _f32(ref[-1])
    assert got[-1].dtype == torch.float32 and stats.shape == (2, 16)
    count = y.shape[0] * y.shape[1] * y.shape[2]
    np.testing.assert_allclose(stats[0], rstats[0], rtol=0, atol=count * ulp)
    np.testing.assert_allclose(stats[1], rstats[1], rtol=0,
                               atol=count * 2 * ymax * ulp)
    # The plain stats are exactly the sums of the plain version's own y.
    yf = got[0].float()
    np.testing.assert_allclose(
        stats, torch.stack([yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))]),
        rtol=1e-6, atol=1e-6)


def _probes(rng, shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("variant", ["plain", "emit_z+res", "stats",
                                     "stats+emit_z+res"])
@pytest.mark.parametrize("pallas_bwd", [False, True])
def test_gradients_match_jax(variant, pallas_bwd):
    a = _inputs(b=2, seed=5)
    with_res = "res" in variant
    emit_z = "emit_z" in variant
    stats = variant.startswith("stats")
    b, h, w, c = a["x"].shape
    outs = [(b, h, w, c)] + ([(b, h, w, c)] if emit_z else []) + (
        [(2, c)] if stats else [])
    # Stats are sums over 128 pixels: scale their probe so each output's
    # share of the functional is of one order.
    probes = _probes(np.random.default_rng(9), outs)
    if stats:
        probes[-1] = probes[-1] * np.float32(1.0 / (b * h * w))

    def jax_f(x, wt, sc, sh, res):
        if stats:
            out = jcb.fused_conv_bn(x, wt, sc, sh, res, 0, True, pallas_bwd,
                                    emit_z=emit_z)
        elif emit_z:
            out = jcb.fused_affine_relu_conv_emit(x, wt, sc, sh, res, 0, True,
                                                  pallas_bwd)
        else:
            out = (jcb.fused_affine_relu_conv(x, wt, sc, sh, res, 0, True,
                                              pallas_bwd),)
        return sum(jnp.sum(o * p) for o, p in zip(out, probes))

    names = ["x", "w", "scale", "shift"] + (["res"] if with_res else [])
    jargs = [jnp.asarray(a[n]) for n in names]
    if not with_res:
        jargs.append(None)
    argnums = tuple(range(len(names)))
    ref = jax.grad(jax_f, argnums=argnums)(*jargs)

    targs = [torch.from_numpy(a[n]).requires_grad_() for n in names]
    tres = targs[4] if with_res else None
    if stats:
        out = tcb.fused_conv_bn(*targs[:4], tres, pallas_bwd=pallas_bwd,
                                emit_z=emit_z)
    elif emit_z:
        out = tcb.fused_affine_relu_conv_emit(*targs[:4], tres,
                                              pallas_bwd=pallas_bwd)
    else:
        out = (tcb.fused_affine_relu_conv(*targs[:4], tres,
                                          pallas_bwd=pallas_bwd),)
    loss = sum((o * torch.from_numpy(p)).sum() for o, p in zip(out, probes))
    loss.backward()
    for n, t, r in zip(names, targs, ref):
        r = np.asarray(r, np.float32)
        g = _f32(t.grad)
        assert g.shape == r.shape, n
        scale = float(np.abs(r).max())
        assert scale > 0, n
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-2 * scale,
                                   err_msg=f"d{n}")


def test_input_grad_reuse_equals_library_input_grad():
    # pallas_bwd's kernel route (here its plain version) and the library
    # conv-transpose compute the same bf16-rounded dz.
    a = _inputs(b=2, seed=2)
    ct = torch.from_numpy(a["res"]).to(torch.bfloat16)
    w = torch.from_numpy(a["w"])
    c = w.shape[-1]
    reuse = tcb.reference_affine_relu_conv(
        ct, tcb.flip_packed(w), torch.ones(c), torch.zeros(c),
        activate=False).float()
    lib, _ = tcb._conv_grads(ct.float(), w, ct, True, False)
    np.testing.assert_allclose(reuse.numpy(), lib.numpy(), rtol=0,
                               atol=bf16_ulp(float(lib.abs().max())))


def test_flip_packed_layout():
    w = torch.randn(3, 3, 16, 32)
    wf = torch.flip(w, (0, 1)).transpose(2, 3)  # HWIO of the input-grad conv
    assert torch.equal(tcb.flip_packed(w), tcb.pack_weight(wf))
    assert torch.equal(tcb.flip_packed(tcb.pack_weight(w)),
                       tcb.pack_weight(wf))


def test_packed_weight_gets_its_gradient_in_packed_layout():
    a = _inputs(b=1, seed=4)
    w = torch.from_numpy(a["w"])
    wk = tcb.pack_weight(w).float().requires_grad_()
    wh = torch.from_numpy(a["w"]).requires_grad_()
    args = [torch.from_numpy(a[n]) for n in ("x", "scale", "shift")]
    tcb.fused_affine_relu_conv(args[0], wk, *args[1:]).sum().backward()
    tcb.fused_affine_relu_conv(args[0], wh, *args[1:]).sum().backward()
    assert wk.grad.shape == (9, 16, 16)
    assert torch.equal(wk.grad, tcb.pack_weight(wh.grad).float())


@pytest.mark.card
def test_train_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for h, c in ((32, 64), (16, 128), (8, 256), (4, 512)):
        for b in (1, 3, 127):
            x = torch.randn(b, h, h, c, generator=g, device="cuda")
            res = torch.randn(b, h, h, c, generator=g, device="cuda")
            w = torch.randn(3, 3, c, c, generator=g, device="cuda") * 0.05
            sc = torch.rand(c, generator=g, device="cuda") + 0.5
            sh = torch.randn(c, generator=g, device="cuda") * 0.1
            before = tcb.reduce_launches
            y, z, st = tcb.fused_conv_bn(x, w, sc, sh, res, emit_z=True)
            y2, z2, st2 = tcb.fused_conv_bn(x, w, sc, sh, res, emit_z=True)
            yr, zr, _ = tcb.reference_affine_relu_conv(
                x, w, sc, sh, res, emit_z=True, emit_stats=True)
            torch.cuda.synchronize()
            assert tcb.reduce_launches == before + 2
            assert torch.equal(st, st2) and torch.equal(y, y2)
            assert torch.equal(z, zr)
            tol = bf16_ulp(yr.abs().max().item())
            assert (y - yr).abs().max().item() <= tol
            own = tcb._stats_of(y)
            bound = 1e-5 * torch.stack([y.abs().sum((0, 1, 2)),
                                        (y * y).sum((0, 1, 2))])
            assert bool(((st - own).abs() <= bound + 1e-6).all())
            # The input-grad reuse: bf16 ct, flipped weights, no activation.
            ct = torch.randn(b, h, h, c, generator=g,
                             device="cuda").to(torch.bfloat16)
            one, zero = torch.ones(c, device="cuda"), torch.zeros(
                c, device="cuda")
            dz = tcb._run(ct, tcb.flip_packed(w), one, zero, None, False,
                          False, role="input_grad")
            dzr = tcb.reference_affine_relu_conv(ct, tcb.flip_packed(w), one,
                                                 zero, activate=False)
            torch.cuda.synchronize()
            tol = bf16_ulp(dzr.float().abs().max().item())
            assert (dz.float() - dzr.float()).abs().max().item() <= tol
