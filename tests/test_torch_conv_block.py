"""The port's fused conv (`tpu_dp_torch.ops.conv_block`) against the JAX
package's (`tpu_dp.ops.conv_block`, its Pallas kernel in interpret mode on
the CPU) on the same numpy inputs.

On the CPU the port's wrappers run the plain version; the kernel itself
is held against the plain version on the card (`test_kernel_matches_plain
_on_card`, skipped without CUDA, and chip_smoke.py at full width).
Tolerance: one bf16 ulp at the output's magnitude — the two sides round
y through bf16 after summing the taps in different orders
(tests/test_conv_block.py states the same bound)."""

from __future__ import annotations

import math

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

VARIANTS = ("plain", "emit_z", "emit_z+res")


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


def _jax(a, variant, dtype, activate):
    x = jnp.asarray(a["x"]).astype(dtype)
    res = jnp.asarray(a["res"]).astype(dtype) if variant == "emit_z+res" \
        else None
    args = (x, jnp.asarray(a["w"]), jnp.asarray(a["scale"]),
            jnp.asarray(a["shift"]), res, 0, activate)
    if variant == "plain":
        return (jcb.fused_affine_relu_conv(*args),)
    return jcb.fused_affine_relu_conv_emit(*args)


def _torch(a, variant, dtype, activate, fn=None):
    x = torch.from_numpy(a["x"]).to(dtype)
    res = torch.from_numpy(a["res"]).to(dtype) if variant == "emit_z+res" \
        else None
    args = (x, torch.from_numpy(a["w"]), torch.from_numpy(a["scale"]),
            torch.from_numpy(a["shift"]), res)
    if fn is not None:
        out = fn(*args, activate=activate, emit_z=variant != "plain")
        return out if isinstance(out, tuple) else (out,)
    if variant == "plain":
        return (tcb.fused_affine_relu_conv(*args, activate=activate),)
    return tcb.fused_affine_relu_conv_emit(*args, activate=activate)


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("activate", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_port_matches_jax_kernel(variant, dtype, activate):
    a = _inputs()
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tcb.reset_launches()
    got = _torch(a, variant, tdt, activate)
    plain = _torch(a, variant, tdt, activate,
                   fn=tcb.reference_affine_relu_conv)
    ref = _jax(a, variant, jdt, activate)
    assert tcb.launches == 0  # a CPU tensor never reaches the kernel
    assert len(got) == len(ref) == (1 if variant == "plain" else 2)
    for name, g, p, r in zip(("y", "z"), got, plain, ref):
        assert g.dtype == tdt and tuple(g.shape) == r.shape
        assert g.is_contiguous()
        r32 = _f32(r)
        tol = bf16_ulp(float(np.abs(r32).max()))
        np.testing.assert_allclose(_f32(g), r32, rtol=0, atol=tol,
                                   err_msg=f"{name} vs JAX kernel")
        np.testing.assert_array_equal(_f32(g), _f32(p))


@pytest.mark.parametrize("with_res", [False, True])
def test_plain_version_matches_jax_reference(with_res):
    a = _inputs(b=2, h=6, w=10, c=8, seed=3)
    res_t = torch.from_numpy(a["res"]) if with_res else None
    res_j = jnp.asarray(a["res"]) if with_res else None
    got = tcb.reference_affine_relu_conv(
        torch.from_numpy(a["x"]), torch.from_numpy(a["w"]),
        torch.from_numpy(a["scale"]), torch.from_numpy(a["shift"]), res_t)
    ref = jcb.reference_affine_relu_conv(
        jnp.asarray(a["x"]), jnp.asarray(a["w"]), jnp.asarray(a["scale"]),
        jnp.asarray(a["shift"]), res_j)
    r32 = _f32(ref)
    np.testing.assert_allclose(_f32(got), r32, rtol=0,
                               atol=bf16_ulp(float(np.abs(r32).max())))


def test_zero_padding_applies_after_activation():
    # shift > 0 everywhere: act(shift) != 0, but the halo must stay 0, so
    # the border sums 6 (edge) or 4 (corner) taps of z = shift, not 9.
    c = 16
    x = torch.zeros(1, 8, 8, c)
    w = torch.full((3, 3, c, c), 0.01)
    y = tcb.fused_affine_relu_conv(x, w, torch.ones(c), torch.full((c,), 2.))
    interior = 9 * c * 0.01 * 2.0
    assert float(y[0, 4, 4, 0]) == pytest.approx(interior, rel=1e-2)
    assert float(y[0, 0, 4, 0]) == pytest.approx(interior * 6 / 9, rel=1e-2)
    assert float(y[0, 0, 0, 0]) == pytest.approx(interior * 4 / 9, rel=1e-2)


def test_pack_weight_layout_roundtrip():
    w = torch.randn(3, 3, 16, 32)
    wk = tcb.pack_weight(w)
    assert wk.shape == (9, 32, 16) and wk.dtype == torch.bfloat16
    assert wk.is_contiguous()
    # [tap][c_out][c_in] == w[dh, dw, c_in, c_out]
    assert torch.equal(wk[5, 7, 3], w[1, 2, 3, 7].to(torch.bfloat16))
    assert torch.equal(tcb._hwio(wk), w.to(torch.bfloat16))
    x = torch.randn(2, 8, 8, 16)
    w2 = torch.randn(3, 3, 16, 16)
    one, zero = torch.ones(16), torch.zeros(16)
    assert torch.equal(
        tcb.fused_affine_relu_conv(x, tcb.pack_weight(w2), one, zero),
        tcb.fused_affine_relu_conv(x, w2, one, zero))


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (2, 6, 6, 64),
                                   (2, 8, 24, 64)])
def test_kernel_refuses_shapes_it_does_not_take(shape):
    c = shape[-1]
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match="conv_block kernel takes"):
        tcb._launch(x, torch.zeros(3, 3, c, c), torch.ones(c),
                    torch.zeros(c), None, True, False)


def test_other_devices_are_refused():
    x = torch.zeros(1, 8, 8, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tcb.fused_affine_relu_conv(x, x, x, x)


def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for h, c in ((32, 64), (16, 128), (8, 256), (4, 512)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(3, h, h, c, generator=g, device="cuda").to(dtype)
            res = torch.randn(3, h, h, c, generator=g, device="cuda").to(dtype)
            w = torch.randn(3, 3, c, c, generator=g, device="cuda") * 0.05
            sc = torch.rand(c, generator=g, device="cuda") + 0.5
            sh = torch.randn(c, generator=g, device="cuda") * 0.1
            before = tcb.launches
            y, z = tcb.fused_affine_relu_conv_emit(x, w, sc, sh, res)
            yr, zr = tcb.reference_affine_relu_conv(x, w, sc, sh, res,
                                                    emit_z=True)
            torch.cuda.synchronize()
            assert tcb.launches == before + 1
            assert torch.equal(z, zr)
            tol = bf16_ulp(yr.float().abs().max().item())
            assert (y.float() - yr.float()).abs().max().item() <= tol
