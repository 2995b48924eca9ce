"""The port's softmax cross-entropy (`tpu_dp_torch.ops.xent`) against the
JAX package's (`tpu_dp.ops.xent`, its Pallas kernels in interpret mode on
the CPU) on the same numpy inputs: forward, backward through `jax.grad`,
the batch mean's value and gradient through `jax.value_and_grad`, and the
weighted mean.

On the CPU the port runs its plain versions; the kernels are held against
them on the card (`test_kernels_match_plain_on_card`, skipped without
CUDA, and chip_smoke.py). The unweighted mean goes through its own
autograd rule (one kernel launch each way on a card); the weighted one
through the per-example kernel and torch ops. Tolerances: f32 within 1e-6 relative to the
row's magnitude (one f32 rounding of logsumexp summed in another order);
bf16 gradients within one bf16 ulp (both sides round the same f32 value)."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dp.ops import xent as jx
from tpu_dp_torch.ops import xent as tx

pytestmark = pytest.mark.port

# The suite runs several pytest workers on one machine: keep each worker's
# PyTorch CPU pool small so the port's tests do not starve the others.
torch.set_num_threads(2)


def _inputs(b, c, seed=0):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((b, c))).astype(np.float32)
    labels = rng.integers(0, c, size=b).astype(np.int32)
    ct = rng.uniform(0.5, 2.0, size=b).astype(np.float32)
    return logits, labels, ct


def bf16_ulp(mag: float) -> float:
    return 2.0 ** (math.floor(math.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [5, 128])
@pytest.mark.parametrize("c", [10, 100])
def test_forward_and_backward_match_jax(c, b, dtype):
    logits, labels, ct = _inputs(b, c, seed=b + c)
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    ref_loss = np.asarray(jx.softmax_xent(jl, jnp.asarray(labels)))
    ref_grad = np.asarray(jax.grad(
        lambda lg: jnp.sum(jx.softmax_xent(lg, jnp.asarray(labels))
                           * jnp.asarray(ct)))(jl).astype(jnp.float32))

    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    tx.reset_launches()
    loss = tx.softmax_xent(tl, torch.from_numpy(labels).long())
    (loss * torch.from_numpy(ct)).sum().backward()
    assert tx.launches == {"forward": 0, "backward": 0}
    assert loss.dtype == torch.float32 and tuple(loss.shape) == (b,)
    assert tl.grad.dtype == tl.dtype
    np.testing.assert_allclose(loss.detach().numpy(), ref_loss, rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref_loss).max()))
    g = tl.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(g, ref_grad, rtol=1e-6, atol=1e-6)
    else:
        # Each element rounds one f32 value to bf16: within one ulp of it.
        ulp = np.vectorize(lambda v: bf16_ulp(abs(v)) if v else 2.0 ** -133)
        assert np.all(np.abs(g - ref_grad) <= ulp(ref_grad))


@pytest.mark.parametrize("weighted", [False, True])
def test_mean_softmax_xent_matches_jax(weighted):
    logits, labels, _ = _inputs(16, 10, seed=3)
    weight = (np.arange(16) < 11).astype(np.float32) if weighted else None
    ref = float(jx.mean_softmax_xent(
        jnp.asarray(logits), jnp.asarray(labels),
        None if weight is None else jnp.asarray(weight)))
    got = tx.mean_softmax_xent(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if weight is None else torch.from_numpy(weight))
    assert float(got) == pytest.approx(ref, rel=1e-6)


def test_plain_versions_match_jax_jnp_path():
    logits, labels, ct = _inputs(7, 100, seed=1)
    np.testing.assert_allclose(
        tx._plain_fwd(torch.from_numpy(logits), torch.from_numpy(labels)),
        np.asarray(jx._jnp_fwd(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
    np.testing.assert_allclose(
        tx._plain_bwd(torch.from_numpy(logits), torch.from_numpy(labels),
                      torch.from_numpy(ct)),
        np.asarray(jx._jnp_bwd(jnp.asarray(logits), jnp.asarray(labels),
                               jnp.asarray(ct))),
        rtol=1e-6, atol=1e-7)


def test_bad_inputs_are_refused_and_bad_labels_give_nan():
    logits = torch.zeros(4, 10)
    with pytest.raises(TypeError, match="int64 or int32"):
        tx.softmax_xent(logits, torch.zeros(4))
    with pytest.raises(ValueError, match="shape"):
        tx.softmax_xent(logits, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tx.softmax_xent(logits.double(), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tx.softmax_xent(logits.to("meta"),
                        torch.zeros(4, dtype=torch.int64, device="meta"))
    # Labels outside [0, C) are not refused: like the JAX kernels (class
    # index compare), they match no class, so the loss is the row's
    # logsumexp and the gradient softmax * ct -- no NaN.
    logits, _, ct = _inputs(4, 10, seed=5)
    labels = np.array([0, 10, -1, 9], np.int32)
    ref_loss = np.asarray(jx.softmax_xent(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    ref_grad = np.asarray(jax.grad(
        lambda lg: jnp.sum(jx.softmax_xent(lg, jnp.asarray(labels))
                           * jnp.asarray(ct)))(jnp.asarray(logits)))
    lg = torch.from_numpy(logits).requires_grad_()
    loss = tx.softmax_xent(lg, torch.from_numpy(labels).long())
    (loss * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), ref_loss, rtol=1e-6)
    np.testing.assert_allclose(lg.grad.numpy(), ref_grad, rtol=1e-6,
                               atol=1e-6)
    assert np.isfinite(loss.detach().numpy()).all()


def _bad_labels(labels, c):
    """Labels outside [0, C): C in the first row, -1 in the last."""
    labels = labels.copy()
    labels[0] = c
    if len(labels) > 1:
        labels[-1] = -1
    return labels


@pytest.mark.parametrize("bad", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [10, 100])
@pytest.mark.parametrize("b", [1, 7, 130])
def test_mean_path_matches_jax_value_and_grad(b, c, dtype, bad):
    logits, labels, _ = _inputs(b, c, seed=7 * b + c)
    if bad:
        labels = _bad_labels(labels, c)
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    ref_loss, ref_grad = jax.value_and_grad(
        lambda lg: jx.mean_softmax_xent(lg, jnp.asarray(labels)))(jl)
    ref_loss = float(ref_loss)
    ref_grad = np.asarray(ref_grad.astype(jnp.float32))

    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    tx.reset_launches()
    loss = tx.mean_softmax_xent(tl, torch.from_numpy(labels).long())
    assert type(loss.grad_fn).__name__ == "_MeanSoftmaxXentBackward"
    loss.backward()
    assert tx.launches == {"forward": 0, "backward": 0}  # CPU: plain
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert tl.grad.dtype == tl.dtype
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-6)
    g = tl.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(
            g, ref_grad, rtol=1e-6, atol=1e-6 * float(np.abs(ref_grad).max()))
    else:
        # Each element rounds one f32 value to bf16: within one ulp of it.
        ulp = np.vectorize(lambda v: bf16_ulp(abs(v)) if v else 2.0 ** -133)
        assert np.all(np.abs(g - ref_grad) <= ulp(ref_grad))


def test_weighted_mean_keeps_the_per_example_route():
    logits, labels, _ = _inputs(7, 10, seed=11)
    weight = (np.arange(7) < 5).astype(np.float32)
    ref_loss, ref_grad = jax.value_and_grad(
        lambda lg: jx.mean_softmax_xent(lg, jnp.asarray(labels),
                                        jnp.asarray(weight)))(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    loss = tx.mean_softmax_xent(tl, torch.from_numpy(labels).long(),
                                torch.from_numpy(weight))
    # (per_example * weight).sum() / weight.sum(): the per-example rule
    # sits under the weighting, not the mean rule.
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None:
            seen.add(type(fn).__name__)
            todo += [f for f, _ in fn.next_functions]
    assert "_SoftmaxXentBackward" in seen
    assert "_MeanSoftmaxXentBackward" not in seen
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-6)
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(tl.grad.numpy(), ref_grad, rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref_grad).max()))


@pytest.mark.card
def test_mean_kernels_match_plain_on_card():
    # The mean variant against the plain versions (rel 1e-6), its loss
    # bit-identical across launches, and its gradient bit-identical to the
    # route it replaces (per-example kernel, torch mean, MeanBackward).
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for b in (1, 7, 128, 1000, 4096):  # the last: the multi-block route
        for dtype in (torch.float32, torch.bfloat16):
            logits, labels, _ = _inputs(b, 10, seed=b)
            lg = torch.from_numpy(logits).cuda().to(dtype)
            lb = torch.from_numpy(_bad_labels(labels, 10)).cuda().long()
            ct = torch.tensor(1.7, device="cuda")
            before = dict(tx.launches)
            loss, again = tx._fwd(lg, lb, mean=True), tx._fwd(lg, lb, True)
            d = tx._bwd(lg, lb, ct, mean=True)
            torch.cuda.synchronize()
            assert tx.launches == {"forward": before["forward"] + 2,
                                   "backward": before["backward"] + 1}
            assert loss.shape == () and torch.equal(loss, again)
            assert torch.allclose(loss, tx._plain_fwd(lg, lb).mean(),
                                  rtol=1e-6, atol=0)
            old = lg.clone().requires_grad_()
            tx.softmax_xent(old, lb).mean().backward(ct)
            assert torch.equal(d, old.grad)
            rd = tx._plain_bwd(lg, lb, (ct / b).expand(b))
            tol = (1e-6 * rd.abs().max().item() if dtype == torch.float32
                   else bf16_ulp(rd.float().abs().max().item()))
            assert (d.float() - rd.float()).abs().max().item() <= tol


@pytest.mark.card
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for c in (10, 100):
        for b in (5, 128):
            for dtype in (torch.float32, torch.bfloat16):
                for ldt in (torch.int64, torch.int32):
                    logits, labels, ct = _inputs(b, c, seed=b * c)
                    lg = torch.from_numpy(logits).cuda().to(dtype)
                    lb = torch.from_numpy(labels).cuda().to(ldt)
                    ctt = torch.from_numpy(ct).cuda()
                    before = dict(tx.launches)
                    loss = tx._fwd(lg, lb)
                    d = tx._bwd(lg, lb, ctt)
                    torch.cuda.synchronize()
                    assert tx.launches["forward"] == before["forward"] + 1
                    assert tx.launches["backward"] == before["backward"] + 1
                    rl = tx._plain_fwd(lg, lb)
                    rd = tx._plain_bwd(lg, lb, ctt)
                    assert torch.allclose(loss, rl, rtol=1e-6, atol=1e-6)
                    tol = (1e-6 if dtype == torch.float32
                           else bf16_ulp(rd.float().abs().max().item()))
                    assert (d.float() - rd.float()).abs().max().item() <= tol
    # Out-of-range labels: the kernels' loss and gradient equal the plain
    # versions' (logsumexp and softmax * ct, as the JAX kernels give).
    logits, _, ct = _inputs(4, 10, seed=5)
    lg = torch.from_numpy(logits).cuda()
    lb = torch.tensor([0, 10, -1, 9], device="cuda")
    ctt = torch.from_numpy(ct).cuda()
    loss, d = tx._fwd(lg, lb), tx._bwd(lg, lb, ctt)
    assert torch.allclose(loss, tx._plain_fwd(lg, lb), rtol=1e-6, atol=1e-6)
    assert torch.allclose(d, tx._plain_bwd(lg, lb, ctt), rtol=1e-6,
                          atol=1e-6)
    assert bool(torch.isfinite(loss).all())
