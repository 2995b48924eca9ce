"""The int8 wire codec of the port's sharded update
(`tpu_dp_torch.parallel.quant`, `collectives.psum_scatter_quant`) against
the JAX package's (`tpu_dp.parallel.quant`) on the CPU, bit for bit: the
same numpy vectors through both codecs (q, scales, dequantized values,
block counts; NaN and ±inf blocks, all-zero blocks, rail crowding), the
layout arithmetic, the residual state's keys and shapes, the byte
accounting on ResNet-18's and ResNet-50's parameter trees at full width,
the residual relayouts, and the one-process exchange against a numpy
composition of the JAX codec. Exact throughout (integer arithmetic, or
the same f32 operations in the same order)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dp.models import build_model as jax_build
from tpu_dp.parallel import quant as jquant
from tpu_dp_torch.compat import leaf_sizes
from tpu_dp_torch.models import build_model
from tpu_dp_torch.parallel import collectives, quant
from tpu_dp_torch.train.optim import shard_optimizer
from tpu_dp_torch.train.step import _sharded_reduce

pytestmark = pytest.mark.port

SAMPLE = np.zeros((1, 32, 32, 3), np.float32)


def _both(x, block):
    q, s = quant.quantize_blocks(torch.from_numpy(x), block)
    jq, js = jquant.quantize_blocks(jnp.asarray(x), block)
    return (q.numpy(), s.numpy()), (np.asarray(jq), np.asarray(js))


def _vector(kind, block, rng):
    x = rng.normal(size=4 * block).astype(np.float32)
    if kind == "scaled":
        x *= np.repeat(np.float32([1e-6, 1.0, 1e3, 3e-2]), block)
    elif kind == "zeros":
        x[block:2 * block] = 0.0
    elif kind == "halves":
        # Quotients at exact halves: round half to even decides.
        x = np.tile(np.float32([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5,
                                -2.5]), block // 2)
    elif kind in ("nan", "inf", "-inf"):
        x[block + 3] = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf}[kind]
    elif kind == "rail":
        x[:block] = 0.5
        x[block - 1] = x[0] = x[1] = 1.0
    return x


@pytest.mark.parametrize("kind", ["normal", "scaled", "zeros", "halves",
                                  "nan", "inf", "-inf", "rail"])
@pytest.mark.parametrize("block", [16, 64, 256])
def test_codec_is_the_jax_codec(kind, block):
    x = _vector(kind, block, np.random.default_rng(block))
    (q, s), (jq, js) = _both(x, block)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    deq = quant.dequantize_blocks(torch.from_numpy(q), torch.from_numpy(s),
                                  block).numpy()
    np.testing.assert_array_equal(deq, np.asarray(jquant.dequantize_blocks(
        jnp.asarray(jq), jnp.asarray(js), block)))
    stats = [int(v) for v in quant.block_stats(torch.from_numpy(q),
                                               torch.from_numpy(s))]
    assert stats == [int(v) for v in jquant.block_stats(jnp.asarray(jq),
                                                        jnp.asarray(js))]
    if kind in ("nan", "inf", "-inf"):
        assert stats[0] == 1
        assert np.isfinite(deq[:block]).all()
        assert not np.isfinite(deq[block:2 * block]).all()
    if kind == "zeros":
        assert not deq[block:2 * block].any()
    if kind == "rail":
        assert stats[1] == 1


def test_codec_error_bound():
    x = np.random.default_rng(0).normal(size=1024).astype(np.float32)
    q, s = quant.quantize_blocks(torch.from_numpy(x), 256)
    back = quant.dequantize_blocks(q, s, 256).numpy()
    err = np.abs(back - x).reshape(4, 256).max(axis=1)
    assert (err <= np.abs(x).reshape(4, 256).max(axis=1) / 254 + 1e-7).all()


def test_make_wire_codec_parsing():
    assert quant.make_wire_codec("") is None
    assert quant.make_wire_codec("f32") is None
    assert quant.make_wire_codec("bf16").dtype == torch.bfloat16
    c = quant.make_wire_codec("int8", block_size=64, error_feedback=False)
    assert (c.block_size, c.error_feedback) == (64, False)
    with pytest.raises(ValueError, match="collective_dtype"):
        quant.make_wire_codec("int4")
    with pytest.raises(ValueError, match="quant_block_size"):
        quant.make_wire_codec("int8", block_size=0)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_layout_arithmetic(world):
    for n in (1, 7, 450, 2047, 2048, 2400, 6001, 48000, 2359296):
        assert collectives.padded_size(n, world) == (
            n + (-n) % world)
        assert collectives.shard_size(n, world) * world == \
            collectives.padded_size(n, world)
        for block in (64, 256):
            assert quant.quant_padded_size(n, world, block) == \
                jquant.quant_padded_size(n, world, block)
            assert quant.leaf_quantizes(n, world, block) == \
                jquant.leaf_quantizes(n, world, block)


def _jax_params(name, num_filters=64, num_classes=10):
    """The JAX model's parameter shapes (no arrays)."""
    model = jax_build(name, num_classes=num_classes, num_filters=num_filters)
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), SAMPLE, train=False))["params"]


def _port_leaves(name, num_filters=64, num_classes=10):
    with torch.device("meta"):
        model = build_model(name, num_classes=num_classes,
                            num_filters=num_filters)
    return leaf_sizes(model.named_parameters())


@pytest.fixture(scope="module")
def trees():
    return {name: (_jax_params(name, num_classes=nc),
                   _port_leaves(name, num_classes=nc))
            for name, nc in (("resnet18", 10), ("resnet50", 100))}


@pytest.mark.parametrize("bucket_mb", [0.0, 25.0, 1.0])
@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_wire_report_matches_jax(trees, name, world, bucket_mb):
    jp, leaves = trees[name]
    bb = int(bucket_mb * 2**20)
    assert quant.wire_report(leaves, world, 256, bb) == jquant.wire_report(
        jp, world, 256, bb)


def test_wire_report_resnet18_bytes(trees):
    _, leaves = trees["resnet18"]
    assert quant.wire_report(leaves, 1)["wire_bytes_per_step"]["f32"] \
        == 44_695_848
    assert quant.wire_report(leaves, 4)["wire_bytes_per_step"] == {
        "f32": 44_695_856, "bf16": 22_347_928, "int8": 11_377_568}


@pytest.mark.parametrize("bucket_mb", [0.0, 0.01])
@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", ["net", "resnet18"])
def test_init_residuals_match_jax(name, world, bucket_mb):
    if name == "net":
        from tpu_dp.models import Net

        params = Net().init(jax.random.PRNGKey(0), SAMPLE)["params"]
        model = build_model("net")
    else:
        model_j = jax_build("resnet18", num_classes=10, num_filters=8)
        params = model_j.init(jax.random.PRNGKey(0), SAMPLE,
                              train=False)["params"]
        model = build_model("resnet18", num_classes=10, num_filters=8)
    bb = int(bucket_mb * 2**20)
    want = jquant.init_residuals(params, world, 64, bucket_bytes=bb)
    got = quant.init_residuals(leaf_sizes(model.named_parameters()), world,
                               64, bucket_bytes=bb)
    assert list(got) == list(want)
    assert all(got[k].shape == want[k].shape and not got[k].any()
               for k in want)
    # The sharded update keys its residual buffers the same way.
    opt = shard_optimizer(model, codec=quant.make_wire_codec("int8", 64),
                          bucket_bytes=bb) if world == 1 else None
    if opt is not None:
        assert sorted(opt.residuals) == sorted(want)
        assert all(opt.residuals[k].numel() == want[k].shape[1]
                   for k in want)
    local = quant.local_residuals(got, world)
    assert all(v.shape == (1, got[k].shape[1]) for k, v in local.items())


def test_residual_relayout_matches_jax():
    rng = np.random.default_rng(5)
    sizes = {"a/kernel": 2400, "b/bias": 7, "c/kernel": 48000}
    for key, w_old, w_new in (("a/kernel", 8, 4),
                              ("c/kernel+b/bias+a/kernel", 2, 4),
                              ("b/bias+c/kernel", 4, 1)):
        ks = key.split("+")
        cpad = sum(collectives.shard_size(sizes[k], w_old) for k in ks)
        cpad += (-cpad) % 64
        saved = rng.normal(size=(w_old, w_old * cpad)).astype(np.float32)
        got = quant.decompose_residual(saved, sizes, key)
        want = jquant.decompose_residual(saved, sizes, key)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        new_cpad = sum(collectives.shard_size(sizes[k], w_new) for k in ks)
        like = np.zeros((w_new, w_new * new_cpad), np.float32)
        np.testing.assert_array_equal(
            quant.compose_residual(got, like, sizes, key),
            jquant.compose_residual(want, like, sizes, key))
    assert quant.decompose_residual(np.zeros((2, 3)), sizes, "x/y") == {}


@pytest.mark.parametrize("block", [64, 256])
def test_one_process_exchange_is_the_jax_codec(block):
    """World 1, no group: the reduce hook quantizes each quantizing leaf
    with its residual (JAX's composition) and dequantizes it."""
    model = build_model("net")
    codec = quant.make_wire_codec("int8", block)
    opt = shard_optimizer(model, codec=codec)
    gen = torch.Generator().manual_seed(2)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    before = {k: v.clone() for k, v in opt.residuals.items()}
    flat_jax = {}
    from tpu_dp_torch.compat import param_leaves

    for key, name, index in param_leaves(model.named_parameters()):
        flat_jax[key] = dict(model.named_parameters())[name].grad.reshape(
            -1)[index].numpy()
    grad, stats = _sharded_reduce(opt)
    for key, (s, c) in opt.shard_of.items():
        g = flat_jax[key]
        if key in before:
            cpad = before[key].numel()
            eff = np.pad(g, (0, cpad - g.size)) + before[key].reshape(
                -1).numpy()
            jq, js = jquant.quantize_blocks(jnp.asarray(eff), block)
            deq = np.asarray(jquant.dequantize_blocks(jq, js, block))
            np.testing.assert_array_equal(grad[s:s + c].numpy(),
                                          deq[:g.size])
            np.testing.assert_array_equal(
                opt.residuals[key].reshape(-1).numpy(), eff - deq)
        else:
            np.testing.assert_array_equal(grad[s:s + c].numpy(), g)
    assert [int(v) for v in stats] == [0, 0] or int(stats[0]) == 0
