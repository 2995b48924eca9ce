"""Gradient-bucket plans of the port's sharded update
(`tpu_dp_torch.parallel.bucketing`, `collectives.exchange_plan`) against
the JAX package's (`tpu_dp.parallel.bucketing`) on the CPU: the same
plan key for key (sizes, quantize flags, summaries) over the same
``(key, size)`` pairs, and over each package's own parameter tree at
full width (which also holds the port's leaf order to the JAX pytree's:
dict keys sorted as strings, so ResNet-50's ``BottleneckBlock_10`` comes
before ``BottleneckBlock_2``). Exact throughout."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tpu_dp.models import build_model as jax_build
from tpu_dp.parallel import bucketing as jbucketing
from tpu_dp.parallel.quant import leaf_key
from tpu_dp_torch.compat import leaf_sizes
from tpu_dp_torch.models import build_model
from tpu_dp_torch.parallel import bucketing, collectives, quant

pytestmark = pytest.mark.port

SAMPLE = np.zeros((1, 32, 32, 3), np.float32)


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, nc in (("resnet18", 10), ("resnet50", 100)):
        model = jax_build(name, num_classes=nc)
        params = jax.eval_shape(lambda m=model: m.init(
            jax.random.PRNGKey(0), SAMPLE, train=False))["params"]
        with torch.device("meta"):
            port = build_model(name, num_classes=nc)
        out[name] = params, leaf_sizes(port.named_parameters())
    return out


def _same(got, want):
    assert [(b.index, b.keys, b.sizes, b.quantizes) for b in got] == [
        (b.index, b.keys, b.sizes, b.quantizes) for b in want]


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_leaf_order_is_the_jax_pytree_order(trees, name):
    params, leaves = trees[name]
    assert leaves == [(leaf_key(p), int(x.size)) for p, x in
                      jax.tree_util.tree_leaves_with_path(params)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("bucket_mb", [0.05, 1.0, 4.0, 25.0])
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_plan_matches_jax(trees, name, bucket_mb, world, int8):
    params, leaves = trees[name]
    bb = bucketing.parse_bucket_mb(bucket_mb)
    got = bucketing.plan_for_tree(leaves, world, bb, block_size=256,
                                  int8=int8)
    _same(got, jbucketing.plan_for_tree(params, world, bb, block_size=256,
                                        int8=int8))
    assert bucketing.plan_summary(got, world, 256) == \
        jbucketing.plan_summary(jbucketing.plan_buckets(
            leaves, world, bb, block_size=256, int8=int8), world, 256)
    assert [b.key for b in got] == [bucketing.KEY_SEP.join(b.keys)
                                    for b in got]


def test_plan_sizes_at_25_mb(trees):
    """ResNet-18 at world 4, 25 MB: 2 buckets of 15 and 47 leaves (the JAX
    package's plan); ResNet-50: 4 buckets."""
    _, r18 = trees["resnet18"]
    plan = bucketing.plan_for_tree(r18, 4, bucketing.parse_bucket_mb(25))
    assert [len(b.keys) for b in plan] == [15, 47]
    _, r50 = trees["resnet50"]
    assert len(bucketing.plan_for_tree(
        r50, 4, bucketing.parse_bucket_mb(25))) == 4


@pytest.mark.parametrize("block", [16, 64, 256])
@pytest.mark.parametrize("world", [2, 3, 5])
def test_plan_buckets_matches_jax_on_pairs(world, block):
    rng = np.random.default_rng(world * block)
    leaves = [(f"m{i}/kernel", int(n)) for i, n in
              enumerate(rng.integers(1, 5000, size=40))]
    for bb in (1, 4096, 20000, 10**6):
        for int8 in (False, True):
            _same(bucketing.plan_buckets(leaves, world, bb,
                                         block_size=block, int8=int8),
                  jbucketing.plan_buckets(leaves, world, bb,
                                          block_size=block, int8=int8))
    for b, jb in zip(bucketing.plan_buckets(leaves, world, 20000,
                                            block_size=block, int8=True),
                     jbucketing.plan_buckets(leaves, world, 20000,
                                             block_size=block, int8=True)):
        assert (b.padded_elements(world), b.shard_elements(world),
                b.quant_padded(world, block)) == (
            jb.padded_elements(world), jb.shard_elements(world),
            jb.quant_padded(world, block))


def test_parse_bucket_mb_and_composition():
    assert bucketing.parse_bucket_mb(0) == 0
    assert bucketing.parse_bucket_mb(None) == 0
    assert bucketing.parse_bucket_mb(25) == jbucketing.parse_bucket_mb(25)
    assert bucketing.parse_bucket_mb(0.05) == jbucketing.parse_bucket_mb(0.05)
    with pytest.raises(ValueError, match="bucket_mb"):
        bucketing.parse_bucket_mb(-1)
    with pytest.raises(ValueError, match="bucket_bytes"):
        bucketing.plan_buckets([("a", 1)], 1, 0)
    assert bucketing.composition("a/b+c/d") == ["a/b", "c/d"]


@pytest.mark.parametrize("wire,bucket_mb", [("", 0.0), ("bf16", 0.0),
                                            ("int8", 0.0), ("", 1.0),
                                            ("int8", 1.0), ("int8", 25.0)])
@pytest.mark.parametrize("world", [1, 4])
def test_exchange_plan_covers_every_leaf_once(trees, world, wire,
                                              bucket_mb):
    """One exchange (f32, bf16), the quantizing leaves and the rest
    (int8), or one per bucket in plan order; each leaf once, each
    quantizing segment keyed as the residuals are."""
    _, leaves = trees["resnet18"]
    codec = quant.make_wire_codec(wire)
    bb = bucketing.parse_bucket_mb(bucket_mb)
    plan = collectives.exchange_plan(leaves, world, codec=codec,
                                     bucket_bytes=bb)
    keys = [k for ex in plan for seg in ex.segments for k in seg.keys]
    assert sorted(keys) == sorted(k for k, _ in leaves)
    assert len(keys) == len(set(keys))
    want_exchanges = (len(bucketing.plan_for_tree(leaves, world, bb))
                      if bb else 2 if wire == "int8" else 1)
    assert len(plan) == want_exchanges
    res = quant.init_residuals(leaves, world, 256, bb) if wire == "int8" \
        else {}
    quantizing = {seg.key: world * seg.cpad for ex in plan if ex.quantizes
                  for seg in ex.segments}
    assert quantizing == {k: v.shape[1] for k, v in res.items()}
    for ex in plan:
        for seg in ex.segments:
            schunk = sum(collectives.shard_size(n, world) for n in seg.sizes)
            assert seg.cpad >= schunk
            assert not ex.quantizes or seg.cpad % 256 == 0
