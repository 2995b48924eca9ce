"""Gradient-bucket planning of the sharded update's exchange (port of
`tpu_dp.parallel.bucketing`, pure Python, the port's own copy).

``train.bucket_mb`` splits the gradient reduce-scatter into size-targeted
buckets, one exchange each, issued in plan order on every rank. This
module is the one source of truth for how gradient leaves map to buckets;
the same plan drives

- the wire schedule (`tpu_dp_torch.train.optim.ShardedUpdate`'s
  exchanges, one collective set per bucket),
- the error-feedback residual layout (`quant.init_residuals`: one residual
  per quantizing bucket, keyed by the bucket's composition key),
- the byte accounting (`quant.wire_report(bucket_bytes=...)`),
- and the checkpoint relayout (`tpu_dp_torch.checkpoint`), which carries a
  residual across bucket or world changes by composition key.

Planning rules (the JAX package's): leaves are ``(key, elements)`` pairs
in the JAX pytree order (dict keys sorted as strings, so ResNet-50's
``BottleneckBlock_10`` comes before ``BottleneckBlock_2``), assigned in
reverse order; a bucket closes when its world-padded f32 payload reaches
``bucket_bytes``; the first leaf always enters the current bucket. Under
the int8 codec a bucket quantizes when its element count is at least
``world * block_size`` (`quant.leaf_quantizes`); smaller buckets ride the
f32 reduce-scatter and carry no residual.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

#: Composition-key separator: a bucket's residual key is its leaf keys
#: joined in issue order; a single-leaf bucket's key is the leaf key.
KEY_SEP = "+"


@dataclasses.dataclass(frozen=True)
class GradBucket:
    """One bucket of the gradient exchange plan (static metadata only)."""

    index: int                 # issue order
    keys: tuple[str, ...]      # leaf keys, issue order
    sizes: tuple[int, ...]     # true (unpadded) element counts per leaf
    quantizes: bool = False    # rides the int8 wire (codec on + threshold)

    @property
    def key(self) -> str:
        """Self-describing composition key (residual dict / report key)."""
        return KEY_SEP.join(self.keys)

    @property
    def elements(self) -> int:
        return sum(self.sizes)

    def padded_elements(self, world: int) -> int:
        """World-padded element count of the concatenated f32 payload."""
        from tpu_dp_torch.parallel.collectives import padded_size

        return sum(padded_size(n, world) for n in self.sizes)

    def shard_elements(self, world: int) -> int:
        """One rank's chunk of the concatenated payload (Σ per-leaf
        `shard_size`, before block padding)."""
        from tpu_dp_torch.parallel.collectives import shard_size

        return sum(shard_size(n, world) for n in self.sizes)

    def quant_padded(self, world: int, block_size: int) -> int:
        """Flat length of the bucket's block-padded int8 wire layout (the
        residual's qpad; every 1/world chunk a whole number of blocks)."""
        from tpu_dp_torch.parallel.quant import quant_padded_size

        return quant_padded_size(self.shard_elements(world) * world,
                                 world, block_size)


def composition(key: str) -> list[str]:
    """Leaf keys of a residual/bucket key (single-leaf keys included)."""
    return key.split(KEY_SEP)


def parse_bucket_mb(bucket_mb: Any) -> int:
    """``train.bucket_mb`` -> target bucket payload bytes (0 = off)."""
    mb = float(bucket_mb or 0.0)
    if mb < 0:
        raise ValueError(f"train.bucket_mb must be >= 0, got {bucket_mb!r}")
    return int(mb * 2**20)


def plan_buckets(leaves: Sequence[tuple[str, int]], world: int,
                 bucket_bytes: int, *, block_size: int | None = None,
                 int8: bool = False) -> list[GradBucket]:
    """Partition ``leaves`` (``(key, element_count)`` pairs, JAX pytree
    order) into size-targeted buckets in reverse order. Deterministic in
    the leaf order and sizes alone, so every rank and every consumer
    derives the same plan."""
    from tpu_dp_torch.parallel.collectives import padded_size
    from tpu_dp_torch.parallel.quant import DEFAULT_BLOCK_SIZE, leaf_quantizes

    if bucket_bytes <= 0:
        raise ValueError("plan_buckets needs bucket_bytes > 0 "
                         "(bucketing off has no plan)")
    block = DEFAULT_BLOCK_SIZE if block_size is None else int(block_size)
    buckets: list[GradBucket] = []
    cur_keys: list[str] = []
    cur_sizes: list[int] = []
    cur_bytes = 0

    def close() -> None:
        nonlocal cur_keys, cur_sizes, cur_bytes
        if not cur_keys:
            return
        buckets.append(GradBucket(
            index=len(buckets), keys=tuple(cur_keys), sizes=tuple(cur_sizes),
            quantizes=bool(int8) and leaf_quantizes(sum(cur_sizes), world,
                                                    block)))
        cur_keys, cur_sizes, cur_bytes = [], [], 0

    for key, n in reversed(list(leaves)):
        cur_keys.append(key)
        cur_sizes.append(int(n))
        cur_bytes += padded_size(int(n), world) * 4
        if cur_bytes >= bucket_bytes:
            close()
    close()
    return buckets


def plan_for_tree(leaves, world: int, bucket_bytes: int, *,
                  block_size: int | None = None,
                  int8: bool = False) -> list[GradBucket]:
    """`plan_buckets` over a parameter tree's ``(flax_key, size)`` pairs
    (`tpu_dp_torch.compat.param_leaves` gives them for a model), or a
    ``{flax_key: size}`` dict in JAX order."""
    pairs = list(leaves.items()) if isinstance(leaves, dict) else list(leaves)
    return plan_buckets(pairs, world, bucket_bytes, block_size=block_size,
                        int8=int8)


def plan_summary(plan: Sequence[GradBucket], world: int,
                 block_size: int | None = None) -> list[dict]:
    """JSON-able per-bucket layout (the run records' ``buckets`` field)."""
    from tpu_dp_torch.parallel.quant import DEFAULT_BLOCK_SIZE

    block = DEFAULT_BLOCK_SIZE if block_size is None else int(block_size)
    out = []
    for b in plan:
        entry = {
            "index": b.index,
            "leaves": len(b.keys),
            "elements": b.elements,
            "padded_elements": b.padded_elements(world),
            "shard_elements": b.shard_elements(world),
            "wire": "int8" if b.quantizes else "f32",
        }
        if b.quantizes:
            entry["quant_padded_elements"] = b.quant_padded(world, block)
        out.append(entry)
    return out
