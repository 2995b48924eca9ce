"""Host-sharded, epoch-seeded sampling (port of `tpu_dp.data.sampler`):
the `DistributedSampler` contract, and the elastic re-split of an
interrupted epoch (`elastic_resplit`, `ElasticTailSampler`), whose index
lists equal the JAX package's bit for bit.

- a *global* permutation computed identically on every shard from a shared
  seed (numpy's generator, so the index streams equal the JAX package's);
- pad-by-wraparound to make the total divisible by the shard count, or an
  explicit ``drop_remainder``;
- strided ``shard_id::num_shards`` selection;
- `set_epoch(e)` reseeds the shuffle.
"""

from __future__ import annotations

import numpy as np


class ShardedSampler:
    """Deterministic per-shard index stream over ``num_examples``."""

    def __init__(
        self,
        num_examples: int,
        num_shards: int,
        shard_id: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = False,
    ):
        if not 0 <= shard_id < num_shards:
            raise ValueError(
                f"shard_id {shard_id} out of range for {num_shards} shards"
            )
        self.num_examples = num_examples
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Select the epoch's permutation."""
        self.epoch = int(epoch)

    def __len__(self) -> int:
        if self.drop_remainder:
            return self.num_examples // self.num_shards
        return -(-self.num_examples // self.num_shards)  # ceil

    def shard_indices(self) -> np.ndarray:
        """This shard's indices for the current epoch (int64, stable)."""
        if self.shuffle:
            # Seeded identically on every shard: all ranks agree on the
            # global permutation with zero communication.
            rng = np.random.default_rng([self.seed, self.epoch])
            indices = rng.permutation(self.num_examples).astype(np.int64)
        else:
            indices = np.arange(self.num_examples, dtype=np.int64)

        if self.drop_remainder:
            total = (self.num_examples // self.num_shards) * self.num_shards
            indices = indices[:total]
        else:
            total = -(-self.num_examples // self.num_shards) * self.num_shards
            pad = total - len(indices)
            if pad:
                # torch's pad-by-wraparound: repeat the stream as many times
                # as needed (pad can exceed num_examples when shards > N).
                reps = -(-pad // max(1, len(indices)))
                indices = np.concatenate(
                    [indices] + [indices] * reps
                )[:total]
        return indices[self.shard_id :: self.num_shards]


def elastic_resplit(num_examples: int, shuffle: bool, seed: int, epoch: int,
                    per_step: int, lineage, new_world: int,
                    new_shard_id: int) -> np.ndarray:
    """An interrupted epoch's *remaining* samples, re-split over the
    survivors: shard ``new_shard_id`` of ``new_world``.

    After a mid-epoch world change every sample of the epoch not consumed
    yet is visited exactly once on the new world, and every survivor
    computes the same answer with no communication. ``lineage`` is the
    epoch's consumption so far, ``(world, steps)`` segments: ``steps``
    updates sharded over ``world`` processes, each shard consuming
    ``steps * per_step`` indices (``per_step`` = per-process batch ×
    microbatches, constant across regroups). Per segment: pad the
    remaining stream by wraparound to a multiple of its world and shard
    it round-robin (`ShardedSampler`'s own layout for segment 0, its pad
    included), drop each shard's consumed head, and concatenate the shard
    tails in rank order as the next remaining stream. The result is
    truncated so every survivor gets the same whole-step count (the ranks
    step in lockstep; the ≤ ``new_world × per_step − 1`` seam samples this
    sheds are the ``drop_remainder`` every epoch end applies)."""
    if not 0 <= new_shard_id < new_world:
        raise ValueError(
            f"new_shard_id {new_shard_id} out of range for world {new_world}")
    base = ShardedSampler(int(num_examples), num_shards=1, shard_id=0,
                          shuffle=shuffle, seed=seed, drop_remainder=False)
    base.set_epoch(epoch)
    remaining = base.shard_indices()  # the epoch's whole permutation
    per_step = int(per_step)
    for world, steps in lineage:
        world, steps = int(world), int(steps)
        if world <= 0 or steps < 0:
            raise ValueError(f"bad lineage segment ({world}, {steps})")
        stream = _pad_to_multiple(remaining, world)
        shards = [stream[r::world] for r in range(world)]
        consumed = steps * per_step
        if consumed > len(shards[0]):
            raise ValueError(
                f"lineage segment ({world}, {steps}) consumes {consumed} "
                f"of {len(shards[0])}-sample shards")
        remaining = np.concatenate([s[consumed:] for s in shards])
    steps_each = (len(remaining) // new_world) // per_step
    mine = remaining[new_shard_id::new_world][:steps_each * per_step]
    return np.ascontiguousarray(mine)


def _pad_to_multiple(indices: np.ndarray, shards: int) -> np.ndarray:
    """`ShardedSampler`'s pad-by-wraparound, applied to an explicit
    stream."""
    total = -(-len(indices) // shards) * shards
    pad = total - len(indices)
    if not pad:
        return indices
    reps = -(-pad // max(1, len(indices)))
    return np.concatenate([indices] + [indices] * reps)[:total]


class ElasticTailSampler:
    """The explicit index stream of a re-split epoch tail, in place of
    `ShardedSampler` inside `DataPipeline` (``shard_indices``, ``len``,
    ``set_epoch``). ``set_epoch`` of another epoch raises: the tail
    belongs to one epoch, and reseeding it would replay consumed
    samples."""

    def __init__(self, indices: np.ndarray, epoch: int):
        self._indices = np.ascontiguousarray(np.asarray(indices, np.int64))
        self.epoch = int(epoch)

    def set_epoch(self, epoch: int) -> None:
        if int(epoch) != self.epoch:
            raise ValueError(
                f"ElasticTailSampler is pinned to epoch {self.epoch}; "
                f"set_epoch({epoch}) would replay consumed samples")

    def __len__(self) -> int:
        return len(self._indices)

    def shard_indices(self) -> np.ndarray:
        return self._indices
