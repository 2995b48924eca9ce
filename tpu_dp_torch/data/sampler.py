"""Host-sharded, epoch-seeded sampling (port of `tpu_dp.data.sampler`,
`ShardedSampler` only): the `DistributedSampler` contract.

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
