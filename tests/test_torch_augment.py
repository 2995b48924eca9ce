"""The port's crop/flip draws are `jax.random`'s own bits (threefry2x32,
``jax_threefry_partitionable`` on, as the installed JAX runs the JAX
package), and an augmented run of the port tracks the JAX package's.

- `threefry2x32`, `prng_key`, `fold_in`, `split`, `random_bits`,
  `randint`, `uniform` and `bernoulli` of `tpu_dp_torch.data.augment`
  against `jax._src.prng` and `jax.random`, bit for bit, over seeds, keys,
  ranges and shapes.
- `crop_flip_draws` and `random_crop_flip` against `tpu_dp.data.augment.
  random_crop_flip`, bit for bit: the global batch, each rank's rows at
  world 2 and 4, the accumulation keys ``step·a + i``, and the sharded
  update's per-shard draws as the JAX package runs them under
  ``shard_map`` (every shard draws rows 0..B-1).
- The augmented `Trainer` against the JAX package's augmented `Trainer`
  from the same init: the reference `Net` at world 1 and on two gloo ranks
  (each rank drawing its own rows of the global batch), with gradient
  accumulation, and an unfused narrow ResNet-18 (the preset's CLI at full
  width is held in tests/test_torch_augment_cli.py). Per-update losses and
  final parameters within 1e-4 (the bound the two
  Trainers are held to in tests/test_torch_net.py; unfused, since the
  fused path's gradients are noise in the reference itself, ROADMAP Queue
  3 item 1).
- On a card (``card`` marker; skipped here) the kernel equals the plain
  version bit for bit, under graph replay too.
"""

from __future__ import annotations

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng
from jax.sharding import PartitionSpec as P

import tpu_dp.config as jax_config
from torch_ddp_worker import run_trainer
from torch_port_util import run_worker_ranks
from tpu_dp import checkpoint as jck
from tpu_dp.data import augment as jaug
from tpu_dp.data.sampler import ShardedSampler
from tpu_dp.parallel import dist as jax_dist
from tpu_dp.train import trainer as jax_trainer_mod
from tpu_dp.train.step import _shard_map
from tpu_dp_torch.data import augment as aug
from tpu_dp_torch.checkpoint import _walk_state_dict
from tpu_dp_torch.ops import augment as aug_ops
from tpu_dp_torch.train import trainer as trainer_mod

pytestmark = pytest.mark.port

torch.set_num_threads(2)

SEEDS = (0, 1, 7, 2**31 - 1, 2**33 + 5)
KEYS = (0, 5, 12345, 2**31 - 1)


def _key(k) -> tuple[int, int]:
    return tuple(int(v) for v in np.asarray(k).tolist())


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)


# -- jax.random's functions ----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_threefry2x32_is_jaxs(seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**32, 2, dtype=np.uint32)
    x = rng.integers(0, 2**32, (2, 257), dtype=np.uint32)
    want = jprng.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]),
                                     jnp.asarray(x[0]), jnp.asarray(x[1]))
    got = aug.threefry2x32(int(k[0]), int(k[1]),
                           torch.from_numpy(x[0].astype(np.int64)),
                           torch.from_numpy(x[1].astype(np.int64)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_chain_is_jaxs(seed):
    base = jax.random.PRNGKey(seed)
    assert aug.prng_key(seed) == _key(base)
    for s in KEYS:
        folded = jax.random.fold_in(base, s)
        assert _key(aug.fold_in(aug.prng_key(seed), s)) == _key(folded)
        dev = aug.fold_in(aug.prng_key(seed), torch.tensor(s))
        assert _key([int(v) for v in dev]) == _key(folded)
        for num in (2, 3):
            want = [_key(k) for k in jax.random.split(folded, num)]
            assert [_key(k) for k in aug.split(_key(folded), num)] == want


@pytest.mark.parametrize("shape", [(7,), (4, 6), (3, 2, 5)])
@pytest.mark.parametrize("seed", [0, 11])
def test_bits_randint_uniform_bernoulli_are_jaxs(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 42)
    mine = _key(key)
    size = int(np.prod(shape))
    counts = torch.arange(size)
    np.testing.assert_array_equal(
        aug.random_bits(mine, counts).view(shape).numpy(),
        np.asarray(jax.random.bits(key, shape), np.int64))
    for lo, hi in ((0, 9), (3, 1000), (-5, 5), (0, 2**31 - 1), (7, 7),
                   (-2**31, 2**31 - 1)):
        np.testing.assert_array_equal(
            aug.randint(mine, counts, lo, hi).view(shape).numpy(),
            np.asarray(jax.random.randint(key, shape, lo, hi)))
    np.testing.assert_array_equal(
        aug.uniform(mine, counts).view(shape).numpy(),
        np.asarray(jax.random.uniform(key, shape)))
    for p in (0.5, 0.1):
        np.testing.assert_array_equal(
            aug.bernoulli(mine, p, counts).view(shape).numpy(),
            np.asarray(jax.random.bernoulli(key, p, shape)))


# -- the draws and the crops ---------------------------------------------------


def _jax_draws(seed, s, n):
    """The JAX package's offsets and flips of an n-row batch at key s."""
    k_off, k_flip = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(seed), s))
    return (np.asarray(jax.random.randint(k_off, (n, 2), 0, 9)),
            np.asarray(jax.random.bernoulli(k_flip, 0.5, (n,))))


@pytest.mark.parametrize("seed", [1, 8])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_each_ranks_draws_are_its_rows_of_the_global_batch(seed, world):
    b = 6
    for s in (0, 3, 1000):
        offsets, flips = _jax_draws(seed, s, world * b)
        for r in range(world):
            o, f = aug.crop_flip_draws(torch.tensor(s), b, seed, r * b,
                                       world * b)
            assert o.dtype == torch.int64 and f.dtype == torch.bool
            np.testing.assert_array_equal(o.numpy(),
                                          offsets[r * b:(r + 1) * b])
            np.testing.assert_array_equal(f.numpy(), flips[r * b:(r + 1) * b])
    with pytest.raises(ValueError, match="outside a batch"):
        aug.crop_flip_draws(torch.tensor(0), b, seed, 4, 8)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_augment_fn_crops_each_ranks_rows_as_the_jax_package(world):
    b, seed = 4, 3
    images = _images(world * b)
    theirs = jaug.make_augment_fn(seed)
    for s in (0, 7, 31):
        want = np.asarray(theirs(jnp.int32(s), jnp.asarray(images)))
        for r in range(world):
            mine = aug.make_augment_fn(seed, row0=r * b, global_n=world * b)
            got = mine(torch.tensor(s), torch.from_numpy(
                images[r * b:(r + 1) * b]))
            np.testing.assert_array_equal(got.numpy(),
                                          want[r * b:(r + 1) * b])
    # random_crop_flip on the JAX package's own draws (pad fill 0).
    offsets, flips = _jax_draws(seed, 5, world * b)
    got = aug.random_crop_flip(torch.from_numpy(images),
                               torch.from_numpy(offsets).long(),
                               torch.from_numpy(flips))
    want = jaug.random_crop_flip(
        jax.random.fold_in(jax.random.PRNGKey(seed), 5), jnp.asarray(images))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("accum", [2, 3])
def test_accumulation_keys_are_step_times_a_plus_i(accum):
    """`_make_accum_body`: microbatch i of update ``step`` draws under
    ``step·a + i``; the port's ``aug(step, x, a, i)`` gives the same."""
    b, seed, step = 4, 5, 6
    images = _images(accum * 2 * b).reshape(accum, 2 * b, 32, 32, 3)
    theirs = jaug.make_augment_fn(seed)
    want = np.asarray(jax.vmap(
        lambda i, im: theirs(jnp.int32(step) * accum + i, im))(
        jnp.arange(accum), jnp.asarray(images)))
    for r in range(2):
        mine = aug.make_augment_fn(seed, row0=r * b, global_n=2 * b)
        for i in range(accum):
            got = mine(torch.tensor(step), torch.from_numpy(
                images[i, r * b:(r + 1) * b]), accum, i)
            np.testing.assert_array_equal(got.numpy(),
                                          want[i, r * b:(r + 1) * b])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_mode_draws_rows_0_to_b_on_every_shard(mesh8, world):
    """Under ``shard_map`` (the sharded update's step) the augment sees
    each shard's local rows with the same key: every shard draws rows
    0..B-1, which the port's sharded Trainer reproduces (``row0=0,
    global_n=B`` on every rank)."""
    b, seed, s = 4, 2, 9
    mesh = jax_dist.data_mesh(devices=jax.devices()[:world])
    images = _images(world * b)
    fn = jaug.make_augment_fn(seed)
    sharded = jax.jit(_shard_map(lambda im: fn(jnp.int32(s), im), mesh,
                                 P(jax_dist.DATA_AXIS),
                                 P(jax_dist.DATA_AXIS)))
    want = np.asarray(sharded(jnp.asarray(images)))
    mine = aug.make_augment_fn(seed, row0=0, global_n=b)
    for r in range(world):
        got = mine(torch.tensor(s), torch.from_numpy(
            images[r * b:(r + 1) * b]))
        np.testing.assert_array_equal(got.numpy(), want[r * b:(r + 1) * b])
    # ... which is not the replicated step's global draw.
    whole = np.asarray(fn(jnp.int32(s), jnp.asarray(images)))
    assert not np.array_equal(whole, want)


def test_the_wrapper_runs_the_plain_version_on_cpu_tensors():
    aug_ops.reset_launches()
    o, f = aug_ops.crop_flip_draws(torch.tensor(4), 8, 3, 8, 16, 2, 1)
    po, pf = aug.crop_flip_draws(torch.tensor(9), 8, 3, 8, 16)
    assert torch.equal(o, po) and torch.equal(f, pf)
    assert aug_ops.launches == 0
    with pytest.raises(ValueError, match="int64 0-dim"):
        aug_ops.crop_flip_draws(torch.tensor([4]), 8, 3)


# -- the augmented Trainer against the JAX package's ---------------------------

_NET = ["--data.dataset=synthetic", "--data.synthetic_train_size=24",
        "--data.synthetic_test_size=8", "--train.epochs=1",
        "--train.eval_at_end=false", "--data.augment=true"]
_R18 = ["--preset=resnet18_cifar10", "--data.dataset=synthetic",
        "--data.synthetic_train_size=12", "--data.synthetic_test_size=4",
        "--data.batch_size=4", "--train.epochs=1",
        "--train.eval_at_end=false"]


def _as_processes(world):
    """`ShardedSampler.shard_indices` of one process reordered into the
    global batches ``world`` processes would assemble: step t's batch is
    each process's t-th batch of its ``rank::world`` shard, in rank order
    (`make_array_from_process_local_data`), which is where the augment's
    rows fall in a run of ``world`` ranks."""
    real = ShardedSampler.shard_indices

    def shard_indices(self):
        idx = real(self)
        b = self._rank_batch
        shards = [idx[r::world] for r in range(world)]
        return np.concatenate([s[t * b:(t + 1) * b] for t in range(
            len(shards[0]) // b) for s in shards])

    return shard_indices


def _jax_run(tmp, args, num_filters=None, world=1, monkeypatch=None):
    """The JAX package's `Trainer` on ``args`` (one device, streamed):
    its per-update losses, final flat state and its init saved for the
    port to resume from (meta epoch -1: a resume starts at epoch 0). With
    ``world`` > 1 its global batches are laid out as ``world`` processes
    would lay them out (`_as_processes`)."""
    cfg = jax_config.parse_cli(args + [
        "--data.device_resident=off", f"--train.ckpt_dir={tmp / 'run'}",
        "--resilience.handle_signals=false"])
    real_build = jax_trainer_mod.build_model
    if num_filters is not None:
        jax_trainer_mod.build_model = functools.partial(
            real_build, num_filters=num_filters)
    try:
        trainer = jax_trainer_mod.Trainer(
            cfg, mesh=jax_dist.data_mesh(num_devices=1))
    finally:
        jax_trainer_mod.build_model = real_build
    if world > 1:
        sampler = trainer.train_pipe.sampler
        sampler._rank_batch = cfg.data.batch_size // world
        monkeypatch.setattr(ShardedSampler, "shard_indices",
                            _as_processes(world))
    init = tmp / "init"
    jck.CheckpointManager(init, async_save=False).save(
        trainer.state, {"epoch": -1, "config": cfg.to_dict(), "seed": 0})
    losses = []
    real = trainer.train_step

    def step(state, item, *a):
        state, m = real(state, item, *a)
        losses.append(float(m["loss"]))
        return state, m

    trainer.train_step = step
    trainer.fit()
    from flax import serialization as fser

    final = dict(_walk_state_dict(fser.to_state_dict(
        jck._to_host(trainer.state))))
    return losses, init, final


def _close(port: dict, jax_state: dict, tol=1e-4,
           collections=("params/", "opt_state/", "batch_stats/")) -> None:
    keys = [k for k in jax_state if k.startswith(collections)]
    assert keys and all(k in port for k in keys)
    worst = max(float(np.abs(port[k] - jax_state[k]).max()) for k in keys)
    assert worst <= tol, worst


@pytest.mark.parametrize("world,accum", [(1, 1), (2, 1), (1, 2)])
def test_augmented_net_trainer_tracks_the_jax_trainer(tmp_path, monkeypatch,
                                                     world, accum):
    with monkeypatch.context() as m:
        losses, init, final = _jax_run(tmp_path / "jax", _NET + [
            f"--optim.grad_accum_steps={accum}",
            f"--data.batch_size={4 // accum}"], world=world, monkeypatch=m)
    ckpt = tmp_path / "ck"
    shutil.copytree(init, ckpt)
    args = _NET + [f"--data.batch_size={4 // world // accum}",
                   f"--optim.grad_accum_steps={accum}", "--resume",
                   f"--train.ckpt_dir={ckpt}"]
    if world == 1:
        out = run_trainer(args)
    else:
        out = run_worker_ranks(tmp_path / "ranks",
                               {"job": "trainer", "args": args}, world)[0]
    assert out["start"] == (0, 0) and len(out["losses"]) == len(losses) == 6
    diffs = [abs(a - b) for a, b in zip(out["losses"], losses)]
    assert max(diffs) <= 1e-4, (out["losses"], losses)
    _close(out["final"], final)


def test_augmented_narrow_resnet18_trainer_tracks_the_jax_trainer(
        tmp_path, monkeypatch):
    losses, init, final = _jax_run(tmp_path / "jax", _R18, num_filters=8)
    ckpt = tmp_path / "ck"
    shutil.copytree(init, ckpt)
    monkeypatch.setattr(trainer_mod, "build_model", functools.partial(
        trainer_mod.build_model, num_filters=8))
    out = run_trainer(_R18 + ["--resume", f"--train.ckpt_dir={ckpt}"])
    assert len(out["losses"]) == len(losses) == 3
    diffs = [abs(a - b) for a, b in zip(out["losses"], losses)]
    assert max(diffs) <= 1e-4, (out["losses"], losses)
    _close(out["final"], final)


# -- the kernel on a card ------------------------------------------------------


@pytest.mark.card
def test_kernel_draws_equal_the_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    step = torch.zeros((), dtype=torch.int64, device="cuda")
    for s in range(0, 100, 7):
        step.fill_(s)
        for row0, accum, micro in ((0, 1, 0), (128, 1, 0), (128, 2, 1)):
            got = aug_ops.crop_flip_draws(step, 128, 3, row0, 512, accum,
                                          micro)
            want = aug.crop_flip_draws(step * accum + micro, 128, 3, row0,
                                       512)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(stream):
        aug_ops.crop_flip_draws(step, 128, 3)  # warm-up: loads the kernel
        with torch.cuda.graph(graph, stream=stream):
            out = aug_ops.crop_flip_draws(step, 128, 3)
    for s in (1, 2, 3):
        step.fill_(s)
        graph.replay()
        want = aug.crop_flip_draws(step, 128, 3)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
