"""Data-parallel training in the port: process groups, sync-BN on the conv
kernel's moments and on the plain path, DDP's gradient mean, sharded feeds
and global metrics, on the CPU with gloo.

The ranks run as subprocesses of `torch_ddp_worker.py` (it imports the port
only; this process holds JAX), meeting through a ``file://`` rendezvous in
``tmp_path``, every one under its own timeout. Narrow widths: ResNet-18 at
``num_filters=8``, B=4 per rank, 2 ranks, 3 SGD updates (momentum 0.9,
weight decay 5e-4, cosine with one warmup step), augmentation off.
Tolerances:

- against the JAX package's GSPMD step on a 2-device CPU mesh, same
  converted weights and global batch: per-step loss within 1e-3 unfused
  and 0.05 fused with the xent kernel (tests/test_torch_train_step.py's
  bounds: f32 summed in other orders; each fused conv rounds through
  bf16);
- against one port process on the concatenated batch (f32, unfused):
  loss and running statistics within 1e-5, parameters after 3 updates
  within 1e-4 · max|p| (the same f32 math, summed in other orders);
- across the ranks: parameters and buffers bit-identical.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from torch_port_util import jax_resnet18_variables
from tpu_dp.data.cifar import make_synthetic
from tpu_dp.data.sampler import ShardedSampler as JaxSampler
from tpu_dp.models import build_model as jax_build
from tpu_dp.parallel import dist as jax_dist
from tpu_dp.train import SGD as JaxSGD
from tpu_dp.train import make_schedule as jax_schedule
from tpu_dp.train import make_train_step as jax_train_step
from tpu_dp.train.state import TrainState as JaxState
from tpu_dp_torch.compat import load_jax_variables
from tpu_dp_torch.config import NotPortedError, parse_cli
from tpu_dp_torch.data.cifar import ArrayDataset
from tpu_dp_torch.data.pipeline import DataPipeline
from tpu_dp_torch.models import build_model
from tpu_dp_torch.parallel import collectives
from tpu_dp_torch.parallel import dist as tdist
from tpu_dp_torch.train.optim import make_sgd
from tpu_dp_torch.train.schedule import make_schedule
from tpu_dp_torch.train.step import TrainState, make_train_step

pytestmark = pytest.mark.port

# The suite runs several pytest workers on one machine: keep each worker's
# PyTorch CPU pool small so the port's tests do not starve the others.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_ddp_worker.py"
SCHED = ("cosine", 0.1, 10, 1, 0.0)  # name, lr, total, warmup, final
STEPS, B, WORLD, FILTERS = 3, 4, 2, 8


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def variables():
    return jax_resnet18_variables(num_filters=FILTERS, seed=6)


@pytest.fixture(scope="module")
def global_batches():
    ds = make_synthetic(STEPS * WORLD * B, 10, seed=8)
    n = WORLD * B
    return (ds.images.reshape(STEPS, n, 32, 32, 3),
            ds.labels.reshape(STEPS, n))


def _run_ranks(tmp_path, variables, batches, fused, mutate=False,
               world=WORLD):
    """Train ``world`` gloo ranks on ``batches``; returns each rank's
    output (see torch_ddp_worker.py)."""
    var_path, data_path = tmp_path / "vars.pkl", tmp_path / "batches.npz"
    with open(var_path, "wb") as f:
        pickle.dump(variables, f)
    np.savez(data_path, images=batches[0], labels=batches[1])
    procs, outs = [], []
    for rank in range(world):
        spec = {"rank": rank, "world": world,
                "init": f"file://{tmp_path / 'rendezvous'}",
                "variables": str(var_path), "batches": str(data_path),
                "fused": fused, "mutate": mutate, "schedule": SCHED,
                "num_filters": FILTERS,
                "out": str(tmp_path / f"rank{rank}.pkl")}
        path = tmp_path / f"spec{rank}.json"
        path.write_text(json.dumps(spec))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(path)], cwd=ROOT, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        for rank, p in enumerate(procs):
            log, _ = p.communicate(timeout=240)
            assert p.returncode == 0, f"rank {rank}:\n{log}"
            with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
                outs.append(pickle.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return outs


def _single_run(variables, batches, fused=False):
    """One port process on the concatenated (global) batches."""
    kw = dict(fused_stages=(0, 1, 2, 3), fused_bwd=True) if fused else {}
    model = load_jax_variables(
        build_model("resnet18", num_filters=FILTERS, **kw), variables)
    opt = make_sgd(model, momentum=0.9, weight_decay=5e-4)
    step = make_train_step(model, opt, make_schedule(*SCHED),
                           use_pallas_xent=fused, device="cpu")
    state = TrainState(step=0, model=model, optimizer=opt)
    losses = [float(step(state, {"image": torch.from_numpy(i),
                                 "label": torch.from_numpy(lab).long()})
                    ["loss"]) for i, lab in zip(*batches)]
    return losses, {k: v.detach().numpy()
                    for k, v in model.state_dict().items()}


def _jax_run(variables, batches, fused):
    """`tpu_dp.train.make_train_step` on a 2-device CPU mesh, the global
    batch sharded over ``data``."""
    mesh = jax_dist.data_mesh(devices=jax.devices()[:WORLD])
    kw = dict(fused_stages=(0, 1, 2, 3), fused_bwd=True) if fused else {}
    model = jax_build("resnet18", num_filters=FILTERS, **kw)
    opt = JaxSGD(momentum=0.9, weight_decay=5e-4)
    params = jax.tree_util.tree_map(jax.numpy.asarray, variables["params"])
    state = JaxState(step=jax.numpy.zeros((), jax.numpy.int32),
                     params=params, opt_state=opt.init(params),
                     batch_stats=jax.tree_util.tree_map(
                         jax.numpy.asarray, variables["batch_stats"]))
    step = jax_train_step(model, opt, mesh, jax_schedule(*SCHED),
                          use_pallas_xent=fused)
    out = []
    for images, labels in zip(*batches):
        state, m = step(state, {"image": images, "label": labels})
        out.append((float(m["loss"]), int(m["correct"]), int(m["count"])))
    return out


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory, variables, global_batches):
    """``rank_runs(fused, mutate=False)``: the 2-rank run's outputs, made
    once per module for each setting."""
    done = {}

    def get(fused, mutate=False):
        if (fused, mutate) not in done:
            done[fused, mutate] = _run_ranks(
                tmp_path_factory.mktemp("ranks"), variables, global_batches,
                fused, mutate)
        return done[fused, mutate]
    return get


@pytest.mark.parametrize("fused", [False, True])
def test_two_ranks_track_the_jax_mesh_step(rank_runs, variables,
                                           global_batches, fused):
    ref = _jax_run(variables, global_batches, fused)
    ranks = rank_runs(fused)
    tol = 0.05 if fused else 1e-3
    for out in ranks:
        got = out["metrics"]
        for k, ((gl, gc, gn, _), (rl, rc, rn)) in enumerate(zip(got, ref)):
            assert abs(gl - rl) <= tol, (k, gl, rl)
            assert gn == rn == WORLD * B
            if not fused:
                assert gc == rc, (k, gc, rc)
        assert out["all_params_have_grads"]
        # Per step: one sync-BN all-reduce per BatchNorm each way (20 in
        # ResNet-18), one metrics all-reduce, at least one DDP bucket.
        for books in out["books"]:
            assert books["pmean_forward"] == books["pmean_backward"] == 20
            assert books["psum"] == 1 and books["ddp_buckets"] >= 1
    # The loss falls once the model has taken a real step.
    assert ranks[0]["metrics"][-1][0] < ranks[0]["metrics"][0][0]


@pytest.fixture(scope="module")
def single(variables, global_batches):
    """One process on the concatenated batch (f32, unfused)."""
    return _single_run(variables, global_batches)


def _concat_mismatch(out, single):
    """What separates a rank's run from the concatenated-batch run, as
    ``{name: (error, tolerance)}`` over the loss, running stats and
    parameters."""
    losses, state = single
    got = [m[0] for m in out["metrics"]]
    res = {"loss": (max(abs(a - b) for a, b in zip(got, losses)), 1e-5)}
    for k, ref in state.items():
        err = float(np.max(np.abs(out["state"][k] - ref)))
        if k.endswith(("running_mean", "running_var")):
            res[k] = (err, 1e-5)
        else:
            res[k] = (err, 1e-4 * float(np.max(np.abs(ref))))
    return res


def test_two_ranks_equal_the_concatenated_batch(rank_runs, single):
    for out in rank_runs(False):
        bad = {k: v for k, v in _concat_mismatch(out, single).items()
               if not v[0] <= v[1]}
        assert bad == {}


def test_ranks_hold_bit_identical_state(rank_runs):
    for a, b in (rank_runs(False), rank_runs(True)):
        assert a["state"].keys() == b["state"].keys()
        for k in a["state"]:
            np.testing.assert_array_equal(a["state"][k], b["state"][k],
                                          err_msg=k)
        assert a["metrics"] == b["metrics"]


def test_missing_backward_reduce_is_caught(rank_runs, single):
    # The parity check of test_two_ranks_equal_the_concatenated_batch sees
    # the factor error: without the cotangent's cross-rank mean the
    # parameters leave its tolerance.
    mutant = rank_runs(False, mutate=True)
    bad = {k: v for k, v in _concat_mismatch(mutant[0], single).items()
           if not v[0] <= v[1]}
    assert any(not k.startswith("loss") for k in bad), bad
    # The forward (and so step 1's loss, before any update) is unchanged.
    assert mutant[0]["metrics"][0] == rank_runs(False)[0]["metrics"][0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _trainer_cli(args, nproc, timeout=300):
    env = _env()
    env["OMP_NUM_THREADS"] = "1"
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={nproc}"] if nproc else [sys.executable])
    out = subprocess.run(launch + ["-m", "tpu_dp_torch.train", *args],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out


def test_torchrun_two_ranks_match_world_one_at_twice_the_batch():
    b, test_size = 4, 21  # 21 divides by neither 2 nor 2b
    common = ["--device", "cpu", "--preset=resnet18_cifar10",
              "--model.fused_stages=all", "--model.fused_bwd=true",
              "--train.pallas_xent=true", "--data.dataset=synthetic",
              "--data.augment=false", "--data.synthetic_train_size=16",
              f"--data.synthetic_test_size={test_size}", "--train.epochs=1",
              "--train.log_every=1"]
    two = _trainer_cli(common + [f"--data.batch_size={b}"], nproc=2)
    one = _trainer_cli(common + [f"--data.batch_size={2 * b}"], nproc=0)

    def parse(out):
        lines = out.stdout.strip().splitlines()
        losses = [float(ln.rpartition(":")[2]) for ln in lines
                  if ln.startswith("[1, ")]
        return losses, json.loads(lines[-1]), lines
    l2, s2, lines2 = parse(two)
    l1, s1, _ = parse(one)
    # Rank 0 alone prints: one line per step, one summary.
    assert len(l2) == len(l1) == 2
    assert sum(ln.startswith("Finished Training") for ln in lines2) == 1
    # Within 1e-3, plus the print's rounding to 3 decimals (5e-4 each).
    assert all(abs(a - c) <= 1e-3 + 1e-3 for a, c in zip(l2, l1)), (l2, l1)
    assert abs(s2["final_train_loss"] - s1["final_train_loss"]) <= 1e-3
    assert (s2["world"], s2["backend"], s2["devices"]) == (2, "gloo", 2)
    assert (s1["world"], s1["backend"]) == (1, None)
    assert s2["eval"]["count"] == s1["eval"]["count"] == test_size
    assert s2["eval"]["accuracy"] == s1["eval"]["accuracy"]
    assert abs(s2["eval"]["loss"] - s1["eval"]["loss"]) <= 1e-3


def test_initialize_reads_the_env_contract(monkeypatch):
    port = _free_port()
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port))):
        monkeypatch.setenv(k, v)
    try:
        ctx = tdist.initialize(device="cpu", timeout_s=60)
        assert (ctx.rank, ctx.world, ctx.local_rank, ctx.backend,
                ctx.device) == (0, 1, 0, "gloo", torch.device("cpu"))
        assert tdist.initialize() is ctx  # one group per process
        assert (tdist.process_index(), tdist.process_count()) == (0, 1)
        assert ctx.process_group is None  # world 1: no reduction
        tdist.barrier()
        head = tdist.describe()
        assert (head["rank"], head["world"], head["backend"]) == (
            0, 1, "gloo")
    finally:
        tdist.shutdown()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("env,kwargs,match", [
    ({"WORLD_SIZE": "2", "RANK": "2"}, {}, "out of range"),
    ({"WORLD_SIZE": "2", "RANK": "-1"}, {}, "out of range"),
    ({"WORLD_SIZE": "0", "RANK": "0"}, {}, ">= 1"),
    ({"WORLD_SIZE": "two", "RANK": "0"}, {}, "not an integer"),
    ({"WORLD_SIZE": "2"}, {}, "needs a rank"),
    ({"WORLD_SIZE": "2", "RANK": "1"}, {}, "MASTER_ADDR"),
    ({}, {"world_size": 3, "rank": 3}, "out of range"),
    ({"WORLD_SIZE": "2", "RANK": "5"}, {"rank": 1, "world_size": 1},
     "out of range"),
])
def test_initialize_rejects_a_bad_contract(monkeypatch, env, kwargs, match):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(tdist.DistConfigError, match=match):
        tdist.initialize(device="cpu", **kwargs)
    assert not torch.distributed.is_initialized()


def test_initialize_alone_and_without_a_card(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    ctx = tdist.initialize(device="cpu")
    assert (ctx.world, ctx.backend, ctx.process_group) == (1, None, None)
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.initialize()
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.initialize(init_method="file:///nonexistent/x")


def test_rendezvous_timeout_names_the_address(tmp_path):
    # A world of 2 where rank 1 never comes: a typed error within the
    # bounded timeout, naming the address and the rank.
    code = (
        "import sys\n"
        "from tpu_dp_torch.parallel import dist\n"
        "try:\n"
        f"    dist.initialize(init_method={str(f'file://{tmp_path}/rv')!r},"
        " world_size=2, rank=0, device='cpu', timeout_s=3)\n"
        "except dist.DistInitError as e:\n"
        "    print('ERR', e); sys.exit(0)\n"
        "sys.exit(1)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "rank 0 of 2" in out.stdout and str(tmp_path) in out.stdout


def test_parallel_overrides_parse_and_refuse_devices():
    cfg = parse_cli(["--preset=resnet18_cifar10",
                     "--parallel.coordinator_address=10.0.0.1:1234",
                     "--parallel.num_processes=4", "--parallel.process_id=3",
                     "--parallel.num_devices=1"])
    assert (cfg.parallel.coordinator_address, cfg.parallel.num_processes,
            cfg.parallel.process_id, cfg.parallel.num_devices) == (
        "10.0.0.1:1234", 4, 3, 1)
    with pytest.raises(NotPortedError, match="one tpu_dp_torch process"):
        parse_cli(["--preset=resnet18_cifar10", "--parallel.num_devices=2"])
    with pytest.raises(ValueError, match="no field"):
        parse_cli(["--parallel.bogus=1"])


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("n,batch,shuffle", [(50, 4, True), (7, 2, False),
                                             (64, 8, True)])
def test_pipeline_shards_equal_jax_sampler(world, n, batch, shuffle):
    ds = ArrayDataset(np.zeros((n, 32, 32, 3), np.uint8),
                      np.arange(n, dtype=np.int32), "t", 10)
    seen = []
    for rank in range(world):
        pipe = DataPipeline(ds, batch, "cpu", shuffle=shuffle, seed=5,
                            drop_remainder=False, prefetch=0,
                            num_shards=world, shard_id=rank)
        theirs = JaxSampler(n, world, rank, shuffle, seed=5)
        for epoch in (0, 3):
            pipe.set_epoch(epoch)
            theirs.set_epoch(epoch)
            want = theirs.shard_indices()
            takes = list(pipe._host_batches())
            assert len(takes) == -(-len(want) // batch)
            got = np.concatenate([t for t, _ in takes])[:len(want)]
            np.testing.assert_array_equal(got, want)
            if epoch == 0:
                w = np.concatenate([np.ones(batch, np.float32)
                                    if wt is None else wt
                                    for _, wt in takes])
                seen.extend(np.concatenate([t for t, _ in takes])[w > 0])
    # Weighted, the ranks' eval batches hold every example exactly once.
    assert sorted(seen) == list(range(n))


def test_collectives_are_the_identity_without_a_group():
    x = torch.arange(6.0, requires_grad=True)
    assert collectives.pmean(x) is x and collectives.psum(x) is x
    xs = [torch.ones(2), torch.zeros(3)]
    assert collectives.pmean(xs) is xs
    assert collectives.world_of(None) == 1
    with pytest.raises(TypeError, match="one dtype"):
        collectives._flat([torch.ones(2), torch.ones(2, dtype=torch.int64)])
