"""Checkpoints, resume and the eval count of the port against the JAX
package, on the CPU.

- A save written by either package loads in the other: the JAX package
  trains a ``num_filters=8`` ResNet-18 (and a `Net`) for 2 steps and
  saves with `tpu_dp.checkpoint.CheckpointManager`, the port restores it;
  the port does the same the other way, and the JAX package's verified
  `load_checkpoint`, `load_params_only` and `resume_latest` accept it.
  Parameters, momentum and statistics are bit-exact; eval logits agree
  within tests/test_torch_resnet.py's bounds (1e-4 · max|logits| unfused
  f32, 1e-2 fused: each fused conv rounds through bf16).
- Torn, bit-rotted and unknown-schema saves are refused with the typed
  errors, and resume falls back to the older save.
- A resume (epoch boundary, and a snapshot-kind save mid-epoch) gives
  per-step losses, final state and eval bit-identical to the uninterrupted
  run, at world 1 and on 2 gloo ranks (`torch_ddp_worker.py` subprocesses
  meeting through a ``file://`` rendezvous, each under a timeout).
- The eval count is the JAX package's: at world 1, 2 and 3 the port's
  ``evaluate()`` gives the ``count``, ``correct`` and loss that
  `tpu_dp.data`'s sampler and pipeline weights give for the same shards.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

import tpu_dp.config as jax_config
from torch_ddp_worker import run_evals, run_trainer
from torch_port_util import ROOT, jax_resnet18_variables, run_worker_ranks
from tpu_dp import checkpoint as jck
from tpu_dp.data.cifar import ArrayDataset as JaxArrayDataset
from tpu_dp.data.pipeline import DataPipeline as JaxPipeline
from tpu_dp.data.sampler import ShardedSampler as JaxSampler
from tpu_dp.models import build_model as jax_build
from tpu_dp.parallel import dist as jax_dist
from tpu_dp.resilience import resume_latest as jax_resume_latest
from tpu_dp.train import SGD as JaxSGD
from tpu_dp.train import make_schedule as jax_schedule
from tpu_dp.train import make_train_step as jax_train_step
from tpu_dp.train.state import TrainState as JaxState
from tpu_dp_torch import checkpoint as ck
from tpu_dp_torch.config import Config, NotPortedError, parse_cli
from tpu_dp_torch.data.cifar import load_dataset, normalize
from tpu_dp_torch.models import build_model
from tpu_dp_torch.obs.counters import counters
from tpu_dp_torch.resilience import find_candidates, resume_latest
from tpu_dp_torch.serve import InferenceEngine
from tpu_dp_torch.train.optim import make_sgd
from tpu_dp_torch.train.schedule import make_schedule
from tpu_dp_torch.train.step import TrainState, make_train_step

pytestmark = pytest.mark.port

torch.set_num_threads(2)

SCHED = ("constant", 0.05, 10, 0, 0.0)  # name, lr, total, warmup, final
FUSED = dict(fused_stages=(0, 1, 2, 3), fused_bwd=True)


@pytest.fixture(autouse=True)
def _no_default_checkpoints_dir():
    # Every save here goes to tmp_path: the default ./checkpoints of the
    # repo root must never appear.
    existed = (ROOT / "checkpoints").exists()
    yield
    assert existed or not (ROOT / "checkpoints").exists()


def _images(n=6, seed=2):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _labels(n=6, seed=2):
    return np.random.default_rng(seed + 1).integers(0, 10, n).astype(
        np.int32)


def _leaves(tree) -> dict:
    return dict(ck._walk_state_dict(tree))


def _assert_trees_equal(a, b):
    a, b = _leaves(a), _leaves(b)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _jax_state(name):
    if name == "net":
        model = jax_build("net")
        variables = model.init(jax.random.PRNGKey(1),
                               np.zeros((1, 32, 32, 3), np.float32))
        variables = {"params": variables["params"], "batch_stats": {}}
    else:
        model = jax_build("resnet18", num_filters=8)
        variables = jax_resnet18_variables(num_filters=8, seed=3)
    opt = JaxSGD(momentum=0.9, weight_decay=5e-4)
    params = jax.tree_util.tree_map(jax.numpy.asarray, variables["params"])
    return model, opt, JaxState(
        step=jax.numpy.zeros((), jax.numpy.int32), params=params,
        opt_state=opt.init(params),
        batch_stats=jax.tree_util.tree_map(jax.numpy.asarray,
                                           variables["batch_stats"]))


def _jax_logits(model, state, images):
    variables = {"params": state.params}
    if state.batch_stats:
        variables["batch_stats"] = state.batch_stats
    return np.asarray(model.apply(variables, normalize(images), train=False),
                      np.float32)


def _port_model(name, fused=False):
    if name == "net":
        return build_model("net")
    return build_model("resnet18", num_filters=8, **(FUSED if fused else {}))


def _port_logits(model, images):
    model.eval()
    with torch.no_grad():
        return model(normalize(torch.from_numpy(images))).numpy()


@pytest.fixture(scope="module", params=["resnet18", "net"])
def jax_saved(request, tmp_path_factory):
    """The JAX package trains ``param`` for 2 steps and saves it."""
    name = request.param
    model, opt, state = _jax_state(name)
    step = jax_train_step(model, opt, jax_dist.data_mesh(num_devices=1),
                          jax_schedule(*SCHED))
    for k in range(2):
        state, _ = step(state, {"image": _images(seed=k),
                                "label": _labels(seed=k)})
    root = tmp_path_factory.mktemp(f"jax_{name}")
    cfg = jax_config.Config()
    cfg.model.name = name
    jck.CheckpointManager(root, async_save=False).save(
        state, {"epoch": 0, "config": cfg.to_dict(), "seed": 0})
    return name, model, state, root


@pytest.mark.parametrize("fused", [False, True])
def test_jax_checkpoint_loads_into_the_port(jax_saved, fused):
    name, jmodel, jstate, root = jax_saved
    if fused and name == "net":
        pytest.skip("Net has no fused path")
    model = _port_model(name, fused)
    target = TrainState(step=0, model=model,
                        optimizer=make_sgd(model, 0.9, 5e-4))
    _, meta = ck.CheckpointManager(root).restore(target)
    assert target.step == 2 and meta["epoch"] == 0
    host = jax.tree_util.tree_map(np.asarray, jstate)
    got = ck.state_dict_of(target)
    for key in ("params", "opt_state", "batch_stats"):
        _assert_trees_equal(got[key], getattr(host, key))
    images = _images(8, seed=9)
    ref = _jax_logits(jmodel, jstate, images)
    bound = 1e-2 if fused else 1e-4
    np.testing.assert_allclose(_port_logits(model, images), ref, rtol=0,
                               atol=bound * float(np.abs(ref).max()))


@pytest.mark.parametrize("name", ["resnet18", "net"])
def test_port_checkpoint_loads_into_jax(tmp_path, name):
    model = _port_model(name)
    if name == "resnet18":
        from tpu_dp_torch.compat import load_jax_variables

        load_jax_variables(model, jax_resnet18_variables(num_filters=8,
                                                         seed=4))
    opt = make_sgd(model, 0.9, 5e-4)
    state = TrainState(step=0, model=model, optimizer=opt)
    step = make_train_step(model, opt, make_schedule(*SCHED), device="cpu")
    for k in range(2):
        step(state, {"image": torch.from_numpy(_images(seed=k)),
                     "label": torch.from_numpy(_labels(seed=k)).long()})
    mgr = ck.CheckpointManager(tmp_path, async_save=True)
    mgr.save(state, {"epoch": 0, "config": Config().to_dict(), "seed": 0})
    mgr.wait()
    saved = ck.state_dict_of(state)
    jmodel, _, target = _jax_state(name)
    step_dir = tmp_path / "step_0000000002"
    loaded, meta = jck.load_checkpoint(step_dir, target, verify=True)
    assert int(loaded.step) == 2 and meta["epoch"] == 0
    host = jax.tree_util.tree_map(np.asarray, loaded)
    for key in ("params", "opt_state", "batch_stats"):
        _assert_trees_equal(getattr(host, key), saved[key])
    params, stats, _ = jck.load_params_only(step_dir, target.params,
                                            target.batch_stats)
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, params),
                        saved["params"])
    resumed, _, source = jax_resume_latest(target, tmp_path)
    assert source == step_dir and int(resumed.step) == 2
    images = _images(8, seed=9)
    ref = _jax_logits(jmodel, loaded, images)
    np.testing.assert_allclose(_port_logits(model, images), ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))
    # The JAX package's --config reads the port's meta.
    jcfg = jax_config.parse_cli([f"--config={step_dir / 'meta.json'}",
                                 f"--train.ckpt_dir={tmp_path / 'new'}"])
    assert jcfg.model.name == "net" and jcfg.train.ckpt_keep == 3


def test_serve_from_a_jax_checkpoint(jax_saved):
    name, jmodel, jstate, root = jax_saved
    if name != "net":
        pytest.skip("the meta's resnet18 is full width; Net is served")
    engine = InferenceEngine.from_checkpoint(root, device="cpu",
                                             buckets=(1, 2, 4, 8),
                                             slo_ms=60_000.0)
    images = _images(8, seed=9)
    engine.start()
    try:
        handles = [engine.submit(images[i:i + 2]) for i in range(0, 8, 2)]
        assert all(h.wait(60) and h.ok for h in handles)
    finally:
        engine.stop()
    preds = np.concatenate([h.predictions for h in handles])
    np.testing.assert_array_equal(
        preds, _jax_logits(jmodel, jstate, images).argmax(-1))
    from tpu_dp_torch.serve.__main__ import main

    assert main(["--device", "cpu", "--ckpt", str(root), "--requests",
                 "6", "--slo-ms", "60000"]) == 0


# -- refusals, fallbacks and the manager ---------------------------------


def _net_saves(root, steps=(10, 20)):
    model = build_model("net")
    state = TrainState(step=0, model=model, optimizer=make_sgd(model, 0.9))
    mgr = ck.CheckpointManager(root, keep=0, async_save=False)
    for n in steps:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01)
        state.step = n
        mgr.save(state, {"epoch": n // 10 - 1})
    return state


def _flip_leaf_byte(step_dir, leaf_path):
    payload = bytearray((step_dir / "state.msgpack").read_bytes())
    leaf = _leaves(ck.read_checkpoint(step_dir)[0])[leaf_path]
    at = bytes(payload).find(np.ascontiguousarray(leaf).tobytes())
    assert at > 0
    payload[at + 5] ^= 0x40
    (step_dir / "state.msgpack").write_bytes(bytes(payload))


def _target():
    model = build_model("net")
    return TrainState(step=0, model=model, optimizer=make_sgd(model, 0.9))


def test_bit_rot_is_refused_naming_the_leaf_and_resume_falls_back(tmp_path):
    _net_saves(tmp_path)
    newest = tmp_path / "step_0000000020"
    _flip_leaf_byte(newest, "params/fc1/kernel")
    with pytest.raises(ck.CorruptCheckpointError) as e:
        ck.load_checkpoint(newest, _target())
    assert e.value.leaves == ("params/fc1/kernel",)
    assert e.value.path == str(newest)
    # The JAX package's verification names the same leaf: the per-leaf
    # hashes agree across the packages.
    _, _, jtarget = _jax_state("net")
    with pytest.raises(jck.CorruptCheckpointError) as je:
        jck.load_checkpoint(newest, jtarget)
    assert je.value.leaves == ("params/fc1/kernel",)
    target = _target()
    _, meta, source = resume_latest(target, tmp_path)
    assert source == tmp_path / "step_0000000010" and target.step == 10
    assert (newest / ck.QUARANTINED_MARKER).exists()
    assert [d for d, _ in find_candidates(tmp_path)] == [source]


def test_torn_saves_are_refused(tmp_path):
    _net_saves(tmp_path, steps=(10, 20, 30))
    (tmp_path / "step_0000000030" / "meta.json").unlink()
    payload = tmp_path / "step_0000000020" / "state.msgpack"
    payload.write_bytes(payload.read_bytes()[:-100])
    with pytest.raises(ck.CorruptCheckpointError, match="torn"):
        ck.load_checkpoint(tmp_path / "step_0000000020", _target())
    assert [s for _, s in find_candidates(tmp_path)] == [20, 10]
    target = _target()
    _, _, source = resume_latest(target, tmp_path)
    assert source.name == "step_0000000010" and target.step == 10
    # Nothing usable at all: a RuntimeError, not a fresh start in disguise.
    (tmp_path / "step_0000000010" / "state.msgpack").write_bytes(b"\x00")
    with pytest.raises(RuntimeError, match="unreadable"):
        resume_latest(_target(), tmp_path)
    with pytest.raises(FileNotFoundError):
        resume_latest(_target(), tmp_path / "empty")


def test_unknown_schema_is_refused_and_schema_1_loads_unverified(tmp_path):
    _net_saves(tmp_path, steps=(10,))
    step_dir = tmp_path / "step_0000000010"
    meta_path = step_dir / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps(dict(meta, schema=99)))
    with pytest.raises(ck.CheckpointSchemaError):
        ck.load_checkpoint(step_dir, _target())
    with pytest.raises(ck.CheckpointSchemaError):
        ck.read_meta(step_dir)
    old = {k: v for k, v in meta.items() if k not in ("schema", "integrity")}
    meta_path.write_text(json.dumps(old))
    before = counters.get("ckpt.unverified_loads")
    target = _target()
    ck.load_checkpoint(step_dir, target)
    assert target.step == 10
    assert counters.get("ckpt.unverified_loads") == before + 1


def test_manager_keeps_prunes_and_publishes_complete_saves(tmp_path):
    _net_saves(tmp_path / "all", steps=(1, 2, 3, 4))
    assert len(ck.CheckpointManager(tmp_path / "all").step_dirs()) == 4
    state = _target()
    # The flat layout: one save dir, written and loaded directly.
    flat = tmp_path / "flat"
    assert ck.save_checkpoint(flat, state, {"epoch": 7}) == (
        flat / "state.msgpack")
    assert ck.load_checkpoint(flat, _target())[1]["epoch"] == 7
    assert [d for d, _ in find_candidates(flat)] == [flat]
    mgr = ck.CheckpointManager(tmp_path / "two", keep=2, async_save=True)
    for n in (1, 2, 3, 4):
        state.step = n
        mgr.save(state, {"epoch": n})
    mgr.wait()
    assert [d.name for d in mgr.step_dirs()] == ["step_0000000003",
                                                 "step_0000000004"]
    assert (tmp_path / "two" / "latest").read_text() == "step_0000000004"
    assert set(mgr.last_save) == {"wait_ms", "snapshot_ms", "blocking_ms",
                                  "write_ms", "payload_bytes"}
    assert ck.missing_save_files(mgr.latest_dir()) == []
    # A pointer naming a torn dir is not trusted.
    (mgr.latest_dir() / "meta.json").unlink()
    assert mgr.latest_dir().name == "step_0000000003"
    assert [d.name for d in mgr.complete_dirs()] == ["step_0000000003"]


def test_async_write_error_surfaces_at_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = ck.CheckpointManager(blocker / "ck", async_save=True)
    assert mgr.save(_target(), {}) is not None
    with pytest.raises(RuntimeError, match="async checkpoint write") as e:
        mgr.wait()
    assert isinstance(e.value.__cause__, OSError)
    mgr.wait()  # reported once


def test_config_dicts_load_in_both_packages(tmp_path):
    args = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
            "--train.ckpt_keep=5"]
    port = parse_cli(args)
    assert jax_config.Config.from_dict(
        json.loads(json.dumps(port.to_dict()))) == jax_config.parse_cli(args)
    jmeta = tmp_path / "meta.json"
    jmeta.write_text(json.dumps({"epoch": 3, "config":
                                 jax_config.parse_cli(args).to_dict()}))
    with pytest.raises(ValueError, match="ckpt_dir"):
        parse_cli([f"--config={jmeta}"])
    assert parse_cli([f"--config={jmeta}", "--resume"]) == parse_cli(
        args + ["--resume"])
    bad = jax_config.parse_cli(args + ["--guard.enabled=true"]).to_dict()
    jmeta.write_text(json.dumps({"config": bad}))
    with pytest.raises(NotPortedError, match="guard.enabled"):
        parse_cli([f"--config={jmeta}", "--train.ckpt_dir=x"])
    with pytest.raises(ValueError, match="auto"):
        parse_cli(["--resume=never"])


# -- ranks and resume ------------------------------------------------------

_NET = ["--data.dataset=synthetic", "--data.synthetic_train_size=24",
        "--data.synthetic_test_size=10", "--train.epochs=3",
        "--train.log_every=100"]
_RESNET = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
           "--model.fused_bwd=true", "--train.pallas_xent=true",
           "--data.dataset=synthetic", "--data.synthetic_train_size=8",
           "--data.synthetic_test_size=4", "--data.batch_size=4",
           "--train.epochs=3"]


def test_only_rank_zero_writes(tmp_path):
    ck0, ck1 = tmp_path / "r0", tmp_path / "r1"
    spec = {"job": "trainer", "args": _NET + [
        "--train.epochs=1", "--data.batch_size=2", f"--train.ckpt_dir={ck0}"],
        "rank_args": {"1": [f"--train.ckpt_dir={ck1}"]}}
    outs = run_worker_ranks(tmp_path / "ranks", spec, 2)
    assert not ck1.exists()
    assert (ck0 / "final_params.msgpack").exists()
    raw, meta = ck.read_checkpoint(ck0 / "step_0000000006")
    assert meta["epoch"] == 0 and meta["config"]["model"]["name"] == "net"
    assert set(raw["params"]) == {"conv1", "conv2", "fc1", "fc2", "fc3"}
    assert not any(k.startswith("module") for k in _leaves(raw))
    for k, v in _leaves(raw).items():
        assert np.asarray(v).tobytes() == outs[1]["final"][k].tobytes(), k


def _resume_runs(tmp_path, args, world, stop, snapshot):
    """Uninterrupted, interrupted before global step ``stop`` (with a
    snapshot-kind save there when ``snapshot``), and resumed; each a list
    of the ranks' outputs."""
    def run(name, extra, **kw):
        full = args + [f"--train.ckpt_dir={tmp_path / name}"] + extra
        if world == 1:
            return [run_trainer(full, **kw)]
        spec = {"job": "trainer", "args": full, **kw}
        return run_worker_ranks(tmp_path / f"ranks_{name}_{len(extra)}",
                                spec, world)

    full = run("full", [])
    part = run("part", [], stop_at_step=stop, snapshot=snapshot)
    resumed = run("part", ["--resume"])
    return full, part, resumed


@pytest.mark.parametrize("model,world,kind", [
    ("resnet18", 1, "epoch"), ("net", 1, "snapshot"), ("net", 2, "epoch"),
    ("net", 2, "snapshot")])
def test_resume_is_bit_identical(tmp_path, model, world, kind):
    if model == "resnet18":
        args, spe = _RESNET, 2
    else:
        args, spe = _NET + [f"--data.batch_size={4 // world}"], 6
    _check_resume(tmp_path, args, world, kind, spe)


@pytest.mark.parametrize("world,kind,wire", [
    (1, "epoch", ["--train.collective_dtype=int8",
                  "--train.bucket_mb=0.05"]),
    (2, "snapshot", ["--train.collective_dtype=int8"]),
    (2, "epoch", [])])
def test_sharded_resume_is_bit_identical(tmp_path, world, kind, wire):
    """The sharded update's momentum shards and int8 residuals cross an
    interruption bit for bit (every rank joins the save's gather)."""
    args = _NET + [f"--data.batch_size={4 // world}",
                   "--train.update_sharding=sharded", *wire]
    _check_resume(tmp_path, args, world, kind, 6)


def _check_resume(tmp_path, args, world, kind, spe):
    """Interrupt ``args`` at the start of epoch 3 or 2 steps into epoch 2
    (``kind``), resume, and hold the restored state, the continuation, the
    final state and the eval bit-identical to the uninterrupted run."""
    stop = 2 * spe if kind == "epoch" else spe + 2
    full, part, resumed = _resume_runs(tmp_path, args, world, stop,
                                       kind == "snapshot")
    where = (2, 0) if kind == "epoch" else (1, 2)
    for f, p, r in zip(full, part, resumed):
        assert r["spe"] == spe and r["start"] == where
        assert r["resumed_from"].endswith(f"step_{stop:010d}")
        assert ("snapshots" in r["resumed_from"]) == (kind == "snapshot")
        # The restored state is the interrupted run's, bit for bit
        # (parameters, statistics, momentum, step).
        assert r["restored"].keys() == p["final"].keys()
        for k in p["final"]:
            assert r["restored"][k].tobytes() == p["final"][k].tobytes(), k
        assert int(r["restored"]["step"]) == stop
        # And the continuation is the uninterrupted run's.
        assert r["losses"] == f["losses"][stop:]
        assert p["losses"] == f["losses"][:len(p["losses"])]
        for k in f["final"]:
            assert r["final"][k].tobytes() == f["final"][k].tobytes(), k
        assert r["eval"] == f["eval"]
    # Every rank holds the same state after the broadcast and at the end.
    for r in resumed[1:]:
        for k in resumed[0]["restored"]:
            assert (r["restored"][k].tobytes()
                    == resumed[0]["restored"][k].tobytes()), k
            assert r["final"][k].tobytes() == resumed[0]["final"][k].tobytes()


# -- the eval count --------------------------------------------------------

_EVAL = ["--data.dataset=synthetic", "--data.synthetic_train_size=8",
         "--train.ckpt_dir=unused"]
#: 21: divides by neither 2 nor 4; 3 at world 3: one image a shard, so the
#: final batch's pad (3) exceeds the shard; 22: wraparound duplicates at
#: world 3; 24: no pad at all.
_SIZES = (21, 3, 22, 24)


def _jax_eval(n: int, world: int) -> dict:
    """count, correct and loss the JAX package's sampler and pipeline
    weights give for ``world`` shards of the synthetic test set, with the
    seed-0 `Net` the port's Trainer starts from."""
    ds = load_dataset("synthetic", "./data", train=False,
                      synthetic_num_examples=n, seed=0)
    jds = JaxArrayDataset(ds.images, ds.labels.astype(np.int32), ds.name,
                          ds.num_classes, ds.synthetic)
    model = build_model("net", generator=torch.Generator().manual_seed(0))
    mesh = jax_dist.data_mesh(num_devices=1)
    count = correct = loss_sum = 0.0
    for rank in range(world):
        sampler = JaxSampler(n, num_shards=world, shard_id=rank,
                             shuffle=False)
        pipe = JaxPipeline(jds, 4, mesh, shuffle=False, drop_remainder=False,
                           prefetch=0, sampler=sampler)
        for b in pipe._host_batches():
            w = b.get("weight", np.ones(len(b["label"]), np.float32))
            logits = _port_logits(model, b["image"]).astype(np.float64)
            labels = b["label"].astype(np.int64)
            per = (np.log(np.exp(logits - logits.max(-1, keepdims=True))
                          .sum(-1)) + logits.max(-1)
                   - logits[np.arange(len(labels)), labels])
            count += w.sum()
            correct += (w * (logits.argmax(-1) == labels)).sum()
            loss_sum += (w * per).sum()
    return {"count": int(count), "correct": int(correct),
            "loss": loss_sum / count}


@pytest.mark.parametrize("world", [1, 2, 3])
def test_eval_count_equals_the_jax_packages(tmp_path, world):
    args = _EVAL + ["--data.batch_size=4"]
    if world == 1:
        got = run_evals(args, list(_SIZES))
    else:
        got = run_worker_ranks(tmp_path, {"job": "eval", "args": args,
                                          "sizes": list(_SIZES)}, world)[0]
    for n, ev in zip(_SIZES, got):
        want = _jax_eval(n, world)
        assert ev["count"] == want["count"], (n, ev, want)
        assert round(ev["accuracy"] * ev["count"]) == want["correct"]
        assert abs(ev["loss"] - want["loss"]) <= 1e-6 * want["loss"]
    # Wraparound duplicates count: 21 images at world 2 count 22.
    expect = {1: (21, 3, 22, 24), 2: (22, 4, 22, 24),
              3: (21, 3, 24, 24)}[world]
    assert tuple(ev["count"] for ev in got) == expect
