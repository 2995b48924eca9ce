"""The port's guard against the JAX package's (`tpu_dp_torch/resilience/
guard.py`, the sentinel in `tpu_dp_torch/train/step.py`; mirrors
tests/test_guard.py).

- The policy takes the JAX policy's decisions on the same record streams
  (NaN, cap, spike on either field, the rollback budget and halt, a flat
  window; the armed cap after each window); the quarantine log reads back
  and tombstones as the JAX log does; `sdc_verdict` and `digest_of_sums`
  give the same majority and split results.
- `params_checksum` equals the JAX package's `make_params_checksum` bit for
  bit on converted `Net`, narrow ResNet-18 and ResNet-50 parameters, bf16
  leaves and sign-bit leaves included; `leaf_paths` equals its
  `leaf_paths`.
- The sentinel step (`Net`, one update a call) tracks the JAX sentinel
  step within 1e-4 in loss, parameters, ``loss_raw``, ``grad_norm`` and
  ``applied`` through neutral updates, a cap skip, a NaN and a spike from
  the fault seam and an eased learning rate.
- The bitwise contracts: a guarded run with nothing to catch equals the
  unguarded run bit for bit (`Net` one update a call and windows of 4,
  the fused ResNet-18 in windows of 2); a ``nan:`` fault under
  ``action=skip`` ends on the state of the port's own run that never saw
  the quarantined batches (one update a call; windows of 4, where the
  frozen counter quarantines the rest of the window; the sharded update).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ddp_worker import run_trainer
from torch_port_util import jax_resnet18_variables, jax_resnet50_variables
from tpu_dp.data.cifar import make_synthetic
from tpu_dp.models import build_model as jax_build
from tpu_dp.resilience import guard as jg
from tpu_dp.train import SGD as JaxSGD
from tpu_dp.train import make_schedule as jax_schedule
from tpu_dp.train import make_train_step as jax_train_step
from tpu_dp.train.state import TrainState as JaxState
from tpu_dp_torch.compat import convert_grads, load_jax_variables
from tpu_dp_torch.models import build_model
from tpu_dp_torch.resilience import guard as pg
from tpu_dp_torch.train.optim import make_sgd
from tpu_dp_torch.train.schedule import make_schedule
from tpu_dp_torch.train.step import TrainState, make_train_step

pytestmark = pytest.mark.port

torch.set_num_threads(2)


# -- the policy ---------------------------------------------------------------


def _rec(step, loss, gnorm=2.0, applied=1):
    return {"step": step, "loss": loss, "gnorm": gnorm, "applied": applied}


_NAN = float("nan")
_STREAMS = {
    "nonfinite_and_cap": [[_rec(3, _NAN, _NAN, 0), _rec(4, 2.0, 2.0, 0)]],
    "loss_spike_after_priming": [
        [_rec(i, 1.0 + 0.01 * i) for i in range(6)], [_rec(6, 50.0)],
        [_rec(7, 50.0)], [_rec(8, 1.05)]],
    "unprimed_passes": [[_rec(0, 1e9)], [_rec(1, 1.0)]],
    "grad_norm_spike": [
        [_rec(i, 1.0, 2.0 + 0.01 * i) for i in range(6)],
        [_rec(6, 1.0, 500.0)]],
    "flat_window": [[_rec(i, 1.0, 1.0) for i in range(8)],
                    [_rec(8, 1.5, 1.0), _rec(9, _NAN, 1.0, 0)]],
    "cap_armed_then_hit": [
        [_rec(i, 1.0 + 0.02 * (i % 5)) for i in range(10)],
        [_rec(10, 9.0, 2.0, 0), _rec(11, 1.04)]],
}


@pytest.mark.parametrize("action", ["warn", "skip", "rollback", "halt"])
@pytest.mark.parametrize("stream", sorted(_STREAMS))
def test_policy_decides_as_the_jax_policy(stream, action):
    kw = dict(action=action, spike_window=16, spike_z=6.0,
              spike_min_steps=4)
    mine, theirs = pg.GuardPolicy(**kw), jg.GuardPolicy(**kw)
    for window in _STREAMS[stream]:
        got = [dataclasses.asdict(t) for t in mine.observe(window)]
        want = [dataclasses.asdict(t) for t in theirs.observe(window)]
        assert repr(got) == repr(want)
        assert repr(mine.loss_cap()) == repr(theirs.loss_cap())
    rng = np.random.default_rng(len(stream))
    xs = rng.standard_normal(9).tolist()
    assert pg.robust_stats(xs) == jg.robust_stats(xs)


def test_rollback_budget_escalates_to_halt_as_in_jax():
    for mod in (pg, jg):
        pol = mod.GuardPolicy(action="rollback", max_rollbacks=2)
        pol.observe([_rec(0, 1.0)])
        pol.on_rollback()
        pol.on_rollback()
        with pytest.raises(mod.DivergedError, match="without progress"):
            pol.on_rollback()
        pol2 = mod.GuardPolicy(action="rollback", max_rollbacks=2)
        pol2.observe([_rec(0, 1.0)])
        pol2.on_rollback()
        pol2.observe([_rec(5, 1.0)])  # progress resets the streak
        pol2.on_rollback()
        pol2.on_rollback()
    assert pg.DIVERGED_EXIT_CODE == jg.DIVERGED_EXIT_CODE == 65
    assert pg.DivergedError.exit_code == 65


@pytest.mark.parametrize("kw,message", [
    (dict(action="explode"), "guard.action must be one of"),
    (dict(spike_window=3), "spike_window must be >= 4"),
    (dict(spike_z=0.0), "spike_z must be positive")])
def test_policy_refuses_bad_knobs_with_the_jax_messages(kw, message):
    with pytest.raises(ValueError, match=message) as mine:
        pg.GuardPolicy(**kw)
    with pytest.raises(ValueError) as theirs:
        jg.GuardPolicy(**kw)
    assert str(mine.value) == str(theirs.value)


def test_quarantine_log_reads_back_and_tombstones_as_jax(tmp_path):
    out = []
    for mod, name in ((pg, "p.jsonl"), (jg, "j.jsonl")):
        log = mod.QuarantineLog(tmp_path / name)
        log.quarantine(epoch=0, step=4, sample_range=(12, 16), rank=0,
                       reason="nan")
        log.record("spike", step=9, field="loss", value=50.0, z=12.0,
                   action="rollback")
        log.tombstone(from_step=9, to_step=5, reason="rollback")
        log.quarantine(epoch=0, step=7, sample_range=(24, 28), rank=0,
                       reason="replayed nan")
        log.close()
        recs = [{k: v for k, v in r.items() if k != "ts"}
                for r in mod.QuarantineLog(tmp_path / name).read()]
        out.append((log.generation, recs, mod.live_records(recs)))
    assert out[0] == out[1]
    assert [(r["kind"], r["step"]) for r in out[0][2]] == [
        ("quarantine", 4), ("quarantine", 7)]


def test_sdc_verdict_and_digest_as_jax():
    paths = ["a", "b", "c"]
    for sums in ([[1, 2, 3], [1, 2, 3], [9, 2, 3]],
                 [[1, 2, 3], [1, 2, 3]], [[1, 2, 3], [9, 2, 3]],
                 [[1, 2, 3], [1, 2, 7], [1, 5, 7], [1, 2, 7]]):
        arr = np.array(sums, np.uint32)
        assert pg.sdc_verdict(arr, paths) == jg.sdc_verdict(arr, paths)
        assert pg.digest_of_sums(arr[0]) == jg.digest_of_sums(arr[0])


# -- the checksum -------------------------------------------------------------


def _jax_net_params(seed=0):
    v = jax_build("net").init(jax.random.PRNGKey(seed),
                              np.zeros((1, 32, 32, 3), np.float32))
    return jax.tree_util.tree_map(np.asarray, dict(v["params"]))


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


_MODELS = {
    "net": lambda: _jax_net_params(),
    "resnet18": lambda: jax_resnet18_variables(num_filters=8)["params"],
    "resnet50": lambda: jax_resnet50_variables(num_filters=8)["params"],
}


def _negate_first_leaf(params):
    """Every element of the first leaf with its sign bit set."""
    params = _plain(params)
    node = params
    while True:
        key = sorted(node)[0]
        if isinstance(node[key], dict):
            node = node[key]
            continue
        node[key] = -np.abs(node[key]) - 0.5
        return params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "mixed"])
@pytest.mark.parametrize("name", sorted(_MODELS))
def test_checksum_equals_the_jax_checksum(name, dtype):
    params = _negate_first_leaf(_MODELS[name]())
    named = convert_grads(params)
    paths = jg.leaf_paths(params)
    assert pg.leaf_paths(named) == paths
    if dtype != "float32":
        # bf16 leaves, rounded the same way on both sides (f32 -> bf16 is
        # round-to-nearest-even in XLA and in torch).
        pick = set(paths[::2] if dtype == "mixed" else paths)
        flat, tree = jax.tree_util.tree_flatten(params)
        params = jax.tree_util.tree_unflatten(tree, [
            jnp.asarray(a, jnp.bfloat16) if p in pick else a
            for p, a in zip(paths, flat)])
        named = {k: t.to(torch.bfloat16) if key in pick else t
                 for k, t, key in _names_with_paths(named)}
    want = np.asarray(jg.make_params_checksum(params)(params))
    got = pg.params_checksum(named)
    assert got.dtype == np.uint32 and got.shape == (len(paths),)
    np.testing.assert_array_equal(got, want)


def _names_with_paths(named):
    from tpu_dp_torch.compat import param_leaves

    return [(name, named[name], key) for key, name, _ in param_leaves(named)]


def test_checksum_moves_with_one_flipped_bit_in_one_leaf():
    model = build_model("net", generator=torch.Generator().manual_seed(0))
    base = pg.params_checksum(model)
    with torch.no_grad():
        model.fc2.weight.view(-1).view(torch.int32)[7].bitwise_xor_(1)
    moved = np.nonzero(pg.params_checksum(model) != base)[0]
    assert [pg.leaf_paths(model)[i] for i in moved] == ["fc2/kernel"]


# -- the sentinel step against the JAX sentinel step --------------------------

_SCHED = ("cosine", 0.1, 12, 2, 0.0)
_STEPS = 7


def _guard(cap=math.inf, lr_scale=1.0, fault_step=-1, fault_scale=1.0):
    return {"loss_cap": np.float32(cap), "lr_scale": np.float32(lr_scale),
            "fault_step": np.int32(fault_step),
            "fault_scale": np.float32(fault_scale)}


def _guards():
    """Per call: neutral; a cap under any loss (skip); neutral; a NaN at
    the counter's value; a spike; an eased learning rate; neutral. The
    counter stays at 2 through the two skips."""
    return [_guard(), _guard(), _guard(cap=1e-3), _guard(fault_step=2,
            fault_scale=float("nan")), _guard(fault_step=2, fault_scale=50.0),
            _guard(lr_scale=0.25), _guard()]


def test_sentinel_step_tracks_the_jax_sentinel_step(mesh1):
    ds = make_synthetic(_STEPS * 8, 10, seed=5)
    batches = [(ds.images[i * 8:(i + 1) * 8], ds.labels[i * 8:(i + 1) * 8])
               for i in range(_STEPS)]
    params = _jax_net_params(seed=1)
    opt = JaxSGD(momentum=0.9, weight_decay=5e-4)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = JaxState(step=jnp.zeros((), jnp.int32), params=jparams,
                     opt_state=opt.init(jparams), batch_stats={})
    jstep = jax_train_step(jax_build("net"), opt, mesh1,
                           jax_schedule(*_SCHED), sentinel=True)
    model = load_jax_variables(build_model("net"), {"params": params})
    popt = make_sgd(model, momentum=0.9, weight_decay=5e-4)
    pstep = make_train_step(model, popt, make_schedule(*_SCHED),
                            device="cpu", sentinel=True)
    pstate = TrainState(step=0, model=model, optimizer=popt)
    applied = []
    for (images, labels), gi in zip(batches, _guards()):
        state, jm = jstep(state, {"image": images, "label": labels}, gi)
        pm = pstep(pstate, {"image": torch.from_numpy(images),
                            "label": torch.from_numpy(labels).long()}, gi)
        applied.append(int(pm["applied"]))
        if not applied[-1]:
            pstep.settle(pstate, 1)
        assert int(pm["applied"]) == int(jm["applied"])
        for key in ("loss", "loss_raw", "grad_norm"):
            a, b = float(pm[key]), float(jm[key])
            if math.isnan(b):
                assert math.isnan(a), key
            else:
                assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (key, a, b)
        assert pstate.step == int(state.step) == int(pstep.step_t)
        mine = {k: v.detach().numpy() for k, v in model.named_parameters()}
        want = convert_grads(jax.tree_util.tree_map(np.asarray,
                                                    state.params))
        for k, v in want.items():
            np.testing.assert_allclose(mine[k], v.numpy(), atol=1e-4,
                                       rtol=0)
    assert applied == [1, 1, 0, 0, 1, 1, 1]


# -- the bitwise contracts ----------------------------------------------------

_NET = ["--data.dataset=synthetic", "--data.synthetic_train_size=48",
        "--data.synthetic_test_size=8", "--train.epochs=1",
        "--train.log_every=100", "--data.augment=true",
        "--resilience.handle_signals=false"]
_RESNET = ["--preset=resnet18_cifar10", "--model.fused_stages=all",
           "--model.fused_bwd=true", "--train.pallas_xent=true",
           "--data.dataset=synthetic", "--data.synthetic_train_size=8",
           "--data.synthetic_test_size=4", "--data.batch_size=4",
           "--train.epochs=1", "--train.steps_per_call=2",
           "--train.eval_at_end=false", "--resilience.handle_signals=false"]


def _same_final(a, b):
    assert a["final"].keys() == b["final"].keys()
    for k, v in a["final"].items():
        assert b["final"][k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("args", [
    _NET, _NET + ["--train.steps_per_call=4"], _RESNET],
    ids=["net-1", "net-window4", "resnet18-fused"])
def test_a_clean_guarded_run_is_the_unguarded_run(tmp_path, args):
    off = run_trainer(args + [f"--train.ckpt_dir={tmp_path / 'off'}"])
    on = run_trainer(args + [f"--train.ckpt_dir={tmp_path / 'on'}",
                             "--guard.enabled=true"])
    assert on["losses"] == off["losses"]
    assert on["eval"] == off["eval"]
    _same_final(on, off)
    assert not (tmp_path / "on" / "quarantine.jsonl").exists()


@pytest.mark.parametrize("extra,fault,dropped", [
    ([], "nan:step=3", {3}),
    (["--train.steps_per_call=4"], "nan:step=5", {5, 6, 7}),
    (["--train.update_sharding=sharded"], "nan:step=3", {3})],
    ids=["one-a-call", "window4-frozen-counter", "sharded"])
def test_a_skipped_batch_is_the_never_saw_it_oracle(tmp_path, extra, fault,
                                                    dropped):
    from tpu_dp_torch.resilience import QuarantineLog

    args = _NET + extra + ["--data.device_resident=off"]
    on = run_trainer(args + [f"--train.ckpt_dir={tmp_path / 'on'}",
                             "--guard.enabled=true", "--guard.action=skip",
                             f"--resilience.fault={fault}"])
    recs = QuarantineLog(tmp_path / "on" / "quarantine.jsonl").read()
    assert [r["step"] - 1 for r in recs] == sorted(dropped)
    assert on["step"] == 12 - len(dropped) and on["host_step"] == 12
    oracle = run_trainer([a for a in args if "steps_per_call" not in a]
                         + [f"--train.ckpt_dir={tmp_path / 'oracle'}"],
                         drop=dropped)
    assert oracle["step"] == on["step"]
    _same_final(on, oracle)
    # The quarantined updates' losses count 0, as in the JAX package.
    assert [on["losses"][i] for i in sorted(dropped)] == [0.0] * len(dropped)
