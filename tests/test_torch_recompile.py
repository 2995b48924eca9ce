"""The port's `RecompileGuard` (`tpu_dp_torch.analysis.recompile`) against
the JAX package's (`tpu_dp.analysis.recompile`) on the same stub
callables, whose ``_cache_size`` grows at chosen calls: the same
``calls``, ``retraces``, ``stats()``, ``recompile.retraces`` counter and
message text, under warn and under raise. Then ``train.recompile_guard``
(off|warn|raise, refused otherwise with the JAX package's message), the
`Trainer`'s guard over its window programs (inert on the CPU, where the
window is eager), and the programs' ``_cache_size`` on the CPU."""

from __future__ import annotations

import pytest
import torch

from tpu_dp.analysis import recompile as jrec
from tpu_dp.obs.counters import counters as jcounters
from tpu_dp_torch.analysis import recompile as trec
from tpu_dp_torch.config import parse_cli
from tpu_dp_torch.obs.counters import counters as tcounters

pytestmark = pytest.mark.port

torch.set_num_threads(2)


class _Stub:
    """A callable whose cache grows at the chosen (1-based) calls."""

    __name__ = "stub_step"

    def __init__(self, grow_at, start=1):
        self.grow_at, self.size, self.n = set(grow_at), start, 0

    def __call__(self, x):
        self.n += 1
        if self.n in self.grow_at:
            self.size += 1
        return 2 * x

    def _cache_size(self):
        return self.size

    def lower(self):
        return "lowered"


def _drive(mod, counters, stub, calls, **kw):
    logs = []
    if kw.get("on_retrace") == "warn":
        kw["logger"] = logs.append
    guard = mod.RecompileGuard(stub, **kw)
    before = counters.get("recompile.retraces", 0)
    outs, errors = [], []
    for i in range(calls):
        try:
            outs.append(guard(i))
        except mod.RecompileError as e:
            errors.append(str(e))
    return {"outs": outs, "errors": errors, "logs": logs,
            "calls": guard.calls, "retraces": guard.retraces,
            "stats": guard.stats(), "name": guard.name,
            "counter": counters.get("recompile.retraces", 0) - before,
            "proxy": guard.lower()}


@pytest.mark.parametrize("on_retrace", ["warn", "raise"])
@pytest.mark.parametrize("warmup_calls", [1, 2, 3])
@pytest.mark.parametrize("grow_at", [(), (1,), (2,), (2, 5), (4, 4, 7),
                                     (1, 2, 3, 6)])
def test_guard_matches_jax(on_retrace, warmup_calls, grow_at):
    kw = dict(warmup_calls=warmup_calls, on_retrace=on_retrace)
    mine = _drive(trec, tcounters, _Stub(grow_at), 8, **kw)
    theirs = _drive(jrec, jcounters, _Stub(grow_at), 8, **kw)
    assert mine == theirs


def test_named_guard_and_inert_on_a_callable_without_cache():
    for mod in (trec, jrec):
        g = mod.RecompileGuard(lambda x: x + 1, name="eager",
                               on_retrace="raise")
        assert [g(i) for i in range(3)] == [1, 2, 3]
        assert g.stats() == {"name": "eager", "calls": 3, "retraces": 0,
                             "cache_size": None}


def test_bad_on_retrace_is_refused_with_the_jax_message():
    msgs = []
    for mod in (trec, jrec):
        with pytest.raises(ValueError) as e:
            mod.RecompileGuard(lambda x: x, on_retrace="ignore")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("mode", ["off", "warn", "raise"])
def test_cli_takes_recompile_guard(mode):
    cfg = parse_cli(["--preset=resnet18_cifar10",
                     f"--train.recompile_guard={mode}"])
    assert cfg.train.recompile_guard == mode


def test_cli_refuses_a_bad_recompile_guard_with_the_jax_message():
    with pytest.raises(ValueError) as e:
        parse_cli(["--preset=resnet18_cifar10",
                   "--train.recompile_guard=loud"])
    # tpu_dp/train/trainer.py's message.
    assert str(e.value) == ("train.recompile_guard must be off|warn|raise, "
                            "got 'loud'")


def _trainer(tmp_path, *extra):
    from tpu_dp_torch.train.trainer import Trainer

    return Trainer(parse_cli([
        "--data.dataset=synthetic", "--data.synthetic_train_size=16",
        "--data.synthetic_test_size=4", "--data.batch_size=4",
        "--train.epochs=1", "--train.steps_per_call=2",
        f"--train.ckpt_dir={tmp_path}", *extra]), device="cpu")


@pytest.mark.parametrize("mode", ["warn", "raise"])
@pytest.mark.parametrize("feed,name", [("off", "multi_step"),
                                       ("on", "resident_loop[w2]")])
def test_trainer_guards_its_window_program_inert_on_the_cpu(
        tmp_path, mode, feed, name):
    t = _trainer(tmp_path, f"--train.recompile_guard={mode}",
                 f"--data.device_resident={feed}")
    g = t._window_guard
    assert isinstance(g, trec.RecompileGuard)
    assert g._fn is t.multi_step
    assert (g.name, g.warmup_calls, g.on_retrace) == (name, 2, mode)
    t.fit()
    # 16 images, batches of 4, windows of 2: two windows, eager here.
    assert g.stats() == {"name": name, "calls": 2, "retraces": 0,
                         "cache_size": None}


def test_trainer_without_the_guard_calls_the_window_directly(tmp_path):
    t = _trainer(tmp_path, "--train.recompile_guard=off")
    assert t._window_guard is None
    t.fit()
    assert t.multi_step._cache_size() is None


def test_a_hook_under_the_window_guard_runs_every_window(tmp_path):
    """A hook that wraps the guard's program (how a test stops a run
    mid-epoch) is what the loop calls for every window, under the
    guard."""
    t = _trainer(tmp_path, "--train.recompile_guard=raise",
                 "--data.device_resident=off")
    guard = t._window_guard
    real, seen = guard._fn, []
    assert real is t.multi_step

    def window(state, pool, *rest):
        seen.append(state.step)
        return real(state, pool, *rest)

    guard._fn = window
    t.fit()
    assert seen == [0, 2]
    assert guard.stats()["calls"] == 2


def test_programs_have_no_cache_on_the_cpu():
    from tpu_dp_torch.models import build_model
    from tpu_dp_torch.train.step import (
        ServeGraph, init_serve_stats, make_serve_step,
    )

    model = build_model("net").eval()
    g = ServeGraph(make_serve_step(model, "cpu", 2), "cpu")
    stats = init_serve_stats(10, "cpu")
    batch = {"image": torch.zeros((2, 32, 32, 3), dtype=torch.uint8),
             "weight": torch.tensor([1.0, 0.0])}
    stats, out = g(stats, batch)
    assert g._cache_size() is None and not g.graphed
    assert int(stats["served"]) == 1 and out["prediction"].shape == (2,)
    guard = trec.RecompileGuard(g, on_retrace="raise")
    guard(stats, batch)
    assert guard.stats()["cache_size"] is None
