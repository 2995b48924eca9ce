"""The port's elastic `Trainer` in one process against the JAX package's
(the single-process twins of tests/test_elastic.py's trainer tests).

- A ``leave:step=3`` departure writes the JAX package's ledger: the same
  file set, the same plan, the same epoch-0 members, and the final
  snapshot's ``membership`` stamp (lineage ``[[1, stop_step]]``), then
  raises `PreemptedError` ("elastic departure"); one update a call and
  windows of 4.
- The departed run resumed with ``--resume`` ends bit-identical to the
  port's uninterrupted elastic run, and within 1e-4 of the JAX package's
  uninterrupted run from the same initial save.
- A snapshot whose lineage spans two worlds resumes into the re-split
  tail (`_maybe_resume_into_tail`), as the JAX package resumes it.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tpu_dp.config as jax_config
from tpu_dp import checkpoint as jck
from tpu_dp.data.sampler import elastic_resplit
from tpu_dp.resilience import PreemptedError as JaxPreemptedError
from tpu_dp.train.trainer import Trainer as JaxTrainer
from tpu_dp_torch.checkpoint import CheckpointManager
from tpu_dp_torch.compat import convert_grads
from tpu_dp_torch.config import parse_cli
from tpu_dp_torch.resilience import PreemptedError
from tpu_dp_torch.train.trainer import Trainer

pytestmark = pytest.mark.port

torch.set_num_threads(2)

#: tests/test_elastic.py's `_elastic_cfg`: Net, 48 images of 4, 2 epochs.
_ARGS = ["--data.dataset=synthetic", "--data.synthetic_train_size=48",
         "--data.synthetic_test_size=16", "--data.batch_size=4",
         "--train.epochs=2", "--train.log_every=100",
         "--train.eval_at_end=false", "--train.ckpt_async=false",
         "--resilience.elastic=true"]
_PORT = ["--resilience.elastic_verify_fingerprint=false",
         "--resilience.handle_signals=false"]


def _jax_trainer(ckpt: Path, *extra) -> JaxTrainer:
    cfg = jax_config.parse_cli(_ARGS + [f"--train.ckpt_dir={ckpt}",
                                        "--parallel.num_devices=1", *extra])
    return JaxTrainer(cfg)


def _port_trainer(ckpt: Path, *extra) -> Trainer:
    return Trainer(parse_cli(_ARGS + _PORT + [f"--train.ckpt_dir={ckpt}",
                                              *extra]), device="cpu")


def _ledger(ckpt: Path) -> tuple[Path, set[str]]:
    gens = list((ckpt / "membership").iterdir())
    assert len(gens) == 1
    return gens[0], {p.name for p in gens[0].iterdir()}


def _init_save(tmp: Path) -> Path:
    """The JAX package's initial state as an epoch -1 save (both packages
    start from it)."""
    init = tmp / "init"
    t = _jax_trainer(tmp / "jax_init")
    jck.CheckpointManager(init, async_save=False).save(
        t.state, {"epoch": -1, "config": t.cfg.to_dict(), "seed": 0})
    return init


def _from(init: Path, ckpt: Path) -> Path:
    shutil.copytree(init, ckpt)
    return ckpt


@pytest.mark.parametrize("k", [1, 4])
def test_leave_departs_with_the_jax_packages_ledger_and_manifest(tmp_path,
                                                                 k):
    fault = ["--resilience.fault=leave:step=3", f"--train.steps_per_call={k}"]
    with pytest.raises(JaxPreemptedError, match="elastic departure") as je:
        _jax_trainer(tmp_path / "jax", *fault).fit()
    mine = _port_trainer(tmp_path / "port", *fault)
    with pytest.raises(PreemptedError, match="elastic departure") as pe:
        mine.fit()
    assert str(pe.value).split(";")[0] == str(je.value).split(";")[0]
    (jgen, jnames), (pgen, pnames) = (_ledger(tmp_path / "jax"),
                                      _ledger(tmp_path / "port"))
    assert pnames == jnames
    assert {"epoch_0000.json", "plan_e0001.json", "left_r00000.json",
            "q_e0001_r00000.json", "q_e0001_r00000.done"} <= pnames
    assert pgen.name.split("_")[:3] == jgen.name.split("_")[:3]
    plan = json.loads((pgen / "plan_e0001.json").read_text())
    assert plan == json.loads((jgen / "plan_e0001.json").read_text())
    assert plan["leavers"] == [0] and plan["survivors"] == []
    assert plan["stop_step"] == (3 if k == 1 else 4)
    epoch0 = [{k2: v for k2, v in json.loads(
        (g / "epoch_0000.json").read_text()).items() if k2 != "ts"}
        for g in (pgen, jgen)]
    assert epoch0[0] == epoch0[1]
    step = plan["stop_step"]
    metas = [json.loads((ck / "snapshots" / f"step_{step:010d}" /
                         "meta.json").read_text())
             for ck in (tmp_path / "port", tmp_path / "jax")]
    assert metas[0]["membership"] == metas[1]["membership"] == {
        "epoch": 0, "world": 1, "members": [0], "lineage": [[1, step]]}
    for key in ("kind", "epoch", "steps_done"):
        assert metas[0][key] == metas[1][key]
    left = [json.loads((g / "left_r00000.json").read_text())["step"]
            for g in (pgen, jgen)]
    assert left[0] == left[1] == step


def test_leave_then_resume_is_bit_identical_and_tracks_jax(tmp_path):
    init = _init_save(tmp_path)
    ck = _from(init, tmp_path / "run")
    with pytest.raises(PreemptedError):
        _port_trainer(ck, "--resilience.fault=leave:step=3",
                      "--resume").fit()
    resumed = _port_trainer(ck, "--resume")
    assert (resumed.start_epoch, resumed.start_step) == (0, 3)
    assert "snapshots" in resumed.resumed_from
    resumed.fit()
    ref = _port_trainer(_from(init, tmp_path / "ref"), "--resume")
    ref.fit()
    a, b = resumed.model.state_dict(), ref.model.state_dict()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    theirs = _jax_trainer(_from(init, tmp_path / "jax"), "--resume=true")
    theirs.fit()
    params = convert_grads(jax.tree_util.tree_map(np.asarray,
                                                  theirs.state.params))
    named = dict(resumed.model.named_parameters())
    for key, v in params.items():
        np.testing.assert_allclose(named[key].detach().numpy(), v.numpy(),
                                   atol=1e-4, rtol=0, err_msg=key)


def test_a_two_world_lineage_resumes_into_the_resplit_tail(tmp_path):
    """A snapshot taken at world 1 after a 3 → 1 shrink (lineage [[3, 2],
    [1, 5]]) resumes, at world 1, into the re-split tail 5 steps in; the
    tail equals the JAX package's re-split of the same lineage."""
    ck = tmp_path / "run"
    t = _port_trainer(ck)
    meta = {"kind": "snapshot", "epoch": 0, "steps_done": 7,
            "config": t.cfg.to_dict(), "seed": 0,
            "membership": {"epoch": 1, "world": 1, "members": [1],
                           "lineage": [[3, 2], [1, 5]]}}
    t.state.step = 7
    CheckpointManager(t.snapshot_dir, async_save=False).save(t.state, meta)
    resumed = _port_trainer(ck, "--resume")
    assert (resumed.start_epoch, resumed.start_step) == (0, 0)
    tail = resumed._elastic_tail
    assert (tail.epoch, tail.base, tail.skip) == (0, 2, 5)
    assert resumed._epoch_lineage == [[3, 2]]
    want = elastic_resplit(48, True, 0, 0, 4, [[3, 2]], 1, 0)
    np.testing.assert_array_equal(tail.pipe.sampler.shard_indices(), want)
    out = resumed.fit()
    # 24 samples remain after 2 steps at world 3: 6 steps at world 1, 5
    # of them already run; then the 12 steps of epoch 1.
    assert out["history"][0]["resumed_at_step"] == 7
    assert resumed._host_step == 7 + 1 + 12
