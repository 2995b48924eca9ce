"""The port's serving path (`tpu_dp_torch.serve`) on the CPU against the JAX
package: predictions and confidences of a fused ResNet-18 served from
converted JAX weights equal JAX `_infer_forward`'s, the audited books hold,
and the copied host modules (queue, batcher, spans) behave exactly like
their originals on one scripted sequence.

Tolerances: predictions must be equal wherever JAX's top-2 logit margin
exceeds 2e-2 x max|logits| (twice the model-level fused bound of
tests/test_torch_resnet.py); confidences agree within 1e-3."""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_resnet18_variables
from tpu_dp.data import cifar as jcifar
from tpu_dp.models import build_model as jax_build
from tpu_dp.obs import spans as jspans
from tpu_dp.obs.counters import Counters as JCounters
from tpu_dp.serve import batcher as jbatcher
from tpu_dp.serve import queue as jqueue
from tpu_dp.train.state import TrainState
from tpu_dp.train.step import _infer_forward
from tpu_dp_torch.compat import load_jax_variables
from tpu_dp_torch.data import cifar as tcifar
from tpu_dp_torch.config import (
    ServeConfig, parse_class_floors, parse_class_slo_ms,
)
from tpu_dp_torch.models import build_model
from tpu_dp_torch.obs import spans as tspans
from tpu_dp_torch.obs.counters import Counters as TCounters
from tpu_dp_torch.serve import InferenceEngine, run_load
from tpu_dp_torch.serve import batcher as tbatcher
from tpu_dp_torch.serve import queue as tqueue
from tpu_dp_torch.serve.__main__ import main as serve_main

pytestmark = pytest.mark.port

# The suite runs several pytest workers on one machine: keep each worker's
# PyTorch CPU pool small so the port's tests do not starve the others.
torch.set_num_threads(2)

FUSED = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def variables():
    return jax_resnet18_variables(num_filters=8, seed=2)


def _port_model(variables, dtype=torch.float32):
    m = build_model("resnet18", num_filters=8, dtype=dtype,
                    fused_stages=FUSED)
    return load_jax_variables(m, variables)


class _Recorder:
    """Engine proxy keeping every (images, handle) `run_load` submits."""

    def __init__(self, engine):
        self._engine, self.sent = engine, []

    def submit(self, images, *a, **kw):
        h = self._engine.submit(images, *a, **kw)
        self.sent.append((np.asarray(images), h))
        return h

    def __getattr__(self, name):
        return getattr(self._engine, name)


def test_served_predictions_match_jax_infer_forward(variables):
    engine = InferenceEngine(_port_model(variables), device="cpu",
                             buckets=(1, 2, 4, 8), slo_ms=60_000.0,
                             registry=TCounters())
    rec = _Recorder(engine)
    engine.start()
    try:
        report = run_load(rec, n_requests=16, rate_rps=2000.0,
                          sizes=(1, 2, 3), seed=5)
    finally:
        engine.stop()
    assert report["consistent"] and report["ground_truth"]["unresolved"] == 0
    assert all(h.done() and h.ok for _, h in rec.sent)

    images = np.concatenate([im for im, _ in rec.sent])
    preds = np.concatenate([h.predictions for _, h in rec.sent])
    confs = np.concatenate([h.confidence for _, h in rec.sent])
    jm = jax_build("resnet18", num_filters=8, fused_stages=FUSED)
    state = TrainState(step=np.zeros((), np.int32),
                       params=variables["params"], opt_state={},
                       batch_stats=variables["batch_stats"])
    logits, jpred = _infer_forward(jm, state, {"image": jnp.asarray(images)})
    logits = np.asarray(logits, np.float32)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2e-2 * np.abs(logits).max()
    assert decided.sum() >= len(decided) // 2
    np.testing.assert_array_equal(preds[decided], np.asarray(jpred)[decided])
    jconf = np.asarray(jax.nn.softmax(logits, axis=-1)).max(-1)
    np.testing.assert_allclose(confs, jconf, rtol=0, atol=1e-3)

    # Books: device served == images served == completed images; the
    # device class histogram is the handles' predictions.
    truth, dev = report["ground_truth"], report["device_stats"]
    assert dev["served"] == truth["images_served"] == len(images)
    assert dev["class_counts"] == np.bincount(preds, minlength=10).tolist()
    assert report["retraces"] == 0
    assert sum(report["bucket_counts"].values()) == report["batches"]


def test_swap_model_between_batches(variables):
    engine = InferenceEngine(_port_model(variables), device="cpu",
                             buckets=(1, 2, 4), slo_ms=60_000.0,
                             registry=TCounters())
    other = build_model("resnet18", num_filters=8, fused_stages=FUSED,
                        generator=torch.Generator().manual_seed(9))
    engine.start()
    try:
        img = np.full((1, 32, 32, 3), 128, np.uint8)
        h1 = engine.submit(img)
        assert h1.wait(60) and h1.model_version == 1
        assert engine.swap_model(other.state_dict()) == 2
        h2 = engine.submit(img)
        assert h2.wait(60) and h2.model_version == 2
    finally:
        engine.stop()
    assert engine.report()["model_version"] == 2


def test_start_warms_every_bucket_on_the_dispatch_thread():
    model = build_model("resnet18", num_filters=8, fused_stages=FUSED)
    engine = InferenceEngine(model, device="cpu", buckets=(1, 2, 4),
                             registry=TCounters())
    threads = []
    model = engine.model  # the replica's own copy
    real = model.forward
    model.forward = lambda x: (threads.append(
        threading.current_thread().name), real(x))[1]
    engine.start()
    engine.stop()
    assert sorted(engine.replica.warmup_ms) == [1, 2, 4]
    assert threads == ["tpu_dp_torch-serve-replica-0"] * 3
    assert engine.device_stats()["served"] == 0


def test_warmup_failure_raises_from_start():
    model = build_model("resnet18", num_filters=8, fused_stages=FUSED)
    engine = InferenceEngine(model, device="cpu", buckets=(1,),
                             registry=TCounters())

    def broken(x):
        raise ValueError("boom")

    engine.model.forward = broken  # the replica's own copy
    with pytest.raises(RuntimeError, match="warmup failed") as info:
        engine.start()
    assert isinstance(info.value.__cause__, ValueError)
    assert engine.replica.status == "dead"


def test_stop_without_drain_sheds_and_serve_config():
    model = build_model("resnet18", num_filters=8, fused_stages=FUSED)
    cfg = ServeConfig(buckets="1,2", class_slo_ms="100,200")
    engine = InferenceEngine.from_serve_config(model, cfg, device="cpu",
                                               registry=TCounters())
    assert engine.ladder.buckets == (1, 2)
    assert engine.class_slo_ms == {0: 100.0, 1: 200.0}
    h = engine.submit(np.zeros((1, 32, 32, 3), np.uint8))
    engine.stop(drain=False)
    assert h.done() and not h.ok and h.shed_reason == "closed"
    assert parse_class_floors("0:0.9,1:0.5") == {0: 0.9, 1: 0.5}
    assert parse_class_slo_ms("") == {}
    with pytest.raises(ValueError):
        parse_class_floors("0=0.9")


def test_cli_audits_and_exits_zero(capsys):
    rc = serve_main(["--requests", "12", "--device", "cpu",
                     "--num-filters", "8", "--buckets", "1,2,4",
                     "--slo-ms", "60000", "--floors", "0:0.5"])
    out = capsys.readouterr().out
    assert rc == 0
    assert '"consistent": true' in out
    assert serve_main(["--requests", "1", "--device", "cpu",
                       "--buckets", "0"]) == 2


# -- copies pinned to their originals -----------------------------------


def _drive_queue(mod, counters_cls):
    reg = counters_cls()
    q = mod.RequestQueue(max_depth=3, default_slo_ms=1000.0,
                         shed_headroom_ms=5.0, image_shape=(2, 2, 1),
                         image_dtype=np.uint8, max_request=4, registry=reg)
    log = []
    script = [(1, 1, 1000.0), (2, 2, 1000.0), (1, 0, 1000.0),
              (3, 0, 1000.0), (1, 2, 1000.0), (1, 0, 1.0), (2, 1, 0.01)]
    handles = []
    for i, (n, cls, slo) in enumerate(script):
        img = np.full((n, 2, 2, 1), i, np.uint8)
        try:
            handles.append(q.submit(img, slo_ms=slo, now=float(i),
                                    slo_class=cls))
            log.append(("ok", i))
        except mod.ShedError as e:
            log.append(("shed", i, e.reason))
    batch, expired = q.collect(4, now=5.0)
    log.append(("batch", [r.req_id for r in batch],
                [r.req_id for r in expired]))
    q.close()
    rest, _ = q.collect(100, now=5.0)
    log.append(("rest", [r.req_id for r in rest]))
    log.append(("handles", [(h.req_id, h.done(), h.shed_reason)
                            for h in handles]))
    ladder = mod_batcher(mod).BucketLadder((1, 2, 4))
    fb = mod_batcher(mod).DynamicBatcher(q, ladder).form(batch, expired, 5.0)
    log.append(("form", fb.bucket, fb.valid, fb.images.tolist(),
                fb.weight.tolist(), [(s.start, s.stop) for s in fb.slices]))
    log.append(("counters", reg.snapshot()))
    return log


def mod_batcher(mod):
    return jbatcher if mod is jqueue else tbatcher


def test_queue_and_batcher_copies_behave_like_originals():
    a = _drive_queue(jqueue, JCounters)
    b = _drive_queue(tqueue, TCounters)
    assert a == b
    assert any(e[0] == "shed" for e in a)  # the script does shed


def _drive_spans(mod):
    rec = mod.SpanRecorder(capacity=5)
    for i in range(8):
        rec.record(i, {"queue_wait": i * 1.5, "device": 10.0 - i,
                       "total": 3.0 * i}, ts=100.0 + i)
    vals = sorted([3.0, 1.0, 2.0, 9.5])
    return (rec.records(), rec.rollup(), len(rec),
            [mod.percentile(vals, q) for q in (0, 25, 50, 95, 100)])


def test_spans_copy_behaves_like_original():
    assert _drive_spans(jspans) == _drive_spans(tspans)


def test_data_copies_behave_like_originals():
    ja = jcifar.make_synthetic(12, 10, seed=4, example_seed=5)
    ta = tcifar.make_synthetic(12, 10, seed=4, example_seed=5)
    np.testing.assert_array_equal(ja.images, ta.images)
    np.testing.assert_array_equal(ja.labels, ta.labels)
    ref = np.asarray(jcifar.normalize(ja.images))
    np.testing.assert_array_equal(tcifar.normalize(ta.images), ref)
    np.testing.assert_array_equal(
        tcifar.normalize(torch.from_numpy(ta.images)).numpy(), ref)
