"""CUDA graphs of the port's train step on a card (`make_multi_step`'s
windows): the ticket counters refuse to be made inside a capture, and
replayed windows equal eager updates bit for bit. Card-only: a graph
captures only there, so both cases skip without CUDA. Imports torch and
the port only, so the card's machine (no flax) runs it:
``python -m pytest tests/test_torch_capture.py -m card``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_dp_torch.data.augment import make_augment_fn
from tpu_dp_torch.models import build_model
from tpu_dp_torch.train.optim import make_sgd
from tpu_dp_torch.train.schedule import make_schedule
from tpu_dp_torch.train.step import (
    TrainState,
    make_multi_step,
    make_train_step,
)

pytestmark = pytest.mark.port

SCHED = ("cosine", 0.1, 10, 1, 0.0)  # name, lr, total, warmup, final
K = 3


@pytest.mark.card
def test_tickets_refuse_to_allocate_during_capture():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a graph captures only there")
    from tpu_dp_torch.ops import _tickets

    dev = torch.device("cuda", 0)
    stream = torch.cuda.Stream(dev)
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
            _tickets.tickets(dev, 1)
    # Made on the stream before the capture: found, not allocated.
    with torch.cuda.stream(stream):
        buf = _tickets.tickets(dev, 1)
    with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
        assert _tickets.tickets(dev, 1) is buf


@pytest.mark.card
def test_graphed_windows_equal_eager_updates_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a graph captures only there")
    rng = np.random.default_rng(0)
    windows = 3
    images = torch.from_numpy(rng.integers(
        0, 256, (windows, K, 4, 32, 32, 3), dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, (windows, K, 4))).cuda()

    def run(graphed):
        model = build_model("net", generator=torch.Generator().manual_seed(
            0)).cuda()
        opt = make_sgd(model, 0.9)
        step = make_train_step(model, opt, make_schedule(*SCHED),
                               use_pallas_xent=True,
                               augment_fn=make_augment_fn(1))
        state = TrainState(step=0, model=model, optimizer=opt)
        losses = []
        loop = make_multi_step(step, K)
        for w in range(windows):
            if graphed:
                losses += loop(state, {"image": images[w],
                                       "label": labels[w]})["loss"].tolist()
            else:
                losses += [float(step(state, {"image": images[w, i],
                                              "label": labels[w, i]})["loss"])
                           for i in range(K)]
        torch.cuda.synchronize()
        return losses, model.state_dict(), loop

    eager, state_e, _ = run(False)
    got, state_g, loop = run(True)
    assert got == eager
    assert all(torch.equal(state_e[k], state_g[k]) for k in state_e)
    # One eager warm-up window, then one capture replayed twice.
    assert loop.graph is not None and loop.replays == windows - 1
    assert loop.captured["xent.forward"] == K
    assert loop.captured["xent.backward"] == K
