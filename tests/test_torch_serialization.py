"""The port's msgpack codec (`tpu_dp_torch.serialization`) against flax's:
trees of dicts, strs, ints, floats and f32/int32/int64 arrays of 0-4
dims round-trip both ways (port-encoded bytes through
``flax.serialization.msgpack_restore``, flax-encoded bytes through the
port's decoder), a state dict encodes to flax's own bytes, and what the
codec does not read is refused with `MsgpackError`."""

from __future__ import annotations

import msgpack
import numpy as np
import pytest
from flax import serialization as fser
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from tpu_dp_torch.serialization import MsgpackError, msgpack_restore, to_bytes

pytestmark = pytest.mark.port

_arrays = st.one_of(*[
    hnp.arrays(dtype, hnp.array_shapes(min_dims=0, max_dims=4, min_side=0,
                                       max_side=4))
    for dtype in (np.float32, np.int32, np.int64)])
_scalars = st.one_of(
    st.integers(-2**63, 2**64 - 1), st.floats(allow_nan=False),
    st.text(max_size=40), st.booleans(), st.none())
_leaves = st.one_of(_scalars, _arrays)
_trees = st.recursive(
    st.dictionaries(st.text(max_size=12), _leaves, max_size=5),
    lambda children: st.dictionaries(st.text(max_size=12),
                                     st.one_of(_leaves, children),
                                     max_size=5),
    max_leaves=20)


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


@settings(max_examples=60, deadline=None)
@given(_trees)
def test_port_bytes_restore_through_flax(tree):
    assert _equal(fser.msgpack_restore(to_bytes(tree)), tree)


@settings(max_examples=60, deadline=None)
@given(_trees)
def test_flax_bytes_restore_through_the_port(tree):
    raw = msgpack.packb(tree, default=fser._msgpack_ext_pack,
                        strict_types=True)
    assert _equal(msgpack_restore(raw), tree)
    # The smallest format for every value, in the tree's order: the same
    # bytes as msgpack's packer.
    assert to_bytes(tree) == raw


def test_state_dict_bytes_equal_flax_to_bytes():
    tree = {"step": np.asarray(7, np.int32),
            "params": {"conv1": {"kernel": np.ones((5, 5, 3, 6), np.float32),
                                 "bias": np.zeros(6, np.float32)}},
            "opt_state": {}, "batch_stats": {}, "residuals": {}}
    assert to_bytes(tree) == fser.to_bytes(tree)


def test_numpy_scalar_is_read():
    raw = fser.msgpack_serialize({"s": np.float32(2.5), "i": np.int64(-3)})
    out = msgpack_restore(raw)
    assert out == {"s": 2.5, "i": -3}
    assert out["s"].dtype == np.float32


def test_chunked_array_marker_is_refused():
    tree = {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2},
                  "chunks": {"0": np.zeros(2, np.float32)}}}
    raw = msgpack.packb(tree, default=fser._msgpack_ext_pack,
                        strict_types=True)
    with pytest.raises(MsgpackError, match="chunked"):
        msgpack_restore(raw)


@pytest.mark.parametrize("raw,match", [
    (msgpack.packb({"c": msgpack.ExtType(2, msgpack.packb((1.0, 2.0)))}),
     "ext type 2"),
    (msgpack.packb({"c": msgpack.ExtType(9, b"xx")}), "ext type 9"),
    (b"\xc1", "format byte"),
    (msgpack.packb({"a": 1}) + b"\x00", "trailing"),
    (fser.msgpack_serialize({"a": np.ones(4, np.float32)})[:-3],
     "truncated"),
])
def test_unknown_and_broken_input_is_refused(raw, match):
    with pytest.raises(MsgpackError, match=match):
        msgpack_restore(raw)


def test_bfloat16_leaf_is_refused_both_ways():
    import jax.numpy as jnp

    bf = np.asarray(jnp.ones(3, jnp.bfloat16))
    with pytest.raises(MsgpackError, match="bfloat16"):
        msgpack_restore(fser.msgpack_serialize({"w": bf}))
    with pytest.raises(MsgpackError, match="bfloat16"):
        to_bytes({"w": bf})


@pytest.mark.parametrize("bad", [{1: 2}, {"x": object()}, {"x": 2**64},
                                 {"x": np.float64(1.0)}])
def test_values_outside_the_subset_are_not_written(bad):
    with pytest.raises(MsgpackError):
        to_bytes(bad)
