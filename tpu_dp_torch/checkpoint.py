"""Checkpoint save/restore of the port in the JAX package's on-disk format
(port of `tpu_dp.checkpoint`): a save written by either package loads in
the other.

- The payload is ``state.msgpack``: the flax state dict of the JAX
  ``TrainState`` (``tpu_dp/train/state.py``) — ``step`` (0-d int32),
  ``params``, ``opt_state`` (params-shaped momentum buffers, ``{}`` for
  momentum 0), ``batch_stats`` and ``residuals`` (``{}``) — built from the
  port's `TrainState` through `tpu_dp_torch.compat` and encoded by the
  port's own msgpack codec (`tpu_dp_torch.serialization`).
- ``meta.json`` holds the caller's metadata, the manifest ``schema`` and
  the integrity block: the payload's sha256 and one sha256 per leaf over
  ``str(dtype)``, ``str(shape)`` and its bytes, so a mismatch names the
  rotten leaf (`verify_payload`). Every load verifies; a schema-1 save (no
  manifest) loads unverified; an unknown schema is refused.
- Only rank 0 writes, atomically: tmp file + rename for the payload, then
  the meta (a save without its meta is torn and never resumed from). A
  fresh write clears a stale quarantine marker.
- `CheckpointManager` keeps ``step_<n:010d>`` directories with a
  ``latest`` pointer flipped only after a complete write, prunes beyond
  ``keep`` (0 keeps all) and writes on a worker thread; the host snapshot
  is taken synchronously on the caller's thread, and the worker issues no
  collective.
- `save_params` / `load_params` are the end-of-training params export;
  `load_params_only` reads a training checkpoint's params and statistics
  for serving without restoring the optimizer.

The port's SGD (`tpu_dp_torch.train.optim`) makes its momentum buffers
as zeros when it is built, as the JAX opt state starts; an optimizer
without a buffer has it written as zeros. A restore copies into the live
buffers in place (a captured CUDA graph of the step keeps their
addresses), making a buffer only where there is none.

The sharded update (`optim.ShardedUpdate`) is saved in the JAX package's
sharded layout: each ``opt_state`` leaf flat of ``padded_size(n, world)``
in the JAX leaf's element order, and under the int8 wire ``residuals`` as
``f32[world, qpad]`` by leaf or bucket composition key. Taking that
snapshot gathers every rank's shards (a collective: every rank calls the
save, rank 0 alone writes). A restore reads any layout into any target
(the JAX package's ``_relayout_opt_leaf`` and ``_reconcile_residuals``):
replicated and sharded either way, any world to any world (the true
elements kept, the padding zero), residuals bitwise when the layout
matches and otherwise resharded preserving their sum over ranks on rank
0's row; a save without residuals gives zeros.

Every write (the payload and meta, the ``latest`` pointer, the params
export) retries transient ``OSError`` on the unified IO budget
(``resilience.io_retry_s``: `resilience.retry.io_retry_params`), and the
storage-fault shim's seams sit where the JAX package has them: ``on_write``
inside the retried block (an injected EIO is retried like a real one),
``post_commit`` after the final rename (``torn``/``bitrot`` corrupt a
committed save). A write that still fails raises to the caller's degrade
policy (the Trainer counts ``ckpt.write_errors`` and trains on).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from tpu_dp_torch import serialization
from tpu_dp_torch.compat import (
    check_state_dict,
    convert_grads,
    convert_variables,
    jax_leaves,
    nest,
)
from tpu_dp_torch.obs.counters import counters as _counters
from tpu_dp_torch.parallel.dist import process_index

log = logging.getLogger(__name__)

_CKPT_NAME = "state.msgpack"
_META_NAME = "meta.json"

#: Checkpoint meta schema. 1 = no ``schema`` key and no integrity block;
#: 2 = + the integrity manifest, verified on every load.
CKPT_SCHEMA = 2
KNOWN_SCHEMAS = (1, 2)

#: Advisory marker a step dir gets when a resume found it corrupt
#: (`tpu_dp_torch.resilience.preempt.quarantine_save_dir`).
QUARANTINED_MARKER = "quarantined.json"


class CheckpointSchemaError(ValueError):
    """A checkpoint manifest declares a schema this build does not know."""


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed checksum verification. Carries the save dir and
    (when the payload still parses) the names of the mismatching leaves."""

    def __init__(self, message: str, *, path: str = "",
                 leaves: tuple[str, ...] = ()):
        super().__init__(message)
        self.path = str(path)
        self.leaves = tuple(leaves)


# -- the payload: the JAX TrainState's state dict -------------------------


def _momentum(optimizer: torch.optim.Optimizer) -> float:
    values = {float(g.get("momentum", 0.0)) for g in optimizer.param_groups}
    if len(values) != 1:
        raise ValueError(f"param groups disagree on momentum: {values}")
    return values.pop()


def _host_copy(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Host copies of f32 ``tensors`` (numpy, C order, shaped as given):
    one concatenation on their device, then one copy into pinned host
    memory (from a card), so later in-place updates do not reach them."""
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("the saved state is float32 throughout")
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    if flat.device.type == "cuda":
        host = torch.empty(flat.numel(), dtype=flat.dtype, pin_memory=True)
        host.copy_(flat)
    else:
        host = flat  # already a copy
    arr, out, at = host.numpy(), [], 0
    for t in tensors:
        out.append(arr[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def _sharded(opt) -> bool:
    return getattr(opt, "is_sharded_update", False)


def state_leaves(state) -> list[tuple[str, tuple, torch.Tensor]]:
    """``(collection, path, tensor)`` of every leaf of the JAX
    ``TrainState`` but the step, in the order `tree_of` nests them: the
    model's variables, then the momentum (replicated: one buffer per
    parameter, zeros where there is none; sharded: the gathered global
    arrays and residuals, a collective every rank joins)."""
    model, opt = state.model, state.optimizer
    leaves = jax_leaves(model.state_dict())
    if _sharded(opt):
        mom, res = opt.gather_state()
        leaves += [("opt_state", tuple(k.split("/")), t)
                   for k, t in mom.items()]
        leaves += [("residuals", (k,), t) for k, t in res.items()]
    elif _momentum(opt) != 0.0:
        bufs = {}
        for name, p in model.named_parameters():
            buf = opt.state.get(p, {}).get("momentum_buffer")
            bufs[name] = torch.zeros_like(p) if buf is None else buf
        leaves += [("opt_state", path, t)
                   for _, path, t in jax_leaves(bufs)]
    return leaves


def tree_of(step: int, leaves, arrays) -> dict[str, Any]:
    """The flax state dict of the JAX ``TrainState``: ``step`` and the host
    ``arrays`` of `state_leaves`' ``leaves``, nested."""
    step = int(step)
    if not 0 <= step < 2**31:
        raise ValueError(f"step {step} does not fit the int32 step leaf")
    tree: dict[str, Any] = {"step": np.asarray(step, np.int32), "params": {},
                            "opt_state": {}, "batch_stats": {},
                            "residuals": {}}
    for (collection, path, _), a in zip(leaves, arrays):
        nest(tree[collection], path, a)
    return tree


def state_dict_of(state) -> dict[str, Any]:
    """The flax state dict of the JAX ``TrainState`` equal to the port's
    `TrainState` ``state``: host numpy copies, taken now. The layout
    changes run on the state's device, and the host gets one copy. A
    sharded optimizer's shards are gathered first (a collective)."""
    leaves = state_leaves(state)
    return tree_of(state.step, leaves,
                   _host_copy([t for _, _, t in leaves]))


def _relayout_opt_leaf(saved, like_shape: tuple, where: str) -> np.ndarray:
    """One saved momentum leaf on ``like_shape``'s layout (the JAX
    package's ``_relayout_opt_leaf``): flat to flat truncates or
    zero-extends (past the true elements there is only padding), shaped
    to flat pads, flat to shaped keeps the leading true elements."""
    saved = np.asarray(saved)
    if saved.shape == tuple(like_shape):
        return saved
    flat = saved.reshape(-1)
    if len(like_shape) == 1:
        out = np.zeros(like_shape[0], dtype=np.float32)
        k = min(out.size, flat.size)
        out[:k] = flat[:k]
        return out
    size = int(np.prod(like_shape))
    if flat.size < size:
        raise ValueError(
            f"checkpoint opt_state leaf {where}: saved {saved.shape} has "
            f"{flat.size} elements, target {tuple(like_shape)} needs "
            f"{size} — not a shard-layout transition")
    return flat[:size].reshape(like_shape)


def _leaf(tree, key: str):
    for part in key.split("/"):
        if not isinstance(tree, dict) or part not in tree:
            return None
        tree = tree[part]
    return tree


def _reconcile_residuals(saved: dict, target: dict[str, tuple],
                         leaf_sizes: dict[str, int]) -> dict:
    """Saved int8 residuals on the ``target`` layout (``{key: (world,
    qpad)}``; the JAX package's ``_reconcile_residuals``): a key whose
    shape matches passes bitwise; every other saved key is decomposed
    into per-leaf pending corrections and the target's remaining keys are
    composed from them, rank 0's row carrying the debt; keys with nothing
    saved start at zero, saved keys the target lacks are dropped."""
    from tpu_dp_torch.parallel import bucketing, quant

    saved = saved if isinstance(saved, dict) else {}
    out, remap, used = {}, [], set()
    for key, shape in target.items():
        got = saved.get(key)
        if got is not None and np.asarray(got).shape == tuple(shape):
            out[key] = np.asarray(got, np.float32)
            used.add(key)
        else:
            remap.append((key, np.zeros(shape, np.float32)))
    if remap:
        sizes = {k: leaf_sizes[k]
                 for key in list(saved) + [k for k, _ in remap]
                 for k in bucketing.composition(key) if k in leaf_sizes}
        pending: dict = {}
        for key, got in saved.items():
            if key not in used:
                pending.update(quant.decompose_residual(got, sizes, key))
        for key, like in remap:
            out[key] = quant.compose_residual(pending, like, sizes, key)
    return out


def _restore_sharded(opt, raw: dict) -> None:
    """A decoded payload's momentum and residuals, relaid onto the sharded
    update ``opt``'s world, into ``opt`` (this rank's slice). The global
    arrays stay on ``opt.restored`` for a resume to broadcast."""
    from tpu_dp_torch.parallel.collectives import padded_size

    saved_opt = raw.get("opt_state") or {}
    mom = {}
    if opt.momentum:
        for key, n in opt.leaves:
            got = _leaf(saved_opt, key)
            if got is None:
                raise KeyError(f"opt_state has no leaf {key}")
            size = np.asarray(got).size
            if size < n:
                raise ValueError(f"opt_state leaf {key}: {size} elements, "
                                 f"the parameter has {n}")
            mom[key] = _relayout_opt_leaf(
                got, (padded_size(n, opt.world),), key)
    elif saved_opt:
        raise ValueError("checkpoint carries momentum buffers; the optimizer "
                         "has momentum 0")
    residuals = _reconcile_residuals(
        raw.get("residuals") or {},
        {k: (opt.world, v.numel()) for k, v in opt.residuals.items()},
        dict(opt.leaves))
    opt.load_state(mom, residuals)
    opt.restored = (mom, residuals)


def restore_state(target, raw: Any):
    """Load a decoded TrainState payload into ``target`` (a port
    `TrainState`) in place: parameters and statistics into the model,
    momentum buffers into the optimizer, the step. Everything is checked
    before anything is written. The momentum may be in either layout and
    any world (relaid onto the target's); int8 residuals are reconciled
    onto a sharded target's layout and dropped by a target without the
    codec, as the JAX package drops them."""
    if not isinstance(raw, dict) or not {"step", "params"} <= set(raw):
        raise ValueError("not a TrainState checkpoint (no step/params)")
    model, opt = target.model, target.optimizer
    state = convert_variables({"params": raw["params"],
                               "batch_stats": raw.get("batch_stats") or {}})
    check_state_dict(model, state)
    if _sharded(opt):
        step = int(np.asarray(raw["step"]))
        _restore_sharded(opt, raw)
        model.load_state_dict(state, strict=True)
        target.step = step
        return target
    named = dict(model.named_parameters())
    saved_opt = raw.get("opt_state") or {}
    if saved_opt:
        # A sharded save's flat leaves onto the parameters' JAX shapes.
        saved_opt = _map_leaves(saved_opt, raw["params"])
    if _momentum(opt) == 0.0:
        if saved_opt:
            raise ValueError("checkpoint carries momentum buffers; the "
                             "optimizer has momentum 0")
        bufs = {}
    else:
        bufs = convert_grads(saved_opt)
        if set(bufs) != set(named):
            raise KeyError(f"opt_state leaves {sorted(set(bufs) ^ set(named))}"
                           f" do not match the parameters")
        for k, v in bufs.items():
            if tuple(v.shape) != tuple(named[k].shape):
                raise ValueError(f"momentum of {k}: shape {tuple(v.shape)}")
    step = int(np.asarray(raw["step"]))
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        for name, buf in bufs.items():
            # In place: a captured CUDA graph of the step holds the live
            # buffer's address.
            p = named[name]
            live = opt.state[p].get("momentum_buffer")
            if live is None:
                opt.state[p]["momentum_buffer"] = buf.to(p.device, p.dtype)
            else:
                live.copy_(buf)
    target.step = step
    return target


# -- integrity -------------------------------------------------------------


def _map_leaves(saved: dict, params: dict) -> dict:
    """``saved`` (a params-shaped tree) with each leaf relaid onto the
    shape of ``params``' leaf at the same path."""
    out = {}
    for k, v in saved.items():
        like = params.get(k) if isinstance(params, dict) else None
        if isinstance(v, dict):
            out[k] = _map_leaves(v, like or {})
        else:
            out[k] = (v if like is None else
                      _relayout_opt_leaf(v, np.asarray(like).shape, k))
    return out


def _leaf_sha256(leaf) -> str:
    """sha256 over one host leaf's dtype, shape and bytes (the JAX
    package's hash: ``'float32'``, ``'(3, 3, 16, 16)'``, ``'()'``)."""
    arr = np.asarray(leaf)
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _walk_state_dict(node, prefix: str = ""):
    """Depth-first ``(path, leaf)`` pairs, paths '/'-joined, keys sorted."""
    if isinstance(node, dict):
        for key in sorted(node):
            yield from _walk_state_dict(
                node[key], f"{prefix}/{key}" if prefix else str(key))
    else:
        yield prefix, node


def _integrity_manifest(payload: bytes, tree) -> dict[str, Any]:
    return {
        "algo": "sha256",
        "payload_sha256": hashlib.sha256(payload).hexdigest(),
        "leaves": {path: _leaf_sha256(leaf)
                   for path, leaf in _walk_state_dict(tree)},
    }


def read_meta(ckpt_dir: str | os.PathLike) -> dict[str, Any]:
    """A save dir's meta.json, schema-checked ({} when absent)."""
    meta_path = Path(ckpt_dir) / _META_NAME
    if not meta_path.exists():
        return {}
    meta = json.loads(meta_path.read_text())
    schema = meta.get("schema", 1)
    if schema not in KNOWN_SCHEMAS:
        raise CheckpointSchemaError(
            f"checkpoint {ckpt_dir} declares schema {schema!r}; this build "
            f"knows {KNOWN_SCHEMAS} — refusing to guess at its layout")
    return meta


def verify_payload(payload: bytes, meta: dict[str, Any],
                   where: str | os.PathLike) -> None:
    """Verify ``payload`` against the meta's integrity manifest; raise
    `CorruptCheckpointError` naming the divergent leaves (when the payload
    still parses). A schema-1 save is counted and loads unverified."""
    integrity = meta.get("integrity") if meta.get("schema", 1) >= 2 else None
    if not integrity:
        _counters.inc("ckpt.unverified_loads")
        return
    if hashlib.sha256(payload).hexdigest() == integrity.get("payload_sha256"):
        _counters.inc("ckpt.verified_loads")
        return
    _counters.inc("ckpt.checksum_failures")
    bad: list[str] = []
    parses = True
    try:
        want = integrity.get("leaves") or {}
        for path, leaf in _walk_state_dict(
                serialization.msgpack_restore(payload)):
            if path in want and _leaf_sha256(leaf) != want[path]:
                bad.append(path)
    except (ValueError, TypeError):
        parses = False
    detail = (f"divergent leaves {bad[:8]}" if bad
              else "payload torn/unparseable" if not parses
              else "payload bytes differ from the saved manifest")
    raise CorruptCheckpointError(
        f"checkpoint {where} failed sha256 verification ({detail}) — "
        f"refusing to restore corrupt state", path=str(where),
        leaves=tuple(bad))


# -- writing ---------------------------------------------------------------


def _chaos_shim():
    """The storage-fault shim, iff armed (`faultinject.storage_shim`,
    imported at call time: the resilience package imports this module)."""
    from tpu_dp_torch.resilience.faultinject import storage_shim

    return storage_shim()


def _io_retry(fn, describe: str):
    """Run one write under the unified IO retry budget
    (``resilience.io_retry_s``): a transient EIO is a retry, not a lost
    save. Exhaustion re-raises the last OSError."""
    from tpu_dp_torch.resilience.retry import io_retry_params, retry_call

    retries, base_delay = io_retry_params()
    return retry_call(fn, retries=retries, base_delay=base_delay,
                      retry_on=(OSError,), jitter=0.5, describe=describe)


def _atomic_write_state(ckpt_dir: Path, tree, meta: dict[str, Any] | None
                        ) -> Path:
    """tmp + rename for the payload, then for the meta (stamped with the
    schema and the integrity block), retried on the IO budget with the
    shim's ``on_write`` seam inside and its ``post_commit`` seam after;
    clears a stale quarantine marker."""
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    payload = serialization.to_bytes(tree)
    meta_out = dict(meta or {})
    meta_out["schema"] = CKPT_SCHEMA
    meta_out["integrity"] = _integrity_manifest(payload, tree)
    meta_text = json.dumps(meta_out, indent=2, default=str)

    def _write():
        shim = _chaos_shim()
        if shim is not None:
            shim.on_write(ckpt_dir / _CKPT_NAME)
        tmp = ckpt_dir / (_CKPT_NAME + ".tmp")
        tmp.write_bytes(payload)
        os.replace(tmp, ckpt_dir / _CKPT_NAME)
        meta_tmp = ckpt_dir / (_META_NAME + ".tmp")
        meta_tmp.write_text(meta_text)
        os.replace(meta_tmp, ckpt_dir / _META_NAME)

    _io_retry(_write, describe=f"checkpoint write {ckpt_dir.name}")
    shim = _chaos_shim()
    if shim is not None:
        shim.post_commit(ckpt_dir)
    try:
        (ckpt_dir / QUARANTINED_MARKER).unlink()
    except FileNotFoundError:
        pass
    return ckpt_dir / _CKPT_NAME


def save_checkpoint(ckpt_dir: str | os.PathLike, state,
                    meta: dict[str, Any] | None = None) -> Path | None:
    """Write ``state`` and ``meta``; rank 0 writes. Returns the payload path
    (None on other ranks). A sharded state's save is a collective: every
    rank calls it."""
    if process_index() != 0:
        if _sharded(state.optimizer):
            state.optimizer.gather_state()
        return None
    return _atomic_write_state(Path(ckpt_dir), state_dict_of(state), meta)


def read_checkpoint(ckpt_dir: str | os.PathLike, verify: bool = True
                    ) -> tuple[Any, dict[str, Any]]:
    """``(decoded payload, meta)`` of one save dir, verified."""
    ckpt_dir = Path(ckpt_dir)
    meta = read_meta(ckpt_dir)
    payload = (ckpt_dir / _CKPT_NAME).read_bytes()
    if verify:
        verify_payload(payload, meta, ckpt_dir)
    return serialization.msgpack_restore(payload), meta


def load_checkpoint(ckpt_dir: str | os.PathLike, target, verify: bool = True
                    ) -> tuple[Any, dict[str, Any]]:
    """Restore ``target`` (a port `TrainState`) in place from one save dir;
    returns ``(target, meta)``. Schema-checked and, unless ``verify=False``,
    verified against the integrity manifest."""
    raw, meta = read_checkpoint(ckpt_dir, verify)
    return restore_state(target, raw), meta


def checkpoint_exists(ckpt_dir: str | os.PathLike) -> bool:
    return (Path(ckpt_dir) / _CKPT_NAME).exists()


def missing_save_files(step_dir: str | os.PathLike) -> list[str]:
    """Required save files absent from ``step_dir``; empty = complete. The
    one definition of completeness the manager and the resume scan share."""
    d = Path(step_dir)
    return [name for name in (_CKPT_NAME, _META_NAME)
            if not (d / name).exists()]


class CheckpointManager:
    """Step-numbered checkpoints with retention and asynchronous writes.

    Each save lands in ``<dir>/step_<n:010d>``; the ``latest`` pointer is
    flipped after the write is complete; ``keep`` bounds the step dirs (0
    keeps all). With ``async_save`` the host snapshot is taken on the
    caller's thread and the encode and IO run on a worker thread; `wait`
    joins it and re-raises its failure (so does the next save). Rank 0
    writes; other ranks return at once. ``last_save`` holds the newest
    save's ``blocking_ms`` on the caller's thread (``wait_ms`` for the
    previous write, then ``snapshot_ms`` for the device-to-host copy),
    ``write_ms`` (encode + IO, on the worker) and ``payload_bytes``.
    """

    def __init__(self, ckpt_dir: str | os.PathLike, keep: int = 3,
                 async_save: bool = True):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = int(keep)
        self.async_save = bool(async_save)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_save: dict[str, float] = {}

    def step_dirs(self) -> list[Path]:
        """Every ``step_<n>`` dir under the root, oldest first, complete or
        not."""
        if not self.ckpt_dir.exists():
            return []
        dirs = [p for p in self.ckpt_dir.iterdir()
                if p.is_dir() and re.fullmatch(r"step_\d+", p.name)]
        return sorted(dirs, key=lambda p: int(p.name.split("_")[1]))

    def wait(self) -> None:
        """Join the in-flight write; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint write to {self.ckpt_dir} failed") from err

    def save(self, state, meta: dict[str, Any] | None = None,
             step: int | None = None, host_tree=None,
             ready=None) -> Path | None:
        """Checkpoint ``state`` under ``step_<n>`` (n defaults to
        ``state.step``); returns the payload path on rank 0. A sharded
        state's snapshot is a collective: every rank calls this.
        ``host_tree`` hands over a host copy already taken (the snapshot
        manager's reusable buffers; untouched until the next save or
        wait), and ``ready`` a CUDA event the writer waits on before it
        encodes (the copy into that tree was enqueued, not finished)."""
        if process_index() != 0:
            if host_tree is None and _sharded(state.optimizer):
                state.optimizer.gather_state()
            return None
        t0 = time.perf_counter()
        self.wait()
        t1 = time.perf_counter()
        n = int(state.step) if step is None else int(step)
        step_dir = self.ckpt_dir / f"step_{n:010d}"
        tree = state_dict_of(state) if host_tree is None else host_tree
        record = self.last_save = {
            "wait_ms": 1e3 * (t1 - t0),
            "snapshot_ms": 1e3 * (time.perf_counter() - t1)}

        def _write():
            t = time.perf_counter()
            if ready is not None:
                ready.synchronize()
            path = _atomic_write_state(step_dir, tree, meta)
            record["payload_bytes"] = path.stat().st_size

            # The pointer flip is the save's commit: same retry and seam.
            def _publish():
                shim = _chaos_shim()
                if shim is not None:
                    shim.on_write(self.ckpt_dir / "latest")
                ptr_tmp = self.ckpt_dir / "latest.tmp"
                ptr_tmp.write_text(step_dir.name)
                os.replace(ptr_tmp, self.ckpt_dir / "latest")

            _io_retry(_publish, describe=f"publish latest={step_dir.name}")
            if self.keep > 0:
                for old in self.step_dirs()[: -self.keep]:
                    if old != step_dir:
                        shutil.rmtree(old, ignore_errors=True)
            record["write_ms"] = 1e3 * (time.perf_counter() - t)

        if self.async_save:
            def _guarded():
                try:
                    _write()
                except Exception as e:  # surfaced by the next wait()
                    self._error = e

            self._thread = threading.Thread(
                target=_guarded, name="tpu_dp_torch-ckpt", daemon=True)
            self._thread.start()
        else:
            _write()
        record["blocking_ms"] = 1e3 * (time.perf_counter() - t0)
        return step_dir / _CKPT_NAME

    def close(self) -> None:
        """Join the in-flight write (re-raising its failure)."""
        self.wait()

    def complete_dirs(self) -> list[Path]:
        """Every step dir holding a complete save, oldest first."""
        return [d for d in self.step_dirs() if not missing_save_files(d)]

    def latest_dir(self) -> Path | None:
        """The newest complete save: the ``latest`` pointer when it names a
        complete dir, else the newest complete dir; None when there is
        none."""
        ptr = self.ckpt_dir / "latest"
        if ptr.exists():
            name = ptr.read_text().strip()
            if name and not missing_save_files(self.ckpt_dir / name):
                return self.ckpt_dir / name
            if name:
                log.warning("checkpoint pointer %s names incomplete dir %s; "
                            "falling back to the newest complete save",
                            ptr, name)
        dirs = self.complete_dirs()
        return dirs[-1] if dirs else None

    def restore(self, target) -> tuple[Any, dict[str, Any]]:
        """Restore the newest complete save into ``target``."""
        self.wait()
        latest = self.latest_dir()
        if latest is None:
            raise FileNotFoundError(f"no checkpoint under {self.ckpt_dir}")
        return load_checkpoint(latest, target)


def resolve_ckpt_dir(ckpt_dir: str | os.PathLike) -> Path:
    """One ``step_*`` save dir, or a manager root resolved to its newest
    complete save."""
    ckpt_dir = Path(ckpt_dir)
    if checkpoint_exists(ckpt_dir):
        return ckpt_dir
    latest = CheckpointManager(ckpt_dir).latest_dir()
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return latest


def load_params_only(ckpt_dir: str | os.PathLike
                     ) -> tuple[dict, dict, dict[str, Any]]:
    """Serving-side restore: ``(params, batch_stats, meta)`` (flax trees of
    numpy arrays) of a verified training checkpoint; the optimizer state
    and residuals are never converted or placed."""
    ckpt_dir = Path(ckpt_dir)
    raw, meta = read_checkpoint(ckpt_dir)
    if not isinstance(raw, dict) or "params" not in raw:
        raise ValueError(
            f"{ckpt_dir / _CKPT_NAME} is not a TrainState checkpoint (no "
            f"'params' subtree) — for a bare `save_params` export use "
            f"`load_params`")
    return raw["params"], raw.get("batch_stats") or {}, meta


def save_params(path: str | os.PathLike, params) -> Path | None:
    """The end-of-training params export (a flax params tree, e.g.
    ``export_params(dict(model.named_parameters()))``); rank 0 only."""
    if process_index() != 0:
        return None
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = serialization.to_bytes(params)

    def _write():
        shim = _chaos_shim()
        if shim is not None:
            shim.on_write(path)
        path.write_bytes(payload)

    _io_retry(_write, describe=f"export params {path.name}")
    return path


def load_params(path: str | os.PathLike, model: torch.nn.Module):
    """Load a `save_params` export into ``model``'s parameters (every name
    and shape must match); returns the model."""
    params = serialization.msgpack_restore(Path(path).read_bytes())
    named = dict(model.named_parameters())
    values = convert_grads(params)
    if set(values) != set(named):
        raise KeyError(f"params {sorted(set(values) ^ set(named))} do not "
                       f"match the model")
    with torch.no_grad():
        for k, v in values.items():
            if tuple(v.shape) != tuple(named[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)}")
        for k, v in values.items():
            named[k].copy_(v)
    return model
