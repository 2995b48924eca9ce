"""Process groups, device resolution and the run header (port of
`tpu_dp.parallel.dist`).

One process drives one device. `initialize` joins the process to its
group through ``torch.distributed.init_process_group`` and returns a
`DistContext`; the launcher's env contract (``torchrun`` and
``python -m torch.distributed.run`` set ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) is read when no
argument says otherwise. Without ``WORLD_SIZE`` and without arguments the
process runs alone and no group is made, as the JAX package runs one
process without a coordinator.

- The rank's device is ``cuda:LOCAL_RANK`` unless the caller names one;
  `initialize` sets it as the current device before the group makes any
  CUDA allocation (the kernels' ticket buffers are kept per device, and a
  rank that touched card 0 first would leave a context and buffers there).
- The backend is NCCL for a CUDA device and gloo for the CPU. A backend
  the caller names is taken as given (gloo on CUDA tensors runs two ranks
  on one card, where NCCL refuses them); nothing switches from one backend
  to the other on its own.
- A bounded ``timeout_s`` stands in for the JAX package's
  ``initialization_timeout``: a rendezvous that does not complete raises
  `DistInitError`, naming the address and the rank.

Elastic membership, parking, token agreement and fault-tolerant barriers
are not ported.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket

import torch
import torch.distributed as dist

#: seconds a rendezvous and every collective may take before they raise.
DEFAULT_TIMEOUT_S = 300.0

_ctx: "DistContext | None" = None


class DistConfigError(ValueError):
    """A rank, world size, local rank or init method that cannot form a
    group (bad env contract or arguments); raised before any rendezvous."""


class DistInitError(RuntimeError):
    """The rendezvous or the process group's creation failed."""


@dataclasses.dataclass(frozen=True)
class DistContext:
    """This process's place in the run: ``rank`` of ``world`` processes,
    ``local_rank`` on its host, the group's ``backend`` (None when the
    process runs alone, without a group) and the ``device`` it drives."""

    rank: int
    world: int
    local_rank: int
    backend: str | None
    device: torch.device

    @property
    def is_main_process(self) -> bool:
        return self.rank == 0

    @property
    def process_group(self):
        """The group the model's BatchNorms and the metrics reduce over:
        the default group when there is more than one rank, else None
        (their reductions are then the identity)."""
        return dist.group.WORLD if self.world > 1 else None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA card (``cuda:LOCAL_RANK`` once
    `initialize` has set it), and raises when there is none: an entry
    point never drops silently to the CPU. An explicit device (the tests
    pass ``"cpu"``) is taken as given.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _env_int(name: str) -> int | None:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        raise DistConfigError(f"{name}={raw!r} is not an integer") from None


def _rank_device(device, local_rank: int) -> torch.device:
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local_rank)
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    if local_rank >= torch.cuda.device_count():
        raise DistConfigError(
            f"LOCAL_RANK={local_rank} but {torch.cuda.device_count()} CUDA "
            f"device(s) are visible: one process drives one card")
    return torch.device("cuda", local_rank)


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               device=None) -> DistContext:
    """Join this process to its group; returns its `DistContext`.

    Explicit arguments win over the env contract (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``; ``env://`` reads ``MASTER_ADDR`` and
    ``MASTER_PORT``). With neither a world size nor an ``init_method`` the
    process runs alone: no group, world 1. ``device`` is the rank's
    device (default ``cuda:LOCAL_RANK``). A second call in a process that
    already joined returns the same context.
    """
    global _ctx
    if _ctx is not None:
        return _ctx
    world = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if world is None and init_method is None:
        return DistContext(0, 1, 0, None, resolve_device(device))
    world = 1 if world is None else int(world)
    rnk = rank if rank is not None else _env_int("RANK")
    if world < 1:
        raise DistConfigError(f"world size must be >= 1, got {world}")
    if rnk is None:
        if world > 1:
            raise DistConfigError(
                f"world size {world} needs a rank (RANK or rank=)")
        rnk = 0
    rnk = int(rnk)
    if not 0 <= rnk < world:
        raise DistConfigError(f"rank {rnk} out of range for world {world}")
    local = _env_int("LOCAL_RANK")
    local = rnk if local is None else local
    if local < 0:
        raise DistConfigError(f"LOCAL_RANK must be >= 0, got {local}")
    if init_method is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not (addr and port):
            raise DistConfigError(
                f"world size {world}: give init_method, or MASTER_ADDR and "
                f"MASTER_PORT")
        init_method, where = "env://", f"{addr}:{port}"
    else:
        where = init_method
    dev = _rank_device(device, local)
    if dev.type == "cuda":
        # Before the group allocates anything on a card.
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rnk,
            timeout=datetime.timedelta(seconds=timeout_s))
    except (RuntimeError, ValueError, TimeoutError) as e:
        raise DistInitError(
            f"process group ({backend}) at {where} failed for rank {rnk} of "
            f"{world} within {timeout_s:g} s: {e}") from e
    _ctx = DistContext(rnk, world, local, backend, dev)
    return _ctx


def shutdown() -> None:
    """Destroy the process group, if this process joined one."""
    global _ctx
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _ctx = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """Wait for every rank (no-op without a group)."""
    if not dist.is_initialized():
        return
    if _ctx is not None and _ctx.backend == "nccl":
        dist.barrier(device_ids=[_ctx.device.index])
    else:
        dist.barrier()


def broadcast_one_to_all(x, group=None):
    """Rank 0's ``x`` on every rank; the identity without a group.

    ``x`` is a list of tensors (broadcast in place, one ``broadcast``
    each: NCCL for CUDA tensors, gloo for CPU ones, as the group's backend
    says) or any picklable object (``broadcast_object_list``, through the
    rank's device under NCCL). Every rank passes the same kind of ``x``,
    tensors of equal shapes and dtypes."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x
    if isinstance(x, list) and x and all(
            isinstance(t, torch.Tensor) for t in x):
        for t in x:
            dist.broadcast(t, src=0, group=group)
        return x
    box = [x]
    dev = (_ctx.device if _ctx is not None and _ctx.backend == "nccl"
           else None)
    dist.broadcast_object_list(box, src=0, group=group, device=dev)
    return box[0]


def describe(device=None) -> dict:
    """Topology summary for the run header: what this process drives, and
    its place in the group."""
    if device is None and _ctx is not None:
        device = _ctx.device
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    return {
        "rank": process_index(),
        "world": process_count(),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "devices": torch.cuda.device_count() if cuda else 1,
        "device_kind": (torch.cuda.get_device_name(dev) if cuda
                        else "cpu"),
        "platform": "gpu" if cuda else "cpu",
        "device": str(dev),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "host": socket.gethostname(),
        "host_cpus": os.cpu_count(),
    }
