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

Elastic world size (`tpu_dp_torch.resilience.elastic`): `elastic_initialize`
forms a membership epoch's group at the address its record publishes (a
fresh store every epoch, opened by the member that publishes the address
at a port the OS assigns, `open_rendezvous_store`: a reused store would
collide with the old group), on the backend the run started with;
`abandon_distributed` walks away from the old group; `agree_token` and
`membership_barrier` agree a string and meet over the current group's
store (host-level, no device collective); `fault_tolerant_barrier` is the
preemption exit's bounded barrier.

A peer that vanishes (the rollback regroup): `is_peer_failure` tells the
errors that mean "a peer is gone" from every other (the JAX package's
`_elastic_fatal_errors`). No wait on a peer may outlast a share of the
collection window (`PEER_WAIT_SHARE`), or a live member blocked on a rank
that already checked in would be declared departed: a gloo collective
gets that timeout (`set_collective_timeout`; gloo's ``abort`` closes no
socket, and its sockets close only when the group object is freed, which
never happens once DDP has been built over it), and an NCCL window
boundary waits on the card through `PeerFence`; wedged work is ended by
the communicators' abort (`abort_communicators`) before the group is
destroyed.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import time

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
    process runs alone, without a group), the ``device`` it drives and
    the rendezvous's ``host:port`` when it has one (a ``file://``
    rendezvous has none)."""

    rank: int
    world: int
    local_rank: int
    backend: str | None
    device: torch.device
    coordinator_address: str | None = None

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
        address = where
    else:
        where = init_method
        address = (init_method[len("tcp://"):]
                   if init_method.startswith("tcp://") else None)
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
    _ctx = DistContext(rnk, world, local, backend, dev, address)
    return _ctx


def shutdown() -> None:
    """Destroy the process group, if this process joined one, and free what
    referred to it (`collect_released`; the caller drops its own
    references first)."""
    global _ctx
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _ctx = None
    collect_released()


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


def fault_tolerant_barrier(retries: int = 2,
                           base_delay: float = 0.05) -> None:
    """`barrier` with bounded retry and a typed terminal failure: the
    preemption exit must not hang on a half-dead group, nor report an
    untyped error. Persistent failure raises `PeerFailedError` naming
    this rank."""
    from tpu_dp_torch.resilience.retry import PeerFailedError, retry_call

    try:
        retry_call(barrier, retries=retries, base_delay=base_delay,
                   describe="group barrier")
    except Exception as e:
        raise PeerFailedError(
            f"barrier failed on process {process_index()}/"
            f"{process_count()} after {retries + 1} attempts: {e}",
            rank=process_index(), world=process_count()) from e


def current_context() -> "DistContext | None":
    """This process's `DistContext`, or None before it joined a group (an
    abandoned group's context is kept for the next epoch's)."""
    return _ctx


def open_rendezvous_store(host: str, timeout_s: float = DEFAULT_TIMEOUT_S):
    """A membership epoch's rendezvous store, listening from now on at a
    port of ``host`` the OS assigns (``.port``): the member that publishes
    the epoch's address opens it before it publishes and hands it to
    `elastic_initialize`, so no other process can take the port between
    the publish and the rendezvous."""
    return dist.TCPStore(host, 0, None, True,
                         timeout=datetime.timedelta(seconds=timeout_s),
                         wait_for_workers=False)


def elastic_initialize(coordinator_address: str | None, num_processes: int,
                       process_id: int, backend: str, device,
                       timeout_s: float = DEFAULT_TIMEOUT_S, store=None,
                       host_service: bool = False) -> DistContext:
    """Form (or re-form) the group of one membership epoch: ``process_id``
    of ``num_processes`` meeting at ``coordinator_address`` (``host:port``
    from the epoch's record), on ``backend`` and ``device`` (the process
    keeps its card and the run's backend). The service member
    (``host_service``) hosts the store: ``store``, the one it opened with
    `open_rendezvous_store` before it published the address, or one it
    binds at that address now; every other member connects to it as a
    client, waiting for it up to ``timeout_s``. A sole survivor (the
    record names no address) forms a group of one on a store of its own,
    so the run keeps its backend and its code path.
    Raises `DistInitError` when the rendezvous fails, and `RuntimeError`
    while a group is live (`abandon_distributed` first)."""
    global _ctx
    if dist.is_initialized():
        raise RuntimeError("elastic_initialize: a process group is live; "
                           "call abandon_distributed() first")
    if num_processes > 1 and not coordinator_address:
        raise DistConfigError(
            f"world {num_processes} needs the record's coordinator address")
    timeout = datetime.timedelta(seconds=timeout_s)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    where = f"tcp://{coordinator_address}"
    try:
        if num_processes == 1:
            store = open_rendezvous_store("127.0.0.1", timeout_s)
            coordinator_address = f"127.0.0.1:{store.port}"
        elif store is None:
            host, _, port = coordinator_address.rpartition(":")
            store = dist.TCPStore(host, int(port), None, host_service,
                                  timeout=timeout, wait_for_workers=False)
        dist.init_process_group(backend, store=store,
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    except (RuntimeError, ValueError, TimeoutError) as e:
        raise DistInitError(
            f"elastic process group ({backend}) at {where} failed for rank "
            f"{process_id} of {num_processes} within {timeout_s:g} s: "
            f"{e}") from e
    local = _ctx.local_rank if _ctx is not None else process_id
    _ctx = DistContext(process_id, num_processes, local, backend, dev,
                       coordinator_address)
    return _ctx


def abandon_distributed() -> None:
    """Walk away from the current group without a collective (a regroup's
    teardown): `torch.distributed.destroy_process_group` is local and stops
    the backend, so a peer that already left cannot hold it up. The context
    is kept for `elastic_initialize`, which takes its local rank; callers
    release what captured the old group's collectives (CUDA graphs) first,
    and drop what still refers to the group (`collect_released`)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


#: The share of an elastic run's collection window (``resilience.
#: regroup_timeout_s``) that a collective or a window fence may wait on a
#: peer: a live member blocked on a rank that failed first must fail, and
#: check in, well inside the window that rank's acting leader runs.
PEER_WAIT_SHARE = 1 / 3


def set_collective_timeout(timeout_s: float) -> None:
    """Set the current group's collective timeout (the rendezvous keeps
    its own): from here on a gloo collective waiting on a peer raises after
    ``timeout_s``. An elastic run sets it once its group is formed and its
    DDP built (their collectives keep the rendezvous's timeout)."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    pg = dist.group.WORLD
    td = datetime.timedelta(seconds=float(timeout_s))
    if hasattr(pg, "set_timeout"):
        pg.set_timeout(td)
    else:  # older torch: the backend's default
        pg._get_backend(torch.device("cpu"))._set_default_timeout(td)


#: The message prefix of the `RuntimeError` gloo raises when a peer's
#: connection closes or resets, or a transfer to it times out (torch 2.13:
#: ``[.../gloo/transport/tcp/pair.cc:537] Read error ... Connection reset
#: by peer``, ``pair.cc:553] Connection closed by peer``,
#: ``unbound_buffer.cc:78] Timed out waiting ...``): gloo types none of
#: them, so the transport's source path is what marks them.
GLOO_TRANSPORT_ERROR = "gloo/transport/"


def peer_failure_types() -> tuple[type[BaseException], ...]:
    """The exception types that mean "a peer is gone" (the JAX package's
    `_elastic_fatal_errors`): `PeerFailedError` (a bounded barrier or
    fence gave up) and torch's `DistBackendError` (NCCL's)."""
    from tpu_dp_torch.resilience.retry import PeerFailedError

    return (PeerFailedError, dist.DistBackendError)


def is_peer_failure(err: BaseException) -> bool:
    """True for an error that means "a peer is gone": one of
    `peer_failure_types`, or gloo's transport `RuntimeError`
    (`GLOO_TRANSPORT_ERROR`). Any other `RuntimeError` is not."""
    if isinstance(err, peer_failure_types()):
        return True
    return type(err) is RuntimeError and GLOO_TRANSPORT_ERROR in str(err)


def abort_communicators(timeout_s: float) -> None:
    """Abort the current group's communicators: under NCCL torch's
    ``_abort_process_group`` (``ncclCommAbort`` on every communicator of
    the group, within one NCCL group call, then the group unregistered),
    which ends the kernels that spin on a dead peer, so the card drains.
    NCCL's abort does not return while a CUDA graph that captured its work
    exists (torch 2.11, NCCL 2.28.9, on four H100s; `tools/
    port_nccl_abort_probe.py`): the caller releases the graphs alongside
    (`Trainer._end_wedged_window`). The abort runs on a helper thread and
    `ElasticError` is raised when it has not returned within
    ``timeout_s``. gloo's abort closes nothing (its sockets close
    when the group is freed): a no-op there, as without a group."""
    import threading

    from tpu_dp_torch.resilience.elastic import ElasticError

    if not (dist.is_available() and dist.is_initialized()):
        return
    if dist.get_backend() != "nccl":
        return
    aborter = threading.Thread(
        target=dist.distributed_c10d._abort_process_group, daemon=True)
    aborter.start()
    aborter.join(timeout_s)
    if aborter.is_alive():
        raise ElasticError(f"the NCCL communicators' abort did not return "
                           f"within {timeout_s:g} s")


class PeerFence:
    """The bounded wait of an elastic NCCL run's window boundary. A
    collective waiting on a dead peer spins on the card (inside a CUDA
    graph torch's watchdog does not see it), and the host would learn of
    it only at its next synchronisation, forever. `step` records an event
    after each window and waits, with a deadline, for the previous
    window's (one window stays in flight, so the host keeps running ahead
    of the card); `drain` waits for all the work issued so far (before a
    fetch or a save). A wait that passes ``timeout_s`` marks the fence
    ``wedged`` and raises `PeerFailedError`; the owner then ends the
    wedged work (`abort_communicators`) and `settle` waits, bounded, for
    the card to drain. Polls `torch.cuda.Event.query`, never
    ``synchronize``."""

    def __init__(self, device, timeout_s: float, poll_s: float = 0.002):
        self.device = torch.device(device)
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        self.wedged = False
        self._pending: list = []

    def step(self) -> None:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._pending.append(ev)
        while len(self._pending) > 1:
            self._wait(self._pending.pop(0))

    def drain(self) -> None:
        self.step()
        self._wait(self._pending.pop())

    def settle(self) -> None:
        """After the wedged work was aborted: the card drained within the
        deadline, or `ElasticError` (nothing on it can be trusted)."""
        from tpu_dp_torch.resilience.elastic import ElasticError

        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        if not self._poll(ev):
            raise ElasticError(
                f"the card did not drain within {self.timeout_s:g} s of the "
                f"communicators' abort")
        self._pending, self.wedged = [], False

    def _poll(self, ev) -> bool:
        deadline = time.monotonic() + self.timeout_s
        while not ev.query():
            if time.monotonic() > deadline:
                return False
            time.sleep(self.poll_s)
        return True

    def _wait(self, ev) -> None:
        from tpu_dp_torch.resilience.retry import PeerFailedError

        if not self._poll(ev):
            self._pending, self.wedged = [], True
            raise PeerFailedError(
                f"window fence: the card's work did not finish within "
                f"{self.timeout_s:g} s (a collective waiting on a dead "
                f"peer)", rank=process_index(), world=process_count())


def collect_released() -> None:
    """Free now what a released group leaves behind: objects that referred
    to it (a model's sync-BN, DDP's reducer, a sharded update) and are only
    reachable through reference cycles would otherwise keep the group's
    and its store's C++ objects until the interpreter's teardown, where
    destroying them can abort the exiting process ("terminate called
    without an active exception")."""
    import gc

    gc.collect()


#: The JAX package's end-of-run parking of its coordination objects: here
#: `shutdown` (a local destroy, then what referred to the group freed) is
#: all an elastic exit needs.
park_distributed = shutdown


def _store():
    """The current group's key-value store (the rendezvous's)."""
    return dist.distributed_c10d._get_default_store()


def agree_token(name: str, make, timeout_s: float = 60.0) -> str:
    """One string every process of the group agrees on: rank 0 mints it
    (``make()``) into the group's store, the others read it. The store
    belongs to this launch's rendezvous, so the token is unique per launch
    (the membership ledger keys its generation directory on it). Alone:
    ``make()``."""
    if not dist.is_initialized():
        return str(make())
    store = _store()
    key = f"tpu_dp:token:{name}"
    if dist.get_rank() == 0:
        token = str(make())
        store.set(key, token)
        return token
    store.wait([key], datetime.timedelta(seconds=timeout_s))
    return store.get(key).decode()


def membership_barrier(tag: str, epoch: int, timeout_s: float = 60.0) -> None:
    """Host-level barrier over the current membership epoch's group, on
    its store (no device collective: usable before the first step of a
    fresh epoch), with the membership epoch in the key so a straggler of
    epoch N cannot satisfy epoch N+1's. Raises `TimeoutError` when a
    member does not arrive within ``timeout_s``. Alone: a no-op."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    store = _store()
    key = f"tpu_dp:me{int(epoch)}:{tag}"
    world = dist.get_world_size()
    store.add(key, 1)
    deadline = time.monotonic() + timeout_s
    while int(store.add(key, 0)) < world:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"membership barrier {key!r}: {int(store.add(key, 0))} of "
                f"{world} arrived within {timeout_s:g} s")
        time.sleep(0.01)


def cross_rank_gather(payload, group=None):
    """Every rank's ``payload`` (a small numpy array of one shape and
    dtype on every rank), stacked ``[world, ...]`` in rank order, on every
    rank (port of the JAX package's `cross_rank_gather`, the guard's SDC
    audit transport). An all-gather, not a broadcast: every rank must see
    a divergence. The bytes travel as uint8 on a CPU tensor under gloo,
    on the rank's card under NCCL. Alone: the stack of one."""
    import numpy as np

    arr = np.ascontiguousarray(np.asarray(payload))
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return arr[None]
    dev = (_ctx.device if _ctx is not None and _ctx.backend == "nccl"
           else torch.device("cpu"))
    mine = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy()).to(dev)
    parts = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    raw = torch.stack(parts).cpu().numpy()
    return raw.view(arr.dtype).reshape((len(parts),) + arr.shape)


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
