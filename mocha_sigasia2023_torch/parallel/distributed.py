"""Process-group set-up for data parallelism over several processes.

Counterpart of mocha_sigasia2023_tpu/parallel/distributed.py on
``torch.distributed``.  One process is one rank, and each rank computes on
one device.  :func:`initialize_multihost` wires a rank into the group,
from its arguments or from the variables ``torchrun`` sets (``MASTER_ADDR``
/ ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``);
:func:`spawn` starts ``n`` ranks on this host with ``torch.multiprocessing``
and does the same in each.

The backend: ``nccl`` when each rank has a CUDA device of its own,
``gloo`` otherwise (CPU tensors, or several ranks sharing one card: gloo
takes their CUDA tensors as they are).  NCCL refuses two ranks on
one device; asking for it there raises before the first collective.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str, given):
    if given is not None:
        return int(given)
    return int(os.environ[name]) if name in os.environ else None


def rank_device(local_rank: int = 0, device=None) -> torch.device:
    """The device of the rank with ``local_rank`` on its host: ``device``
    when given (``"cpu"``, ``"cuda"`` or ``"cuda:i"``), else the CUDA
    device ``local_rank`` modulo the visible cards.  Raises without CUDA
    unless the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def default_backend(dev: torch.device, local_world_size: int) -> str:
    """``nccl`` when the ranks of a host each have a CUDA device of their
    own, else ``gloo``."""
    if dev.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _check_distinct_devices(dev: torch.device, backend: str) -> None:
    """Under nccl, raise when another rank computes on this rank's card
    (NCCL fails such a group at its first collective, with a message about
    duplicate GPUs)."""
    if backend != "nccl":
        return
    store = dist.distributed_c10d._get_default_store()
    me = f"{socket.gethostname()}:{dev}"
    rank, world = dist.get_rank(), dist.get_world_size()
    store.set(f"mocha_rank_device_{rank}", me)
    for r in range(world):
        if r != rank and store.get(f"mocha_rank_device_{r}").decode() == me:
            dist.destroy_process_group()
            raise RuntimeError(
                f"ranks {min(r, rank)} and {max(r, rank)} both compute on "
                f"{dev} of {socket.gethostname()}: NCCL takes one rank a "
                "device; give each rank a card of its own, or use the "
                "'gloo' backend for ranks that share one")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device=None) -> torch.device:
    """Join this process to the process group; returns the device it
    computes on (also made the current CUDA device).

    ``coordinator_address`` is ``host:port`` of rank 0 (default
    ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` the world size
    (``WORLD_SIZE``), ``process_id`` this rank (``RANK``).  ``device``
    defaults to the CUDA device ``LOCAL_RANK`` (0 without it) modulo the
    visible cards; ``backend`` to :func:`default_backend` of it, with
    ``LOCAL_WORLD_SIZE`` (the world size without it) ranks on this host.
    """
    world = _env_int("WORLD_SIZE", num_processes)
    rank = _env_int("RANK", process_id)
    if world is None or rank is None:
        raise ValueError("initialize_multihost: give num_processes and "
                         "process_id, or set WORLD_SIZE and RANK")
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ or "MASTER_PORT" not in os.environ:
            raise ValueError("initialize_multihost: give coordinator_address"
                             " ('host:port'), or set MASTER_ADDR and "
                             "MASTER_PORT")
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    local_rank = _env_int("LOCAL_RANK", None)
    local_world = _env_int("LOCAL_WORLD_SIZE", None) or world
    dev = rank_device(rank if local_rank is None else local_rank, device)
    backend = backend or default_backend(dev, local_world)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"initialize_multihost: the nccl backend reduces "
                         f"CUDA tensors only; {dev} ranks take 'gloo'")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(0, device=dev)      # the device is initialized here
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    _check_distinct_devices(dev, backend)
    return dev


def is_primary_host() -> bool:
    """Rank 0 of the group, or True when no group is initialized."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(rank, fn, nprocs, port, backend, device, threads, args):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(nprocs), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
    torch.set_num_threads(threads)
    dev = initialize_multihost(backend=backend, device=device)
    try:
        fn(rank, dev, *args)
    finally:
        shutdown()


def spawn(fn, nprocs: int, args=(), *, backend: Optional[str] = None,
          device=None, threads: Optional[int] = None) -> None:
    """Run ``fn(rank, device, *args)`` in ``nprocs`` new processes, each a
    rank of one group on localhost (:func:`initialize_multihost` with
    ``backend`` and ``device``), and wait for them.  ``fn`` must be
    importable by name (a module-level function).  ``threads`` sets each
    rank's torch thread count (default: this host's cores over
    ``nprocs``).  A rank that raises makes this raise, after the other
    ranks are stopped."""
    import torch.multiprocessing as mp

    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // nprocs)
    mp.spawn(_spawned, args=(fn, nprocs, free_port(), backend, device,
                             threads, tuple(args)),
             nprocs=nprocs, join=True)
