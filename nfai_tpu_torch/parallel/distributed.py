"""Process-group initialisation for the mesh (one process a rank).

Counterpart of nfai_tpu/parallel/distributed.py. The JAX package is one
controller per host; the port is one process per device, PyTorch's idiom:
every rank runs the same program, and `torch.distributed` joins them.
`init_distributed` reads the same arguments or environment variables as the
JAX function (``NFAI_COORD``, ``NFAI_NUM_PROCS``, ``NFAI_PROC_ID``) and
returns False when no coordinator is given.

Typical launch (2 hosts, one rank each; more ranks a host each set their own
NFAI_PROC_ID):
    # host 0
    NFAI_COORD=host0:8476 NFAI_NUM_PROCS=2 NFAI_PROC_ID=0 python -m nfai_tpu_torch.server --mesh tp=2 ...
    # host 1
    NFAI_COORD=host0:8476 NFAI_NUM_PROCS=2 NFAI_PROC_ID=1 python -m nfai_tpu_torch.server --mesh tp=2 ...

On one host the CLI and the server start their own ranks (`spawn_local`):
`--mesh tp=2` alone is enough.

The coordinator is ``host:port`` (a TCP store served by rank 0) or
``file:///path`` (a file store, for ranks on one host). The backend
defaults to NCCL on CUDA and gloo on the CPU; the caller may pass "gloo" on
CUDA. NCCL cannot hold two ranks of one communicator on one device, so
before the group is made every rank registers (host, device) in the store
and a device claimed twice raises on every rank, naming gloo: the port
never switches backend on its own. Every group has a finite timeout
(`timeout_s`, default `DEFAULT_TIMEOUT_S` or ``NFAI_DIST_TIMEOUT``), so a
dead rank ends a run with an error instead of hanging it.
"""
from __future__ import annotations

import datetime
import importlib
import logging
import os
import socket
import time

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 300.0


def _timeout(timeout_s: float | None) -> datetime.timedelta:
    if timeout_s is None:
        timeout_s = float(os.environ.get("NFAI_DIST_TIMEOUT", DEFAULT_TIMEOUT_S))
    return datetime.timedelta(seconds=timeout_s)


def _store(address: str, world: int, rank: int, timeout: datetime.timedelta) -> dist.Store:
    if address.startswith("file://"):
        return dist.FileStore(address[len("file://"):], world)
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {address!r}: use host:port or file:///path")
    return dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=timeout)


def local_device_index(rank: int) -> int:
    """The CUDA device rank `rank` runs on: rank % the visible device count."""
    return rank % torch.cuda.device_count()


def _check_devices(store: dist.Store, world: int, rank: int, timeout: datetime.timedelta) -> None:
    """Under NCCL: every rank adds itself to its (host, device) key, waits
    for all ranks, and raises if its device was claimed twice."""
    key = f"nfai/device/{socket.gethostname()}/{local_device_index(rank)}"
    store.add(key, 1)
    store.add("nfai/device_checked", 1)
    deadline = time.monotonic() + timeout.total_seconds()
    while store.add("nfai/device_checked", 0) < world:
        if time.monotonic() > deadline:
            raise TimeoutError("not every rank reached the device check")
        time.sleep(0.01)
    if (n := store.add(key, 0)) > 1:
        raise RuntimeError(
            f"{n} ranks share CUDA device {local_device_index(rank)} on {socket.gethostname()}: "
            "NCCL takes one rank a device; pass backend='gloo' to run several ranks on one device")


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout_s: float | None = None,
) -> bool:
    """Join this process to the world from the arguments or NFAI_COORD /
    NFAI_NUM_PROCS / NFAI_PROC_ID. Returns True if a world was joined, False
    without a coordinator. `backend` None: "nccl" where CUDA is available,
    else "gloo"."""
    coordinator_address = coordinator_address or os.environ.get("NFAI_COORD")
    if not coordinator_address:
        return False
    num_processes = num_processes or int(os.environ.get("NFAI_NUM_PROCS", "1"))
    process_id = process_id if process_id is not None else int(os.environ.get("NFAI_PROC_ID", "0"))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    timeout = _timeout(timeout_s)
    store = _store(coordinator_address, num_processes, process_id, timeout)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs CUDA; use 'gloo' on the CPU")
        _check_devices(store, num_processes, process_id, timeout)
        torch.cuda.set_device(local_device_index(process_id))
    dist.init_process_group(backend, store=store, world_size=num_processes, rank=process_id,
                            timeout=timeout)
    log.info("torch.distributed: rank %d/%d, backend %s, via %s", process_id, num_processes,
             backend, coordinator_address)
    return True


def free_port() -> int:
    """A TCP port on localhost that was free when asked (for one host's world)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def leave_world() -> None:
    """Destroy this process's groups, if it joined a world: a rank that
    exits with its gloo groups alive may abort in their threads' teardown."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(target: str, argv, env: dict) -> None:
    os.environ.update(env)
    module, _, fn = target.partition(":")
    try:
        code = getattr(importlib.import_module(module), fn)(argv)
    finally:
        leave_world()
    raise SystemExit(code)


def spawn_local(target: str, argv: list[str], world: int) -> list:
    """Start ranks 1 .. world - 1 of a one-host world as processes running
    `target(argv)` ("module:function", a module's `main`), and set this
    process up as rank 0:
    NFAI_COORD (a free localhost port), NFAI_NUM_PROCS and NFAI_PROC_ID in
    each process's environment. Returns the processes (`join_local` ends
    them)."""
    import torch.multiprocessing as mp

    coord = f"127.0.0.1:{free_port()}"
    base = {"NFAI_COORD": coord, "NFAI_NUM_PROCS": str(world)}
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(1, world):
        p = ctx.Process(target=_rank_main, args=(target, argv, {**base, "NFAI_PROC_ID": str(rank)}))
        p.start()
        procs.append(p)
    os.environ.update({**base, "NFAI_PROC_ID": "0"})
    return procs


def start_world(mesh_shape: dict[str, int], target: str, argv: list[str], device: str = "cuda") -> list:
    """The CLI's and the server's world for `mesh_shape` (nothing without
    one). With NFAI_COORD set this process is one rank of a launch the user
    started; else it becomes rank 0 of a one-host world and spawns the other
    ranks (`spawn_local`): as many as the mesh's fixed sizes multiply to (an
    axis of -1 takes the visible CUDA devices). Returns the spawned
    processes (`join_local` ends them). The backend: gloo on the CPU, NCCL
    on CUDA (one rank a card)."""
    if not mesh_shape:
        return []
    procs = []
    if not os.environ.get("NFAI_COORD"):
        world = 1
        for v in mesh_shape.values():
            world *= v if v != -1 else 1
        if -1 in mesh_shape.values():
            if device != "cuda":
                raise ValueError(f"mesh {mesh_shape}: give every axis a size on the CPU")
            world = torch.cuda.device_count()
        procs = spawn_local(target, argv, world)
    try:
        init_distributed(backend="gloo" if device == "cpu" else "nccl")
    except BaseException:
        join_local(procs, 0.0)
        raise
    return procs


def join_local(procs: list, timeout_s: float = 60.0) -> list[int | None]:
    """Wait for spawned ranks (each at most `timeout_s`), terminate any that
    still run, leave the world (`leave_world`), and return their exit
    codes."""
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(5)
    leave_world()
    return [p.exitcode for p in procs]
