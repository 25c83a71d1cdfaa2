"""Multi-process initialisation, each rank's device, and a local launcher.

Counterpart of `petr_tpu/parallel/distributed.py`. petr_tpu runs one JAX
process per host and ``jax.distributed.initialize`` wires them; here one
process per card (a rank) joins a ``torch.distributed`` process group over
TCP, with an explicit backend: ``nccl`` on cards (the default there),
``gloo`` on the CPU, or for several ranks that share one card (NCCL refuses
two ranks on one device; Gloo stages its all-reduce and broadcast of CUDA
tensors through the host). A failed initialisation raises: nothing switches
from one backend to the other.

``spawn`` starts ``world_size`` ranks of a function on this host: the
port's stand-in for petr_tpu's "n devices in one process", used by the
tests, ``dryrun_multichip``, ``cli.scaling`` and ``chip_smoke.py``.

petr_tpu's ``host_local_batch_to_global`` has no counterpart: each rank
keeps the rows its loader read (``Loader(process_shard=...)``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import socket
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from petr_tpu_torch.parallel.mesh import Mesh, make_mesh

BACKENDS = ("nccl", "gloo")
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> bool:
    """Join the process group of ``num_processes`` ranks whose rank 0
    listens at ``coordinator_address`` (host:port) -> whether a group was
    initialised.

    Env fallbacks as petr_tpu's: COORDINATOR_ADDRESS, NUM_PROCESSES /
    WORLD_SIZE, PROCESS_ID / RANK. Without a coordinator it is a no-op for
    one process (and raises for more); with one, it initialises even one
    process, so that a one-rank run can exercise the backend."""
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", os.environ.get("WORLD_SIZE", "1")))
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", os.environ.get("RANK", "0")))
    if coordinator_address is None:
        if num_processes > 1:
            raise ValueError(f"{num_processes} processes need a coordinator address (host:port)")
        return False
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    return True


def rank_device(device: str = "cuda", rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``cuda:{local rank % cards}`` (the local rank from
    LOCAL_RANK, else the rank), made current; the CPU when asked. Raises
    when a card is asked for and there is none."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run on the CPU")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def make_pod_mesh(model_parallel: Optional[int] = None) -> Mesh:
    """The (data, model) mesh over every rank with ``model`` within a host's
    local devices (`distributed.py:48-62`). A rank owns one card, so the
    default model axis, a process's local devices, is 1: pure data
    parallelism over the ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    model = 1 if model_parallel is None else model_parallel
    if world % model:
        raise ValueError(f"model axis {model} does not divide {world} ranks")
    return make_mesh(world, model=model)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world_size: int, backend: str, device: str, port: int,
               fn: Callable, args: Sequence, out_dir: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host: the loopback interface
    dev = rank_device(device, rank)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world_size,
                            rank=rank, timeout=TIMEOUT)
    try:
        result = fn(rank, world_size, dev, *args)
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str, device: str, args: Sequence = ()) -> List[Any]:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size`` new
    processes joined in one process group -> every rank's return value, by
    rank. ``fn`` must be importable by name (a module-level function). A
    rank that raises fails the launch with its traceback, after the others
    are stopped."""
    import torch.multiprocessing as mp

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if torch.device(device).type != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run on the CPU")
    out_dir = tempfile.mkdtemp(prefix="petr_spawn_")
    try:
        mp.start_processes(_rank_main, args=(world_size, backend, device, free_port(), fn, tuple(args), out_dir),
                           nprocs=world_size, join=True, start_method="spawn")
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
