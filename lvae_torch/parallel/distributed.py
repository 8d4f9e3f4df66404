"""Process-group set-up for multi-process runs (port of
lvae_tpu.parallel.distributed).

The JAX package runs one controller over every device of a mesh; the port
runs one process per rank (``torchrun``, or ``torch.multiprocessing``), and
each rank computes its shard (``parallel/mesh.py``). This module starts the
process group those ranks share: ``nccl`` where every rank of the host has
a card of its own, ``gloo`` on the CPU or where ranks share a card (NCCL
refuses two ranks on one device). Only ``all_reduce`` and ``broadcast``
cross it, which both backends carry for CUDA tensors.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

from lvae_torch.utils.device import resolve_device


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def local_rank() -> int:
    """This process's rank on its host (``LOCAL_RANK``, else its rank)."""
    return _env_int("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else _env_int("RANK", 0))


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK % device_count`` for a
    CUDA device without an index, else ``device`` itself; raises without a
    card (``utils/device.resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def choose_backend(device: torch.device, local_world: int) -> str:
    """``gloo`` on the CPU or where the host's ranks share a card, else
    ``nccl``."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> int:
    """Start the process group from the arguments or ``torchrun``'s
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``); returns the world size.

    A single process (world size 1 and no ``coordinator_address`` given)
    starts nothing and returns 1; a group already started is kept. The
    backend is :func:`choose_backend`'s, and the choice is printed.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE", 1)
    if world == 1 and coordinator_address is None:
        return 1
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ or "MASTER_PORT" not in os.environ:
            raise ValueError(f"a world of {world} processes needs a coordinator_address or "
                             "MASTER_ADDR and MASTER_PORT")
        # env:// joins torchrun's own store where there is one
        init_method = "env://"
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    else:
        init_method = f"tcp://{coordinator_address}"
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    if process_id is not None and "LOCAL_RANK" not in os.environ:
        os.environ["LOCAL_RANK"] = str(process_id)
    dev = rank_device(device)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    backend = choose_backend(dev, local_world)
    why = ("the CPU" if dev.type != "cuda" else
           f"{local_world} rank(s) on {torch.cuda.device_count()} card(s)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(f"initialize_distributed: rank {rank} of {world} on {dev}, backend {backend} "
          f"({why}), coordinator {coordinator_address}", flush=True)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return world


def make_global_mesh(latent: int = 1, device=None):
    """A ``(data, latent)`` mesh over every process of the group: the data
    axis takes world size / ``latent`` ranks."""
    from lvae_torch.parallel.mesh import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % latent:
        raise ValueError(f"{n} processes are not divisible by latent={latent}")
    return make_mesh(data=n // latent, latent=latent, device=device)


# ------------------------------------------------------- worlds of ranks
def free_port() -> int:
    """A free TCP port on localhost, for a coordinator address."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_main(rank: int, nprocs: int, port: int, fn, args: tuple, out: str, device) -> None:
    initialize_distributed(f"localhost:{port}", nprocs, rank, device=device)
    result = fn(*args)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn_ranks(nprocs: int, fn, args: tuple, out: str, device="cuda"):
    """Start a world of ``nprocs`` spawned ranks on localhost, each of
    which joins the group (:func:`initialize_distributed` on ``device``),
    runs ``fn(*args)`` (a module-level function) and saves what it returns
    to ``<out>/rank<r>.pt``. Returns at once; :func:`join_ranks` waits."""
    import torch.multiprocessing as tmp

    os.makedirs(out, exist_ok=True)
    return tmp.start_processes(_rank_main, args=(nprocs, free_port(), fn, args, out, device),
                               nprocs=nprocs, join=False, start_method="spawn")


def join_ranks(ctx, out: str, timeout: float) -> list:
    """Wait for a world of :func:`spawn_ranks` and return each rank's
    result, in rank order. A rank that fails raises here (the others are
    stopped); a world still running after ``timeout`` seconds is killed and
    raises ``TimeoutError``."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"the world of ranks did not finish in {timeout} s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(len(ctx.processes))]
