"""Process-group rendezvous, ranks and rank-0 broadcasts (counterpart of
``pytorch_cifar_tpu/parallel/mesh.py``).

The JAX package runs one process per host over a named device mesh; here
each card has its own process and the default ``torch.distributed``
process group *is* the mesh: its one axis is :data:`DATA_AXIS`, its size
the world, a rank's shard index its rank. There is no ``make_mesh``
counterpart. The backend follows the process's device: NCCL for CUDA
tensors, gloo for the CPU. Every collective here runs over the default
group, with tensors on :func:`collective_device`.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from pytorch_cifar_tpu_torch import resolve_device

DATA_AXIS = "data"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the job's default process group (the JAX package's
    ``jax.distributed.initialize``, the reference's
    ``dist.init_process_group``, ``main_dist.py:73-74``).

    ``coordinator_address`` ``host:port`` is rank 0's TCP store, with
    ``num_processes`` and ``process_id``; without it the group reads
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` from the
    environment, as ``torchrun`` sets them. The backend is NCCL when the
    process's ``device`` is CUDA (the default) and gloo when it is the CPU.
    A rendezvous that fails or times out (``timeout_s``; torch's default
    when None) raises: a job never quietly trains alone. Returns whether
    this call made the group (False when one exists already, which this
    call then joins as it is)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if coordinator_address:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id), **kwargs,
        )
    else:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    return True


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Processes in the job (1 without a process group)."""
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    """This process's rank, its shard index on :data:`DATA_AXIS`."""
    return dist.get_rank() if is_distributed() else 0


def is_primary() -> bool:
    """True on the process that owns logging and the checkpoint commit
    (the reference's rank-0 gating, ``main_dist.py:78-82,243``)."""
    return rank() == 0


def local_rank() -> int:
    """This process's index among the processes of its host:
    ``LOCAL_RANK`` where a launcher sets it, else the rank modulo the
    host's visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    count = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank() % max(count, 1)


def rank_device(device=None) -> torch.device:
    """The device a rank trains on: ``cuda:<local rank>`` unless the
    caller names the CPU (or an indexed card). Raises where CUDA is asked
    for and absent, as :func:`~pytorch_cifar_tpu_torch.resolve_device`."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return dev


def collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_bytes(data: Optional[bytes]) -> bytes:
    """``data`` from rank 0 to every rank (the others pass None and get
    rank 0's bytes): its length, then its bytes as one uint8 tensor.
    Without a process group the bytes come back unchanged."""
    if not is_distributed():
        return data
    dev = collective_device()
    primary = is_primary()
    n = torch.tensor([len(data) if primary else 0], dtype=torch.int64,
                     device=dev)
    dist.broadcast(n, src=0)
    if primary:
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8) \
            if data else torch.zeros(0, dtype=torch.uint8)
        buf = buf.to(dev)
    else:
        buf = torch.empty(int(n.item()), dtype=torch.uint8, device=dev)
    if buf.numel():
        dist.broadcast(buf, src=0)
    return data if primary else buf.cpu().numpy().tobytes()


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any of them (an
    all-reduce MAX): the agreed stop at an epoch boundary."""
    if not is_distributed():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
