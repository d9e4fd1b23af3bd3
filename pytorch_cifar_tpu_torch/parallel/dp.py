"""The collectives of a data-parallel step, as plain functions over the
default process group (counterpart of
``pytorch_cifar_tpu/parallel/dp.py``, whose ``shard_map`` wrappers carry
the same contract as the reference's DDP, ``main_dist.py:109-147``):

- params and optimizer state are replicated: every rank starts from rank
  0's (:func:`broadcast_module_`, DDP's init-time broadcast) and applies
  the same averaged update;
- the global batch is split over the ranks, each computing on its shard's
  rows (:func:`shard_positions`);
- gradients are averaged each step through one flat buffer
  (:func:`all_reduce_mean_`), and so are the BN running buffers updated by
  the step's forward, unless cross-replica BN already made them equal;
- metrics are summed (:func:`all_reduce_sum_`).

The model is not wrapped in ``DistributedDataParallel``: its
``broadcast_buffers`` copies rank 0's BN buffers where the JAX package
averages them, and its averaged gradient weights ragged shards equally
where the JAX step's global-count loss does not. Under NCCL every call
here is enqueued on the current stream and none waits for the host.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import torch
import torch.distributed as dist
from torch import nn

from pytorch_cifar_tpu_torch.parallel.mesh import world_size


def _by_dtype(tensors: Iterable[torch.Tensor]) -> Dict[torch.dtype, List]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


def _flat_(tensors: Iterable[torch.Tensor],
           collective: Callable[[torch.Tensor], None]) -> None:
    """Run ``collective`` in place on one flat buffer per dtype holding
    every tensor (in logical order, whatever its memory format), then
    copy the results back."""
    for group in _by_dtype(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view(t.shape))


def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Each tensor replaced in place by its mean over the ranks (the JAX
    ``pmean``: the sum, then divided by the world), one all-reduce per
    dtype."""
    world = world_size()

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(world)

    _flat_(tensors, mean)


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` replaced in place by its sum over the ranks (the JAX
    ``psum``); returns it."""
    dist.all_reduce(t)
    return t


def broadcast_module_(module: nn.Module) -> None:
    """Every parameter and buffer of ``module`` set to rank 0's (DDP's
    init-time broadcast, ``main_dist.py:141-144``)."""
    with torch.no_grad():
        _flat_(list(module.parameters()) + list(module.buffers()),
               lambda flat: dist.broadcast(flat, src=0))


def bn_running_buffers(module: nn.Module) -> List[torch.Tensor]:
    """The BN running means and variances, which a train forward updates
    from its shard's moments (``num_batches_tracked`` is not advanced)."""
    return [b for m in module.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in (m.running_mean, m.running_var) if b is not None]


def shard_positions(num_steps: int, global_batch: int, shard: int,
                    n_shards: int, device) -> torch.Tensor:
    """Epoch positions shard ``shard`` of ``n_shards`` visits, in visit
    order: step i's rows ``i * global_batch + shard * shard_batch +
    arange(shard_batch)`` (JAX ``steps.py:283-295``), as int64."""
    shard_batch = global_batch // n_shards
    steps = torch.arange(num_steps, device=device)[:, None] * global_batch
    rows = torch.arange(shard_batch, device=device)[None, :]
    return (steps + shard * shard_batch + rows).reshape(-1)
