"""Optimizer: SGD + momentum + coupled weight decay + per-epoch cosine LR
(counterpart of ``pytorch_cifar_tpu/train/optim.py``).

``torch.optim.SGD(momentum=0.9, weight_decay=5e-4, nesterov=False)`` adds
the decay to the gradient before the momentum update
(``buf = m * buf + (g + wd * p); p -= lr * buf``), on every parameter, BN
included: exactly the JAX package's optax chain ``add_decayed_weights ->
trace -> scale_by_learning_rate``. The cosine is per epoch,
``0.5 * lr * (1 + cos(pi * floor(step / steps_per_epoch) / t_max))``,
applied per update by :func:`set_lr`; ``t_max`` is independent of the
epoch count.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def cosine_epoch_schedule(
    lr: float, t_max: int, steps_per_epoch: int
) -> Schedule:
    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return 0.5 * lr * (1.0 + math.cos(math.pi * epoch / t_max))

    return schedule


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    lr: float = 0.1,
    momentum: float = 0.9,
    weight_decay: float = 5e-4,
) -> torch.optim.SGD:
    return torch.optim.SGD(
        params, lr=lr, momentum=momentum, weight_decay=weight_decay,
        nesterov=False,
    )


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The learning rate of the next update, for every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = lr
