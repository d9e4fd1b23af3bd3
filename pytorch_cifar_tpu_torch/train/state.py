"""TrainState: what a training run carries from one step to the next
(counterpart of ``pytorch_cifar_tpu/train/state.py``).

The JAX package's state is one immutable pytree (params, BN stats,
optimizer state, step). Here the model holds its parameters and BN running
stats and the optimizer its momentum buffers, both updated in place; the
state adds the step counter, the LR schedule and the augmentation
generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.data.pipeline import mix_seed
from pytorch_cifar_tpu_torch.train.optim import Schedule


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    generator: torch.Generator  # augmentation draws, on the data's device
    seed: int = 0
    step: int = 0  # updates taken so far; indexes the LR schedule

    def draw_augment(
        self, n: int, padding: int = 4, shard: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This step's crop offsets ``(n, 2)`` in ``[0, 2 * padding]`` and
        flip bits ``(n,)``, from the generator reseeded with
        ``(seed, step)``: the draw depends on the step alone, as the JAX
        step folds ``state.step`` into its key. A data-parallel step
        passes its ``shard`` index, folded in after the step as the JAX
        step folds ``axis_index``, so the ranks draw apart."""
        seed = mix_seed(self.seed, self.step)
        if shard is not None:
            seed = mix_seed(seed, shard)
        self.generator.manual_seed(seed)
        dev = self.generator.device
        offsets = torch.randint(
            0, 2 * padding + 1, (n, 2), generator=self.generator, device=dev
        )
        flips = torch.rand(n, generator=self.generator, device=dev) < 0.5
        return offsets, flips


def create_train_state(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    schedule: Schedule,
    seed: int = 0,
    device=None,
) -> TrainState:
    """A state whose augmentation generator lives on ``device``, where the
    step's batches lie: CUDA unless the caller names another."""
    return TrainState(
        model=model,
        optimizer=optimizer,
        schedule=schedule,
        generator=torch.Generator(device=resolve_device(device)),
        seed=seed,
    )
