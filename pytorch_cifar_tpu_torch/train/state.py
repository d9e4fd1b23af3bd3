"""TrainState: what a training run carries from one step to the next
(counterpart of ``pytorch_cifar_tpu/train/state.py``).

The JAX package's state is one immutable pytree (params, BN stats,
optimizer state, step). Here the model holds its parameters and BN running
stats and the optimizer its momentum buffers, both updated in place; the
state adds the step counter, the LR schedule and two generators, one for
the augmentation draws and one for the model's own (EfficientNet's
drop-connect and dropout masks, the JAX model's ``"stochastic"`` stream).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.data.pipeline import mix_seed
from pytorch_cifar_tpu_torch.train.optim import Schedule


MODEL_STREAM = 1 << 31  # set in the model draws' seeds, clear in the others'


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    generator: torch.Generator  # augmentation draws, on the data's device
    model_generator: torch.Generator  # the model's draws, on the same device
    seed: int = 0
    step: int = 0  # updates taken so far; indexes the LR schedule

    def _step_seed(self, shard: Optional[int]) -> int:
        """The seed of this step's draws, in ``[0, 2**31)``: ``(seed,
        step)``, then the ``shard`` as the JAX step folds ``axis_index``."""
        seed = mix_seed(self.seed, self.step)
        return seed if shard is None else mix_seed(seed, shard)

    def draw_augment(
        self, n: int, padding: int = 4, shard: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This step's crop offsets ``(n, 2)`` in ``[0, 2 * padding]`` and
        flip bits ``(n,)``, from the generator reseeded with
        ``(seed, step)``: the draw depends on the step alone, as the JAX
        step folds ``state.step`` into its key. A data-parallel step
        passes its ``shard`` index, folded in after the step as the JAX
        step folds ``axis_index``, so the ranks draw apart."""
        self.generator.manual_seed(self._step_seed(shard))
        dev = self.generator.device
        offsets = torch.randint(
            0, 2 * padding + 1, (n, 2), generator=self.generator, device=dev
        )
        flips = torch.rand(n, generator=self.generator, device=dev) < 0.5
        return offsets, flips

    def model_draws(self, shard: Optional[int] = None) -> Callable:
        """This step's draw function for the model,
        ``fn(shape, keep) -> bool mask`` (True with probability ``keep``),
        from the model generator reseeded with the augmentation draw's
        ``(seed, step[, shard])`` seed with bit 31 set: every such seed
        differs from every augmentation seed in the 32 bits both
        generators read (the JAX step splits its key into ``k_aug`` and
        ``k_model`` for the same reason), so the two streams never share
        bits. The draws follow in call order from there."""
        gen = self.model_generator
        gen.manual_seed(self._step_seed(shard) | MODEL_STREAM)

        def keep_mask(shape, keep: float) -> torch.Tensor:
            return torch.rand(shape, generator=gen, device=gen.device) < keep

        return keep_mask


def create_train_state(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    schedule: Schedule,
    seed: int = 0,
    device=None,
) -> TrainState:
    """A state whose generators live on ``device``, where the step's
    batches lie: CUDA unless the caller names another."""
    dev = resolve_device(device)
    return TrainState(
        model=model,
        optimizer=optimizer,
        schedule=schedule,
        generator=torch.Generator(device=dev),
        model_generator=torch.Generator(device=dev),
        seed=seed,
    )
