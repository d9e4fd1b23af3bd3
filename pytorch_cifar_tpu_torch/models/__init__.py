"""Model registry of the port (the ResNet family so far).

Counterpart of ``pytorch_cifar_tpu/models/__init__.py``: models are named
factories selected by ``--model``. Factories take ``num_classes`` and return
an ``nn.Module`` mapping NCHW ``(n, 3, 32, 32)`` to ``(n, num_classes)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from pytorch_cifar_tpu_torch.models.common import (  # noqa: F401
    count_params,
    reset_parameters,
)
from pytorch_cifar_tpu_torch.models.resnet import (
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)

MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "ResNet18": ResNet18,
    "ResNet34": ResNet34,
    "ResNet50": ResNet50,
    "ResNet101": ResNet101,
    "ResNet152": ResNet152,
}


def create_model(
    name: str,
    num_classes: int = 10,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build ``name`` on the CPU; with ``generator``, its initial weights
    are drawn from it (PyTorch's default init) instead of the global RNG."""
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}"
        )
    model = MODEL_REGISTRY[name](num_classes=num_classes)
    if generator is not None:
        reset_parameters(model, generator)
    return model


def available_models():
    return sorted(MODEL_REGISTRY)
