"""Model registry of the port (LeNet, the ResNet family, GoogLeNet and
MobileNet so far).

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
from pytorch_cifar_tpu_torch.models.googlenet import GoogLeNet
from pytorch_cifar_tpu_torch.models.lenet import LeNet
from pytorch_cifar_tpu_torch.models.mobilenet import MobileNet
from pytorch_cifar_tpu_torch.models.resnet import (
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)

MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "GoogLeNet": GoogLeNet,
    "LeNet": LeNet,
    "MobileNet": MobileNet,
    "ResNet18": ResNet18,
    "ResNet34": ResNet34,
    "ResNet50": ResNet50,
    "ResNet101": ResNet101,
    "ResNet152": ResNet152,
}

# the JAX package's other registry models, which later slices port
NOT_PORTED = (
    "DLA", "DPN26", "DPN92", "DenseNet121", "DenseNet161", "DenseNet169",
    "DenseNet201", "DenseNetCifar", "EfficientNetB0", "MobileNetV2", "PNASNetA", "PNASNetB", "PreActResNet101",
    "PreActResNet152", "PreActResNet18", "PreActResNet34", "PreActResNet50",
    "RegNetX_200MF", "RegNetX_400MF", "RegNetY_400MF", "ResNeXt29_2x64d",
    "ResNeXt29_32x4d", "ResNeXt29_4x64d", "ResNeXt29_8x64d", "SENet18",
    "ShuffleNetG2", "ShuffleNetG3", "ShuffleNetV2_0.5", "ShuffleNetV2_1",
    "ShuffleNetV2_1.5", "ShuffleNetV2_2", "SimpleDLA", "VGG11", "VGG13",
    "VGG16", "VGG19",
)


def create_model(
    name: str,
    num_classes: int = 10,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build ``name`` on the CPU; with ``generator``, its initial weights
    are drawn from it (PyTorch's default init) instead of the global RNG."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet; the port has "
            f"{sorted(MODEL_REGISTRY)}"
        )
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
