"""Model registry of the port: the JAX package's 44 names.

Counterpart of ``pytorch_cifar_tpu/models/__init__.py``: models are named
factories selected by ``--model``, under the JAX registry's spellings. Factories take ``num_classes`` and return
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
from pytorch_cifar_tpu_torch.models.densenet import (
    DenseNet121,
    DenseNet161,
    DenseNet169,
    DenseNet201,
    DenseNetCifar,
)
from pytorch_cifar_tpu_torch.models.dla import DLA
from pytorch_cifar_tpu_torch.models.dla_simple import SimpleDLA
from pytorch_cifar_tpu_torch.models.dpn import DPN26, DPN92
from pytorch_cifar_tpu_torch.models.efficientnet import EfficientNetB0
from pytorch_cifar_tpu_torch.models.googlenet import GoogLeNet
from pytorch_cifar_tpu_torch.models.lenet import LeNet
from pytorch_cifar_tpu_torch.models.mobilenet import MobileNet
from pytorch_cifar_tpu_torch.models.mobilenetv2 import MobileNetV2
from pytorch_cifar_tpu_torch.models.pnasnet import PNASNetA, PNASNetB
from pytorch_cifar_tpu_torch.models.preact_resnet import (
    PreActResNet18,
    PreActResNet34,
    PreActResNet50,
    PreActResNet101,
    PreActResNet152,
)
from pytorch_cifar_tpu_torch.models.regnet import (
    RegNetX_200MF,
    RegNetX_400MF,
    RegNetY_400MF,
)
from pytorch_cifar_tpu_torch.models.resnet import (
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from pytorch_cifar_tpu_torch.models.resnext import (
    ResNeXt29_2x64d,
    ResNeXt29_4x64d,
    ResNeXt29_8x64d,
    ResNeXt29_32x4d,
)
from pytorch_cifar_tpu_torch.models.senet import SENet18
from pytorch_cifar_tpu_torch.models.shufflenet import (
    ShuffleNetG2,
    ShuffleNetG3,
)
from pytorch_cifar_tpu_torch.models.shufflenetv2 import (
    ShuffleNetV2_1,
    ShuffleNetV2_2,
    ShuffleNetV2_05,
    ShuffleNetV2_15,
)
from pytorch_cifar_tpu_torch.models.vgg import VGG11, VGG13, VGG16, VGG19

MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "DLA": DLA,
    "DPN26": DPN26,
    "DPN92": DPN92,
    "DenseNet121": DenseNet121,
    "DenseNet161": DenseNet161,
    "DenseNet169": DenseNet169,
    "DenseNet201": DenseNet201,
    "DenseNetCifar": DenseNetCifar,
    "EfficientNetB0": EfficientNetB0,
    "GoogLeNet": GoogLeNet,
    "LeNet": LeNet,
    "MobileNet": MobileNet,
    "MobileNetV2": MobileNetV2,
    "PNASNetA": PNASNetA,
    "PNASNetB": PNASNetB,
    "PreActResNet18": PreActResNet18,
    "PreActResNet34": PreActResNet34,
    "PreActResNet50": PreActResNet50,
    "PreActResNet101": PreActResNet101,
    "PreActResNet152": PreActResNet152,
    "RegNetX_200MF": RegNetX_200MF,
    "RegNetX_400MF": RegNetX_400MF,
    "RegNetY_400MF": RegNetY_400MF,
    "ResNeXt29_2x64d": ResNeXt29_2x64d,
    "ResNeXt29_4x64d": ResNeXt29_4x64d,
    "ResNeXt29_8x64d": ResNeXt29_8x64d,
    "ResNeXt29_32x4d": ResNeXt29_32x4d,
    "ResNet18": ResNet18,
    "ResNet34": ResNet34,
    "ResNet50": ResNet50,
    "ResNet101": ResNet101,
    "ResNet152": ResNet152,
    "SENet18": SENet18,
    "ShuffleNetG2": ShuffleNetG2,
    "ShuffleNetG3": ShuffleNetG3,
    "ShuffleNetV2_0.5": ShuffleNetV2_05,
    "ShuffleNetV2_1": ShuffleNetV2_1,
    "ShuffleNetV2_1.5": ShuffleNetV2_15,
    "ShuffleNetV2_2": ShuffleNetV2_2,
    "SimpleDLA": SimpleDLA,
    "VGG11": VGG11,
    "VGG13": VGG13,
    "VGG16": VGG16,
    "VGG19": VGG19,
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
