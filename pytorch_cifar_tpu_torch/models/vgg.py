"""VGG11/13/16/19 for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/vgg.py``.

Config-list driven stacks of conv3x3 (with bias) + BN + ReLU, ``"M"``
entries 2x2 / stride 2 max pools, and one linear head from 512. Modules
are the reference's ``features`` Sequential (Conv, BN, ReLU and MaxPool
entries, then its ``AvgPool2d(1, 1)``, an identity with no parameters) and
``classifier``, so ``state_dict()`` keys keep the reference's indices
(``features.0``, ``features.1``, ``features.3``, ...).

Eval mode (:meth:`VGG.fold` / :meth:`VGG.folded_forward`): every conv is a
stride-1 3x3 followed by BN and ReLU, so every one goes through the fused
``conv3x3_bn_relu`` kernel, its bias folded into the affine once: 8, 10,
13 and 16 launches a forward, down to 2x2 maps of 512 channels after the
fourth pool.

The pools go through ``common.max_pool`` and the flatten through
``parallel.spatial.gather_slabs``: under a spatial partition the last pool's
1x1 map belongs to one rank of each line (at two ranks a line, the second
owns no row of it), and the linear reads it whole on every rank; elsewhere
both are the plain ops, bit for bit.

Golden param counts: VGG11 9,231,114 · VGG13 9,416,010 · VGG16
14,728,266 · VGG19 20,040,522.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from pytorch_cifar_tpu_torch.models.common import (
    RELU,
    Conv2d,
    Linear,
    batchnorm,
    conv_bn,
    fold_conv_bn,
    folded_dense,
    max_pool,
)
from pytorch_cifar_tpu_torch.parallel.spatial import gather_slabs

CFG = {
    "VGG11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "VGG13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
              512, "M"),
    "VGG16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"),
    "VGG19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
              512, 512, "M", 512, 512, 512, 512, "M"),
}


class _MaxPool(nn.MaxPool2d):
    """The reference's ``MaxPool2d(2, 2)``, through ``common.max_pool`` (a
    slab's pool under a spatial partition, the same call elsewhere)."""

    def __init__(self):
        super().__init__(2, 2)

    def forward(self, x):
        return max_pool(x, 2)


class _Identity(nn.AvgPool2d):
    """The reference's ``AvgPool2d(1, 1)``: its input, unchanged (a 1x1
    window divides by 1), on a slab too."""

    def __init__(self):
        super().__init__(1, 1)

    def forward(self, x):
        return x


class VGG(nn.Module):
    def __init__(self, cfg: Sequence[Union[int, str]],
                 num_classes: int = 10):
        super().__init__()
        layers, cin = [], 3
        for item in cfg:
            if item == "M":
                layers.append(_MaxPool())
            else:
                layers += [Conv2d(cin, item, 3, padding=1), batchnorm(item),
                           nn.ReLU()]
                cin = item
        layers.append(_Identity())
        self.features = nn.Sequential(*layers)
        # 512 in every registered configuration (the reference's constant)
        self.classifier = Linear(cin, num_classes)

    def forward(self, x):
        if not self.training:
            return self.folded_forward(self.fold(x.dtype), x)
        out = self.features(x.contiguous(memory_format=torch.channels_last))
        return self.classifier(gather_slabs(out).flatten(1))

    def fold(self, dtype: torch.dtype) -> dict:
        """The eval-mode weights for ``dtype`` compute (see
        :meth:`.resnet.ResNet.fold`): one fused site per conv, ``"M"`` for
        each pool."""
        layers = list(self.features)
        with torch.no_grad():
            plan = []
            for i, m in enumerate(layers):
                if isinstance(m, nn.Conv2d):
                    plan.append(fold_conv_bn(m, layers[i + 1], dtype,
                                             act=RELU))
                elif isinstance(m, nn.MaxPool2d):
                    plan.append("M")
            return {
                "features": plan,
                "linear": (
                    self.classifier.weight.to(dtype),
                    self.classifier.bias.to(dtype),
                ),
            }

    def folded_forward(self, folded: dict, x: torch.Tensor) -> torch.Tensor:
        """Eval forward over :meth:`fold`'s weights; ``x`` is NCHW in the
        compute dtype and becomes channels_last here."""
        out = x.contiguous(memory_format=torch.channels_last)
        for f in folded["features"]:
            out = max_pool(out, 2) if f == "M" else conv_bn(out, f)
        return folded_dense(gather_slabs(out).flatten(1), *folded["linear"])


def VGG11(num_classes: int = 10) -> VGG:
    return VGG(CFG["VGG11"], num_classes)


def VGG13(num_classes: int = 10) -> VGG:
    return VGG(CFG["VGG13"], num_classes)


def VGG16(num_classes: int = 10) -> VGG:
    return VGG(CFG["VGG16"], num_classes)


def VGG19(num_classes: int = 10) -> VGG:
    return VGG(CFG["VGG19"], num_classes)
