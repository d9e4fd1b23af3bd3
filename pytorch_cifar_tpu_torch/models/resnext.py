"""ResNeXt-29 for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/resnext.py``.

A grouped-conv bottleneck (1x1 -> grouped 3x3 with ``groups =
cardinality`` -> 1x1 expanding x2, each with BN, ReLU but after the last)
with a projection shortcut (1x1 conv + BN) on a stride or width change.
A 1x1 stem conv + BN + ReLU, three stages at strides 1 / 2 / 2 whose
bottleneck width doubles each stage, an 8x8 pool and a linear from
``cardinality * width * 8``. Modules are defined in the reference's order
and under its names (``conv1``, ``bn1``, ``layer{1..3}.{i}.conv1..3/
bn1..3/shortcut.0/.1``, ``linear``), so ``state_dict()`` is the reference
layout.

Eval mode (:meth:`ResNeXt.fold` / :meth:`ResNeXt.folded_forward`): every
BN folds into its conv; no site is a kernel site (the stem is 1x1, the
3x3s are grouped but not depthwise), so every conv runs ``F.conv2d`` (with
``groups``) plus the folded affine.

Golden param counts: 2x64d 9,128,778 · 4x64d 27,104,586 · 8x64d
89,598,282 · 32x4d 4,774,218.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_cifar_tpu_torch.models.common import (
    RELU,
    Linear,
    avg_pool,
    batchnorm,
    conv,
    conv_bn,
    fold_conv_bn,
)
from pytorch_cifar_tpu_torch.models.resnet import _block_forward

EXPANSION = 2


class Block(nn.Module):
    """The reference's grouped-conv ``Block``."""

    def __init__(self, in_planes: int, cardinality: int,
                 bottleneck_width: int, stride: int = 1):
        super().__init__()
        group_width = cardinality * bottleneck_width
        out_width = EXPANSION * group_width
        self.conv1 = conv(in_planes, group_width, 1)
        self.bn1 = batchnorm(group_width)
        self.conv2 = conv(group_width, group_width, 3, stride,
                          groups=cardinality)
        self.bn2 = batchnorm(group_width)
        self.conv3 = conv(group_width, out_width, 1)
        self.bn3 = batchnorm(out_width)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != out_width:
            self.shortcut = nn.Sequential(
                conv(in_planes, out_width, 1, stride), batchnorm(out_width))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + self.shortcut(x))

    def fold(self, dtype) -> dict:
        return {
            "convs": [fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
                      fold_conv_bn(self.conv2, self.bn2, dtype, act=RELU),
                      fold_conv_bn(self.conv3, self.bn3, dtype)],
            "shortcut": fold_conv_bn(self.shortcut[0], self.shortcut[1],
                                     dtype) if len(self.shortcut) else None,
        }


class ResNeXt(nn.Module):
    def __init__(self, num_blocks: Sequence[int], cardinality: int,
                 bottleneck_width: int, num_classes: int = 10):
        super().__init__()
        self.cardinality = cardinality
        self.bottleneck_width = bottleneck_width
        self.in_planes = 64
        self.conv1 = conv(3, 64, 1)
        self.bn1 = batchnorm(64)
        self.layer1 = self._make_layer(num_blocks[0], 1)
        self.layer2 = self._make_layer(num_blocks[1], 2)
        self.layer3 = self._make_layer(num_blocks[2], 2)
        self.linear = Linear(cardinality * bottleneck_width * 8, num_classes)

    def _make_layer(self, n: int, stride: int) -> nn.Sequential:
        layers = []
        for s in [stride] + [1] * (n - 1):
            layers.append(Block(self.in_planes, self.cardinality,
                                self.bottleneck_width, s))
            self.in_planes = EXPANSION * self.cardinality \
                * self.bottleneck_width
        self.bottleneck_width *= 2  # each stage doubles it
        return nn.Sequential(*layers)

    def blocks(self) -> List[nn.Module]:
        return [b for layer in (self.layer1, self.layer2, self.layer3)
                for b in layer]

    def forward(self, x):
        if not self.training:
            return self.folded_forward(self.fold(x.dtype), x)
        x = x.contiguous(memory_format=torch.channels_last)
        out = F.relu(self.bn1(self.conv1(x)))
        for b in self.blocks():
            out = b(out)
        out = avg_pool(out, 8)
        return self.linear(out.flatten(1))

    def fold(self, dtype: torch.dtype) -> dict:
        """The eval-mode weights for ``dtype`` compute (see
        :meth:`.resnet.ResNet.fold`)."""
        with torch.no_grad():
            return {
                "stem": fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
                "blocks": [b.fold(dtype) for b in self.blocks()],
                "linear": (
                    self.linear.weight.to(dtype),
                    self.linear.bias.to(dtype),
                ),
            }

    def folded_forward(self, folded: dict, x: torch.Tensor) -> torch.Tensor:
        """Eval forward over :meth:`fold`'s weights; ``x`` is NCHW in the
        compute dtype and becomes channels_last here."""
        out = conv_bn(x.contiguous(memory_format=torch.channels_last),
                      folded["stem"])
        for f in folded["blocks"]:
            out = _block_forward(f, out)
        out = avg_pool(out, 8)
        return F.linear(out.flatten(1), *folded["linear"])


def ResNeXt29_2x64d(num_classes: int = 10) -> ResNeXt:
    return ResNeXt((3, 3, 3), 2, 64, num_classes)


def ResNeXt29_4x64d(num_classes: int = 10) -> ResNeXt:
    return ResNeXt((3, 3, 3), 4, 64, num_classes)


def ResNeXt29_8x64d(num_classes: int = 10) -> ResNeXt:
    return ResNeXt((3, 3, 3), 8, 64, num_classes)


def ResNeXt29_32x4d(num_classes: int = 10) -> ResNeXt:
    return ResNeXt((3, 3, 3), 32, 4, num_classes)
