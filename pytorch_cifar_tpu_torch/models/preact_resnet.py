"""Pre-activation ResNet family for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/preact_resnet.py``.

BN-ReLU-conv ordering: a block normalizes and activates its input first,
and its projection shortcut (a 1x1 conv with no BN) branches off that
*pre-activated* tensor; the identity shortcut is the raw input. There is
no final BN or ReLU before the 4x4 pool and the linear. Modules are
defined in the reference's order and under its names (``conv1``,
``layer{1..4}.{i}.bn1/conv1/bn2/conv2[/bn3/conv3]/shortcut.0``,
``linear``), so ``state_dict()`` is the reference layout.

Eval mode (:meth:`PreActResNet.fold` / :meth:`PreActResNet.folded_forward`):
each block's ``bn1`` is an affine + ReLU on its input; a stride-1 3x3 conv
that the next BN and a ReLU follow (the basic block's ``conv1``, the
bottleneck's ``conv2``) goes through the fused ``conv3x3_bn_relu`` kernel;
the bottleneck's ``conv1`` folds ``bn2`` as an ``F.conv2d`` site; the last
conv of a block, the stride-2 3x3s and the shortcuts stay plain
``F.conv2d``. The stem's raw output is the first basic block's identity
shortcut, so it stays plain in PreActResNet18/34; in the bottleneck models
the first block projects from the activated tensor and nothing reads the
raw stem output, so the stem and that block's ``bn1`` + ReLU fuse into a
kernel site. Launches a forward: 5, 13, 14, 31 and 48.

Golden param counts: PreActResNet18 11,171,146 · PreActResNet34
21,279,306 · PreActResNet50 23,509,066 · PreActResNet101 42,501,194 ·
PreActResNet152 58,144,842.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_cifar_tpu_torch.models.common import (
    RELU,
    Linear,
    affine_relu,
    avg_pool,
    batchnorm,
    conv,
    conv_bn,
    fold_affine,
    fold_conv_bn,
    folded_dense,
)


def _shortcut(in_planes: int, out_planes: int, stride: int) -> nn.Sequential:
    if stride != 1 or in_planes != out_planes:
        return nn.Sequential(conv(in_planes, out_planes, 1, stride))
    return nn.Sequential()


class PreActBlock(nn.Module):
    """BN-ReLU-conv3x3 -> BN-ReLU-conv3x3, added to the shortcut."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = batchnorm(in_planes)
        self.conv1 = conv(in_planes, planes, 3, stride)
        self.bn2 = batchnorm(planes)
        self.conv2 = conv(planes, planes, 3)
        self.shortcut = _shortcut(in_planes, planes, stride)

    def forward(self, x):
        out = F.relu(self.bn1(x))
        shortcut = self.shortcut(out) if len(self.shortcut) else x
        out = self.conv1(out)
        return self.conv2(F.relu(self.bn2(out))) + shortcut

    def fold(self, dtype, pre: bool = True) -> dict:
        return {
            "pre": fold_affine(self.bn1, dtype) if pre else None,
            "convs": [fold_conv_bn(self.conv1, self.bn2, dtype, act=RELU),
                      fold_conv_bn(self.conv2, None, dtype)],
            "shortcut": fold_conv_bn(self.shortcut[0], None, dtype)
            if len(self.shortcut) else None,
        }


class PreActBottleneck(nn.Module):
    """BN-ReLU-conv1x1 -> BN-ReLU-conv3x3 -> BN-ReLU-conv1x1 (x4)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = batchnorm(in_planes)
        self.conv1 = conv(in_planes, planes, 1)
        self.bn2 = batchnorm(planes)
        self.conv2 = conv(planes, planes, 3, stride)
        self.bn3 = batchnorm(planes)
        self.conv3 = conv(planes, self.expansion * planes, 1)
        self.shortcut = _shortcut(in_planes, self.expansion * planes, stride)

    def forward(self, x):
        out = F.relu(self.bn1(x))
        shortcut = self.shortcut(out) if len(self.shortcut) else x
        out = self.conv1(out)
        out = self.conv2(F.relu(self.bn2(out)))
        return self.conv3(F.relu(self.bn3(out))) + shortcut

    def fold(self, dtype, pre: bool = True) -> dict:
        return {
            "pre": fold_affine(self.bn1, dtype) if pre else None,
            "convs": [fold_conv_bn(self.conv1, self.bn2, dtype, act=RELU),
                      fold_conv_bn(self.conv2, self.bn3, dtype, act=RELU),
                      fold_conv_bn(self.conv3, None, dtype)],
            "shortcut": fold_conv_bn(self.shortcut[0], None, dtype)
            if len(self.shortcut) else None,
        }


def _block_forward(f: dict, x: torch.Tensor) -> torch.Tensor:
    """One folded block. ``f["pre"]`` None: ``x`` is already the
    pre-activated tensor (the stem fused the block's ``bn1``), and no
    identity shortcut reads the raw one."""
    out = x if f["pre"] is None else affine_relu(x, f["pre"])
    sc = x if f["shortcut"] is None else conv_bn(out, f["shortcut"])
    for site in f["convs"]:
        out = conv_bn(out, site)
    return out + sc


class PreActResNet(nn.Module):
    def __init__(self, block, num_blocks: Sequence[int],
                 num_classes: int = 10):
        super().__init__()
        self.in_planes = 64
        self.conv1 = conv(3, 64, 3)
        self.layer1 = self._make_layer(block, 64, num_blocks[0], 1)
        self.layer2 = self._make_layer(block, 128, num_blocks[1], 2)
        self.layer3 = self._make_layer(block, 256, num_blocks[2], 2)
        self.layer4 = self._make_layer(block, 512, num_blocks[3], 2)
        self.linear = Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes: int, n: int, stride: int):
        layers = []
        for s in [stride] + [1] * (n - 1):
            layers.append(block(self.in_planes, planes, s))
            self.in_planes = planes * block.expansion
        return nn.Sequential(*layers)

    def blocks(self) -> List[nn.Module]:
        """Every block in forward order."""
        return [b for layer in (self.layer1, self.layer2, self.layer3,
                                self.layer4) for b in layer]

    def forward(self, x):
        if not self.training:
            return self.folded_forward(self.fold(x.dtype), x)
        out = self.conv1(x.contiguous(memory_format=torch.channels_last))
        for b in self.blocks():
            out = b(out)
        out = avg_pool(out, 4)
        return self.linear(out.flatten(1))

    def fold(self, dtype: torch.dtype) -> dict:
        """The eval-mode weights for ``dtype`` compute (see
        :meth:`.resnet.ResNet.fold`). The stem folds the first block's
        ``bn1`` where that block projects (nothing reads the raw stem
        output then)."""
        blocks = self.blocks()
        fuse = len(blocks[0].shortcut) > 0
        with torch.no_grad():
            return {
                "stem": fold_conv_bn(self.conv1, blocks[0].bn1, dtype,
                                     act=RELU) if fuse
                else fold_conv_bn(self.conv1, None, dtype),
                "blocks": [b.fold(dtype, pre=not (fuse and i == 0))
                           for i, b in enumerate(blocks)],
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
        out = avg_pool(out, 4)
        return folded_dense(out.flatten(1), *folded["linear"])


def PreActResNet18(num_classes: int = 10) -> PreActResNet:
    return PreActResNet(PreActBlock, (2, 2, 2, 2), num_classes)


def PreActResNet34(num_classes: int = 10) -> PreActResNet:
    return PreActResNet(PreActBlock, (3, 4, 6, 3), num_classes)


def PreActResNet50(num_classes: int = 10) -> PreActResNet:
    return PreActResNet(PreActBottleneck, (3, 4, 6, 3), num_classes)


def PreActResNet101(num_classes: int = 10) -> PreActResNet:
    return PreActResNet(PreActBottleneck, (3, 4, 23, 3), num_classes)


def PreActResNet152(num_classes: int = 10) -> PreActResNet:
    return PreActResNet(PreActBottleneck, (3, 8, 36, 3), num_classes)
