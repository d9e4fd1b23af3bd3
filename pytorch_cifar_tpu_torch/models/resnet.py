"""ResNet family for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/resnet.py``.

Modules are defined in the reference's order and under its names
(``conv1``, ``bn1``, ``layer{1..4}.{i}.conv1/bn1/...``, ``shortcut.0/.1``,
``linear``), so ``state_dict()`` is the reference layout and serves as the
template of the JAX package's ``compat.export_torch_state_dict``.

Two forwards:

- train mode: the port's :class:`~.common.BatchNorm` with batch statistics
  (the JAX ``BatchNorm``'s semantics; its moments go through kernel K2
  under ``bn_moments_impl(fused_moments)``), convs and the linear computing
  in the input's dtype (the bf16 policy);
- eval mode: :meth:`ResNet.fold` folds every BN into its conv once per
  weight set, and :meth:`ResNet.folded_forward` runs the folded sites. Each
  stride-1 3x3 conv -> BN -> ReLU (the stem, BasicBlock ``conv1`` at stride
  1, Bottleneck ``conv2`` at stride 1) goes through the fused
  ``conv3x3_bn_relu`` kernel: 6 launches per ResNet-18 forward. The
  stride-2 convs, every BN that feeds the residual add, and the 1x1
  shortcuts stay ``F.conv2d`` plus the folded affine. Calling the module
  in eval mode folds on the fly (convenient, not the serving path).

Golden param counts: ResNet18 11,173,962 · ResNet50 23,520,842 ·
ResNet152 58,156,618.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_cifar_tpu_torch.models.common import (
    RELU,
    FoldedConvBN,
    Linear,
    avg_pool,
    batchnorm,
    conv,
    conv_bn,
    fold_conv_bn,
    folded_dense,
)


def _fold_shortcut(shortcut: nn.Sequential, dtype) -> Optional[FoldedConvBN]:
    if len(shortcut) == 0:
        return None
    return fold_conv_bn(shortcut[0], shortcut[1], dtype)


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN + projection shortcut, post-activation."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride)
        self.bn1 = batchnorm(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = batchnorm(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != self.expansion * planes:
            self.shortcut = nn.Sequential(
                conv(in_planes, self.expansion * planes, 1, stride),
                batchnorm(self.expansion * planes),
            )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self.shortcut(x))

    def fold(self, dtype) -> Dict[str, Optional[FoldedConvBN]]:
        return {
            "convs": [
                fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
                fold_conv_bn(self.conv2, self.bn2, dtype),
            ],
            "shortcut": _fold_shortcut(self.shortcut, dtype),
        }


class Bottleneck(nn.Module):
    """1x1 reduce - 3x3 - 1x1 expand (x4), post-activation."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 1)
        self.bn1 = batchnorm(planes)
        self.conv2 = conv(planes, planes, 3, stride)
        self.bn2 = batchnorm(planes)
        self.conv3 = conv(planes, self.expansion * planes, 1)
        self.bn3 = batchnorm(self.expansion * planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != self.expansion * planes:
            self.shortcut = nn.Sequential(
                conv(in_planes, self.expansion * planes, 1, stride),
                batchnorm(self.expansion * planes),
            )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + self.shortcut(x))

    def fold(self, dtype) -> Dict[str, Optional[FoldedConvBN]]:
        return {
            "convs": [
                fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
                fold_conv_bn(self.conv2, self.bn2, dtype, act=RELU),
                fold_conv_bn(self.conv3, self.bn3, dtype),
            ],
            "shortcut": _fold_shortcut(self.shortcut, dtype),
        }


def _block_forward(f: dict, x: torch.Tensor) -> torch.Tensor:
    """One folded block: the convs in order (the last one's BN feeds the
    residual add, so it carries no ReLU), then relu(out + shortcut)."""
    out = x
    for site in f["convs"]:
        out = conv_bn(out, site)
    sc = x if f["shortcut"] is None else conv_bn(x, f["shortcut"])
    return torch.relu(out + sc)


class ResNet(nn.Module):
    def __init__(self, block, num_blocks: Sequence[int], num_classes: int = 10):
        super().__init__()
        self.in_planes = 64
        self.conv1 = conv(3, 64, 3)
        self.bn1 = batchnorm(64)
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
        """Every residual block in forward order."""
        return [
            b
            for layer in (self.layer1, self.layer2, self.layer3, self.layer4)
            for b in layer
        ]

    def forward(self, x):
        if not self.training:
            return self.folded_forward(self.fold(x.dtype), x)
        x = x.contiguous(memory_format=torch.channels_last)
        out = F.relu(self.bn1(self.conv1(x)))
        for b in self.blocks():
            out = b(out)
        out = avg_pool(out, 4)
        return self.linear(out.flatten(1))

    def fold(self, dtype: torch.dtype) -> dict:
        """The eval-mode weights for ``dtype`` compute: every BN folded
        into its conv, every weight in the layout its site consumes. Build
        once per weight set; :meth:`folded_forward` only reads it."""
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
        compute dtype and becomes channels_last here (a no-op when it
        already is, as the NHWC input's permute is)."""
        out = conv_bn(x.contiguous(memory_format=torch.channels_last),
                      folded["stem"])
        for f in folded["blocks"]:
            out = _block_forward(f, out)
        out = avg_pool(out, 4)
        return folded_dense(out.flatten(1), *folded["linear"])


def ResNet18(num_classes: int = 10) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes)


def ResNet34(num_classes: int = 10) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes)


def ResNet50(num_classes: int = 10) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes)


def ResNet101(num_classes: int = 10) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes)


def ResNet152(num_classes: int = 10) -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3), num_classes)
