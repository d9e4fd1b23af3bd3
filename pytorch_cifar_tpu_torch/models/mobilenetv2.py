"""MobileNetV2 for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/mobilenetv2.py``.

Inverted residual blocks: a 1x1 expand conv (kept at expansion 1, as the
reference keeps it), a 3x3 depthwise conv, a 1x1 linear projection, each
followed by BN (ReLU after the first two). The residual add applies only at
stride 1, through a 1x1 conv + BN projection when the channel count
changes. CIFAR strides: stem stride 1 and stage 2 at stride 1. Head: a
320 -> 1280 1x1 conv + BN + ReLU, a 4x4 average pool and a 1280 -> classes
linear. Modules are defined in the reference's order and under its names
(``conv1``, ``bn1``, ``layers.{i}.conv1..3/bn1..3/shortcut.0/.1``,
``conv2``, ``bn2``, ``linear``), so ``state_dict()`` is the reference
layout.

Two forwards, as in :mod:`.mobilenet`:

- train mode: batch-statistics BN, every conv through the library;
- eval mode: :meth:`MobileNetV2.fold` / :meth:`MobileNetV2.folded_forward`.
  The stem goes through the fused ``conv3x3_bn_relu`` kernel (1 launch a
  forward) and the 14 stride-1 depthwise convs (32, 96 and 144 channels at
  32x32, 192 at 16x16, 384 and 576 at 8x8, 960 at 4x4) through the
  ``depthwise_stencil`` kernel; the 3 stride-2 depthwise convs and every
  1x1 conv stay ``F.conv2d`` plus the folded affine.

Golden param count: 2,296,922.
"""

from __future__ import annotations

from typing import Optional

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
)

# (expansion, out planes, blocks, stride of the first block) per stage
CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 1),  # stride 2 -> 1 for CIFAR
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class InvertedResidual(nn.Module):
    """expand 1x1 -> depthwise 3x3 -> project 1x1 (linear), residual at
    stride 1 (the reference's ``Block``)."""

    def __init__(self, in_planes: int, out_planes: int, expansion: int,
                 stride: int):
        super().__init__()
        self.stride = stride
        planes = expansion * in_planes
        self.conv1 = conv(in_planes, planes, 1)
        self.bn1 = batchnorm(planes)
        self.conv2 = conv(planes, planes, 3, stride, groups=planes)
        self.bn2 = batchnorm(planes)
        self.conv3 = conv(planes, out_planes, 1)
        self.bn3 = batchnorm(out_planes)
        self.shortcut = nn.Sequential()
        if stride == 1 and in_planes != out_planes:
            self.shortcut = nn.Sequential(conv(in_planes, out_planes, 1),
                                          batchnorm(out_planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return out + self.shortcut(x) if self.stride == 1 else out

    def fold(self, dtype) -> dict:
        sc: Optional[FoldedConvBN] = None
        if len(self.shortcut):
            sc = fold_conv_bn(self.shortcut[0], self.shortcut[1], dtype)
        return {
            "convs": [fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
                      fold_conv_bn(self.conv2, self.bn2, dtype, act=RELU),
                      fold_conv_bn(self.conv3, self.bn3, dtype)],
            "residual": self.stride == 1,
            "shortcut": sc,
        }


def _block_forward(f: dict, x: torch.Tensor) -> torch.Tensor:
    out = x
    for site in f["convs"]:
        out = conv_bn(out, site)
    if not f["residual"]:
        return out
    return out + (x if f["shortcut"] is None else conv_bn(x, f["shortcut"]))


class MobileNetV2(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.conv1 = conv(3, 32, 3)
        self.bn1 = batchnorm(32)
        blocks, in_planes = [], 32
        for expansion, out_planes, n, stride in CFG:
            for s in [stride] + [1] * (n - 1):
                blocks.append(InvertedResidual(in_planes, out_planes,
                                               expansion, s))
                in_planes = out_planes
        self.layers = nn.Sequential(*blocks)
        self.conv2 = conv(in_planes, 1280, 1)
        self.bn2 = batchnorm(1280)
        self.linear = Linear(1280, num_classes)

    def forward(self, x):
        if not self.training:
            return self.folded_forward(self.fold(x.dtype), x)
        x = x.contiguous(memory_format=torch.channels_last)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.layers(out)
        out = F.relu(self.bn2(self.conv2(out)))
        out = avg_pool(out, 4)
        return self.linear(out.flatten(1))

    def fold(self, dtype: torch.dtype) -> dict:
        """The eval-mode weights for ``dtype`` compute (see
        :meth:`.resnet.ResNet.fold`)."""
        with torch.no_grad():
            return {
                "stem": fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
                "blocks": [b.fold(dtype) for b in self.layers],
                "head": fold_conv_bn(self.conv2, self.bn2, dtype, act=RELU),
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
        out = conv_bn(out, folded["head"])
        out = avg_pool(out, 4)
        return F.linear(out.flatten(1), *folded["linear"])
