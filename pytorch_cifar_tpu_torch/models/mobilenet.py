"""MobileNetV1 for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/mobilenet.py``.

Depthwise-separable blocks: a 3x3 depthwise conv (``groups == channels``)
and a 1x1 pointwise conv, each followed by BN and ReLU; a 3x3 stem to 32
channels; a 2x2 average pool and a 1024 -> classes linear. Modules are
defined in the reference's order and under its names (``conv1``, ``bn1``,
``layers.{i}.conv1/bn1/conv2/bn2``, ``linear``), so ``state_dict()`` is the
reference layout.

Two forwards, as in :mod:`.resnet`:

- train mode: the port's :class:`~.common.BatchNorm` with batch statistics,
  every conv through the library (the depthwise kernel has no backward, as
  the TPU kernel has none);
- eval mode: :meth:`MobileNet.fold` folds every BN into its conv once per
  weight set and :meth:`MobileNet.folded_forward` runs the folded sites.
  The stem goes through the fused ``conv3x3_bn_relu`` kernel (1 launch per
  forward) and the 9 stride-1 depthwise convs (32 channels at 32x32, 128
  at 16x16, 256 at 8x8, five of 512 at 4x4, 1024 at 2x2) through the
  ``depthwise_stencil`` kernel; the 4 stride-2 depthwise convs and the 13
  pointwise convs stay ``F.conv2d`` plus the folded affine.

Golden param count: 3,217,226.
"""

from __future__ import annotations

from typing import List

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

# int = (planes, stride 1); tuple = (planes, stride)
CFG = (64, (128, 2), 128, (256, 2), 256, (512, 2), 512, 512, 512, 512, 512,
       (1024, 2), 1024)


class DepthwiseSeparable(nn.Module):
    """3x3 depthwise + 1x1 pointwise, each followed by BN-ReLU (the
    reference's ``Block``)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_planes, in_planes, 3, stride, groups=in_planes)
        self.bn1 = batchnorm(in_planes)
        self.conv2 = conv(in_planes, planes, 1)
        self.bn2 = batchnorm(planes)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)))

    def fold(self, dtype) -> List[FoldedConvBN]:
        return [
            fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
            fold_conv_bn(self.conv2, self.bn2, dtype, act=RELU),
        ]


class MobileNet(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.conv1 = conv(3, 32, 3)
        self.bn1 = batchnorm(32)
        blocks, in_planes = [], 32
        for item in CFG:
            planes, stride = (item, 1) if isinstance(item, int) else item
            blocks.append(DepthwiseSeparable(in_planes, planes, stride))
            in_planes = planes
        self.layers = nn.Sequential(*blocks)
        self.linear = Linear(1024, num_classes)

    def forward(self, x):
        if not self.training:
            return self.folded_forward(self.fold(x.dtype), x)
        x = x.contiguous(memory_format=torch.channels_last)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.layers(out)
        out = avg_pool(out, 2)
        return self.linear(out.flatten(1))

    def fold(self, dtype: torch.dtype) -> dict:
        """The eval-mode weights for ``dtype`` compute (see
        :meth:`.resnet.ResNet.fold`); the depthwise weights are laid out
        ``(k, k, c)`` here, once per weight set."""
        with torch.no_grad():
            return {
                "stem": fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
                "blocks": [b.fold(dtype) for b in self.layers],
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
        for sites in folded["blocks"]:
            for site in sites:
                out = conv_bn(out, site)
        out = avg_pool(out, 2)
        return folded_dense(out.flatten(1), *folded["linear"])
