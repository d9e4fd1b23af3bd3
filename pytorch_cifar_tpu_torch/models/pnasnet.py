"""PNASNet A and B for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/pnasnet.py``.

A separable conv here is a depthwise conv with a channel multiplier
(``groups = in``, ``out = m * in``) and BN, with no pointwise stage and no
activation (the reference's simplification). Cell A adds a 7x7 separable
conv to a 3x3 max pool and applies ReLU. Cell B sums a 7x7 and a 3x3
separable conv, and a max pool and a 5x5 separable conv, applies ReLU to
each pair, concatenates them and reduces with a 1x1 conv + BN + ReLU. A
stride-2 cell puts a 1x1 conv + BN after its pool. Layout: the stem
conv3x3 + BN + ReLU, 6 cells, a stride-2 cell doubling the channels, 6
cells, another, 6 cells, an 8x8 average pool and a linear. Modules are
defined in the reference's order and under its names (``conv1``, ``bn1``,
``layer1.{i}`` / ``layer2`` / ... with ``sep_conv{1..3}.conv1/bn1``,
``conv1``/``bn1`` and ``conv2``/``bn2``, ``linear``), so ``state_dict()``
is the reference layout.

Every stride-1 cell pools 3 / 1 / 1 through ``ops.max_pool.max_pool3x3_s1``
in both modes (18 forward launches a forward, 18 backward launches a
train step, on 44 / 88 / 176 channels in A and 32 / 64 / 128 in B); the
stride-2 cells' 3 / 2 / 1 pools stay ``F.max_pool2d``.

Eval mode (:meth:`PNASNet.fold` / :meth:`PNASNet.folded_forward`): the stem
goes through the fused ``conv3x3_bn_relu`` kernel (1 launch a forward) and
the stride-1 cells' separable convs, whose multiplier is 1, through the
``depthwise_stencil`` kernel: k = 7 in A (18 launches), k = 7, 3 and 5 in B
(54 launches), on maps of 32x32, 16x16 and 8x8. The stride-2 cells'
separable convs (multiplier 2) and the 1x1 convs stay ``F.conv2d`` plus the
folded affine.

Golden param counts: PNASNetA 130,646 · PNASNetB 451,626.
"""

from __future__ import annotations

from typing import List, Optional

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
    max_pool,
)

CELLS_PER_STAGE = 6


class SepConv(nn.Module):
    """Depthwise conv with a channel multiplier, then BN."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int,
                 stride: int):
        super().__init__()
        self.conv1 = conv(in_planes, out_planes, kernel_size, stride,
                          groups=in_planes)
        self.bn1 = batchnorm(out_planes)

    def forward(self, x):
        return self.bn1(self.conv1(x))

    def fold(self, dtype) -> FoldedConvBN:
        return fold_conv_bn(self.conv1, self.bn1, dtype)


class _Cell(nn.Module):
    """What the two cells share: the pool branch and its stride-2 1x1."""

    def _pool_branch(self, x):
        y = max_pool(x, 3, stride=self.stride, padding=1)
        if self.stride == 2:
            y = self.bn1(self.conv1(y))
        return y

    def _fold_pool(self, dtype) -> Optional[FoldedConvBN]:
        return fold_conv_bn(self.conv1, self.bn1, dtype) \
            if self.stride == 2 else None


def _pool_forward(f: dict, x: torch.Tensor) -> torch.Tensor:
    y = max_pool(x, 3, stride=f["stride"], padding=1)
    return y if f["pool_1x1"] is None else conv_bn(y, f["pool_1x1"])


class CellA(_Cell):
    def __init__(self, in_planes: int, out_planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.sep_conv1 = SepConv(in_planes, out_planes, 7, stride)
        if stride == 2:
            self.conv1 = conv(in_planes, out_planes, 1)
            self.bn1 = batchnorm(out_planes)

    def forward(self, x):
        return F.relu(self.sep_conv1(x) + self._pool_branch(x))

    def fold(self, dtype) -> dict:
        return {"stride": self.stride, "sep": [self.sep_conv1.fold(dtype)],
                "pool_1x1": self._fold_pool(dtype)}

    @staticmethod
    def folded(f: dict, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(conv_bn(x, f["sep"][0]) + _pool_forward(f, x))


class CellB(_Cell):
    def __init__(self, in_planes: int, out_planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        # left branch
        self.sep_conv1 = SepConv(in_planes, out_planes, 7, stride)
        self.sep_conv2 = SepConv(in_planes, out_planes, 3, stride)
        # right branch
        self.sep_conv3 = SepConv(in_planes, out_planes, 5, stride)
        if stride == 2:
            self.conv1 = conv(in_planes, out_planes, 1)
            self.bn1 = batchnorm(out_planes)
        # reduce channels
        self.conv2 = conv(2 * out_planes, out_planes, 1)
        self.bn2 = batchnorm(out_planes)

    def forward(self, x):
        b1 = F.relu(self.sep_conv1(x) + self.sep_conv2(x))
        b2 = F.relu(self._pool_branch(x) + self.sep_conv3(x))
        y = torch.cat([b1, b2], dim=1)
        return F.relu(self.bn2(self.conv2(y)))

    def fold(self, dtype) -> dict:
        return {"stride": self.stride,
                "sep": [s.fold(dtype) for s in (self.sep_conv1,
                                                 self.sep_conv2,
                                                 self.sep_conv3)],
                "pool_1x1": self._fold_pool(dtype),
                "reduce": fold_conv_bn(self.conv2, self.bn2, dtype,
                                       act=RELU)}

    @staticmethod
    def folded(f: dict, x: torch.Tensor) -> torch.Tensor:
        s7, s3, s5 = f["sep"]
        b1 = torch.relu(conv_bn(x, s7) + conv_bn(x, s3))
        b2 = torch.relu(_pool_forward(f, x) + conv_bn(x, s5))
        return conv_bn(torch.cat([b1, b2], dim=1), f["reduce"])


class PNASNet(nn.Module):
    def __init__(self, cell_type, num_planes: int, num_classes: int = 10):
        super().__init__()
        self.cell_type = cell_type
        p = num_planes
        self.in_planes = p
        self.conv1 = conv(3, p, 3)
        self.bn1 = batchnorm(p)
        self.layer1 = self._make_layer(p)
        self.layer2 = self._downsample(2 * p)
        self.layer3 = self._make_layer(2 * p)
        self.layer4 = self._downsample(4 * p)
        self.layer5 = self._make_layer(4 * p)
        self.linear = Linear(4 * p, num_classes)

    def _make_layer(self, planes: int) -> nn.Sequential:
        cells = []
        for _ in range(CELLS_PER_STAGE):
            cells.append(self.cell_type(self.in_planes, planes, stride=1))
            self.in_planes = planes
        return nn.Sequential(*cells)

    def _downsample(self, planes: int) -> nn.Module:
        cell = self.cell_type(self.in_planes, planes, stride=2)
        self.in_planes = planes
        return cell

    def cells(self) -> List[nn.Module]:
        return [*self.layer1, self.layer2, *self.layer3, self.layer4,
                *self.layer5]

    def forward(self, x):
        if not self.training:
            return self.folded_forward(self.fold(x.dtype), x)
        x = x.contiguous(memory_format=torch.channels_last)
        out = F.relu(self.bn1(self.conv1(x)))
        for cell in self.cells():
            out = cell(out)
        out = avg_pool(out, 8)
        return self.linear(out.flatten(1))

    def fold(self, dtype: torch.dtype) -> dict:
        """The eval-mode weights for ``dtype`` compute (see
        :meth:`.resnet.ResNet.fold`)."""
        with torch.no_grad():
            return {
                "stem": fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
                "cells": [c.fold(dtype) for c in self.cells()],
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
        for f in folded["cells"]:
            out = self.cell_type.folded(f, out)
        out = avg_pool(out, 8)
        return F.linear(out.flatten(1), *folded["linear"])


def PNASNetA(num_classes: int = 10) -> PNASNet:
    return PNASNet(CellA, 44, num_classes)


def PNASNetB(num_classes: int = 10) -> PNASNet:
    return PNASNet(CellB, 32, num_classes)
