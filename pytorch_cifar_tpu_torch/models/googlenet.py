"""GoogLeNet for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/googlenet.py``.

Inception cells of four parallel branches concatenated on channels: 1x1 /
1x1 -> 3x3 / 1x1 -> 3x3 -> 3x3 / maxpool 3 -> 1x1, every conv with its bias
and followed by BN and ReLU. The stem is conv3x3(3 -> 192) + BN + ReLU, the
stage transitions are max pools 3 / stride 2 / pad 1, the head an 8x8
average pool and a 1024 -> classes linear. Modules are defined in the
reference's order and under its names (``pre_layers.0/.1``, cells ``a3`` ..
``b5`` with ``b1.0/.1``, ``b2.0/.1/.3/.4``, ``b3.0/.1/.3/.4/.6/.7``,
``b4.1/.2``, ``linear``), so ``state_dict()`` is the reference layout.

``merged_1x1`` (on by default, as in the JAX model) runs the three
same-input 1x1 convs of a cell (``b1.0``, ``b2.0``, ``b3.0``) in train mode
as ONE conv over the concatenated weights, with one
:func:`~.common.bn_batch_moments` reduce over the merged output, sliced to
each branch's ``BatchNorm(..., moments=m)``. Exact, not approximate: every
conv output channel is its own dot product and BN statistics are per
channel. ``merged_1x1=False`` runs the literal branches; both share one
``state_dict``. (The JAX model's ``merged_3x3``, a measured negative that is
off by default there, is not ported.)

The pool branch (3 / 1 / 1) goes through
``ops.max_pool.max_pool3x3_s1`` in both modes: 9 forward launches per
forward, with a winner map and 9 backward launches per train step.

Eval mode: :meth:`GoogLeNet.fold` folds every BN and conv bias into its conv
once per weight set; :meth:`GoogLeNet.folded_forward` runs the stem and
the three 3x3 convs of every cell through the fused ``conv3x3_bn_relu``
kernel (28 launches per forward). The three 1x1 heads are folded into one
conv here whatever ``merged_1x1`` says (a third of the launches, the same
values); the 3x3 convs that follow read channel slices of its output, which
the NHWC kernel cannot take (it reads dense pixels), so each slice is
copied once to a dense channels_last tensor, 96-192 of the cell's 256-832
channels.

Golden param count: 6,166,250.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_cifar_tpu_torch.models.common import (
    RELU,
    FoldedConvBN,
    Linear,
    avg_pool,
    batchnorm,
    bn_batch_moments,
    conv,
    conv_bn,
    fold_conv_bn,
    max_pool,
)

# (n1x1, n3x3red, n3x3, n5x5red, n5x5, pool_planes) per cell in forward
# order; None marks a max pool 3 / stride 2 / pad 1 transition
CELLS: Tuple = (
    ("a3", (64, 96, 128, 16, 32, 32)),
    ("b3", (128, 128, 192, 32, 96, 64)),
    None,
    ("a4", (192, 96, 208, 16, 48, 64)),
    ("b4", (160, 112, 224, 24, 64, 64)),
    ("c4", (128, 128, 256, 24, 64, 64)),
    ("d4", (112, 144, 288, 32, 64, 64)),
    ("e4", (256, 160, 320, 32, 128, 128)),
    None,
    ("a5", (256, 160, 320, 32, 128, 128)),
    ("b5", (384, 192, 384, 48, 128, 128)),
)


class MaxPool3x3(nn.Module):
    """The cell's 3 / stride 1 / pad 1 pool (kernel K4 on a CUDA tensor)."""

    def forward(self, x):
        return max_pool(x, 3, stride=1, padding=1)


def _cbr(cin: int, cout: int, k: int) -> List[nn.Module]:
    return [conv(cin, cout, k, bias=True), batchnorm(cout),
            nn.ReLU(inplace=True)]


class Inception(nn.Module):
    """Four-branch inception cell; output channels = sum of branch widths."""

    def __init__(self, in_planes: int, n1x1: int, n3x3red: int, n3x3: int,
                 n5x5red: int, n5x5: int, pool_planes: int,
                 merged_1x1: bool = True):
        super().__init__()
        self.merged_1x1 = merged_1x1
        self.b1 = nn.Sequential(*_cbr(in_planes, n1x1, 1))
        self.b2 = nn.Sequential(*_cbr(in_planes, n3x3red, 1),
                                *_cbr(n3x3red, n3x3, 3))
        self.b3 = nn.Sequential(*_cbr(in_planes, n5x5red, 1),
                                *_cbr(n5x5red, n5x5, 3),
                                *_cbr(n5x5, n5x5, 3))
        self.b4 = nn.Sequential(MaxPool3x3(), *_cbr(in_planes, pool_planes, 1))

    def _heads(self):
        """The three same-input (1x1 conv, BN) pairs, in branch order."""
        return [(b[0], b[1]) for b in (self.b1, self.b2, self.b3)]

    def _merged_heads(self, x):
        """The three 1x1 conv + BN + ReLU heads as one conv and one moments
        reduce (train mode; in eval mode the BNs read their running stats
        and the moments are not computed)."""
        heads = self._heads()
        weight = torch.cat([c.weight for c, _ in heads]).to(x.dtype)
        bias = torch.cat([c.bias for c, _ in heads]).to(x.dtype)
        h = F.conv2d(x, weight, bias)
        widths = [c.out_channels for c, _ in heads]
        if self.training:
            moments = zip(*(m.split(widths) for m in bn_batch_moments(h)))
        else:
            moments = [None] * len(heads)
        # split, not three slices: its backward is one concatenation
        return [F.relu(bn(part, moments=m), inplace=True)
                for (_, bn), part, m in zip(heads, h.split(widths, dim=1),
                                            moments)]

    def forward(self, x):
        if self.merged_1x1:
            y1, y2, y3 = self._merged_heads(x)
            y2, y3 = self.b2[3:](y2), self.b3[3:](y3)
        else:
            y1, y2, y3 = self.b1(x), self.b2(x), self.b3(x)
        return torch.cat([y1, y2, y3, self.b4(x)], dim=1)

    def fold(self, dtype) -> dict:
        """``heads``: the three 1x1 sites as one folded conv, with the
        widths to split its output by; ``b2``/``b3``: the 3x3 sites that
        follow (fused); ``b4``: the 1x1 after the pool."""
        heads = [fold_conv_bn(c, bn, dtype, act=RELU)
                 for c, bn in self._heads()]
        merged = FoldedConvBN(
            torch.cat([f.weight for f in heads]).contiguous(
                memory_format=torch.channels_last
            ),
            torch.cat([f.mul for f in heads], dim=1),
            torch.cat([f.add for f in heads], dim=1),
            stride=1, padding=0, act=RELU, fused=False,
        )
        return {
            "heads": merged,
            "widths": [f.weight.shape[0] for f in heads],
            "b2": [fold_conv_bn(self.b2[3], self.b2[4], dtype, act=RELU)],
            "b3": [fold_conv_bn(self.b3[3], self.b3[4], dtype, act=RELU),
                   fold_conv_bn(self.b3[6], self.b3[7], dtype, act=RELU)],
            "b4": fold_conv_bn(self.b4[1], self.b4[2], dtype, act=RELU),
        }


def _cell_forward(f: dict, x: torch.Tensor) -> torch.Tensor:
    """One folded cell. The fused 3x3 kernel reads dense NHWC pixels, so the
    two reduce slices of the merged heads' output are copied dense first."""
    y1, y2, y3 = torch.split(conv_bn(x, f["heads"]), f["widths"], dim=1)
    for site in f["b2"]:
        y2 = conv_bn(y2.contiguous(memory_format=torch.channels_last), site)
    for site in f["b3"]:
        y3 = conv_bn(y3.contiguous(memory_format=torch.channels_last), site)
    y4 = conv_bn(max_pool(x, 3, stride=1, padding=1), f["b4"])
    return torch.cat([y1, y2, y3, y4], dim=1)


class GoogLeNet(nn.Module):
    def __init__(self, num_classes: int = 10, merged_1x1: bool = True):
        super().__init__()
        self.pre_layers = nn.Sequential(*_cbr(3, 192, 3))
        in_planes = 192
        for cell in CELLS:
            if cell is None:
                continue
            name, widths = cell
            setattr(self, name, Inception(in_planes, *widths,
                                          merged_1x1=merged_1x1))
            in_planes = widths[0] + widths[2] + widths[4] + widths[5]
        self.linear = Linear(in_planes, num_classes)

    def cells(self) -> list:
        """The Inception cells in forward order, None at each stage
        transition."""
        return [None if c is None else getattr(self, c[0]) for c in CELLS]

    def forward(self, x):
        if not self.training:
            return self.folded_forward(self.fold(x.dtype), x)
        out = self.pre_layers(x.contiguous(memory_format=torch.channels_last))
        for cell in self.cells():
            out = max_pool(out, 3, stride=2, padding=1) if cell is None \
                else cell(out)
        out = avg_pool(out, 8, stride=1)
        return self.linear(out.flatten(1))

    def fold(self, dtype: torch.dtype) -> dict:
        """The eval-mode weights for ``dtype`` compute (see
        :meth:`.resnet.ResNet.fold`)."""
        with torch.no_grad():
            return {
                "stem": fold_conv_bn(self.pre_layers[0], self.pre_layers[1],
                                     dtype, act=RELU),
                "cells": [None if c is None else c.fold(dtype)
                          for c in self.cells()],
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
            out = max_pool(out, 3, stride=2, padding=1) if f is None \
                else _cell_forward(f, out)
        out = avg_pool(out, 8, stride=1)
        return F.linear(out.flatten(1), *folded["linear"])
