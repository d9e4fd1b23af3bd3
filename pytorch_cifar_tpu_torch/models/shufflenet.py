"""ShuffleNet (v1) G2/G3 for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/shufflenet.py``.

A bottleneck of a grouped 1x1 conv + BN + ReLU, a channel shuffle, a
depthwise 3x3 + BN + ReLU and a grouped 1x1 conv + BN; a stride-2 block
(each stage's first) concatenates ``[out, avg_pool(x, 3, 2, 1)]``, a
stride-1 block adds ``x``; ReLU after either. Each stage's first block
emits ``out_planes - in_planes`` channels. The first block's first 1x1
uses ``groups = 1`` (the 24-channel stem is not group-divisible) and
shuffles in one group; its last 1x1 keeps ``groups``. ``mid = out_planes
// 4`` is the integer fix of the reference's Python 3 float (SURVEY.md
§2.5.1). Stem conv1x1(3 -> 24) + BN + ReLU; a 4x4 pool and a linear.
Modules are defined in the reference's order and under its names
(``conv1``, ``bn1``, ``layer{1..3}.{i}.conv1..3/bn1..3``, ``linear``; the
shuffle and the pool hold no parameters), so ``state_dict()`` is the
reference layout.

Eval mode (:meth:`ShuffleNet.fold` / :meth:`ShuffleNet.folded_forward`):
the 13 stride-1 depthwise convs go through the ``depthwise_stencil``
kernel (on 50 / 100 / 200 channels at 16x16 / 8x8 / 4x4 for G2, 60 / 120
/ 240 for G3), BN and ReLU after it in the compute dtype; the 3 stride-2
depthwise convs, the grouped 1x1s and the 1x1 stem stay ``F.conv2d`` plus
the folded affine.

Golden param counts (with the integer fix): G2 887,582 · G3 862,768.
"""

from __future__ import annotations

from typing import Any, List, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_cifar_tpu_torch.models.common import (
    RELU,
    Linear,
    avg_pool,
    batchnorm,
    channel_shuffle,
    conv,
    conv_bn,
    fold_conv_bn,
)

STEM = 24


class Bottleneck(nn.Module):
    """The reference's ShuffleNet ``Bottleneck`` (the JAX
    ``ShuffleBottleneck``)."""

    def __init__(self, in_planes: int, out_planes: int, stride: int,
                 groups: int):
        super().__init__()
        self.stride = stride
        mid = out_planes // 4
        self.g = 1 if in_planes == STEM else groups
        self.conv1 = conv(in_planes, mid, 1, groups=self.g)
        self.bn1 = batchnorm(mid)
        self.conv2 = conv(mid, mid, 3, stride, groups=mid)
        self.bn2 = batchnorm(mid)
        self.conv3 = conv(mid, out_planes, 1, groups=groups)
        self.bn3 = batchnorm(out_planes)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = channel_shuffle(out, self.g)
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return _join(out, x, self.stride)

    def fold(self, dtype) -> dict:
        return {
            "reduce": fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
            "g": self.g,
            "depthwise": fold_conv_bn(self.conv2, self.bn2, dtype, act=RELU),
            "expand": fold_conv_bn(self.conv3, self.bn3, dtype),
            "stride": self.stride,
        }


def _join(out: torch.Tensor, x: torch.Tensor, stride: int) -> torch.Tensor:
    if stride == 2:
        return torch.relu(torch.cat([out, avg_pool(x, 3, 2, 1)], dim=1))
    return torch.relu(out + x)


def _block_forward(f: dict, x: torch.Tensor) -> torch.Tensor:
    out = channel_shuffle(conv_bn(x, f["reduce"]), f["g"])
    out = conv_bn(conv_bn(out, f["depthwise"]), f["expand"])
    return _join(out, x, f["stride"])


class ShuffleNet(nn.Module):
    def __init__(self, cfg: Mapping[str, Any], num_classes: int = 10):
        super().__init__()
        self.conv1 = conv(3, STEM, 1)
        self.bn1 = batchnorm(STEM)
        self.in_planes = STEM
        for i, (out, n) in enumerate(zip(cfg["out_planes"],
                                         cfg["num_blocks"])):
            setattr(self, f"layer{i + 1}",
                    self._make_layer(out, n, cfg["groups"]))
        self.linear = Linear(cfg["out_planes"][2], num_classes)

    def _make_layer(self, out_planes: int, n: int,
                    groups: int) -> nn.Sequential:
        layers = []
        for i in range(n):
            cat_planes = self.in_planes if i == 0 else 0
            layers.append(Bottleneck(self.in_planes, out_planes - cat_planes,
                                     2 if i == 0 else 1, groups))
            self.in_planes = out_planes
        return nn.Sequential(*layers)

    def blocks(self) -> List[nn.Module]:
        return [b for i in range(3) for b in getattr(self, f"layer{i + 1}")]

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
        out = avg_pool(out, 4)
        return F.linear(out.flatten(1), *folded["linear"])


def ShuffleNetG2(num_classes: int = 10) -> ShuffleNet:
    return ShuffleNet({"out_planes": (200, 400, 800), "num_blocks": (4, 8, 4),
                       "groups": 2}, num_classes)


def ShuffleNetG3(num_classes: int = 10) -> ShuffleNet:
    return ShuffleNet({"out_planes": (240, 480, 960), "num_blocks": (4, 8, 4),
                       "groups": 3}, num_classes)
