"""SENet18 for CIFAR-10, PyTorch port of ``pytorch_cifar_tpu/models/senet.py``.

Pre-activation basic blocks (see :mod:`.preact_resnet`: the projection
shortcut, a 1x1 conv with no BN, branches off the pre-activated input)
with a squeeze-excitation gate on the block's output before the residual
add: the global mean, ``fc1`` (a 1x1 conv with bias to ``planes // 16``),
ReLU, ``fc2`` (back to ``planes``, with bias), sigmoid, a product
(:func:`~.common.se_gate`). Stem conv3x3 + BN + ReLU; stages 64 / 128 /
256 / 512 at strides 1 / 2 / 2 / 2; a 4x4 pool and a linear. Modules are
defined in the reference's order and under its names (``conv1``, ``bn1``,
``layer{1..4}.{i}.bn1/conv1/bn2/conv2/shortcut.0/fc1/fc2``, ``linear``),
so ``state_dict()`` is the reference layout.

Eval mode (:meth:`SENet.fold` / :meth:`SENet.folded_forward`): the stem and
each block's stride-1 ``conv1`` (with ``bn2`` and its ReLU) go through the
fused ``conv3x3_bn_relu`` kernel, 6 launches a forward; each block's
``bn1`` is an affine + ReLU, its ``conv2``, stride-2 ``conv1`` and
shortcut stay plain ``F.conv2d``, and the gate computes in the compute
dtype.

Golden param count: SENet18 11,260,354.
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
    se_gate,
)


class PreActBlock(nn.Module):
    """BN-ReLU-conv3x3 -> BN-ReLU-conv3x3, the SE gate, the residual add
    (the reference's ``PreActBlock`` of ``senet.py``)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = batchnorm(in_planes)
        self.conv1 = conv(in_planes, planes, 3, stride)
        self.bn2 = batchnorm(planes)
        self.conv2 = conv(planes, planes, 3)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(conv(in_planes, planes, 1, stride))
        self.fc1 = conv(planes, planes // 16, 1, bias=True)
        self.fc2 = conv(planes // 16, planes, 1, bias=True)

    def forward(self, x):
        out = F.relu(self.bn1(x))
        shortcut = self.shortcut(out) if len(self.shortcut) else x
        out = self.conv1(out)
        out = self.conv2(F.relu(self.bn2(out)))
        out = se_gate(out, self.fc1.weight, self.fc1.bias, self.fc2.weight,
                      self.fc2.bias)
        return out + shortcut

    def fold(self, dtype) -> dict:
        return {
            "pre": fold_affine(self.bn1, dtype),
            "convs": [fold_conv_bn(self.conv1, self.bn2, dtype, act=RELU),
                      fold_conv_bn(self.conv2, None, dtype)],
            "shortcut": fold_conv_bn(self.shortcut[0], None, dtype)
            if len(self.shortcut) else None,
            "se": tuple(t.to(dtype) for t in (
                self.fc1.weight, self.fc1.bias, self.fc2.weight,
                self.fc2.bias)),
        }


def _block_forward(f: dict, x: torch.Tensor) -> torch.Tensor:
    out = affine_relu(x, f["pre"])
    sc = x if f["shortcut"] is None else conv_bn(out, f["shortcut"])
    for site in f["convs"]:
        out = conv_bn(out, site)
    return se_gate(out, *f["se"]) + sc


class SENet(nn.Module):
    def __init__(self, num_blocks: Sequence[int], num_classes: int = 10):
        super().__init__()
        self.in_planes = 64
        self.conv1 = conv(3, 64, 3)
        self.bn1 = batchnorm(64)
        self.layer1 = self._make_layer(64, num_blocks[0], 1)
        self.layer2 = self._make_layer(128, num_blocks[1], 2)
        self.layer3 = self._make_layer(256, num_blocks[2], 2)
        self.layer4 = self._make_layer(512, num_blocks[3], 2)
        self.linear = Linear(512, num_classes)

    def _make_layer(self, planes: int, n: int, stride: int):
        layers = []
        for s in [stride] + [1] * (n - 1):
            layers.append(PreActBlock(self.in_planes, planes, s))
            self.in_planes = planes
        return nn.Sequential(*layers)

    def blocks(self) -> List[nn.Module]:
        return [b for layer in (self.layer1, self.layer2, self.layer3,
                                self.layer4) for b in layer]

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


def SENet18(num_classes: int = 10) -> SENet:
    return SENet((2, 2, 2, 2), num_classes)
