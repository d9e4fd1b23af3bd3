"""RegNet X/Y for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/regnet.py``.

A residual bottleneck of ratio 1: 1x1 conv + BN + ReLU, a grouped 3x3
(``groups = w_b // group_width``) + BN + ReLU, in the Y variants a
squeeze-excitation gate (:func:`~.common.se_gate`, whose width derives
from the block's *input* width: ``round(w_in * 0.25)``), a 1x1 conv + BN,
and a projection shortcut (1x1 conv + BN) on a stride or width change.
Stem conv3x3(3 -> 64) + BN + ReLU, four stages, a global mean and a
linear. Modules are defined in the reference's order and under its names
(``conv1``, ``bn1``, ``layer{1..4}.{i}.conv1/bn1/conv2/bn2/se.se1/se.se2/
conv3/bn3/shortcut.0/.1``, ``linear``), so ``state_dict()`` is the
reference layout.

Eval mode (:meth:`RegNet.fold` / :meth:`RegNet.folded_forward`): the stem
goes through the fused ``conv3x3_bn_relu`` kernel (1 launch a forward);
the grouped 3x3s (never depthwise) and the 1x1s run ``F.conv2d`` plus the
folded affine.

Golden param counts: X_200MF 2,321,946 · X_400MF 4,779,338 · Y_400MF
5,714,362.
"""

from __future__ import annotations

from typing import Any, List, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_cifar_tpu_torch.models.common import (
    RELU,
    Linear,
    batchnorm,
    conv,
    conv_bn,
    fold_conv_bn,
    global_avg_pool,
    se_gate,
)

X_200MF = {"depths": (1, 1, 4, 7), "widths": (24, 56, 152, 368),
           "strides": (1, 1, 2, 2), "group_width": 8,
           "bottleneck_ratio": 1, "se_ratio": 0}
X_400MF = {"depths": (1, 2, 7, 12), "widths": (32, 64, 160, 384),
           "strides": (1, 1, 2, 2), "group_width": 16,
           "bottleneck_ratio": 1, "se_ratio": 0}
Y_400MF = dict(X_400MF, se_ratio=0.25)


class SE(nn.Module):
    """Squeeze-excitation: 1x1 reduce and expand convs, with bias."""

    def __init__(self, in_planes: int, se_planes: int):
        super().__init__()
        self.se1 = conv(in_planes, se_planes, 1, bias=True)
        self.se2 = conv(se_planes, in_planes, 1, bias=True)

    def forward(self, x):
        return se_gate(x, self.se1.weight, self.se1.bias, self.se2.weight,
                       self.se2.bias)

    def fold(self, dtype) -> tuple:
        return tuple(t.to(dtype) for t in (self.se1.weight, self.se1.bias,
                                           self.se2.weight, self.se2.bias))


class Block(nn.Module):
    """The reference's RegNet ``Block``."""

    def __init__(self, w_in: int, w_out: int, stride: int, group_width: int,
                 bottleneck_ratio: float, se_ratio: float):
        super().__init__()
        w_b = int(round(w_out * bottleneck_ratio))
        self.conv1 = conv(w_in, w_b, 1)
        self.bn1 = batchnorm(w_b)
        self.conv2 = conv(w_b, w_b, 3, stride, groups=w_b // group_width)
        self.bn2 = batchnorm(w_b)
        self.with_se = se_ratio > 0
        if self.with_se:
            self.se = SE(w_b, int(round(w_in * se_ratio)))
        self.conv3 = conv(w_b, w_out, 1)
        self.bn3 = batchnorm(w_out)
        self.shortcut = nn.Sequential()
        if stride != 1 or w_in != w_out:
            self.shortcut = nn.Sequential(conv(w_in, w_out, 1, stride),
                                          batchnorm(w_out))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.with_se:
            out = self.se(out)
        out = self.bn3(self.conv3(out))
        return F.relu(out + self.shortcut(x))

    def fold(self, dtype) -> dict:
        return {
            "convs": [fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
                      fold_conv_bn(self.conv2, self.bn2, dtype, act=RELU)],
            "se": self.se.fold(dtype) if self.with_se else None,
            "project": fold_conv_bn(self.conv3, self.bn3, dtype),
            "shortcut": fold_conv_bn(self.shortcut[0], self.shortcut[1],
                                     dtype) if len(self.shortcut) else None,
        }


def _block_forward(f: dict, x: torch.Tensor) -> torch.Tensor:
    out = x
    for site in f["convs"]:
        out = conv_bn(out, site)
    if f["se"] is not None:
        out = se_gate(out, *f["se"])
    out = conv_bn(out, f["project"])
    sc = x if f["shortcut"] is None else conv_bn(x, f["shortcut"])
    return torch.relu(out + sc)


class RegNet(nn.Module):
    def __init__(self, cfg: Mapping[str, Any], num_classes: int = 10):
        super().__init__()
        self.cfg = cfg
        self.in_planes = 64
        self.conv1 = conv(3, 64, 3)
        self.bn1 = batchnorm(64)
        for i in range(4):
            setattr(self, f"layer{i + 1}", self._make_layer(i))
        self.linear = Linear(cfg["widths"][-1], num_classes)

    def _make_layer(self, idx: int) -> nn.Sequential:
        cfg = self.cfg
        layers = []
        for i in range(cfg["depths"][idx]):
            layers.append(Block(
                self.in_planes, cfg["widths"][idx],
                cfg["strides"][idx] if i == 0 else 1, cfg["group_width"],
                cfg["bottleneck_ratio"], cfg["se_ratio"]))
            self.in_planes = cfg["widths"][idx]
        return nn.Sequential(*layers)

    def blocks(self) -> List[nn.Module]:
        return [b for i in range(4) for b in getattr(self, f"layer{i + 1}")]

    def forward(self, x):
        if not self.training:
            return self.folded_forward(self.fold(x.dtype), x)
        x = x.contiguous(memory_format=torch.channels_last)
        out = F.relu(self.bn1(self.conv1(x)))
        for b in self.blocks():
            out = b(out)
        return self.linear(global_avg_pool(out))

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
        return F.linear(global_avg_pool(out), *folded["linear"])


def RegNetX_200MF(num_classes: int = 10) -> RegNet:
    return RegNet(X_200MF, num_classes)


def RegNetX_400MF(num_classes: int = 10) -> RegNet:
    return RegNet(X_400MF, num_classes)


def RegNetY_400MF(num_classes: int = 10) -> RegNet:
    return RegNet(Y_400MF, num_classes)
