"""Dual Path Networks for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/dpn.py``.

Each bottleneck (1x1 conv + BN + ReLU, a grouped 3x3 with ``groups = 32``
+ BN + ReLU, 1x1 conv + BN to ``out_planes + dense_depth``) emits a
residual path, its first ``out_planes`` channels, added to the shortcut's,
and a dense path, the rest, concatenated behind both stacks:
``relu(cat([x[:, :d] + out[:, :d], x[:, d:], out[:, d:]]))``. The
projection (1x1 conv + BN) exists only on each stage's first block. Stem
conv3x3(3 -> 64) + BN + ReLU; a 4x4 pool and a linear from
``out_planes[3] + (num_blocks[3] + 1) * dense_depth[3]``. Modules are
defined in the reference's order and under its names (``conv1``, ``bn1``,
``layer{1..4}.{i}.conv1..3/bn1..3/shortcut.0/.1``, ``linear``), so
``state_dict()`` is the reference layout.

Eval mode (:meth:`DPN.fold` / :meth:`DPN.folded_forward`): the stem goes
through the fused ``conv3x3_bn_relu`` kernel (1 launch a forward); the
grouped 3x3s and the 1x1s run ``F.conv2d`` plus the folded affine.

Golden param counts: DPN26 11,574,842 · DPN92 34,236,634.
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
    conv,
    conv_bn,
    fold_conv_bn,
    folded_dense,
)

CFG_BASE = {"in_planes": (96, 192, 384, 768),
            "out_planes": (256, 512, 1024, 2048),
            "dense_depth": (16, 32, 24, 128)}
GROUPS = 32


def _dual_path(x: torch.Tensor, out: torch.Tensor, d: int) -> torch.Tensor:
    return torch.relu(torch.cat([x[:, :d] + out[:, :d], x[:, d:],
                                 out[:, d:]], dim=1))


class Bottleneck(nn.Module):
    """The reference's DPN ``Bottleneck`` (the JAX ``DualPathBlock``)."""

    def __init__(self, last_planes: int, in_planes: int, out_planes: int,
                 dense_depth: int, stride: int, first_layer: bool):
        super().__init__()
        self.out_planes = out_planes
        self.conv1 = conv(last_planes, in_planes, 1)
        self.bn1 = batchnorm(in_planes)
        self.conv2 = conv(in_planes, in_planes, 3, stride, groups=GROUPS)
        self.bn2 = batchnorm(in_planes)
        self.conv3 = conv(in_planes, out_planes + dense_depth, 1)
        self.bn3 = batchnorm(out_planes + dense_depth)
        self.shortcut = nn.Sequential()
        if first_layer:
            self.shortcut = nn.Sequential(
                conv(last_planes, out_planes + dense_depth, 1, stride),
                batchnorm(out_planes + dense_depth))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return _dual_path(self.shortcut(x), out, self.out_planes)

    def fold(self, dtype) -> dict:
        return {
            "convs": [fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
                      fold_conv_bn(self.conv2, self.bn2, dtype, act=RELU),
                      fold_conv_bn(self.conv3, self.bn3, dtype)],
            "shortcut": fold_conv_bn(self.shortcut[0], self.shortcut[1],
                                     dtype) if len(self.shortcut) else None,
            "d": self.out_planes,
        }


def _block_forward(f: dict, x: torch.Tensor) -> torch.Tensor:
    out = x
    for site in f["convs"]:
        out = conv_bn(out, site)
    sc = x if f["shortcut"] is None else conv_bn(x, f["shortcut"])
    return _dual_path(sc, out, f["d"])


class DPN(nn.Module):
    def __init__(self, cfg: Mapping[str, Any], num_classes: int = 10):
        super().__init__()
        self.conv1 = conv(3, 64, 3)
        self.bn1 = batchnorm(64)
        self.last_planes = 64
        for i in range(4):
            setattr(self, f"layer{i + 1}", self._make_layer(
                cfg["in_planes"][i], cfg["out_planes"][i],
                cfg["num_blocks"][i], cfg["dense_depth"][i],
                1 if i == 0 else 2))
        self.linear = Linear(cfg["out_planes"][3] + (cfg["num_blocks"][3] + 1)
                             * cfg["dense_depth"][3], num_classes)

    def _make_layer(self, in_planes: int, out_planes: int, n: int,
                    dense_depth: int, stride: int) -> nn.Sequential:
        layers = []
        for i, s in enumerate([stride] + [1] * (n - 1)):
            layers.append(Bottleneck(self.last_planes, in_planes, out_planes,
                                     dense_depth, s, i == 0))
            self.last_planes = out_planes + (i + 2) * dense_depth
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
        return folded_dense(out.flatten(1), *folded["linear"])


def DPN26(num_classes: int = 10) -> DPN:
    return DPN(dict(CFG_BASE, num_blocks=(2, 2, 2, 2)), num_classes)


def DPN92(num_classes: int = 10) -> DPN:
    return DPN(dict(CFG_BASE, num_blocks=(3, 4, 20, 3)), num_classes)
