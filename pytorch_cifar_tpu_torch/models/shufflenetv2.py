"""ShuffleNetV2 for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/shufflenetv2.py``.

A basic block splits the channels at ``c = int(C * 0.5)``, transforms the
second part (1x1 conv + BN + ReLU, 3x3 depthwise + BN with no ReLU, 1x1
conv + BN + ReLU), concatenates the untouched first part before it and
shuffles the channels in two groups. A down block runs two stride-2
branches (depthwise + BN, 1x1 + BN + ReLU; and 1x1 + BN + ReLU, depthwise +
BN, 1x1 + BN + ReLU), concatenated and shuffled. Stem conv3x3(3 -> 24) +
BN + ReLU (the ImageNet max pool removed), three stages of a down block and
3 / 7 / 3 basic blocks, a 1x1 conv + BN + ReLU to 1024 (2048 at 2x), a 4x4
average pool and a linear. Modules are defined in the reference's order and
under its names (``conv1``, ``bn1``, ``layer{1..3}.{i}.conv1..5/bn1..5``,
``conv2``, ``bn2``, ``linear``), so ``state_dict()`` is the reference
layout.

Eval mode (:meth:`ShuffleNetV2.fold` / :meth:`ShuffleNetV2.folded_forward`):
the stem goes through the fused ``conv3x3_bn_relu`` kernel (1 launch a
forward) and the 13 basic blocks' stride-1 depthwise convs through the
``depthwise_stencil`` kernel (13 launches, on C / 2 channels: 24 / 48 / 96
at 0.5x, 58 / 116 / 232 at 1x, 88 / 176 / 352 at 1.5x, 112 / 244 / 488 at
2x); the down blocks' stride-2 depthwise convs and every 1x1 conv stay
``F.conv2d`` plus the folded affine. The split's halves are views of the
block's input: the 1x1 conv reads its half in place, and the stencil site
gets that conv's dense output.

Golden param counts: 0.5x 352,042 · 1x 1,263,854 · 1.5x 2,488,874 · 2x
5,338,026.
"""

from __future__ import annotations

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
    folded_dense,
)

SPLIT_RATIO = 0.5
# net size -> (out channels of the three stages and the head, basic blocks
# of the three stages)
CONFIGS = {
    0.5: ((48, 96, 192, 1024), (3, 7, 3)),
    1: ((116, 232, 464, 1024), (3, 7, 3)),
    1.5: ((176, 352, 704, 1024), (3, 7, 3)),
    2: ((224, 488, 976, 2048), (3, 7, 3)),
}


def _split(x: torch.Tensor):
    c = int(x.shape[1] * SPLIT_RATIO)
    return x[:, :c], x[:, c:]


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels - int(in_channels * SPLIT_RATIO)  # the second part
        self.conv1 = conv(c, c, 1)
        self.bn1 = batchnorm(c)
        self.conv2 = conv(c, c, 3, groups=c)
        self.bn2 = batchnorm(c)
        self.conv3 = conv(c, c, 1)
        self.bn3 = batchnorm(c)

    def forward(self, x):
        x1, x2 = _split(x)
        out = F.relu(self.bn1(self.conv1(x2)))
        out = self.bn2(self.conv2(out))  # no ReLU after the depthwise
        out = F.relu(self.bn3(self.conv3(out)))
        return channel_shuffle(torch.cat([x1, out], dim=1), 2)

    def fold(self, dtype) -> list:
        return [fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
                fold_conv_bn(self.conv2, self.bn2, dtype),
                fold_conv_bn(self.conv3, self.bn3, dtype, act=RELU)]


class DownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        mid = out_channels // 2
        # left: depthwise stride 2 -> 1x1
        self.conv1 = conv(in_channels, in_channels, 3, 2, groups=in_channels)
        self.bn1 = batchnorm(in_channels)
        self.conv2 = conv(in_channels, mid, 1)
        self.bn2 = batchnorm(mid)
        # right: 1x1 -> depthwise stride 2 -> 1x1
        self.conv3 = conv(in_channels, mid, 1)
        self.bn3 = batchnorm(mid)
        self.conv4 = conv(mid, mid, 3, 2, groups=mid)
        self.bn4 = batchnorm(mid)
        self.conv5 = conv(mid, mid, 1)
        self.bn5 = batchnorm(mid)

    def forward(self, x):
        left = self.bn1(self.conv1(x))
        left = F.relu(self.bn2(self.conv2(left)))
        right = F.relu(self.bn3(self.conv3(x)))
        right = self.bn4(self.conv4(right))
        right = F.relu(self.bn5(self.conv5(right)))
        return channel_shuffle(torch.cat([left, right], dim=1), 2)

    def fold(self, dtype) -> dict:
        return {
            "left": [fold_conv_bn(self.conv1, self.bn1, dtype),
                     fold_conv_bn(self.conv2, self.bn2, dtype, act=RELU)],
            "right": [fold_conv_bn(self.conv3, self.bn3, dtype, act=RELU),
                      fold_conv_bn(self.conv4, self.bn4, dtype),
                      fold_conv_bn(self.conv5, self.bn5, dtype, act=RELU)],
        }


def _sites(sites, x):
    for site in sites:
        x = conv_bn(x, site)
    return x


def _block_forward(f, x: torch.Tensor) -> torch.Tensor:
    """One folded block: a basic block's three sites (a list) or a down
    block's two branches (a dict)."""
    if isinstance(f, dict):
        parts = [_sites(f["left"], x), _sites(f["right"], x)]
    else:
        x1, x2 = _split(x)
        parts = [x1, _sites(f, x2)]
    return channel_shuffle(torch.cat(parts, dim=1), 2)


class ShuffleNetV2(nn.Module):
    def __init__(self, net_size: float = 1, num_classes: int = 10):
        super().__init__()
        out_channels, num_blocks = CONFIGS[net_size]
        self.conv1 = conv(3, 24, 3)
        self.bn1 = batchnorm(24)
        cin = 24
        for i, (cout, n) in enumerate(zip(out_channels[:3], num_blocks)):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                DownBlock(cin, cout), *[BasicBlock(cout) for _ in range(n)]))
            cin = cout
        self.conv2 = conv(cin, out_channels[3], 1)
        self.bn2 = batchnorm(out_channels[3])
        self.linear = Linear(out_channels[3], num_classes)

    def blocks(self) -> list:
        return [b for i in range(3) for b in getattr(self, f"layer{i + 1}")]

    def forward(self, x):
        if not self.training:
            return self.folded_forward(self.fold(x.dtype), x)
        x = x.contiguous(memory_format=torch.channels_last)
        out = F.relu(self.bn1(self.conv1(x)))
        for b in self.blocks():
            out = b(out)
        out = F.relu(self.bn2(self.conv2(out)))
        out = avg_pool(out, 4)
        return self.linear(out.flatten(1))

    def fold(self, dtype: torch.dtype) -> dict:
        """The eval-mode weights for ``dtype`` compute (see
        :meth:`.resnet.ResNet.fold`)."""
        with torch.no_grad():
            return {
                "stem": fold_conv_bn(self.conv1, self.bn1, dtype, act=RELU),
                "blocks": [b.fold(dtype) for b in self.blocks()],
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
        return folded_dense(out.flatten(1), *folded["linear"])


def ShuffleNetV2_05(num_classes: int = 10) -> ShuffleNetV2:
    return ShuffleNetV2(0.5, num_classes)


def ShuffleNetV2_1(num_classes: int = 10) -> ShuffleNetV2:
    return ShuffleNetV2(1, num_classes)


def ShuffleNetV2_15(num_classes: int = 10) -> ShuffleNetV2:
    return ShuffleNetV2(1.5, num_classes)


def ShuffleNetV2_2(num_classes: int = 10) -> ShuffleNetV2:
    return ShuffleNetV2(2, num_classes)
