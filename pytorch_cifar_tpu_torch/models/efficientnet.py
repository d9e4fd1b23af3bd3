"""EfficientNet-B0 for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/efficientnet.py``.

MBConv blocks: a 1x1 expand conv + BN + swish (skipped at expand ratio 1),
a 3x3 or 5x5 depthwise conv + BN + swish, squeeze-excitation (a global mean,
a 1x1 conv with bias + swish, a 1x1 conv with bias + sigmoid, a product; its
width is the block's *input* channels x 0.25), a 1x1 project conv + BN, and
a skip connection at stride 1 when the channels match, through per-sample
stochastic depth in training (rate ``0.2 * b / 16`` for block ``b``). Stem
conv3x3 + BN + swish; head: a global mean, dropout 0.2 in training and a
linear. Modules are defined in the reference's order and under its names
(``conv1``, ``bn1``, ``layers.{i}.conv1/bn1/conv2/bn2/se.se1/se.se2/conv3/
bn3``, ``linear``), so ``state_dict()`` is the reference layout.

The reference builds ``conv1``/``bn1`` even at expand ratio 1 and never
calls them: block 0 carries 1,088 dead parameters, which the golden count
includes. Their gradient is zero (the train step gives them one, as the JAX
step's gradient tree does), and the dead BN's running statistics are never
updated.

The random draws (drop-connect's per-sample masks, the head's dropout mask)
come from :func:`~.common.keep_mask`, which reads the draw function the
train step sets; eval draws nothing.

Eval mode (:meth:`EfficientNet.fold` / :meth:`EfficientNet.folded_forward`):
the 12 stride-1 depthwise convs go through the ``depthwise_stencil`` kernel
with swish after the folded affine (k = 3 at 32x32 x 32, 16x16 x 144, 4x4 x
480 twice and 2x2 x 1,152; k = 5 at 8x8 x 240, 4x4 x 480, 4x4 x 672 twice
and 2x2 x 1,152 three times); the stem (swish, not ReLU: no fused site),
the 4 stride-2 depthwise convs and every 1x1 conv stay ``F.conv2d`` plus
the folded affine.

Golden param count: 3,599,686.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_cifar_tpu_torch.models.common import (
    SWISH,
    Linear,
    batchnorm,
    conv,
    conv_bn,
    drop_connect,
    fold_conv_bn,
    folded_dense,
    global_avg_pool,
    keep_mask,
    swish,
)

B0 = {
    "num_blocks": (1, 2, 2, 3, 3, 4, 1),
    "expansion": (1, 6, 6, 6, 6, 6, 6),
    "out_channels": (16, 24, 40, 80, 112, 192, 320),
    "kernel_size": (3, 3, 5, 3, 5, 5, 3),
    "stride": (1, 2, 2, 2, 1, 2, 1),
    "dropout_rate": 0.2,
    "drop_connect_rate": 0.2,
}


class SE(nn.Module):
    """Squeeze-excitation with swish on the reduce conv."""

    def __init__(self, in_channels: int, se_channels: int):
        super().__init__()
        self.se1 = conv(in_channels, se_channels, 1, bias=True)
        self.se2 = conv(se_channels, in_channels, 1, bias=True)

    def forward(self, x):
        # the folded forward's arithmetic, on weights that keep their graph
        # (a 1x1 conv of the squeezed map is no window op of a slab)
        return _se_forward(self.fold(x.dtype), x)

    def fold(self, dtype) -> tuple:
        return tuple(t.to(dtype) for t in (self.se1.weight, self.se1.bias,
                                           self.se2.weight, self.se2.bias))


def _se_forward(f: tuple, x: torch.Tensor) -> torch.Tensor:
    w1, b1, w2, b2 = f
    w = global_avg_pool(x, keepdim=True)
    w = torch.sigmoid(F.conv2d(swish(F.conv2d(w, w1, b1)), w2, b2))
    return x * w


class MBConv(nn.Module):
    """expand + depthwise + SE + project (the reference's ``Block``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, expand_ratio: int = 1, se_ratio: float = 0.0,
                 drop_rate: float = 0.0):
        super().__init__()
        self.stride = stride
        self.drop_rate = drop_rate
        self.expand_ratio = expand_ratio
        channels = expand_ratio * in_channels
        self.conv1 = conv(in_channels, channels, 1)
        self.bn1 = batchnorm(channels)
        self.conv2 = conv(channels, channels, kernel_size, stride,
                          groups=channels)
        self.bn2 = batchnorm(channels)
        self.se = SE(channels, int(in_channels * se_ratio))
        self.conv3 = conv(channels, out_channels, 1)
        self.bn3 = batchnorm(out_channels)
        self.has_skip = stride == 1 and in_channels == out_channels

    def forward(self, x):
        out = x
        if self.expand_ratio != 1:  # else conv1/bn1 are dead
            out = swish(self.bn1(self.conv1(x)))
        out = swish(self.bn2(self.conv2(out)))
        out = self.se(out)
        out = self.bn3(self.conv3(out))
        if self.has_skip:
            if self.training and self.drop_rate > 0:
                mask = keep_mask((out.shape[0], 1, 1, 1),
                                 1.0 - self.drop_rate)
                out = drop_connect(out, mask, self.drop_rate)
            out = out + x
        return out

    def fold(self, dtype) -> dict:
        return {
            "expand": fold_conv_bn(self.conv1, self.bn1, dtype, act=SWISH)
            if self.expand_ratio != 1 else None,
            "depthwise": fold_conv_bn(self.conv2, self.bn2, dtype, act=SWISH),
            "se": self.se.fold(dtype),
            "project": fold_conv_bn(self.conv3, self.bn3, dtype),
            "skip": self.has_skip,
        }


def _block_forward(f: dict, x: torch.Tensor) -> torch.Tensor:
    out = x if f["expand"] is None else conv_bn(x, f["expand"])
    out = conv_bn(out, f["depthwise"])
    out = _se_forward(f["se"], out)
    out = conv_bn(out, f["project"])
    return out + x if f["skip"] else out


class EfficientNet(nn.Module):
    def __init__(self, cfg: Mapping[str, Any], num_classes: int = 10):
        super().__init__()
        self.cfg = cfg
        self.conv1 = conv(3, 32, 3)
        self.bn1 = batchnorm(32)
        self.layers = self._make_layers(32)
        self.linear = Linear(cfg["out_channels"][-1], num_classes)

    def _make_layers(self, in_channels: int) -> nn.Sequential:
        cfg = self.cfg
        blocks, b = [], 0
        total = sum(cfg["num_blocks"])
        for expansion, out_channels, n, k, stride in zip(
                cfg["expansion"], cfg["out_channels"], cfg["num_blocks"],
                cfg["kernel_size"], cfg["stride"]):
            for s in [stride] + [1] * (n - 1):
                blocks.append(MBConv(
                    in_channels, out_channels, k, s, expansion, se_ratio=0.25,
                    drop_rate=cfg["drop_connect_rate"] * b / total))
                in_channels = out_channels
                b += 1
        return nn.Sequential(*blocks)

    def forward(self, x):
        if not self.training:
            return self.folded_forward(self.fold(x.dtype), x)
        x = x.contiguous(memory_format=torch.channels_last)
        out = swish(self.bn1(self.conv1(x)))
        out = self.layers(out)
        out = global_avg_pool(out)
        rate = self.cfg["dropout_rate"]
        if rate > 0:
            out = drop_connect(out, keep_mask(tuple(out.shape), 1.0 - rate),
                               rate)
        return self.linear(out)

    def fold(self, dtype: torch.dtype) -> dict:
        """The eval-mode weights for ``dtype`` compute (see
        :meth:`.resnet.ResNet.fold`)."""
        with torch.no_grad():
            return {
                "stem": fold_conv_bn(self.conv1, self.bn1, dtype, act=SWISH),
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
        for f in folded["blocks"]:
            out = _block_forward(f, out)
        return folded_dense(global_avg_pool(out), *folded["linear"])


def EfficientNetB0(num_classes: int = 10) -> EfficientNet:
    return EfficientNet(B0, num_classes)
