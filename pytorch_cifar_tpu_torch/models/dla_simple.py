"""SimpleDLA for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/dla_simple.py`` (the default model of both
trainers).

Deep-layer aggregation with a binary :class:`Tree`: the left subtree runs at
the stage's stride, the right subtree takes the left's output, and a
:class:`Root` (concatenate on channels, 1x1 conv, BN, ReLU) aggregates the
two. The leaves are ResNet ``BasicBlock`` s (:mod:`.resnet`). Stages: three
conv3x3+BN+ReLU stems (16, 16, 32 channels), then Trees of 64 (level 1,
stride 1), 128 (level 2, stride 2), 256 (level 2, stride 2) and 512 (level
1, stride 2), a 4x4 average pool and a 512 -> classes linear.

Modules are defined in the reference's order and under its names
(``base``/``layer1``/``layer2`` as ``Sequential(conv, bn, relu)``,
``layer3`` .. ``layer6`` Trees, each with ``root.conv/bn`` first and then
``left_tree`` and ``right_tree``, ``linear``), so ``state_dict()`` is the
reference layout.

Two forwards, as in :mod:`.resnet`:

- train mode: the port's :class:`~.common.BatchNorm` with batch statistics
  (K2 under ``bn_moments_impl(fused_moments)``), every conv through the
  library;
- eval mode: :meth:`SimpleDLA.fold` folds every BN into its conv once per
  weight set and :meth:`SimpleDLA.folded_forward` runs the folded sites.
  The three stems and the ``conv1`` of every block at stride 1 (9 of the
  12 blocks) go through the fused ``conv3x3_bn_relu`` kernel: 12 launches
  per forward. The stride-2 convs, every BN that feeds a residual add, the
  1x1 shortcuts and each Root's 1x1 conv stay ``F.conv2d`` plus the folded
  affine.

Golden param count: 15,142,970.
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
from pytorch_cifar_tpu_torch.models.resnet import BasicBlock, _block_forward

STEMS = (16, 16, 32)  # base, layer1, layer2
# (out channels, level, stride) of layer3 .. layer6
TREES = ((64, 1, 1), (128, 2, 2), (256, 2, 2), (512, 1, 2))


def _stem(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, 3), batchnorm(cout),
                         nn.ReLU(inplace=True))


class Root(nn.Module):
    """Concatenate on channels, then 1x1 conv, BN and ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = conv(in_channels, out_channels, 1)
        self.bn = batchnorm(out_channels)

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        return F.relu(self.bn(self.conv(torch.cat(xs, dim=1))))

    def fold(self, dtype) -> FoldedConvBN:
        return fold_conv_bn(self.conv, self.bn, dtype, act=RELU)


class Tree(nn.Module):
    """Binary aggregation tree of ``level`` 1 (two blocks) or 2 (two level-1
    trees); the left child runs at ``stride``, the right at 1 on the
    left's output, and the root aggregates both outputs."""

    def __init__(self, in_channels: int, out_channels: int, level: int = 1,
                 stride: int = 1):
        super().__init__()
        self.root = Root(2 * out_channels, out_channels)
        if level == 1:
            self.left_tree = BasicBlock(in_channels, out_channels, stride)
            self.right_tree = BasicBlock(out_channels, out_channels, 1)
        else:
            self.left_tree = Tree(in_channels, out_channels, level - 1,
                                  stride)
            self.right_tree = Tree(out_channels, out_channels, level - 1, 1)

    def forward(self, x):
        out1 = self.left_tree(x)
        out2 = self.right_tree(out1)
        return self.root([out1, out2])

    def fold(self, dtype) -> dict:
        return {"left": self.left_tree.fold(dtype),
                "right": self.right_tree.fold(dtype),
                "root": self.root.fold(dtype)}


def _tree_forward(f: dict, x: torch.Tensor) -> torch.Tensor:
    """One folded tree: a block's fold holds its ``convs``, a subtree's its
    own ``left``/``right``/``root``."""

    def child(c, v):
        return _block_forward(c, v) if "convs" in c else _tree_forward(c, v)

    out1 = child(f["left"], x)
    out2 = child(f["right"], out1)
    return conv_bn(torch.cat([out1, out2], dim=1), f["root"])


class SimpleDLA(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.base = _stem(3, STEMS[0])
        self.layer1 = _stem(STEMS[0], STEMS[1])
        self.layer2 = _stem(STEMS[1], STEMS[2])
        cin = STEMS[2]
        for i, (cout, level, stride) in enumerate(TREES):
            setattr(self, f"layer{i + 3}", Tree(cin, cout, level, stride))
            cin = cout
        self.linear = Linear(cin, num_classes)

    def stems(self) -> List[nn.Sequential]:
        return [self.base, self.layer1, self.layer2]

    def trees(self) -> List[Tree]:
        return [getattr(self, f"layer{i + 3}") for i in range(len(TREES))]

    def forward(self, x):
        if not self.training:
            return self.folded_forward(self.fold(x.dtype), x)
        out = x.contiguous(memory_format=torch.channels_last)
        for stem in self.stems():
            out = stem(out)
        for tree in self.trees():
            out = tree(out)
        out = avg_pool(out, 4)
        return self.linear(out.flatten(1))

    def fold(self, dtype: torch.dtype) -> dict:
        """The eval-mode weights for ``dtype`` compute (see
        :meth:`.resnet.ResNet.fold`)."""
        with torch.no_grad():
            return {
                "stems": [fold_conv_bn(s[0], s[1], dtype, act=RELU)
                          for s in self.stems()],
                "trees": [t.fold(dtype) for t in self.trees()],
                "linear": (
                    self.linear.weight.to(dtype),
                    self.linear.bias.to(dtype),
                ),
            }

    def folded_forward(self, folded: dict, x: torch.Tensor) -> torch.Tensor:
        """Eval forward over :meth:`fold`'s weights; ``x`` is NCHW in the
        compute dtype and becomes channels_last here."""
        out = x.contiguous(memory_format=torch.channels_last)
        for site in folded["stems"]:
            out = conv_bn(out, site)
        for f in folded["trees"]:
            out = _tree_forward(f, out)
        out = avg_pool(out, 4)
        return folded_dense(out.flatten(1), *folded["linear"])
