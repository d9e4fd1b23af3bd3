"""DLA (the paper's version) for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/dla.py``.

It differs from :mod:`.dla_simple` in the Tree. A level-2 tree carries a
``prev_root`` block on its raw input and a level-1 subtree (``level_1``),
then a left and a right node on the subtree's output, and its Root
aggregates all four: ``(level + 2) * out_channels`` channels. A level-1 tree
is SimpleDLA's binary one. Stems, stages (64 / 128 / 256 / 512 channels at
levels 1, 2, 2, 1 and strides 1, 2, 2, 2), pool and linear are SimpleDLA's,
and so are the pieces: the ResNet ``BasicBlock`` and SimpleDLA's
:class:`~.dla_simple.Root`.

Modules are defined in the reference's order and under its names (a tree's
``root`` first, then ``level_1``, ``prev_root``, ``left_node`` and
``right_node``), so ``state_dict()`` is the reference layout; the JAX model
calls them in another order, which ``compat`` maps by name.

Eval mode: :meth:`DLA.fold` / :meth:`DLA.folded_forward` as in SimpleDLA.
The three stems and the ``conv1`` of every block at stride 1 (9 of the 14
blocks: each level-2 tree's ``prev_root`` and its subtree's left node run
at stride 2, as does layer6's left node) go through the fused
``conv3x3_bn_relu`` kernel: 12 launches per forward.

Golden param count: 16,291,386.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from pytorch_cifar_tpu_torch.models.common import (
    RELU,
    Linear,
    avg_pool,
    conv_bn,
    fold_conv_bn,
    folded_dense,
)
from pytorch_cifar_tpu_torch.models.dla_simple import STEMS, TREES, Root, _stem
from pytorch_cifar_tpu_torch.models.resnet import BasicBlock, _block_forward


class Tree(nn.Module):
    """The paper's aggregation tree of ``level`` 1 or 2 (the network has no
    deeper one)."""

    def __init__(self, in_channels: int, out_channels: int, level: int = 1,
                 stride: int = 1):
        super().__init__()
        self.level = level
        self.root = Root((level + 2 if level > 1 else 2) * out_channels,
                         out_channels)
        if level > 1:
            for i in reversed(range(1, level)):
                setattr(self, f"level_{i}",
                        Tree(in_channels, out_channels, i, stride))
            self.prev_root = BasicBlock(in_channels, out_channels, stride)
            self.left_node = BasicBlock(out_channels, out_channels, 1)
        else:
            self.left_node = BasicBlock(in_channels, out_channels, stride)
        self.right_node = BasicBlock(out_channels, out_channels, 1)

    def subtrees(self) -> List["Tree"]:
        return [getattr(self, f"level_{i}")
                for i in reversed(range(1, self.level))]

    def forward(self, x):
        xs = [self.prev_root(x)] if self.level > 1 else []
        for sub in self.subtrees():
            x = sub(x)
            xs.append(x)
        x = self.left_node(x)
        xs.append(x)
        x = self.right_node(x)
        xs.append(x)
        return self.root(xs)

    def fold(self, dtype) -> dict:
        return {
            "prev_root": self.prev_root.fold(dtype) if self.level > 1
            else None,
            "subtrees": [t.fold(dtype) for t in self.subtrees()],
            "left": self.left_node.fold(dtype),
            "right": self.right_node.fold(dtype),
            "root": self.root.fold(dtype),
        }


def _tree_forward(f: dict, x: torch.Tensor) -> torch.Tensor:
    xs = [] if f["prev_root"] is None else [_block_forward(f["prev_root"], x)]
    for sub in f["subtrees"]:
        x = _tree_forward(sub, x)
        xs.append(x)
    x = _block_forward(f["left"], x)
    xs.append(x)
    x = _block_forward(f["right"], x)
    xs.append(x)
    return conv_bn(torch.cat(xs, dim=1), f["root"])


class DLA(nn.Module):
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
