"""DenseNet for CIFAR-10, PyTorch port of
``pytorch_cifar_tpu/models/densenet.py``.

Pre-activation bottleneck layers (BN-ReLU-conv1x1 to ``4 * growth`` ->
BN-ReLU-conv3x3 to ``growth``) whose output goes *in front of* the running
stack (``cat([out, x])``); transitions (BN-ReLU-conv1x1 to ``floor(planes
* 0.5)``, a 2x2 average pool) between the four dense stages; stem conv3x3
to ``2 * growth``; head BN-ReLU, a 4x4 pool and a linear. Every conv is
bias-free. Modules are defined in the reference's order and under its
names (``conv1``, ``dense{1..4}.{i}.bn1/conv1/bn2/conv2``,
``trans{1..3}.bn/conv``, ``bn``, ``linear``), so ``state_dict()`` is the
reference layout.

``shared_stats`` (train mode only, on by default, as in the JAX model)
computes each new chunk's BN moments once, through
:func:`~.common.bn_batch_moments` (so kernel K2 takes them under
``bn_moments_impl``, and cross-replica BN still averages them), and hands
every later BN that covers the chunk the concatenated moments
(``BatchNorm(moments=)``): per-channel moments of a concatenation are the
concatenation of its parts' moments, so the outputs, gradients and
running statistics are the per-layer path's. Each layer's ``bn2`` reduces
its own input.

Eval mode (:meth:`DenseNet.fold` / :meth:`DenseNet.folded_forward`): the
BNs over the stack are affines + ReLU, each layer's ``conv1`` folds
``bn2`` (an ``F.conv2d`` site), the 3x3s, the stem and the transitions'
convs stay plain ``F.conv2d``. No site is a kernel site: a 3x3 conv's
output joins the stack raw, which later layers read.

Golden param counts: DenseNet121 6,956,298 · DenseNet169 12,493,322 ·
DenseNet201 18,104,330 · DenseNet161 26,482,378 · DenseNetCifar
1,000,618.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_cifar_tpu_torch.models.common import (
    RELU,
    Linear,
    affine_relu,
    avg_pool,
    batchnorm,
    bn_batch_moments,
    conv,
    conv_bn,
    fold_affine,
    fold_conv_bn,
    folded_dense,
)

Moments = Tuple[torch.Tensor, torch.Tensor]


def _joined(new: torch.Tensor, moments: Moments) -> Moments:
    """The moments of ``cat([new, x])`` from ``x``'s: ``new``'s reduced
    once, in front."""
    m, sq = bn_batch_moments(new)
    return torch.cat([m, moments[0]]), torch.cat([sq, moments[1]])


class Bottleneck(nn.Module):
    """One dense layer (the JAX ``DenseLayer``)."""

    def __init__(self, in_planes: int, growth_rate: int):
        super().__init__()
        self.bn1 = batchnorm(in_planes)
        self.conv1 = conv(in_planes, 4 * growth_rate, 1)
        self.bn2 = batchnorm(4 * growth_rate)
        self.conv2 = conv(4 * growth_rate, growth_rate, 3)

    def forward(self, x, moments: Optional[Moments] = None):
        """``cat([out, x])``; with ``x``'s ``moments``, also the
        concatenation's."""
        out = self.conv1(F.relu(self.bn1(x, moments)))
        out = self.conv2(F.relu(self.bn2(out)))
        joined = torch.cat([out, x], dim=1)
        if moments is None:
            return joined
        return joined, _joined(out, moments)

    def fold(self, dtype) -> dict:
        return {"pre": fold_affine(self.bn1, dtype),
                "convs": [fold_conv_bn(self.conv1, self.bn2, dtype, act=RELU),
                          fold_conv_bn(self.conv2, None, dtype)]}


class Transition(nn.Module):
    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.bn = batchnorm(in_planes)
        self.conv = conv(in_planes, out_planes, 1)

    def forward(self, x, moments: Optional[Moments] = None):
        return avg_pool(self.conv(F.relu(self.bn(x, moments))), 2)

    def fold(self, dtype) -> dict:
        return {"pre": fold_affine(self.bn, dtype),
                "conv": fold_conv_bn(self.conv, None, dtype)}


class DenseNet(nn.Module):
    def __init__(self, nblocks: Sequence[int], growth_rate: int = 12,
                 reduction: float = 0.5, num_classes: int = 10,
                 shared_stats: bool = True):
        super().__init__()
        self.growth_rate = growth_rate
        self.shared_stats = shared_stats
        planes = 2 * growth_rate
        self.conv1 = conv(3, planes, 3)
        for i, n in enumerate(nblocks):
            setattr(self, f"dense{i + 1}", nn.Sequential(*[
                Bottleneck(planes + j * growth_rate, growth_rate)
                for j in range(n)]))
            planes += n * growth_rate
            if i < len(nblocks) - 1:
                out = int(math.floor(planes * reduction))
                setattr(self, f"trans{i + 1}", Transition(planes, out))
                planes = out
        self.bn = batchnorm(planes)
        self.linear = Linear(planes, num_classes)
        self.stages = len(nblocks)

    def _stage(self, i: int) -> Tuple[nn.Sequential, Optional[Transition]]:
        last = i == self.stages - 1
        return (getattr(self, f"dense{i + 1}"),
                None if last else getattr(self, f"trans{i + 1}"))

    def forward(self, x):
        if not self.training:
            return self.folded_forward(self.fold(x.dtype), x)
        out = self.conv1(x.contiguous(memory_format=torch.channels_last))
        moments = bn_batch_moments(out) if self.shared_stats else None
        for i in range(self.stages):
            dense, trans = self._stage(i)
            for layer in dense:
                if moments is None:
                    out = layer(out)
                else:
                    out, moments = layer(out, moments)
            if trans is not None:
                out = trans(out, moments)
                # a fresh tensor: the stack restarts from one chunk
                moments = bn_batch_moments(out) if self.shared_stats \
                    else None
        out = avg_pool(F.relu(self.bn(out, moments)), 4)
        return self.linear(out.flatten(1))

    def fold(self, dtype: torch.dtype) -> dict:
        """The eval-mode weights for ``dtype`` compute (see
        :meth:`.resnet.ResNet.fold`)."""
        with torch.no_grad():
            stages: List[dict] = []
            for i in range(self.stages):
                dense, trans = self._stage(i)
                stages.append({
                    "layers": [layer.fold(dtype) for layer in dense],
                    "trans": None if trans is None else trans.fold(dtype)})
            return {
                "stem": fold_conv_bn(self.conv1, None, dtype),
                "stages": stages,
                "head": fold_affine(self.bn, dtype),
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
        for stage in folded["stages"]:
            for f in stage["layers"]:
                new = affine_relu(out, f["pre"])
                for site in f["convs"]:
                    new = conv_bn(new, site)
                out = torch.cat([new, out], dim=1)
            t = stage["trans"]
            if t is not None:
                out = avg_pool(conv_bn(affine_relu(out, t["pre"]),
                                       t["conv"]), 2)
        out = avg_pool(affine_relu(out, folded["head"]), 4)
        return folded_dense(out.flatten(1), *folded["linear"])


def DenseNet121(num_classes: int = 10) -> DenseNet:
    return DenseNet((6, 12, 24, 16), 32, num_classes=num_classes)


def DenseNet169(num_classes: int = 10) -> DenseNet:
    return DenseNet((6, 12, 32, 32), 32, num_classes=num_classes)


def DenseNet201(num_classes: int = 10) -> DenseNet:
    return DenseNet((6, 12, 48, 32), 32, num_classes=num_classes)


def DenseNet161(num_classes: int = 10) -> DenseNet:
    return DenseNet((6, 12, 36, 24), 48, num_classes=num_classes)


def DenseNetCifar(num_classes: int = 10) -> DenseNet:
    return DenseNet((6, 12, 24, 16), 12, num_classes=num_classes)
