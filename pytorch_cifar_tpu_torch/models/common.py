"""Shared building blocks for the port's models (what ResNet needs).

Counterpart of ``pytorch_cifar_tpu/models/common.py``. The layers are
PyTorch's own: ``nn.Conv2d``/``nn.Linear`` default init *is* the init the
JAX package re-derives (U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and
biases), and ``nn.BatchNorm2d(eps=1e-5, momentum=0.1)`` *is* the torch-exact
BN semantics its ``BatchNorm`` implements. :func:`reset_parameters` redraws
that same init from an explicit ``torch.Generator``.

Activations are NCHW-logical tensors in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` is a zero-copy NHWC view for the NHWC kernels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_cifar_tpu_torch.ops.conv_bn_relu import conv3x3_bn_relu

BN_EPS = 1e-5


def conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    """Bias-free conv with torch ``padding=k//2`` (the zoo's 1x1 and 3x3)."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def batchnorm(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=0.1)


@torch.no_grad()
def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """PyTorch-default init drawn from ``generator``: conv/linear weight and
    bias U(-b, b) with b = 1/sqrt(fan_in); BN scale 1, bias 0, running
    stats (0, 1)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def fold_bn(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BN as a per-channel affine, exactly as the JAX model folds
    it: ``mul = scale * rsqrt(var + eps)``, ``add = bias - mean * mul``, in
    fp32 (the caller applies it in the compute dtype)."""
    mul = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    add = bn.bias.float() - bn.running_mean.float() * mul
    return mul, add


@dataclass(frozen=True)
class FoldedConvBN:
    """One eval-mode conv -> BN [-> ReLU] site with the BN folded, its
    weights already in the layout and dtype the forward consumes.

    ``fused`` sites (3x3, stride 1, followed by ReLU) run the NHWC kernel:
    ``weight`` is HWIO in the compute dtype, ``mul``/``add`` fp32 ``(c,)``.
    Other sites run ``F.conv2d``: ``weight`` is OIHW channels_last in the
    compute dtype, ``mul``/``add`` ``(1, c, 1, 1)`` in the compute dtype."""

    weight: torch.Tensor
    mul: torch.Tensor
    add: torch.Tensor
    stride: int
    padding: int
    relu: bool
    fused: bool


@torch.no_grad()
def fold_conv_bn(
    conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype, relu: bool
) -> FoldedConvBN:
    """Fold one site for ``dtype`` compute (once per weight set)."""
    mul, add = fold_bn(bn)
    stride, padding = conv.stride[0], conv.padding[0]
    fused = relu and conv.kernel_size == (3, 3) and stride == 1
    if fused:
        weight = conv.weight.permute(2, 3, 1, 0).to(dtype).contiguous()
    else:
        weight = conv.weight.to(dtype).contiguous(
            memory_format=torch.channels_last
        )
        mul = mul.to(dtype).view(1, -1, 1, 1)
        add = add.to(dtype).view(1, -1, 1, 1)
    return FoldedConvBN(weight, mul, add, stride, padding, relu, fused)


def conv_bn(x: torch.Tensor, f: FoldedConvBN) -> torch.Tensor:
    """Apply one folded site to a channels_last activation. Fused sites go
    through ``ops.conv_bn_relu.conv3x3_bn_relu`` (the Hopper kernel on a
    CUDA tensor, its plain version on a CPU one)."""
    if f.fused:
        y = conv3x3_bn_relu(x.permute(0, 2, 3, 1), f.weight, f.mul, f.add)
        return y.permute(0, 3, 1, 2)
    y = F.conv2d(x, f.weight, stride=f.stride, padding=f.padding)
    y = y * f.mul + f.add
    return torch.relu(y) if f.relu else y


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    return F.avg_pool2d(x, window)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
