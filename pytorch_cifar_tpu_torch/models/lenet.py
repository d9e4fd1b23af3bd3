"""LeNet-5 for CIFAR-10, PyTorch port of ``pytorch_cifar_tpu/models/lenet.py``.

The only zoo model with no BatchNorm: two valid-padding 5x5 convs with
bias, each followed by ReLU and a 2x2 max pool, then three fully-connected
layers (400-120-84-10). 62,006 params. Modules carry the reference's names
(``conv1``, ``conv2``, ``fc1``..``fc3``). The flatten before ``fc1`` is the
reference's NCHW order; the JAX model flattens NHWC, and
``compat.state_dict_from_jax`` permutes ``fc1``'s columns across the two.
It has no fused site: its served forward (:meth:`LeNet.folded_forward`) is
the eval forward on weights cast once to the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_cifar_tpu_torch.models.common import (
    Conv2d,
    Linear,
    folded_conv2d,
    folded_dense,
)


class LeNet(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.conv1 = Conv2d(3, 6, 5)
        self.conv2 = Conv2d(6, 16, 5)
        self.fc1 = Linear(16 * 5 * 5, 120)
        self.fc2 = Linear(120, 84)
        self.fc3 = Linear(84, num_classes)

    def forward(self, x):
        out = F.max_pool2d(F.relu(self.conv1(x)), 2)
        out = F.max_pool2d(F.relu(self.conv2(out)), 2)
        out = out.flatten(1)
        out = F.relu(self.fc1(out))
        out = F.relu(self.fc2(out))
        return self.fc3(out)

    def fold(self, dtype: torch.dtype) -> dict:
        """Each layer's ``(weight, bias)`` in the compute dtype, once per
        weight set (the engine's contract; there is no BN to fold)."""
        with torch.no_grad():
            return {name: (m.weight.to(dtype), m.bias.to(dtype))
                    for name, m in self.named_children()}

    def folded_forward(self, folded: dict, x: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` over :meth:`fold`'s weights; ``x`` is NCHW in
        the compute dtype."""
        out = F.max_pool2d(F.relu(folded_conv2d(x, *folded["conv1"])), 2)
        out = F.max_pool2d(F.relu(folded_conv2d(out, *folded["conv2"])), 2)
        out = F.relu(folded_dense(out.flatten(1), *folded["fc1"]))
        out = F.relu(folded_dense(out, *folded["fc2"]))
        return folded_dense(out, *folded["fc3"])
