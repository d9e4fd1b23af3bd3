"""Input normalization of the port (counterpart of
``pytorch_cifar_tpu/data/augment.py``; the training augmentations come with
the training slice)."""

from __future__ import annotations

from typing import Sequence

import torch

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2023, 0.1994, 0.2010)


def normalize(
    x: torch.Tensor,
    mean: Sequence[float] = CIFAR10_MEAN,
    std: Sequence[float] = CIFAR10_STD,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 NHWC -> normalized NHWC: ``(x - mean*255) / (std*255)`` in
    fp32, then cast to ``dtype`` (ToTensor + Normalize). ``mean``/``std``
    may be fp32 tensors already on ``x``'s device (no copy per call)."""
    m = torch.as_tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    s = torch.as_tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return ((x.float() - m) / s).to(dtype)
