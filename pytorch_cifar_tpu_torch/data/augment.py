"""Batched on-device augmentation and input normalization of the port
(counterpart of ``pytorch_cifar_tpu/data/augment.py``).

RandomCrop(32, padding=4) + RandomHorizontalFlip + Normalize, as the
reference's transforms, vectorized over the batch on the tensor's device.
The random choices are tensor arguments: crop offsets ``(n, 2)`` in
``[0, 2 * padding]`` and flip bits ``(n,)``. The trainer draws them from a
``torch.Generator`` (``train/state.py``); the JAX package draws them from
``jax.random`` keys, so the two streams differ by design, and the tests
hand both the same draws. The JAX package's one-hot einsum formulation of
the crop is a TPU device trick with a bit-identical result; here the crop
is plain indexing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

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


def crop_flip(
    x: torch.Tensor,
    offsets: torch.Tensor,
    flips: Optional[torch.Tensor] = None,
    padding: int = 4,
) -> torch.Tensor:
    """RandomCrop(h, padding) with an optional horizontal flip, NHWC, any
    dtype: image i is zero-padded by ``padding`` and cropped at row
    ``offsets[i, 0]``, column ``offsets[i, 1]``; where ``flips[i]`` is set,
    the crop is mirrored left-right. Same result as the JAX
    ``crop_flip_onehot`` given the same offsets and flip bits."""
    n, h, w, _ = x.shape
    dev = x.device
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    rows = torch.arange(h, device=dev)[None, :] + offsets[:, 0:1]
    cols = torch.arange(w, device=dev)[None, :].expand(n, w)
    if flips is not None:
        cols = torch.where(flips.bool()[:, None], w - 1 - cols, cols)
    cols = cols + offsets[:, 1:2]
    img = torch.arange(n, device=dev)[:, None, None]
    return xp[img, rows[:, :, None], cols[:, None, :]]


def random_hflip(x: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """RandomHorizontalFlip: image i mirrored left-right where ``flips[i]``
    is set, NHWC."""
    return torch.where(flips.bool()[:, None, None, None], x.flip(2), x)


def augment_batch(
    x: torch.Tensor,
    offsets: torch.Tensor,
    flips: torch.Tensor,
    crop: bool = True,
    flip: bool = True,
    mean: Sequence[float] = CIFAR10_MEAN,
    std: Sequence[float] = CIFAR10_STD,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Train-time pipeline, uint8 NHWC in: crop -> flip -> normalize."""
    if crop:
        x = crop_flip(x, offsets, flips if flip else None)
    elif flip:
        x = random_hflip(x, flips)
    return normalize(x, mean, std, dtype)
