"""Fused 3x3 conv + inference BatchNorm + ReLU, NHWC: the Hopper kernel.

Port of ``pytorch_cifar_tpu/ops/conv_bn_relu.py`` (Pallas ``_kernel``):

    relu(conv3x3(x, w, stride=1, pad=1) * scale + bias)

summed in fp32, with the BN folded into a per-channel fp32 affine and one
rounding to ``x``'s type. Layouts are the JAX package's, so the tests
compare like with like: ``x`` NHWC ``(n, h, w, cin)``, ``w`` HWIO
``(3, 3, cin, cout)``, ``scale``/``bias`` fp32 ``(cout,)``.

:func:`conv3x3_bn_relu` launches the CUDA kernel (``csrc/conv_bn_relu.cu``)
for a CUDA tensor and raises on anything it cannot take; a CPU tensor runs
:func:`conv3x3_bn_relu_reference`. There is no fallback from one to the
other. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch
import torch.nn.functional as F

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
_launch_lock = threading.Lock()


def conv3x3_bn_relu_reference(
    x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: conv in fp32, affine, ReLU, cast to x's type."""
    y = F.conv2d(
        x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
        padding=1,
    )
    y = y * scale.float().view(1, -1, 1, 1) + bias.float().view(1, -1, 1, 1)
    return torch.relu(y).permute(0, 2, 3, 1).to(x.dtype)


def fold_batchnorm(
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BN as a per-channel affine: y = x*scale + bias."""
    scale = gamma / torch.sqrt(var + eps)
    return scale, beta - mean * scale


def _check(x, w, scale, bias) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(
            f"expected x (n, h, w, cin) and w (3, 3, cin, cout), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    cout = w.shape[3]
    if scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError(
            f"scale/bias must be ({cout},), got {tuple(scale.shape)} and "
            f"{tuple(bias.shape)}"
        )
    # checked on every device, so a layout slip shows in the CPU tests too
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3_bn_relu needs contiguous NHWC x and HWIO w")


def conv3x3_bn_relu(
    x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """relu(conv3x3(x, w, stride=1, pad=1) * scale + bias), NHWC."""
    global LAUNCHES
    _check(x, w, scale, bias)
    tensors = (x, w, scale, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return conv3x3_bn_relu_reference(x, w, scale, bias)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError(
            "conv3x3_bn_relu: x, w, scale and bias must all be on one CUDA "
            f"device (or all on the CPU), got {[str(t.device) for t in tensors]}"
        )
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise TypeError(
            f"conv3x3_bn_relu takes bf16 or fp32 x with w of the same type, "
            f"got {x.dtype} and {w.dtype}"
        )
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("scale and bias must be fp32")
    if not (scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("conv3x3_bn_relu needs contiguous scale and bias")
    from pytorch_cifar_tpu_torch.ops import _build

    lib = _build.load("conv_bn_relu")
    fn = (
        lib.conv3x3_bn_relu_bf16
        if x.dtype == torch.bfloat16
        else lib.conv3x3_bn_relu_f32
    )
    n, h, wd, cin = x.shape
    out = torch.empty((n, h, wd, w.shape[3]), dtype=x.dtype, device=x.device)
    err = fn(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), n, h, wd, cin, w.shape[3],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"conv3x3_bn_relu kernel launch failed with cudaError {err} at "
            f"x {tuple(x.shape)} {x.dtype}, cout {w.shape[3]}"
        )
    with _launch_lock:
        LAUNCHES += 1
    return out
