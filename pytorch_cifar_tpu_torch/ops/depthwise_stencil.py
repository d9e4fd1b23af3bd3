"""Depthwise K x K / stride 1 / SAME convolution, NHWC: the Hopper kernel.

Port of ``pytorch_cifar_tpu/ops/depthwise_stencil.py``
(``depthwise_stencil``, Pallas ``_kernel``), the depthwise convolutions of
MobileNet (3x3) and PNASNet (5x5, 7x7):

    out[n, y, x, c] = sum over (dy, dx) of
                      x[n, y + dy - p, x + dx - p, c] * w[dy, dx, c]

with ``p = K // 2`` and zeros outside the map, summed in fp32 in row-major
tap order and rounded once to ``x``'s type. Layouts are the JAX package's:
``x`` NHWC ``(n, h, w, c)`` contiguous, ``w`` ``(K, K, c)`` in ``x``'s type,
K in {3, 5, 7}, any ``c``. Forward only, as the TPU kernel is: training
keeps the library's grouped convolution.

:func:`depthwise_stencil` launches the CUDA kernel
(``csrc/depthwise_stencil.cu``) for a CUDA tensor and raises on anything it
cannot take; a CPU tensor runs :func:`depthwise_stencil_reference`. There
is no fallback from one to the other. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from pytorch_cifar_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
_launch_lock = threading.Lock()

KERNEL_SIZES = (3, 5, 7)


def depthwise_stencil_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the K * K shifted multiply-adds over a
    zero-padded copy, in fp32 (at least), one cast to ``x``'s type."""
    n, h, wd, c = x.shape
    k = w.shape[0]
    p = k // 2
    wide = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(wide), (0, 0, p, p, p, p))
    wf = w.to(wide)
    acc = torch.zeros((n, h, wd, c), dtype=wide, device=x.device)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy:dy + h, dx:dx + wd] * wf[dy, dx]
    return acc.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 3 or w.shape[0] != w.shape[1] \
            or w.shape[2] != x.shape[3]:
        raise ValueError(
            f"expected x (n, h, w, c) and w (k, k, c), got {tuple(x.shape)} "
            f"and {tuple(w.shape)}"
        )
    if w.shape[0] not in KERNEL_SIZES:
        raise ValueError(
            f"depthwise_stencil takes k in {KERNEL_SIZES}, got {w.shape[0]}"
        )
    # checked on every device, so a layout slip shows in the CPU tests too
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("depthwise_stencil needs contiguous NHWC x and KKC w")
    if w.dtype != x.dtype:
        raise TypeError(
            f"depthwise_stencil takes w in x's type, got {x.dtype} and "
            f"{w.dtype}"
        )


def depthwise_stencil(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise conv of NHWC ``x`` with ``w`` ``(k, k, c)``, stride 1,
    SAME."""
    global LAUNCHES
    _check(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return depthwise_stencil_reference(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            "depthwise_stencil: x and w must be on one CUDA device (or both "
            f"on the CPU), got {x.device} and {w.device}"
        )
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"depthwise_stencil takes bf16 or fp32 x, got {x.dtype}")
    out = torch.empty_like(x)
    if x.numel() == 0:  # nothing to convolve: no launch, none counted
        return out
    lib = _build.load("depthwise_stencil")
    fn = (
        lib.depthwise_stencil_bf16
        if x.dtype == torch.bfloat16
        else lib.depthwise_stencil_f32
    )
    n, h, wd, c = x.shape
    err = fn(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, c, w.shape[0],
        _build.vector_width(c, x, w, out),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"depthwise_stencil kernel launch failed with cudaError {err} at "
            f"x {tuple(x.shape)} {x.dtype}, k {w.shape[0]}"
        )
    with _launch_lock:
        LAUNCHES += 1
    return out
