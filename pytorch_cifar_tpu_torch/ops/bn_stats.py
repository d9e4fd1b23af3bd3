"""Per-channel batch moments for BatchNorm in one read: the Hopper kernel.

Port of ``pytorch_cifar_tpu/ops/bn_stats.py`` (``fused_moments`` ->
``_moments_sums`` -> Pallas ``_moments_kernel``):

    fused_moments(x) == (mean(x, axes N, H, W), mean(x * x, axes N, H, W))

in fp32, for NHWC ``x`` (a contiguous ``(N, H, W, C)``, which is what a
channels_last NCHW activation's ``permute(0, 2, 3, 1)`` gives) in bf16 or
fp32. The gradient is :class:`FusedMoments`' elementwise backward,
``dx = a/n + 2*b*x/n`` cast to ``x``'s type, in plain PyTorch, as the JAX
package computes it in plain jnp outside any Pallas kernel.

The forward launches the CUDA kernel (``csrc/bn_stats.cu``: one launch,
whose blocks each reduce a chunk of rows and whose last block per channel
tile, found by an integer ticket, sums the chunks' partials in a fixed
order; no float atomics, so two launches on one input are bit-identical)
for a CUDA tensor and raises on anything it cannot take; a CPU tensor runs
:func:`fused_moments_reference`. There is no fallback from one to the
other. ``LAUNCHES`` counts kernel launches, one per forward call.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
_launch_lock = threading.Lock()
# (device index, stream) -> the kernel's int32 ticket counters, one per
# channel tile. Zeroed once here; each launch's last block of a tile
# resets its counter, so a launch finds them zero and leaves them so.
# Launches on one stream run in order and may share them; two streams
# may run at once, so each has its own.
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def fused_moments_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: mean and mean of squares over all but the
    last axis, in fp32 (f64 input stays f64)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    axes = tuple(range(x.dim() - 1))
    return xf.mean(dim=axes), (xf * xf).mean(dim=axes)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"fused_moments takes NHWC x, got {tuple(x.shape)}")
    # checked on every device, so a layout slip shows in the CPU tests too
    if not x.is_contiguous():
        raise ValueError(
            "fused_moments needs a contiguous NHWC x (a channels_last "
            "activation's permute(0, 2, 3, 1))"
        )


def _tickets(device: int, stream: int, tiles: int) -> torch.Tensor:
    """The stream's ticket counters, at least ``tiles`` of them. A larger
    buffer replaces a smaller one; it is allocated on this stream, so the
    old one is freed only after the launches queued before it."""
    key = (device, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 64), dtype=torch.int32,
                          device=f"cuda:{device}")
        _TICKETS[key] = buf
    return buf


def _moments_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_moments takes bf16 or fp32 x, got {x.dtype}")
    from pytorch_cifar_tpu_torch.ops import _build

    lib = _build.load("bn_stats")
    c = x.shape[-1]
    rows = x.numel() // c
    esize = x.element_size()
    vec = int(c % (16 // esize) == 0 and x.data_ptr() % 16 == 0)
    rows_per_block, chunks = ctypes.c_longlong(), ctypes.c_int()
    tiles = ctypes.c_int()
    err = lib.fused_moments_plan(
        rows, c, vec, esize, ctypes.byref(rows_per_block),
        ctypes.byref(chunks), ctypes.byref(tiles),
    )
    if err != 0:
        raise ValueError(f"fused_moments cannot take x {tuple(x.shape)}")
    partial = torch.empty(
        (chunks.value, 2, c), dtype=torch.float32, device=x.device
    )
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tickets = _tickets(x.device.index, stream, tiles.value)
    fn = lib.fused_moments_bf16 if esize == 2 else lib.fused_moments_f32
    err = fn(
        x.data_ptr(), partial.data_ptr(), out.data_ptr(),
        tickets.data_ptr(), rows, c, vec, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused_moments kernel launch failed with cudaError {err} at "
            f"x {tuple(x.shape)} {x.dtype}"
        )
    with _launch_lock:
        LAUNCHES += 1
    return out[0], out[1]


class FusedMoments(torch.autograd.Function):
    """(E[x], E[x^2]) over N, H, W of NHWC ``x``; the backward is the
    elementwise ``dx = a/n + 2*b*x/n`` (no reduction)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return fused_moments_reference(x)
        if x.device.type != "cuda":
            raise ValueError(
                f"fused_moments: x must be on a CUDA device or the CPU, got "
                f"{x.device}"
            )
        return _moments_cuda(x)

    @staticmethod
    def backward(ctx, a, b):
        (x,) = ctx.saved_tensors
        n = x.numel() // x.shape[-1]
        dx = (a / n) + x.to(a.dtype) * (2.0 * b / n)
        return dx.to(x.dtype)


def fused_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2]) over all but the channel axis of NHWC ``x``, fp32,
    one read of ``x``; differentiable."""
    _check(x)
    return FusedMoments.apply(x)
