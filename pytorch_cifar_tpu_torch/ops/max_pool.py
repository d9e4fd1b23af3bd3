"""3x3 / stride 1 / pad 1 max pool, NHWC, forward and backward: the Hopper
kernels.

Port of ``pytorch_cifar_tpu/ops/max_pool.py`` (``max_pool3x3_s1`` ->
``_max_pool3x3_fwd``/``_max_pool3x3_bwd``, Pallas ``_fwd_kernel`` and
``_bwd_kernel``), the pool branch of every GoogLeNet Inception cell:

    out[n, y, x, c] = max of x over the 3x3 window around (y, x)

with ``-inf`` outside the map, for a contiguous NHWC ``x`` (what a
channels_last NCHW activation's ``permute(0, 2, 3, 1)`` gives). The winner
of a window is its row-major FIRST maximum (taps 0..8 scanned with a strict
``>``), the rule of the TPU kernel, of XLA's select-and-scatter and of
``F.max_pool2d``; the gradient of a window goes to its winner alone.

Under autograd the forward also writes ONE uint8 winner map (the winning
tap per element), and the backward is a kernel too: each input position
gathers ``g`` from the up to nine windows whose map names it, summed in
fp32 in tap order and rounded once. A window whose every real tap is
``-inf`` keeps tap 0, which at a border lies outside the map: its gradient
is dropped, as the TPU kernel drops it.

One difference from the TPU kernel, on purpose: **a NaN wins** (``v > best
or isnan(v)``). The TPU kernel's strict ``>`` lets a NaN through only at
tap 0, while ``nn.max_pool``, which the JAX GoogLeNet runs, propagates it;
a pool that swallowed NaNs would hide a diverged step from the train
step's ``nonfinite`` metric. Kernel and plain version share the rule.

:func:`max_pool3x3_s1` launches the CUDA kernels (``csrc/max_pool.cu``)
for a CUDA tensor and raises on anything they cannot take; a CPU tensor
runs :func:`max_pool3x3_s1_reference` and
:func:`max_pool3x3_s1_backward_reference`. There is no fallback from one to
the other. ``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pytorch_cifar_tpu_torch.ops import _build

FWD_LAUNCHES = 0  # forward launches since import (or since a caller reset it)
BWD_LAUNCHES = 0  # backward launches, counted apart
_launch_lock = threading.Lock()

_PAD = (0, 0, 1, 1, 1, 1)  # F.pad of (n, h, w, c): one pixel around h and w


def max_pool3x3_s1_reference(
    x: torch.Tensor, with_index: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version: ``(out, idx)``, ``idx`` the uint8 winner map
    (None unless ``with_index``). An explicit ``-inf`` pad and the nine
    shifted slices scanned in row-major order, so the tie and NaN rules are
    written here and not inherited from a library pool."""
    n, h, w, c = x.shape
    xp = F.pad(x, _PAD, value=float("-inf"))
    best = xp[:, 0:h, 0:w]
    win = torch.zeros(x.shape, dtype=torch.uint8, device=x.device)
    for t in range(1, 9):
        dy, dx = divmod(t, 3)
        cur = xp[:, dy:dy + h, dx:dx + w]
        take = (cur > best) | torch.isnan(cur)
        best = torch.where(take, cur, best)
        if with_index:
            win = torch.where(take, t, win)
    return best.contiguous(), (win if with_index else None)


def max_pool3x3_s1_backward_reference(
    g: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the backward: input position ``p`` sums
    ``g`` over the windows whose map names ``p``, in tap order, in fp32 (at
    least), and rounds once. Window ``(y - dy + 1, x - dx + 1)`` sees
    ``(y, x)`` as its tap ``(dy, dx)``; windows outside the map read a pad
    whose map value (255) names no tap."""
    n, h, w, c = g.shape
    gp = F.pad(g.to(torch.promote_types(g.dtype, torch.float32)), _PAD)
    ip = F.pad(idx, _PAD, value=255)
    acc = torch.zeros_like(gp[:, 1:1 + h, 1:1 + w])
    for t in range(9):
        dy, dx = divmod(t, 3)
        rows, cols = slice(2 - dy, 2 - dy + h), slice(2 - dx, 2 - dx + w)
        acc = acc + torch.where(ip[:, rows, cols] == t, gp[:, rows, cols], 0.0)
    return acc.to(g.dtype)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"max_pool3x3_s1 takes NHWC x, got {tuple(x.shape)}")
    # checked on every device, so a layout slip shows in the CPU tests too
    if not x.is_contiguous():
        raise ValueError(
            "max_pool3x3_s1 needs a contiguous NHWC x (a channels_last "
            "activation's permute(0, 2, 3, 1))"
        )


def _entry(x: torch.Tensor, which: str):
    if x.device.type != "cuda":
        raise ValueError(
            f"max_pool3x3_s1: x must be on a CUDA device or the CPU, got "
            f"{x.device}"
        )
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"max_pool3x3_s1 takes bf16 or fp32 x, got {x.dtype}")
    lib = _build.load("max_pool")
    suffix = "bf16" if x.dtype == torch.bfloat16 else "f32"
    return getattr(lib, f"max_pool3x3_{which}_{suffix}")


def _forward(
    x: torch.Tensor, with_index: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    global FWD_LAUNCHES
    if x.device.type == "cpu":
        return max_pool3x3_s1_reference(x, with_index)
    fn = _entry(x, "fwd")
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    idx = (
        torch.empty(x.shape, dtype=torch.uint8, device=x.device)
        if with_index else None
    )
    if x.numel() == 0:  # nothing to pool: no launch, none counted
        return out, idx
    tensors = (x, out) if idx is None else (x, out, idx)
    err = fn(
        x.data_ptr(), out.data_ptr(), None if idx is None else idx.data_ptr(),
        n, h, w, c, _build.vector_width(c, *tensors),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"max_pool3x3_s1 forward launch failed with cudaError {err} at "
            f"x {tuple(x.shape)} {x.dtype}"
        )
    with _launch_lock:
        FWD_LAUNCHES += 1
    return out, idx


def _backward(g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    global BWD_LAUNCHES
    if g.device.type == "cpu":
        return max_pool3x3_s1_backward_reference(g, idx)
    fn = _entry(g, "bwd")
    n, h, w, c = g.shape
    gi = torch.empty_like(g)
    if g.numel() == 0:
        return gi
    err = fn(
        g.data_ptr(), idx.data_ptr(), gi.data_ptr(), n, h, w, c,
        _build.vector_width(c, g, gi, idx),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"max_pool3x3_s1 backward launch failed with cudaError {err} at "
            f"g {tuple(g.shape)} {g.dtype}"
        )
    with _launch_lock:
        BWD_LAUNCHES += 1
    return gi


class MaxPool3x3S1(torch.autograd.Function):
    """The pool with its winner map saved for the backward kernel."""

    @staticmethod
    def forward(ctx, x):
        out, idx = _forward(x, with_index=True)
        ctx.save_for_backward(idx)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        # autograd may hand over a cotangent in another layout (an expanded
        # scalar, a slice of a concatenation's gradient): the kernel reads
        # dense NHWC, so make it so here, where it shows
        if not g.is_contiguous():
            g = g.contiguous()
        return _backward(g, idx)


def max_pool3x3_s1(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride 1 / pad 1 max pool of NHWC ``x``; differentiable. The
    winner map is written only when a gradient can be asked for."""
    _check(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return MaxPool3x3S1.apply(x)
    return _forward(x, with_index=False)[0]
