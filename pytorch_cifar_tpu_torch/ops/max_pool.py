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
fp32 in tap order (an unmatched tap adds +0, never ``g * 0``) and rounded
once. A window whose every real tap is ``-inf`` keeps tap 0, which at a
border lies outside the map: its gradient is dropped, as the TPU kernel
drops it.

One difference from the TPU kernel, on purpose: **a NaN wins** (``v > best
or isnan(v)``). The TPU kernel's strict ``>`` lets a NaN through only at
tap 0, while ``nn.max_pool``, which the JAX GoogLeNet runs, propagates it;
a pool that swallowed NaNs would hide a diverged step from the train
step's ``nonfinite`` metric. Kernel and plain version share the rule.

:func:`plan` picks either kernel's tile from the shape and the vector
width: a block stages a band of ``rows`` rows (or ``ib`` whole images) of
a chunk of ``ccv`` channel vectors in shared memory with a one-pixel
border (the halo rows inside the map are the input's), and its threads
each own a (column, channel vector) and walk down the band. The forward
stages ``x`` with a ``-inf`` border and computes the separable
``max_h(max_w(x))``; the backward stages ``g`` and the winner map with a
zero / 255 border (a map value that names no tap) and sums, at each
position, the nine neighbouring windows' ``g`` whose map names it. The
kernels check the plan again.

:func:`max_pool3x3_s1` launches the CUDA kernels (``csrc/max_pool.cu``)
for a CUDA tensor and raises on anything they cannot take; a CPU tensor
runs :func:`max_pool3x3_s1_reference` and
:func:`max_pool3x3_s1_backward_reference`. There is no fallback from one to
the other. ``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pytorch_cifar_tpu_torch.ops import _build

FWD_LAUNCHES = 0  # forward launches since import (or since a caller reset it)
BWD_LAUNCHES = 0  # backward launches, counted apart
_launch_lock = threading.Lock()

_PAD = (0, 0, 1, 1, 1, 1)  # F.pad of (n, h, w, c): one pixel around h and w

# the kernels' constants, as in csrc/max_pool.cu
THREADS = 256  # threads of a block the plan aims for
MAX_THREADS = 512  # threads of a block, at most
CHUNK_BYTES = 128  # channel bytes of one tile pixel, at most
BLOCKS_PER_SM = 4  # blocks of a full tile that share one SM's 228 KB
TILE_BYTES = 48 * 1024  # shared memory of one block's tile, at most
SMEM_OPT_IN = 232_448  # the most shared memory one block may have (227 KB)


@dataclass(frozen=True)
class Plan:
    """One launch's tile: ``ib`` whole images, or (``ib`` = 1) a band of
    ``rows`` rows, of a chunk of ``ccv`` channel vectors, staged as
    ``(rows + 2) x (w + 2)`` pixels an image; ``threads`` threads and
    ``smem`` bytes of shared memory a block."""

    ib: int
    rows: int
    ccv: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=None)
def plan(h: int, w: int, c: int, elem: int, vec: int,
         backward: bool = False) -> Plan:
    """The tile of the forward kernel (which stages ``x``, ``elem`` bytes a
    channel) or of the backward kernel (which stages ``g`` and the winner
    map, ``elem + 1`` bytes a channel) for an (h, w, c) map moved ``vec``
    channels at a time; raises on a shape it cannot take. Cached: it
    depends on the shape alone, and every launch asks."""
    if min(h, w, c, vec) <= 0 or c % vec:
        raise ValueError(f"max_pool3x3_s1: h {h}, w {w}, c {c}, vec {vec}")
    if w > MAX_THREADS:
        raise ValueError(f"max_pool3x3_s1 takes maps up to {MAX_THREADS} "
                         f"wide, got {w}")
    cvt = c // vec
    cap = min(max(1, CHUNK_BYTES // (vec * elem)), MAX_THREADS // w)
    fewest = -(-cvt // cap)
    # equal chunks that tile C where a count up to twice the fewest does,
    # else equal widths with the last no wider
    chunks = next((k for k in range(fewest, 2 * fewest + 1) if cvt % k == 0),
                  fewest)
    ccv = -(-cvt // chunks)
    staged = elem + 1 if backward else elem
    row_bytes = (w + 2) * ccv * vec * staged  # one tile row of the chunk
    ib = max(1, THREADS // (w * ccv))
    while ib > 1 and ib * (h + 2) * row_bytes > TILE_BYTES:
        ib -= 1
    if ib > 1:  # whole images, as many as fit
        rows = h
    else:  # bands of equal height whose rows and border fit the tile
        fit = max(1, min(h, TILE_BYTES // row_bytes - 2))
        rows = -(-h // -(-h // fit))
    smem = ib * (rows + 2) * row_bytes
    if smem > SMEM_OPT_IN:
        raise ValueError(f"max_pool3x3_s1: {smem} bytes of shared memory at "
                         f"{(h, w, c)}")
    return Plan(ib, rows, ccv, ib * w * ccv, smem)


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
    out = torch.empty_like(x)
    idx = (
        torch.empty(x.shape, dtype=torch.uint8, device=x.device)
        if with_index else None
    )
    if x.numel() == 0:  # nothing to pool: no launch, none counted
        return out, idx
    err = _launch_fwd(fn, x, out, idx)
    if err != 0:
        raise RuntimeError(
            f"max_pool3x3_s1 forward launch failed with cudaError {err} at "
            f"x {tuple(x.shape)} {x.dtype}"
        )
    with _launch_lock:
        FWD_LAUNCHES += 1
    return out, idx


def _launch_fwd(fn, x: torch.Tensor, out: torch.Tensor,
                idx: Optional[torch.Tensor]) -> int:
    """One forward launch into ``out`` (and ``idx``) at its plan; returns
    the cudaError."""
    n, h, w, c = x.shape
    tensors = (x, out) if idx is None else (x, out, idx)
    vec = _build.vector_width(c, *tensors)
    p = plan(h, w, c, x.element_size(), vec)
    return fn(
        x.data_ptr(), out.data_ptr(), None if idx is None else idx.data_ptr(),
        n, h, w, c, vec, p.ib, p.rows, p.ccv, p.smem,
        torch.cuda.current_stream(x.device).cuda_stream,
    )


def _backward(g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    global BWD_LAUNCHES
    if g.device.type == "cpu":
        return max_pool3x3_s1_backward_reference(g, idx)
    fn = _entry(g, "bwd")
    n, h, w, c = g.shape
    gi = torch.empty_like(g)
    if g.numel() == 0:
        return gi
    vec = _build.vector_width(c, g, gi, idx)
    p = plan(h, w, c, g.element_size(), vec, backward=True)
    err = fn(
        g.data_ptr(), idx.data_ptr(), gi.data_ptr(), n, h, w, c, vec,
        p.ib, p.rows, p.ccv, p.smem,
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
