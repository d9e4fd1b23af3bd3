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

:func:`plan` picks the kernel's tile from the shape and the vector width:
a block stages ``ib`` images x ``th`` rows (plus the halo) of a chunk of
``ccv`` channel vectors in shared memory; its threads each own a vector and
a run of 4 outputs along a row, ``tr`` rows at a time. The sums here mirror
the kernel's, which checks them again.

:func:`depthwise_stencil` launches the CUDA kernel
(``csrc/depthwise_stencil.cu``) for a CUDA tensor and raises on anything it
cannot take; a CPU tensor runs :func:`depthwise_stencil_reference`. There
is no fallback from one to the other. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from pytorch_cifar_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
_launch_lock = threading.Lock()

KERNEL_SIZES = (3, 5, 7)
# the kernel's constants, as in csrc/depthwise_stencil.cu
RUN = 4  # outputs along a row per thread: its register window
MAX_THREADS = 128  # threads of a block, at most
CHUNK_BYTES = 128  # channel bytes of one tile pixel, at most
MIN_ROWS = 8  # rows of a band when a row needs many threads
SMEM_OPT_IN = 232_448  # the most shared memory one block may have (227 KB)


@dataclass(frozen=True)
class Plan:
    """One launch's tile: ``ib`` images x ``th`` rows (plus the halo) of a
    chunk of ``ccv`` channel vectors, staged in shared memory, each row
    ``xruns`` runs of :data:`RUN` outputs; the threads cover ``tr`` rows
    at a time; ``smem`` bytes of shared memory per block."""

    ib: int
    th: int
    tr: int
    ccv: int
    xruns: int
    smem: int

    @property
    def threads(self) -> int:
        return self.ib * self.tr * self.xruns * self.ccv


def plan(h: int, w: int, c: int, k: int, elem: int, vec: int) -> Plan:
    """The kernel's tile for an (h, w, c) map, k x k taps, ``elem``-byte
    elements moved ``vec`` at a time; raises on a shape it cannot take."""
    if k not in KERNEL_SIZES or c % vec:
        raise ValueError(f"depthwise_stencil: k {k}, c {c}, vec {vec}")
    xruns = -(-w // RUN)
    if xruns > MAX_THREADS:
        raise ValueError(f"depthwise_stencil takes maps up to "
                         f"{MAX_THREADS * RUN} wide, got {w}")
    cvt = c // vec
    cap = min(max(1, CHUNK_BYTES // (vec * elem)), MAX_THREADS // xruns)
    chunks = -(-cvt // cap)
    ccv = -(-cvt // chunks)  # chunks of equal width, the last no wider
    per_row = xruns * ccv
    if h * per_row <= MAX_THREADS:  # whole images, as many as fit
        ib, th, tr = MAX_THREADS // (h * per_row), h, h
    else:
        ib, tr = 1, MAX_THREADS // per_row
        th = min(h, max(tr, MIN_ROWS))
    smem = ((ib * (th + k - 1) * (xruns * RUN + k - 1) + k * k) * ccv * vec
            * elem)
    if smem > SMEM_OPT_IN:
        raise ValueError(f"depthwise_stencil: {smem} bytes of shared memory "
                         f"at {(h, w, c)} k {k}")
    return Plan(ib, th, tr, ccv, xruns, smem)


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
    n, h, wd, c = x.shape
    k = w.shape[0]
    vec = _build.vector_width(c, x, w, out)
    p = plan(h, wd, c, k, x.element_size(), vec)
    lib = _build.load("depthwise_stencil")
    fn = (
        lib.depthwise_stencil_bf16
        if x.dtype == torch.bfloat16
        else lib.depthwise_stencil_f32
    )
    err = fn(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, c, k, vec,
        p.ib, p.th, p.tr, p.ccv, p.xruns, p.smem,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"depthwise_stencil kernel launch failed with cudaError {err} at "
            f"x {tuple(x.shape)} {x.dtype}, k {k}, {p}"
        )
    with _launch_lock:
        LAUNCHES += 1
    return out
