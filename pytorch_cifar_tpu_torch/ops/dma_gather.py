"""Epoch row gather of the device-resident dataset: the Hopper kernel.

Port of ``pytorch_cifar_tpu/ops/dma_gather.py`` (Pallas ``_gather_kernel``):

    dma_row_gather(images, idx) == images[idx]

for in-range ``idx``, with rows moved as raw bytes, so any dtype and any
trailing shape gathers alike. The JAX kernel's ``(k*8, 128)`` row-tiling
precondition is a TPU layout constraint and has no counterpart here.

:func:`dma_row_gather` launches the CUDA kernel (``csrc/dma_gather.cu``)
for a CUDA tensor and raises on anything it cannot take; a CPU tensor runs
:func:`dma_row_gather_reference`. There is no fallback from one to the
other. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import threading

import torch

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
_launch_lock = threading.Lock()


def dma_row_gather_reference(
    images: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: ``torch.index_select`` along rows."""
    return torch.index_select(images, 0, idx)


def _row_bytes(images: torch.Tensor) -> int:
    return images[0].numel() * images.element_size()


def vector_path(images: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel may copy rows as 16-byte vectors: the row's byte
    size and both base addresses are multiples of 16. Decided here from
    ``data_ptr()``, so callers need not align anything."""
    return (
        _row_bytes(images) % 16 == 0
        and images.data_ptr() % 16 == 0
        and out.data_ptr() % 16 == 0
    )


def _check(images: torch.Tensor, idx: torch.Tensor) -> None:
    if images.dim() < 1 or images.shape[0] == 0:
        raise ValueError(
            f"images must have at least one row, got {tuple(images.shape)}"
        )
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    # checked on every device, so a layout slip shows in the CPU tests too
    if not (images.is_contiguous() and idx.is_contiguous()):
        raise ValueError("dma_row_gather needs contiguous images and idx")


def dma_row_gather(images: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``images[idx]`` as a row gather; ``idx`` is ``(M,)`` int32 in
    ``[0, N)``. The kernel clamps each index into range, so no launch reads
    out of bounds; out-of-range values are not otherwise relied on."""
    global LAUNCHES
    _check(images, idx)
    if images.device.type == "cpu" and idx.device.type == "cpu":
        return dma_row_gather_reference(images, idx)
    if images.device.type != "cuda" or idx.device != images.device:
        raise ValueError(
            "dma_row_gather: images and idx must be on one CUDA device (or "
            f"both on the CPU), got {images.device} and {idx.device}"
        )
    out = torch.empty(
        (idx.shape[0], *images.shape[1:]), dtype=images.dtype,
        device=images.device,
    )
    if idx.shape[0] == 0:  # nothing to gather: no launch, none counted
        return out
    from pytorch_cifar_tpu_torch.ops import _build

    lib = _build.load("dma_gather")
    err = lib.dma_row_gather(
        images.data_ptr(), idx.data_ptr(), out.data_ptr(), images.shape[0],
        idx.shape[0], _row_bytes(images), int(vector_path(images, out)),
        torch.cuda.current_stream(images.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"dma_row_gather kernel launch failed with cudaError {err} at "
            f"images {tuple(images.shape)} {images.dtype}, idx {idx.shape[0]}"
        )
    with _launch_lock:
        LAUNCHES += 1
    return out
