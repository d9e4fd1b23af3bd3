"""Fused 3x3 conv + inference BatchNorm + ReLU, NHWC: the Hopper kernel.

Port of ``pytorch_cifar_tpu/ops/conv_bn_relu.py`` (Pallas ``_kernel``):

    relu(conv3x3(x, w, stride=1, pad=1) * scale + bias)

summed in fp32, with the BN folded into a per-channel fp32 affine and one
rounding to ``x``'s type. Layouts are the JAX package's, so the tests
compare like with like: ``x`` NHWC ``(n, h, w, cin)``, ``w`` HWIO
``(3, 3, cin, cout)``, ``scale``/``bias`` fp32 ``(cout,)``.

:func:`plan` picks the kernel's path and tile from the shape alone (so a
row's summation order never depends on the batch): bf16 with ``cin`` and
``cout`` multiples of 8 runs the wgmma path (two warpgroups over 128
pixels, ``ib`` whole images at maps of 64 pixels or fewer, a cp.async ring
of 4 16-channel chunks); fp32 and the stems (cin = 3) run the
mma.sync path. The sums here mirror the kernel's, which checks them again.

:func:`conv3x3_bn_relu` launches the CUDA kernel (``csrc/conv_bn_relu.cu``)
for a CUDA tensor and raises on anything it cannot take; a CPU tensor runs
:func:`conv3x3_bn_relu_reference`. There is no fallback from one to the
other. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
_launch_lock = threading.Lock()


def conv3x3_bn_relu_reference(
    x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: conv in fp32, affine, ReLU, cast to x's type.
    The zero padding is explicit, so a NaN weight reaches the border
    outputs (0 * NaN = NaN), as in the JAX reference and the kernel: a
    conv's own padding may skip those taps (oneDNN does)."""
    y = F.conv2d(
        F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1)),
        w.float().permute(3, 2, 0, 1),
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


# the wgmma path's tile, as in csrc/conv_bn_relu.cu (namespace wg)
WG_M = 128  # output pixels per block: two warpgroups of 64 rows
WG_KC = 16  # input channels per stage: one k16 step
WG_ATOM = 1024  # a 128-byte swizzle atom: 8 rows of 128 bytes
WG_STAGES = 4  # the cp.async ring's depth
SMEM_OPT_IN = 232_448  # the most shared memory one block may have (227 KB)
# two blocks an SM: 228 KB less 1 KB the card keeps per block, halved
SMEM_TWO_BLOCKS = (233_472 - 2 * 1024) // 2

# the mma.sync path (fp32, the stems): 64 pixels x 64 channels a block
SYNC_M, SYNC_STRIDE, SYNC_STRIDE_W = 64, 24, 72


@dataclass(frozen=True)
class Plan:
    """One launch's path and tile. ``ib`` images x ``th`` rows of each make
    the M tile, ``bn`` output channels the N tile; ``smem`` is the
    dynamic shared memory one block asks for, in bytes; ``blocks_per_sm``
    the blocks an SM the wgmma kernel is built for."""

    path: str  # "wgmma" or "sync"
    ib: int
    th: int
    bn: int
    smem: int
    blocks_per_sm: int = 1  # the kernel's register cap: 2 means 128 a thread


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


def wgmma_smem(bn: int, halo_px: int) -> int:
    """The wgmma path's shared memory: a ring of 4 stages, each the 9 taps'
    [16 ci][bn co] weight tiles and the [halo pixel][16 ci] input, or the
    epilogue's [128][bn + 8] bf16 tile if larger, plus one atom of slack to
    align the ring."""
    stage = 9 * WG_KC * bn * 2 + _round_up(halo_px * WG_KC * 2, WG_ATOM)
    return WG_ATOM + max(WG_STAGES * stage, WG_M * (bn + 8) * 2)


def plan(h: int, w: int, cin: int, cout: int,
         dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The kernel's path and tile for a (h, w, cin, cout) site; raises on
    a shape no path takes."""
    if dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0:
        if w > WG_M:
            raise ValueError(f"conv3x3_bn_relu takes maps up to {WG_M} "
                             f"wide in bf16, got {w}")
        if h * w <= WG_M:  # whole images: the TPU kernel's ib
            ib, th = WG_M // (h * w), h
        else:
            ib, th = 1, min(h, WG_M // w)
        # 128 channels a block where that pads cout no wider than 64 do;
        # 64 at maps of 64 pixels or fewer, where blocks are few
        wide = h * w > 64 and -(-cout // 128) * 128 == -(-cout // 64) * 64
        bn = 128 if wide else 64
        smem = wgmma_smem(bn, ib * (th + 2) * (w + 2))
        if smem > SMEM_OPT_IN:
            raise ValueError(f"conv3x3_bn_relu: a {h}x{w} map needs {smem} "
                             "bytes of shared memory")
        # two blocks an SM for BN = 64 where both fit, unless the map is too
        # small to give the SMs two blocks each (4x4: 128 at bucket 128)
        two = bn == 64 and h * w > 16 and smem <= SMEM_TWO_BLOCKS
        return Plan("wgmma", ib, th, bn, smem, 2 if two else 1)
    if w > SYNC_M:
        raise ValueError(f"conv3x3_bn_relu takes maps up to {SYNC_M} wide "
                         f"in fp32 and at cin or cout not a multiple of 8, "
                         f"got {w}")
    th = min(h, SYNC_M // w)
    elem = 2 if dtype == torch.bfloat16 else 4
    smem = ((th + 2) * (w + 2) * SYNC_STRIDE + 9 * WG_KC * SYNC_STRIDE_W) \
        * elem
    return Plan("sync", 1, th, 64, smem)


def require_aligned(*tensors: torch.Tensor) -> None:
    """The wgmma path copies 16 bytes at a time: every base must be 16-byte
    aligned (a fresh allocation is; a view at an odd offset is not)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(
                "conv3x3_bn_relu's bf16 kernel needs 16-byte-aligned x, w "
                f"and out; got a base at {t.data_ptr()} (mod 16 = "
                f"{t.data_ptr() % 16})"
            )


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
    n, h, wd, cin = x.shape
    p = plan(h, wd, cin, w.shape[3], x.dtype)
    if p.path == "sync" and n > 65535:  # one grid row per image
        raise ValueError("conv3x3_bn_relu's sync path takes at most 65535 "
                         f"images, got {n}")
    return launch(x, w, scale, bias, p)


def launch(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
           bias: torch.Tensor, p: Plan) -> torch.Tensor:
    """Launch the kernel with plan ``p`` on checked CUDA tensors. The
    wrapper passes :func:`plan`'s; a bench may pass the sync path at a
    bf16 site, to time the design the wgmma path replaced."""
    global LAUNCHES
    from pytorch_cifar_tpu_torch.ops import _build

    lib = _build.load("conv_bn_relu")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), n, h, wd, cin, cout)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if p.path == "wgmma":
        require_aligned(x, w, out)
        err = lib.conv3x3_bn_relu_bf16_wgmma(
            *ptrs, p.ib, p.th, p.bn, p.blocks_per_sm, p.smem, stream)
    else:
        fn = (lib.conv3x3_bn_relu_bf16 if x.dtype == torch.bfloat16
              else lib.conv3x3_bn_relu_f32)
        err = fn(*ptrs, stream)
    if err != 0:
        raise RuntimeError(
            f"conv3x3_bn_relu kernel launch failed with cudaError {err} at "
            f"x {tuple(x.shape)} {x.dtype}, cout {cout}, {p}"
        )
    with _launch_lock:
        LAUNCHES += 1
    return out
