"""What the kernel bench tools and ``chip_smoke.py`` share: the card's name
and power limit, CUDA-event timing, the library's 3x3 pool, and which
profiled kernel names are the library's convolutions and GEMMs."""

from __future__ import annotations

import statistics
import subprocess

import torch
import torch.nn.functional as F

# substrings of cuDNN's and cuBLAS's kernel names (``nvjet`` is cuBLAS's
# Hopper GEMM, which the 1x1 convolutions and the linear layers run)
LIBRARY_CONV_GEMM_KEYS = ("conv", "xmma", "gemm", "cudnn", "cutlass",
                          "implicit", "sm90", "wgrad", "dgrad", "nvjet")


def is_library_conv_gemm(kernel_name: str) -> bool:
    low = kernel_name.lower()
    return any(k in low for k in LIBRARY_CONV_GEMM_KEYS)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 25, reps: int = 5) -> float:
    """Median over ``runs`` of the per-call device time of ``reps``
    back-to-back calls, timed with CUDA events. A sleep kernel queued first
    keeps the stream busy while the host enqueues, so the events bracket
    device work, not launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def library_pool(v: torch.Tensor) -> torch.Tensor:
    """The library yardstick of the 3x3 / stride 1 / pad 1 max pool on an
    NHWC view (never on the port's path for this pool)."""
    return F.max_pool2d(v.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)
