"""What the kernel bench tools and ``chip_smoke.py`` share: the card's name
and power limit, CUDA-event timing, the library's 3x3 pool, which profiled
kernel names are the library's convolutions and GEMMs, and the main path's
kernel shapes."""

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


# ResNet-18's fused conv3x3+BN+ReLU sites: (name, h, w, cin, cout, launches
# per forward)
RESNET18_SITES = [
    ("stem", 32, 32, 3, 64, 1),
    ("layer1.{0,1}.conv1", 32, 32, 64, 64, 2),
    ("layer2.1.conv1", 16, 16, 128, 128, 1),
    ("layer3.1.conv1", 8, 8, 256, 256, 1),
    ("layer4.1.conv1", 4, 4, 512, 512, 1),
]

# GoogLeNet's 3x3 / stride 1 pool inputs at batch 512: (h, w, c, pools per
# forward), and a shape that takes the narrow-vector path
POOL_SHAPES = [(32, 32, 192, 1), (32, 32, 256, 1), (16, 16, 480, 1),
               (16, 16, 512, 3), (16, 16, 528, 1), (8, 8, 832, 2)]
POOL_ODD = (3, 5, 5, 130)

# the depthwise stencil's shapes: MobileNet's five stride-1 depthwise sites
# at bucket 128 (k = 3), PNASNet's 5x5 and 7x7 at (512, 32, 32, 44), and a
# narrow-vector shape: (n, h, w, c, k, launches per MobileNet forward)
STENCIL_SHAPES = [(128, 32, 32, 32, 3, 1), (128, 16, 16, 128, 3, 1),
                  (128, 8, 8, 256, 3, 1), (128, 4, 4, 512, 3, 5),
                  (128, 2, 2, 1024, 3, 1), (512, 32, 32, 44, 5, 0),
                  (512, 32, 32, 44, 7, 0), (2, 8, 8, 130, 3, 0),
                  (2, 8, 8, 130, 7, 0)]


def _recorded(name: str, op: str, key) -> dict:
    """``{key(*args): calls}`` of the ``models.common`` op ``op`` in one
    folded forward of ``name`` on one image on the CPU."""
    from pytorch_cifar_tpu_torch.models import common, create_model

    count: dict = {}
    real = getattr(common, op)

    def record(*args):
        k = key(*args)
        count[k] = count.get(k, 0) + 1
        return real(*args)

    setattr(common, op, record)
    try:
        with torch.no_grad():
            create_model(name).eval()(torch.zeros(1, 3, 32, 32))
    finally:
        setattr(common, op, real)
    return count


def fused_sites(name: str) -> list:
    """Any model's fused conv3x3+BN+ReLU sites, one row per distinct (h, w,
    cin, cout) in forward order with its launches per forward, recorded
    from one folded forward of one image on the CPU."""
    count = _recorded(name, "conv3x3_bn_relu", lambda x, w, scale, bias: (
        x.shape[1], x.shape[2], w.shape[2], w.shape[3]))
    return [(f"{h}x{w}x{cin}->{cout}", h, w, cin, cout, k)
            for (h, w, cin, cout), k in count.items()]


def stencil_sites(name: str) -> list:
    """Any model's depthwise stencil sites: ``(h, w, c, k, launches per
    forward)`` per distinct shape, in forward order (as
    :func:`fused_sites`)."""
    count = _recorded(name, "depthwise_stencil", lambda x, w: (
        x.shape[1], x.shape[2], x.shape[3], w.shape[0]))
    return [(*shape, k) for shape, k in count.items()]


def pool_sites(name: str) -> list:
    """Any model's 3x3 / stride 1 max-pool sites: ``(h, w, c, launches per
    forward)`` per distinct shape, in forward order."""
    count = _recorded(name, "max_pool3x3_s1",
                      lambda x: (x.shape[1], x.shape[2], x.shape[3]))
    return [(*shape, k) for shape, k in count.items()]
