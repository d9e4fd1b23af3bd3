"""Where a served forward's device time goes, by kernel, on the card:

    python -m pytorch_cifar_tpu_torch.tools.profile_forward

Builds the ResNet-18 engine (bf16, seeded random weights, buckets 8/32/128)
and, for each bucket, times ``ITERS`` warm ``predict`` calls with no
profiler attached (the wall time per call), then captures ``ITERS`` more
under ``torch.profiler`` with CUDA activity only (the device time). Prints
one JSON line per bucket: the mean and median wall time per call, the
device-busy time per call (sum of kernel times), the idle share
(1 - busy / mean wall), and the device time per call of each group — the
fused ``conv3x3_bn_relu`` kernel, cuDNN/cuBLAS convolutions and GEMMs,
copies, and everything else — with the ten costliest kernel names.
"""

from __future__ import annotations

import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pytorch_cifar_tpu_torch.serve import InferenceEngine

BUCKETS = (8, 32, 128)
ITERS = 50


def group_of(name: str) -> str:
    low = name.lower()
    if "conv3x3_bn_relu" in low:
        return "fused_conv3x3_bn_relu"
    if "memcpy" in low or "memset" in low:
        return "copy"
    if any(k in low for k in ("conv", "xmma", "gemm", "cudnn", "cutlass",
                              "implicit", "sm90", "wgrad", "dgrad")):
        return "library_conv_gemm"
    return "elementwise_other"


def profile_bucket(engine, b: int) -> dict:
    x = np.random.RandomState(b).randint(
        0, 256, size=(b, 32, 32, 3)
    ).astype(np.uint8)
    for _ in range(3):
        engine.predict(x)
    torch.cuda.synchronize()
    walls = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        engine.predict(x)  # returns host logits: ends synchronized
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.mean(walls))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            engine.predict(x)
    by_name: dict = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3 / ITERS
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device events")
    groups: dict = defaultdict(float)
    for name, ms in by_name.items():
        groups[group_of(name)] += ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "bucket": b,
        "wall_ms_per_call": wall_ms,
        "wall_ms_p50": float(np.median(walls)),
        "device_busy_ms_per_call": busy,
        "idle_share": 1.0 - busy / wall_ms,
        "groups_ms_per_call": dict(sorted(groups.items())),
        "top_kernels_ms_per_call": [[n[:90], ms] for n, ms in top],
    }


def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    engine = InferenceEngine.from_random(
        "ResNet18", seed=0, buckets=BUCKETS, compute_dtype=torch.bfloat16,
    )
    for b in engine.buckets:
        rec = profile_bucket(engine, b)
        print(json.dumps({"card": smi, "dtype": "bfloat16", **rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
