"""Where a train step's time goes, by kernel group, on the card:

    python -m pytorch_cifar_tpu_torch.tools.profile_train [--model GoogLeNet]

Builds a seeded train state of ``--model`` (ResNet-18 unless named; batch
512, bf16 compute, crop and flip on) and times ``ITERS`` warm steps on one fixed batch with no
profiler attached, with BN moments stock and under
``bn_moments_impl(fused_moments)`` (kernel K2) in turns (stock, fused,
fused, stock; the wall per step is the faster of each mode's two runs,
the last step synchronized; each step's host issue time, the host's wall
from the step's call to its return, is kept too: where it exceeds the
device's work the host bounds the step). Then it captures ``ITERS`` more
steps of each mode under ``torch.profiler`` with CUDA activity only (the
device time). Prints one JSON line per mode: wall and device-busy ms per
step, the idle share (1 - busy / wall), the
median and largest host issue ms per step of each unprofiled run, the
device ms per step of each kernel group (K1, K2, K3, K4 forward and
backward, library convs and GEMMs, reductions, the optimizer's fused updates, copies, other
elementwise work) and the ten costliest kernels. A last line times the
epoch gather (kernel K1, 50,176 rows of ``(50000, 32, 32, 3)`` uint8) and
its share of an epoch of 98 stock steps.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.models.common import bn_moments_impl
from pytorch_cifar_tpu_torch.ops.bn_stats import fused_moments
from pytorch_cifar_tpu_torch.ops.dma_gather import dma_row_gather
from pytorch_cifar_tpu_torch.tools._bench import (
    card_line,
    is_library_conv_gemm,
)
from pytorch_cifar_tpu_torch.train.optim import (
    cosine_epoch_schedule,
    make_optimizer,
)
from pytorch_cifar_tpu_torch.train.state import create_train_state
from pytorch_cifar_tpu_torch.train.steps import make_train_step

BATCH, ITERS, STEPS_PER_EPOCH = 512, 20, 98


def group_of(name: str) -> str:
    low = name.lower()
    for key, group in (("moments_", "k2_fused_moments"),
                       ("gather_rows", "k1_dma_row_gather"),
                       ("conv3x3_bn_relu", "k3_conv3x3_bn_relu"),
                       ("max_pool_fwd_kernel", "k4_max_pool_fwd"),
                       ("max_pool_bwd_kernel", "k4_max_pool_bwd"),
                       ("memcpy", "copy"), ("memset", "copy"),
                       ("multi_tensor_apply", "optimizer_foreach"),
                       ("reduce_kernel", "reduction")):
        if key in low:
            return group
    if is_library_conv_gemm(low):
        return "library_conv_gemm"
    return "elementwise_other"


def wall_ms(state, step, batch) -> tuple:
    """(wall ms per step over ``ITERS`` warm steps, each step's host issue
    ms), no profiler attached."""
    for _ in range(5):
        step(state, batch)
    torch.cuda.synchronize()
    issue = []
    t0 = time.perf_counter()
    for _ in range(ITERS):
        t = time.perf_counter()
        step(state, batch)
        issue.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / ITERS, issue


def profile_steps(state, step, batch, wall: float) -> dict:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            step(state, batch)
        torch.cuda.synchronize()
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
        "wall_ms_per_step": wall,
        "img_per_sec": BATCH / wall * 1e3,
        "device_busy_ms_per_step": busy,
        "idle_share": 1.0 - busy / wall,
        "groups_ms_per_step": dict(sorted(groups.items())),
        "top_kernels_ms_per_step": [[n[:90], ms] for n, ms in top],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", default="ResNet18")
    args = parser.parse_args(argv)
    smi = card_line()
    print(smi, flush=True)
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (BATCH, 32, 32, 3), generator=g,
                           dtype=torch.uint8).cuda()
    labels = torch.randint(0, 10, (BATCH,), generator=g,
                           dtype=torch.int32).cuda()
    model = create_model(args.model, generator=g).to(
        "cuda", memory_format=torch.channels_last
    )
    state = create_train_state(
        model, make_optimizer(model.parameters()),
        cosine_epoch_schedule(0.1, 200, STEPS_PER_EPOCH), device="cuda",
    )
    step = make_train_step(compute_dtype=torch.bfloat16, device="cuda")
    impls = {"stock": None, "fused_moments": fused_moments}
    # walls first, in turns, before any profiler capture: a finished
    # capture can leave the host's launches slower for the rest of the run
    runs = {mode: [] for mode in impls}
    issue = {mode: [] for mode in impls}
    for mode in ("stock", "fused_moments", "fused_moments", "stock"):
        with bn_moments_impl(impls[mode]):
            wall, per_step = wall_ms(state, step, (images, labels))
        runs[mode].append(wall)
        issue[mode].append([statistics.median(per_step), max(per_step)])
    walls = {mode: min(ms) for mode, ms in runs.items()}
    for mode, impl in impls.items():
        with bn_moments_impl(impl):
            rec = profile_steps(state, step, (images, labels), walls[mode])
        print(json.dumps({"card": smi, "model": args.model, "batch": BATCH,
                          "dtype": "bfloat16", "bn_moments": mode, "wall_ms_runs": runs[mode],
                          "host_issue_ms_p50_max_runs": issue[mode],
                          **rec}), flush=True)

    data = torch.randint(0, 256, (50_000, 32, 32, 3), generator=g,
                         dtype=torch.uint8).cuda()
    idx = torch.randint(0, 50_000, (STEPS_PER_EPOCH * BATCH,), generator=g,
                        dtype=torch.int32).cuda()
    for _ in range(3):
        dma_row_gather(data, idx)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        dma_row_gather(data, idx)
    end.record()
    torch.cuda.synchronize()
    k1_ms = start.elapsed_time(end) / ITERS
    epoch_ms = walls["stock"] * STEPS_PER_EPOCH
    print(json.dumps({"card": smi, "k1_epoch_gather_ms": k1_ms,
                      "epoch_steps_ms": epoch_ms,
                      "k1_share_of_epoch": k1_ms / (k1_ms + epoch_ms)}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
