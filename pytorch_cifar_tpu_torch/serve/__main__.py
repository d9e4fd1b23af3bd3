"""Serving CLI of the port, load-generator mode:

    python -m pytorch_cifar_tpu_torch.serve --model ResNet18 --verify
    python -m pytorch_cifar_tpu_torch.serve --model GoogLeNet
    python -m pytorch_cifar_tpu_torch.serve --model MobileNet

Builds an :class:`InferenceEngine` from seeded random weights, warms every
bucket, optionally checks that the padded bucket path equals the direct
unpadded forward (``--verify``), drives a :class:`MicroBatcher` with the
closed-loop load generator, and prints ONE JSON line on stdout under
``serve.py``'s key names, plus ``kernel_launches`` (launches of the port's
serving kernels during the run: the fused conv, the 3x3 max pool and the
depthwise stencil, whichever the model has) and ``launches_by_kernel``.
Progress goes to stderr. Runs on CUDA unless
``--device cpu`` is given. Checkpoint loading (``--ckpt``) is not ported
yet.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.obs import MetricsRegistry
from pytorch_cifar_tpu_torch.ops import conv_bn_relu, depthwise_stencil, max_pool
from pytorch_cifar_tpu_torch.serve import (
    InferenceEngine,
    MicroBatcher,
    run_load,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _launches() -> dict:
    """Launch counts of the kernels a served forward can reach."""
    return {
        "conv3x3_bn_relu": conv_bn_relu.LAUNCHES,
        "max_pool3x3_s1": max_pool.FWD_LAUNCHES,
        "depthwise_stencil": depthwise_stencil.LAUNCHES,
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_cifar_tpu_torch.serve",
        description="Serve a seeded random-weight model under closed-loop load.",
    )
    p.add_argument("--model", default="ResNet18")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 8, 32, 128])
    p.add_argument("--max_batch", type=int, default=0,
                   help="0 = the largest bucket")
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--max_queue", type=int, default=1024)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests", type=int, default=64, help="per client")
    p.add_argument("--request_images_max", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verify", action="store_true",
                   help="check padded bucket forward == direct forward")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    registry = MetricsRegistry()
    launches0 = _launches()
    print(
        f"==> building {args.model} (seed {args.seed}, buckets "
        f"{tuple(args.buckets)}, {args.dtype}, {device})",
        file=sys.stderr,
    )
    engine = InferenceEngine.from_random(
        args.model,
        seed=args.seed,
        buckets=args.buckets,
        compute_dtype=DTYPES[args.dtype],
        registry=registry,
        device=device,
    )
    print(
        f"==> warm: {engine.compile_count} buckets in "
        f"{engine.cold_start_s:.2f}s",
        file=sys.stderr,
    )
    if args.verify:
        rs = np.random.RandomState(args.seed)
        bks = engine.buckets
        # an off-bucket size, so the padded path is actually exercised
        n = bks[0] - 1 if bks[0] > 1 else (bks[1] - 1 if len(bks) > 1 else 1)
        x = rs.randint(0, 256, size=(n, *engine.image_shape)).astype(np.uint8)
        padded, direct = engine.predict(x), engine.direct_forward(x)
        if not np.array_equal(padded, direct):
            print(
                "error: padded bucket forward is not bit-identical to the "
                f"direct unpadded forward at n={n} (max abs diff "
                f"{float(np.max(np.abs(padded - direct)))})",
                file=sys.stderr,
            )
            return 1
        print(
            f"==> verify: bucket-padded forward bit-identical to direct "
            f"forward at n={n}",
            file=sys.stderr,
        )

    batcher = MicroBatcher(
        engine,
        max_batch=args.max_batch or None,
        max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue,
        registry=registry,
    )
    try:
        report = run_load(
            batcher,
            clients=args.clients,
            requests_per_client=args.requests,
            images_max=args.request_images_max,
            seed=args.seed,
        )
    finally:
        batcher.close()  # graceful drain

    obs_summary = registry.summary()
    launches = {k: v - launches0[k] for k, v in _launches().items()}
    out = {
        "model": args.model,
        "platform": device.type,
        "device": (
            torch.cuda.get_device_name(device)
            if device.type == "cuda"
            else "cpu"
        ),
        "dtype": args.dtype,
        "n_devices": 1,
        "buckets": list(engine.buckets),
        "max_batch": batcher.max_batch,
        "max_wait_ms": args.max_wait_ms,
        "compiles": engine.compile_count,
        "cold_start_s": round(engine.cold_start_s, 3),
        "engine_version": engine.version,
        "batches": batcher.stats["batches"],
        "largest_batch": batcher.stats["largest_batch"],
        "expired": batcher.stats["expired"],
        **{
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in report.items()
        },
        "img_per_sec_per_chip": round(report["img_per_sec"], 3),
        "kernel_launches": sum(launches.values()),
        "launches_by_kernel": launches,
        "obs": {
            "queue_depth_max": obs_summary.get("serve.queue_depth.max", 0.0),
            "batch_occupancy_mean": round(
                obs_summary.get("serve.batch_occupancy.mean", 0.0), 4
            ),
            "latency_p95_ms": round(
                obs_summary.get("serve.latency_ms.p95", 0.0), 3
            ),
            "device_p95_ms": round(
                obs_summary.get("serve.device_ms.p95", 0.0), 3
            ),
            "staging_reuse": obs_summary.get("serve.staging_reuse", 0.0),
            "continuous_admitted": obs_summary.get(
                "serve.continuous_admitted", 0.0
            ),
        },
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
