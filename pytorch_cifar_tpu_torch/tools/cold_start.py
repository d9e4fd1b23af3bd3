"""Split a serving replica's cold start into its stages.

    python -m pytorch_cifar_tpu_torch.tools.cold_start --model ResNet18 \\
        --ckpt DIR [--lanes fp int8] [--aot_cache CACHE]
    python -m pytorch_cifar_tpu_torch.tools.cold_start \\
        --zoo GoogLeNet,MobileNet --cycles 3 [--aot_cache CACHE]

The first form is one fresh replica process: it times ``import torch``,
the CUDA context, the load of the serving kernels' libraries (built first
if they are not, and said so), then builds an engine for each of
``--lanes`` in turn (``fp``: the float engine at ``--dtype``; ``int8``: the
int8 lane) as the serving CLI does (``InferenceEngine.from_checkpoint``,
or ``from_random`` at ``--seed``) and reports each engine's own
``cold_start_stages``: the checkpoint's read and CRC, its decode, the
model's build and load, the fold (for int8 also the quantization and
``_int8_plan``), or on a cache hit the checkpoint's read, CRC and
SHA-256, the cache's read, its transfer and the model's skeleton; and each
bucket's first forward (the first lane's pay
the process's first launches). It then runs each bucket's second forward
on fixed inputs (``RandomState(16 + bucket)``) and prints their logits'
SHA-256, so two processes' bits compare by digest.

The second form is a zoo re-admission: a ``ModelZooServer`` of the named
tenants (seeded random weights, or ``<--ckpt>/<Name>`` where it exists)
with ``max_resident 1``, each tenant requested in turn ``--cycles`` times,
every admission's stages, ms and counters reported.

One JSON line on stdout. ``--device cpu`` runs it on the CPU (the tests);
the default is the card, and without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

SERVING_KERNELS = ("conv_bn_relu", "max_pool", "depthwise_stencil")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_cifar_tpu_torch.tools.cold_start",
        description="Split a replica's cold start (or a zoo re-admission) "
                    "into its stages.")
    p.add_argument("--model", default="ResNet18")
    p.add_argument("--ckpt", default=None,
                   help="serve this checkpoint (a trainer's dir, .msgpack or "
                        ".pth); default: seeded random weights")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 8, 32, 128])
    p.add_argument("--lanes", nargs="+", default=["fp"],
                   choices=["fp", "int8"],
                   help="the engines to build in turn (fp: float; int8: "
                        "the int8 lane)")
    p.add_argument("--aot_cache", default="",
                   help="the cold-start cache directory ('' = none)")
    p.add_argument("--zoo", default="",
                   help="comma-separated tenants: time their re-admissions")
    p.add_argument("--cycles", type=int, default=2,
                   help="--zoo: requests of every tenant in turn")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    args = parse_args(argv)
    t_main = time.perf_counter()
    stages = {}
    t0 = time.perf_counter()
    import numpy as np
    import torch
    stages["import_torch_ms"] = _ms(t0)

    from pytorch_cifar_tpu_torch import resolve_device

    t0 = time.perf_counter()
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    stages["cuda_context_ms"] = _ms(t0)
    built_now = []
    if device.type == "cuda":
        from pytorch_cifar_tpu_torch.ops import _build

        built_now = [n for n in SERVING_KERNELS
                     if not _build.library_path(n).exists()]
        t0 = time.perf_counter()
        for n in SERVING_KERNELS:
            _build.load(n)
        stages["kernel_libraries_ms"] = _ms(t0)
    t0 = time.perf_counter()
    from pytorch_cifar_tpu_torch.serve import InferenceEngine
    from pytorch_cifar_tpu_torch.serve.engine import kernel_launches
    stages["import_port_ms"] = _ms(t0)
    dtype = getattr(torch, args.dtype)
    kw = dict(buckets=args.buckets, compute_dtype=dtype, device=device,
              aot_cache_dir=args.aot_cache or None)
    out = {"dtype": args.dtype, "lanes": args.lanes,
           "buckets": sorted(set(args.buckets)),
           "aot_cache": bool(args.aot_cache), "platform": device.type,
           "device": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "kernels_built_now": built_now}
    if args.zoo:
        out.update(_zoo(args, kw, kernel_launches))
        out["process_stages"] = stages
        print(json.dumps(out))
        return 0

    out.update({"model": args.model, "ckpt": args.ckpt,
                "process_stages": stages, "engines": {}})
    for lane in args.lanes:
        launches0 = kernel_launches()
        t0 = time.perf_counter()
        if args.ckpt:
            engine = InferenceEngine.from_checkpoint(
                args.ckpt, args.model, int8=lane == "int8", **kw)
        else:
            engine = InferenceEngine.from_random(
                args.model, seed=args.seed, int8=lane == "int8", **kw)
        engine_ms = _ms(t0)
        ready_ms = _ms(t_main)
        warm_launches = {k: v - launches0[k]
                         for k, v in kernel_launches().items()}
        second, bits = {}, {}
        for b in engine.buckets:
            x = np.random.RandomState(16 + b).randint(
                0, 256, size=(b, 32, 32, 3)).astype(np.uint8)
            t0 = time.perf_counter()
            y = engine.predict(x)
            second[f"b{b}_second_ms"] = _ms(t0)
            bits[str(b)] = hashlib.sha256(np.ascontiguousarray(
                y, dtype=np.float32).tobytes()).hexdigest()
        out["engines"][lane] = {
            "engine_ms": engine_ms,
            "stages": engine.cold_start_stages,
            "second_forward": second,
            "ready_ms": ready_ms,
            "cold_start_s": engine.cold_start_s,
            "ready_s": engine.ready_s,
            "compiles": engine.compile_count,
            "aot_cache_hits": engine.aot_cache_hits,
            "aot_cache_misses": engine.aot_cache_misses,
            "bits": bits,
            "warmup_launches": warm_launches,
            "launches_by_kernel": {k: v - launches0[k]
                                   for k, v in kernel_launches().items()},
        }
        del engine
    print(json.dumps(out))
    return 0


def _zoo(args, kw, kernel_launches) -> dict:
    """Every tenant requested in turn ``--cycles`` times through a
    ``max_resident 1`` zoo: each request after the first evicts and
    admits."""
    import numpy as np

    from pytorch_cifar_tpu_torch.obs import MetricsRegistry
    from pytorch_cifar_tpu_torch.serve import ModelZooServer, TenantSpec

    names = [n.strip() for n in args.zoo.split(",") if n.strip()]
    specs = []
    for n in names:
        d = os.path.join(args.ckpt, n) if args.ckpt else ""
        specs.append(TenantSpec(n, d if d and os.path.isdir(d) else None,
                                buckets=tuple(args.buckets), seed=args.seed))
    registry = MetricsRegistry()
    launches0 = kernel_launches()
    zoo = ModelZooServer(
        specs, max_resident=1, compute_dtype=kw["compute_dtype"],
        registry=registry, int8=args.lanes == ["int8"], device=kw["device"],
        aot_cache_dir=kw["aot_cache_dir"], eager=False)
    x = np.random.RandomState(16).randint(
        0, 256, size=(5, 32, 32, 3)).astype(np.uint8)
    admissions = []
    bits = {}
    try:
        for cycle in range(args.cycles):
            for n in names:
                t0 = time.perf_counter()
                y = zoo.predict(x, model=n)
                ms = _ms(t0)
                eng = zoo._tenants[n].engine
                admissions.append({
                    "model": n, "cycle": cycle, "ms": ms,
                    "engine_ms": eng.ready_s * 1e3,
                    "compiles": eng.compile_count,
                    "aot_cache_hits": eng.aot_cache_hits,
                    "aot_cache_misses": eng.aot_cache_misses,
                    "stages": eng.cold_start_stages,
                })
                digest = hashlib.sha256(y.tobytes()).hexdigest()
                bits.setdefault(n, set()).add(digest)
    finally:
        zoo.close()
    return {
        "zoo": names, "admissions": admissions,
        "bits_stable": {n: len(v) == 1 for n, v in bits.items()},
        "launches_by_kernel": {k: v - launches0[k]
                               for k, v in kernel_launches().items()},
    }


if __name__ == "__main__":
    sys.exit(main())
