"""Serving CLI of the port, in load-generator mode or as one HTTP replica:

    python -m pytorch_cifar_tpu_torch.serve --model ResNet18 --verify
    python -m pytorch_cifar_tpu_torch.serve --model GoogLeNet
    python -m pytorch_cifar_tpu_torch.serve --model MobileNet
    python -m pytorch_cifar_tpu_torch.serve --model ResNet18 --ckpt checkpoint
    python -m pytorch_cifar_tpu_torch.serve --model ResNet18 --ckpt checkpoint \\
        --watch --http_port 0
    python -m pytorch_cifar_tpu_torch.serve --model ResNet18 --http_port 0
    python -m pytorch_cifar_tpu_torch.serve --model ResNet18 \\
        --http_port 8100 --edge event --deadline_ms 250 --prom_out s.prom
    python -m pytorch_cifar_tpu_torch.serve --model ResNet18 --int8
    python -m pytorch_cifar_tpu_torch.serve \\
        --models ResNet18,GoogLeNet,MobileNet --max_resident 2 [--int8]

Builds an :class:`InferenceEngine` from seeded random weights, or from
``--ckpt`` (a trainer's directory, a ``.msgpack`` of either package, or a
reference ``ckpt.pth``), warms every bucket, optionally checks that the
padded bucket path equals the direct unpadded forward (``--verify``) and
puts a :class:`MicroBatcher` in front of it. ``--watch`` (with ``--ckpt``
a directory) starts a :class:`CheckpointWatcher` that hot-reloads every
newer publish of that dir every ``--poll_s`` seconds, refusing staging
dirs, torn pairs and quarantined publishes. Then one of two traffic
sources:

- default (``--http_port -1``): the closed-loop load generator drives the
  batcher in-process;
- ``--http_port N`` (0 = an ephemeral port): the process is one replica
  of a fleet. ``--edge threaded`` (the default) serves through
  :class:`ServingFrontend`, ``--edge event`` through
  :class:`EdgeFrontend`: ``POST /predict`` in JSON or the binary PCTW
  frame, ``GET /healthz``, live Prometheus ``GET /metrics``. It prints
  ``==> http: serving on URL`` on stderr, serves until SIGTERM/SIGINT or
  ``--duration_s``, then drains (in-flight requests are answered). A
  :class:`~pytorch_cifar_tpu_torch.serve.router.Router` spreads clients
  over such replicas.

Either way it prints ONE JSON line on stdout under ``serve.py``'s key
names (in HTTP mode the report of its ``_serve_http``: what the network
brought, from the metrics registry), plus ``kernel_launches`` (launches
of the port's serving kernels during the run: the fused conv, the 3x3 max
pool and the depthwise stencil, whichever the model has),
``launches_by_kernel``, ``device`` and, with ``--ckpt``, ``ckpt_epoch``
(``reloads`` and ``reload_skipped`` count the watcher's swaps and deferred
polls).
``--int8`` serves the engine's int8 weight-only lane.

``--models A,B=dir,...`` turns the process into a
:class:`ModelZooServer` hosting every named model (``serve.py``'s zoo
mode): a tenant without ``=dir`` serves ``<--ckpt>/<Name>`` when that
directory exists, else seeded random weights; ``--max_resident`` and
``--zoo_memory_mb`` bound the resident set. The load generator draws each
request's model from a zipf mix ordered by the card's cost priors
(``load_cost_priors``), or ``--http_port`` puts the zoo behind the
frontend (model-routed; an unknown model is a 404). Its JSON line carries
``serve.py``'s zoo keys (``model: "zoo"``, ``models``, ``resident``,
``zoo``, ``admission_ms_p50``, ``tenants``) beside the load report's.

Progress goes to stderr. Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from pytorch_cifar_tpu_torch import resolve_device
from pytorch_cifar_tpu_torch.obs import (
    MetricsExporter,
    MetricsRegistry,
    trace,
    write_prometheus,
)
from pytorch_cifar_tpu_torch.obs.metrics import _percentile_from_buckets
from pytorch_cifar_tpu_torch.serve import (
    BatcherBackend,
    CheckpointWatcher,
    EdgeFrontend,
    InferenceEngine,
    MicroBatcher,
    ModelZooServer,
    ServingFrontend,
    TenantSpec,
    load_cost_priors,
    run_load,
    zipf_mix,
)
from pytorch_cifar_tpu_torch.serve.engine import kernel_launches

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
EDGES = {"threaded": ServingFrontend, "event": EdgeFrontend}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_cifar_tpu_torch.serve",
        description="Serve a model under closed-loop load or over HTTP.",
    )
    p.add_argument("--model", default="ResNet18")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 8, 32, 128])
    p.add_argument("--max_batch", type=int, default=0,
                   help="0 = the largest bucket")
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--max_queue", type=int, default=1024)
    p.add_argument("--deadline_ms", type=float, default=0.0,
                   help="queue-time bound of a request without its own "
                        "(0 = none)")
    p.add_argument("--bulk_share", type=float, default=0.5,
                   help="share of max_queue bulk requests may hold")
    p.add_argument("--continuous", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="fill a dispatched bucket's pad slack with queued "
                        "requests")
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests", type=int, default=64, help="per client")
    p.add_argument("--request_images_max", type=int, default=8)
    p.add_argument("--duration_s", type=float, default=0.0,
                   help="wall-clock cap of the load, or how long an HTTP "
                        "replica serves (0 = none: until SIGTERM/SIGINT)")
    p.add_argument("--hedge", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="resubmit a request that missed its deadline once")
    p.add_argument("--ckpt", default=None,
                   help="serve this checkpoint (trainer dir, .msgpack or "
                        ".pth) instead of seeded random weights")
    p.add_argument("--watch", action="store_true",
                   help="hot-reload newer checkpoints published into the "
                        "--ckpt directory")
    p.add_argument("--poll_s", type=float, default=1.0,
                   help="--watch: seconds between polls")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--int8", action="store_true",
                   help="serve int8 weights (weight-only, one scale per "
                        "output channel; not bit-identical to float)")
    p.add_argument("--models", default="",
                   help="zoo mode: comma-separated Name[=ckpt_dir] tenants "
                        "(no model in a request = the first); a tenant "
                        "without a dir serves <--ckpt>/<Name> if it exists")
    p.add_argument("--max_resident", type=int, default=0,
                   help="zoo: resident tenants at most (0 = all)")
    p.add_argument("--zoo_memory_mb", type=float, default=0.0,
                   help="zoo: estimated weight-bytes budget (0 = none)")
    p.add_argument("--verify", action="store_true",
                   help="check padded bucket forward == direct forward")
    p.add_argument("--http_port", type=int, default=-1,
                   help="serve HTTP on this port (0 = ephemeral; -1 = the "
                        "in-process load generator)")
    p.add_argument("--http_host", default="127.0.0.1")
    p.add_argument("--edge", default="threaded", choices=sorted(EDGES),
                   help="threaded: a thread per connection; event: one "
                        "non-blocking loop and a worker pool")
    p.add_argument("--trace_out", default="",
                   help="write host spans here (Chrome trace JSON)")
    p.add_argument("--metrics_out", default="",
                   help="append metric snapshots here (JSONL)")
    p.add_argument("--metrics_every_s", type=float, default=10.0)
    p.add_argument("--prom_out", default="",
                   help="write the metrics as Prometheus text at exit")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def _serve_http(args, backend, registry) -> dict:
    """Serve ``backend`` over HTTP until SIGTERM/SIGINT or
    ``--duration_s``, drain, and return a load-shaped report assembled
    from the registry (the keys of ``serve.py``'s ``_serve_http``)."""
    frontend = EDGES[args.edge](
        backend, host=args.http_host, port=args.http_port,
        registry=registry,
    ).start()
    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(f"==> http: serving on {frontend.url}", file=sys.stderr,
          flush=True)
    t0 = time.perf_counter()
    stop.wait(args.duration_s or None)
    try:
        print("==> http: draining", file=sys.stderr, flush=True)
    except OSError:
        pass  # the reader of stderr is gone: the drain must still run
    frontend.stop()  # no new requests; in-flight responses finish
    elapsed = time.perf_counter() - t0

    snap = registry.snapshot()
    s = registry.summary()
    http_ms = snap["histograms"].get("serve.http_ms")
    requests = int(s.get("serve.http_ms.count", 0.0))
    images = int(s.get("serve.http_images", 0.0))
    return {
        "clients": 0,  # open-loop: whatever the network brought
        "requests": requests,
        "images": images,
        "rejected": int(s.get("serve.rejected", 0.0)),
        "hedged": int(s.get("serve.hedged", 0.0)),
        "failed": int(s.get("serve.http_errors", 0.0)),
        "bulk_requests": int(s.get("serve.bulk_requests", 0.0)),
        "elapsed_s": round(elapsed, 4),
        "img_per_sec": images / max(elapsed, 1e-9),
        "request_per_sec": requests / max(elapsed, 1e-9),
        "mean_ms": s.get("serve.http_ms.mean", 0.0),
        "p50_ms": s.get("serve.http_ms.p50", 0.0),
        "p95_ms": s.get("serve.http_ms.p95", 0.0),
        "p99_ms": (
            _percentile_from_buckets(http_ms, 99.0) if http_ms else 0.0
        ),
    }


def _main_zoo(args, registry, device) -> int:
    """Zoo mode (``--models``): one :class:`ModelZooServer` under the
    in-process load generator (a zipf per-model mix from the cost priors)
    or behind the frontend, and one JSON line with per-tenant blocks
    beside the load report's keys."""
    launches0 = kernel_launches()
    root = args.ckpt or "./checkpoint"
    specs = []
    for entry in args.models.split(","):
        spec = TenantSpec.parse(
            entry,
            buckets=tuple(args.buckets),
            deadline_ms=args.deadline_ms,
            max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms,
            max_queue=args.max_queue,
            bulk_share=args.bulk_share,
            watch=args.watch,
            poll_s=args.poll_s,
            seed=args.seed,
        )
        if spec.ckpt is None:
            # per-model ckpt-dir convention: <--ckpt>/<Name> when it
            # exists; otherwise seeded random weights
            candidate = os.path.join(root, spec.name)
            if os.path.isdir(candidate):
                spec.ckpt = candidate
            else:
                print(
                    f"==> zoo: no checkpoint for {spec.name} (looked in "
                    f"{candidate}); serving random weights at seed "
                    f"{args.seed}",
                    file=sys.stderr,
                )
        specs.append(spec)
    t0 = time.perf_counter()
    zoo = ModelZooServer(
        specs,
        max_resident=args.max_resident,
        memory_budget_mb=args.zoo_memory_mb,
        compute_dtype=DTYPES[args.dtype],
        registry=registry,
        continuous=args.continuous,
        int8=args.int8,
        device=device,
    )
    health = zoo.health()
    print(
        f"==> zoo: {len(specs)} tenants ({', '.join(zoo.models())}), "
        f"{len(health['resident'])} resident (max_resident "
        f"{zoo.max_resident}, budget {args.zoo_memory_mb or 'unbounded'} "
        f"MiB), warm in {time.perf_counter() - t0:.2f}s on {device}",
        file=sys.stderr,
    )
    exporter = None
    if args.metrics_out:
        exporter = MetricsExporter(
            registry, args.metrics_out, interval_s=args.metrics_every_s
        ).start()
    try:
        if args.http_port >= 0:
            report = _serve_http(args, zoo, registry)
        else:
            report = run_load(
                zoo,
                clients=args.clients,
                requests_per_client=args.requests,
                images_max=args.request_images_max,
                seed=args.seed,
                duration_s=args.duration_s or None,
                hedge=args.hedge,
                model_mix=zipf_mix(zoo.models(), priors=load_cost_priors()),
            )
        # residency and generations BEFORE the drain tears them down
        health = zoo.health()
    finally:
        zoo.close()
        if exporter is not None:
            exporter.stop()
        if args.prom_out:
            write_prometheus(args.prom_out, registry.snapshot())
        if args.trace_out:
            trace.uninstall()

    s = registry.summary()
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    out = {
        "model": "zoo",
        "models": zoo.models(),
        "default_model": zoo.default_model,
        "resident": health["resident"],
        "max_resident": zoo.max_resident,
        "memory_budget_mb": args.zoo_memory_mb,
        "platform": device.type,
        "device": (
            torch.cuda.get_device_name(device)
            if device.type == "cuda"
            else "cpu"
        ),
        "dtype": args.dtype,
        "int8": args.int8,
        "zoo": zoo.stats,
        "admission_ms_p50": round(
            s.get("serve.zoo.admission_ms.p50", 0.0), 3
        ),
        "tenants": {
            name: {
                k: t.get(k)
                for k in (
                    "resident", "admissions", "evictions",
                    "engine_version", "ckpt_epoch",
                    "promotion_generation", "compiles",
                    "aot_cache_hits",
                )
            }
            for name, t in health["tenants"].items()
        },
        **{
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in report.items()
        },
        "kernel_launches": sum(launches.values()),
        "launches_by_kernel": launches,
    }
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.watch and not args.ckpt and not args.models:
        print("error: --watch needs --ckpt (the directory to watch)",
              file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    registry = MetricsRegistry()
    if args.trace_out:
        trace.install(args.trace_out)
    if args.models:
        return _main_zoo(args, registry, device)
    launches0 = kernel_launches()
    source = f"ckpt {args.ckpt}" if args.ckpt else f"seed {args.seed}"
    print(
        f"==> building {args.model} ({source}, buckets "
        f"{tuple(args.buckets)}, {args.dtype}, {device})",
        file=sys.stderr,
    )
    kw = dict(buckets=args.buckets, compute_dtype=DTYPES[args.dtype],
              registry=registry, device=device, int8=args.int8)
    if args.ckpt:
        engine = InferenceEngine.from_checkpoint(args.ckpt, args.model, **kw)
    else:
        engine = InferenceEngine.from_random(args.model, seed=args.seed, **kw)
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
        default_deadline_ms=args.deadline_ms,
        bulk_share=args.bulk_share,
        continuous=args.continuous,
        registry=registry,
    )
    exporter = None
    if args.metrics_out:
        exporter = MetricsExporter(
            registry, args.metrics_out, interval_s=args.metrics_every_s
        ).start()
    watcher = None
    if args.watch:
        watcher = CheckpointWatcher(
            engine, args.ckpt, poll_s=args.poll_s, registry=registry
        ).start()
        print(
            f"==> watching {args.ckpt} for new best checkpoints "
            f"(poll {args.poll_s}s)",
            file=sys.stderr,
        )
    try:
        if args.http_port >= 0:
            report = _serve_http(
                args, BatcherBackend(engine, batcher, watcher=watcher),
                registry,
            )
        else:
            report = run_load(
                batcher,
                clients=args.clients,
                requests_per_client=args.requests,
                images_max=args.request_images_max,
                seed=args.seed,
                duration_s=args.duration_s or None,
                hedge=args.hedge,
            )
    finally:
        if watcher is not None:
            watcher.stop()
        batcher.close()  # graceful drain
        if exporter is not None:
            exporter.stop()
        if args.prom_out:
            write_prometheus(args.prom_out, registry.snapshot())
        if args.trace_out:
            trace.uninstall()

    obs_summary = registry.summary()
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    out = {
        "model": args.model,
        "platform": device.type,
        "device": (
            torch.cuda.get_device_name(device)
            if device.type == "cuda"
            else "cpu"
        ),
        "dtype": args.dtype,
        "int8": args.int8,
        "n_devices": 1,
        "buckets": list(engine.buckets),
        "max_batch": batcher.max_batch,
        "max_wait_ms": args.max_wait_ms,
        "compiles": engine.compile_count,
        "cold_start_s": round(engine.cold_start_s, 3),
        "engine_version": engine.version,
        "reloads": watcher.reloads if watcher is not None else 0,
        "reload_skipped": watcher.skipped if watcher is not None else 0,
        "batches": batcher.stats["batches"],
        "largest_batch": batcher.stats["largest_batch"],
        "deadline_ms": args.deadline_ms,
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
            "expired": obs_summary.get("serve.expired", 0.0),
            "hedged": obs_summary.get("serve.hedged", 0.0),
            "reloads": obs_summary.get("serve.reload.reloads", 0.0),
            "wire_requests": obs_summary.get("serve.wire_requests", 0.0),
            "wire_decode_p95_ms": round(
                obs_summary.get("serve.wire_decode_ms.p95", 0.0), 3
            ),
            "staging_reuse": obs_summary.get("serve.staging_reuse", 0.0),
            "continuous_admitted": obs_summary.get(
                "serve.continuous_admitted", 0.0
            ),
        },
    }
    if args.ckpt:
        out["ckpt_epoch"] = engine.checkpoint_meta.get("epoch")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
