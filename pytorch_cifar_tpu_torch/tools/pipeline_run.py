"""Continuous train -> canary -> promote pipeline in one command.

Counterpart of the JAX package's ``tools/pipeline_run.py``. A trainer
child publishes every best checkpoint into ``<ckpt>/staging``
(``python -m pytorch_cifar_tpu_torch.train ... --publish staging``); this
process serves the LIVE dir over HTTP while a one-replica canary vets each
staged candidate (exact golden-batch diffing plus an optional shadow soak)
and the promotion controller either republishes it into the live dir (the
hot-reload watcher then swaps it into the serving engine) or quarantines
it with a tombstone while the trainer keeps running. The fleet never
serves a byte of an unvetted checkpoint.

Topology (one process + one trainer child)::

    train --publish staging ──> <ckpt>/staging ──> PromotionController
                                                        │ promote
    HTTP clients ──> frontend ──> ShadowBackend ────────┼─> <ckpt> (live)
                       │               └─shadow tee─> canary engine
                       └──> batcher ──> live engine <─watcher─┘

Two modes:

- **pipeline** (``--epochs N``): spawn the trainer child, serve and vet
  until it finishes and every staged candidate has a verdict, then drain
  and report;
- **serve-only** (``--epochs 0``): serve and vet until SIGTERM/SIGINT or
  ``--duration_s``; the live dir must hold a checkpoint already, and
  candidates are staged by someone else (``chip_smoke.py``'s canary drill).

Prints ONE JSON line on stdout (promotions and rejections, the canary's
status, the served epoch and generation, the canary's golden and promote
times, each engine's forwards and the kernels' launches, client-side load
stats); progress and the readiness lines go to stderr:

    ==> pipeline: watching staging <ckpt>/staging
    ==> pipeline: serving on http://127.0.0.1:PORT

Usage:
  python -m pytorch_cifar_tpu_torch.tools.pipeline_run --ckpt ./pipe \\
      --model ResNet18 --epochs 3 --clients 4 --shadow_fraction 0.5
  python -m pytorch_cifar_tpu_torch.tools.pipeline_run --ckpt ./pipe \\
      --model ResNet18 --epochs 0 --golden eval     # serve-only

Runs on CUDA (both engines and the trainer child on the one card) unless
``--device cpu`` is given, which the tests do.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the card trains with amp and serves in bf16 (the train and serving
# CLIs' defaults); the CPU (tests) stays in fp32
COMPUTE_DTYPE = {"cuda": torch.bfloat16, "cpu": torch.float32}


def train_cmd(args) -> list:
    """The trainer child: the port's train CLI on the synthetic split,
    staging every improvement (the canary decides what the fleet sees,
    not a disk-write throttle)."""
    return [
        sys.executable, "-m", "pytorch_cifar_tpu_torch.train",
        "--model", args.model,
        "--synthetic_data",
        "--synthetic_train_size", str(args.train_size),
        "--synthetic_test_size", str(args.test_size),
        "--batch_size", str(args.batch),
        "--epochs", str(args.epochs),
        "--lr", str(args.lr),
        "--amp" if args.device == "cuda" else "--no-amp",
        "--output_dir", args.ckpt,
        "--publish", "staging",
        "--checkpoint_every", "0",
        "--log_every", "1000000",
        "--seed", str(args.seed),
        "--device", args.device,
    ]


def wait_for_staged(staging: str, proc, timeout: float) -> None:
    """Block until the trainer child commits its first staged checkpoint
    (payload + sidecar): the bootstrap precondition."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            _, err = proc.communicate()
            raise SystemExit(
                f"trainer exited rc={proc.returncode} before its first "
                f"staged checkpoint:\n{err[-4000:]}"
            )
        if all(
            os.path.isfile(os.path.join(staging, n))
            for n in ("ckpt.msgpack", "ckpt.json")
        ):
            return
        time.sleep(0.2)
    raise SystemExit("timed out waiting for the first staged checkpoint")


def drive_load(url, stop, *, clients, images_max, bulk_fraction,
               deadline_ms, seed):
    """Closed-loop HTTP load until ``stop`` is set (the loadgen protocol:
    back off and retry on QueueFull, hedge once on DeadlineExceeded).
    Returns ``finish()``, which joins the clients and returns the merged
    report."""
    from pytorch_cifar_tpu_torch.serve.batcher import (
        BatcherClosed,
        DeadlineExceeded,
        QueueFull,
    )
    from pytorch_cifar_tpu_torch.serve.loadgen import (
        HttpTarget,
        percentile_ms,
    )

    lat_ms: list = []
    counts = {
        "images": 0, "rejected": 0, "hedged": 0, "failed": 0, "bulk": 0,
    }
    lock = threading.Lock()

    def submit_with_backoff(target, x, priority):
        while not stop.is_set():
            try:
                return target.submit(x, priority=priority)
            except QueueFull:
                with lock:
                    counts["rejected"] += 1
                time.sleep(0.002)
        raise BatcherClosed("pipeline load stopping")

    def client(cid: int) -> None:
        target = HttpTarget(url, deadline_ms=deadline_ms or None)
        rs = np.random.RandomState(seed * 1000 + cid)
        while not stop.is_set():
            n = int(rs.randint(1, images_max + 1))
            x = rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)
            priority = (
                "bulk"
                if bulk_fraction and rs.uniform() < bulk_fraction
                else "interactive"
            )
            if priority == "bulk":
                with lock:
                    counts["bulk"] += 1
            t0 = time.perf_counter()
            try:
                submit_with_backoff(target, x, priority).result()
            except DeadlineExceeded:
                with lock:
                    counts["hedged"] += 1
                try:
                    submit_with_backoff(target, x, priority).result()
                except (DeadlineExceeded, BatcherClosed):
                    if not stop.is_set():
                        with lock:
                            counts["failed"] += 1
                    continue
            except BatcherClosed:
                if not stop.is_set():
                    with lock:
                        counts["failed"] += 1
                continue
            with lock:
                lat_ms.append((time.perf_counter() - t0) * 1e3)
                counts["images"] += n
        target.close()

    t_start = time.perf_counter()
    threads = [
        threading.Thread(target=client, args=(i,), name=f"pipe-load-{i}")
        for i in range(clients)
    ]
    for t in threads:
        t.start()

    def finish() -> dict:
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t_start
        return {
            "clients": clients,
            "requests": len(lat_ms),
            "elapsed_s": round(elapsed, 3),
            "img_per_sec": counts["images"] / max(elapsed, 1e-9),
            "p50_ms": percentile_ms(lat_ms, 50),
            "p95_ms": percentile_ms(lat_ms, 95),
            "p99_ms": percentile_ms(lat_ms, 99),
            **counts,
        }

    return finish


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_cifar_tpu_torch.tools.pipeline_run",
        description="Train into staging, vet each candidate on a canary, "
                    "promote it into the live dir and hot-reload it.",
    )
    p.add_argument("--ckpt", required=True, help="live dir (staging is "
                   "<ckpt>/staging); bootstrapped from the trainer's first "
                   "staged checkpoint if empty")
    p.add_argument("--model", default="LeNet")
    # trainer child (synthetic recipe)
    p.add_argument("--epochs", type=int, default=3,
                   help="trainer child epochs; 0 = serve-only mode")
    p.add_argument("--train-size", type=int, default=512, dest="train_size")
    p.add_argument("--test-size", type=int, default=256, dest="test_size")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    # serving
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 4, 8])
    p.add_argument("--max_wait_ms", type=float, default=2.0)
    p.add_argument("--deadline_ms", type=float, default=0.0)
    p.add_argument("--http_port", type=int, default=0)
    p.add_argument("--http_host", default="127.0.0.1")
    p.add_argument("--poll_s", type=float, default=0.3,
                   help="canary + watcher poll interval")
    # canary budget
    p.add_argument("--shadow_fraction", type=float, default=0.25)
    p.add_argument("--min_shadow", type=int, default=0,
                   help="shadow requests a candidate must soak before "
                   "promotion (0 = golden-only gate)")
    p.add_argument("--max_flip_frac", type=float, default=0.75)
    p.add_argument("--acc_margin", type=float, default=1.0)
    p.add_argument("--golden", choices=("eval", "labeled", "random"),
                   default="eval",
                   help="golden set: the trainer's synthetic eval split "
                   "(labeled: the accuracy gate applies), 'labeled' = the "
                   "real CIFAR-10 test split (GoldenSet.labeled_eval; "
                   "synthetic, loudly, when the archive is absent), or "
                   "unlabeled random batches")
    p.add_argument("--golden_n", type=int, default=128)
    p.add_argument("--data_dir", default="./data",
                   help="--golden labeled: where the CIFAR-10 archive "
                   "lives")
    # load + lifecycle
    p.add_argument("--clients", type=int, default=0)
    p.add_argument("--images_max", type=int, default=4)
    p.add_argument("--bulk_fraction", type=float, default=0.0)
    p.add_argument("--duration_s", type=float, default=0.0,
                   help="serve-only mode: stop after this many seconds "
                   "(0 = until SIGTERM/SIGINT)")
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from pytorch_cifar_tpu_torch import resolve_device
    from pytorch_cifar_tpu_torch.obs import MetricsRegistry
    from pytorch_cifar_tpu_torch.serve import (
        BatcherBackend,
        CanaryBudget,
        CheckpointWatcher,
        GoldenSet,
        InferenceEngine,
        MicroBatcher,
        PromotionController,
        ServingFrontend,
        ShadowBackend,
    )
    from pytorch_cifar_tpu_torch.serve.engine import kernel_launches
    from pytorch_cifar_tpu_torch.train.checkpoint import (
        CKPT_NAME,
        ensure_staging_dir,
        publish_checkpoint,
    )
    from pytorch_cifar_tpu_torch.utils.logging import set_logger

    set_logger(None)
    device = resolve_device(args.device)
    live = args.ckpt
    staging = ensure_staging_dir(live)

    trainer = None
    if args.epochs > 0:
        print(
            f"==> pipeline: trainer child staging into {staging}",
            file=sys.stderr, flush=True,
        )
        trainer = subprocess.Popen(
            train_cmd(args),
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
            text=True,
            cwd=REPO,
        )

    # bootstrap: with no live incumbent there is nothing to diff against,
    # so the first staged checkpoint is published as generation 0; every
    # later candidate must beat it through the canary
    if not os.path.isfile(os.path.join(live, CKPT_NAME)):
        if trainer is None:
            raise SystemExit(
                f"no live checkpoint in {live!r} and no trainer to make "
                "one (--epochs 0 needs a bootstrapped dir)"
            )
        wait_for_staged(staging, trainer, args.timeout)
        path = publish_checkpoint(
            staging, live,
            extra_meta={"promotion": {"generation": 0, "bootstrap": True}},
        )
        print(f"==> pipeline: bootstrapped live <- {path}", file=sys.stderr,
              flush=True)

    registry = MetricsRegistry()
    dtype = COMPUTE_DTYPE[device.type]
    kw = dict(buckets=tuple(args.buckets), compute_dtype=dtype,
              device=device)
    engine = InferenceEngine.from_checkpoint(
        live, args.model, registry=registry, **kw
    )
    canary_engine = InferenceEngine.from_checkpoint(live, args.model, **kw)
    if args.golden == "eval":
        golden = GoldenSet.synthetic_eval(
            n_train=args.train_size, n_test=args.test_size,
            limit=args.golden_n,
        )
    elif args.golden == "labeled":
        golden = GoldenSet.labeled_eval(
            args.data_dir, limit=args.golden_n, seed=args.seed
        )
    else:
        golden = GoldenSet.random(args.golden_n, seed=args.seed)
    controller = PromotionController(
        canary_engine, staging, live,
        golden=golden,
        budget=CanaryBudget(
            max_flip_frac=args.max_flip_frac,
            acc_margin=args.acc_margin,
            min_shadow_requests=args.min_shadow,
        ),
        poll_s=args.poll_s,
        shadow_fraction=args.shadow_fraction,
        registry=registry,
    ).start()
    print(f"==> pipeline: watching staging {staging}", file=sys.stderr,
          flush=True)

    batcher = MicroBatcher(
        engine, max_wait_ms=args.max_wait_ms,
        default_deadline_ms=args.deadline_ms, registry=registry,
    )
    watcher = CheckpointWatcher(
        engine, live, poll_s=args.poll_s, registry=registry
    ).start()
    backend = ShadowBackend(
        BatcherBackend(engine, batcher, watcher=watcher), controller
    )
    frontend = ServingFrontend(
        backend, host=args.http_host, port=args.http_port,
        registry=registry,
    ).start()
    print(f"==> pipeline: serving on {frontend.url}", file=sys.stderr,
          flush=True)

    stop_load = threading.Event()
    finish_load = None
    if args.clients > 0:
        finish_load = drive_load(
            frontend.url, stop_load,
            clients=args.clients, images_max=args.images_max,
            bulk_fraction=args.bulk_fraction,
            deadline_ms=args.deadline_ms, seed=args.seed,
        )

    trainer_rc = None
    try:
        if trainer is not None:
            deadline = time.monotonic() + args.timeout
            while trainer.poll() is None:
                if time.monotonic() > deadline:
                    trainer.kill()
                    raise SystemExit("trainer child timed out")
                time.sleep(0.3)
            _, err = trainer.communicate()
            trainer_rc = trainer.returncode
            if trainer_rc != 0:
                sys.stderr.write(err[-4000:])
            # quiesce: every staged publish still in flight gets its
            # verdict before the pipeline reports
            deadline = time.monotonic() + args.timeout
            while controller.pending_candidate():
                if time.monotonic() > deadline:
                    print(
                        "==> pipeline: quiesce timed out with a pending "
                        "candidate", file=sys.stderr,
                    )
                    break
                time.sleep(args.poll_s)
            # one more watcher poll, so a just-promoted checkpoint serves
            # before the final report
            watcher.poll_once()
        else:
            stop = threading.Event()
            signal.signal(signal.SIGTERM, lambda *a: stop.set())
            signal.signal(signal.SIGINT, lambda *a: stop.set())
            stop.wait(args.duration_s or None)
    finally:
        print("==> pipeline: draining", file=sys.stderr, flush=True)
        stop_load.set()
        load_report = finish_load() if finish_load is not None else {}
        frontend.stop()
        controller.stop()
        watcher.stop()
        batcher.close()
        if trainer is not None and trainer.poll() is None:
            trainer.terminate()
            try:
                trainer.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                trainer.kill()
                trainer.communicate()
            trainer_rc = trainer.returncode

    served_meta = watcher.last_meta or engine.checkpoint_meta
    status = controller.status()
    summary = registry.summary()
    record = {
        "harness": "pipeline_run",
        "model": args.model,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "dtype": str(dtype).removeprefix("torch."),
        "live_dir": live,
        "trainer_rc": trainer_rc,
        "promotions": status["promotions"],
        "rejected": status["rejected"],
        "generation": status["generation"],
        "canary": status,
        "served_epoch": served_meta.get("epoch"),
        "served_generation": (
            (served_meta.get("promotion") or {}).get("generation")
        ),
        "reloads": watcher.reloads,
        "reload_quarantined": watcher.quarantined,
        "compiles": engine.compile_count,
        # every device forward of each engine (warmups, batches, golden
        # evals, shadow requests) and the kernels they launched
        "forwards": {"live": engine.forward_count,
                     "canary": canary_engine.forward_count},
        "launches_by_kernel": kernel_launches(),
        # the canary's own times, from the registry (canary.* histograms)
        "canary_ms": {
            k: summary.get(f"canary.{k}")
            for k in ("golden_ms.count", "golden_ms.p50", "golden_ms.max",
                      "promote_ms.count", "promote_ms.p50",
                      "promote_ms.max", "shadow_ms.count", "shadow_ms.p50",
                      "shadow_ms.max")
        },
        "max_memory_allocated_mb": (
            torch.cuda.max_memory_allocated(device) / 2**20
            if device.type == "cuda" else None
        ),
        "load": load_report,
    }
    print(json.dumps(record), flush=True)
    return 0 if trainer_rc in (None, 0) else 1


if __name__ == "__main__":
    sys.exit(main())
