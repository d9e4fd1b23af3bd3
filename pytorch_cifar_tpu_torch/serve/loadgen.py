"""Synthetic closed-loop load generator + latency statistics.

The closed-loop half of ``pytorch_cifar_tpu/serve/loadgen.py`` for the
port: each simulated client submits one request, BLOCKS on its result, then
immediately submits the next, so offered load adapts to service capacity
(``clients`` bounds the in-flight requests) and the latency distribution is
the one a real synchronous client would see. ``QueueFull`` rejections are
counted and retried after a short backoff; a request that fails (its
deadline passed, or the batcher closed) counts as ``failed``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from pytorch_cifar_tpu_torch.serve.batcher import (
    BatcherClosed,
    DeadlineExceeded,
    QueueFull,
)

IMAGE_SHAPE = (32, 32, 3)
RETRY_BACKOFF_S = 0.002


def percentile_ms(latencies_ms, pct: float) -> float:
    """Nearest-rank percentile of a latency sample (ms)."""
    if not latencies_ms:
        return 0.0
    xs = sorted(latencies_ms)
    idx = min(len(xs) - 1, max(0, int(round(pct / 100.0 * len(xs))) - 1))
    return xs[idx]


def run_load(
    batcher,
    *,
    clients: int = 8,
    requests_per_client: int = 16,
    images_max: int = 8,
    seed: int = 0,
) -> dict:
    """Drive ``batcher`` with ``clients`` synchronous synthetic clients,
    ``requests_per_client`` requests each.

    Each request carries a uniform-random 1..images_max batch of uint8
    32x32x3 images (the realistic serving mix: mostly small requests,
    padded by the engine), drawn from a per-client ``RandomState``.
    ``batcher`` is anything with the submit surface, such as a
    :class:`~pytorch_cifar_tpu_torch.serve.batcher.MicroBatcher`.

    Returns the latency/throughput report the CLIs publish:
    ``img_per_sec``, ``request_per_sec``, ``p50_ms``/``p95_ms``/``p99_ms``,
    ``mean_ms``, ``requests``, ``images``, ``rejected``, ``failed``,
    ``elapsed_s``.
    """
    latencies_ms: list = []
    counts = {"images": 0, "rejected": 0, "failed": 0}
    lock = threading.Lock()

    def submit_with_backoff(x):
        while True:
            try:
                return batcher.submit(x)
            except QueueFull:
                # admission control said back off; the retry delay is
                # part of the client-observed latency (t0 stays)
                with lock:
                    counts["rejected"] += 1
                time.sleep(RETRY_BACKOFF_S)

    def client(cid: int) -> None:
        rs = np.random.RandomState(seed * 1000 + cid)
        for _ in range(requests_per_client):
            n = int(rs.randint(1, images_max + 1))
            x = rs.randint(0, 256, size=(n, *IMAGE_SHAPE)).astype(np.uint8)
            t0 = time.perf_counter()
            try:
                submit_with_backoff(x).result()
            except (DeadlineExceeded, BatcherClosed):
                with lock:
                    counts["failed"] += 1
                continue
            dt_ms = (time.perf_counter() - t0) * 1e3
            with lock:
                latencies_ms.append(dt_ms)
                counts["images"] += n

    threads = [
        threading.Thread(target=client, args=(i,), name=f"loadgen-{i}")
        for i in range(clients)
    ]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t_start

    return {
        "clients": clients,
        "requests": len(latencies_ms),
        "images": counts["images"],
        "rejected": counts["rejected"],
        "failed": counts["failed"],
        "elapsed_s": round(elapsed, 4),
        "img_per_sec": counts["images"] / max(elapsed, 1e-9),
        "request_per_sec": len(latencies_ms) / max(elapsed, 1e-9),
        "mean_ms": (
            sum(latencies_ms) / len(latencies_ms) if latencies_ms else 0.0
        ),
        "p50_ms": percentile_ms(latencies_ms, 50),
        "p95_ms": percentile_ms(latencies_ms, 95),
        "p99_ms": percentile_ms(latencies_ms, 99),
    }
