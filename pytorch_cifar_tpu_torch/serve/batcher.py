"""Dynamic micro-batching: coalesce concurrent requests into device batches.

A copy of ``pytorch_cifar_tpu/serve/batcher.py`` for the port's
single-device engine, without its mesh-engine paths.

The engine's per-bucket programs amortize fixed dispatch cost over the
batch dimension, so serving throughput under concurrency hinges on running
FEW LARGE batches instead of many single-image ones. The batcher is the
piece that turns N independent clients into that shape:

- ``submit`` enqueues a request (1..k images) and returns a
  ``concurrent.futures.Future``; a single worker thread drains the queue.
- The worker coalesces queued requests up to ``max_batch`` images, waiting
  at most ``max_wait_ms`` after it picks up the first one — the classic
  latency/throughput knob (0 = never wait, pure FIFO).
- **Admission control**: the queue is bounded at ``max_queue`` images.
  A full queue rejects with :class:`QueueFull` instead of growing without
  bound — under sustained overload an unbounded queue converts overload
  into unbounded latency for EVERY request, which is strictly worse than
  telling some clients to back off (they retry; see loadgen).
- **Deadlines**: a request may carry a deadline (per-submit ``deadline_ms``
  or the constructor default). A request whose deadline passes while it is
  still queued fails fast with :class:`DeadlineExceeded` at batch-formation
  time instead of occupying a coalesced batch — when the engine stalls,
  callers get a bounded-latency error they can retry elsewhere, not a
  forever-pending future (ROBUSTNESS.md).
- **Priority lanes** (SERVING.md "priority classes"): a request is either
  ``"interactive"`` (the default: a user is waiting on it) or ``"bulk"``
  (batch scoring, backfills — throughput matters, latency does not). Two
  fairness guarantees keep a bulk flood from starving interactive
  traffic, which plain FIFO demonstrably does NOT (the pre-lane batcher
  served a deep bulk backlog to completion before touching an interactive
  request queued behind it — past any reasonable deadline):
  (1) *dispatch order*: batch formation drains the interactive lane
  first, so an interactive request waits at most one in-flight engine
  call plus the interactive queue ahead of it, never the bulk backlog;
  (2) *admission*: bulk may occupy at most ``bulk_share`` of ``max_queue``
  (further bulk submits get :class:`QueueFull` — back off and retry),
  so interactive submits always find queue headroom. Interactive-lane
  FIFO order is unchanged from the single-lane batcher, and an all-
  interactive workload behaves bit-for-bit as before.
- **Continuous batching** (``continuous``, default on): batch formation
  closes at ``max_batch``/``max_wait_ms`` as before, but the worker
  makes one more non-blocking admission pass at DISPATCH time, filling
  the pad slack of the bucket program the formed batch is about to run
  (``engine.bucket_for(total) - total`` rows that would otherwise carry
  zero padding). A request that arrived after formation closed — or
  that could not extend the batch past ``max_batch`` but fits the
  bucket being dispatched anyway — rides the current device call
  instead of waiting out a full engine cycle. The pass drains lanes in
  priority order and never skips past a lane's head (per-lane FIFO is
  preserved); letting bulk fill leftover slack delays no interactive
  request — the batch departs immediately either way, the rows were
  pads. The dispatched PROGRAM never changes (slack is bounded by the
  bucket the formed total already selected), so ``compile_count`` stays
  pinned. Admissions are counted in ``serve.continuous_admitted`` /
  ``serve.continuous_images``; note a slack-filled batch may exceed
  ``max_batch`` up to that bucket size (the occupancy histogram can
  read > 1.0) — those rows were free.
- **Staged assembly**: multi-request batches are copied straight into a
  bucket-sized buffer from the engine's shared staging arena
  (``data/pipeline.StagingPool``) with the pad tail zeroed, so the
  engine pads nothing and the dispatch path allocates nothing
  (``serve.staging_reuse``).
- **Graceful drain**: ``close()`` rejects new submissions immediately,
  finishes everything already admitted (so accepted requests are never
  dropped), then stops the worker. ``close(drain=False)`` fails pending
  requests with :class:`BatcherClosed` immediately — and if the worker
  does not exit within ``timeout`` (wedged in a stalled engine call),
  whatever is still queued is failed too, so no caller is ever left
  blocked forever on ``future.result()``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional

import numpy as np

from pytorch_cifar_tpu_torch.obs import MetricsRegistry, trace


class QueueFull(RuntimeError):
    """Admission control: the request queue is at max_queue images."""


class BatcherClosed(RuntimeError):
    """The batcher is shutting down and accepts no new requests."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed while it was still queued."""


# request-priority classes (SERVING.md): order = dispatch order
PRIORITIES = ("interactive", "bulk")


class _Pending:
    __slots__ = (
        "x", "n", "future", "expires_at", "admitted_at", "priority"
    )

    def __init__(
        self,
        x: np.ndarray,
        expires_at: Optional[float] = None,
        priority: str = "interactive",
    ):
        self.x = x
        self.n = x.shape[0]
        self.future: Future = Future()
        self.expires_at = expires_at  # time.monotonic() deadline, or None
        self.admitted_at = 0.0  # perf_counter at admission (latency obs)
        self.priority = priority


class MicroBatcher:
    def __init__(
        self,
        engine,
        *,
        max_batch: Optional[int] = None,
        max_wait_ms: float = 2.0,
        max_queue: int = 1024,
        default_deadline_ms: float = 0.0,
        bulk_share: float = 0.5,
        continuous: bool = True,
        autostart: bool = True,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.engine = engine
        self.max_batch = int(max_batch or max(engine.buckets))
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        if self.max_queue < self.max_batch:
            # a queue smaller than one batch could never fill a batch
            raise ValueError("max_queue must be >= max_batch")
        self.default_deadline_ms = float(default_deadline_ms)
        # priority lanes (module docstring): dispatch drains lanes in
        # PRIORITIES order; bulk admission is capped at bulk_share of the
        # queue so a bulk flood can never crowd interactive submits out
        if not 0.0 < bulk_share <= 1.0:
            raise ValueError("bulk_share must be in (0, 1]")
        self.bulk_share = float(bulk_share)
        self._bulk_max = max(
            self.max_batch, int(self.max_queue * self.bulk_share)
        )
        # continuous batching (module docstring): the dispatch-time
        # slack-admission pass needs the engine's bucket table; engines
        # without one (or continuous=False) keep the close-at-formation
        # batcher exactly as before
        self.continuous = bool(continuous) and hasattr(engine, "bucket_for")
        self._lanes = {p: deque() for p in PRIORITIES}
        self._queued_images = 0
        self._queued_bulk_images = 0
        self._cond = threading.Condition()
        self._closed = False
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        # observability (obs/): the registry is the single source of
        # truth and ``stats`` is a read-only view over it.
        # ``registry=None`` gives this batcher its own (tests assert exact
        # counts); the serve CLI passes one shared registry through
        # engine and batcher.
        self.obs = registry if registry is not None else MetricsRegistry()
        self._c_requests = self.obs.counter("serve.requests")
        self._c_images = self.obs.counter("serve.images")
        self._c_batches = self.obs.counter("serve.batches")
        self._c_rejected = self.obs.counter("serve.rejected")
        self._c_expired = self.obs.counter("serve.expired")
        self._g_queue = self.obs.gauge("serve.queue_depth")
        # per-priority accounting (the starvation regression's obs trail):
        # bulk totals ride their own counters/gauge so the exporter can
        # tell a healthy bulk backlog from interactive queue pressure
        self._c_bulk_requests = self.obs.counter("serve.bulk_requests")
        self._c_bulk_rejected = self.obs.counter("serve.bulk_rejected")
        self._c_bulk_expired = self.obs.counter("serve.bulk_expired")
        self._g_bulk_queue = self.obs.gauge("serve.bulk_queue_depth")
        # images per coalesced batch (its max is the old largest_batch)
        # and fill fraction against max_batch — the knob max_wait_ms
        # exists to move
        self._h_batch = self.obs.histogram(
            "serve.batch_images",
            bounds=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
        )
        self._h_occupancy = self.obs.histogram(
            "serve.batch_occupancy",
            bounds=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
        )
        # admission -> result latency, the client-observed number
        self._h_latency = self.obs.histogram("serve.latency_ms")
        # continuous-batching admissions: requests/images that rode the
        # pad slack of an already-formed batch instead of waiting for
        # the next engine cycle
        self._c_cont_admitted = self.obs.counter("serve.continuous_admitted")
        self._c_cont_images = self.obs.counter("serve.continuous_images")
        if autostart:
            self.start()

    @property
    def stats(self) -> dict:
        """Summary view over the registry, plus the per-priority
        accounting: ``queued`` holds the LIVE
        per-lane image counts and the ``bulk_*`` keys total the bulk
        lane's traffic (interactive = the totals minus bulk)."""
        with self._cond:
            queued = {
                p: sum(r.n for r in self._lanes[p]) for p in PRIORITIES
            }
        return {
            "requests": int(self._c_requests.value),
            "images": int(self._c_images.value),
            "batches": int(self._c_batches.value),
            "rejected": int(self._c_rejected.value),
            "expired": int(self._c_expired.value),
            "largest_batch": int(self._h_batch.snapshot()["max"]),
            "queued": queued,
            "bulk_requests": int(self._c_bulk_requests.value),
            "bulk_rejected": int(self._c_bulk_rejected.value),
            "bulk_expired": int(self._c_bulk_expired.value),
            "continuous_admitted": int(self._c_cont_admitted.value),
        }

    # -- client side ---------------------------------------------------

    def submit(
        self,
        images: np.ndarray,
        deadline_ms: Optional[float] = None,
        priority: str = "interactive",
    ) -> Future:
        """Enqueue a request; the Future resolves to fp32 logits for
        exactly these rows. Raises QueueFull/BatcherClosed synchronously
        so the caller can apply backpressure without blocking.
        ``deadline_ms`` bounds queue time (falls back to the constructor's
        ``default_deadline_ms``; 0/None = no deadline). ``priority`` picks
        the lane (module docstring): ``"bulk"`` requests are admitted only
        into their ``bulk_share`` queue slice and dispatch after every
        queued interactive request."""
        if priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {priority!r} (expected one of "
                f"{PRIORITIES})"
            )
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        expires_at = (
            time.monotonic() + deadline_ms / 1e3 if deadline_ms else None
        )
        req = _Pending(np.asarray(images), expires_at, priority)
        if req.n < 1:
            raise ValueError("empty request")
        bulk = priority == "bulk"
        with self._cond:
            if self._closed:
                raise BatcherClosed("batcher is closed")
            if bulk:
                self._c_bulk_requests.inc()
            if self._queued_images + req.n > self.max_queue or (
                bulk and self._queued_bulk_images + req.n > self._bulk_max
            ):
                self._c_rejected.inc()
                if bulk:
                    self._c_bulk_rejected.inc()
                raise QueueFull(
                    f"{priority} queue at {self._queued_images}"
                    f"/{self.max_queue} images "
                    f"(bulk {self._queued_bulk_images}/{self._bulk_max}); "
                    f"retry later"
                )
            req.admitted_at = time.perf_counter()
            self._lanes[priority].append(req)
            self._queued_images += req.n
            if bulk:
                self._queued_bulk_images += req.n
            self._c_requests.inc()
            self._set_queue_gauges_locked()
            self._cond.notify()
        return req.future

    def predict(
        self,
        images: np.ndarray,
        deadline_ms: Optional[float] = None,
        priority: str = "interactive",
    ) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(images, deadline_ms, priority).result()

    # -- worker side ---------------------------------------------------

    def start(self) -> None:
        # the thread handle is shared with close() — taking the condition
        # here makes a concurrent start/close pair see one consistent
        # worker instead of racing the is_alive check (graftcheck
        # unlocked-shared-mutation). The nascent worker just blocks on
        # this same condition in _take_batch until start() releases it.
        with self._cond:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._worker, name="micro-batcher", daemon=True
                )
                self._thread.start()

    def _set_queue_gauges_locked(self) -> None:
        self._g_queue.set(self._queued_images)
        self._g_bulk_queue.set(self._queued_bulk_images)

    def _remove_accounting_locked(self, req: _Pending) -> None:
        """Queue-size bookkeeping for one request leaving a lane (caller
        holds the lock and has already popped it)."""
        self._queued_images -= req.n
        if req.priority == "bulk":
            self._queued_bulk_images -= req.n

    def _expire_locked(self, req: _Pending, now: float) -> None:
        self._remove_accounting_locked(req)
        self._c_expired.inc()
        if req.priority == "bulk":
            self._c_bulk_expired.inc()
        req.future.set_exception(
            DeadlineExceeded(
                f"request expired after "
                f"{(now - req.expires_at) * 1e3:.1f} ms past its "
                f"deadline while queued"
            )
        )

    def _qlen_locked(self) -> int:
        return sum(len(q) for q in self._lanes.values())

    def _head_lane_locked(self):
        """The lane the next request dispatches from: lanes drain in
        PRIORITIES order, so bulk only moves when no interactive request
        is queued — the anti-starvation dispatch rule."""
        for p in PRIORITIES:
            if self._lanes[p]:
                return self._lanes[p]
        return None

    def _fail_expired_locked(self) -> None:
        """Fail every queued request whose deadline has passed (caller
        holds the lock). Runs at batch-formation time: an expired request
        must not occupy a coalesced batch, and after an engine stall the
        backlog fails fast instead of being served pointlessly late."""
        if not any(
            r.expires_at is not None
            for q in self._lanes.values()
            for r in q
        ):
            return
        now = time.monotonic()
        for p, q in self._lanes.items():
            kept: deque = deque()
            for req in q:
                if req.expires_at is not None and now >= req.expires_at:
                    self._expire_locked(req, now)
                else:
                    kept.append(req)
            self._lanes[p] = kept
        self._set_queue_gauges_locked()

    def _take_batch(self):
        """Block until work exists, then coalesce up to max_batch images,
        waiting at most max_wait_ms after the first request is picked up.
        Lanes drain in priority order (interactive first). Returns []
        only at shutdown with an empty queue."""
        with self._cond:
            self._fail_expired_locked()
            while not self._qlen_locked() and not self._closed:
                self._cond.wait()
                self._fail_expired_locked()
            lane = self._head_lane_locked()
            if lane is None:
                return []  # closed and fully drained
            batch = [lane.popleft()]
            total = batch[0].n
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            while total < self.max_batch:
                lane = self._head_lane_locked()
                if lane is not None:
                    head = lane[0]
                    if (
                        head.expires_at is not None
                        and time.monotonic() >= head.expires_at
                    ):
                        # expired while coalescing: fail it, keep going
                        lane.popleft()
                        self._expire_locked(head, time.monotonic())
                        continue
                    if total + head.n > self.max_batch:
                        break  # requests are never split across batches
                    batch.append(lane.popleft())
                    total += head.n
                else:
                    if self._closed:
                        break  # draining: don't wait for traffic that
                        # can no longer arrive
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                    self._fail_expired_locked()
                    if not self._qlen_locked():
                        break  # timeout or spurious wake with no work
            for req in batch:
                self._remove_accounting_locked(req)
            self._set_queue_gauges_locked()
        return batch

    def _admit_slack_locked(self, batch, total: int) -> int:
        """Continuous batching (module docstring): one non-blocking
        admission pass at dispatch time, filling the pad slack of the
        bucket ``total`` already selected. Lanes drain in priority
        order; per-lane FIFO is preserved (a head that does not fit
        ends that lane's pass — later requests are never reordered past
        it). Returns the new total. Caller holds the condition."""
        target = self.engine.bucket_for(total)
        if target < total:
            # total is past the largest bucket: the engine will chunk
            # this batch — there is no single program with slack to fill
            return total
        admitted_reqs = admitted_imgs = 0
        for p in PRIORITIES:
            q = self._lanes[p]
            while q and total < target:
                head = q[0]
                if (
                    head.expires_at is not None
                    and time.monotonic() >= head.expires_at
                ):
                    q.popleft()
                    self._expire_locked(head, time.monotonic())
                    continue
                if total + head.n > target:
                    break  # FIFO: never skip past a lane's head
                q.popleft()
                self._remove_accounting_locked(head)
                batch.append(head)
                total += head.n
                admitted_reqs += 1
                admitted_imgs += head.n
            if total >= target:
                break
        if admitted_reqs:
            self._c_cont_admitted.inc(admitted_reqs)
            self._c_cont_images.inc(admitted_imgs)
            self._set_queue_gauges_locked()
        return total

    def _account_dispatch_locked(self, total: int) -> None:
        """Per-dispatch metrics for the finalized batch (caller holds
        the condition)."""
        self._c_batches.inc()
        self._c_images.inc(total)
        self._h_batch.observe(total)
        self._h_occupancy.observe(total / self.max_batch)

    def _assemble(self, batch, total: int):
        """Host assembly of one dispatch batch: ``(x, release)`` where
        ``release`` (may be None) must be called once the engine call
        has returned. Multi-request batches copy into a bucket-sized
        buffer from the engine's staging arena with the pad tail zeroed
        — the engine then pads nothing and the hot path allocates
        nothing; single requests pass through untouched (zero copies).
        A batch past the largest bucket (the engine chunks it) is a plain
        concatenate."""
        if len(batch) == 1:
            return batch[0].x, None
        pool = self.engine.staging
        bucket = self.engine.bucket_for(total)
        if bucket < total:
            return np.concatenate([r.x for r in batch], axis=0), None
        first = batch[0].x
        buf = pool.acquire((bucket, *first.shape[1:]), first.dtype)
        off = 0
        for req in batch:
            buf[off : off + req.n] = req.x
            off += req.n
        buf[off:] = 0  # pad rows are zeros (the engine's contract)
        return buf, lambda: pool.release(buf)

    def _worker(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return
            # dispatch-time slack admission + the per-dispatch metrics:
            # a second lock acquisition AFTER formation released it, so
            # requests submitted in between are visible to the pass
            with self._cond:
                total = sum(r.n for r in batch)
                if self.continuous:
                    total = self._admit_slack_locked(batch, total)
                self._account_dispatch_locked(total)
            if not self._drain and self._closed:
                for req in batch:
                    req.future.set_exception(
                        BatcherClosed("batcher closed without drain")
                    )
                continue
            x, release = self._assemble(batch, total)
            try:
                with trace.span("serve/batch", images=total):
                    out = self.engine.predict(x)
            except Exception as e:  # engine failure fails THIS batch only
                for req in batch:
                    req.future.set_exception(e)
                continue
            finally:
                if release is not None:
                    release()
            off = 0
            done = time.perf_counter()
            for req in batch:
                req.future.set_result(out[off : off + req.n])
                off += req.n
                self._h_latency.observe((done - req.admitted_at) * 1e3)

    # -- lifecycle -----------------------------------------------------

    def _fail_queued_locked(self, exc: Exception) -> None:
        for q in self._lanes.values():
            while q:
                req = q.popleft()
                self._remove_accounting_locked(req)
                req.future.set_exception(exc)
        self._set_queue_gauges_locked()

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting requests; by default finish everything already
        admitted before the worker exits. ``drain=False`` fails all
        pending futures immediately; a worker that misses ``timeout``
        (stalled engine call) has its remaining queue failed too — either
        way no caller stays blocked forever on ``future.result()``."""
        with self._cond:
            self._closed = True
            self._drain = drain
            if not drain:
                # fail HERE, not in the worker: the worker may be wedged
                # inside a stalled engine.predict and never reach the queue
                self._fail_queued_locked(
                    BatcherClosed("batcher closed without drain")
                )
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                with self._cond:
                    self._fail_queued_locked(
                        BatcherClosed(
                            f"batcher close timed out after {timeout}s "
                            "with the worker still busy; request abandoned"
                        )
                    )

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
        return False
