"""Serving over processes: one logical replica spanning N ranks.

The port's counterpart of ``pytorch_cifar_tpu/serve/mesh_replica.py``,
on ``torch.distributed``. An :class:`InferenceEngine` built with a
``mesh_group`` runs its own slab of every padded bucket on its own
devices, and the leader gathers the logits; this module makes such a
group ONE replica behind the router:

- **Rank 0 (the leader)** owns the HTTP frontend and the micro-batcher.
  Every formed batch goes to the followers, first a fixed-size command
  frame (``int64[4]``: op, row count, sequence, reserved), then the batch
  bytes, each one broadcast of a host array of known size over the
  engine's gloo group (:func:`~pytorch_cifar_tpu_torch.parallel.mesh.broadcast_array`).
  Then every rank runs the same padded bucket, each its slab, and the
  logits come back to the leader in one fixed-size gather per bucket;
  the leader answers the wire.
- **Followers (ranks > 0)** run :meth:`MeshReplica.follower_loop` on
  their MAIN thread: they block on the next command frame and mirror
  whatever the leader dispatched. A follower decides nothing about time.
- **One initiator, one order.** Every collective (batches, weight swaps,
  heartbeats, shutdown) is started by one leader thread,
  ``_dispatch_loop``; callers (the batcher's worker, the hot-reload
  watcher) enqueue work and wait on a Future.
- **Gloo, whatever the device.** Command frames, batch bytes, weights
  and logits are host arrays over a gloo group: two ranks can share one
  card (NCCL refuses that), the CPU tests run the same code, and the
  dispatch thread's collectives never touch a CUDA stream.
- **Bootstrap and the warm-up barrier.** Construction broadcasts the
  leader's weights to every rank (every rank serves the leader's bits,
  whatever it read from its own disk), then runs one collective probe a
  bucket: every rank's slab holds the same images, so every rank's
  logits must equal the leader's bit for bit, or the replica does not
  serve.
- **Hot reload.** :meth:`MeshReplica.swap_weights` checks the weights'
  keys, shapes and dtypes on the caller's thread (a wrong model is
  refused before anything is broadcast), then the dispatch loop
  broadcasts them and every rank swaps the same generation.
- **A dead peer ends the process, never hangs it, never leaves a
  zombie.** (a) A collective that HANGS (gloo waiting for a peer that
  will not come) trips the watchdog: the leader arms a deadline around
  every collective, a follower re-arms on every command, and the idle
  leader heartbeats. (b) A collective that RAISES (gloo's ``timeout``,
  set from ``--mesh_timeout_s``, or a reset connection) leaves the ranks
  out of step. Either way the process exits :data:`PEER_TIMEOUT_RC`
  within ``timeout_s``; the router's probe of the leader fails and it
  evicts the logical replica and hedges its requests.

With one process (no ``mesh_group``) every broadcast is the identity and
the watchdog never starts: the engine's own semantics.
"""

from __future__ import annotations

import logging
import os
import queue as queue_lib
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np

from pytorch_cifar_tpu_torch import faults
from pytorch_cifar_tpu_torch.obs import trace
from pytorch_cifar_tpu_torch.parallel.mesh import (
    broadcast_array,
    broadcast_tree,
)
from pytorch_cifar_tpu_torch.serve.engine import probe_batch

log = logging.getLogger(__name__)

# command frame (int64[4]): [op, n_rows, sequence, reserved]. Fixed size,
# so a follower can always post its placeholder without knowing what
# comes; the op then says the shape of any payload that follows.
_CMD_LEN = 4
OP_HEARTBEAT = 0
OP_BATCH = 1
OP_SWAP = 2
OP_SHUTDOWN = 3

# exit code of a rank that found a dead or wedged peer: the launchers and
# the drill key on it, and 70 (EX_SOFTWARE) never collides with a signal
PEER_TIMEOUT_RC = 70


class MeshReplicaError(RuntimeError):
    """Protocol-level failure of the multi-process replica."""


class MeshReplicaClosed(MeshReplicaError):
    """The replica is shut down and accepts no new work."""


class _Watchdog:
    """Bounded detection of a peer that never arrives at a collective. A
    stuck gloo transfer cannot be interrupted from Python, so the one safe
    recovery is to take the process down: ``exit_fn`` (``os._exit`` by
    default; tests inject their own) fires once an armed deadline has
    passed. ``arm``/``disarm`` are cheap enough to wrap every
    collective."""

    def __init__(self, timeout_s: float, *, registry=None,
                 exit_fn=os._exit, interval_s: float = 0.25):
        self.timeout_s = float(timeout_s)
        self._exit_fn = exit_fn
        self._interval_s = float(interval_s)
        self._lock = threading.Lock()
        self._deadline: Optional[float] = None
        self._why = ""
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._c_timeouts = (registry.counter("serve.mesh.peer_timeouts")
                            if registry is not None else None)

    def arm(self, why: str) -> None:
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s
            self._why = why

    def disarm(self) -> None:
        with self._lock:
            self._deadline = None

    def _run(self) -> None:
        while not self._stop.wait(self._interval_s):
            with self._lock:
                deadline, why = self._deadline, self._why
            if deadline is not None and time.monotonic() > deadline:
                log.error(
                    "mesh replica watchdog: no collective progress for "
                    "%.1fs (%s) — a peer process is dead or wedged; "
                    "exiting rc=%d so the router can evict this logical "
                    "replica instead of hanging on it",
                    self.timeout_s, why, PEER_TIMEOUT_RC)
                if self._c_timeouts is not None:
                    self._c_timeouts.inc()
                self._exit_fn(PEER_TIMEOUT_RC)
                return  # an injected exit_fn does not exit

    def start(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="mesh-watchdog", daemon=True)
                self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()


class MeshReplica:
    """The engine-shaped coordinator of one multi-process replica: the
    :class:`InferenceEngine` surface the batcher, the watcher and the HTTP
    backend read (``predict``, ``swap_weights``, ``bucket_for``,
    ``buckets``, ``staging``, ...), so the leader's serving stack is the
    one-process stack with this object in the engine's seat. Every rank
    constructs it at the same time (the bootstrap and the barrier are
    collectives). See the module docstring for the protocol."""

    def __init__(self, engine, *, timeout_s: float = 60.0,
                 heartbeat_s: Optional[float] = None, registry=None,
                 exit_fn=os._exit):
        self.engine = engine
        self.group = engine.mesh_group
        self.process_index = int(engine.process_index)
        self.process_count = int(engine.process_count)
        self.is_leader = self.process_index == 0
        self.timeout_s = float(timeout_s)
        # the idle leader's keep-alive: well inside timeout_s, so a quiet
        # but healthy replica never trips a follower's watchdog
        self.heartbeat_s = (float(heartbeat_s) if heartbeat_s is not None
                            else max(0.5, self.timeout_s / 4.0))
        # a drain behind a wedged collective ends with the watchdog's
        # exit; close() waits past that bound, never for ever
        self.drain_timeout_s = 2.0 * self.timeout_s
        self.barrier_generation = 0
        self._seq = 0
        self._queue: queue_lib.Queue = queue_lib.Queue()
        self._lock = threading.Lock()  # the closed flag, the thread, _seq
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._obs = reg = registry
        self._c_dispatches = reg.counter("serve.mesh.dispatches") \
            if reg else None
        self._c_swaps = reg.counter("serve.mesh.swaps") if reg else None
        self._c_heartbeats = reg.counter("serve.mesh.heartbeats") \
            if reg else None
        self._h_broadcast = reg.histogram("serve.mesh.broadcast_ms") \
            if reg else None
        if reg is not None:
            reg.gauge("serve.mesh.processes").set(self.process_count)
            reg.gauge("serve.mesh.local_devices").set(len(engine.devices))
        self._exit_fn = exit_fn
        self._watchdog = _Watchdog(self.timeout_s, registry=registry,
                                   exit_fn=exit_fn)
        host = engine.weights_host()
        # a follower's swap placeholder: zeros at the raw avals (a tree
        # broadcast needs the same names, shapes and dtypes everywhere)
        self._weight_placeholder = {
            k: np.zeros(np.shape(v), np.asarray(v).dtype)
            for k, v in host.items()}
        if self.process_count > 1:
            # bootstrap: every rank serves the LEADER's weights, through
            # the same broadcast every later hot reload takes
            engine.swap_weights(broadcast_tree(
                host if self.is_leader else self._weight_placeholder,
                self.group))
        del host
        self.warmup_barrier()
        if self.process_count > 1:
            self._watchdog.start()
        if self.is_leader:
            with self._lock:
                self._thread = threading.Thread(
                    target=self._dispatch_loop, name="mesh-dispatch",
                    daemon=True)
                self._thread.start()
        else:
            # armed from here on: the leader heartbeats while idle, so a
            # silent leader for timeout_s is a gone leader
            self._watchdog.arm("waiting for the first leader command")

    # -- the warm-up barrier -------------------------------------------

    def warmup_barrier(self) -> None:
        """One collective probe a bucket before the replica may serve:
        every rank's slab of the bucket holds the same images (the probe
        batch of the slab's size, repeated once a rank), so every rank's
        logits must equal the leader's bit for bit. The bucket call blocks
        until every rank arrives, so no rank serves, or reports healthy,
        ahead of a straggler. A rank whose weights or kernels differ fails
        here, before the replica is healthy. Advances
        ``barrier_generation`` (in ``/healthz``)."""
        eng = self.engine  # warmed at construction
        for b in eng.buckets:
            slab = b // self.process_count
            probe = np.concatenate(
                [probe_batch(slab, eng.image_shape)] * self.process_count)
            got = eng._forward(probe)
            if self.process_count == 1:
                continue
            mine = got if not self.is_leader else got[:slab]
            full = broadcast_array(
                got if self.is_leader
                else np.zeros((b, *got.shape[1:]), got.dtype), self.group)
            ranks = full.reshape(self.process_count, slab, *got.shape[1:])
            bad = [r for r in range(self.process_count)
                   if not np.array_equal(ranks[r], ranks[0])]
            if bad or not np.array_equal(mine, ranks[0]):
                raise MeshReplicaError(
                    f"rank {self.process_index}: ranks "
                    f"{bad or [self.process_index]} diverge from the "
                    f"leader at bucket {b} during the warm-up barrier: "
                    "this replica must not serve")
        self.barrier_generation += 1
        if self._obs is not None:
            self._obs.gauge("serve.mesh.barrier_generation").set(
                self.barrier_generation)
        trace.instant("serve/mesh_barrier",
                      generation=self.barrier_generation,
                      processes=self.process_count)

    # -- the engine's surface (leader) ---------------------------------

    def predict(self, images: np.ndarray) -> np.ndarray:
        """uint8 NHWC batch of any size -> fp32 logits, computed by every
        rank of the replica. Leader only: followers mirror it in
        :meth:`follower_loop`."""
        if not self.is_leader:
            raise MeshReplicaError(
                "predict() is leader-only; followers run follower_loop()")
        # fault hook BEFORE anything is broadcast: an injected engine
        # failure fails only this batch and never desyncs the protocol
        faults.maybe_raise("serve_error")
        x = np.asarray(images)
        if x.ndim != 4 or x.shape[1:] != self.engine.image_shape:
            raise ValueError(
                f"expected (n, "
                f"{', '.join(map(str, self.engine.image_shape))}) images, "
                f"got {x.shape}")
        return self._submit(OP_BATCH, x).result()

    def swap_weights(self, state_dict) -> int:
        """Swap every rank's weights to ``state_dict``: checked on THIS
        thread (a wrong model is refused before any broadcast), then the
        dispatch loop broadcasts it and every rank swaps the same
        generation in lock-step. Returns the new version."""
        self.engine.check_swap_avals(state_dict)
        return self._submit(OP_SWAP, state_dict).result()

    def weights_host(self) -> dict:
        return self.engine.weights_host()

    def bucket_for(self, n: int) -> int:
        return self.engine.bucket_for(n)

    def shard_split(self, n: int):
        return self.engine.shard_split(n)

    def mesh_health(self) -> dict:
        """The topology block ``/healthz`` shows, so a half-joined replica
        can be told from a probe: the process span, the devices, the
        barrier generation."""
        return {
            **self.engine.topology(),
            "barrier_generation": int(self.barrier_generation),
            "timeout_s": self.timeout_s,
            "engine_version": int(self.engine.version),
        }

    # the rest of the engine surface the batcher, the backend, the watcher
    # and the CLI read, delegated
    @property
    def buckets(self):
        return self.engine.buckets

    @property
    def n_devices(self) -> int:
        return self.engine.n_devices

    @property
    def staging(self):
        return self.engine.staging

    @property
    def model_name(self) -> str:
        return self.engine.model_name

    @property
    def num_classes(self) -> int:
        return self.engine.num_classes

    @property
    def image_shape(self):
        return self.engine.image_shape

    @property
    def compile_count(self) -> int:
        return self.engine.compile_count

    @property
    def version(self) -> int:
        return self.engine.version

    @property
    def aot_cache_hits(self) -> int:
        return self.engine.aot_cache_hits

    @property
    def aot_cache_misses(self) -> int:
        return self.engine.aot_cache_misses

    @property
    def cold_start_s(self) -> float:
        return self.engine.cold_start_s

    @property
    def checkpoint_meta(self) -> dict:
        return self.engine.checkpoint_meta

    # -- leader dispatch -----------------------------------------------

    def _fatal(self, why: str) -> None:
        """A collective RAISED with peers attached (failure mode (b)): the
        ranks are out of step, so this process leaves the fleet rather
        than serve as a zombie, with the watchdog's exit code."""
        log.error(
            "mesh replica: collective failed (%s) — the ranks are "
            "desynced; exiting rc=%d so the router evicts this logical "
            "replica instead of flapping on a zombie", why, PEER_TIMEOUT_RC)
        if self._obs is not None:
            self._obs.counter("serve.mesh.peer_timeouts").inc()
        self._exit_fn(PEER_TIMEOUT_RC)

    def _submit(self, op: int, payload) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise MeshReplicaClosed("mesh replica is shut down")
            self._queue.put((op, payload, fut))
        return fut

    def _cmd(self, op: int, n: int) -> np.ndarray:
        with self._lock:
            self._seq += 1
            seq = self._seq
        return np.asarray([op, n, seq, 0], np.int64)

    def _send(self, arr: np.ndarray) -> np.ndarray:
        return broadcast_array(arr, self.group)

    def _dispatch_loop(self) -> None:
        """The one collective initiator: drains the work queue in FIFO
        order, broadcasting each item to the followers and entering the
        bucket call with them; heartbeats when idle, so a follower's
        watchdog can tell a quiet leader from a dead one. Every collective
        is bracketed by the watchdog."""
        multi = self.process_count > 1
        while True:
            try:
                op, payload, fut = self._queue.get(timeout=self.heartbeat_s)
            except queue_lib.Empty:
                if multi:
                    try:
                        self._watchdog.arm("heartbeat broadcast")
                        self._send(self._cmd(OP_HEARTBEAT, 0))
                        self._watchdog.disarm()
                    except Exception as e:
                        self._watchdog.disarm()
                        self._fatal(f"heartbeat broadcast: {e}")
                        return  # an injected exit_fn does not exit
                    if self._c_heartbeats is not None:
                        self._c_heartbeats.inc()
                continue
            if op == OP_SHUTDOWN:
                try:
                    if multi:
                        self._watchdog.arm("shutdown broadcast")
                        self._send(self._cmd(OP_SHUTDOWN, 0))
                    self._watchdog.disarm()
                except Exception as e:  # peers already gone: still done
                    self._watchdog.disarm()
                    log.warning("shutdown broadcast failed: %s", e)
                fut.set_result(None)
                return
            if op == OP_SWAP:
                try:
                    self._watchdog.arm("weight-swap broadcast")
                    if multi:
                        self._send(self._cmd(OP_SWAP, 0))
                        payload = broadcast_tree(payload, self.group)
                    version = self.engine.swap_weights(payload)
                    self._watchdog.disarm()
                    if self._c_swaps is not None:
                        self._c_swaps.inc()
                    fut.set_result(version)
                except Exception as e:
                    self._watchdog.disarm()
                    fut.set_exception(e)
                    if multi:  # the followers may have swapped already
                        self._fatal(f"swap broadcast: {e}")
                        return
                continue
            # OP_BATCH: chunked through the largest bucket, as predict
            # chunks: a command, the chunk's bytes and the bucket call each
            try:
                x = payload
                cap = self.engine.buckets[-1]
                outs = []
                for off in range(0, x.shape[0], cap):
                    chunk = np.ascontiguousarray(x[off:off + cap])
                    self._watchdog.arm(
                        f"batch broadcast+execute (n={chunk.shape[0]})")
                    t0 = time.perf_counter()
                    if multi:
                        self._send(self._cmd(OP_BATCH, chunk.shape[0]))
                        chunk = self._send(chunk)
                        if self._h_broadcast is not None:
                            self._h_broadcast.observe(
                                (time.perf_counter() - t0) * 1e3)
                    outs.append(self.engine._run_bucket(chunk))
                    self._watchdog.disarm()
                if self._c_dispatches is not None:
                    self._c_dispatches.inc()
                fut.set_result(outs[0] if len(outs) == 1
                               else np.concatenate(outs))
            except Exception as e:
                self._watchdog.disarm()
                fut.set_exception(e)
                if multi:
                    # a broadcast or the bucket's gather failed with peers
                    # attached (predict's fault hook runs before submit)
                    self._fatal(f"batch dispatch: {e}")
                    return

    # -- follower ------------------------------------------------------

    def follower_loop(self) -> None:
        """Run on a follower's MAIN thread until the leader broadcasts
        shutdown: block on the next command and mirror it (the bucket
        call, the swap, or nothing for a heartbeat). The watchdog is
        re-armed on every command, so a leader that dies takes this
        process down within ``timeout_s``."""
        if self.is_leader:
            raise MeshReplicaError("follower_loop() is follower-only")
        try:
            self._follower_loop_body(self.engine)
        except Exception as e:  # failure mode (b): out of step, terminal
            self._watchdog.disarm()
            self._fatal(f"follower collective: {e}")
        finally:
            self._watchdog.disarm()
            self._watchdog.stop()
            with self._lock:
                self._closed = True

    def _follower_loop_body(self, eng) -> None:
        while True:
            self._watchdog.arm("waiting for the next leader command")
            cmd = self._send(np.zeros(_CMD_LEN, np.int64))
            op, n = int(cmd[0]), int(cmd[1])
            if op == OP_HEARTBEAT:
                if self._c_heartbeats is not None:
                    self._c_heartbeats.inc()
                continue
            if op == OP_SHUTDOWN:
                return
            if op == OP_SWAP:
                eng.swap_weights(broadcast_tree(self._weight_placeholder,
                                                self.group))
                if self._c_swaps is not None:
                    self._c_swaps.inc()
                continue
            if op == OP_BATCH:
                eng._run_bucket(self._send(
                    np.zeros((n, *eng.image_shape), np.uint8)))
                if self._c_dispatches is not None:
                    self._c_dispatches.inc()
                continue
            raise MeshReplicaError(
                f"unknown mesh command op={op} (protocol skew?)")

    # -- life cycle ----------------------------------------------------

    def close(self) -> None:
        """Leader: finish the queue's tail, broadcast shutdown (the
        followers' loops return), join the dispatch thread, stop the
        watchdog. Idempotent; a follower's close is a local flag (its loop
        ends on the leader's broadcast)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if not self.is_leader:
            return
        fut: Future = Future()
        self._queue.put((OP_SHUTDOWN, None, fut))
        try:
            fut.result(timeout=self.drain_timeout_s)
        except Exception:  # the watchdog ends a wedged process
            log.warning("mesh replica shutdown broadcast did not confirm")
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join(timeout=self.drain_timeout_s)
        self._watchdog.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
