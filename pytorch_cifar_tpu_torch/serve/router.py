"""Multi-replica router: spread traffic over N replica engines.

A copy of ``pytorch_cifar_tpu/serve/router.py`` for the port, without the
fleet controller's membership calls (``add_replica``/``remove_replica``/
``fleet_view``: not ported yet). One replica process = one card = one
:class:`~pytorch_cifar_tpu_torch.serve.frontend.ServingFrontend`. The
router is the fleet edge above them — a plain process (it never touches
a device; replicas own theirs) that implements the same
``predict``/``health`` backend protocol the frontend serves, so the SAME
HTTP frontend binds in front of it and clients cannot tell one replica
from a fleet. Responsibilities:

- **Least-loaded dispatch**: each request goes to the healthy replica
  with the fewest router-side in-flight requests, round-robin on ties —
  the closed-loop-friendly greedy policy (in-flight count IS queue
  depth + device occupancy as observed from here, no replica cooperation
  needed, and a slow replica sheds load automatically because its
  requests finish later).
- **Health probes + eviction**: a background thread polls every
  replica's ``/healthz``; ``fail_after`` consecutive failures (probe or
  dispatch) evict the replica from rotation. Probes keep running against
  evicted replicas, and one success reinstates — a restarted replica
  rejoins with no operator action.
- **Hedging**: a request that dies with the replica (connection error,
  5xx) or times out against its deadline (504) is retried ONCE on a
  DIFFERENT replica — the cross-replica half of the retry/hedging item
  (the loadgen's same-queue retry was the first half). In-flight loss on
  a SIGKILLed replica is therefore bounded: hedged or failed-with-error,
  never hung.
- **Priority-aware admission**: an interactive request rejected by one
  replica's admission control (429) tries a second replica — transient
  per-replica queue pressure should not bounce a user. A bulk 429 is
  returned immediately: bulk backpressure must propagate to the bulk
  client, not consume a second replica's bulk budget (the fleet-level
  complement of the batcher's lane cap).

Wire protocol: the binary frame (``serve/wire.py``) — the request is
encoded ONCE into a buffered frame whose
raw bytes are replayed in full on every attempt (a hedge or a
stale-connection retry resends the complete frame from the buffer, never
a half-consumed stream), and the response is the replica's raw float32
logit bytes — so the bytes a client receives through the router are
bit-identical to the replica's answer whatever encoding the CLIENT
spoke (the frontend decodes client JSON or binary into the same array
this router re-frames).
"""

from __future__ import annotations

import http.client
import json
import logging
import socket
import threading
import time
from typing import Optional, Sequence
from urllib.parse import urlsplit

import numpy as np

from pytorch_cifar_tpu_torch.obs import MetricsRegistry
from pytorch_cifar_tpu_torch.serve import wire
from pytorch_cifar_tpu_torch.serve.batcher import (
    BatcherClosed,
    DeadlineExceeded,
    QueueFull,
)
from pytorch_cifar_tpu_torch.serve.tenancy import UnknownModel

log = logging.getLogger(__name__)


class ReplicaError(RuntimeError):
    """A replica-side failure the router may hedge: connection refused /
    reset (replica death) or a 5xx that is not a deadline."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


class Replica:
    """One backend endpoint: HTTP client (per-thread persistent
    connections — dispatch runs on the frontend's many handler threads)
    plus the router-visible dispatch state. The STATE is owned by the
    Router and only mutated under the router's lock; this class only
    owns the sockets."""

    def __init__(self, url: str, *, timeout_s: float = 30.0, pool=None):
        parts = urlsplit(url if "//" in url else f"http://{url}")
        if parts.scheme != "http" or not parts.hostname:
            raise ValueError(f"replica url must be http://host:port: {url!r}")
        self.url = f"http://{parts.hostname}:{parts.port or 80}"
        self.host = parts.hostname
        self.tcp_port = int(parts.port or 80)
        self.timeout_s = float(timeout_s)
        # event transport (edge.EdgePool): when set, exchanges go
        # through the shared non-blocking pool instead of a per-thread
        # http.client connection — same (status, payload) contract, and
        # the pool owns the stale-keep-alive retry
        self._pool = pool
        self._local = threading.local()
        # dispatch state — mutated ONLY under Router._lock
        self.healthy = True
        self.in_flight = 0
        self.consecutive_failures = 0
        self.last_health: dict = {}
        self.dispatched = 0

    def _conn(self, fresh: bool = False) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        # a conn whose sock is gone (closed by us after a failure, or a
        # connect() that raised before the cache slot was replaced) must
        # be rebuilt, not reused — reusing it crashes on .sock access
        if conn is None or fresh or conn.sock is None:
            if conn is not None:
                conn.close()
            self._local.conn = None  # a failing connect leaves no stale cache
            conn = http.client.HTTPConnection(
                self.host, self.tcp_port, timeout=self.timeout_s
            )
            # TCP_NODELAY both ways (see frontend._Handler): without it
            # Nagle + delayed ACK adds a flat ~40 ms per exchange
            conn.connect()
            conn.sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
            self._local.conn = conn
        return conn

    def request(
        self,
        method: str,
        path: str,
        body: Optional[bytes] = None,
        timeout_s: Optional[float] = None,
        content_type: str = "application/json",
        raw: bool = False,
    ):
        """One HTTP exchange; returns ``(status, payload_dict)`` — or
        ``(status, payload_bytes)`` with ``raw=True`` and a 200 (error
        payloads are always JSON and decoded either way). ``body`` is a
        fully buffered bytes object, so a stale keep-alive connection
        (server idled it out) gets ONE transparent reconnect that
        resends the COMPLETE body — a binary frame is never replayed
        from a half-consumed stream."""
        if self._pool is not None:
            try:
                status, payload = self._pool.exchange(
                    self.host,
                    self.tcp_port,
                    method,
                    path,
                    body,
                    content_type=content_type,
                    timeout_s=(
                        timeout_s if timeout_s is not None else self.timeout_s
                    ),
                )
            except OSError as e:
                raise ReplicaError(f"{self.url}: {e}") from None
            if raw and status == 200:
                return status, payload
            try:
                obj = json.loads(payload.decode("utf-8")) if payload else {}
            except ValueError:
                obj = {"error": payload[:200].decode("utf-8", "replace")}
            return status, obj
        headers = {"Content-Type": content_type} if body else {}
        for attempt in (0, 1):
            conn = None
            try:
                conn = self._conn(fresh=attempt > 0)
                if timeout_s is not None:
                    conn.sock.settimeout(timeout_s)
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
                status = resp.status
            except (
                http.client.HTTPException,
                ConnectionError,
                TimeoutError,
                OSError,
            ) as e:
                if attempt == 0:
                    continue  # stale connection: reconnect once
                raise ReplicaError(
                    f"{self.url}: {type(e).__name__}: {e}"
                ) from None
            finally:
                if timeout_s is not None and conn is not None:
                    sock = getattr(conn, "sock", None)
                    if sock is not None:
                        sock.settimeout(self.timeout_s)
            if raw and status == 200:
                return status, payload
            try:
                obj = json.loads(payload.decode("utf-8")) if payload else {}
            except ValueError:
                obj = {"error": payload[:200].decode("utf-8", "replace")}
            return status, obj
        raise AssertionError("unreachable")

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


class Router:
    """The fleet backend (module docstring). Implements the frontend's
    backend protocol: ``predict`` raises the batcher exception types so
    the frontend's status-code mapping is identical for one replica or
    fifty. ``start()`` launches the health-probe thread; ``stop()``
    joins it.

    **Model-aware dispatch**: ``predict(..., model=...)`` rides the wire-v2 frame to the replica.
    Replica selection filters on each replica's last probed ``/healthz``
    ``models`` list when one is present (a zoo replica advertises its
    tenants), so a model is dispatched only to replicas that host it; a
    replica answering 404 anyway (stale health, mid-reconfig) raises
    :class:`~pytorch_cifar_tpu_torch.serve.tenancy.UnknownModel` — the
    frontend's 404, deterministic, never hedged (every replica of a
    homogeneous fleet would answer the same)."""

    # the frontend passes request model ids through to this backend
    supports_model_routing = True

    def __init__(
        self,
        replica_urls: Sequence[str],
        *,
        registry: Optional[MetricsRegistry] = None,
        probe_s: float = 0.5,
        fail_after: int = 2,
        hedge: bool = True,
        request_timeout_s: float = 60.0,
        probe_timeout_s: float = 2.0,
        transport: str = "threaded",
    ):
        if not replica_urls:
            raise ValueError("router needs at least one replica url")
        if transport not in ("threaded", "event"):
            raise ValueError(
                f"transport must be 'threaded' or 'event', got {transport!r}"
            )
        self.transport = transport
        # event transport: ONE shared non-blocking pool multiplexes every
        # replica's in-flight exchanges (edge.EdgePool) — dispatch,
        # hedging, eviction, and status classification are unchanged, only
        # the socket layer under Replica.request differs
        self._pool = None
        if transport == "event":
            from pytorch_cifar_tpu_torch.serve.edge import EdgePool

            self._pool = EdgePool(timeout_s=request_timeout_s).start()
        self.replicas = [
            Replica(u, timeout_s=request_timeout_s, pool=self._pool)
            for u in replica_urls
        ]
        self.probe_s = float(probe_s)
        self.fail_after = int(fail_after)
        self.hedge = bool(hedge)
        self.request_timeout_s = float(request_timeout_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.obs = registry if registry is not None else MetricsRegistry()
        self._c_requests = self.obs.counter("router.requests")
        self._c_images = self.obs.counter("router.images")
        self._c_hedged = self.obs.counter("router.hedged")
        self._c_failed = self.obs.counter("router.failed")
        self._c_rejected = self.obs.counter("router.rejected")
        self._c_evictions = self.obs.counter("router.evictions")
        self._c_reinstated = self.obs.counter("router.reinstated")
        self._c_replica_errors = self.obs.counter("router.replica_errors")
        self._g_inflight = self.obs.gauge("router.inflight")
        self._g_healthy = self.obs.gauge("router.healthy_replicas")
        self._h_latency = self.obs.histogram("router.latency_ms")
        # one lock over ALL replica dispatch state (healthy/in_flight/
        # failure counts): probe thread + every frontend handler thread
        # mutate it
        self._lock = threading.Lock()
        self._rr = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # canary shadow tee (serve/canary.py): when attached, every
        # answered request is OFFERED to the promotion controller, a
        # lock+append into its bounded queue, never a canary compute and
        # never an error on the client path
        self._shadow = None
        self._shadow_model = None  # tee only this model's traffic
        self._g_healthy.set(len(self.replicas))

    def attach_shadow(self, controller) -> None:
        """Tee answered requests to a canary
        :class:`~pytorch_cifar_tpu_torch.serve.canary.PromotionController`:
        ``offer(images, incumbent_logits, priority=...)`` is called with
        the request and the incumbent's answer (no second incumbent
        pass), off the client response path. ``None`` detaches. On a
        multi-model fleet only requests for the controller's own model
        are offered."""
        with self._lock:
            self._shadow = controller
            self._shadow_model = getattr(
                getattr(controller, "engine", None), "model_name", None
            )

    # -- replica selection + state transitions -------------------------

    def _pick_locked(self, exclude=(), model=None) -> Optional[Replica]:
        """Healthy replica with the fewest in-flight requests;
        round-robin breaks ties so equal-load replicas share work. With
        ``model``, replicas whose last probed health advertises a
        ``models`` list that does NOT contain it are skipped (zoo
        fleets may shard tenants across replicas); replicas with no
        model list yet (pre-first-probe) stay candidates — a wrong
        guess costs one 404-classified dispatch, not an outage."""
        candidates = [
            r for r in self.replicas if r.healthy and r not in exclude
        ]
        if model is not None:
            candidates = [
                r for r in candidates if self._hosts(r, model)
            ]
        if not candidates:
            return None
        low = min(r.in_flight for r in candidates)
        tied = [r for r in candidates if r.in_flight == low]
        self._rr += 1
        return tied[self._rr % len(tied)]

    @staticmethod
    def _hosts(replica: Replica, model: str) -> bool:
        """Does this replica host ``model``, per its last probed health?
        Zoo replicas advertise a ``models`` list; single-model replicas
        a scalar ``model``; a replica never probed yet stays a
        candidate (a wrong guess costs one 404-classified dispatch)."""
        h = replica.last_health
        if not h:
            return True
        models = h.get("models")
        if models:
            return model in models
        served = h.get("model")
        return served is None or served == model

    def _mark_failure(self, replica: Replica, why: str) -> None:
        self._c_replica_errors.inc()
        with self._lock:
            replica.consecutive_failures += 1
            evict = (
                replica.healthy
                and replica.consecutive_failures >= self.fail_after
            )
            if evict:
                replica.healthy = False
            healthy = sum(r.healthy for r in self.replicas)
        if evict:
            self._c_evictions.inc()
            self._g_healthy.set(healthy)
            log.warning(
                "evicted replica %s after %d consecutive failures (%s)",
                replica.url, replica.consecutive_failures, why,
            )

    def _mark_success(self, replica: Replica, health=None) -> None:
        with self._lock:
            replica.consecutive_failures = 0
            reinstated = not replica.healthy
            replica.healthy = True
            if health is not None:
                replica.last_health = health
            healthy = sum(r.healthy for r in self.replicas)
        if reinstated:
            self._c_reinstated.inc()
            self._g_healthy.set(healthy)
            log.info("reinstated replica %s", replica.url)

    # -- dispatch ------------------------------------------------------

    def _dispatch(self, replica: Replica, body: bytes, timeout_s: float):
        """One attempt against one replica. Returns logits; raises the
        classified failure (QueueFull / DeadlineExceeded / ReplicaError)
        for :meth:`predict` to route."""
        with self._lock:
            replica.in_flight += 1
            replica.dispatched += 1
            self._g_inflight.set(
                sum(r.in_flight for r in self.replicas)
            )
        try:
            status, resp = replica.request(
                "POST", "/predict", body, timeout_s=timeout_s,
                content_type=wire.CONTENT_TYPE, raw=True,
            )
        except ReplicaError as e:
            # connection refused/reset/timeout: the replica-death signal
            self._mark_failure(replica, str(e))
            raise
        finally:
            with self._lock:
                replica.in_flight -= 1
        if status == 200:
            try:
                logits, _version = wire.decode_response(resp)
            except wire.WireError as e:
                # a 200 carrying an undecodable frame is replica damage:
                # count the failure (eviction pressure) and let the
                # caller hedge the buffered frame to another replica
                self._mark_failure(replica, f"bad response frame: {e}")
                raise ReplicaError(
                    f"{replica.url}: undecodable response frame: {e}"
                ) from None
            self._mark_success(replica)
            return logits
        err = resp.get("error", f"http {status}")
        if status == 404:
            # routing miss, not replica damage: the model is not hosted
            # there (or anywhere, for a homogeneous fleet) — surface the
            # frontend's 404 deterministically, never hedge or evict
            raise UnknownModel(f"{replica.url}: {err}")
        if status == 429:
            # admission control, not replica damage: no failure mark
            raise QueueFull(f"{replica.url}: {err}")
        if status == 504:
            # the replica is alive, the request just missed its queue
            # deadline — hedge-worthy but not evict-worthy
            raise DeadlineExceeded(f"{replica.url}: {err}")
        self._mark_failure(replica, f"http {status}")
        raise ReplicaError(f"{replica.url}: http {status}: {err}", status)

    def predict(
        self,
        images: np.ndarray,
        deadline_ms: Optional[float] = None,
        priority: str = "interactive",
        model: Optional[str] = None,
    ) -> np.ndarray:
        """Route one request (module docstring: least-loaded dispatch,
        hedge-once on deadline/replica failure, priority-aware 429
        handling, model-aware candidate filtering). Raises the batcher
        exception types (plus UnknownModel for an unhosted model id) so
        callers — the frontend above all — need no router-specific
        error handling."""
        x = np.ascontiguousarray(np.asarray(images, dtype=np.uint8))
        # ONE buffered binary frame (serve/wire.py) per request: every
        # attempt — first dispatch, stale-connection retry, cross-replica
        # hedge — resends these exact bytes in full (a model id rides
        # the v2 frame field; no model = the v1 frame, byte-identical
        # to the pre-zoo router)
        body = wire.encode_request(
            x,
            deadline_ms=float(deadline_ms) if deadline_ms else None,
            priority=priority,
            model=model,
        )
        # per-attempt HTTP timeout: the deadline bounds queue time on the
        # replica; the wire timeout must outlive deadline + service time,
        # and never be shorter than the configured floor
        timeout_s = self.request_timeout_s
        if deadline_ms:
            timeout_s = max(timeout_s, deadline_ms / 1e3 + 30.0)
        self._c_requests.inc()
        t0 = time.perf_counter()
        attempted: list = []
        attempts = 2 if self.hedge and len(self.replicas) > 1 else 1
        last_exc: Optional[Exception] = None
        for attempt in range(attempts):
            with self._lock:
                replica = self._pick_locked(exclude=attempted, model=model)
            if replica is None:
                break  # nobody (left) to try
            attempted.append(replica)
            try:
                out = self._dispatch(replica, body, timeout_s)
                self._c_images.inc(int(x.shape[0]))
                self._h_latency.observe((time.perf_counter() - t0) * 1e3)
                with self._lock:
                    shadow = self._shadow
                    shadow_model = self._shadow_model
                if shadow is not None and model not in (None, shadow_model):
                    shadow = None  # another tenant's traffic: never teed
                if shadow is not None:
                    # fire-and-forget: offer() enqueues (or drops) and
                    # never raises; the client's bits and deadline are
                    # already settled in `out`
                    shadow.offer(x, out, priority=priority)
                return out
            except QueueFull as e:
                last_exc = e
                if priority == "bulk":
                    # bulk backpressure propagates to the bulk client
                    # instead of probing the rest of the fleet
                    self._c_rejected.inc()
                    raise
                continue  # interactive: try a less-pressured replica
            except (DeadlineExceeded, ReplicaError) as e:
                last_exc = e
                if attempt + 1 < attempts:
                    self._c_hedged.inc()
                continue
        self._c_failed.inc()
        if isinstance(last_exc, QueueFull):
            self._c_rejected.inc()
            raise last_exc
        if isinstance(last_exc, DeadlineExceeded):
            raise last_exc
        if last_exc is None:
            if model is not None:
                with self._lock:
                    healthy = [r for r in self.replicas if r.healthy]
                if healthy and not any(
                    self._hosts(r, model) for r in healthy
                ):
                    # healthy fleet, nobody hosts the model: the
                    # deterministic 404, not an availability error
                    raise UnknownModel(
                        f"router: no replica hosts model {model!r}"
                    )
            raise BatcherClosed("router: no healthy replica")
        # replica death on every attempt: unavailable, retry elsewhere
        raise BatcherClosed(f"router: {last_exc}")

    # -- health --------------------------------------------------------

    def probe_once(self) -> int:
        """One probe sweep (the probe thread's body; tests drive it
        directly for timing-free determinism). Returns the healthy
        count. Probes a snapshot of the membership."""
        with self._lock:
            replicas = list(self.replicas)
        for replica in replicas:
            try:
                status, health = replica.request(
                    "GET", "/healthz", timeout_s=self.probe_timeout_s
                )
            except ReplicaError as e:
                self._mark_failure(replica, str(e))
                continue
            if status == 200:
                self._mark_success(replica, health=health)
            else:
                self._mark_failure(replica, f"healthz http {status}")
        with self._lock:
            healthy = sum(r.healthy for r in self.replicas)
        self._g_healthy.set(healthy)
        return healthy

    def health(self) -> dict:
        """The router's own ``/healthz`` payload: fleet status + the
        per-replica view (dispatch state + each replica's last probed
        health, with the promotion generation surfaced top-level per
        replica so rollout progress reads off one scrape)."""
        with self._lock:
            replicas = [
                {
                    "url": r.url,
                    "healthy": r.healthy,
                    "in_flight": r.in_flight,
                    "dispatched": r.dispatched,
                    "consecutive_failures": r.consecutive_failures,
                    "generation": (r.last_health or {}).get(
                        "promotion_generation"
                    ),
                    "health": dict(r.last_health),
                }
                for r in self.replicas
            ]
            shadow = self._shadow
        healthy = sum(r["healthy"] for r in replicas)
        out = {
            "status": "ok" if healthy else "unavailable",
            "role": "router",
            "healthy_replicas": healthy,
            "replicas": replicas,
            "evictions": int(self._c_evictions.value),
            "reinstated": int(self._c_reinstated.value),
            "hedged": int(self._c_hedged.value),
        }
        if shadow is not None:
            out["canary"] = shadow.status()
        return out

    @property
    def stats(self) -> dict:
        return {
            "transport": self.transport,
            "requests": int(self._c_requests.value),
            "images": int(self._c_images.value),
            "hedged": int(self._c_hedged.value),
            "failed": int(self._c_failed.value),
            "rejected": int(self._c_rejected.value),
            "evictions": int(self._c_evictions.value),
            "reinstated": int(self._c_reinstated.value),
            "replica_errors": int(self._c_replica_errors.value),
        }

    # -- lifecycle -----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.probe_s):
            try:
                self.probe_once()
            except Exception:
                log.exception("health probe sweep failed")

    def start(self) -> "Router":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="router-probe", daemon=True
                )
                self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # take the handle under the lock, join OUTSIDE it (the probe
        # sweep takes the lock for state transitions)
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()
        for replica in self.replicas:
            replica.close()
        if self._pool is not None:
            self._pool.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
