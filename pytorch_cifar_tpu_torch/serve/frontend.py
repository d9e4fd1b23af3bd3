"""HTTP serving frontend: the production traffic path over the batcher.

A copy of ``pytorch_cifar_tpu/serve/frontend.py`` for the port: the same
routes, encodings, status codes and metric names, over the port's
batcher and engine. Stdlib-only (``http.server``), because the serving
path must not grow a web-framework dependency for three routes:

- ``POST /predict`` — a JSON body carrying a uint8 NHWC image batch
  (base64-packed bytes + ``shape``, or nested lists), optional
  ``deadline_ms`` and ``priority`` (``interactive``/``bulk``, the
  batcher's lanes), optional ``encoding: "b64"`` for a packed float32
  response — OR, with ``Content-Type: application/octet-stream``, the
  zero-copy binary frame (``serve/wire.py``): a 24-byte header plus the
  batch's raw bytes, decoded into a NumPy view with no JSON parse and no
  base64, answered with a raw float32 logits frame (or JSON, when the
  frame's flag asks). All encodings return logits bit-identical to an
  in-process ``engine.predict`` of the same rows (JSON floats round-trip
  float32 exactly through float64 repr; the binary frame is the float32
  bytes themselves). Malformed frames — truncated, bad
  magic/version/dtype, header/payload length mismatch, oversized ``n`` —
  are 400s with a JSON error body naming the defect, never 500s or
  hangs; an oversized Content-Length is rejected before the body is even
  read.
- ``GET /healthz`` — engine + checkpoint generation: model, engine
  weight version (bumped by every weight swap), checkpoint epoch,
  compile/AOT-cache counts, queue stats. 200 while serving, 503 once
  draining — the signal a router's health probe keys on.
- ``GET /metrics`` — LIVE Prometheus text rendered from the shared obs
  registry on every scrape (``--prom_out`` writes one dump at exit; a
  real scraper polls this route).

Error mapping is part of the API contract (clients decide retry policy
from the status code alone):

- 400 malformed request (bad JSON, bad shape/dtype, unknown priority),
- 404 / 405 unknown route / method,
- 404 :class:`~pytorch_cifar_tpu_torch.serve.tenancy.UnknownModel` — a
  well-formed request naming a model this backend does not serve,
- 429 :class:`~pytorch_cifar_tpu_torch.serve.batcher.QueueFull` —
  admission control said back off and retry,
- 503 :class:`~pytorch_cifar_tpu_torch.serve.batcher.BatcherClosed` (or
  a router with no healthy replica) — not retryable HERE, retryable
  elsewhere,
- 504 :class:`~pytorch_cifar_tpu_torch.serve.batcher.DeadlineExceeded` —
  the queue-time bound passed; the router hedges these to a second
  replica,
- 500 any other backend failure.

**Graceful drain, no thread leak**: ``stop()`` closes the listener (no
new connections), lets every in-flight handler finish its response,
closes idle keep-alive connections (their handler threads are blocked in
``readline``; closing the socket unblocks them), then joins the accept
loop AND every handler thread (``block_on_close`` + non-daemon handler
threads) — after ``stop()`` returns, no frontend thread exists
(pinned by tests/test_torch_frontend.py).

The handler is backend-agnostic: anything with ``predict(images,
deadline_ms=..., priority=...)`` + ``health()`` serves — a
:class:`BatcherBackend` (one replica: engine + micro-batcher) or a
:class:`~pytorch_cifar_tpu_torch.serve.router.Router` (the fleet edge),
so one frontend implementation is both the replica's data plane and the
router's.
"""

from __future__ import annotations

import base64
import binascii
import json
import logging
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from pytorch_cifar_tpu_torch.obs import MetricsRegistry
from pytorch_cifar_tpu_torch.obs.export import prometheus_text
from pytorch_cifar_tpu_torch.serve import wire
from pytorch_cifar_tpu_torch.serve.batcher import (
    PRIORITIES,
    BatcherClosed,
    DeadlineExceeded,
    QueueFull,
)
from pytorch_cifar_tpu_torch.serve.tenancy import UnknownModel

log = logging.getLogger(__name__)

# request bound: admission control belongs to the batcher, but a frontend
# must cap the DECODE cost it will pay before the batcher ever sees the
# request (a 10^9-image JSON body would OOM the handler, not the queue)
MAX_IMAGES_PER_REQUEST = 4096


def decode_predict_request(
    body: bytes, image_shape: Tuple[int, int, int]
) -> Tuple[np.ndarray, Optional[float], str, str, Optional[str]]:
    """Parse a ``/predict`` JSON body into ``(images, deadline_ms,
    priority, encoding, model)``. ``model`` (optional) is the tenant id
    of a multi-model zoo backend; None routes to the server's default
    model. Raises
    ``ValueError`` on ANY malformed input — the handler maps that to
    400 with the message as the response body, so a client sees WHY its
    request was rejected (an unknown-but-well-formed model name is NOT
    malformed: the backend raises UnknownModel and the handler answers
    404)."""
    try:
        req = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ValueError(f"body is not valid JSON: {e}") from None
    if not isinstance(req, dict):
        raise ValueError("body must be a JSON object")
    if "images" not in req:
        raise ValueError("missing required field 'images'")
    images = req["images"]
    if isinstance(images, str):
        # packed form: base64 of C-order uint8 bytes + explicit shape
        shape = req.get("shape")
        if (
            not isinstance(shape, (list, tuple))
            or len(shape) != 4
            or not all(isinstance(v, int) and v > 0 for v in shape)
        ):
            raise ValueError(
                "base64 'images' needs 'shape' as [n, h, w, c] positive "
                "ints"
            )
        try:
            raw = base64.b64decode(images, validate=True)
        except (binascii.Error, ValueError) as e:
            raise ValueError(f"'images' is not valid base64: {e}") from None
        n = int(shape[0])
        if tuple(shape[1:]) != tuple(image_shape):
            raise ValueError(
                f"shape {list(shape)} does not match the served image "
                f"shape (n, {', '.join(map(str, image_shape))})"
            )
        expect = n * int(np.prod(image_shape))
        if len(raw) != expect:
            raise ValueError(
                f"'images' payload is {len(raw)} bytes, shape "
                f"{list(shape)} needs {expect}"
            )
        x = np.frombuffer(raw, dtype=np.uint8).reshape(shape)
    elif isinstance(images, list):
        try:
            x = np.asarray(images, dtype=np.uint8)
        except (TypeError, ValueError, OverflowError) as e:
            raise ValueError(
                f"'images' nested list is not a uint8 array: {e}"
            ) from None
        if x.ndim != 4 or x.shape[1:] != tuple(image_shape):
            raise ValueError(
                f"'images' has shape {list(x.shape)}, expected "
                f"(n, {', '.join(map(str, image_shape))})"
            )
    else:
        raise ValueError("'images' must be a base64 string or nested list")
    if x.shape[0] > MAX_IMAGES_PER_REQUEST:
        raise ValueError(
            f"request carries {x.shape[0]} images; the frontend caps a "
            f"single request at {MAX_IMAGES_PER_REQUEST}"
        )
    deadline_ms = req.get("deadline_ms")
    if deadline_ms is not None:
        if not isinstance(deadline_ms, (int, float)) or deadline_ms < 0:
            raise ValueError("'deadline_ms' must be a non-negative number")
        deadline_ms = float(deadline_ms)
    priority = req.get("priority", "interactive")
    if priority not in PRIORITIES:
        raise ValueError(
            f"unknown priority {priority!r} (expected one of {PRIORITIES})"
        )
    encoding = req.get("encoding", "json")
    if encoding not in ("json", "b64"):
        raise ValueError("'encoding' must be 'json' or 'b64'")
    model = req.get("model")
    if model is not None and (not isinstance(model, str) or not model):
        raise ValueError("'model' must be a non-empty string when present")
    return x, deadline_ms, priority, encoding, model


def encode_predict_response(
    logits: np.ndarray, encoding: str, engine_version: int
) -> dict:
    """Response body for one answered ``/predict``. ``json`` encoding
    emits logits as float lists (float32 -> float64 repr is exact, so
    the wire is bit-transparent); ``b64`` packs the float32 bytes."""
    logits = np.asarray(logits, dtype=np.float32)
    labels = [int(v) for v in np.argmax(logits, axis=-1)]
    out = {
        "n": int(logits.shape[0]),
        "labels": labels,
        "engine_version": int(engine_version),
    }
    if encoding == "b64":
        out["logits_b64"] = base64.b64encode(
            np.ascontiguousarray(logits).tobytes()
        ).decode("ascii")
        out["shape"] = list(logits.shape)
        out["dtype"] = "float32"
    else:
        out["logits"] = [[float(v) for v in row] for row in logits]
    return out


def decode_logits(resp: dict) -> np.ndarray:
    """Client-side inverse of :func:`encode_predict_response` (both
    encodings). Shared by the router, the HTTP loadgen, and tests so
    every consumer decodes the wire format identically."""
    if "logits_b64" in resp:
        raw = base64.b64decode(resp["logits_b64"])
        return np.frombuffer(raw, dtype=np.float32).reshape(resp["shape"])
    return np.asarray(resp["logits"], dtype=np.float32)


class BatcherBackend:
    """One replica's backend: requests go through the micro-batcher
    (priority lanes, deadlines, admission control) and health reads the
    engine + optional hot-reload watcher."""

    def __init__(self, engine, batcher, watcher=None):
        self.engine = engine
        self.batcher = batcher
        self.watcher = watcher

    def predict(
        self,
        images: np.ndarray,
        deadline_ms: Optional[float] = None,
        priority: str = "interactive",
    ) -> np.ndarray:
        return self.batcher.submit(images, deadline_ms, priority).result()

    @property
    def engine_version(self) -> int:
        return int(self.engine.version)

    def health(self) -> dict:
        eng = self.engine
        meta = getattr(eng, "checkpoint_meta", {}) or {}
        if self.watcher is not None and self.watcher.last_meta:
            # a hot reload swapped in a newer publish: its sidecar meta
            # (epoch, best_acc, and the promotion stamp when the canary
            # published it) is what this replica serves now
            meta = self.watcher.last_meta
        # promotion generation (serve/canary.py): stamped into the live
        # sidecar by every canary promotion; None on a pre-pipeline dir
        promo = meta.get("promotion") or {}
        out = {
            "status": "ok",
            "role": "replica",
            "model": eng.model_name,
            "engine_version": int(eng.version),
            "ckpt_epoch": meta.get("epoch"),
            "best_acc": meta.get("best_acc"),
            "promotion_generation": promo.get("generation"),
            "compiles": int(eng.compile_count),
            "aot_cache_hits": int(eng.aot_cache_hits),
            "cold_start_s": round(float(eng.cold_start_s), 3),
            "buckets": [int(b) for b in eng.buckets],
            "n_devices": int(getattr(eng, "n_devices", 1)),
            "queued": self.batcher.stats["queued"],
        }
        if self.watcher is not None:
            out["reloads"] = self.watcher.reloads
            out["reload_skipped"] = self.watcher.skipped
            out["reload_quarantined"] = self.watcher.quarantined
        return out


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer that tracks its handler connections so a
    drain can close IDLE keep-alive sockets (whose handler threads sit
    in readline and would otherwise outlive the server) while letting
    busy handlers finish their in-flight response. Handler threads are
    non-daemon and joined by ``server_close`` (``block_on_close``), so
    shutdown is a real join, not an abandon."""

    daemon_threads = False
    block_on_close = True
    allow_reuse_address = True

    def __init__(self, addr, frontend):
        self.frontend = frontend
        # connection -> busy flag; guards itself with _track_lock (the
        # handler threads and stop() both touch it)
        self._track_lock = threading.Lock()
        self._tracked: dict = {}
        self._draining = False
        super().__init__(addr, _Handler)

    def track(self, handler, busy: bool) -> bool:
        """Record ``handler``'s busy state; returns the draining flag so
        a handler finishing its response under drain closes its
        keep-alive connection instead of waiting for traffic that will
        never come."""
        with self._track_lock:
            self._tracked[handler] = busy
            return self._draining

    def untrack(self, handler) -> None:
        with self._track_lock:
            self._tracked.pop(handler, None)

    def begin_drain(self) -> None:
        """Stop keep-alive: close every IDLE connection (unblocking its
        reader thread) and flag draining so busy handlers close theirs
        after the in-flight response."""
        with self._track_lock:
            self._draining = True
            idle = [h for h, busy in self._tracked.items() if not busy]
        for h in idle:
            try:
                h.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closing on its own

    def handle_error(self, request, client_address):
        # a client hanging up mid-request (or drain closing an idle
        # socket mid-readline) is routine, not a stack trace on stderr
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
            log.debug("connection error from %s: %s", client_address, exc)
            return
        super().handle_error(request, client_address)


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 keep-alive: closed-loop clients reuse one TCP connection
    # per thread — without it, connect cost dominates every latency
    # percentile the loadgen reports
    protocol_version = "HTTP/1.1"
    server_version = "pct-serve"
    # TCP_NODELAY: a small JSON response sits in Nagle's buffer waiting
    # for the client's delayed ACK otherwise — a flat +40 ms on every
    # request-response pair (measured; the clients set it too)
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # stderr per request is not a log
        log.debug("%s %s", self.address_string(), fmt % args)

    def setup(self):
        super().setup()
        self.server.track(self, busy=False)

    def finish(self):
        self.server.untrack(self)
        super().finish()

    # -- plumbing ------------------------------------------------------

    def _send_json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str, ctype: str) -> None:
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_bytes(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str) -> None:
        fe = self.server.frontend
        fe.c_http_errors.inc()
        fe.registry.counter(f"serve.http_{code}").inc()
        self._send_json(code, {"error": message, "status": code})

    # -- routes --------------------------------------------------------

    def do_GET(self):
        fe = self.server.frontend
        draining = self.server.track(self, busy=True)
        try:
            fe.c_http_requests.inc()
            if self.path == "/healthz":
                try:
                    health = fe.backend.health()
                except Exception as e:  # a broken backend is still a 503
                    health = {"status": "error", "error": str(e)}
                if draining:
                    health = {**health, "status": "draining"}
                code = 200 if health.get("status") == "ok" else 503
                self._send_json(code, health)
            elif self.path == "/metrics":
                # LIVE scrape: rendered from the shared registry NOW
                self._send_text(
                    200,
                    prometheus_text(fe.registry.snapshot()),
                    "text/plain; version=0.0.4",
                )
            elif self.path == "/predict":
                self._error(405, "POST /predict (GET not supported)")
            else:
                self._error(404, f"unknown path {self.path!r}")
        finally:
            if self.server.track(self, busy=False):
                self.close_connection = True

    def do_POST(self):
        fe = self.server.frontend
        draining = self.server.track(self, busy=True)
        t0 = time.perf_counter()
        try:
            fe.c_http_requests.inc()
            if self.path != "/predict":
                self._error(404, f"unknown path {self.path!r}")
                return
            if draining:
                self._error(503, "frontend is draining")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._error(400, "bad Content-Length")
                return
            if length <= 0:
                self._error(400, "missing request body")
                return
            binary = wire.is_binary_content_type(
                self.headers.get("Content-Type")
            )
            if binary and length > wire.max_request_bytes(
                fe.image_shape, MAX_IMAGES_PER_REQUEST
            ):
                # oversized n rejected from the Content-Length alone —
                # before the body costs a read, let alone a decode
                self._error(
                    400,
                    f"binary frame of {length} bytes exceeds the "
                    f"{MAX_IMAGES_PER_REQUEST}-image request cap",
                )
                return
            body = self.rfile.read(length)
            t_dec = time.perf_counter()
            try:
                if binary:
                    x, deadline_ms, priority, json_resp, model = (
                        wire.decode_request(
                            body, fe.image_shape, MAX_IMAGES_PER_REQUEST
                        )
                    )
                    encoding = "json" if json_resp else "binary"
                    fe.c_wire_requests.inc()
                else:
                    x, deadline_ms, priority, encoding, model = (
                        decode_predict_request(body, fe.image_shape)
                    )
            except (wire.WireError, ValueError) as e:
                self._error(400, str(e))
                return
            fe.h_wire_decode.observe((time.perf_counter() - t_dec) * 1e3)
            # model routing: a routing backend (zoo server, router)
            # takes the id as a
            # kwarg; a single-model replica accepts its OWN model name
            # and 404s any other — unknown model is a routing miss, not
            # a malformed request
            if model is not None and not fe.backend_routes_models:
                if model != fe.served_model:
                    self._error(
                        404,
                        f"model {model!r} is not served here "
                        f"(this replica serves {fe.served_model!r})",
                    )
                    return
                model = None  # satisfied: call the single-model surface
            try:
                if model is not None:
                    logits = fe.backend.predict(
                        x, deadline_ms=deadline_ms, priority=priority,
                        model=model,
                    )
                else:
                    logits = fe.backend.predict(
                        x, deadline_ms=deadline_ms, priority=priority
                    )
            except UnknownModel as e:
                self._error(404, str(e))
                return
            except QueueFull as e:
                self._error(429, str(e))
                return
            except DeadlineExceeded as e:
                self._error(504, str(e))
                return
            except BatcherClosed as e:
                self._error(503, str(e))
                return
            except ValueError as e:
                self._error(400, str(e))
                return
            except Exception as e:
                log.exception("backend failure")
                self._error(500, f"{type(e).__name__}: {e}")
                return
            fe.c_http_images.inc(int(x.shape[0]))
            fe.h_http_ms.observe((time.perf_counter() - t0) * 1e3)
            if encoding == "binary":
                self._send_bytes(
                    200,
                    wire.encode_response(logits, fe.backend_version()),
                    wire.CONTENT_TYPE,
                )
            else:
                self._send_json(
                    200,
                    encode_predict_response(
                        logits, encoding, fe.backend_version()
                    ),
                )
        finally:
            if self.server.track(self, busy=False):
                self.close_connection = True


class ServingFrontend:
    """The HTTP listener: ``start()`` binds and serves on a background
    accept thread (ThreadingHTTPServer: one handler thread per
    connection); ``stop()`` drains gracefully (module docstring). Port 0
    binds an ephemeral port — read the real one from :attr:`port` /
    :attr:`url` (the serving CLI prints it, tests read it)."""

    def __init__(
        self,
        backend,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        registry: Optional[MetricsRegistry] = None,
        image_shape: Tuple[int, int, int] = (32, 32, 3),
    ):
        self.backend = backend
        self.registry = registry if registry is not None else MetricsRegistry()
        self.image_shape = tuple(
            getattr(getattr(backend, "engine", None), "image_shape", None)
            or image_shape
        )
        self.c_http_requests = self.registry.counter("serve.http_requests")
        self.c_http_images = self.registry.counter("serve.http_images")
        self.c_http_errors = self.registry.counter("serve.http_errors")
        self.h_http_ms = self.registry.histogram("serve.http_ms")
        # wire-path observability: binary-frame request count and the
        # request decode cost (both encodings — the number the binary
        # format exists to shrink)
        self.c_wire_requests = self.registry.counter("serve.wire_requests")
        self.h_wire_decode = self.registry.histogram("serve.wire_decode_ms")
        # model routing: a zoo server / router declares routing support
        # and takes the request's model id as a predict kwarg; for a
        # single-model backend, resolve the one name it serves (walking
        # wrapper backends, each holding the next as ``backend``) so a
        # request naming it explicitly still succeeds and anything else
        # is a clean 404
        self.backend_routes_models = bool(
            getattr(backend, "supports_model_routing", False)
        )
        self.served_model = None
        b = backend
        for _ in range(4):  # backend wrappers nest at most a few deep
            eng = getattr(b, "engine", None)
            if eng is not None and hasattr(eng, "model_name"):
                self.served_model = eng.model_name
                break
            b = getattr(b, "backend", None)
            if b is None:
                break
        self._server = _Server((host, int(port)), self)
        self.host, self.port = self._server.server_address[:2]
        # accept-loop thread handle: shared with stop(), hence the lock
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def backend_version(self) -> int:
        return int(getattr(self.backend, "engine_version", 0))

    def start(self) -> "ServingFrontend":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._server.serve_forever,
                    kwargs={"poll_interval": 0.05},
                    name=f"http-frontend:{self.port}",
                    daemon=False,
                )
                self._thread.start()
        return self

    def stop(self) -> None:
        """Graceful drain: stop accepting, finish in-flight responses,
        close idle keep-alives, join the accept loop and every handler
        thread. Idempotent."""
        self._server.shutdown()  # accept loop exits (no new connections)
        self._server.begin_drain()  # idle sockets closed, busy flagged
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()
        # joins every remaining handler thread (block_on_close) — after
        # this, no frontend thread exists
        self._server.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
