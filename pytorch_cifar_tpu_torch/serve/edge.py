"""Event-loop edge: the non-blocking frontend + router I/O layer.

A copy of ``pytorch_cifar_tpu/serve/edge.py`` for the port: the same
protections, metric names and bytes on the wire.

The threaded edge (``serve/frontend.py``'s ``ThreadingHTTPServer``, the
router's thread-per-exchange ``Replica``) spends one OS thread per
connection. That is fine for drills and collapses at production
connection counts: 10k keep-alive clients would mean 10k stacks, 10k
scheduler entries, and a context switch per byte. This module is the
same edge rebuilt on readiness notification (stdlib ``selectors`` — the
zero-dependency stance holds): single-digit threads, any number of
sockets.

Two halves, one event-loop core:

- :class:`EdgeFrontend` — a drop-in replacement for
  :class:`~pytorch_cifar_tpu_torch.serve.frontend.ServingFrontend` (same
  constructor surface, same ``start()/stop()/url``, same routes, same
  error contract, same ``serve.http_*`` metrics) whose listener, HTTP
  parsing, and response writes all run on ONE non-blocking loop thread.
  Each connection is a small state machine (READ_HEAD -> READ_BODY ->
  DISPATCH -> WRITE): bytes arrive via ``recv_into`` a reused
  per-connection buffer, bodies accumulate into one exactly-sized
  ``bytearray`` (the PCTW frame's payload is then decoded as a zero-copy
  view over it), and responses leave through a memoryview write queue
  that survives partial ``send``s. The blocking work — request decode,
  ``backend.predict`` (micro-batcher or router), response encode — runs
  on a small off-loop worker pool; completions re-arm the loop through a
  wakeup pipe. Answers are bit-identical to the threaded frontend across
  both wire encodings (same decode/encode functions, same bytes).
- :class:`EdgePool` — the router's event transport: instead of
  one-thread-one-exchange through ``http.client``, every replica gets a
  non-blocking connection pool multiplexed on one shared loop. In-flight
  exchanges are request-id-tagged in the pool's pending table; caller
  threads block on a per-exchange event (the router's hedging, eviction,
  and status classification code is unchanged — it only ever sees
  ``(status, payload)`` or :class:`ReplicaError`-shaped failures).

**Edge protections** — enforced BEFORE a request costs allocation or a
worker:

- per-client token-bucket rate limiting (``rate_limit_rps``/
  ``rate_burst``, keyed by client IP): an over-budget request head is
  answered 429 and never decoded;
- slow-loris read deadlines (``read_deadline_s``): a connection that
  STARTS a request and then trickles it is closed at the deadline —
  idle keep-alive connections are unaffected;
- oversized-frame rejection from the header alone: a binary
  Content-Length beyond :func:`wire.max_request_bytes` (or any body
  beyond the JSON cap) is 400'd before the body is read, and a PCTW
  frame's ``n`` is checked the moment its 24 header bytes arrive —
  mid-body, before the payload accumulates;
- load-shed tiers wired to the priority lanes (``shed_pending`` /
  ``shed_pending_bulk``): when the dispatch backlog passes the bulk
  threshold, bulk-priority requests are shed with 429 while interactive
  traffic still flows; past the interactive threshold everything sheds.
  Priority is read from the frame flags (binary) or a cheap body scan
  (JSON) — no full decode on the shed path.

**Observability** (``serve.edge.*``): connections gauge,
accepts/closes/rate_limited/loris_closed/shed counters, and read/write-ms
histograms (first byte -> request complete; response queued -> flushed),
alongside the ``serve.http_*`` family the threaded frontend emits — the
serving CLI's ``--http_port`` report keeps its keys whichever edge
serves.

**Event-loop discipline**: no function reachable from a selectors
callback may block without a bound. Cross-thread traffic is a deque +
the wakeup pipe; the only lock the loop ever holds is a micro
critical-section around deque/dict ops (every holder is a handful of
bytecode ops, so the wait is bounded — nothing like an unbounded
``acquire()``); the loop never joins, never sleeps, and every socket is
``setblocking(False)``. Worker threads may block (that is their job) —
they are reachable only as ``Thread(target=...)`` entries, never called
from the loop.
"""

from __future__ import annotations

import collections
import errno
import json
import logging
import os
import queue
import selectors
import socket
import threading
import time
from typing import Optional, Tuple

import numpy as np

from pytorch_cifar_tpu_torch.obs import MetricsRegistry
from pytorch_cifar_tpu_torch.obs.export import prometheus_text
from pytorch_cifar_tpu_torch.serve import wire
from pytorch_cifar_tpu_torch.serve.batcher import (
    BatcherClosed,
    DeadlineExceeded,
    QueueFull,
    UnknownModel,
)
from pytorch_cifar_tpu_torch.serve.frontend import (
    MAX_IMAGES_PER_REQUEST,
    decode_predict_request,
    encode_predict_response,
)

log = logging.getLogger(__name__)

# connection read-buffer chunk: one recv_into per readiness event reads
# at most this much; a 64 KiB chunk keeps a 12 MiB binary frame under
# ~200 events without holding 64 KiB per IDLE connection (the chunk is
# loop-owned and shared — only one recv runs at a time on one loop)
_RECV_CHUNK = 64 * 1024

# JSON request bound: nested-list uint8 images cost up to 4 chars per
# byte; base64 4/3 — this cap covers the largest legal request in either
# JSON form with headroom, so an oversized Content-Length is rejected
# before the body is read whatever the encoding
_MAX_JSON_BODY = 64 * 1024 * 1024

_CRLF2 = b"\r\n\r\n"


class TokenBucket:
    """Per-client token bucket: ``rate`` tokens/s refill, ``burst``
    capacity. ``allow(key, now)`` spends one token or answers False.
    Loop-thread-only (no locking); stale clients are pruned so 10k
    one-shot clients do not grow the table forever."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self._state: dict = {}  # key -> [tokens, last_ts]

    def allow(self, key, now: float) -> bool:
        if self.rate <= 0:
            return True
        st = self._state.get(key)
        if st is None:
            st = self._state[key] = [self.burst, now]
        tokens = min(self.burst, st[0] + (now - st[1]) * self.rate)
        st[1] = now
        if tokens < 1.0:
            st[0] = tokens
            return False
        st[0] = tokens - 1.0
        if len(self._state) > 4096:
            self._prune(now)
        return True

    def _prune(self, now: float) -> None:
        full_by = self.burst / max(self.rate, 1e-9)
        dead = [
            k for k, st in self._state.items() if now - st[1] > full_by
        ]
        for k in dead:
            del self._state[k]


# connection states
_READ_HEAD = 0
_READ_BODY = 1
_BUSY = 2  # dispatched to a worker; response not yet queued
_CLOSED = 3


class _Conn:
    """One client connection's state machine (module docstring). Owned
    by the loop thread; workers only ever see the immutable request
    tuple and the connection's id."""

    __slots__ = (
        "sock", "cid", "addr", "state", "head", "body", "body_filled",
        "binary", "content_length", "keep_alive", "out", "close_after",
        "deadline", "t_first_byte", "t_write_start", "wire_checked",
        "priority_hint", "path", "method",
    )

    def __init__(self, sock, cid: int, addr):
        self.sock = sock
        self.cid = cid
        self.addr = addr
        self.state = _READ_HEAD
        self.head = bytearray()
        self.body: Optional[memoryview] = None  # over an exact bytearray
        self.body_filled = 0
        self.binary = False
        self.content_length = 0
        self.keep_alive = True
        self.out: collections.deque = collections.deque()  # memoryviews
        self.close_after = False
        self.deadline: Optional[float] = None  # slow-loris bound
        self.t_first_byte = 0.0
        self.t_write_start = 0.0
        self.wire_checked = False
        self.priority_hint = "interactive"
        self.path = ""
        self.method = ""


def _parse_head(head: bytes):
    """Minimal HTTP/1.1 request-head parse: (method, path, headers
    dict lower-cased) or raises ValueError."""
    try:
        text = head.decode("iso-8859-1")
    except UnicodeDecodeError as e:  # pragma: no cover - latin1 total
        raise ValueError(f"undecodable request head: {e}") from None
    lines = text.split("\r\n")
    parts = lines[0].split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise ValueError(f"malformed request line {lines[0]!r}")
    headers = {}
    for ln in lines[1:]:
        if not ln:
            continue
        name, sep, value = ln.partition(":")
        if not sep:
            raise ValueError(f"malformed header line {ln!r}")
        headers[name.strip().lower()] = value.strip()
    return parts[0], parts[1], headers


def _http_response(
    code: int, body: bytes, ctype: str, keep_alive: bool
) -> bytes:
    reason = {
        200: "OK", 400: "Bad Request", 404: "Not Found",
        405: "Method Not Allowed", 429: "Too Many Requests",
        500: "Internal Server Error", 503: "Service Unavailable",
        504: "Gateway Timeout",
    }.get(code, "Error")
    head = (
        f"HTTP/1.1 {code} {reason}\r\n"
        f"Server: pct-serve-edge\r\n"
        f"Content-Type: {ctype}\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n"
        "\r\n"
    ).encode("ascii")
    return head + body


class EdgeFrontend:
    """The event-loop HTTP frontend (module docstring). Same surface as
    :class:`~pytorch_cifar_tpu_torch.serve.frontend.ServingFrontend`; the
    extra knobs are the edge protections."""

    def __init__(
        self,
        backend,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        registry: Optional[MetricsRegistry] = None,
        image_shape: Tuple[int, int, int] = (32, 32, 3),
        workers: int = 4,
        rate_limit_rps: float = 0.0,
        rate_burst: float = 0.0,
        read_deadline_s: float = 10.0,
        shed_pending: int = 256,
        shed_pending_bulk: int = 64,
    ):
        self.backend = backend
        self.registry = registry if registry is not None else MetricsRegistry()
        self.image_shape = tuple(
            getattr(getattr(backend, "engine", None), "image_shape", None)
            or image_shape
        )
        self.read_deadline_s = float(read_deadline_s)
        self.shed_pending = int(shed_pending)
        self.shed_pending_bulk = int(shed_pending_bulk)
        self._bucket = TokenBucket(
            rate_limit_rps, rate_burst or max(rate_limit_rps, 1.0)
        )
        # the serve.http_* family the threaded frontend emits — report
        # assembly (the serving CLI) and dashboards see one edge, not two
        self.c_http_requests = self.registry.counter("serve.http_requests")
        self.c_http_images = self.registry.counter("serve.http_images")
        self.c_http_errors = self.registry.counter("serve.http_errors")
        self.h_http_ms = self.registry.histogram("serve.http_ms")
        self.c_wire_requests = self.registry.counter("serve.wire_requests")
        self.h_wire_decode = self.registry.histogram("serve.wire_decode_ms")
        # the serve.edge.* family
        self.g_connections = self.registry.gauge("serve.edge.connections")
        self.c_accepts = self.registry.counter("serve.edge.accepts")
        self.c_closes = self.registry.counter("serve.edge.closes")
        self.c_rate_limited = self.registry.counter("serve.edge.rate_limited")
        self.c_loris_closed = self.registry.counter("serve.edge.loris_closed")
        self.c_shed = self.registry.counter("serve.edge.shed")
        self.h_read_ms = self.registry.histogram("serve.edge.read_ms")
        self.h_write_ms = self.registry.histogram("serve.edge.write_ms")
        # model routing — identical resolution to ServingFrontend
        self.backend_routes_models = bool(
            getattr(backend, "supports_model_routing", False)
        )
        self.served_model = None
        b = backend
        for _ in range(4):
            eng = getattr(b, "engine", None)
            if eng is not None and hasattr(eng, "model_name"):
                self.served_model = eng.model_name
                break
            b = getattr(b, "backend", None)
            if b is None:
                break

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(1024)
        self._listener.setblocking(False)
        self.host, self.port = self._listener.getsockname()[:2]

        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        self._recv_buf = bytearray(_RECV_CHUNK)  # loop-owned, reused
        self._recv_view = memoryview(self._recv_buf)
        self._conns: dict = {}  # cid -> _Conn
        self._by_sock: dict = {}  # id(sock) -> _Conn (selector key map)
        self._next_cid = 0
        self._pending = 0  # dispatched-to-worker, not yet answered
        # cross-thread channels: deque append/popleft are GIL-atomic, so
        # loop callbacks touch them lock-free
        self._done: collections.deque = collections.deque()
        self._work_q: queue.Queue = queue.Queue()
        self._draining = False
        self._drain_deadline = 0.0
        self._n_workers = max(1, int(workers))
        # thread handles: mutated only by start()/stop() under _lock
        # (the loop takes it only around its table updates)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._workers: list = []

    # -- lifecycle -----------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def backend_version(self) -> int:
        return int(getattr(self.backend, "engine_version", 0))

    def start(self) -> "EdgeFrontend":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._sel.register(
                    self._listener, selectors.EVENT_READ, self._on_accept
                )
                self._sel.register(
                    self._wake_r, selectors.EVENT_READ, self._on_wakeup
                )
                self._workers = [
                    threading.Thread(
                        target=self._worker,
                        name=f"edge-worker-{i}:{self.port}",
                        daemon=False,
                    )
                    for i in range(self._n_workers)
                ]
                for t in self._workers:
                    t.start()
                self._thread = threading.Thread(
                    target=self._loop,
                    name=f"edge-loop:{self.port}",
                    daemon=False,
                )
                self._thread.start()
        return self

    def stop(self, drain_timeout_s: float = 30.0) -> None:
        """Graceful drain: stop accepting, let in-flight requests finish
        and their responses flush, close every connection, join the loop
        and the workers. Idempotent; after return no edge thread or fd
        survives (pinned by tests/test_torch_edge.py)."""
        with self._lock:
            t = self._thread
            workers = self._workers
            self._thread = None
            self._workers = []
        if t is None:
            return
        with self._lock:
            self._done.append(("drain", float(drain_timeout_s)))
        self._wake()
        t.join()
        for _ in workers:
            self._work_q.put(None)
        for w in workers:
            w.join()
        self._sel.close()
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _wake(self) -> None:
        try:
            os.write(self._wake_w, b"\x00")
        except (BlockingIOError, OSError):
            pass  # pipe full: the loop is already waking up

    # -- the loop ------------------------------------------------------

    def _loop(self) -> None:
        while True:
            timeout = self._next_timeout()
            try:
                events = self._sel.select(timeout)
            except OSError:  # pragma: no cover - selector torn down
                break
            for key, mask in events:
                callback = key.data
                try:
                    callback(key, mask)
                except Exception:
                    log.exception("edge loop callback failed")
            now = time.monotonic()
            self._expire_loris(now)
            if self._draining and self._drain_done(now):
                break
        self._teardown()

    def _next_timeout(self) -> float:
        timeout = 0.5
        now = time.monotonic()
        for conn in self._conns.values():
            if conn.deadline is not None:
                timeout = min(timeout, max(0.0, conn.deadline - now))
        if self._draining:
            timeout = min(timeout, 0.02)
        return timeout

    def _expire_loris(self, now: float) -> None:
        expired = [
            c for c in self._conns.values()
            if c.deadline is not None and now >= c.deadline
        ]
        for conn in expired:
            # a started-but-trickling request: the slow-loris shape —
            # close before it pins buffer + table space any longer
            self.c_loris_closed.inc()
            self._close_conn(conn)

    def _drain_done(self, now: float) -> bool:
        if now >= self._drain_deadline:
            return True
        busy = any(
            c.state == _BUSY or c.out for c in self._conns.values()
        )
        return not busy and self._pending == 0

    def _teardown(self) -> None:
        for conn in list(self._conns.values()):
            self._close_conn(conn)
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError, OSError):
            pass
        try:
            self._sel.unregister(self._wake_r)
        except (KeyError, ValueError, OSError):
            pass

    # -- loop callbacks (registered as selector data) -----------------

    def _on_accept(self, key, mask) -> None:
        # accept until the backlog is dry: one readiness event can cover
        # many queued connects under a flood
        while True:
            try:
                sock, addr = self._listener.accept()
            except BlockingIOError:
                return
            except OSError:
                return
            if self._draining:
                sock.close()
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
            except OSError:
                pass
            self._next_cid += 1
            conn = _Conn(sock, self._next_cid, addr)
            with self._lock:
                self._conns[conn.cid] = conn
                self._by_sock[id(sock)] = conn
            self._sel.register(
                sock, selectors.EVENT_READ, self._on_conn_event
            )
            self.c_accepts.inc()
            self.g_connections.set(len(self._conns))

    def _on_wakeup(self, key, mask) -> None:
        try:
            os.read(self._wake_r, 4096)
        except (BlockingIOError, OSError):
            pass
        while self._done:
            with self._lock:
                item = self._done.popleft()
            if item[0] == "drain":
                self._draining = True
                self._drain_deadline = time.monotonic() + item[1]
                try:
                    self._sel.unregister(self._listener)
                except (KeyError, ValueError, OSError):
                    pass
                self._listener.close()
                # idle keep-alive connections will never send again in
                # time we care about: close them now, keep busy ones
                for conn in list(self._conns.values()):
                    if conn.state == _READ_HEAD and not conn.out:
                        if not conn.head:
                            self._close_conn(conn)
                continue
            _tag, cid, payload = item
            self._pending -= 1
            conn = self._conns.get(cid)
            if conn is None:
                continue  # client hung up while the worker computed
            self._queue_response(conn, payload)

    def _on_conn_event(self, key, mask) -> None:
        conn = self._by_sock.get(id(key.fileobj))
        if conn is None:
            try:
                self._sel.unregister(key.fileobj)
            except (KeyError, ValueError, OSError):
                pass
            return
        if mask & selectors.EVENT_WRITE:
            self._on_writable(conn)
        if conn.state != _CLOSED and mask & selectors.EVENT_READ:
            self._on_readable(conn)

    # -- connection I/O (loop thread) ----------------------------------

    def _on_readable(self, conn: _Conn) -> None:
        try:
            n = conn.sock.recv_into(self._recv_view)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if n == 0:
            self._close_conn(conn)
            return
        if conn.state == _BUSY:
            # pipelined bytes ahead of the in-flight response: buffer
            # them in head; the parser resumes after the response flush
            conn.head += self._recv_view[:n]
            return
        self._feed(conn, self._recv_view[:n])

    def _feed(self, conn: _Conn, data) -> None:
        """Advance the state machine with freshly received bytes."""
        if conn.state == _CLOSED or conn.close_after:
            return  # the connection is on its way out; drop the bytes
        now = time.monotonic()
        if conn.state == _READ_HEAD:
            if not conn.head:
                conn.t_first_byte = now
                conn.deadline = now + self.read_deadline_s
            conn.head += data
            idx = conn.head.find(_CRLF2)
            if idx < 0:
                if len(conn.head) > 64 * 1024:
                    self._send_error(
                        conn, 400, "request head exceeds 64 KiB",
                        close=True,
                    )
                return
            head = bytes(conn.head[:idx])
            rest = conn.head[idx + 4:]
            conn.head = bytearray()
            if not self._begin_request(conn, head, now):
                return
            if conn.state == _READ_BODY and rest:
                self._feed_body(conn, rest)
            elif conn.state == _READ_HEAD and rest:
                self._feed(conn, rest)
            elif rest:
                conn.head += rest  # pipelined past a dispatched request
        elif conn.state == _READ_BODY:
            self._feed_body(conn, data)

    def _begin_request(self, conn: _Conn, head: bytes, now: float) -> bool:
        """Parse a complete request head; route GETs, arm a body read
        for POST /predict. Returns False when the connection died."""
        try:
            method, path, headers = _parse_head(head)
        except ValueError as e:
            self._send_error(conn, 400, str(e), close=True)
            return False
        conn.method, conn.path = method, path
        conn.keep_alive = (
            headers.get("connection", "keep-alive").lower() != "close"
        )
        self.c_http_requests.inc()
        if method == "GET":
            conn.deadline = None
            self._handle_get(conn, path)
            return conn.state != _CLOSED
        if method != "POST":
            self._send_error(conn, 405, f"unsupported method {method!r}")
            return conn.state != _CLOSED
        if path != "/predict":
            self._send_error(conn, 404, f"unknown path {path!r}")
            return conn.state != _CLOSED
        if self._draining:
            self._send_error(conn, 503, "frontend is draining")
            return conn.state != _CLOSED
        # protection 1: per-client rate limit — answered from the head,
        # before the body is read or a byte of it is allocated
        if not self._bucket.allow(conn.addr[0], now):
            self.c_rate_limited.inc()
            self._send_error(
                conn, 429,
                "rate limit exceeded for this client; back off and retry",
                drop_body=True,
            )
            return conn.state != _CLOSED
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            self._send_error(conn, 400, "bad Content-Length", close=True)
            return False
        if length <= 0:
            self._send_error(conn, 400, "missing request body")
            return conn.state != _CLOSED
        conn.binary = wire.is_binary_content_type(
            headers.get("content-type")
        )
        # protection 2: oversized rejection BEFORE the body is read —
        # the binary bound is exact (wire.max_request_bytes); the JSON
        # bound covers the largest legal request with headroom
        cap = (
            wire.max_request_bytes(self.image_shape, MAX_IMAGES_PER_REQUEST)
            if conn.binary
            else _MAX_JSON_BODY
        )
        if length > cap:
            self._send_error(
                conn, 400,
                (
                    f"binary frame of {length} bytes exceeds the "
                    f"{MAX_IMAGES_PER_REQUEST}-image request cap"
                    if conn.binary
                    else f"request body of {length} bytes exceeds the "
                    f"{cap}-byte cap"
                ),
                close=True,
            )
            return False
        conn.content_length = length
        conn.body = memoryview(bytearray(length))
        conn.body_filled = 0
        conn.wire_checked = False
        conn.state = _READ_BODY
        conn.deadline = now + self.read_deadline_s
        return True

    def _feed_body(self, conn: _Conn, data) -> None:
        take = min(len(data), conn.content_length - conn.body_filled)
        conn.body[conn.body_filled:conn.body_filled + take] = data[:take]
        conn.body_filled += take
        if (
            conn.binary
            and not conn.wire_checked
            and conn.body_filled >= wire.HEADER_SIZE
        ):
            # protection 2b: the PCTW header is in hand — reject a bad
            # n/shape NOW, mid-body, before the payload accumulates
            conn.wire_checked = True
            if not self._check_wire_header(conn):
                return
        if conn.body_filled < conn.content_length:
            return
        leftovers = bytes(data[take:]) if take < len(data) else b""
        self._complete_request(conn, leftovers)

    def _check_wire_header(self, conn: _Conn) -> bool:
        hdr = bytes(conn.body[:wire.HEADER_SIZE])
        try:
            magic, version, frame, dtype, flags, n, h, w, c = (
                wire._HEADER.unpack(hdr)
            )
        except Exception:
            self._send_error(conn, 400, "undecodable frame header",
                             close=True)
            return False
        if magic != wire.MAGIC:
            self._send_error(
                conn, 400,
                f"bad magic {magic!r} (expected {wire.MAGIC!r})",
                close=True,
            )
            return False
        if n > MAX_IMAGES_PER_REQUEST:
            self._send_error(
                conn, 400,
                f"frame carries {n} images; a single request is capped "
                f"at {MAX_IMAGES_PER_REQUEST}",
                close=True,
            )
            return False
        conn.priority_hint = (
            "bulk" if flags & wire.FLAG_BULK else "interactive"
        )
        return True

    def _complete_request(self, conn: _Conn, leftovers: bytes) -> None:
        self.h_read_ms.observe(
            (time.monotonic() - conn.t_first_byte) * 1e3
        )
        conn.deadline = None
        body = conn.body.obj if conn.body is not None else b""
        conn.body = None
        if not conn.binary:
            # cheap priority hint for the shed decision — a real decode
            # happens off-loop only if the request is admitted
            conn.priority_hint = (
                "bulk"
                if b'"priority"' in body and b'"bulk"' in body
                else "interactive"
            )
        if leftovers:
            conn.head += leftovers  # before any synchronous flush/resume
        # protection 3: load-shed tiers — bulk sheds first, interactive
        # holds on until the higher bound; both BEFORE a worker is spent
        backlog = self._pending
        if backlog >= self.shed_pending or (
            conn.priority_hint == "bulk"
            and backlog >= self.shed_pending_bulk
        ):
            self.c_shed.inc()
            # the body is fully consumed: rearm the parser BEFORE the
            # 429 is queued, or the next keep-alive request would land
            # in _feed_body against a None body
            conn.state = _READ_HEAD
            conn.content_length = 0
            conn.body_filled = 0
            self._send_error(
                conn, 429,
                f"edge shedding load ({backlog} requests pending)",
            )
        else:
            conn.state = _BUSY
            self._pending += 1
            t0 = time.monotonic()
            self._work_q.put_nowait(
                (conn.cid, bytes(body), conn.binary, conn.keep_alive, t0)
            )

    def _handle_get(self, conn: _Conn, path: str) -> None:
        # GET routes answer from worker threads too (health may call a
        # blocking backend), except /metrics which is a pure snapshot
        if path == "/metrics":
            body = prometheus_text(self.registry.snapshot()).encode()
            self._queue_response(
                conn,
                _http_response(
                    200, body, "text/plain; version=0.0.4",
                    conn.keep_alive,
                ),
            )
            return
        if path == "/healthz":
            conn.state = _BUSY
            self._pending += 1
            self._work_q.put_nowait(
                (conn.cid, None, False, conn.keep_alive, time.monotonic())
            )
            return
        if path == "/predict":
            self._send_error(conn, 405, "POST /predict (GET not supported)")
            return
        self._send_error(conn, 404, f"unknown path {path!r}")

    # -- responses (loop thread) ---------------------------------------

    def _send_error(
        self, conn: _Conn, code: int, message: str,
        close: bool = False, drop_body: bool = False,
    ) -> None:
        self.c_http_errors.inc()
        self.registry.counter(f"serve.http_{code}").inc()
        body = json.dumps({"error": message, "status": code}).encode()
        keep = conn.keep_alive and not close
        if drop_body:
            # rate-limited POST: the body is on the wire but unread; a
            # keep-alive parse would see it as the next request head, so
            # the connection closes after the 429 flushes
            keep = False
        conn.close_after = conn.close_after or not keep
        self._queue_response(
            conn, _http_response(code, body, "application/json", keep)
        )
        if close:
            conn.close_after = True

    def _queue_response(self, conn: _Conn, payload: bytes) -> None:
        if conn.state == _CLOSED:
            return
        # a response to a Connection: close request advertises close in
        # its header; the flush path must actually close the socket
        conn.close_after = conn.close_after or not conn.keep_alive
        if not conn.out:
            conn.t_write_start = time.monotonic()
        conn.out.append(memoryview(payload))
        if conn.state == _BUSY:
            conn.state = _READ_HEAD
        self._arm(conn)
        self._on_writable(conn)  # opportunistic: most flushes are one send

    def _arm(self, conn: _Conn) -> None:
        mask = selectors.EVENT_READ
        if conn.out:
            mask |= selectors.EVENT_WRITE
        try:
            self._sel.modify(conn.sock, mask, self._on_conn_event)
        except (KeyError, ValueError, OSError):
            pass

    def _on_writable(self, conn: _Conn) -> None:
        while conn.out:
            mv = conn.out[0]
            try:
                sent = conn.sock.send(mv)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close_conn(conn)
                return
            if sent < len(mv):
                conn.out[0] = mv[sent:]  # partial write: resume later
                break
            conn.out.popleft()
        if not conn.out:
            self.h_write_ms.observe(
                (time.monotonic() - conn.t_write_start) * 1e3
            )
            if conn.close_after or (self._draining and conn.state != _BUSY):
                self._close_conn(conn)
                return
            self._arm(conn)
            # response flushed: resume the parser over pipelined bytes
            if conn.state == _READ_HEAD and conn.head:
                buffered = bytes(conn.head)
                conn.head = bytearray()
                self._feed(conn, buffered)
        else:
            self._arm(conn)

    def _close_conn(self, conn: _Conn) -> None:
        if conn.state == _CLOSED:
            return
        conn.state = _CLOSED
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        with self._lock:
            self._conns.pop(conn.cid, None)
            self._by_sock.pop(id(conn.sock), None)
        conn.out.clear()
        self.c_closes.inc()
        self.g_connections.set(len(self._conns))

    # -- worker threads (may block; never loop-reachable) --------------

    def _worker(self) -> None:
        while True:
            item = self._work_q.get()
            if item is None:
                return
            cid, body, binary, keep_alive, t0 = item
            try:
                if body is None:
                    payload = self._do_health(keep_alive)
                else:
                    payload = self._do_predict(body, binary, keep_alive, t0)
            except Exception as e:  # a broken handler must not kill a worker
                log.exception("edge worker failed")
                payload = self._error_payload(
                    500, f"{type(e).__name__}: {e}", keep_alive
                )
            with self._lock:
                self._done.append(("done", cid, payload))
            self._wake()

    def _do_health(self, keep_alive: bool) -> bytes:
        try:
            health = self.backend.health()
        except Exception as e:
            health = {"status": "error", "error": str(e)}
        if self._draining:
            health = {**health, "status": "draining"}
        code = 200 if health.get("status") == "ok" else 503
        return _http_response(
            code, json.dumps(health).encode(), "application/json",
            keep_alive,
        )

    def _error_payload(
        self, code: int, message: str, keep_alive: bool
    ) -> bytes:
        self.c_http_errors.inc()
        self.registry.counter(f"serve.http_{code}").inc()
        body = json.dumps({"error": message, "status": code}).encode()
        return _http_response(code, body, "application/json", keep_alive)

    def _do_predict(
        self, body: bytes, binary: bool, keep_alive: bool, t0: float
    ) -> bytes:
        t_dec = time.perf_counter()
        try:
            if binary:
                x, deadline_ms, priority, json_resp, model = (
                    wire.decode_request(
                        body, self.image_shape, MAX_IMAGES_PER_REQUEST
                    )
                )
                encoding = "json" if json_resp else "binary"
                self.c_wire_requests.inc()
            else:
                x, deadline_ms, priority, encoding, model = (
                    decode_predict_request(body, self.image_shape)
                )
        except (wire.WireError, ValueError) as e:
            return self._error_payload(400, str(e), keep_alive)
        self.h_wire_decode.observe((time.perf_counter() - t_dec) * 1e3)
        if model is not None and not self.backend_routes_models:
            if model != self.served_model:
                return self._error_payload(
                    404,
                    f"model {model!r} is not served here "
                    f"(this replica serves {self.served_model!r})",
                    keep_alive,
                )
            model = None
        try:
            if model is not None:
                logits = self.backend.predict(
                    x, deadline_ms=deadline_ms, priority=priority,
                    model=model,
                )
            else:
                logits = self.backend.predict(
                    x, deadline_ms=deadline_ms, priority=priority
                )
        except UnknownModel as e:
            return self._error_payload(404, str(e), keep_alive)
        except QueueFull as e:
            return self._error_payload(429, str(e), keep_alive)
        except DeadlineExceeded as e:
            return self._error_payload(504, str(e), keep_alive)
        except BatcherClosed as e:
            return self._error_payload(503, str(e), keep_alive)
        except ValueError as e:
            return self._error_payload(400, str(e), keep_alive)
        except Exception as e:
            log.exception("backend failure")
            return self._error_payload(
                500, f"{type(e).__name__}: {e}", keep_alive
            )
        self.c_http_images.inc(int(x.shape[0]))
        self.h_http_ms.observe((time.monotonic() - t0) * 1e3)
        if encoding == "binary":
            return _http_response(
                200,
                wire.encode_response(logits, self.backend_version()),
                wire.CONTENT_TYPE,
                keep_alive,
            )
        return _http_response(
            200,
            json.dumps(
                encode_predict_response(
                    logits, encoding, self.backend_version()
                )
            ).encode(),
            "application/json",
            keep_alive,
        )


# ---------------------------------------------------------------------
# EdgePool: the router's event transport
# ---------------------------------------------------------------------


class _Exchange:
    """One in-flight request-id-tagged HTTP exchange: the caller thread
    blocks on ``event``; the loop fills ``status``/``payload`` or
    ``error`` and sets it."""

    __slots__ = (
        "xid", "host", "port", "request", "deadline", "event",
        "status", "payload", "error", "retried",
    )

    def __init__(self, xid, host, port, request: bytes, deadline: float):
        self.xid = xid
        self.host = host
        self.port = port
        self.request = request
        self.deadline = deadline
        self.event = threading.Event()
        self.status: Optional[int] = None
        self.payload: bytes = b""
        self.error: Optional[str] = None
        self.retried = False


_PC_CONNECTING = 0
_PC_WRITING = 1
_PC_READ_HEAD = 2
_PC_READ_BODY = 3
_PC_IDLE = 4


class _PoolConn:
    """One pooled replica connection: carries at most one exchange at a
    time (HTTP/1.1); the POOL multiplexes many of these per replica on
    one loop."""

    __slots__ = (
        "sock", "host", "port", "state", "ex", "out", "rbuf",
        "body", "body_filled", "content_length", "status", "reused",
    )

    def __init__(self, sock, host, port):
        self.sock = sock
        self.host = host
        self.port = port
        self.state = _PC_CONNECTING
        self.ex: Optional[_Exchange] = None
        self.out: collections.deque = collections.deque()
        self.rbuf = bytearray()
        self.body: Optional[memoryview] = None
        self.body_filled = 0
        self.content_length = 0
        self.status = 0
        self.reused = False


class EdgePool:
    """Non-blocking per-replica connection pools on one shared event
    loop (module docstring). ``exchange()`` is the blocking caller-side
    API — the frontend's worker threads and the router's probe thread
    call it exactly like ``Replica.request`` uses ``http.client`` — and
    everything socket-shaped happens on the loop thread."""

    def __init__(
        self,
        *,
        timeout_s: float = 60.0,
        max_conns_per_host: int = 64,
    ):
        self.timeout_s = float(timeout_s)
        self.max_conns_per_host = int(max_conns_per_host)
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        self._sel.register(
            self._wake_r, selectors.EVENT_READ, self._on_wakeup
        )
        self._submitted: collections.deque = collections.deque()
        self._pending: dict = {}  # xid -> _Exchange (the tag table)
        self._idle: dict = {}  # (host, port) -> [conns]
        self._conns: dict = {}  # id(sock) -> _PoolConn
        self._waiting: dict = {}  # (host, port) -> deque of exchanges
        self._next_xid = 0
        self._xid_lock = threading.Lock()
        self._stopping = False
        self._recv_buf = bytearray(_RECV_CHUNK)
        self._recv_view = memoryview(self._recv_buf)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "EdgePool":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="edge-pool", daemon=False
                )
                self._thread.start()
        return self

    def close(self) -> None:
        with self._lock:
            t = self._thread
            self._thread = None
        if t is None:
            return
        self._submitted.append(None)  # stop sentinel
        self._wake()
        t.join()
        self._sel.close()
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass

    def _wake(self) -> None:
        try:
            os.write(self._wake_w, b"\x00")
        except (BlockingIOError, OSError):
            pass

    # -- caller-side API (any thread; blocks on the exchange event) ----

    def exchange(
        self,
        host: str,
        port: int,
        method: str,
        path: str,
        body: Optional[bytes] = None,
        content_type: str = "application/json",
        timeout_s: Optional[float] = None,
    ) -> Tuple[int, bytes]:
        """One HTTP exchange through the pool; returns ``(status,
        payload)`` or raises ``OSError`` on connection failure/timeout
        (the Replica wrapper maps that to :class:`ReplicaError`)."""
        bound = self.timeout_s if timeout_s is None else float(timeout_s)
        blines = [
            f"{method} {path} HTTP/1.1",
            f"Host: {host}:{port}",
            "Connection: keep-alive",
        ]
        payload = body or b""
        if payload:
            blines.append(f"Content-Type: {content_type}")
        blines.append(f"Content-Length: {len(payload)}")
        request = "\r\n".join(blines).encode("ascii") + b"\r\n\r\n" + payload
        with self._xid_lock:
            self._next_xid += 1
            xid = self._next_xid
        ex = _Exchange(
            xid, host, int(port), request, time.monotonic() + bound
        )
        with self._lock:
            started = self._thread is not None
        if not started:
            raise OSError("edge pool is not running")
        self._submitted.append(ex)
        self._wake()
        if not ex.event.wait(bound + 5.0):
            ex.error = ex.error or f"exchange timeout after {bound}s"
        if ex.error is not None:
            raise OSError(ex.error)
        assert ex.status is not None
        return ex.status, ex.payload

    # -- loop ----------------------------------------------------------

    def _loop(self) -> None:
        while True:
            timeout = self._pool_timeout()
            try:
                events = self._sel.select(timeout)
            except OSError:  # pragma: no cover
                break
            for key, mask in events:
                callback = key.data
                try:
                    callback(key, mask)
                except Exception:
                    log.exception("edge pool callback failed")
            self._expire(time.monotonic())
            if self._stopping:
                break
        self._teardown()

    def _pool_timeout(self) -> float:
        timeout = 0.5
        now = time.monotonic()
        for ex in self._pending.values():
            timeout = min(timeout, max(0.0, ex.deadline - now))
        return timeout

    def _expire(self, now: float) -> None:
        expired = [
            ex for ex in self._pending.values() if now >= ex.deadline
        ]
        for ex in expired:
            conn = next(
                (c for c in self._conns.values() if c.ex is ex), None
            )
            if conn is not None:
                self._fail_conn(
                    conn, f"{ex.host}:{ex.port}: exchange timed out"
                )
            else:
                self._resolve(
                    ex, error=f"{ex.host}:{ex.port}: exchange timed out"
                )

    def _teardown(self) -> None:
        for conn in list(self._conns.values()):
            if conn.ex is not None:
                self._resolve(conn.ex, error="edge pool closed")
            self._drop_conn(conn)
        for dq in self._waiting.values():
            while dq:
                self._resolve(dq.popleft(), error="edge pool closed")
        for ex in list(self._pending.values()):
            self._resolve(ex, error="edge pool closed")

    def _resolve(
        self, ex: _Exchange, *, error: Optional[str] = None
    ) -> None:
        with self._lock:
            self._pending.pop(ex.xid, None)
        if error is not None and ex.error is None:
            ex.error = error
        ex.event.set()

    # -- loop callbacks ------------------------------------------------

    def _on_wakeup(self, key, mask) -> None:
        try:
            os.read(self._wake_r, 4096)
        except (BlockingIOError, OSError):
            pass
        while self._submitted:
            ex = self._submitted.popleft()
            if ex is None:
                self._stopping = True
                continue
            with self._lock:
                self._pending[ex.xid] = ex
            self._assign(ex)

    def _assign(self, ex: _Exchange) -> None:
        hp = (ex.host, ex.port)
        idle = self._idle.get(hp)
        while idle:
            conn = idle.pop()
            if id(conn.sock) in self._conns:
                self._start_exchange(conn, ex)
                return
        n_here = sum(
            1 for c in self._conns.values()
            if (c.host, c.port) == hp
        )
        if n_here >= self.max_conns_per_host:
            with self._lock:
                self._waiting.setdefault(hp, collections.deque()).append(ex)
            return
        try:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setblocking(False)
            try:
                sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
            except OSError:
                pass
            rc = sock.connect_ex((ex.host, ex.port))
        except OSError as e:
            self._resolve(ex, error=f"{ex.host}:{ex.port}: {e}")
            return
        if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            sock.close()
            self._resolve(
                ex,
                error=f"{ex.host}:{ex.port}: connect failed "
                f"({errno.errorcode.get(rc, rc)})",
            )
            return
        conn = _PoolConn(sock, ex.host, ex.port)
        conn.ex = ex
        conn.out.append(memoryview(ex.request))
        with self._lock:
            self._conns[id(sock)] = conn
        self._sel.register(
            sock,
            selectors.EVENT_READ | selectors.EVENT_WRITE,
            self._on_conn_event,
        )

    def _start_exchange(self, conn: _PoolConn, ex: _Exchange) -> None:
        conn.ex = ex
        conn.state = _PC_WRITING
        conn.reused = True
        conn.rbuf = bytearray()
        conn.status = 0
        conn.body = None
        conn.body_filled = 0
        conn.out.append(memoryview(ex.request))
        self._arm(conn)
        self._on_conn_writable(conn)

    def _arm(self, conn: _PoolConn) -> None:
        mask = selectors.EVENT_READ
        if conn.out:
            mask |= selectors.EVENT_WRITE
        try:
            self._sel.modify(conn.sock, mask, self._on_conn_event)
        except (KeyError, ValueError, OSError):
            pass

    def _on_conn_event(self, key, mask) -> None:
        conn = self._conns.get(id(key.fileobj))
        if conn is None:
            try:
                self._sel.unregister(key.fileobj)
            except (KeyError, ValueError, OSError):
                pass
            return
        if mask & selectors.EVENT_WRITE:
            if conn.state == _PC_CONNECTING:
                err = conn.sock.getsockopt(
                    socket.SOL_SOCKET, socket.SO_ERROR
                )
                if err != 0:
                    self._fail_conn(
                        conn,
                        f"{conn.host}:{conn.port}: connect failed "
                        f"({errno.errorcode.get(err, err)})",
                    )
                    return
                conn.state = _PC_WRITING
            self._on_conn_writable(conn)
        if id(conn.sock) in self._conns and mask & selectors.EVENT_READ:
            self._on_conn_readable(conn)

    def _on_conn_writable(self, conn: _PoolConn) -> None:
        while conn.out:
            mv = conn.out[0]
            try:
                sent = conn.sock.send(mv)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as e:
                self._fail_conn(conn, f"{conn.host}:{conn.port}: {e}")
                return
            if sent < len(mv):
                conn.out[0] = mv[sent:]
                break
            conn.out.popleft()
        if not conn.out and conn.state == _PC_WRITING:
            conn.state = _PC_READ_HEAD
        self._arm(conn)

    def _on_conn_readable(self, conn: _PoolConn) -> None:
        try:
            n = conn.sock.recv_into(self._recv_view)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            self._fail_conn(conn, f"{conn.host}:{conn.port}: {e}")
            return
        if n == 0:
            # server closed: a stale keep-alive conn that died before
            # any response byte gets ONE transparent retry on a fresh
            # connection (same contract as Replica's reconnect)
            self._fail_conn(
                conn, f"{conn.host}:{conn.port}: connection closed"
            )
            return
        data = self._recv_view[:n]
        if conn.state == _PC_READ_HEAD:
            conn.rbuf += data
            idx = conn.rbuf.find(_CRLF2)
            if idx < 0:
                return
            head = bytes(conn.rbuf[:idx])
            rest = conn.rbuf[idx + 4:]
            conn.rbuf = bytearray()
            try:
                status, length = self._parse_response_head(head)
            except ValueError as e:
                self._fail_conn(conn, f"{conn.host}:{conn.port}: {e}")
                return
            conn.status = status
            conn.content_length = length
            conn.body = memoryview(bytearray(length))
            conn.body_filled = 0
            conn.state = _PC_READ_BODY
            if rest:
                self._pool_feed_body(conn, rest)
            elif length == 0:
                self._finish_exchange(conn)
        elif conn.state == _PC_READ_BODY:
            self._pool_feed_body(conn, data)

    @staticmethod
    def _parse_response_head(head: bytes) -> Tuple[int, int]:
        lines = head.decode("iso-8859-1").split("\r\n")
        parts = lines[0].split(None, 2)
        if len(parts) < 2 or not parts[0].startswith("HTTP/1."):
            raise ValueError(f"malformed status line {lines[0]!r}")
        status = int(parts[1])
        length = 0
        for ln in lines[1:]:
            name, _, value = ln.partition(":")
            if name.strip().lower() == "content-length":
                length = int(value.strip())
        return status, length

    def _pool_feed_body(self, conn: _PoolConn, data) -> None:
        take = min(len(data), conn.content_length - conn.body_filled)
        conn.body[conn.body_filled:conn.body_filled + take] = data[:take]
        conn.body_filled += take
        if conn.body_filled >= conn.content_length:
            self._finish_exchange(conn)

    def _finish_exchange(self, conn: _PoolConn) -> None:
        ex = conn.ex
        conn.ex = None
        conn.state = _PC_IDLE
        conn.reused = True
        if ex is not None and ex.xid in self._pending:
            ex.status = conn.status
            ex.payload = bytes(conn.body.obj) if conn.body else b""
            self._resolve(ex)
        conn.body = None
        hp = (conn.host, conn.port)
        nxt = self._next_waiting(hp)
        if nxt is not None:
            self._start_exchange(conn, nxt)
        else:
            self._idle.setdefault(hp, []).append(conn)
            self._arm(conn)

    def _next_waiting(self, hp) -> Optional[_Exchange]:
        waiting = self._waiting.get(hp)
        while waiting:
            ex = waiting.popleft()
            if ex.xid in self._pending:  # skip already-timed-out waiters
                return ex
        return None

    def _fail_conn(self, conn: _PoolConn, why: str) -> None:
        ex = conn.ex
        conn.ex = None
        self._drop_conn(conn)
        if ex is None or ex.xid not in self._pending:
            return
        no_response_bytes = (
            conn.status == 0 and not conn.rbuf and conn.body_filled == 0
        )
        if (
            conn.reused and no_response_bytes and not ex.retried
            and time.monotonic() < ex.deadline
        ):
            # stale keep-alive: retry ONCE on a fresh connection with
            # the complete buffered request (never a half-consumed one)
            # — but only while the caller is still waiting; a retry of
            # an expired exchange just burns replica capacity
            ex.retried = True
            self._assign(ex)
            return
        self._resolve(ex, error=why)

    def _drop_conn(self, conn: _PoolConn) -> None:
        with self._lock:
            self._conns.pop(id(conn.sock), None)
        hp = (conn.host, conn.port)
        idle = self._idle.get(hp)
        if idle and conn in idle:
            idle.remove(conn)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        # capacity freed: a waiting exchange may now open a fresh conn
        nxt = self._next_waiting(hp)
        if nxt is not None:
            self._assign(nxt)
