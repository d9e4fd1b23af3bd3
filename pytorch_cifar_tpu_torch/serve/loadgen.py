"""Synthetic closed-loop load generator + latency statistics.

A copy of ``pytorch_cifar_tpu/serve/loadgen.py`` for the port: the same
protocol, report keys and per-client draws (a seed gives the same request
sizes and pixels in both packages).

Closed-loop: each simulated client submits one request, BLOCKS on its
result, then immediately submits the next — so offered load adapts to
service capacity (``clients`` bounds the in-flight requests) and the
latency distribution is the one a real synchronous client would see.
``QueueFull`` rejections are counted and retried after a short backoff,
exercising the admission-control path rather than hiding it.

Deadline hedging: a request that
fails with ``DeadlineExceeded`` (its queue-time bound passed during an
engine stall or a deep backlog) is resubmitted ONCE — the fresh submit
re-enters the queue at the tail with a fresh deadline, which is exactly
what a real frontend would do before surfacing the error to the client.
Hedges are counted (``hedged``, and the ``serve.hedged`` obs counter);
a request whose hedge also fails is counted in ``failed`` instead of
crashing the client loop. The retry wait is part of the client-observed
latency, like the QueueFull backoff.

Shared by the serving CLI and ``chip_smoke.py`` so the reported
p50/p95/p99 and img/s always mean the same protocol.

**HTTP client mode**: ``run_load`` drives anything with the batcher's
``submit`` surface — :class:`HttpTarget` wraps a frontend/router URL in
exactly that surface (one persistent HTTP/1.1 connection per client
thread; 429/504/503 map back to ``QueueFull``/``DeadlineExceeded``/
``BatcherClosed``), so a run through the wire reports the SAME
closed-loop stats and hedge counters through the full network path that
the in-process numbers mean. ``wire=`` picks the request encoding per
target — JSON, the zero-copy binary frame, or a mixed fleet of both.

**Mixed-priority load**: ``bulk_fraction`` tags that share of requests
``priority="bulk"`` (per-client deterministic rng), exercising the
batcher's lanes and the router's priority-aware admission under one
closed loop.

**Heavy-tailed multi-model load**: ``model_mix={name: weight, ...}``
makes each request name a
model drawn from that distribution (per-client deterministic rng) —
:func:`zipf_mix` builds the production-shaped heavy tail from the zoo's
model list, optionally ordered by the zoo sweep's throughput priors.
The id rides the JSON ``model`` field or the wire-v2 frame field
(``HttpTarget``); the report grows a ``per_model`` request-count block.
"""

from __future__ import annotations

import base64
import http.client
import json
import socket
import threading
import time
from typing import Optional
from urllib.parse import urlsplit

import numpy as np

from pytorch_cifar_tpu_torch.serve import wire as wire_mod
from pytorch_cifar_tpu_torch.serve.batcher import (
    BatcherClosed,
    DeadlineExceeded,
    QueueFull,
)
from pytorch_cifar_tpu_torch.serve.frontend import decode_logits
from pytorch_cifar_tpu_torch.serve.tenancy import UnknownModel


class _Resolved:
    """Future-compatible wrapper over an already-computed result: the
    HTTP exchange is synchronous, so by the time ``submit`` returns the
    answer exists — ``result()`` just hands it over. Keeps ``run_load``'s
    ``submit(...).result()`` protocol identical for both transports."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def result(self, timeout=None):
        return self._value


class HttpTarget:
    """A frontend/router URL exposed through the batcher's ``submit``
    surface (module docstring). Thread-safe: each loadgen client thread
    gets its own persistent HTTP/1.1 connection (``threading.local``),
    reconnecting transparently when the server idles one out.

    ``wire`` picks the request encoding: ``"json"`` (the base64-packed
    JSON protocol), ``"binary"`` (the zero-copy frame of
    ``serve/wire.py`` — raw bytes both ways), or ``"mixed"`` (each client
    thread alternates encodings per request: one fleet, heterogeneous
    clients).

    Error mapping is the frontend contract in reverse: 429 raises
    :class:`QueueFull` (the client backs off and retries), 504 raises
    :class:`DeadlineExceeded` (the client hedges once), 503 and
    connection failures raise :class:`BatcherClosed` (counted failed).
    """

    def __init__(
        self,
        url: str,
        *,
        deadline_ms: Optional[float] = None,
        timeout_s: float = 60.0,
        wire: str = "json",
    ):
        parts = urlsplit(url if "//" in url else f"http://{url}")
        if parts.scheme != "http" or not parts.hostname:
            raise ValueError(f"target url must be http://host:port: {url!r}")
        if wire not in ("json", "binary", "mixed"):
            raise ValueError(
                f"wire must be 'json', 'binary', or 'mixed': {wire!r}"
            )
        self.host = parts.hostname
        self.tcp_port = int(parts.port or 80)
        self.url = f"http://{self.host}:{self.tcp_port}"
        self.deadline_ms = deadline_ms
        self.timeout_s = float(timeout_s)
        self.wire = wire
        self._local = threading.local()
        self.obs = None  # loadgen's optional registry hook (run_load)

    def _conn(self, fresh: bool = False) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        # a conn whose sock is gone (closed after a failure, or a
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

    def submit(
        self,
        images: np.ndarray,
        deadline_ms: Optional[float] = None,
        priority: str = "interactive",
        model: Optional[str] = None,
    ) -> _Resolved:
        """One synchronous ``POST /predict``; returns a resolved future
        of the fp32 logits (b64-packed JSON or a raw binary frame on the
        wire, per ``wire``: bit-identical to the server's array either
        way). ``model`` names a zoo tenant (JSON ``model`` field /
        wire-v2 frame field); an unhosted model's 404 raises
        :class:`~pytorch_cifar_tpu_torch.serve.tenancy.UnknownModel`."""
        x = np.ascontiguousarray(np.asarray(images, dtype=np.uint8))
        if deadline_ms is None:
            deadline_ms = self.deadline_ms
        binary = self.wire == "binary"
        if self.wire == "mixed":
            # per-thread alternation: deterministic, no coordination
            seq = getattr(self._local, "seq", 0)
            self._local.seq = seq + 1
            binary = seq % 2 == 0
        body, ctype = _encode_predict_body(
            x, deadline_ms, priority, model, binary
        )
        for attempt in (0, 1):
            try:
                conn = self._conn(fresh=attempt > 0)
                conn.request(
                    "POST", "/predict", body=body,
                    headers={"Content-Type": ctype},
                )
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
                    continue  # stale keep-alive: reconnect once
                raise BatcherClosed(
                    f"{self.url}: {type(e).__name__}: {e}"
                ) from None
            break
        if status == 200:
            if binary:
                logits, _version = wire_mod.decode_response(payload)
                return _Resolved(logits)
            return _Resolved(decode_logits(json.loads(payload)))
        try:
            err = json.loads(payload).get("error", "")
        except ValueError:
            err = payload[:200].decode("utf-8", "replace")
        if status == 404:
            raise UnknownModel(f"{self.url}: {err}")
        if status == 429:
            raise QueueFull(f"{self.url}: {err}")
        if status == 504:
            raise DeadlineExceeded(f"{self.url}: {err}")
        raise BatcherClosed(f"{self.url}: http {status}: {err}")

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


def zipf_mix(models, s: float = 1.2, priors=None) -> dict:
    """Heavy-tailed per-model traffic weights: weight(rank) = 1/rank^s,
    the classic production shape (a few hot models, a long cold tail).
    With ``priors`` ({model: img/s} — the zoo sweep's cost priors), rank
    order is cheapest-first so the HOT models are the cheap ones (the
    realistic case: the expensive tail still forces placement churn);
    without priors the given order is the rank order."""
    models = list(models)
    if priors:
        models.sort(key=lambda m: -float(priors.get(m, 0.0)))
    weights = {
        m: 1.0 / float(rank + 1) ** s for rank, m in enumerate(models)
    }
    total = sum(weights.values())
    return {m: w / total for m, w in weights.items()}


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
    images_min: int = 1,
    images_max: int = 8,
    image_shape=(32, 32, 3),
    seed: int = 0,
    retry_backoff_s: float = 0.002,
    duration_s: Optional[float] = None,
    hedge: bool = True,
    bulk_fraction: float = 0.0,
    model_mix: Optional[dict] = None,
) -> dict:
    """Drive ``batcher`` with ``clients`` synchronous synthetic clients.

    Each request carries a uniform-random 1..images_max image batch (the
    realistic serving mix: mostly small requests, padded by the engine).
    Stops after ``requests_per_client`` requests per client, or after
    ``duration_s`` wall seconds when given (whichever comes first).
    ``hedge``: resubmit a ``DeadlineExceeded`` request once before
    counting it failed (module docstring; ``--no-hedge`` disables).
    ``bulk_fraction``: that share of requests carries
    ``priority="bulk"`` (deterministic per-client rng; 0.0 keeps the
    all-interactive protocol every earlier round reported).
    ``model_mix``: {model: weight} — each request names a model drawn
    from this distribution (:func:`zipf_mix` builds the heavy tail);
    the target must take a ``model`` kwarg on ``submit`` (an
    :class:`HttpTarget`), and the report grows a ``per_model``
    request-count block.
    ``batcher`` is anything with the submit surface — a
    :class:`~pytorch_cifar_tpu_torch.serve.batcher.MicroBatcher` or an
    :class:`HttpTarget` (the full network path).

    Returns the latency/throughput report the CLIs publish:
    ``img_per_sec``, ``request_per_sec``, ``p50_ms``/``p95_ms``/``p99_ms``,
    ``mean_ms``, ``requests``, ``images``, ``rejected``, ``hedged``,
    ``failed``, ``elapsed_s``.
    """
    images_max = max(images_min, images_max)
    latencies_ms: list = []
    counts = {
        "images": 0, "rejected": 0, "hedged": 0, "failed": 0, "bulk": 0,
    }
    per_model: dict = {}
    lock = threading.Lock()
    stop_at = None
    # the per-model draw table (cumulative weights, deterministic rng)
    mix_names = mix_cum = None
    if model_mix:
        mix_names = list(model_mix)
        w = np.asarray([float(model_mix[m]) for m in mix_names])
        mix_cum = np.cumsum(w / w.sum())
    # hedges ride the serving registry (when the batcher carries one) so
    # the Prometheus dump / exporter see retry pressure, not just the CLI
    obs = getattr(batcher, "obs", None)
    c_hedged = obs.counter("serve.hedged") if obs is not None else None

    def submit_with_backoff(x, priority, model):
        kw = {} if model is None else {"model": model}
        while True:
            try:
                return batcher.submit(x, priority=priority, **kw)
            except QueueFull:
                # admission control said back off; the retry delay is
                # part of the client-observed latency (t0 stays)
                with lock:
                    counts["rejected"] += 1
                time.sleep(retry_backoff_s)

    def client(cid: int) -> None:
        rs = np.random.RandomState(seed * 1000 + cid)
        for _ in range(requests_per_client):
            if stop_at is not None and time.monotonic() >= stop_at:
                return
            n = int(rs.randint(images_min, images_max + 1))
            x = rs.randint(0, 256, size=(n, *image_shape)).astype(np.uint8)
            priority = (
                "bulk"
                if bulk_fraction and rs.uniform() < bulk_fraction
                else "interactive"
            )
            if priority == "bulk":
                with lock:
                    counts["bulk"] += 1
            model = None
            if mix_names is not None:
                model = mix_names[
                    int(np.searchsorted(mix_cum, rs.uniform()))
                ]
            t0 = time.perf_counter()
            try:
                submit_with_backoff(x, priority, model).result()
            except DeadlineExceeded:
                if not hedge:
                    with lock:
                        counts["failed"] += 1
                    continue
                # retry-once hedge: re-enter the queue with a fresh
                # deadline; a second expiry (or a shutdown race) fails
                # the request for good — never a third attempt
                with lock:
                    counts["hedged"] += 1
                if c_hedged is not None:
                    c_hedged.inc()
                try:
                    submit_with_backoff(x, priority, model).result()
                except (DeadlineExceeded, BatcherClosed):
                    with lock:
                        counts["failed"] += 1
                    continue
            except BatcherClosed:
                with lock:
                    counts["failed"] += 1
                continue
            dt_ms = (time.perf_counter() - t0) * 1e3
            with lock:
                latencies_ms.append(dt_ms)
                counts["images"] += n
                if model is not None:
                    per_model[model] = per_model.get(model, 0) + 1

    threads = [
        threading.Thread(target=client, args=(i,), name=f"loadgen-{i}")
        for i in range(clients)
    ]
    t_start = time.perf_counter()
    if duration_s is not None:
        stop_at = time.monotonic() + duration_s
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t_start

    out_per_model = (
        {"per_model": {m: per_model.get(m, 0) for m in mix_names}}
        if mix_names is not None
        else {}
    )
    return {
        "clients": clients,
        "requests": len(latencies_ms),
        "images": counts["images"],
        "rejected": counts["rejected"],
        "hedged": counts["hedged"],
        "failed": counts["failed"],
        "bulk_requests": counts["bulk"],
        **out_per_model,
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


# ---------------------------------------------------------------------
# Async load generator
# ---------------------------------------------------------------------

# The thread-per-client generator above cannot GENERATE production
# connection counts: 1k clients would be 1k stacks on the loadgen side.
# run_async_load is the same closed-loop protocol — each logical client
# has exactly one request in flight, QueueFull backs off and retries,
# DeadlineExceeded hedges once, latency includes both waits — driven by
# ONE thread over non-blocking sockets, so `--clients 2048` costs 2048
# sockets, not 2048 threads. It exists to exercise the event-loop edge
# at the connection counts it was built for.


def _encode_predict_body(x, deadline_ms, priority, model, binary):
    """(body, content_type) for one POST /predict — the encodings both
    HttpTarget.submit and the async generator put on the wire."""
    if binary:
        return (
            wire_mod.encode_request(
                x,
                deadline_ms=float(deadline_ms) if deadline_ms else None,
                priority=priority,
                model=model,
            ),
            wire_mod.CONTENT_TYPE,
        )
    req = {
        "images": base64.b64encode(x.tobytes()).decode("ascii"),
        "shape": [int(v) for v in x.shape],
        "priority": priority,
        "encoding": "b64",
    }
    if deadline_ms:
        req["deadline_ms"] = float(deadline_ms)
    if model is not None:
        req["model"] = str(model)
    return json.dumps(req).encode("utf-8"), "application/json"


class _AsyncClient:
    """One logical closed-loop client: request generator + HTTP/1.1
    response parser over a non-blocking keep-alive socket. All state is
    driven by the single run_async_load loop thread."""

    __slots__ = (
        "cid", "rs", "seq", "done_requests", "sock", "connected",
        "out", "rbuf", "body", "body_filled", "content_length", "status",
        "request", "t0", "hedged_once", "retry_at", "reconnects",
        "deadline_at", "finished", "n_images", "model",
    )

    def __init__(self, cid, seed):
        self.cid = cid
        self.rs = np.random.RandomState(seed * 1000 + cid)
        self.seq = 0
        self.done_requests = 0
        self.sock = None
        self.connected = False
        self.out = None  # memoryview of unsent request bytes
        self.rbuf = bytearray()
        self.body = None
        self.body_filled = 0
        self.content_length = 0
        self.status = 0
        self.request = b""
        self.t0 = 0.0
        self.hedged_once = False
        self.retry_at = 0.0  # 429 backoff wakeup
        self.reconnects = 0
        self.deadline_at = 0.0
        self.finished = False
        self.n_images = 0
        self.model = None


def run_async_load(
    url: str,
    *,
    clients: int = 64,
    requests_per_client: int = 16,
    images_min: int = 1,
    images_max: int = 8,
    image_shape=(32, 32, 3),
    seed: int = 0,
    retry_backoff_s: float = 0.002,
    duration_s: Optional[float] = None,
    hedge: bool = True,
    bulk_fraction: float = 0.0,
    model_mix: Optional[dict] = None,
    wire: str = "json",
    deadline_ms: Optional[float] = None,
    timeout_s: float = 60.0,
) -> dict:
    """Closed-loop load from ``clients`` LOGICAL clients multiplexed on
    one thread of non-blocking sockets (module comment above). Protocol
    and report keys are identical to :func:`run_load` — 429 backs off
    ``retry_backoff_s`` and retries (counted ``rejected``, latency keeps
    running), 504 hedges once (counted ``hedged``), other errors and
    dead connections count ``failed`` — so A/B numbers against the
    threaded generator compare like for like. ``wire`` is ``"json"``,
    ``"binary"``, or ``"mixed"`` (per-client alternation)."""
    import selectors

    parts = urlsplit(url if "//" in url else f"http://{url}")
    if parts.scheme != "http" or not parts.hostname:
        raise ValueError(f"target url must be http://host:port: {url!r}")
    if wire not in ("json", "binary", "mixed"):
        raise ValueError(f"wire must be 'json', 'binary', or 'mixed': {wire!r}")
    host, port = parts.hostname, int(parts.port or 80)
    images_max = max(images_min, images_max)

    latencies_ms: list = []
    counts = {
        "images": 0, "rejected": 0, "hedged": 0, "failed": 0, "bulk": 0,
    }
    per_model: dict = {}
    mix_names = mix_cum = None
    if model_mix:
        mix_names = list(model_mix)
        w = np.asarray([float(model_mix[m]) for m in mix_names])
        mix_cum = np.cumsum(w / w.sum())

    sel = selectors.DefaultSelector()
    by_fd: dict = {}
    stop_at = (
        time.monotonic() + duration_s if duration_s is not None else None
    )
    live = 0

    def next_request(c: _AsyncClient):
        """Generate the next request (the run_load generator, verbatim
        protocol) or mark the client finished."""
        if c.done_requests >= requests_per_client or (
            stop_at is not None and time.monotonic() >= stop_at
        ):
            finish(c)
            return
        n = int(c.rs.randint(images_min, images_max + 1))
        x = c.rs.randint(0, 256, size=(n, *image_shape)).astype(np.uint8)
        priority = (
            "bulk"
            if bulk_fraction and c.rs.uniform() < bulk_fraction
            else "interactive"
        )
        if priority == "bulk":
            counts["bulk"] += 1
        c.model = None
        if mix_names is not None:
            c.model = mix_names[
                int(np.searchsorted(mix_cum, c.rs.uniform()))
            ]
        binary = wire == "binary" or (wire == "mixed" and c.seq % 2 == 0)
        c.seq += 1
        body, ctype = _encode_predict_body(
            x, deadline_ms, priority, c.model, binary
        )
        c.request = (
            f"POST /predict HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            f"Connection: keep-alive\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n\r\n"
        ).encode("ascii") + body
        c.n_images = n
        c.t0 = time.perf_counter()
        c.hedged_once = False
        c.reconnects = 0
        send_current(c)

    def send_current(c: _AsyncClient):
        """(Re)send the buffered current request — fresh attempt, fresh
        exchange deadline; reuses the live connection when there is one."""
        c.rbuf = bytearray()
        c.body = None
        c.body_filled = 0
        c.status = 0
        c.deadline_at = time.monotonic() + timeout_s
        c.out = memoryview(c.request)
        if c.sock is None:
            open_conn(c)
        else:
            arm(c)
            on_writable(c)

    def open_conn(c: _AsyncClient):
        import errno as _errno

        close_sock(c)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setblocking(False)
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        rc = s.connect_ex((host, port))
        if rc not in (0, _errno.EINPROGRESS, _errno.EWOULDBLOCK):
            s.close()
            fail_request(c)
            return
        c.sock = s
        c.connected = False
        by_fd[s.fileno()] = c
        sel.register(
            s, selectors.EVENT_READ | selectors.EVENT_WRITE, c
        )

    def close_sock(c: _AsyncClient):
        if c.sock is None:
            return
        by_fd.pop(c.sock.fileno(), None)
        try:
            sel.unregister(c.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            c.sock.close()
        except OSError:
            pass
        c.sock = None
        c.connected = False

    def finish(c: _AsyncClient):
        nonlocal live
        if not c.finished:
            c.finished = True
            live -= 1
        close_sock(c)

    def fail_request(c: _AsyncClient):
        counts["failed"] += 1
        close_sock(c)
        c.done_requests += 1
        next_request(c)

    def conn_lost(c: _AsyncClient):
        """Transport died mid-exchange. A stale keep-alive (zero
        response bytes on a reused conn) gets one fresh-connection
        resend — the HttpTarget reconnect contract; anything else is a
        failed request."""
        stale = (
            c.status == 0 and not c.rbuf and c.body_filled == 0
            and c.reconnects == 0
        )
        close_sock(c)
        if stale:
            c.reconnects += 1
            send_current(c)
        else:
            fail_request(c)

    def arm(c: _AsyncClient):
        mask = selectors.EVENT_READ
        if c.out is not None and len(c.out):
            mask |= selectors.EVENT_WRITE
        try:
            sel.modify(c.sock, mask, c)
        except (KeyError, ValueError, OSError):
            pass

    def on_writable(c: _AsyncClient):
        if not c.connected:
            err = c.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err != 0:
                conn_lost(c)
                return
            c.connected = True
        while c.out is not None and len(c.out):
            try:
                sent = c.sock.send(c.out)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                conn_lost(c)
                return
            c.out = c.out[sent:]
        if c.out is not None and not len(c.out):
            c.out = None
        arm(c)

    def on_readable(c: _AsyncClient):
        try:
            data = c.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            conn_lost(c)
            return
        if not data:
            conn_lost(c)
            return
        if c.body is None:
            c.rbuf += data
            idx = c.rbuf.find(b"\r\n\r\n")
            if idx < 0:
                return
            head = bytes(c.rbuf[:idx])
            rest = bytes(c.rbuf[idx + 4:])
            c.rbuf = bytearray()
            try:
                lines = head.decode("iso-8859-1").split("\r\n")
                c.status = int(lines[0].split(None, 2)[1])
                length = 0
                for ln in lines[1:]:
                    name, _, value = ln.partition(":")
                    if name.strip().lower() == "content-length":
                        length = int(value.strip())
            except (ValueError, IndexError):
                conn_lost(c)
                return
            c.content_length = length
            c.body = memoryview(bytearray(length))
            c.body_filled = 0
            if rest:
                feed_body(c, rest)
            elif length == 0:
                complete(c)
        else:
            feed_body(c, data)

    def feed_body(c: _AsyncClient, data):
        take = min(len(data), c.content_length - c.body_filled)
        c.body[c.body_filled:c.body_filled + take] = data[:take]
        c.body_filled += take
        if c.body_filled >= c.content_length:
            complete(c)

    def complete(c: _AsyncClient):
        payload = bytes(c.body.obj)
        status = c.status
        c.body = None
        c.status = 0
        if status == 200:
            dt_ms = (time.perf_counter() - c.t0) * 1e3
            latencies_ms.append(dt_ms)
            counts["images"] += c.n_images
            if c.model is not None:
                per_model[c.model] = per_model.get(c.model, 0) + 1
            c.done_requests += 1
            next_request(c)
            return
        if status == 429:
            # admission control said back off; latency keeps running
            counts["rejected"] += 1
            c.retry_at = time.monotonic() + retry_backoff_s
            return
        if status == 504 and hedge and not c.hedged_once:
            c.hedged_once = True
            counts["hedged"] += 1
            send_current(c)
            return
        counts["failed"] += 1
        c.done_requests += 1
        next_request(c)

    pool = [_AsyncClient(i, seed) for i in range(clients)]
    live = clients
    t_start = time.perf_counter()
    for c in pool:
        next_request(c)

    while live > 0:
        now = time.monotonic()
        timeout = 0.25
        for c in pool:
            if c.finished:
                continue
            if c.retry_at and now >= c.retry_at:
                c.retry_at = 0.0
                send_current(c)
            elif c.retry_at:
                timeout = min(timeout, c.retry_at - now)
            if c.sock is not None and now >= c.deadline_at:
                fail_request(c)
        if live <= 0:
            break
        for key, mask in sel.select(max(timeout, 0.0)):
            c = key.data
            if c.sock is None or c.finished:
                continue
            if mask & selectors.EVENT_WRITE:
                on_writable(c)
            if c.sock is not None and mask & selectors.EVENT_READ:
                on_readable(c)
        if stop_at is not None and time.monotonic() >= stop_at:
            for c in pool:
                if not c.finished and c.sock is None and not c.retry_at:
                    finish(c)
            if all(
                c.finished or c.sock is None for c in pool
            ) and time.monotonic() >= stop_at + timeout_s:
                break  # hung tail past the grace window: report what we have
    sel.close()
    elapsed = time.perf_counter() - t_start

    out_per_model = (
        {"per_model": {m: per_model.get(m, 0) for m in mix_names}}
        if mix_names is not None
        else {}
    )
    return {
        "clients": clients,
        "requests": len(latencies_ms),
        "images": counts["images"],
        "rejected": counts["rejected"],
        "hedged": counts["hedged"],
        "failed": counts["failed"],
        "bulk_requests": counts["bulk"],
        **out_per_model,
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


def main(argv=None) -> int:
    """CLI: drive a frontend/router URL with the async load generator and
    print the one-line JSON report — ``python -m
    pytorch_cifar_tpu_torch.serve.loadgen --url http://... --clients
    512``."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--url", required=True, help="frontend/router URL")
    p.add_argument(
        "--clients", type=int, default=64,
        help="LOGICAL clients (sockets, not threads — thousands are fine)",
    )
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--images_min", type=int, default=1)
    p.add_argument("--images_max", type=int, default=8)
    p.add_argument("--duration_s", type=float, default=0.0)
    p.add_argument("--wire", choices=("json", "binary", "mixed"),
                   default="json")
    p.add_argument("--deadline_ms", type=float, default=0.0)
    p.add_argument("--bulk_fraction", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timeout_s", type=float, default=60.0)
    args = p.parse_args(argv)

    report = run_async_load(
        args.url,
        clients=args.clients,
        requests_per_client=args.requests,
        images_min=args.images_min,
        images_max=args.images_max,
        seed=args.seed,
        duration_s=args.duration_s or None,
        bulk_fraction=args.bulk_fraction,
        wire=args.wire,
        deadline_ms=args.deadline_ms or None,
        timeout_s=args.timeout_s,
    )
    print(json.dumps({"harness": "loadgen_async", **report}))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
