"""The port's event-loop edge (``serve/edge.py``) on the CPU.

- ``EdgeFrontend`` answers bit-identically to the threaded frontend in
  both encodings, and both equal the engine's ``predict``; a router on the
  event transport (``EdgePool``) over two event replicas too;
- its state machine survives a request trickled at every boundary, and
  keep-alive carries many (and pipelined) requests on one accept;
- the protections fire where JAX's do: a rate-limit 429 from the request
  head, a slow-loris close at the read deadline with an idle keep-alive
  connection untouched, oversize rejected from the head and mid-body from
  the 24 PCTW header bytes, bulk shed before interactive; each error
  body is the JAX edge's for the same request;
- the drain answers in-flight requests and leaves no thread or fd.

Deadlines are short, and no assertion depends on how close to one a
close lands.
"""

import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

from pytorch_cifar_tpu.serve import edge as jax_edge
from pytorch_cifar_tpu_torch.serve import (
    BatcherBackend,
    EdgeFrontend,
    EdgePool,
    HttpTarget,
    MicroBatcher,
    Router,
    ServingFrontend,
    run_load,
    wire,
)
from pytorch_cifar_tpu_torch.serve.frontend import MAX_IMAGES_PER_REQUEST
from _torch_threads import torch_threads  # noqa: F401
from _torch_wire import (
    TIMEOUT_S,
    StubBackend,
    images,
    lenet_engine,
    post_head,
    recv_response,
)


@pytest.fixture(scope="module")
def stack():
    """One LeNet engine + batcher behind a threaded AND an event
    frontend: the pair every bit-identity case compares."""
    engine = lenet_engine()
    batcher = MicroBatcher(engine, max_batch=4, max_wait_ms=1, max_queue=64)
    backend = BatcherBackend(engine, batcher)
    threaded = ServingFrontend(backend).start()
    event = EdgeFrontend(backend).start()
    yield engine, threaded, event
    event.stop()
    threaded.stop()
    batcher.close()


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("mode", ["json", "binary"])
@pytest.mark.parametrize("n", [1, 3, 4, 7])
def test_event_edge_bit_identical_to_threaded(stack, n, mode):
    engine, threaded, event = stack
    x = images(n, seed=n)
    answers = []
    for fe in (threaded, event):
        t = HttpTarget(fe.url, wire=mode)
        answers.append(t.submit(x).result())
        t.close()
    assert answers[1].dtype == np.float32
    assert answers[0].tobytes() == answers[1].tobytes()
    assert np.array_equal(answers[1], engine.predict(x))


def test_closed_loop_through_event_edge(stack):
    _, _, event = stack
    before = event.c_http_requests.value
    target = HttpTarget(event.url, wire="mixed")
    rep = run_load(target, clients=4, requests_per_client=6, images_max=4,
                   seed=9)
    target.close()
    assert rep["failed"] == 0 and rep["requests"] == 24
    assert event.c_http_requests.value >= before + 24
    assert event.c_wire_requests.value > 0  # the binary half of "mixed"


def test_router_on_event_transport_bit_identical(stack):
    engine, _, event = stack
    second = EdgeFrontend(event.backend).start()
    try:
        with Router([event.url, second.url], transport="event") as r:
            x = images(3, seed=77)
            want = engine.predict(x)
            for _ in range(6):
                assert np.array_equal(r.predict(x), want)
            assert all(rep.dispatched > 0 for rep in r.replicas)
            with EdgeFrontend(r) as front:
                for mode in ("json", "binary"):
                    t = HttpTarget(front.url, wire=mode)
                    assert np.array_equal(t.submit(x).result(), want)
                    t.close()
            assert r.probe_once() == 2
    finally:
        second.stop()


def test_edge_pool_reuses_one_connection():
    stub = StubBackend()
    with EdgeFrontend(stub) as fe:
        pool = EdgePool().start()
        try:
            body = json.dumps({"images": images(1).tolist()}).encode()
            for _ in range(5):
                status, payload = pool.exchange(
                    fe.host, fe.port, "POST", "/predict", body)
                assert status == 200
                assert json.loads(payload)["logits"][0][0] == 1.0
            status, payload = pool.exchange(fe.host, fe.port, "GET",
                                            "/healthz")
            assert status == 200 and json.loads(payload)["status"] == "ok"
        finally:
            pool.close()
        assert stub.calls == 5 and int(fe.c_accepts.value) == 1


def test_partial_reads_resume_at_every_boundary(stack):
    engine, _, event = stack
    x = images(3, seed=5)
    want = engine.predict(x)
    frame = wire.encode_request(x)
    head = post_head(wire.CONTENT_TYPE, len(frame))
    msg, hs = head + frame, len(head)
    for cut in sorted({1, 5, hs - 2, hs, hs + 1, hs + wire.HEADER_SIZE - 1,
                       hs + wire.HEADER_SIZE, hs + wire.HEADER_SIZE + 7,
                       len(msg) - 1}):
        with socket.create_connection((event.host, event.port)) as s:
            s.sendall(msg[:cut])
            time.sleep(0.02)  # let the loop consume the first fragment
            s.sendall(msg[cut:])
            status, _, body = recv_response(s)
        assert status == 200, cut
        assert np.array_equal(wire.decode_response(body)[0], want), cut


def test_keep_alive_and_pipelining_on_one_accept(stack):
    engine, _, event = stack
    accepts = int(event.c_accepts.value)
    x = images(2, seed=11)
    want = engine.predict(x)
    jbody = json.dumps({"images": x.tolist()}).encode()
    jreq = post_head("application/json", len(jbody)) + jbody
    frame = wire.encode_request(x)
    breq = post_head(wire.CONTENT_TYPE, len(frame)) + frame
    with socket.create_connection((event.host, event.port)) as s:
        # alternate encodings, then two requests in one send (pipelined)
        for req, answers in ((jreq, 1), (breq, 1), (jreq, 1), (breq, 1),
                             (jreq + breq, 2)):
            s.sendall(req)
            for _ in range(answers):
                status, headers, body = recv_response(s)
                assert status == 200
                got = (wire.decode_response(body)[0]
                       if headers["content-type"] == wire.CONTENT_TYPE
                       else np.asarray(json.loads(body)["logits"],
                                       np.float32))
                assert np.array_equal(got, want)
    assert int(event.c_accepts.value) == accepts + 1


def _error_of(fe_cls, backend, data, **kw):
    """(status, Connection header, error body) of one raw request to a
    fresh edge of ``fe_cls``: the port's or the JAX package's."""
    fe = fe_cls(backend, **kw).start()
    try:
        with socket.create_connection((fe.host, fe.port)) as s:
            s.sendall(data)
            status, headers, body = recv_response(s)
            if headers.get("connection") == "close":
                s.settimeout(5)
                assert s.recv(256) == b""  # closed after the flush
        return status, headers.get("connection"), json.loads(body)
    finally:
        fe.stop()


def _oversized_requests():
    cap = wire.max_request_bytes((32, 32, 3), MAX_IMAGES_PER_REQUEST)
    hdr = wire._HEADER.pack(wire.MAGIC, wire.VERSION, wire.FRAME_PREDICT,
                            wire.DTYPE_UINT8, 0, MAX_IMAGES_PER_REQUEST + 1,
                            32, 32, 3)
    return {
        # head only: the 400 must not wait for cap + 1 bytes
        "head": post_head(wire.CONTENT_TYPE, cap + 1),
        "json_head": post_head("application/json", 64 * 1024 * 1024 + 1),
        # an in-cap Content-Length hiding an oversized n: 24 bytes sent
        "mid_body": post_head(wire.CONTENT_TYPE, len(hdr) + 64) + hdr,
        "bad_magic_mid_body": post_head(wire.CONTENT_TYPE, len(hdr) + 64)
        + b"XXXX" + hdr[4:],
        "bad_head": b"GARBAGE\r\n\r\n",
    }


@pytest.mark.parametrize("name", sorted(_oversized_requests()))
def test_rejected_before_the_body_as_jax_rejects(name):
    data = _oversized_requests()[name]
    stub, jstub = StubBackend(), StubBackend()
    got = _error_of(EdgeFrontend, stub, data)
    want = _error_of(jax_edge.EdgeFrontend, jstub, data)
    assert got == want and got[0] == 400 and got[1] == "close"
    assert stub.calls == 0 and jstub.calls == 0


def test_rate_limit_429_from_the_head():
    stub = StubBackend()
    fe = EdgeFrontend(stub, rate_limit_rps=0.001, rate_burst=2).start()
    try:
        for _ in range(2):  # the burst
            t = HttpTarget(fe.url, wire="json")
            assert t.submit(images(1)).result() is not None
            t.close()
        body = json.dumps({"images": images(1).tolist()}).encode()
        with socket.create_connection((fe.host, fe.port)) as s:
            s.sendall(post_head("application/json", len(body)))  # no body
            status, headers, payload = recv_response(s)
            assert status == 429 and headers["connection"] == "close"
            assert "rate limit" in json.loads(payload)["error"]
            s.settimeout(5)
            assert s.recv(256) == b""
        assert int(fe.c_rate_limited.value) == 1 and stub.calls == 2
    finally:
        fe.stop()


def test_slow_loris_closed_idle_keep_alive_untouched():
    stub = StubBackend()
    fe = EdgeFrontend(stub, read_deadline_s=0.3).start()
    try:
        idle = socket.create_connection((fe.host, fe.port))
        with socket.create_connection((fe.host, fe.port)) as loris:
            loris.sendall(b"POST /predict HTTP/1.1\r\nContent-Le")
            loris.settimeout(TIMEOUT_S)
            assert loris.recv(256) == b""  # closed at its deadline
        assert int(fe.c_loris_closed.value) == 1
        time.sleep(0.4)  # the idle connection outlives a deadline too
        body = json.dumps({"images": images(1).tolist()}).encode()
        idle.sendall(post_head("application/json", len(body)) + body)
        assert recv_response(idle)[0] == 200
        idle.close()
        assert int(fe.c_loris_closed.value) == 1
    finally:
        fe.stop()


def test_bulk_shed_before_interactive_and_connection_reused():
    backend = StubBackend(gated=True)
    fe = EdgeFrontend(backend, workers=1, shed_pending=64,
                      shed_pending_bulk=1).start()
    results = {}
    t_bg = HttpTarget(fe.url, wire="json")
    bg = threading.Thread(
        target=lambda: results.update(bg=t_bg.submit(images(1)).result()))
    try:
        bg.start()
        assert _wait(lambda: fe._pending >= 1)
        x = images(1, seed=7)
        bulk = wire.encode_request(x, priority="bulk")
        inter = wire.encode_request(x)
        with socket.create_connection((fe.host, fe.port)) as s:
            s.sendall(post_head(wire.CONTENT_TYPE, len(bulk)) + bulk)
            status, _, payload = recv_response(s)
            assert status == 429
            assert "shedding" in json.loads(payload)["error"]
            assert int(fe.c_shed.value) == 1
            # the same connection carries an interactive request, admitted
            s.sendall(post_head(wire.CONTENT_TYPE, len(inter)) + inter)
            assert _wait(lambda: fe._pending == 2)
            backend.gate.set()
            status, _, payload = recv_response(s)
            assert status == 200
            assert wire.decode_response(payload)[0].shape == (1, 10)
        bg.join(timeout=TIMEOUT_S)
        assert not bg.is_alive() and results["bg"] is not None
    finally:
        backend.gate.set()
        t_bg.close()
        fe.stop()


def test_metrics_carry_both_families(stack):
    _, _, event = stack
    t = HttpTarget(event.url, wire="binary")
    assert t.submit(images(1)).result() is not None
    t.close()
    with urllib.request.urlopen(event.url + "/metrics",
                                timeout=TIMEOUT_S) as r:
        text = r.read().decode()
    for needle in ("pct_serve_http_requests", "pct_serve_edge_accepts",
                   "pct_serve_edge_connections",
                   "pct_serve_edge_read_ms_bucket"):
        assert needle in text, needle


def test_drain_answers_in_flight_and_leaks_nothing():
    def open_fds():
        return set(os.listdir("/proc/self/fd"))

    threads_before, fds_before = set(threading.enumerate()), open_fds()
    backend = StubBackend(gated=True)
    fe = EdgeFrontend(backend, workers=1).start()
    target = HttpTarget(fe.url, wire="json")
    results = {}
    sender = threading.Thread(
        target=lambda: results.update(out=target.submit(images(1)).result()))
    sender.start()
    assert _wait(lambda: fe._pending == 1)  # in a worker's hands
    stopper = threading.Thread(target=fe.stop)
    stopper.start()
    time.sleep(0.05)
    backend.gate.set()
    sender.join(timeout=TIMEOUT_S)
    stopper.join(timeout=TIMEOUT_S)
    assert not sender.is_alive() and not stopper.is_alive()
    assert results["out"] is not None  # answered mid-drain
    target.close()
    host, port = fe.host, fe.port
    fe.stop()  # idempotent
    assert _wait(lambda: not (set(threading.enumerate()) - threads_before)
                 and not (open_fds() - fds_before))
    with pytest.raises(OSError):
        socket.create_connection((host, port), timeout=2)
