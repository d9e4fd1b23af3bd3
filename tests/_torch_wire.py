"""Shared pieces of the port's wire tests (``tests/test_torch_{wire,
frontend,edge,router,loadgen,serve_http}.py``).

Stub backends answer constant logits and count their calls, so a
protocol test needs no engine; :func:`lenet_engine` is the one real
engine the files serve (LeNet, fp32, on the CPU). Every socket read has a
timeout, and every server a test starts listens on an ephemeral port.
"""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import torch

from pytorch_cifar_tpu_torch.serve import InferenceEngine, wire

TIMEOUT_S = 30


def images(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


def lenet_engine(registry=None):
    return InferenceEngine.from_random(
        "LeNet", seed=0, buckets=(1, 4), compute_dtype=torch.float32,
        registry=registry, device="cpu",
    )


def b64_payload(x, **kw):
    return {
        "images": base64.b64encode(np.ascontiguousarray(x).tobytes())
        .decode(),
        "shape": list(x.shape),
        **kw,
    }


def post(url, body, ctype="application/json", timeout=TIMEOUT_S):
    """``(status, content type, body bytes)`` of one POST /predict; an
    HTTP error status is returned, not raised."""
    req = urllib.request.Request(
        url + "/predict", data=body, headers={"Content-Type": ctype}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.headers.get("Content-Type"), e.read()


def post_json(url, payload, timeout=TIMEOUT_S):
    return post(url, json.dumps(payload).encode(), timeout=timeout)


def post_frame(url, frame, timeout=TIMEOUT_S):
    return post(url, frame, wire.CONTENT_TYPE, timeout=timeout)


def get(url, path, timeout=TIMEOUT_S):
    try:
        with urllib.request.urlopen(url + path, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read()


def recv_response(sock, timeout=TIMEOUT_S):
    """Read exactly one HTTP/1.1 response off a raw socket (status,
    headers dict, body bytes) without consuming past it."""
    sock.settimeout(timeout)
    buf = bytearray()
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(4096)
        assert chunk, "server closed mid-head"
        buf += chunk
    head, _, rest = bytes(buf).partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    status = int(lines[0].split()[1])
    headers = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    length = int(headers.get("content-length", "0"))
    body = bytearray(rest)
    while len(body) < length:
        chunk = sock.recv(4096)
        assert chunk, "server closed mid-body"
        body += chunk
    assert len(body) == length, "read past the response"
    return status, headers, bytes(body)


def post_head(ctype, length, path="/predict", extra=""):
    return (
        f"POST {path} HTTP/1.1\r\n"
        f"Content-Type: {ctype}\r\n"
        f"Content-Length: {length}\r\n{extra}\r\n"
    ).encode()


class StubBackend:
    """Protocol-test backend: constant logits tagged in column 0, call
    counting, an optional scripted exception, an optional gate that holds
    every predict until set, and the rows of every request it saw."""

    def __init__(self, tag=1.0, raises=None, gated=False):
        self.tag = tag
        self.raises = raises
        self.engine_version = 1
        self.gate = threading.Event()
        if not gated:
            self.gate.set()
        self._lock = threading.Lock()
        self.calls = 0
        self.seen_rows = []

    def predict(self, images, deadline_ms=None, priority="interactive"):
        self.gate.wait(timeout=TIMEOUT_S)
        with self._lock:
            self.calls += 1
            self.seen_rows.append(int(images.shape[0]))
        if self.raises is not None:
            raise self.raises
        out = np.zeros((images.shape[0], 10), np.float32)
        out[:, 0] = self.tag
        return out

    def health(self):
        return {"status": "ok", "role": "stub", "tag": self.tag}
