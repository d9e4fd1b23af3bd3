"""The port's threaded HTTP frontend against the JAX package's.

- ``/predict`` equals the port's in-process ``engine.predict`` bit for bit
  in the binary frame, JSON-b64 and JSON lists, directly and through the
  router (and a frontend stacked on the router);
- ``decode_predict_request`` and ``encode_predict_response`` agree with
  JAX's on both JSON encodings: the same arrays and fields, the same
  ``ValueError`` messages, the same JSON text for the same logits;
- every backend exception and every malformed request gets JAX's status
  and error body; ``/healthz`` has JAX's keys; ``/metrics`` is live
  Prometheus text; the drain leaves no thread behind;
- across packages: one JAX-written ResNet-18 checkpoint served by each
  package's engine through its own frontend agrees within rtol 1e-4, atol
  1e-5 in fp32 and within 2% of the largest logit in bf16.
"""

import base64
import json
import re
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.serve import batcher as jax_batcher
from pytorch_cifar_tpu.serve import frontend as jax_frontend
from pytorch_cifar_tpu.serve import tenancy as jax_tenancy
from pytorch_cifar_tpu.serve import wire as jax_wire
from pytorch_cifar_tpu.serve.engine import InferenceEngine as JaxEngine
from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch.obs import MetricsRegistry
from pytorch_cifar_tpu_torch.serve import (
    BatcherBackend,
    BatcherClosed,
    DeadlineExceeded,
    HttpTarget,
    InferenceEngine,
    MicroBatcher,
    QueueFull,
    Router,
    ServingFrontend,
    UnknownModel,
    run_load,
    wire,
)
from pytorch_cifar_tpu_torch.serve.frontend import (
    decode_logits,
    decode_predict_request,
    encode_predict_response,
)
from _torch_ckpt import jax_state
from _torch_threads import torch_threads  # noqa: F401
from _torch_wire import (
    StubBackend,
    b64_payload,
    get,
    images,
    lenet_engine,
    post,
    post_frame,
    post_head,
    post_json,
    recv_response,
)

SHAPE = (32, 32, 3)


@pytest.fixture(scope="module")
def stack():
    """One LeNet engine + batcher + threaded frontend, one registry
    through all three (the CLI's wiring)."""
    registry = MetricsRegistry()
    engine = lenet_engine(registry)
    batcher = MicroBatcher(engine, max_batch=4, max_wait_ms=1,
                           max_queue=64, registry=registry)
    frontend = ServingFrontend(BatcherBackend(engine, batcher),
                               registry=registry).start()
    yield engine, batcher, frontend
    frontend.stop()
    batcher.close()


def _answer(url, x, encoding):
    """Logits of one POST /predict in ``encoding``."""
    if encoding == "list":
        status, _, body = post_json(url, {"images": x.tolist()})
    elif encoding == "b64":
        status, _, body = post_json(url, b64_payload(x, encoding="b64"))
    elif encoding == "binary":
        status, ctype, body = post_frame(url, wire.encode_request(x))
        assert status == 200 and ctype == wire.CONTENT_TYPE
        return wire.decode_response(body)[0]
    else:  # a binary frame asking for a JSON answer
        status, _, body = post_frame(
            url, wire.encode_request(x, json_response=True))
    assert status == 200, body
    resp = json.loads(body)
    assert resp["n"] == x.shape[0]
    return decode_logits(resp)


ENCODINGS = ["list", "b64", "binary", "binary_json"]


@pytest.mark.parametrize("n", [1, 3, 5])
@pytest.mark.parametrize("encoding", ENCODINGS)
def test_predict_bit_identical_to_engine(stack, encoding, n):
    engine, _, frontend = stack
    x = images(n, seed=n)
    got = _answer(frontend.url, x, encoding)
    assert got.dtype == np.float32
    assert np.array_equal(got, engine.predict(x))


def test_predict_through_router_bit_identical(stack):
    engine, _, frontend = stack
    x = images(3, seed=9)
    want = engine.predict(x)
    with Router([frontend.url]) as r:
        assert np.array_equal(r.predict(x), want)
        with ServingFrontend(r) as edge:
            for encoding in ENCODINGS:
                assert np.array_equal(_answer(edge.url, x, encoding), want)


def _request_bodies():
    x = images(2, seed=3)
    good = [
        {"images": x.tolist()},
        b64_payload(x),
        b64_payload(x, encoding="b64", deadline_ms=250, priority="bulk"),
        {"images": x.tolist(), "deadline_ms": 0, "model": "LeNet"},
    ]
    bad = [
        b"not json at all", b"\xff\xfe", json.dumps([1, 2, 3]).encode(),
        {}, {"images": 3},
        {"images": "!!!notb64", "shape": [1, 32, 32, 3]},
        {"images": base64.b64encode(b"xx").decode(), "shape": [1, 32, 32, 3]},
        {"images": "AAAA", "shape": [1, 32, 32]},
        b64_payload(images(1), shape=[1, 16, 64, 3]),
        {"images": x.tolist()[0]},
        {"images": [[[[256] * 3] * 32] * 32]},
        {"images": x.tolist(), "priority": "vip"},
        {"images": x.tolist(), "deadline_ms": -5},
        {"images": x.tolist(), "deadline_ms": "soon"},
        {"images": x.tolist(), "encoding": "msgpack"},
        {"images": x.tolist(), "model": ""},
        b64_payload(np.zeros((4097, 1, 1, 1), np.uint8),
                    shape=[4097, 32, 32, 3]),
    ]
    return [(json.dumps(b).encode() if isinstance(b, dict) else b)
            for b in good + bad]


@pytest.mark.parametrize("i", range(len(_request_bodies())))
def test_request_decode_agrees_with_jax(i):
    body = _request_bodies()[i]
    try:
        want = jax_frontend.decode_predict_request(body, SHAPE)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            decode_predict_request(body, SHAPE)
        assert str(ours.value) == str(e)
        return
    got = decode_predict_request(body, SHAPE)
    assert np.array_equal(got[0], want[0]) and got[0].dtype == np.uint8
    assert got[1:] == want[1:]


def _logits(seed):
    rs = np.random.RandomState(seed)
    out = (rs.standard_normal((3, 10)) * 10.0 ** rs.randint(-8, 8)).astype(
        np.float32)
    out[0, :4] = [-0.0, 1e-45, np.float32(3.4028235e38), 0.1]
    return out


@pytest.mark.parametrize("encoding", ["json", "b64"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_response_json_text_equal_jax(encoding, seed):
    logits = _logits(seed)
    ours = encode_predict_response(logits, encoding, 7)
    theirs = jax_frontend.encode_predict_response(logits, encoding, 7)
    assert json.dumps(ours) == json.dumps(theirs)
    for decode in (decode_logits, jax_frontend.decode_logits):
        back = decode(json.loads(json.dumps(ours)))
        assert back.tobytes() == logits.tobytes()


EXCEPTIONS = [
    ("QueueFull", QueueFull, jax_batcher.QueueFull),
    ("BatcherClosed", BatcherClosed, jax_batcher.BatcherClosed),
    ("DeadlineExceeded", DeadlineExceeded, jax_batcher.DeadlineExceeded),
    ("UnknownModel", UnknownModel, jax_tenancy.UnknownModel),
    ("ValueError", ValueError, ValueError),
    ("RuntimeError", RuntimeError, RuntimeError),
]


@pytest.mark.parametrize("name,ours,theirs", EXCEPTIONS,
                         ids=[e[0] for e in EXCEPTIONS])
def test_backend_exceptions_get_jax_status(name, ours, theirs):
    body = json.dumps({"images": images(1).tolist()}).encode()
    frame = wire.encode_request(images(1))
    with ServingFrontend(StubBackend(raises=ours("no"))) as fe, \
            jax_frontend.ServingFrontend(
                StubBackend(raises=theirs("no"))) as jfe:
        for data, ctype in ((body, "application/json"),
                            (frame, wire.CONTENT_TYPE)):
            got = post(fe.url, data, ctype)
            want = post(jfe.url, data, ctype)
            assert got[0] == want[0] and got[0] >= 400, name
            assert json.loads(got[2]) == json.loads(want[2])


def _bad_requests():
    good = wire.encode_request(images(2, seed=1))
    return [
        (b"not json", "application/json"),
        (json.dumps({}).encode(), "application/json"),
        (json.dumps({"images": images(1).tolist(), "priority": "vip"})
         .encode(), "application/json"),
        (good[:10], wire.CONTENT_TYPE),
        (good[:-7], wire.CONTENT_TYPE),
        (b"XXXX" + good[4:], wire.CONTENT_TYPE),
        (good[:7] + bytes([0x80]) + good[8:], wire.CONTENT_TYPE),
        (wire._HEADER.pack(wire.MAGIC, wire.VERSION, wire.FRAME_PREDICT,
                           wire.DTYPE_UINT8, 0, 5000, 32, 32, 3),
         wire.CONTENT_TYPE),
        (json.dumps({"images": images(1).tolist(), "model": "VGG16"})
         .encode(), "application/json"),
        (wire.encode_request(images(1), model="VGG16"), wire.CONTENT_TYPE),
    ]


def test_malformed_requests_get_jax_status_and_body():
    stub, jstub = StubBackend(), StubBackend()
    with ServingFrontend(stub) as fe, \
            jax_frontend.ServingFrontend(jstub) as jfe:
        for data, ctype in _bad_requests():
            got, want = post(fe.url, data, ctype), post(jfe.url, data, ctype)
            assert got[0] == want[0] and got[0] in (400, 404), data[:32]
            assert json.loads(got[2]) == json.loads(want[2])
        # an oversized binary Content-Length: refused from the head alone
        big = wire.max_request_bytes(SHAPE, 4096) + 1
        answers = []
        for f in (fe, jfe):
            with socket.create_connection((f.host, f.port)) as s:
                s.sendall(post_head(wire.CONTENT_TYPE, big))
                status, _, body = recv_response(s)
            answers.append((status, json.loads(body)))
        assert answers[0] == answers[1] and answers[0][0] == 400
        for path, code in (("/nope", 404), ("/predict", 405)):
            assert get(fe.url, path)[0] == get(jfe.url, path)[0] == code
    assert stub.calls == 0 and jstub.calls == 0


def test_single_model_replica_answers_its_own_name(stack):
    engine, _, frontend = stack
    x = images(2, seed=43)
    status, _, body = post_json(
        frontend.url, b64_payload(x, encoding="b64", model="LeNet"))
    assert status == 200
    assert np.array_equal(decode_logits(json.loads(body)), engine.predict(x))
    status, _, body = post_frame(frontend.url,
                                 wire.encode_request(x, model="LeNet"))
    assert status == 200
    assert np.array_equal(wire.decode_response(body)[0], engine.predict(x))
    status, _, body = post_frame(frontend.url,
                                 wire.encode_request(x, model="VGG16"))
    assert status == 404 and "VGG16" in json.loads(body)["error"]


def test_healthz_has_the_jax_keys(stack):
    engine, batcher, frontend = stack
    status, body = get(frontend.url, "/healthz")
    health = json.loads(body)
    # the JAX backend reads the same engine and batcher attributes
    want = jax_frontend.BatcherBackend(engine, batcher).health()
    assert status == 200 and sorted(health) == sorted(want)
    assert health["status"] == "ok" and health["role"] == "replica"
    assert health["model"] == "LeNet" and health["buckets"] == [1, 4]
    assert health["compiles"] == 2 and health["aot_cache_hits"] == 0
    assert health["n_devices"] == 1
    assert health["engine_version"] == engine.version


# one Prometheus text-format sample line: name{labels} value
_PROM_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [0-9eE.+-]+$")


def test_metrics_is_live_prometheus_text(stack):
    _, _, frontend = stack
    post_json(frontend.url, {"images": images(1).tolist()})

    def scrape():
        status, body = get(frontend.url, "/metrics")
        assert status == 200
        text = body.decode()
        for ln in text.splitlines():
            if ln and not ln.startswith("#"):
                assert _PROM_LINE.match(ln), ln
        assert "pct_serve_requests" in text  # the batcher's counters too
        return float(re.search(r"^pct_serve_http_requests ([0-9.]+)$",
                               text, re.M).group(1))

    before = scrape()
    post_json(frontend.url, {"images": images(1).tolist()})
    assert scrape() > before


def test_drain_leaves_no_thread_and_is_idempotent():
    before = set(threading.enumerate())
    fe = ServingFrontend(StubBackend()).start()
    target = HttpTarget(fe.url)
    rep = run_load(target, clients=4, requests_per_client=4)
    assert rep["failed"] == 0 and rep["requests"] == 16
    fe.stop()
    fe.stop()
    deadline = time.monotonic() + 10
    while (set(threading.enumerate()) - before
           and time.monotonic() < deadline):
        time.sleep(0.05)
    leaked = set(threading.enumerate()) - before
    assert not leaked, [t.name for t in leaked]
    with pytest.raises(BatcherClosed):
        target.submit(images(1))
    target.close()


@pytest.fixture(scope="module")
def resnet18_ckpt(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_ckpt"))
    jax_ckpt.save_checkpoint(out, jax_state("ResNet18", seed=5), 3, 55.0)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packages_serve_one_jax_checkpoint_alike(resnet18_ckpt, dtype):
    port_engine = InferenceEngine.from_checkpoint(
        resnet18_ckpt, "ResNet18", buckets=(4,),
        compute_dtype=getattr(torch, dtype), device="cpu")
    jax_engine = JaxEngine.from_checkpoint(
        resnet18_ckpt, "ResNet18", buckets=(4,),
        compute_dtype=getattr(jnp, dtype))
    assert port_engine.checkpoint_meta == jax_engine.checkpoint_meta
    batcher = MicroBatcher(port_engine, max_wait_ms=1)
    jbatcher = jax_batcher.MicroBatcher(jax_engine, max_wait_ms=1)
    x = images(3, seed=7)
    try:
        with ServingFrontend(BatcherBackend(port_engine, batcher)) as fe, \
                jax_frontend.ServingFrontend(
                    jax_frontend.BatcherBackend(jax_engine, jbatcher)) as jfe:
            got = wire.decode_response(
                post_frame(fe.url, wire.encode_request(x))[2])[0]
            want = jax_wire.decode_response(
                post_frame(jfe.url, jax_wire.encode_request(x))[2])[0]
            # and each package's client reads the other's server
            cross = HttpTarget(jfe.url, wire="binary").submit(x).result()
    finally:
        batcher.close()
        jbatcher.close()
    assert np.array_equal(got, port_engine.predict(x))
    assert np.array_equal(cross, want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert np.max(np.abs(got - want)) <= 0.02 * np.max(np.abs(want))


class _GatedEngine:
    """Engine stand-in whose predict blocks until released, so requests
    queue behind the first one; it records each dispatched batch's
    first-row tags."""

    buckets = (4,)

    def __init__(self, staging):
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.staging = staging
        self.heads = []

    def bucket_for(self, n):
        return 4

    def predict(self, x):
        self.entered.set()
        self.gate.wait(timeout=30)
        self.heads.append(int(x[0, 0, 0, 0]))
        return np.zeros((x.shape[0], 10), np.float32)


def _tagged(tag):
    return np.full((1, 32, 32, 3), tag, np.uint8)


def _run_knobs(mod, pool_cls, **kw):
    """The same script against either package's ``MicroBatcher``: the
    dispatched heads, which requests expired or were refused, and the
    stats."""
    eng = _GatedEngine(pool_cls())
    mb = mod.MicroBatcher(eng, max_batch=1, max_wait_ms=0.0, max_queue=4,
                          **kw)
    outcome = []
    try:
        if not kw.get("autostart", True):
            held = mb.submit(_tagged(1))
            assert not eng.entered.wait(0.2)  # no worker until start()
            mb.start()
        else:
            held = mb.submit(_tagged(1))
        assert eng.entered.wait(10)
        futures = [mb.submit(_tagged(2))]  # the default deadline applies
        for tag in (3, 4, 5):
            try:
                futures.append(mb.submit(_tagged(tag), priority="bulk"))
            except mod.QueueFull:
                outcome.append(("refused", tag))
        time.sleep(0.05)
        eng.gate.set()
        for tag, f in zip((2, 3, 4, 5), futures):
            try:
                f.result(timeout=30)
                outcome.append(("answered", tag))
            except mod.DeadlineExceeded:
                outcome.append(("expired", tag))
        held.result(timeout=30)
    finally:
        eng.gate.set()
        mb.close()
    stats = {k: v for k, v in mb.stats.items() if k != "queued"}
    return eng.heads, sorted(outcome), stats


@pytest.mark.parametrize("kw", [
    {}, {"default_deadline_ms": 1.0}, {"bulk_share": 0.25},
    {"bulk_share": 1.0}, {"continuous": False}, {"autostart": False},
], ids=lambda kw: ",".join(kw) or "defaults")
def test_batcher_knobs_behave_as_jax(kw):
    from pytorch_cifar_tpu.data.pipeline import StagingPool as JaxPool
    from pytorch_cifar_tpu_torch.data.pipeline import StagingPool
    from pytorch_cifar_tpu_torch.serve import batcher

    assert _run_knobs(batcher, StagingPool, **kw) == \
        _run_knobs(jax_batcher, JaxPool, **kw)
