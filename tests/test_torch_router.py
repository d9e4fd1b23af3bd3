"""The port's router (``serve/router.py``) against stub backends behind
the port's frontends, on both transports (threaded ``http.client``
connections and the event ``EdgePool``):

- least-loaded dispatch with round-robin ties spreads sequential load;
- a dead replica's traffic is hedged once to the survivor, the corpse is
  evicted after ``fail_after`` failures and reinstated by a probe once a
  frontend answers on its port again;
- a bulk 429 returns at once, an interactive 429 tries a second replica;
- a hedge and a stale-connection retry resend the complete frame;
- the model-aware filter sends a model only to replicas that advertise
  it, and an unhosted model is a 404 (``UnknownModel``), never a hedge;
- the fleet's errors are the batcher's exception types, as in JAX;
- ``attach_shadow`` offers every answered request of the canary's own
  model (with the incumbent's answer) to the controller, never a failed
  one or another model's, and ``/healthz`` carries its status.
"""

import numpy as np
import pytest

from pytorch_cifar_tpu_torch.serve import (
    BatcherClosed,
    QueueFull,
    Router,
    ServingFrontend,
    UnknownModel,
)
from _torch_threads import torch_threads  # noqa: F401
from _torch_wire import StubBackend, images

TRANSPORTS = ["threaded", "event"]


class ZooStub(StubBackend):
    """A routing-aware stub: answers only its own model list."""

    supports_model_routing = True

    def __init__(self, tag, models):
        super().__init__(tag=tag)
        self.models = list(models)

    def predict(self, images, deadline_ms=None, priority="interactive",
                model=None):
        if model is not None and model not in self.models:
            raise UnknownModel(f"model {model!r} not hosted")
        return super().predict(images, deadline_ms, priority)

    def health(self):
        return {"status": "ok", "role": "zoo", "tag": self.tag,
                "models": self.models}


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_spreads_load_and_reports_health(transport):
    a, b = StubBackend(1.0), StubBackend(2.0)
    with ServingFrontend(a) as fa, ServingFrontend(b) as fb:
        with Router([fa.url, fb.url], transport=transport) as r:
            for _ in range(8):
                assert float(r.predict(images(1))[0, 0]) in (1.0, 2.0)
            assert a.calls == b.calls == 4  # ties alternate
            assert r.probe_once() == 2
            h = r.health()
            assert h["status"] == "ok" and h["role"] == "router"
            assert h["healthy_replicas"] == 2
            assert [rep["health"]["tag"] for rep in h["replicas"]] == [1, 2]
            assert r.stats["transport"] == transport


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_hedges_once_evicts_and_reinstates(transport):
    a, b = StubBackend(1.0), StubBackend(2.0)
    fa = ServingFrontend(a).start()
    port_a = fa.port
    fb = ServingFrontend(b).start()
    r = Router([fa.url, fb.url], fail_after=2, transport=transport)
    fa2 = None
    try:
        fa.stop()  # connection refused from now on
        for _ in range(4):
            assert float(r.predict(images(1))[0, 0]) == 2.0
        assert r.stats["hedged"] >= 1 and r.stats["failed"] == 0
        assert r.probe_once() == 1 and r.stats["evictions"] == 1
        assert [rep["healthy"] for rep in r.health()["replicas"]] == [
            False, True]
        fa2 = ServingFrontend(a, port=port_a).start()
        assert r.probe_once() == 2 and r.stats["reinstated"] == 1
    finally:
        r.stop()
        fb.stop()
        if fa2 is not None:
            fa2.stop()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_no_healthy_replica_is_closed(transport):
    fa = ServingFrontend(StubBackend()).start()
    r = Router([fa.url], fail_after=1, transport=transport)
    try:
        fa.stop()
        with pytest.raises(BatcherClosed):
            r.predict(images(1))
        r.probe_once()
        assert r.health()["status"] == "unavailable"
        with pytest.raises(BatcherClosed):
            r.predict(images(1))  # the evicted fleet: unavailable at once
    finally:
        r.stop()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_priority_aware_admission(transport):
    full, ok = StubBackend(raises=QueueFull("full")), StubBackend(2.0)
    with ServingFrontend(full) as ff, ServingFrontend(ok) as fo:
        with Router([ff.url, fo.url], transport=transport) as r:
            rejected = 0
            for _ in range(6):
                ok_before = ok.calls
                try:
                    r.predict(images(1), priority="bulk")
                except QueueFull:
                    rejected += 1
                    assert ok.calls == ok_before  # no second replica asked
            assert rejected >= 1
            for _ in range(6):  # interactive spills to the other replica
                out = r.predict(images(1), priority="interactive")
                assert float(out[0, 0]) == 2.0
            assert r.stats["rejected"] == rejected
            assert r.stats["evictions"] == 0  # a 429 is no replica damage


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_hedge_resends_the_full_frame(transport):
    dead = StubBackend(raises=RuntimeError("boom"))  # 500 every time
    ok = StubBackend(tag=3.0)
    with ServingFrontend(dead) as fd, ServingFrontend(ok) as fo:
        with Router([fd.url, fo.url], fail_after=100,
                    transport=transport) as r:
            x = images(256, seed=31)  # 786 KiB: many socket reads
            for _ in range(4):
                out = r.predict(x)
                assert out.shape == (256, 10) and float(out[0, 0]) == 3.0
            assert r.stats["hedged"] >= 1 and r.stats["failed"] == 0
    # every frame either replica decoded carried all 256 rows
    assert set(ok.seen_rows) == {256} and set(dead.seen_rows) == {256}


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_stale_connection_retry_resends_the_frame(transport):
    stub = StubBackend(tag=5.0)
    fe = ServingFrontend(stub).start()
    port = fe.port
    r = Router([fe.url], fail_after=100, transport=transport)
    fe2 = None
    try:
        x = images(7, seed=32)
        assert float(r.predict(x)[0, 0]) == 5.0  # a kept-alive connection
        fe.stop()
        fe2 = ServingFrontend(stub, port=port).start()
        out = r.predict(x)  # stale connection -> reconnect -> full frame
        assert out.shape == (7, 10) and float(out[0, 0]) == 5.0
        assert stub.seen_rows == [7, 7]
        assert r.stats["replica_errors"] == 0
    finally:
        r.stop()
        if fe2 is not None:
            fe2.stop()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_model_aware_dispatch_and_404(transport):
    a, b = ZooStub(1.0, ["ModelA"]), ZooStub(2.0, ["ModelB"])
    with ServingFrontend(a) as fa, ServingFrontend(b) as fb:
        with Router([fa.url, fb.url], transport=transport) as r:
            assert r.probe_once() == 2  # the models lists are cached
            for _ in range(3):
                assert float(r.predict(images(1), model="ModelA")[0, 0]) == 1
                assert float(r.predict(images(1), model="ModelB")[0, 0]) == 2
            with pytest.raises(UnknownModel):
                r.predict(images(1), model="ModelC")
            assert r.stats["hedged"] == 0  # routing, not retrying


def test_router_needs_a_replica_and_a_known_transport():
    with pytest.raises(ValueError):
        Router([])
    with pytest.raises(ValueError):
        Router(["http://127.0.0.1:1"], transport="carrier-pigeon")
    with pytest.raises(ValueError):
        Router(["ftp://127.0.0.1:1"])


def test_logits_pass_through_unchanged():
    """The router re-frames nothing: the replica's float32 bytes are the
    caller's, -0.0 and denormals included."""

    class Exact(StubBackend):
        def predict(self, images, deadline_ms=None, priority="interactive"):
            out = np.full((images.shape[0], 10), 1e-45, np.float32)
            out[:, 1] = -0.0
            out[:, 2] = np.float32(3.4028235e38)
            return out

    with ServingFrontend(Exact()) as fe, Router([fe.url]) as r:
        out = r.predict(images(2))
        want = Exact().predict(images(2))
        assert out.tobytes() == want.tobytes()


class RecordingCanary:
    """A promotion controller's tee surface: records ``offer`` calls."""

    class engine:  # noqa: N801 - the controller's engine attribute
        model_name = "ResNet18"

    def __init__(self):
        self.offers = []

    def offer(self, images, incumbent_logits, priority="interactive"):
        self.offers.append((images.shape[0], float(incumbent_logits[0, 0]),
                            priority))
        return True

    def status(self):
        return {"state": "shadowing", "offers": len(self.offers)}


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_attach_shadow_tees_answered_requests_of_its_model(transport):
    ok = ZooStub(3.0, ["ResNet18", "LeNet"])
    full = StubBackend(raises=QueueFull("full"))
    canary = RecordingCanary()
    with ServingFrontend(ok) as fo, ServingFrontend(full) as ff:
        with Router([fo.url], transport=transport) as r:
            assert "canary" not in r.health()
            r.attach_shadow(canary)
            r.predict(images(2))
            r.predict(images(3), priority="bulk", model="ResNet18")
            r.predict(images(1), model="LeNet")  # another tenant's
            assert canary.offers == [(2, 3.0, "interactive"),
                                     (3, 3.0, "bulk")]
            assert r.health()["canary"] == {"state": "shadowing",
                                            "offers": 2}
            r.attach_shadow(None)
            r.predict(images(1))
            assert len(canary.offers) == 2 and "canary" not in r.health()
        with Router([ff.url], transport=transport) as r:
            r.attach_shadow(canary)
            with pytest.raises(QueueFull):
                r.predict(images(1), priority="bulk")
            assert len(canary.offers) == 2  # a refused request is not teed
