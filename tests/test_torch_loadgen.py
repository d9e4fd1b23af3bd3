"""The port's load generators against the JAX package's ``loadgen``.

- ``run_load`` at the default arguments (and with a bulk share, a model
  mix, other sizes) draws the same request sizes, pixels, priorities and
  models per client as JAX's for a seed, and counts retries, hedges and
  failures alike on the same scripted answers;
- ``zipf_mix`` and the request bodies both packages put on the wire are
  equal;
- ``run_async_load`` through a port frontend (threaded or event, every
  wire) answers every request, and its report has ``run_load``'s keys;
- the module's ``main`` prints one JSON line.
"""

import json
import threading

import pytest

from pytorch_cifar_tpu.serve import batcher as jax_batcher
from pytorch_cifar_tpu.serve import loadgen as jax_loadgen
from pytorch_cifar_tpu_torch.serve import (
    BatcherBackend,
    EdgeFrontend,
    MicroBatcher,
    ServingFrontend,
    batcher,
    loadgen,
)
from _torch_threads import torch_threads  # noqa: F401
from _torch_wire import images, lenet_engine


class Recorder:
    """A submit target that records each client's requests (by the
    loadgen thread's name) and answers at once, or raises the scripted
    exception of the module ``exc`` every ``every``-th call."""

    def __init__(self, exc=None, every=0):
        self.exc = exc
        self.every = every
        self.lock = threading.Lock()
        self.seen = {}
        self.calls = 0

    def submit(self, x, priority="interactive", model=None):
        with self.lock:
            self.calls += 1
            k = self.calls
            self.seen.setdefault(threading.current_thread().name, []).append(
                (x.shape, x.tobytes(), priority, model))
        if self.every and k % self.every == 0:
            raise self.exc.DeadlineExceeded("late")
        if self.every and k % self.every == 1 and k > 1:
            raise self.exc.QueueFull("full")
        return self

    def result(self, timeout=None):
        return None


LOADS = {
    "default": {},
    "sizes": dict(clients=3, requests_per_client=5, images_min=2,
                  images_max=5, seed=7),
    "bulk": dict(clients=2, requests_per_client=8, bulk_fraction=0.5,
                 seed=3),
    "mix": dict(clients=2, requests_per_client=6, seed=1,
                model_mix=jax_loadgen.zipf_mix(["LeNet", "VGG16", "DPN26"])),
}


@pytest.mark.parametrize("name", sorted(LOADS))
def test_run_load_draws_equal_jax(name):
    kw = LOADS[name]
    ours, theirs = Recorder(), Recorder()
    rep = loadgen.run_load(ours, **kw)
    jrep = jax_loadgen.run_load(theirs, **kw)
    assert ours.seen == theirs.seen and ours.seen
    assert sorted(rep) == sorted(jrep)
    for k in ("requests", "images", "bulk_requests", "per_model"):
        assert rep.get(k) == jrep.get(k), k


@pytest.mark.parametrize("hedge", [True, False])
def test_retries_and_hedges_counted_as_jax(hedge):
    kw = dict(clients=1, requests_per_client=12, hedge=hedge,
              retry_backoff_s=0.0)
    rep = loadgen.run_load(Recorder(batcher, every=4), **kw)
    jrep = jax_loadgen.run_load(Recorder(jax_batcher, every=4), **kw)
    for k in ("requests", "images", "rejected", "hedged", "failed"):
        assert rep[k] == jrep[k], k
    assert rep["rejected"] > 0
    if hedge:
        assert rep["hedged"] > 0
    else:
        assert rep["hedged"] == 0 and rep["failed"] > 0


@pytest.mark.parametrize("s", [0.8, 1.2])
def test_zipf_mix_equal_jax(s):
    models = ["LeNet", "ResNet18", "VGG16", "MobileNet"]
    priors = {"LeNet": 9e4, "VGG16": 3e4, "ResNet18": 2e4}
    assert loadgen.zipf_mix(models, s=s) == jax_loadgen.zipf_mix(models, s=s)
    assert loadgen.zipf_mix(models, s=s, priors=priors) == \
        jax_loadgen.zipf_mix(models, s=s, priors=priors)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("args", [
    (None, "interactive", None), (250.0, "bulk", None),
    (0.0, "interactive", "LeNet"), (12.5, "bulk", "VGG16"),
])
def test_request_bodies_equal_jax(args, binary):
    x = images(3, seed=2)
    assert loadgen._encode_predict_body(x, *args, binary) == \
        jax_loadgen._encode_predict_body(x, *args, binary)


def test_percentile_equal_jax():
    xs = [float(v) for v in range(1, 101)] + [0.5, 1e4]
    for pct in (0, 1, 50, 95, 99, 100):
        assert loadgen.percentile_ms(xs, pct) == \
            jax_loadgen.percentile_ms(xs, pct)
    assert loadgen.percentile_ms([], 50) == 0.0


@pytest.fixture(scope="module")
def servers():
    engine = lenet_engine()
    mb = MicroBatcher(engine, max_batch=4, max_wait_ms=1, max_queue=256)
    backend = BatcherBackend(engine, mb)
    fes = {"threaded": ServingFrontend(backend).start(),
           "event": EdgeFrontend(backend).start()}
    yield fes
    for fe in fes.values():
        fe.stop()
    mb.close()


@pytest.mark.parametrize("mode", ["json", "binary", "mixed"])
@pytest.mark.parametrize("edge", ["threaded", "event"])
def test_run_async_load_zero_failures(servers, edge, mode):
    rep = loadgen.run_async_load(
        servers[edge].url, clients=16, requests_per_client=3, images_max=4,
        bulk_fraction=0.25, wire=mode, timeout_s=30, seed=4)
    assert rep["failed"] == 0 and rep["requests"] == 48
    assert rep["images"] > 0 and rep["p99_ms"] >= rep["p50_ms"] > 0
    assert sorted(rep) == sorted(loadgen.run_load(
        Recorder(), clients=1, requests_per_client=1))


def test_main_prints_one_json_line(servers, capsys):
    assert loadgen.main(["--url", servers["event"].url, "--clients", "4",
                         "--requests", "2", "--wire", "binary"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["harness"] == "loadgen_async"
    assert rec["failed"] == 0 and rec["requests"] == 8
