"""The port's multi-tenant zoo server (``serve/tenancy.py``) against the
JAX package's, one case per ``tests/test_tenancy.py`` test and beside them
the JAX quirks the port carries over.

Both packages serve the same checkpoint files: one JAX-written v2
checkpoint dir per tenant (LeNet and MobileNet, every leaf drawn from a
seed, ``tests/_torch_ckpt.py``), fp32 on the CPU at buckets (1, 4), as the
JAX tests use. A zoo tenant answers bit for bit as a dedicated port engine
on the same checkpoint, and within rtol 1e-4 of the JAX engine. The JAX
zoo is an oracle only where it is first shown to answer with its
dedicated engine's bits (``aot_cache_dir=None``; the JAX tenancy tests'
shared AOT cache fails on XLA:CPU).

These zoos run without a cold-start cache (``tests/test_torch_aot_cache.py``
holds the zoo on one): a re-admission rebuilds and warms its buckets
(``compiles`` counts them again, ``aot_cache_hits`` is 0), and the bar is
the logits, bit for bit across evict -> re-admit. An evicted
tenant's engine is garbage the moment it is evicted (a weak reference to
it dies without a collection): nothing keeps its weights on the device.
"""

import json
import os
import threading
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu import serve as jax_serve
from pytorch_cifar_tpu.serve.tenancy import ModelZooServer as JaxZoo
from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch import faults
from pytorch_cifar_tpu_torch.models import MODEL_REGISTRY
from pytorch_cifar_tpu_torch.serve import (
    CanaryBudget,
    GoldenSet,
    InferenceEngine,
    ModelZooServer,
    TenantSpec,
    UnknownModel,
    load_cost_priors,
    run_load,
    tenancy,
    zipf_mix,
)
from pytorch_cifar_tpu_torch.serve.tenancy import COST_PRIORS_PATH
from pytorch_cifar_tpu_torch.train.checkpoint import (
    ensure_staging_dir,
    is_quarantined,
)
from _torch_ckpt import jax_state
from _torch_threads import torch_threads  # noqa: F401

MODELS = ("LeNet", "MobileNet")
BUCKETS = (1, 4)
PORT_KW = {"compute_dtype": torch.float32, "device": "cpu"}


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


def _write(out_dir, model, seed, epoch=1, best_acc=10.0):
    """A JAX-written v2 checkpoint of ``model`` with every leaf drawn from
    ``seed``."""
    jax_ckpt.save_checkpoint(str(out_dir), jax_state(model, seed),
                             epoch=epoch, best_acc=best_acc)
    return str(out_dir)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_ckpts")
    return {m: _write(root / m, m, seed=i) for i, m in enumerate(MODELS)}


def _specs(ckpts, **kw):
    return [TenantSpec(m, ckpts[m], buckets=BUCKETS, **kw) for m in MODELS]


def _zoo(ckpts, specs=None, **kw):
    return ModelZooServer(specs if specs is not None else _specs(ckpts),
                          **PORT_KW, **kw)


@pytest.fixture(scope="module")
def dedicated(ckpts):
    """Dedicated port engines on the same checkpoints: the bit oracles."""
    return {m: InferenceEngine.from_checkpoint(ckpts[m], m, buckets=BUCKETS,
                                               **PORT_KW)
            for m in MODELS}


# -- routing ------------------------------------------------------------


def test_zoo_predict_bit_identical_to_dedicated(ckpts, dedicated):
    """Every tenant answers bit for bit as a dedicated port engine, by
    model id and (the first tenant) through the default route, and within
    rtol 1e-4 of the JAX engine on the same checkpoint."""
    x = _images(3, seed=1)
    with _zoo(ckpts) as zoo:
        for m in MODELS:
            got = zoo.predict(x, model=m)
            assert np.array_equal(got, dedicated[m].predict(x)), m
            jeng = jax_serve.InferenceEngine.from_checkpoint(
                ckpts[m], m, buckets=BUCKETS, compute_dtype=jnp.float32)
            np.testing.assert_allclose(got, jeng.predict(x), rtol=1e-4,
                                       atol=1e-5)
        assert zoo.default_model == MODELS[0]
        assert np.array_equal(zoo.predict(x), dedicated[MODELS[0]].predict(x))


def test_zoo_matches_jax_zoo_on_shared_checkpoints(ckpts):
    """The JAX zoo without its AOT cache answers with its dedicated
    engine's bits; the port's zoo agrees with it within rtol 1e-4 and
    reports the same health and stats keys."""
    x = _images(3, seed=2)
    jspecs = [jax_serve.TenantSpec(m, ckpts[m], buckets=BUCKETS)
              for m in MODELS]
    jzoo = JaxZoo(jspecs, compute_dtype=jnp.float32, aot_cache_dir=None,
                  cost_priors={})
    try:
        with _zoo(ckpts, cost_priors={}) as zoo:
            for m in MODELS:
                want = jzoo.predict(x, model=m)
                jeng = jax_serve.InferenceEngine.from_checkpoint(
                    ckpts[m], m, buckets=BUCKETS, compute_dtype=jnp.float32)
                assert np.array_equal(want, jeng.predict(x)), m
                np.testing.assert_allclose(zoo.predict(x, model=m), want,
                                           rtol=1e-4, atol=1e-5)
            jh, h = jzoo.health(), zoo.health()
            assert set(h) == set(jh)
            for m in MODELS:
                assert set(h["tenants"][m]) == set(jh["tenants"][m])
                assert h["tenants"][m]["est_bytes"] == \
                    jh["tenants"][m]["est_bytes"]
            assert h["resident"] == jh["resident"]
            assert set(zoo.stats) == set(jzoo.stats)
    finally:
        jzoo.close()


def test_unknown_model_raises_and_counts(ckpts):
    with _zoo(ckpts) as zoo:
        with pytest.raises(UnknownModel):
            zoo.predict(_images(1), model="NoSuchNet")
        with pytest.raises(UnknownModel):
            zoo.submit(_images(1), model="AlsoNot")
        assert zoo.stats["unknown_model"] == 2
        assert zoo.obs.summary()["serve.zoo.unknown_model"] == 2.0
    with pytest.raises(KeyError):
        TenantSpec("NoSuchNet")


def test_tenant_spec_parse_grammar():
    spec = TenantSpec.parse("LeNet=/tmp/somewhere")
    assert spec.name == "LeNet" and spec.ckpt == "/tmp/somewhere"
    spec = TenantSpec.parse("  MobileNet  ")
    assert spec.name == "MobileNet" and spec.ckpt is None
    # the same grammar and defaults as the JAX spec
    j = jax_serve.TenantSpec.parse(" LeNet = /x ")
    p = TenantSpec.parse(" LeNet = /x ")
    assert vars(p) == vars(j)


# -- placement / eviction ----------------------------------------------


def test_evict_readmit_bit_identical_and_engine_freed(ckpts):
    """A max_resident=1 zoo alternating two tenants evicts and re-admits
    on every switch: the re-admitted tenant's logits equal its first
    admission's bit for bit; the re-admission warmed its buckets again (no
    cold-start cache); the evicted engine is freed at once."""
    with _zoo(ckpts, max_resident=1) as zoo:
        x = _images(5, seed=2)  # off-bucket: padding rides the cycle too
        first, refs = {}, {}
        for m in MODELS:
            first[m] = zoo.predict(x, model=m)
            refs[m] = weakref.ref(zoo._tenants[m].engine)
        assert zoo.stats["evictions"] >= 1
        assert refs[MODELS[0]]() is None  # evicted: nothing holds it
        again = {m: zoo.predict(x, model=m) for m in MODELS}
        for m in MODELS:
            assert np.array_equal(first[m], again[m]), m
        assert refs[MODELS[1]]() is None
        h = zoo.health()["tenants"]
        for m in MODELS:
            assert h[m]["evictions"] >= 1, m
        resident = [m for m in MODELS if h[m]["resident"]]
        assert len(resident) == 1
        assert h[resident[0]]["admissions"] >= 2
        assert h[resident[0]]["compiles"] == len(BUCKETS)
        assert h[resident[0]]["aot_cache_hits"] == 0


def test_cost_prior_seeded_placement_and_eviction(ckpts):
    """Priors drive placement: with one slot, eager placement admits the
    COSTLIEST model (lowest img/s), and the first eviction takes the
    cheapest; real traffic overrides the seed."""
    priors = {"LeNet": 100_000.0, "MobileNet": 1_000.0}
    with _zoo(ckpts, max_resident=1, cost_priors=priors) as zoo:
        assert zoo.health()["resident"] == ["MobileNet"]
        zoo.predict(_images(1), model="LeNet")
        assert zoo.health()["resident"] == ["LeNet"]
        zoo.predict(_images(1), model="MobileNet")
        assert zoo.health()["resident"] == ["MobileNet"]
    with _zoo(ckpts, cost_priors=priors) as zoo:
        # both resident, MobileNet admitted first (costliest first)
        order = sorted(MODELS, key=lambda m: zoo._tenants[m].last_used)
        assert order == ["LeNet", "MobileNet"]


def test_memory_budget_bounds_resident_set(ckpts):
    """The byte budget bounds the resident set like max_resident: room for
    one tenant's estimate only (LeNet ~0.5 MB, MobileNet ~13 MB
    estimated) keeps one resident."""
    with _zoo(ckpts, memory_budget_mb=2.0) as zoo:
        zoo.predict(_images(1), model="LeNet")
        zoo.predict(_images(1), model="MobileNet")
        h = zoo.health()
        assert len(h["resident"]) == 1
        assert h["memory_budget_bytes"] == 2 * 1024 * 1024
        assert zoo.stats["evictions"] >= 1
        assert zoo.obs.summary()["serve.zoo.memory_budget_bytes.value"] == \
            2.0 * 1024 * 1024


def test_concurrent_admission_builds_once(ckpts):
    """Threads racing a non-resident tenant: ONE pays the build, the
    others wait on the condition; every answer is the same."""
    with _zoo(ckpts, eager=False) as zoo:
        x = _images(2, seed=3)
        outs, errs = [None] * 4, []

        def hit(i):
            try:
                outs[i] = zoo.predict(x, model="LeNet")
            except Exception as e:  # pragma: no cover - fail loudly below
                errs.append(e)

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        assert all(np.array_equal(outs[0], o) for o in outs[1:])
        assert zoo.health()["tenants"]["LeNet"]["admissions"] == 1


def test_eviction_drains_admitted_requests(ckpts):
    """Eviction is a drain, not a drop: requests admitted before churn are
    answered from the old engine."""
    with _zoo(ckpts, max_resident=1) as zoo:
        x = _images(3, seed=4)
        futs = [zoo.submit(x, model="LeNet") for _ in range(4)]
        zoo.predict(_images(1), model="MobileNet")  # forces churn
        want = None
        for f in futs:
            out = f.result(timeout=60)
            want = out if want is None else want
            assert np.array_equal(out, want)
        assert zoo.stats["evictions"] >= 1


@pytest.mark.parametrize("churns", [1, 2, 3])
def test_submit_survives_eviction_after_each_admission(ckpts, dedicated,
                                                       churns):
    """Churn between a tenant's admission and the enqueue of a request is
    never a client error, however often it strikes: the request re-admits
    the tenant and is answered with its bits. (The JAX zoo retries once
    and raises BatcherClosed from the second eviction on.)"""
    with _zoo(ckpts, eager=False) as zoo:
        real, left = zoo._ensure_resident, [churns]

        def churned(name, touch=True):
            tenant = real(name, touch)
            if left[0] > 0:  # another admission evicts it right here
                left[0] -= 1
                with zoo._cond:
                    tenant.state = tenancy.EVICTING
                zoo._evict(tenant)
            return tenant

        zoo._ensure_resident = churned
        x = _images(3, seed=5)
        out = zoo.predict(x, model="LeNet")
        assert np.array_equal(out, dedicated["LeNet"].predict(x))
        h = zoo.health()["tenants"]["LeNet"]
        assert h["admissions"] == churns + 1
        assert h["evictions"] == churns


# -- SLOs, health, metrics ---------------------------------------------


def test_per_tenant_slo_deadline_configures_queue(ckpts):
    specs = [
        TenantSpec("LeNet", ckpts["LeNet"], buckets=BUCKETS,
                   deadline_ms=123.0),
        TenantSpec("MobileNet", ckpts["MobileNet"], buckets=BUCKETS,
                   deadline_ms=456.0),
    ]
    with _zoo(ckpts, specs=specs) as zoo:
        zoo.predict(_images(1), model="LeNet")
        zoo.predict(_images(1), model="MobileNet")
        assert zoo._tenants["LeNet"].batcher.default_deadline_ms == 123.0
        assert zoo._tenants["MobileNet"].batcher.default_deadline_ms == 456.0
        h = zoo.health()["tenants"]
        assert h["LeNet"]["deadline_ms"] == 123.0
        assert h["MobileNet"]["deadline_ms"] == 456.0


def test_health_and_per_model_metrics(ckpts):
    with _zoo(ckpts) as zoo:
        zoo.predict(_images(2), model="MobileNet")
        h = zoo.health()
        assert h["status"] == "ok" and h["role"] == "zoo"
        assert h["models"] == sorted(MODELS)
        assert set(h["resident"]) == set(MODELS)
        assert h["max_resident"] == len(MODELS)
        assert h["memory_bytes"] > 0
        t = h["tenants"]["MobileNet"]
        assert t["resident"] and t["engine_version"] == 0
        assert t["ckpt_epoch"] == 1
        assert t["buckets"] == list(BUCKETS)
        assert t["queued"] == {"interactive": 0, "bulk": 0}
        s = zoo.obs.summary()
        assert s.get("serve.tenant.MobileNet.requests") == 1.0
        assert s.get("serve.tenant.MobileNet.images") == 2.0
        assert s.get("serve.zoo.resident.max") == float(len(MODELS))
        assert s.get("serve.zoo.admission_ms.count", 0) >= 2
        assert s.get("serve.tenant.LeNet.admissions") == 1.0


# -- per-tenant hot reload + canary isolation --------------------------


def test_per_tenant_hot_reload_swaps_one_tenant(ckpts, tmp_path):
    """A republished checkpoint swaps into ITS tenant only: the watched
    tenant's generation bumps and its answers change to the new
    checkpoint's; the other tenant's bits never move."""
    live = _write(tmp_path / "lenet_live", "LeNet", seed=0, epoch=1)
    specs = [
        TenantSpec("LeNet", live, buckets=BUCKETS, watch=True,
                   poll_s=600.0),
        TenantSpec("MobileNet", ckpts["MobileNet"], buckets=BUCKETS),
    ]
    with _zoo(ckpts, specs=specs) as zoo:
        x = _images(3, seed=5)
        before = zoo.predict(x, model="LeNet")
        mobile_before = zoo.predict(x, model="MobileNet")
        _write(tmp_path / "lenet_live", "LeNet", seed=9, epoch=2,
               best_acc=20.0)
        watcher = zoo._tenants["LeNet"].watcher
        assert watcher is not None and watcher.poll_once() is True
        after = zoo.predict(x, model="LeNet")
        assert not np.array_equal(before, after)
        want = InferenceEngine.from_checkpoint(live, "LeNet", buckets=BUCKETS,
                                               **PORT_KW).predict(x)
        assert np.array_equal(after, want)
        h = zoo.health()["tenants"]
        assert h["LeNet"]["engine_version"] == 1
        assert h["LeNet"]["ckpt_epoch"] == 2
        assert h["LeNet"]["reloads"] == 1
        assert h["MobileNet"]["engine_version"] == 0
        assert np.array_equal(zoo.predict(x, model="MobileNet"),
                              mobile_before)


def test_per_tenant_canary_quarantines_without_touching_others(ckpts,
                                                               tmp_path):
    """A NaN candidate for one tenant is quarantined by that tenant's own
    controller: it keeps serving its incumbent bits and the other
    tenant's answers and generation never move."""
    live = _write(tmp_path / "lenet_live", "LeNet", seed=0)
    staging = ensure_staging_dir(live)
    specs = [TenantSpec("LeNet", live, buckets=BUCKETS),
             TenantSpec("MobileNet", ckpts["MobileNet"], buckets=BUCKETS)]
    with _zoo(ckpts, specs=specs) as zoo:
        x = _images(3, seed=6)
        lenet_pre = zoo.predict(x, model="LeNet")
        mobile_pre = zoo.predict(x, model="MobileNet")
        ctl = zoo.enable_canary("LeNet", staging,
                                golden=GoldenSet.random(16, seed=3),
                                budget=CanaryBudget(max_flip_frac=1.0))
        try:
            _write(staging, "LeNet", seed=3, epoch=2, best_acc=50.0)
            faults.regress_checkpoint(staging, nan=True)
            assert ctl.poll_once() == "quarantined"
            assert is_quarantined(staging, "ckpt.msgpack")
            assert np.array_equal(zoo.predict(x, model="LeNet"), lenet_pre)
            assert np.array_equal(zoo.predict(x, model="MobileNet"),
                                  mobile_pre)
            h = zoo.health()["tenants"]
            assert h["LeNet"]["canary"]["state"] == "quarantined"
            assert h["LeNet"]["canary"]["rejected"] == 1
            assert h["MobileNet"]["engine_version"] == 0
            assert "canary" not in h["MobileNet"]
        finally:
            ctl.stop()


# -- loadgen surface ----------------------------------------------------


def test_run_load_model_mix_over_zoo(ckpts):
    with _zoo(ckpts) as zoo:
        rep = run_load(zoo, clients=3, requests_per_client=4, images_max=3,
                       seed=7, model_mix=zipf_mix(list(MODELS)))
        assert rep["failed"] == 0 and rep["requests"] == 12
        assert set(rep["per_model"]) == set(MODELS)
        assert sum(rep["per_model"].values()) == 12
        assert rep["per_model"][MODELS[0]] >= rep["per_model"][MODELS[1]]
        s = zoo.obs.summary()
        assert sum(s.get(f"serve.tenant.{m}.requests", 0.0)
                   for m in MODELS) == 12.0


# -- the cost priors ----------------------------------------------------


def test_cost_priors_are_the_cards_sweep():
    """The committed priors: the sweep of every registry name on an H100
    (the file names the card and its power limit), never a TPU number. A
    model whose sweep failed keeps its error and has no prior (it sorts
    as costliest, as an unknown prior does)."""
    with open(COST_PRIORS_PATH) as f:
        sweep = json.load(f)
    assert sweep["platform"] == "gpu"
    assert "H100" in sweep["card"] and sweep["card"].endswith("W")
    assert set(sweep["results"]) == set(MODEL_REGISTRY)
    priors = load_cost_priors()
    for name, entry in sweep["results"].items():
        assert ("images_per_sec" in entry) != ("error" in entry), name
        if "error" in entry:
            assert name not in priors
        else:
            assert entry["batch"] == 512
            assert priors[name] == entry["images_per_sec"] > 0
    assert len(priors) >= 40
    assert set(MODELS) <= set(priors)
    assert os.path.dirname(COST_PRIORS_PATH).endswith(
        os.path.join("pytorch_cifar_tpu_torch", "tools"))


def test_load_cost_priors_missing_or_unreadable_file(tmp_path):
    assert load_cost_priors(str(tmp_path / "absent.json")) == {}
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert load_cost_priors(str(bad)) == {}


# -- the JAX quirks carried over ---------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_estimate_counts_raw_float_avals_even_for_int8(ckpts, model):
    """``_estimate_bytes`` is JAX's: the raw float avals doubled, so an
    int8 tenant is estimated as a float one; the number equals the JAX
    zoo's for the same model."""
    est = {}
    for int8 in (False, True):
        with _zoo(ckpts, specs=[TenantSpec(model, ckpts[model],
                                           buckets=(1,))],
                  int8=int8) as zoo:
            t = zoo._tenants[model]
            assert t.engine.int8 is int8
            est[int8] = t.est_bytes
    assert est[True] == est[False] > 0
    jeng = type("E", (), {"_raw_avals": (
        jax_serve.InferenceEngine._avals(jax_state(model).params),
        jax_serve.InferenceEngine._avals(jax_state(model).batch_stats))})
    assert est[False] == JaxZoo._estimate_bytes(None, jeng)


def test_int8_zoo_canary_engine_is_float_and_tenant_host_is_float(ckpts,
                                                                  tmp_path):
    """``enable_canary`` builds the tenant's canary engine without int8,
    as JAX does, even in an int8 zoo; an int8 tenant's ``weights_host``
    is the float originals."""
    live = _write(tmp_path / "lenet_live", "LeNet", seed=0)
    staging = ensure_staging_dir(live)
    with _zoo(ckpts, specs=[TenantSpec("LeNet", live, buckets=BUCKETS)],
              int8=True) as zoo:
        eng = zoo._tenants["LeNet"].engine
        assert eng.int8
        host = eng.weights_host()
        assert all(v.dtype != np.int8 for v in host.values())
        ctl = zoo.enable_canary("LeNet", staging,
                                golden=GoldenSet.random(8, seed=3))
        try:
            assert ctl.engine.int8 is False
        finally:
            ctl.stop()
