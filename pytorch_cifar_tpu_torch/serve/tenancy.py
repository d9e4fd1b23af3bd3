"""Multi-tenant model-zoo serving: one process, N models, uneven traffic.

The port's counterpart of ``pytorch_cifar_tpu/serve/tenancy.py``.
:class:`ModelZooServer` hosts N named models of the registry, one
:class:`~.engine.InferenceEngine` + :class:`~.batcher.MicroBatcher` pair
per RESIDENT model, under a shared weight-memory budget. Everything the
single-model stack guarantees (fixed buckets, bit-exact padding, priority
lanes, deadlines, hot reload, canary promotion) is reused per tenant,
unchanged; what this module adds is the multiplexing above it:

- **Placement/eviction: cost-prior-seeded LRU under a budget.** The
  resident set is bounded two ways: ``max_resident`` (tenant count) and
  ``memory_budget_mb`` (estimated weight bytes, from each engine's raw
  ``state_dict`` avals at admission). A request for a non-resident model
  evicts until the newcomer fits and admits it. The victim is the
  least-recently-USED resident; before any traffic has touched a tenant,
  recency is seeded from the per-model train img/s priors
  (:data:`COST_PRIORS_PATH`, measured on the card by
  ``tools/zoo_bench.py``): the CHEAPEST models (highest img/s) evict first,
  and eager placement at construction admits the costliest first.
- **Eviction is a drain, not a drop.** The victim's watcher stops, its
  batcher drains (every admitted request is answered from the old
  engine), and only then is its engine dropped, which frees its weights
  on the device: nothing else holds a reference to it.
- **Re-admission rebuilds.** The port has no cold-start cache yet: a
  re-admitted tenant loads, folds and warms its buckets again
  (``compile_count`` counts those warm-ups again, ``aot_cache_hits`` stays
  0). Its logits are bit for bit those of its first admission.
- **Per-model admission queues and SLOs.** Each tenant owns its own
  bounded-queue micro-batcher, with the tenant's ``deadline_ms`` as its
  default queue-time bound.
- **Per-model hot reload and canary promotion.** A tenant with a
  checkpoint dir gets its own :class:`~.reload.CheckpointWatcher`
  (``watch=True``), and :meth:`ModelZooServer.enable_canary` attaches a
  dedicated :class:`~.canary.PromotionController` with its own canary
  engine, so one model's bad candidate is quarantined without touching
  the other tenants.
- **Routing.** Requests carry a model id (the JSON ``model`` field or the
  wire-v2 frame field); an unknown id raises :class:`UnknownModel`, which
  the HTTP frontend maps to 404. Requests naming no model go to
  ``default_model``.

Thread-safety: one condition (``_cond``) guards tenant state and the LRU
clock. Everything expensive (engine construction and warm-up, the batcher
drain, the predict itself) runs outside it; concurrent requests for a
model mid-(re)admission wait on the condition in a while-predicate loop.

``python -m pytorch_cifar_tpu_torch.serve --models A,B,...`` runs one zoo.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from pytorch_cifar_tpu_torch.obs import MetricsRegistry, trace
from pytorch_cifar_tpu_torch.serve.batcher import BatcherClosed, MicroBatcher
from pytorch_cifar_tpu_torch.serve.engine import InferenceEngine
from pytorch_cifar_tpu_torch.serve.reload import CheckpointWatcher

log = logging.getLogger(__name__)

# tenant residency states (one word each; _cond guards transitions):
#   resident — engine + batcher live, serving
#   loading  — claimed by one admitting thread; others wait on _cond
#   evicting — drain in progress; waiters treat it like loading
#   evicted  — engine dropped; the next request re-admits
RESIDENT = "resident"
LOADING = "loading"
EVICTING = "evicting"
EVICTED = "evicted"

COST_PRIORS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tools", "zoo_sweep_h100.json",
)


class UnknownModel(LookupError):
    """A request named a model this server does not host — the HTTP
    frontend maps this to 404 (the request was well-formed; the tenant
    is absent). Deliberately NOT a ValueError: the frontend's 400
    mapping must never swallow it."""


def load_cost_priors(path: str = COST_PRIORS_PATH) -> Dict[str, float]:
    """Per-model img/s priors from the zoo sweep (``results.<model>.
    images_per_sec``). Missing/unreadable file -> {} — priors only seed
    the LRU clock and placement order; real traffic overrides them."""
    try:
        with open(path) as f:
            sweep = json.load(f)
        return {
            name: float(entry["images_per_sec"])
            for name, entry in sweep.get("results", {}).items()
            if isinstance(entry, dict) and "images_per_sec" in entry
        }
    except (OSError, ValueError, TypeError):
        return {}


class TenantSpec:
    """One tenant's static configuration. ``ckpt`` is a trainer's output
    dir / ``.msgpack`` / reference ``.pth`` (the engine loader's full
    menu); None serves seeded random weights at ``seed`` (drawn from
    torch's generator: identical across the port's processes).
    ``deadline_ms`` is the tenant's SLO budget: the default queue-time
    bound of its admission queue (per-request ``deadline_ms`` still
    overrides)."""

    def __init__(
        self,
        name: str,
        ckpt: Optional[str] = None,
        *,
        buckets: Sequence[int] = (1, 8, 32),
        num_classes: int = 10,
        deadline_ms: float = 0.0,
        max_batch: int = 0,
        max_wait_ms: float = 2.0,
        max_queue: int = 1024,
        bulk_share: float = 0.5,
        watch: bool = False,
        poll_s: float = 1.0,
        seed: int = 0,
    ):
        from pytorch_cifar_tpu_torch.models import MODEL_REGISTRY

        if name not in MODEL_REGISTRY:
            raise KeyError(
                f"unknown model {name!r}; available: "
                f"{sorted(MODEL_REGISTRY)}"
            )
        self.name = name
        self.ckpt = ckpt
        self.buckets = tuple(buckets)
        self.num_classes = int(num_classes)
        self.deadline_ms = float(deadline_ms)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.bulk_share = float(bulk_share)
        self.watch = bool(watch)
        self.poll_s = float(poll_s)
        self.seed = int(seed)

    @classmethod
    def parse(cls, text: str, **kw) -> "TenantSpec":
        """``"Name"`` or ``"Name=ckpt_dir"`` — the ``--models`` CLI
        grammar."""
        name, _, ckpt = text.strip().partition("=")
        return cls(name.strip(), ckpt.strip() or None, **kw)


class _Tenant:
    """Runtime state for one zoo tenant. Mutable fields are guarded by
    the server's condition (module docstring)."""

    def __init__(self, spec: TenantSpec, prior: float):
        self.spec = spec
        self.prior = prior  # img/s cost prior (0.0 = unknown)
        self.state = EVICTED
        self.engine: Optional[InferenceEngine] = None
        self.batcher: Optional[MicroBatcher] = None
        self.watcher: Optional[CheckpointWatcher] = None
        self.controller = None  # per-tenant canary (enable_canary)
        self.last_used = 0.0  # LRU clock tick; prior-seeded at startup
        self.est_bytes = 0  # weight-bytes estimate, set at admission
        self.admissions = 0
        self.evictions = 0


class ModelZooServer:
    """N named models behind one backend surface (module docstring).

    Implements the serving-backend protocol the HTTP frontend speaks —
    ``predict(images, deadline_ms=..., priority=..., model=...)``,
    ``submit(...)`` (the loadgen surface), ``health()`` and
    ``engine_version`` — so one :class:`~.frontend.ServingFrontend`
    serves a zoo exactly as it serves a single replica or a router.
    Tenant engines run on ``device`` (CUDA unless the caller names
    another).
    """

    # the frontend passes the request's model id through only to
    # backends that declare routing support (frontend.py)
    supports_model_routing = True

    def __init__(
        self,
        specs: Sequence[TenantSpec],
        *,
        max_resident: int = 0,
        memory_budget_mb: float = 0.0,
        default_model: Optional[str] = None,
        compute_dtype=None,
        registry: Optional[MetricsRegistry] = None,
        cost_priors: Optional[Dict[str, float]] = None,
        continuous: bool = True,
        int8: bool = False,
        eager: bool = True,
        device=None,
    ):
        if not specs:
            raise ValueError("need at least one tenant spec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        self.obs = registry if registry is not None else MetricsRegistry()
        self.compute_dtype = compute_dtype
        self.device = device
        self.continuous = bool(continuous)
        self.int8 = bool(int8)
        self.max_resident = int(max_resident) or len(specs)
        self.memory_budget_bytes = int(memory_budget_mb * 1024 * 1024)
        self.default_model = default_model or specs[0].name
        if self.default_model not in names:
            raise ValueError(
                f"default model {self.default_model!r} is not a tenant "
                f"({names})"
            )
        priors = (
            cost_priors if cost_priors is not None else load_cost_priors()
        )
        self._tenants: Dict[str, _Tenant] = {
            s.name: _Tenant(s, float(priors.get(s.name, 0.0)))
            for s in specs
        }
        # ONE condition over tenant states + the LRU clock; every
        # blocking operation (engine build, drain join, predict) runs
        # outside it
        self._cond = threading.Condition()
        self._closed = False
        # LRU clock: a monotonically increasing tick, bumped per touch.
        # Seeding: sort costliest-first (lowest img/s prior; unknown
        # priors sort as costliest — conservatively sticky): rank 0 gets
        # the largest seed tick (evicted LAST), the cheapest model the
        # smallest (first victim before any real traffic)
        self._tick = 0.0
        by_cost = sorted(
            self._tenants.values(),
            key=lambda t: t.prior if t.prior > 0 else -1.0,
        )
        for rank, t in enumerate(by_cost):
            t.last_used = -float(rank + 1)
        self._g_resident = self.obs.gauge("serve.zoo.resident")
        self._g_mem = self.obs.gauge("serve.zoo.memory_bytes")
        self._g_budget = self.obs.gauge("serve.zoo.memory_budget_bytes")
        self._c_admissions = self.obs.counter("serve.zoo.admissions")
        self._c_evictions = self.obs.counter("serve.zoo.evictions")
        self._c_unknown = self.obs.counter("serve.zoo.unknown_model")
        self._h_admission = self.obs.histogram("serve.zoo.admission_ms")
        self._g_budget.set(float(self.memory_budget_bytes))
        # per-model metric families: serve.tenant.{model}.{requests,
        # images,evictions,admissions,admission_ms}
        self._tenant_metrics: Dict[str, dict] = {}
        for name in names:
            self._tenant_metrics[name] = {
                "requests": self.obs.counter(
                    f"serve.tenant.{name}.requests"
                ),
                "images": self.obs.counter(f"serve.tenant.{name}.images"),
                "admissions": self.obs.counter(
                    f"serve.tenant.{name}.admissions"
                ),
                "evictions": self.obs.counter(
                    f"serve.tenant.{name}.evictions"
                ),
                "admission_ms": self.obs.histogram(
                    f"serve.tenant.{name}.admission_ms"
                ),
            }
        if eager:
            # eager placement: admit the COSTLIEST models first (their
            # warm load is the most expensive to pay inside a request)
            # until max_resident; the rest admit lazily on first request
            order = sorted(
                self._tenants.values(), key=lambda t: t.last_used,
                reverse=True,
            )
            for t in order:
                if len(self._resident_names()) >= self.max_resident:
                    break
                try:
                    # touch=False: eager admission keeps the prior-seeded
                    # LRU ticks, so a later over-budget admission evicts
                    # the CHEAPEST eagerly placed tenant, not the first
                    self._ensure_resident(t.spec.name, touch=False)
                except Exception:
                    log.exception(
                        "eager admission of %s failed; tenant stays "
                        "evicted (first request retries)", t.spec.name,
                    )

    # -- introspection ---------------------------------------------------

    def models(self):
        return sorted(self._tenants)

    def _resident_names(self):
        with self._cond:
            return [
                n for n, t in self._tenants.items()
                if t.state in (RESIDENT, LOADING)
            ]

    # -- placement / eviction ------------------------------------------

    def _estimate_bytes(self, engine: InferenceEngine) -> int:
        """Weight-bytes estimate for the budget, as the JAX package
        computes it: the RAW float avals (params and BN statistics; the
        step counters ``num_batches_tracked``, which the JAX trees do not
        carry, are left out), doubled for the host copy + device placement.
        An int8 engine is estimated at its raw avals too. An estimate, not
        an accounting — the budget bounds placement."""
        total = 0
        for key, shape, dtype in engine._raw_avals:
            if key.endswith("num_batches_tracked"):
                continue
            total += int(np.prod(shape or (1,))) * np.dtype(dtype).itemsize
        return 2 * total

    def _set_residency_gauges_locked(self) -> None:
        resident = [
            t for t in self._tenants.values() if t.state == RESIDENT
        ]
        self._g_resident.set(float(len(resident)))
        self._g_mem.set(float(sum(t.est_bytes for t in resident)))

    def _pick_victim_locked(self, protect: str) -> Optional[_Tenant]:
        """Least-recently-used resident tenant other than ``protect``
        (cost-prior seeding makes the pre-traffic order cheapest-first).
        None when nothing is evictable."""
        candidates = [
            t for n, t in self._tenants.items()
            if t.state == RESIDENT and n != protect
        ]
        if not candidates:
            return None
        return min(candidates, key=lambda t: t.last_used)

    def _evict(self, victim: _Tenant) -> None:
        """Drain + drop one tenant's serving pair. Caller has already
        transitioned it to EVICTING under the condition; the drain (a
        worker join) runs OUTSIDE the lock. Afterwards nothing of the
        server holds the engine, so its device memory is freed."""
        name = victim.spec.name
        with trace.span("serve/zoo_evict", model=name):
            if victim.watcher is not None:
                victim.watcher.stop()
            if victim.batcher is not None:
                # drain: every admitted request is answered from the old
                # engine before it drops
                victim.batcher.close(drain=True)
        with self._cond:
            victim.engine = None
            victim.batcher = None
            victim.watcher = None
            victim.state = EVICTED
            victim.evictions += 1
            self._set_residency_gauges_locked()
            self._cond.notify_all()
        self._c_evictions.inc()
        self._tenant_metrics[name]["evictions"].inc()
        log.info("zoo: evicted %s (LRU)", name)

    def _make_room(self, newcomer: _Tenant, new_bytes: int) -> None:
        """Evict LRU tenants until ``newcomer`` fits both budgets. Runs
        outside the condition; each victim is claimed under it."""
        while True:
            with self._cond:
                resident = [
                    t for t in self._tenants.values()
                    if t.state == RESIDENT
                ]
                count_ok = len(resident) < self.max_resident
                mem_ok = (
                    self.memory_budget_bytes <= 0
                    or sum(t.est_bytes for t in resident) + new_bytes
                    <= self.memory_budget_bytes
                )
                if count_ok and mem_ok:
                    return
                victim = self._pick_victim_locked(newcomer.spec.name)
                if victim is None:
                    # nothing evictable (everything else mid-transition):
                    # admit anyway rather than deadlock — the budget is a
                    # placement bound, not a hard allocator
                    log.warning(
                        "zoo: no evictable tenant while admitting %s; "
                        "budget temporarily exceeded",
                        newcomer.spec.name,
                    )
                    return
                victim.state = EVICTING
            self._evict(victim)

    def _engine_kw(self, spec: TenantSpec) -> dict:
        return dict(
            num_classes=spec.num_classes,
            buckets=spec.buckets,
            compute_dtype=self.compute_dtype,
            registry=self.obs,
            device=self.device,
        )

    def _build(self, tenant: _Tenant):
        """Construct one tenant's engine (+ optional watcher) and
        batcher — the expensive part of admission, always outside the
        condition."""
        spec = tenant.spec
        kw = dict(self._engine_kw(spec), int8=self.int8)
        if spec.ckpt:
            engine = InferenceEngine.from_checkpoint(spec.ckpt, spec.name,
                                                     **kw)
        else:
            engine = InferenceEngine.from_random(spec.name, seed=spec.seed,
                                                 **kw)
        batcher = MicroBatcher(
            engine,
            max_batch=spec.max_batch or None,
            max_wait_ms=spec.max_wait_ms,
            max_queue=spec.max_queue,
            default_deadline_ms=spec.deadline_ms,  # the tenant's SLO
            bulk_share=spec.bulk_share,
            continuous=self.continuous,
            registry=self.obs,
        )
        watcher = None
        if spec.watch and spec.ckpt and os.path.isdir(spec.ckpt):
            watcher = CheckpointWatcher(
                engine, spec.ckpt, poll_s=spec.poll_s, registry=self.obs
            ).start()
        return engine, batcher, watcher

    def _ensure_resident(self, name: str, touch: bool = True) -> _Tenant:
        """Admission: return the tenant resident, (re-)admitting it if
        needed. Raises :class:`UnknownModel` for names outside the zoo.
        Concurrent callers for a model mid-load wait on the condition;
        exactly one thread pays the build. ``touch=False`` (eager
        placement only) leaves the prior-seeded LRU tick in place."""
        tenant = self._tenants.get(name)
        if tenant is None:
            self._c_unknown.inc()
            raise UnknownModel(
                f"model {name!r} is not hosted here (models: "
                f"{sorted(self._tenants)})"
            )
        with self._cond:
            while True:
                if self._closed:
                    raise BatcherClosed("zoo server is closed")
                if tenant.state == RESIDENT:
                    if touch:
                        self._tick += 1.0
                        tenant.last_used = self._tick
                    return tenant
                if tenant.state in (LOADING, EVICTING):
                    self._cond.wait()
                    continue
                tenant.state = LOADING  # claim the admission
                break
        t0 = time.perf_counter()
        try:
            engine, batcher, watcher = self._build(tenant)
            self._make_room(tenant, self._estimate_bytes(engine))
        except Exception:
            with self._cond:
                tenant.state = EVICTED
                self._cond.notify_all()
            raise
        ms = (time.perf_counter() - t0) * 1e3
        with self._cond:
            tenant.engine = engine
            tenant.batcher = batcher
            tenant.watcher = watcher
            tenant.est_bytes = self._estimate_bytes(engine)
            tenant.state = RESIDENT
            tenant.admissions += 1
            if touch:
                self._tick += 1.0
                tenant.last_used = self._tick
            self._set_residency_gauges_locked()
            self._cond.notify_all()
        self._c_admissions.inc()
        self._h_admission.observe(ms)
        m = self._tenant_metrics[name]
        m["admissions"].inc()
        m["admission_ms"].observe(ms)
        trace.instant(
            "serve/zoo_admit", model=name, ms=round(ms, 3),
            compiles=engine.compile_count,
            aot_hits=engine.aot_cache_hits,
        )
        log.info(
            "zoo: admitted %s in %.1f ms (compiles=%d, aot_hits=%d)",
            name, ms, engine.compile_count, engine.aot_cache_hits,
        )
        return tenant

    # -- the request surface -------------------------------------------

    def _resolve(self, model: Optional[str]) -> str:
        return model if model else self.default_model

    def submit(
        self,
        images: np.ndarray,
        deadline_ms: Optional[float] = None,
        priority: str = "interactive",
        model: Optional[str] = None,
    ):
        """The batcher ``submit`` surface, model-routed: returns the
        tenant batcher's Future. Placement churn never surfaces as a client
        error: the request is enqueued under the condition while its
        tenant is RESIDENT, and an evictor claims a tenant under the same
        condition before it closes the batcher, so the request is either
        drained by that eviction or re-admits the tenant and tries again,
        as often as churn takes it. (The JAX zoo tries twice and then
        raises BatcherClosed.) The enqueue does not block."""
        name = self._resolve(model)
        while True:
            tenant = self._ensure_resident(name)
            with self._cond:
                if tenant.state != RESIDENT or tenant.batcher is None:
                    continue  # evicted since its admission: re-admit
                fut = tenant.batcher.submit(images, deadline_ms, priority)
            m = self._tenant_metrics[name]
            m["requests"].inc()
            m["images"].inc(int(np.asarray(images).shape[0]))
            return fut

    def predict(
        self,
        images: np.ndarray,
        deadline_ms: Optional[float] = None,
        priority: str = "interactive",
        model: Optional[str] = None,
    ) -> np.ndarray:
        """Blocking predict for the frontend backend protocol."""
        return self.submit(images, deadline_ms, priority, model).result()

    # -- per-tenant canary promotion -----------------------------------

    def enable_canary(
        self,
        model: str,
        staging_dir: str,
        *,
        golden=None,
        budget=None,
        **controller_kw,
    ):
        """Attach a dedicated PromotionController to one tenant: its own
        canary engine (built from the tenant's live checkpoint dir — the
        incumbent), vetting whatever lands in ``staging_dir``. One
        controller per tenant means one model's bad candidate is
        quarantined with zero impact on every other tenant's bits or
        latency. The canary engine is built as the JAX package builds it:
        without ``int8``, whatever the zoo serves. Returns the controller;
        the caller drives it (``poll_once`` or ``start``/``stop``) and owns
        its lifetime."""
        from pytorch_cifar_tpu_torch.serve.canary import (
            GoldenSet,
            PromotionController,
        )

        tenant = self._tenants.get(model)
        if tenant is None:
            raise UnknownModel(f"model {model!r} is not hosted here")
        spec = tenant.spec
        if not spec.ckpt:
            raise ValueError(
                f"tenant {model} has no checkpoint dir to promote into"
            )
        canary_engine = InferenceEngine.from_checkpoint(
            spec.ckpt, spec.name, **self._engine_kw(spec)
        )
        if golden is None:
            # the REAL labeled eval split where available, the synthetic
            # eval split otherwise — either way the tenant's CanaryBudget
            # judges exact labeled accuracy
            golden = GoldenSet.labeled_eval()
        ctl = PromotionController(
            canary_engine,
            staging_dir,
            spec.ckpt,
            golden=golden,
            budget=budget,
            registry=self.obs,
            **controller_kw,
        )
        with self._cond:
            tenant.controller = ctl
        return ctl

    # -- health / lifecycle --------------------------------------------

    @property
    def engine_version(self) -> int:
        """The default tenant's weight generation (frontend contract)."""
        with self._cond:
            t = self._tenants[self.default_model]
            return int(t.engine.version) if t.engine is not None else 0

    def health(self) -> dict:
        """The zoo ``/healthz`` payload: residency, the memory budget,
        and a per-tenant block (generation, checkpoint epoch, promotion
        generation, compile/AOT counters, admission/eviction history,
        queue depths) — one scrape shows the whole zoo."""
        with self._cond:
            tenants = {
                n: {
                    "resident": t.state == RESIDENT,
                    "state": t.state,
                    "prior_img_per_sec": t.prior,
                    "admissions": t.admissions,
                    "evictions": t.evictions,
                    "est_bytes": t.est_bytes,
                    "engine": t.engine,
                    "batcher": t.batcher,
                    "watcher": t.watcher,
                    "controller": t.controller,
                    "ckpt": t.spec.ckpt,
                    "deadline_ms": t.spec.deadline_ms,
                }
                for n, t in self._tenants.items()
            }
            resident = [
                n for n, v in tenants.items() if v["resident"]
            ]
            mem = sum(v["est_bytes"] for v in tenants.values()
                      if v["resident"])
        out_tenants = {}
        for n, v in tenants.items():
            eng = v.pop("engine")
            batcher = v.pop("batcher")
            watcher = v.pop("watcher")
            controller = v.pop("controller")
            if eng is not None:
                meta = getattr(eng, "checkpoint_meta", {}) or {}
                if watcher is not None and watcher.last_meta:
                    meta = watcher.last_meta
                promo = meta.get("promotion") or {}
                v.update(
                    engine_version=int(eng.version),
                    ckpt_epoch=meta.get("epoch"),
                    promotion_generation=promo.get("generation"),
                    compiles=int(eng.compile_count),
                    aot_cache_hits=int(eng.aot_cache_hits),
                    buckets=[int(b) for b in eng.buckets],
                )
            if batcher is not None:
                v["queued"] = batcher.stats["queued"]
            if watcher is not None:
                v["reloads"] = watcher.reloads
            if controller is not None:
                v["canary"] = controller.status()
            out_tenants[n] = v
        return {
            "status": "ok",
            "role": "zoo",
            "model": self.default_model,  # what pre-zoo probes read
            "default_model": self.default_model,
            "models": sorted(self._tenants),
            "resident": sorted(resident),
            "max_resident": self.max_resident,
            "memory_bytes": mem,
            "memory_budget_bytes": self.memory_budget_bytes,
            "tenants": out_tenants,
        }

    @property
    def stats(self) -> dict:
        return {
            "admissions": int(self._c_admissions.value),
            "evictions": int(self._c_evictions.value),
            "unknown_model": int(self._c_unknown.value),
            "resident": self._resident_names(),
        }

    def close(self) -> None:
        """Drain and drop every resident tenant (idempotent). After
        close() returns, no tenant thread exists and further submits
        raise BatcherClosed."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            victims = [
                t for t in self._tenants.values() if t.state == RESIDENT
            ]
            for t in victims:
                t.state = EVICTING
            self._cond.notify_all()
        for t in victims:
            self._evict(t)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
