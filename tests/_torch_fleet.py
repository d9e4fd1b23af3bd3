"""Both packages' fleet control plane side by side, for the port's fleet
tests (``tests/test_torch_fleet*.py``).

A :class:`Side` bundles one package's fleet, router, journal and metrics
modules, so one scenario runs through the JAX package's
``FleetController`` over a JAX ``Router`` and through the port's over a
port ``Router`` (never started), with the same :class:`FakeReplica`
launcher and a fake clock. :func:`trace` reduces a finished scenario to
what the two must agree on: membership, ``serve.fleet.*`` metrics, stats
and journal records.

:func:`pin_wall` patches the wall clock (``time.time``) of both packages'
fleet and journal modules to one fixed value, so journal records (their
``wall`` stamp and the policy's ``*_wall`` fields) compare whole.

:func:`replica_pids` and :func:`reap_replicas` are the orphan check of the
launcher tests: they list, from ``/proc``, the port replica processes
(``python -m pytorch_cifar_tpu_torch.serve``) whose command line names a
path of this run, and kill them.
"""

import os
import signal
import time
import types

from pytorch_cifar_tpu import obs as jax_obs
from pytorch_cifar_tpu.serve import fleet as jax_fleet
from pytorch_cifar_tpu.serve import journal as jax_journal
from pytorch_cifar_tpu.serve import router as jax_router
from pytorch_cifar_tpu_torch import obs
from pytorch_cifar_tpu_torch.serve import fleet, journal, router

WALL = 1_700_000_000.0


class Side:
    def __init__(self, name, fleet_mod, router_mod, journal_mod, obs_mod):
        self.name = name
        self.fleet = fleet_mod
        self.Router = router_mod.Router
        self.journal = journal_mod
        self.MetricsRegistry = obs_mod.MetricsRegistry

    def __repr__(self):
        return self.name


JAX = Side("jax", jax_fleet, jax_router, jax_journal, jax_obs)
PORT = Side("port", fleet, router, journal, obs)
SIDES = (JAX, PORT)


def pin_wall(monkeypatch, wall=WALL):
    """Every ``time.time()`` of both packages' fleet and journal modules
    reads ``wall``; their monotonic clocks and sleeps are untouched."""
    fake = types.SimpleNamespace(
        time=lambda: wall, monotonic=time.monotonic, sleep=time.sleep,
        perf_counter=time.perf_counter)
    for mod in (jax_fleet, jax_journal, fleet, journal):
        monkeypatch.setattr(mod, "time", fake)


class FakeReplica:
    """A launcher product with the ReplicaProcess surface the controller
    uses: url/health/alive()/decommission() (JAX ``tests/test_fleet.py``'s
    fake, shared by both sides)."""

    def __init__(self, idx):
        self.idx = idx
        self.url = f"http://127.0.0.1:{9000 + idx}"
        self.pid = 1000 + idx
        self.health = {"compiles": 0, "aot_cache_hits": 3}
        self.dead = False
        self.drained = False

    def alive(self):
        return not self.dead

    def decommission(self, timeout_s=60.0):
        self.dead = True
        self.drained = True
        return 0.01


def default_policy(side, **kw):
    base = dict(min_replicas=1, max_replicas=3, queue_high=8.0,
                queue_low=1.0, up_after_s=2.0, down_after_s=10.0,
                up_cooldown_s=5.0, down_cooldown_s=20.0)
    base.update(kw)
    return side.fleet.FleetPolicy(**base)


def make_fleet(side, policy=None, seeds=1, **ctl_kwargs):
    """JAX ``make_fleet``: a controller over a real (unstarted) Router, a
    fake launcher, a fake clock and mutable scrape signals. Returns
    (controller, clock dict, signals holder, spawned list, seeds)."""
    policy = policy or default_policy(side)
    spawned = []

    def launcher(idx):
        r = FakeReplica(idx)
        spawned.append(r)
        return r

    clk = {"t": 0.0}
    sig = {"s": side.fleet.FleetSignals(healthy=seeds)}
    seed_handles = [FakeReplica(i) for i in range(seeds)]
    rt = side.Router([h.url for h in seed_handles])  # never start()ed
    ctl = side.fleet.FleetController(
        rt, launcher, policy,
        scrape=lambda: sig["s"],
        registry=side.MetricsRegistry(),
        clock=lambda: clk["t"],
        **ctl_kwargs,
    )
    for h in seed_handles:
        ctl.adopt(h)
    return ctl, clk, sig, spawned, seed_handles


def pressured(side, n, queued=40):
    return side.fleet.FleetSignals(healthy=n, queued=queued, in_flight=n)


def idle(side, n):
    return side.fleet.FleetSignals(healthy=n, queued=0, in_flight=0)


def fleet_metrics(registry) -> dict:
    """The ``serve.fleet.*`` part of a registry snapshot."""
    snap = registry.snapshot()
    return {kind: {k: v for k, v in snap.get(kind, {}).items()
                   if k.startswith("serve.fleet.")}
            for kind in ("counters", "gauges", "histograms")}


def trace(ctl, actions, journal_obj=None) -> dict:
    """What the two packages' controllers must agree on after one
    scenario."""
    out = {
        "actions": list(actions),
        "router": [r.url for r in ctl.router.replicas],
        "replicas": sorted(ctl.replicas()),
        "generations": {u: getattr(h, "generation", None)
                        for u, h in sorted(ctl.replicas().items())},
        "stats": ctl.stats,
        "metrics": fleet_metrics(ctl.obs),
        "generation": ctl.generation,
        "rollout": ctl.rollout,
    }
    if journal_obj is not None:
        out["journal"] = journal_obj.records()
    return out


# -- orphan reaping (launcher tests) ----------------------------------


def _cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().split(b"\0")
    except OSError:
        return None  # raced an exit


def replica_pids(marker) -> set:
    """Live port replica pids whose command line names ``marker`` (a
    path of this run, such as its checkpoint dir)."""
    module = fleet.REPLICA_MODULE.encode()
    want = str(marker).encode()
    pids = set()
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        argv = _cmdline(d)
        if argv and module in argv and any(want in a for a in argv):
            pids.add(int(d))
    return pids


def reap_replicas(marker) -> set:
    """SIGKILL every port replica of this run still alive; returns their
    pids (empty when the run left none)."""
    pids = replica_pids(marker)
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return pids
