"""The port's fleet control plane against the JAX package's: the pure part
(``FleetPolicy``, ``FleetSignals``, the Prometheus parsers,
``ScalingEvaluator``) and the controller.

Every scenario of the JAX package's ``tests/test_fleet.py`` runs here
through BOTH ``FleetController``s: the JAX one over a JAX ``Router``, the
port's over a port ``Router`` (neither started), with the same fake
launcher (``_torch_fleet.FakeReplica``) and fake clock. Each scenario keeps
the JAX test's own assertions, and the two packages' actions, membership,
``serve.fleet.*`` metrics, stats and journal records must be equal. The
wall clock of both packages' fleet and journal modules is pinned
(``_torch_fleet.pin_wall``), so journal records compare whole, ``wall``
and ``*_wall`` fields included.
"""

import json
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_fleet import (
    JAX,
    PORT,
    SIDES,
    FakeReplica,
    default_policy,
    idle,
    make_fleet,
    pin_wall,
    pressured,
    trace,
)
from _torch_threads import torch_threads  # noqa: F401
from _torch_wire import StubBackend, images, post_frame
from pytorch_cifar_tpu_torch.obs import MetricsRegistry
from pytorch_cifar_tpu_torch.serve import (
    DeadlineExceeded,
    Router,
    ServingFrontend,
    wire,
)


@pytest.fixture(autouse=True)
def wall(monkeypatch):
    pin_wall(monkeypatch)


def _ops(journal):
    return [r["op"] for r in journal.records()]


# ---------------------------------------------------------------------
# the scenarios of the JAX package's tests/test_fleet.py, side by side
# ---------------------------------------------------------------------


def scale_up_requires_sustained_pressure(side, tmp):
    ctl, clk, sig, spawned, _ = make_fleet(side)
    sig["s"] = pressured(side, 1)
    acts = [ctl.control_once(now=0.0), ctl.control_once(now=1.9)]
    assert acts == ["hold", "hold"] and spawned == []
    acts.append(ctl.control_once(now=2.0))
    assert acts[-1] == "up"
    assert len(spawned) == 1 and len(ctl.replicas()) == 2
    assert len(ctl.router.replicas) == 2  # registered live
    assert ctl.stats["scale_ups"] == 1
    assert ctl.obs.gauge("serve.fleet.replicas").value == 2.0
    return trace(ctl, acts)


def scale_up_cooldown_then_max_bound(side, tmp):
    ctl, clk, sig, spawned, _ = make_fleet(side)
    sig["s"] = pressured(side, 1)
    acts = [ctl.control_once(now=0.0), ctl.control_once(now=2.0)]
    sig["s"] = pressured(side, 2)
    acts += [ctl.control_once(now=t) for t in (3.0, 6.0, 7.5)]
    assert acts == ["hold", "up", "hold", "hold", "up"]
    assert len(ctl.replicas()) == 3
    sig["s"] = pressured(side, 3)
    acts += [ctl.control_once(now=30.0), ctl.control_once(now=60.0)]
    assert acts[-2:] == ["hold", "hold"]
    assert ctl.stats["scale_ups"] == 2
    return trace(ctl, acts)


def pressure_window_resets_inside_band(side, tmp):
    ctl, clk, sig, spawned, _ = make_fleet(side)
    sig["s"] = pressured(side, 1)
    acts = [ctl.control_once(now=0.0)]
    sig["s"] = side.fleet.FleetSignals(healthy=1, queued=4)  # in band
    acts.append(ctl.control_once(now=1.0))
    sig["s"] = pressured(side, 1)
    acts += [ctl.control_once(now=t) for t in (1.5, 3.0, 3.6)]
    assert acts[1:] == ["hold", "hold", "hold", "up"]
    return trace(ctl, acts)


def deadline_expiries_trigger_pressure(side, tmp):
    ctl, clk, sig, spawned, _ = make_fleet(side)
    S = side.fleet.FleetSignals
    sig["s"] = S(healthy=1, queued=0, deadline_expired=2.0)
    acts = [ctl.control_once(now=0.0)]
    sig["s"] = S(healthy=1, queued=0, deadline_expired=5.0)
    acts.append(ctl.control_once(now=2.5))
    assert acts == ["hold", "up"]
    verdict = ctl.evaluator.evaluate(
        S(healthy=2, queued=0, deadline_expired=5.0), 2, 60.0)
    assert verdict[0] != "up"
    return {**trace(ctl, acts), "verdict": verdict}


def p99_bound_triggers_pressure(side, tmp):
    policy = side.fleet.FleetPolicy(
        min_replicas=1, max_replicas=2, p99_high_ms=100.0,
        up_after_s=1.0, up_cooldown_s=1.0)
    ctl, clk, sig, spawned, _ = make_fleet(side, policy=policy)
    sig["s"] = side.fleet.FleetSignals(healthy=1, queued=0, p99_ms=250.0)
    acts = [ctl.control_once(now=0.0), ctl.control_once(now=1.0)]
    assert acts == ["hold", "up"]
    return trace(ctl, acts)


def scale_down_requires_sustained_idle_and_respects_min(side, tmp):
    ctl, clk, sig, spawned, seeds = make_fleet(side, seeds=2)
    sig["s"] = idle(side, 2)
    acts = [ctl.control_once(now=t) for t in (0.0, 9.9, 10.0)]
    assert acts == ["hold", "hold", "down"]
    assert len(ctl.replicas()) == 1 and len(ctl.router.replicas) == 1
    assert ctl.stats["scale_downs"] == 1
    drained = [h.idx for h in seeds if h.drained]
    assert drained == [1]  # newest first
    sig["s"] = idle(side, 1)
    acts += [ctl.control_once(now=100.0), ctl.control_once(now=1000.0)]
    assert acts[-2:] == ["hold", "hold"] and len(ctl.replicas()) == 1
    return {**trace(ctl, acts), "drained": drained}


def scale_down_only_when_drain_is_free(side, tmp):
    ctl, clk, sig, spawned, seeds = make_fleet(side, seeds=2)
    sig["s"] = idle(side, 2)
    acts = [ctl.control_once(now=0.0)]
    for r in ctl.router.replicas:
        r.in_flight = 1  # both replicas hold work
    acts.append(ctl.control_once(now=15.0))
    assert ctl.stats["scale_downs"] == 0
    for r in ctl.router.replicas:
        r.in_flight = 0
    acts.append(ctl.control_once(now=16.0))
    assert acts == ["hold", "hold", "down"]
    return trace(ctl, acts)


def scale_down_cooldown(side, tmp):
    policy = side.fleet.FleetPolicy(
        min_replicas=1, max_replicas=4, down_after_s=1.0,
        down_cooldown_s=30.0)
    ctl, clk, sig, spawned, _ = make_fleet(side, policy=policy, seeds=3)
    sig["s"] = idle(side, 3)
    acts = [ctl.control_once(now=t) for t in (0.0, 1.0, 5.0, 30.9, 31.5)]
    assert acts[1:] == ["down", "hold", "hold", "down"]
    assert len(ctl.replicas()) == 1
    return trace(ctl, acts)


def dead_replica_reaped_and_replaced_immediately(side, tmp):
    ctl, clk, sig, spawned, seeds = make_fleet(side)
    sig["s"] = idle(side, 1)
    seeds[0].dead = True  # preempted
    acts = [ctl.control_once(now=0.0)]
    assert acts == ["replace"]
    assert ctl.stats["replica_failures"] == 1
    assert len(ctl.replicas()) == 1 and len(spawned) == 1
    urls = [r.url for r in ctl.router.replicas]
    assert seeds[0].url not in urls and spawned[0].url in urls
    assert seeds[0].drained  # reaped, never orphaned
    return trace(ctl, acts)


def failed_spawn_holds_without_eating_cooldown(side, tmp):
    calls = {"n": 0}

    def flaky_launcher(idx):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("no capacity")
        return FakeReplica(idx)

    policy = side.fleet.FleetPolicy(min_replicas=1, max_replicas=2,
                                    up_after_s=1.0)
    clk = {"t": 0.0}
    sig = {"s": pressured(side, 1)}
    seed = FakeReplica(0)
    ctl = side.fleet.FleetController(
        side.Router([seed.url]), flaky_launcher, policy,
        scrape=lambda: sig["s"], clock=lambda: clk["t"],
        registry=side.MetricsRegistry(),
    )
    ctl.adopt(seed)
    acts = [ctl.control_once(now=t) for t in (0.0, 1.0)]
    assert acts == ["hold", "hold"]  # the spawn raised
    assert ctl.stats["replica_failures"] == 1
    acts.append(ctl.control_once(now=1.5))
    assert acts[-1] == "up" and len(ctl.replicas()) == 2
    return trace(ctl, acts)


def scrape_error_holds_and_counts(side, tmp):
    ctl, clk, sig, spawned, _ = make_fleet(side)

    def broken():
        raise OSError("fleet edge unreachable")

    ctl.scrape = broken
    acts = [ctl.control_once(now=0.0)]
    assert acts == ["hold"] and ctl.stats["scrape_errors"] == 1
    assert spawned == []
    return trace(ctl, acts)


def router_add_remove_replica_hooks(side, tmp):
    rt = side.Router(["http://127.0.0.1:9100"])
    added = rt.add_replica("http://127.0.0.1:9101")
    assert len(rt.replicas) == 2
    assert rt.add_replica("http://127.0.0.1:9101") is added  # idempotent
    assert len(rt.replicas) == 2
    removed = rt.remove_replica("http://127.0.0.1:9101")
    assert removed is added and len(rt.replicas) == 1
    assert rt.remove_replica("http://127.0.0.1:9101") is None
    assert rt.obs.gauge("router.healthy_replicas").value == 1.0
    return {"urls": [r.url for r in rt.replicas], "removed": removed.url,
            "healthy": rt.obs.gauge("router.healthy_replicas").value}


def router_fleet_view_snapshot(side, tmp):
    rt = side.Router(["http://127.0.0.1:9100", "http://127.0.0.1:9101"])
    rt.replicas[0].in_flight = 3
    rt.replicas[1].last_health = {"queued": {"interactive": 2}}
    view = rt.fleet_view()
    assert view["http://127.0.0.1:9100"][0] == 3
    assert view["http://127.0.0.1:9101"][1] == {"queued": {"interactive": 2}}
    return view


def evaluator_is_pure_state_machine(side, tmp):
    p = side.fleet.FleetPolicy(min_replicas=1, max_replicas=4,
                               up_after_s=2.0)
    ev = side.fleet.ScalingEvaluator(p)
    out = [ev.evaluate(pressured(side, 1), 1, 0.0)]
    out.append(ev.evaluate(pressured(side, 1), 1, 2.5))
    out.append(ev.evaluate(pressured(side, 1), 1, 2.6))
    ev.acted_up(2.6)
    out.append(ev.evaluate(pressured(side, 2), 2, 3.0))
    out.append(ev.evaluate(idle(side, 0), 0, 3.1))
    assert out[0][0] == "hold" and out[1][0] == "up" and "load" in out[1][1]
    assert out[2][0] == "up" and out[3][0] == "hold"
    assert out[4] == ("up", "min-replicas floor")
    return out


def make_rollout_fleet(side, tmp, seeds=2, gate=None, rollback=None):
    """JAX ``make_rollout_fleet``: a journaled controller whose launcher
    mints replicas on a settable generation and whose generation probe
    reads a settable live generation."""
    launch_gen, probe_gen, spawned = {"g": 2}, {"g": 2}, []

    def launcher(idx):
        r = FakeReplica(idx)
        r.health["promotion_generation"] = launch_gen["g"]
        spawned.append(r)
        return r

    clk = {"t": 0.0}
    sig = {"s": side.fleet.FleetSignals(healthy=seeds, queued=4)}
    jr = side.journal.ControllerJournal(str(tmp / "fleet.journal"))
    seed_handles = [FakeReplica(i) for i in range(seeds)]
    for h in seed_handles:
        h.health["promotion_generation"] = 2
    ctl = side.fleet.FleetController(
        side.Router([h.url for h in seed_handles]), launcher,
        default_policy(side, max_replicas=4),
        scrape=lambda: sig["s"],
        registry=side.MetricsRegistry(),
        clock=lambda: clk["t"],
        journal=jr,
        generation_probe=lambda: probe_gen["g"],
        rollout_gate=gate,
        rollback=rollback,
    )
    for h in seed_handles:
        ctl.adopt(h)
    return ctl, clk, sig, spawned, probe_gen, launch_gen, jr


def journal_records_every_actuation_in_order(side, tmp):
    jr = side.journal.ControllerJournal(str(tmp / "j"))
    ctl, clk, sig, spawned, seed_handles = make_fleet(side, journal=jr)
    sig["s"] = pressured(side, 1)
    acts = [ctl.control_once(now=0.0), ctl.control_once(now=2.0)]
    sig["s"] = idle(side, 2)
    acts += [ctl.control_once(now=10.0), ctl.control_once(now=20.5)]
    assert acts[1] == "up" and acts[3] == "down"
    spawned[0].dead = True
    seed_handles[0].dead = True
    acts.append(ctl.control_once(now=21.0))
    ops = _ops(jr)
    assert ops[0] == "adopt"
    i_spawn = ops.index("spawn-intent")
    assert ops[i_spawn + 1] == "replica-up"
    assert "policy" in ops and "reap" in ops
    assert "drain-done" in ops[ops.index("drain-intent"):]
    state = side.journal.FleetJournalState.from_records(jr.records())
    assert set(state.live_replicas()) == set(ctl.replicas())
    assert ctl.stats["journal_replays"] == 0
    out = trace(ctl, acts, jr)
    jr.close()
    return out


def rolling_deploy_converts_fleet_one_at_a_time(side, tmp):
    ctl, clk, sig, spawned, probe_gen, launch_gen, jr = (
        make_rollout_fleet(side, tmp))
    acts = [ctl.control_once(now=0.0)]  # baselines gen 2
    assert acts == ["hold"] and ctl.generation == 2
    probe_gen["g"] = launch_gen["g"] = 3
    counts = []
    for i in range(1, 8):
        acts.append(ctl.control_once(now=float(i)))
        counts.append(len(ctl.replicas()))
        if ctl.rollout is None and ctl.generation == 3:
            break
    assert ctl.generation == 3 and ctl.rollout is None
    assert ctl.stats["rollouts"] == 1
    assert all(a == "rollout" for a in acts[1:])
    assert max(counts) == 3 and min(counts) >= 2
    assert len(ctl.replicas()) == 2
    ops = _ops(jr)
    assert ops.index("rollout-begin") < ops.index("rollout-done")
    assert ctl.stats["scale_ups"] == 0 and ctl.stats["scale_downs"] == 0
    out = {**trace(ctl, acts, jr), "counts": counts}
    jr.close()
    return out


class RefusingGate:
    def __init__(self):
        self.baselined = []
        self.checked = []

    def baseline_from(self, url):
        self.baselined.append(url)

    def check(self, url):
        self.checked.append(url)
        return ["golden batch: 4/8 rows flipped vs baseline"]


def rolling_deploy_halts_and_rolls_back_on_canary(side, tmp):
    restored, gate = [], RefusingGate()
    ctl, clk, sig, spawned, probe_gen, launch_gen, jr = make_rollout_fleet(
        side, tmp, gate=gate, rollback=lambda: restored.append(1) or True)
    acts = [ctl.control_once(now=0.0)]
    probe_gen["g"] = launch_gen["g"] = 3
    acts.append(ctl.control_once(now=1.0))  # surge -> rejected
    assert acts[-1] == "rollout" and gate.baselined and gate.checked
    assert restored == [1] and ctl.rollout["phase"] == "rollback"
    assert spawned[0].drained and spawned[0].url not in ctl.replicas()
    probe_gen["g"] = launch_gen["g"] = 2  # the restored live dir
    acts.append(ctl.control_once(now=2.0))  # rollback-done
    assert ctl.rollout is None and ctl.generation == 2
    assert ctl.stats["rollbacks"] == 1 and ctl.stats["rollouts"] == 0
    assert len(ctl.replicas()) == 2
    ops = _ops(jr)
    assert ops.index("rollout-halt") < ops.index("rollout-rollback-done")
    i_fail = ops.index("spawn-failed")
    assert ops.index("spawn-intent") < i_fail < ops.index("rollout-halt")
    out = {**trace(ctl, acts, jr), "gate": (gate.baselined, gate.checked)}
    jr.close()
    return out


def recover_controller_adopts_live_reaps_dead_resumes_windows(side, tmp):
    path = str(tmp / "fleet.journal")
    j = side.journal.ControllerJournal(path)
    j.append("generation", generation=2)
    for i in range(3):
        j.append("spawn-intent", idx=i)
        j.append("replica-up", idx=i, url=f"http://127.0.0.1:910{i}",
                 pid=50 + i, generation=2, compiles=0)
    j.append("drain-intent", idx=2, url="http://127.0.0.1:9102")
    j.append("policy", pressure_since_wall=None, idle_since_wall=None,
             last_up_wall=j.records()[0]["wall"] - 3.0,
             last_down_wall=None, last_expired=7.0)
    j.append("rollout-begin", from_generation=2, to_generation=3,
             n_start=2)
    j.append("rollout-phase", phase="converting")
    j.close()

    alive, probed, spawned = {"http://127.0.0.1:9100"}, [], []

    def probe(url):
        probed.append(url)
        return ({"compiles": 0, "promotion_generation": 2}
                if url in alive else None)

    def launcher(idx):
        spawned.append(idx)
        return FakeReplica(idx)

    rt = side.Router(["http://127.0.0.1:9100", "http://127.0.0.1:9101"])
    jr = side.journal.ControllerJournal(path)
    ctl = side.fleet.recover_controller(
        jr, rt, launcher, default_policy(side, max_replicas=4),
        scrape=lambda: side.fleet.FleetSignals(healthy=1, queued=4),
        probe=probe,
        pid_check=lambda pid: pid == 50,
        registry=side.MetricsRegistry(),
        clock=lambda: 100.0,
    )
    assert spawned == []  # recovery never spawns
    assert set(ctl.replicas()) == {"http://127.0.0.1:9100"}
    assert ctl.replicas()["http://127.0.0.1:9100"].pid == 50
    assert [r.url for r in rt.replicas] == ["http://127.0.0.1:9100"]
    assert "http://127.0.0.1:9102" not in probed
    assert ctl.generation == 2 and ctl.stats["journal_replays"] == 1
    assert ctl.stats["adoptions"] == 1
    assert ctl.stats["replica_failures"] == 1
    assert ctl.evaluator.last_up == pytest.approx(97.0)
    assert ctl.evaluator.last_expired == 7.0
    assert ctl.rollout["to_generation"] == 3
    assert ctl.rollout["phase"] == "converting"
    state = side.journal.FleetJournalState.from_records(
        side.journal.replay_journal(path)[0])
    assert set(state.live_replicas()) == {"http://127.0.0.1:9100"}
    assert state.rollout["phase"] == "converting"
    out = {**trace(ctl, [], jr), "probed": probed,
           "evaluator": (ctl.evaluator.last_up, ctl.evaluator.last_expired)}
    jr.close()
    return out


def recover_controller_refuses_corrupt_journal(side, tmp):
    path = tmp / "j"
    j = side.journal.ControllerJournal(str(path))
    j.append("replica-up", idx=0, url="u0", pid=1, generation=1)
    j.append("replica-up", idx=1, url="u1", pid=2, generation=1)
    j.close()
    lines = path.read_bytes().splitlines(keepends=True)
    path.write_bytes(lines[0][:-9] + b"XXXXXXXX\n" + lines[1])
    with pytest.raises(side.journal.JournalCorrupt) as e:
        side.fleet.recover_controller(
            side.journal.ControllerJournal(str(path)), side.Router(["u0"]),
            FakeReplica, default_policy(side, max_replicas=2),
            scrape=lambda: side.fleet.FleetSignals(healthy=1),
            probe=lambda url: None,
            pid_check=lambda pid: False,
            registry=side.MetricsRegistry(),
        )
    return str(e.value).replace(str(tmp), "<tmp>")


SCENARIOS = {f.__name__: f for f in (
    scale_up_requires_sustained_pressure,
    scale_up_cooldown_then_max_bound,
    pressure_window_resets_inside_band,
    deadline_expiries_trigger_pressure,
    p99_bound_triggers_pressure,
    scale_down_requires_sustained_idle_and_respects_min,
    scale_down_only_when_drain_is_free,
    scale_down_cooldown,
    dead_replica_reaped_and_replaced_immediately,
    failed_spawn_holds_without_eating_cooldown,
    scrape_error_holds_and_counts,
    router_add_remove_replica_hooks,
    router_fleet_view_snapshot,
    evaluator_is_pure_state_machine,
    journal_records_every_actuation_in_order,
    rolling_deploy_converts_fleet_one_at_a_time,
    rolling_deploy_halts_and_rolls_back_on_canary,
    recover_controller_adopts_live_reaps_dead_resumes_windows,
    recover_controller_refuses_corrupt_journal,
)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name, tmp_path):
    got = {}
    for side in SIDES:
        (tmp_path / side.name).mkdir()
        got[side.name] = SCENARIOS[name](side, tmp_path / side.name)
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------
# the pure part
# ---------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(min_replicas=0),
    dict(min_replicas=3, max_replicas=2),
    dict(queue_low=9.0, queue_high=8.0),
])
def test_policy_validation(kw):
    msgs = []
    for side in SIDES:
        with pytest.raises(ValueError) as e:
            side.fleet.FleetPolicy(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # a valid policy keeps its fields
    ok = dict(min_replicas=2, max_replicas=5, queue_low=0.5, queue_high=6.0)
    assert (PORT.fleet.FleetPolicy(**ok).__dict__
            == JAX.fleet.FleetPolicy(**ok).__dict__)


HEALTH = {
    "healthy_replicas": 2,
    "replicas": [
        {"in_flight": 3, "health": {"queued": {"interactive": 4, "bulk": 2}}},
        {"in_flight": 1, "health": {}},  # mid-join: no queue stats
    ],
}
PROM = "\n".join([
    "pct_serve_http_504 7",
    'pct_router_latency_ms_bucket{le="10"} 90',
    'pct_router_latency_ms_bucket{le="100"} 99',
    'pct_router_latency_ms_bucket{le="+Inf"} 100',
])


@pytest.mark.parametrize("health,prom", [
    (HEALTH, PROM),
    ({}, ""),
    ({"healthy_replicas": 1, "replicas": [{"health": {"queued": 5}}]}, ""),
])
def test_signals_from_http_match_jax(health, prom):
    got = [side.fleet.FleetSignals.from_http(health, prom).__dict__
           for side in SIDES]
    assert got[0] == got[1]
    s = PORT.fleet.FleetSignals.from_http(health, prom)
    assert s.load_per_replica == JAX.fleet.FleetSignals.from_http(
        health, prom).load_per_replica
    if health is HEALTH:
        assert (s.healthy, s.queued, s.bulk_queued, s.in_flight) == (
            2, 6, 2, 4)
        assert s.deadline_expired == 7.0 and s.p99_ms == 100.0


@pytest.mark.parametrize("pct", [50.0, 90.0, 99.0, 100.0])
def test_prom_parsers_match_jax(pct):
    text = PROM + "\npct_x_total 3\npct_h_bucket{le=\"1\"} 0\n"
    for name in ("pct_x_total", "pct_absent", "pct_serve_http_504"):
        assert (PORT.fleet.parse_prom_counter(text, name)
                == JAX.fleet.parse_prom_counter(text, name))
    for name in ("pct_router_latency_ms", "pct_h", "pct_absent"):
        assert (PORT.fleet.parse_prom_histogram_percentile(text, name, pct)
                == JAX.fleet.parse_prom_histogram_percentile(
                    text, name, pct))
    assert PORT.fleet.parse_prom_histogram_percentile("", "pct_h", pct) == 0


def test_scrape_of_the_ports_own_edge_after_a_504():
    """The names the scrape reads are the names the port's frontend and
    router export: a fleet frontend over a port Router answers one request
    (``router.latency_ms``), then a 504 from a replica whose queue
    deadline expired (``serve.http_504``); both packages' scrapes of its
    ``/healthz`` + ``/metrics`` read the same signals."""
    ok = ServingFrontend(StubBackend()).start()
    late = ServingFrontend(
        StubBackend(raises=DeadlineExceeded("queue deadline"))).start()
    reg = MetricsRegistry()
    rt = Router([ok.url], registry=reg, hedge=False)
    edge = ServingFrontend(rt, registry=reg).start()
    try:
        x = images(2)
        status = post_frame(edge.url, wire.encode_request(x))[0]
        assert status == 200
        rt.add_replica(late.url)
        assert rt.remove_replica(ok.url) is not None
        status = post_frame(edge.url, wire.encode_request(x))[0]
        assert status == 504
        with urllib.request.urlopen(edge.url + "/metrics", timeout=30) as r:
            prom = r.read().decode()
        with urllib.request.urlopen(edge.url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert PORT.fleet.parse_prom_counter(prom, "pct_serve_http_504") == 1
        assert PORT.fleet.parse_prom_histogram_percentile(
            prom, "pct_router_latency_ms", 99.0) > 0
        got = [side.fleet.scrape_fleet(edge.url).__dict__ for side in SIDES]
        assert got[0] == got[1]
        assert got[1] == JAX.fleet.FleetSignals.from_http(
            health, prom).__dict__
        assert got[1]["deadline_expired"] == 1.0 and got[1]["healthy"] == 1
    finally:
        edge.stop()
        rt.stop()
        ok.stop()
        late.stop()


@pytest.mark.parametrize("transport", ["threaded", "event"])
def test_a_request_begun_on_a_lone_replica_hedges_to_one_added_since(
        transport):
    """A replica dies (a 500) holding a request it took while the fleet
    held it alone, after the controller added a second replica. JAX's
    router decided at the request's start that no hedge was left, and
    the request fails; the port's reads the membership at the failure
    and hedges it to the new replica (a divergence from JAX)."""
    got = {}
    for side in SIDES:
        dying = StubBackend(tag=1.0, raises=RuntimeError("replica died"),
                            gated=True)
        fresh = StubBackend(tag=2.0)
        with ServingFrontend(dying) as fd, ServingFrontend(fresh) as ff:
            rt = side.Router([fd.url], transport=transport)
            try:
                with ThreadPoolExecutor(1) as ex:
                    fut = ex.submit(rt.predict, images(2))
                    deadline = time.monotonic() + 30
                    while (rt.replicas[0].in_flight == 0
                           and time.monotonic() < deadline):
                        time.sleep(0.005)
                    assert rt.replicas[0].in_flight == 1
                    rt.add_replica(ff.url)
                    dying.gate.set()
                    try:
                        got[side.name] = fut.result(timeout=60)[:, 0].tolist()
                    except Exception as e:
                        got[side.name] = type(e).__name__
                got[side.name] = (got[side.name], rt.stats["hedged"],
                                  fresh.calls)
            finally:
                rt.stop()
    assert got["jax"] == ("BatcherClosed", 0, 0)
    assert got["port"] == ([2.0, 2.0], 1, 1)


@pytest.mark.parametrize("transport", ["threaded", "event"])
def test_a_request_whose_replica_was_removed_hedges_to_the_other(transport):
    """A replica holds a request when the controller removes it (it died
    and was reaped), and the attempt fails after that. JAX's router
    decided at the request's start, with two replicas, that a hedge was
    left; the port reads the membership at the failure and must still
    count the replica it has not tried: both hedge to it."""
    got = {}
    for side in SIDES:
        dying = StubBackend(tag=1.0, raises=RuntimeError("replica died"),
                            gated=True)
        fresh = StubBackend(tag=2.0)
        with ServingFrontend(dying) as fd, ServingFrontend(fresh) as ff:
            # least in-flight, ties round-robin from the second entry:
            # the first request goes to the dying replica
            rt = side.Router([ff.url, fd.url], transport=transport)
            try:
                with ThreadPoolExecutor(1) as ex:
                    fut = ex.submit(rt.predict, images(2))
                    held = rt.replicas[1]
                    deadline = time.monotonic() + 30
                    while held.in_flight == 0 and time.monotonic() < deadline:
                        time.sleep(0.005)
                    assert held.in_flight == 1 and fresh.calls == 0
                    assert rt.remove_replica(fd.url) is held
                    dying.gate.set()
                    try:
                        got[side.name] = fut.result(timeout=60)[:, 0].tolist()
                    except Exception as e:
                        got[side.name] = type(e).__name__
                got[side.name] = (got[side.name], rt.stats["hedged"],
                                  fresh.calls)
            finally:
                rt.stop()
    assert got["jax"] == ([2.0, 2.0], 1, 1)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluator_matches_jax_on_a_seeded_history(seed):
    """A seeded random history of (signals, n, now): both evaluators give
    the same verdict tuple for tuple, acting on each verdict alike."""
    rs = np.random.RandomState(seed)
    p99_high = float(rs.choice([0.0, 50.0]))
    evs = {side.name: side.fleet.ScalingEvaluator(default_policy(
        side, max_replicas=4, p99_high_ms=p99_high)) for side in SIDES}
    expired, now, n, verdicts = 0.0, 0.0, 1, []
    regime = "busy"
    for _ in range(600):
        if rs.rand() < 0.05:  # load swings between stretches
            regime = str(rs.choice(["busy", "mid", "idle"]))
        now += float(rs.exponential(0.7))
        busy = regime == "busy"
        expired += float(rs.poisson(0.3)) if busy else 0.0
        top = {"busy": 60, "mid": 12, "idle": 1}[regime]
        kw = dict(healthy=int(rs.randint(0, 5)),
                  queued=int(rs.randint(0, top)),
                  bulk_queued=int(rs.randint(0, 3)),
                  in_flight=int(rs.randint(0, top // 4 + 1)),
                  deadline_expired=expired,
                  p99_ms=float(rs.uniform(0, 120 if busy else 40)))
        if rs.rand() < 0.1:
            n = int(rs.randint(0, 5))
        step = {}
        for side in SIDES:
            ev = evs[side.name]
            sig = side.fleet.FleetSignals(**kw)
            step[side.name] = ev.evaluate(sig, n, now)
            if step[side.name][0] == "up":
                ev.acted_up(now)
            elif step[side.name][0] == "down":
                ev.acted_down(now)
        assert step["port"] == step["jax"]
        verdicts.append(step["port"][0])
        if verdicts[-1] == "up":
            n += 1
        elif verdicts[-1] == "down":
            n -= 1
    # the history exercised every verdict
    assert {"up", "down", "hold"} <= set(verdicts)
