"""Crash recovery across the two packages, the journal follower and the
pid guard.

A controller of either package is killed mid-rollout or mid-drain (its
fake launcher or replica raises where the SIGKILL would land), and the
journal it leaves is recovered by BOTH packages' ``recover_controller``
with the same fake ``probe``/``pid_check``: the journal bytes the two
writers leave, and the adoptions, reaps, resumed rollout and compacted
journal bytes of the four recoveries must be equal. The wall clock of
both packages' fleet and journal modules is pinned
(``_torch_fleet.pin_wall``). Fake replicas here wear pids above Linux's
largest ``pid_max``, so no signal a recovery sends can reach a real
process.
"""

import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import pytest

from _torch_fleet import JAX, PORT, SIDES, FakeReplica, default_policy, pin_wall
from _torch_threads import torch_threads  # noqa: F401
from _torch_wire import StubBackend, images
from pytorch_cifar_tpu_torch.serve import (
    ControllerJournal,
    JournalFollower,
    Router,
    ServingFrontend,
)
from pytorch_cifar_tpu_torch.serve import fleet

NO_PID = 1 << 22  # above every Linux pid_max: kill() finds no process


@pytest.fixture(autouse=True)
def wall(monkeypatch):
    pin_wall(monkeypatch)


class Killed(BaseException):
    """Where a SIGKILL lands: the controller stops mid-actuation."""


class GhostReplica(FakeReplica):
    def __init__(self, idx, kill_on_drain=False):
        super().__init__(idx)
        self.pid = NO_PID + 100 + idx
        self.kill_on_drain = kill_on_drain

    def decommission(self, timeout_s=60.0):
        if self.kill_on_drain:
            raise Killed(f"SIGKILL while draining replica {self.idx}")
        return super().decommission(timeout_s)


def run_until_killed(side, tmp, kill):
    """Drive one package's journaled controller over ghost replicas until
    the kill point; returns the journal path. ``kill``: ``surge`` (during
    the rollout's surge spawn), ``rollout-drain`` (while the rollout
    drains an old replica) or ``scale-down`` (while a scale-down drains)."""
    path = str(tmp / "fleet.journal")
    jr = side.journal.ControllerJournal(path)
    gen = {"probe": 1, "launch": 1}

    def launcher(idx):
        if kill == "surge" and gen["launch"] == 2:
            raise Killed("SIGKILL during the surge spawn")
        r = GhostReplica(idx, kill_on_drain=False)
        r.health["promotion_generation"] = gen["launch"]
        return r

    sig = {"s": side.fleet.FleetSignals(healthy=3, queued=6)}  # in band
    ctl = side.fleet.FleetController(
        side.Router([], allow_empty=True), launcher,
        default_policy(side, max_replicas=4, down_after_s=1.0,
                       down_cooldown_s=1.0),
        scrape=lambda: sig["s"], registry=side.MetricsRegistry(),
        clock=lambda: 0.0, journal=jr,
        generation_probe=lambda: gen["probe"],
    )
    assert ctl.seed(3) == 3
    now = 0.0
    assert ctl.control_once(now=now) == "hold"  # baselines generation 1
    try:
        if kill == "scale-down":
            for h in ctl.replicas().values():
                h.kill_on_drain = True
            sig["s"] = side.fleet.FleetSignals(healthy=3)  # idle
            for now in (1.0, 2.5):
                ctl.control_once(now=now)
        else:
            gen["probe"] = gen["launch"] = 2
            for step in range(1, 10):
                if kill == "rollout-drain" and ctl.rollout is not None \
                        and ctl.rollout["phase"] == "converting":
                    for h in ctl.replicas().values():
                        h.kill_on_drain = h.generation == 1
                ctl.control_once(now=float(step))
    except Killed:
        pass
    else:
        raise AssertionError(f"the controller never reached {kill!r}")
    jr.close()  # the process is gone: nothing more reaches the journal
    return path


def recover(side, path, alive_urls):
    """Recover ``path`` with ``side``'s package; what it decided."""
    probed, spawned = [], []
    rt = side.Router([], allow_empty=True)
    jr = side.journal.ControllerJournal(path)
    state = side.journal.FleetJournalState.from_records(jr.records())
    alive_pids = {info["pid"] for url, info in state.replicas.items()
                  if url in alive_urls and not info.get("draining")}

    def probe(url):
        probed.append(url)
        return ({"compiles": 3, "promotion_generation":
                 state.replicas[url]["generation"]}
                if url in alive_urls else None)

    ctl = side.fleet.recover_controller(
        jr, rt, lambda idx: spawned.append(idx) or GhostReplica(idx),
        default_policy(side, max_replicas=4),
        scrape=lambda: side.fleet.FleetSignals(healthy=1),
        probe=probe, pid_check=lambda pid: pid in alive_pids,
        registry=side.MetricsRegistry(), clock=lambda: 50.0,
    )
    jr.close()
    files = {}
    for suffix in ("", ".snapshot", ".snapshot.json"):
        with open(path + suffix, "rb") as f:
            files[suffix] = f.read()
    return {
        "adopted": {u: (h.idx, h.pid, h.generation)
                    for u, h in sorted(ctl.replicas().items())},
        "router": [r.url for r in rt.replicas],
        "probed": probed,
        "spawned": spawned,
        "stats": ctl.stats,
        "rollout": ctl.rollout,
        "evaluator": (ctl.evaluator.pressure_since, ctl.evaluator.idle_since,
                      ctl.evaluator.last_up, ctl.evaluator.last_down,
                      ctl.evaluator.last_expired),
        "files": files,
    }


@pytest.mark.parametrize("kill", ["surge", "rollout-drain", "scale-down"])
def test_recovery_across_packages(kill, tmp_path):
    written = {}
    for side in SIDES:
        (tmp_path / side.name).mkdir()
        written[side.name] = run_until_killed(side, tmp_path / side.name,
                                              kill)
    with open(written["jax"], "rb") as a, open(written["port"], "rb") as b:
        assert a.read() == b.read()  # the two writers' journals, bytes
    state = PORT.journal.FleetJournalState.from_records(
        PORT.journal.replay_journal(written["port"])[0])
    live = sorted(state.replicas)
    alive = set(live[1:])  # the first replica died with the controller
    got = {}
    for writer in SIDES:
        for reader in SIDES:
            copy = tmp_path / f"{writer.name}_by_{reader.name}"
            copy.mkdir()
            dst = str(copy / "fleet.journal")
            shutil.copy(written[writer.name], dst)
            got[(writer.name, reader.name)] = recover(reader, dst, alive)
    first = got[("jax", "jax")]
    for key, rec in got.items():
        assert rec == first, key
    # what the recovery did: adopt the living, reap the dead, finish the
    # interrupted drain, never spawn
    assert first["spawned"] == []
    assert first["stats"]["journal_replays"] == 1
    draining = {u for u, i in state.replicas.items() if i.get("draining")}
    assert set(first["adopted"]) == alive - draining
    assert first["stats"]["adoptions"] == len(alive - draining)
    assert first["stats"]["replica_failures"] == len(
        set(live) - alive - draining)
    assert not set(first["probed"]) & draining
    if kill == "scale-down":
        assert draining and first["rollout"] is None
    else:
        assert first["rollout"]["to_generation"] == 2
        assert first["rollout"]["phase"] == (
            "surge" if kill == "surge" else "converting")
        assert bool(draining) == (kill == "rollout-drain")


# ---------------------------------------------------------------------
# the journal follower
# ---------------------------------------------------------------------


def follow(side, path):
    rt = side.Router([], allow_empty=True)
    return rt, side.journal.JournalFollower(path, rt, poll_s=0.05)


def test_follower_tracks_adds_removes_torn_tail_and_holds_on_corrupt(
        tmp_path):
    """Both packages' followers over one journal, step by step: adds,
    removes, a torn tail (dropped: the next poll converges) and a corrupt
    record (the last applied membership holds)."""
    path = str(tmp_path / "fleet.journal")
    jr = ControllerJournal(path)
    pair = [follow(side, path) for side in SIDES]

    def sync():
        views = []
        for rt, fo in pair:
            fo.sync_once()
            views.append(([r.url for r in rt.replicas], fo.syncs,
                          fo.corrupt_polls))
        assert views[0] == views[1]
        return views[1]

    urls = [f"http://127.0.0.1:{9300 + i}" for i in range(3)]
    assert sync() == ([], 1, 0)
    for i, u in enumerate(urls):
        jr.append("spawn-intent", idx=i)
        jr.append("replica-up", idx=i, url=u, pid=NO_PID + i, generation=1)
    assert sync() == (urls, 2, 0)
    jr.append("drain-intent", idx=0, url=urls[0])
    assert sync()[0] == urls[1:]  # draining: out of rotation at once
    jr.append("drain-done", idx=0, url=urls[0])
    jr.append("reap", idx=1, url=urls[1], pid=NO_PID + 1)
    assert sync()[0] == urls[2:]
    # a torn tail (a crash mid-append) is dropped, never applied
    jr.close()
    with open(path, "ab") as f:
        f.write(b'{"seq": 99, "op": "replica-up", "url": "http://127.0.0.1:94')
    assert sync() == (urls[2:], 5, 0)
    # a corrupt record before the end: the follower holds membership
    with open(path, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    lines[1] = lines[1][:-9] + b"XXXXXXXX\n"
    with open(path, "wb") as f:
        f.write(b"".join(lines[:-1]))
    assert sync() == (urls[2:], 5, 1)
    assert sync() == (urls[2:], 5, 2)


@pytest.mark.parametrize("transport", ["threaded", "event"])
def test_follower_moves_a_live_router_on_both_transports(transport,
                                                         tmp_path):
    """A started port Router that began empty follows the journal: a
    replica the journal adds later takes traffic (the event transport's
    EdgePool opens connections to a URL it did not start with), a
    replaced one stops taking it."""
    a = ServingFrontend(StubBackend(tag=1.0)).start()
    b = ServingFrontend(StubBackend(tag=2.0)).start()
    rt = Router([], allow_empty=True, transport=transport, probe_s=0.05)
    rt.start()
    path = str(tmp_path / "fleet.journal")
    jr = ControllerJournal(path)
    fo = JournalFollower(path, rt, poll_s=0.02).start()

    def wait_for(urls):
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if sorted(rt.fleet_view()) == sorted(urls):
                return True
            time.sleep(0.01)
        return False

    try:
        x = images(3)
        jr.append("replica-up", idx=0, url=a.url, pid=NO_PID, generation=1)
        assert wait_for([a.url])
        assert rt.predict(x)[:, 0].tolist() == [1.0] * 3
        jr.append("replica-up", idx=1, url=b.url, pid=NO_PID + 1,
                  generation=2)
        jr.append("drain-intent", idx=0, url=a.url)
        assert wait_for([b.url])
        assert rt.predict(x)[:, 0].tolist() == [2.0] * 3
        assert fo.corrupt_polls == 0 and fo.syncs >= 2
    finally:
        fo.stop()
        jr.close()
        rt.stop()
        a.stop()
        b.stop()
    assert fo._thread is None


# ---------------------------------------------------------------------
# the pid guard and the adopted-replica handle
# ---------------------------------------------------------------------


def _spawn(argv):
    return subprocess.Popen(argv, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def test_pid_guard_names_the_ports_replica_module():
    """The guard recognises a live child whose argv names
    ``pytorch_cifar_tpu_torch.serve`` (the JAX package's, which looks for
    ``serve.py``, does not: recovery on the card would reap every live
    replica), and refuses a plain ``sleep``, a dead pid and no pid."""
    sleeper = [sys.executable, "-c", "import time; time.sleep(60)"]
    replica = _spawn(sleeper + [fleet.REPLICA_MODULE])
    plain = _spawn(["sleep", "60"])
    dead = _spawn(["true"])
    dead.wait(timeout=30)
    try:
        assert fleet.pid_is_serve_replica(replica.pid)
        assert not JAX.fleet.pid_is_serve_replica(replica.pid)
        assert not fleet.pid_is_serve_replica(plain.pid)
        assert not fleet.pid_is_serve_replica(dead.pid)
        assert not fleet.pid_is_serve_replica(None)
        assert not fleet.pid_is_serve_replica(NO_PID)
    finally:
        for p in (replica, plain):
            p.kill()
            p.wait(timeout=30)


def test_adopted_replica_drains_a_live_process():
    """An adopted replica (no Popen: a predecessor's child) drains by pid:
    SIGTERM, then liveness by signal 0 and /proc's zombie state."""
    code = ("import signal, sys, time\n"
            "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
            "time.sleep(60)\n")
    child = _spawn([sys.executable, "-c", code, fleet.REPLICA_MODULE])
    reaper = threading.Thread(target=child.wait)
    try:
        time.sleep(0.5)  # the handler is installed
        handle = fleet.AdoptedReplica(4, "http://127.0.0.1:9", child.pid,
                                      generation=2)
        assert handle.alive() and handle.proc.returncode is None
        drain_s = handle.decommission(timeout_s=20)
        reaper.start()
        reaper.join(timeout=30)
        assert not handle.alive() and drain_s < 20
        assert child.returncode == 0  # drained on SIGTERM, not killed
    finally:
        if child.poll() is None:
            child.send_signal(signal.SIGKILL)
            child.wait(timeout=30)
    assert not os.path.exists(f"/proc/{child.pid}/cmdline") or \
        not fleet.pid_is_serve_replica(child.pid)


# ---------------------------------------------------------------------
# the launchers' start and their and the replicas' wait for SIGTERM
# ---------------------------------------------------------------------


def test_launchers_and_the_control_plane_load_no_torch():
    """Both launchers and everything the router, the frontends, the
    journal and the controller need import without torch (a launcher,
    and a controller restarted after a crash, start without the seconds
    of ``import torch``); the serve package's names still resolve, to
    the submodules' own objects."""
    code = (
        "import sys\n"
        "from pytorch_cifar_tpu_torch.tools import fleet_run, router_run\n"
        "from pytorch_cifar_tpu_torch.serve import (\n"
        "    EdgeFrontend, FleetController, HttpGoldenGate, HttpTarget,\n"
        "    JournalFollower, Router, ServingFrontend, UnknownModel,\n"
        "    recover_controller, run_async_load)\n"
        "assert 'torch' not in sys.modules, 'torch was loaded'\n"
        "from pytorch_cifar_tpu_torch.serve import InferenceEngine, tenancy\n"
        "from pytorch_cifar_tpu_torch.serve.engine import InferenceEngine as E\n"
        "assert InferenceEngine is E and tenancy.UnknownModel is UnknownModel\n"
        "assert 'torch' in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_wait_for_stop_runs_a_handler_another_thread_received():
    """A signal the kernel hands to another thread than the main one (here
    the main thread blocks it) interrupts no untimed wait of the main
    thread; ``wait_for_stop`` wakes on its tick, runs the handler and
    returns. It also returns once its duration passed."""
    from pytorch_cifar_tpu_torch.utils.signals import wait_for_stop

    stop, ready = threading.Event(), threading.Event()
    old = signal.signal(signal.SIGUSR1, lambda *a: stop.set())

    def sender():  # created before the main thread blocks the signal
        ready.wait(timeout=30)
        os.kill(os.getpid(), signal.SIGUSR1)

    t = threading.Thread(target=sender)
    t.start()
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGUSR1})
    try:
        t0 = time.monotonic()
        ready.set()
        wait_for_stop(stop, duration_s=20.0)
        assert stop.is_set() and time.monotonic() - t0 < 10
    finally:
        signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGUSR1})
        signal.signal(signal.SIGUSR1, old)
        t.join(timeout=30)
    # the deadline is kept, not rounded up to a whole tick (0.5 s, 1.0 s)
    t0 = time.monotonic()
    wait_for_stop(threading.Event(), duration_s=0.6)
    assert 0.6 <= time.monotonic() - t0 < 1.0


def test_replica_process_keeps_and_forwards_the_exit_record(capsys):
    """``ReplicaProcess`` over a stand-in child that speaks the serving
    CLI's protocol: the URL from the ready line, one SIGTERM drains it,
    and the JSON line it prints at exit is kept as ``exit_record`` and
    forwarded on stderr under ``[replica i]``."""
    code = (
        "import signal, sys, threading\n"
        "stop = threading.Event()\n"
        "signal.signal(signal.SIGTERM, lambda *a: stop.set())\n"
        "print('==> http: serving on http://127.0.0.1:9', file=sys.stderr,"
        " flush=True)\n"
        "while not stop.wait(0.05): pass\n"
        "print('{\"launches_by_kernel\": {\"conv3x3_bn_relu\": 18}}')\n")
    handle = fleet.ReplicaProcess(
        7, [sys.executable, "-c", code, fleet.REPLICA_MODULE])
    try:
        assert handle.wait_url(30) == "http://127.0.0.1:9"
        assert handle.alive() and fleet.pid_is_serve_replica(handle.pid)
        handle.terminate()
        handle.terminate()  # SIGTERM goes once
        assert handle.decommission(timeout_s=30) < 30
    finally:
        if handle.alive():
            handle.proc.kill()
            handle.proc.wait(timeout=30)
    assert handle.proc.returncode == 0
    assert handle.exit_record == (
        '{"launches_by_kernel": {"conv3x3_bn_relu": 18}}')
    err = capsys.readouterr().err
    assert "[replica 7] ==> http: serving on http://127.0.0.1:9" in err
    assert ('[replica 7] {"launches_by_kernel": {"conv3x3_bn_relu": 18}}'
            in err)
    assert handle.decommission(timeout_s=5) < 5  # idempotent on a corpse
