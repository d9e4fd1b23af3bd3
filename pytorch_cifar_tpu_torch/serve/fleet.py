"""Elastic fleet controller: autoscaling serving replicas.

A copy of ``pytorch_cifar_tpu/serve/fleet.py`` for the port: the same
policy arithmetic, journal records, ``serve.fleet.*`` metric names and
``==> fleet: ...`` stderr lines, over the port's router, journal,
checkpoint module and serving CLI. The control plane turns load swings and
replica deaths into automatic, bounded-latency events:

- :class:`FleetPolicy`: the deterministic scaling policy: a
  target-utilization band on per-replica load (queued + in-flight work)
  with hysteresis (``queue_high`` > ``queue_low``), per-direction
  sustained-signal windows (``up_after_s`` / ``down_after_s``) and
  cooldowns, hard ``min_replicas`` / ``max_replicas`` bounds, plus the
  latency-side triggers: a p99 bound and deadline-expiry deltas. Pure
  data + arithmetic: no clocks, no I/O, so tests drive it exactly.
- :class:`FleetSignals`: one scrape of the fleet's existing
  observability surfaces: the router ``/healthz`` (per-replica queue
  depth, in-flight counts, health) and the fleet frontend's Prometheus
  ``/metrics`` (router latency histogram -> p99, edge 504s -> deadline
  expiries).
- :class:`FleetController`: the loop: scrape -> evaluate -> actuate.
  Scale-up spawns a replica (``python -m pytorch_cifar_tpu_torch.serve
  --http_port 0``, on the card unless ``--device cpu``), waits for
  ``/healthz`` to go green, and registers it with the live
  :class:`~pytorch_cifar_tpu_torch.serve.router.Router`
  (:meth:`~pytorch_cifar_tpu_torch.serve.router.Router.add_replica`). The
  replicas share a cold-start cache (``--aot_cache``): the first replica
  of a weight set prepares and exports it, every later one imports it and
  joins with ``compiles`` at 0. Scale-down happens only when a
  drain costs nothing (the victim has no router-side in-flight work and
  an empty queue): the replica is removed from rotation FIRST (no new
  dispatches), then SIGTERM'd (the serving CLI's graceful drain answers
  everything already admitted), and the process is ALWAYS reaped (wait,
  kill as backstop). A replica that dies under the controller
  (preemption, SIGKILL) is reaped, deregistered, and replaced by the
  ``min_replicas`` floor, which bypasses pressure timing (an outage is
  not a load signal) but still never exceeds ``max_replicas``.

The clock is injectable (``clock=``), every decision is taken in
``control_once()`` (the background thread just calls it on an
interval), and the actuator is a plain callable, so the whole policy
state machine is unit-testable with zero subprocesses and zero sleeps.

Durable control plane: with a
:class:`~pytorch_cifar_tpu_torch.serve.journal.ControllerJournal` attached,
every actuation is journaled append-durably BEFORE it is taken: spawn
intent before the fork, replica-up before the traffic shift, drain intent
before the deregister+SIGTERM, reap before the removal, plus the
scaling-window/cooldown stamps and rollout state. :func:`recover_controller`
replays the journal against live ``/healthz`` probes: replicas that still
answer (and whose pid is still a port replica, :func:`pid_is_serve_replica`)
are re-adopted as :class:`AdoptedReplica` handles, dead ones are
reaped-and-replaced by the ``min_replicas`` floor, and nothing is ever
double-spawned: a controller crash stops decisions, never the fleet.
Generation-aware rolling deploys ride the same loop: when the live dir's
promotion-generation stamp moves, the controller surges ONE replica on the
new generation (gated by :class:`HttpGoldenGate` before it takes traffic),
then converts the fleet one replica at a time (spawn new, drain old) and
halts + rolls back fleet-wide, restoring the ``.prev`` publish pair, the
moment a surge canary regresses.

Telemetry: ``serve.fleet.replicas`` (gauge), ``serve.fleet.pressure``
(gauge: the per-replica load the band compares against),
``serve.fleet.generation`` (gauge: the serving checkpoint generation),
``serve.fleet.scale_ups`` / ``serve.fleet.scale_downs`` /
``serve.fleet.replica_failures`` / ``serve.fleet.scrape_errors`` /
``serve.fleet.journal_replays`` / ``serve.fleet.adoptions`` /
``serve.fleet.rollouts`` / ``serve.fleet.rollbacks`` (counters),
``serve.fleet.spawn_ms`` / ``serve.fleet.drain_ms`` (histograms); the
journal itself counts ``serve.fleet.journal_appends``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from pytorch_cifar_tpu_torch.obs import MetricsRegistry

log = logging.getLogger(__name__)

# the replicas' serving CLI (``python -m``); the pid-reuse guard matches it
REPLICA_MODULE = "pytorch_cifar_tpu_torch.serve"
# the ready line the serving CLI prints; the pump thread parses the
# replica URL from it (the same contract tools/router_run.py consumes)
_URL_RE = re.compile(r"==> http: serving on (http://\S+)")


# ---------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------


@dataclasses.dataclass
class FleetPolicy:
    """Deterministic scaling policy (module docstring).

    ``queue_high``/``queue_low`` bound the per-replica load — queued
    images (both priority lanes) plus router-side in-flight requests,
    divided by the healthy replica count. The band IS the hysteresis:
    load between the two thresholds holds the fleet steady, and the
    sustained-signal windows + cooldowns keep a bursty minute from
    flapping replicas up and down."""

    min_replicas: int = 1
    max_replicas: int = 4
    # target-utilization band on per-replica load
    queue_high: float = 8.0
    queue_low: float = 1.0
    # latency-side scale-up triggers: 0 disables the p99 trigger;
    # deadline expiries always count (an expiry is never acceptable)
    p99_high_ms: float = 0.0
    # sustained-signal windows: pressure/idle must hold this long
    up_after_s: float = 2.0
    down_after_s: float = 10.0
    # per-direction cooldowns since the LAST action in that direction
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 20.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.queue_low > self.queue_high:
            raise ValueError(
                "queue_low must be <= queue_high (the hysteresis band)"
            )


@dataclasses.dataclass
class FleetSignals:
    """One observation of the fleet, scraped from the existing
    ``/healthz`` + ``/metrics`` surfaces (or constructed directly by
    tests). ``deadline_expired`` is CUMULATIVE (the edge's 504 counter);
    the controller differences consecutive scrapes."""

    healthy: int = 0
    queued: int = 0          # summed per-replica queue depth, both lanes
    bulk_queued: int = 0     # the bulk-lane share of `queued`
    in_flight: int = 0       # router-side dispatched-not-yet-answered
    deadline_expired: float = 0.0  # cumulative fleet-edge 504s
    p99_ms: float = 0.0      # router-observed request latency p99

    @property
    def load_per_replica(self) -> float:
        """The number the utilization band compares against."""
        return (self.queued + self.in_flight) / max(self.healthy, 1)

    @staticmethod
    def from_http(health: dict, prom_text: str = "") -> "FleetSignals":
        """Build signals from a router ``/healthz`` payload plus the
        fleet frontend's Prometheus ``/metrics`` text. Tolerant of
        partial payloads (a replica mid-join may not report queue stats
        yet): missing fields read as zero, never raise."""
        queued = bulk = in_flight = 0
        for rep in health.get("replicas", ()):
            in_flight += int(rep.get("in_flight") or 0)
            q = (rep.get("health") or {}).get("queued")
            if isinstance(q, dict):
                queued += sum(int(v or 0) for v in q.values())
                bulk += int(q.get("bulk") or 0)
            elif q:
                queued += int(q)
        return FleetSignals(
            healthy=int(health.get("healthy_replicas") or 0),
            queued=queued,
            bulk_queued=bulk,
            in_flight=in_flight,
            deadline_expired=parse_prom_counter(
                prom_text, "pct_serve_http_504"
            ),
            p99_ms=parse_prom_histogram_percentile(
                prom_text, "pct_router_latency_ms", 99.0
            ),
        )


def parse_prom_counter(text: str, name: str) -> float:
    """Value of counter ``name`` in Prometheus exposition text (0.0 when
    absent — a counter nobody incremented is never exported)."""
    m = re.search(
        r"^%s ([0-9.eE+-]+)$" % re.escape(name), text, re.MULTILINE
    )
    return float(m.group(1)) if m else 0.0


def parse_prom_histogram_percentile(
    text: str, name: str, pct: float
) -> float:
    """Percentile estimate from a Prometheus cumulative-bucket series:
    the upper bound of the first bucket whose cumulative count reaches
    the rank (the standard coarse estimate; the controller only
    thresholds it). 0.0 when the histogram is absent or empty."""
    buckets: List[tuple] = []  # (bound, cumulative_count)
    for m in re.finditer(
        r'^%s_bucket\{le="([^"]+)"\} ([0-9.eE+-]+)$' % re.escape(name),
        text,
        re.MULTILINE,
    ):
        bound = float("inf") if m.group(1) == "+Inf" else float(m.group(1))
        buckets.append((bound, float(m.group(2))))
    if not buckets:
        return 0.0
    buckets.sort(key=lambda b: b[0])
    total = buckets[-1][1]
    if total <= 0:
        return 0.0
    rank = pct / 100.0 * total
    last_finite = 0.0
    for bound, cum in buckets:
        if bound != float("inf"):
            last_finite = bound
        if cum >= rank:
            return bound if bound != float("inf") else last_finite
    return last_finite


def scrape_fleet(url: str, timeout_s: float = 5.0) -> FleetSignals:
    """The default scrape: GET ``/healthz`` + ``/metrics`` on the fleet
    frontend (the router's own health payload embeds every replica's
    last probed health, so one endpoint shows the whole fleet). Raises
    OSError/ValueError on an unreachable or unparseable fleet — the
    controller counts the miss and holds."""
    import json
    import urllib.error
    import urllib.request

    def get(path):
        try:
            with urllib.request.urlopen(url + path, timeout=timeout_s) as r:
                return r.read().decode("utf-8")
        except urllib.error.HTTPError as e:
            # /healthz answers 503 when unhealthy — the body is still
            # the health payload and the controller wants to read it
            return e.read().decode("utf-8")

    health = json.loads(get("/healthz"))
    prom = get("/metrics")
    return FleetSignals.from_http(health, prom)


class ScalingEvaluator:
    """The deterministic decision state machine: feed it one
    (signals, replica count, now) observation per sweep and it answers
    ``("up"|"down"|"hold", reason)``. Pure arithmetic over the policy —
    no clocks (``now`` is an argument), no I/O, no threads: the
    controller owns the single thread that drives it, so every field
    here is single-writer by construction, and tests can replay any
    pressure history exactly.

    The controller reports back with :meth:`acted_up` /
    :meth:`acted_down` after a SUCCESSFUL actuation — cooldowns stamp
    from completed actions, not attempts (a failed spawn must not eat
    the cooldown and delay the retry)."""

    def __init__(self, policy: FleetPolicy):
        self.policy = policy
        self.pressure_since: Optional[float] = None
        self.idle_since: Optional[float] = None
        self.last_up: Optional[float] = None
        self.last_down: Optional[float] = None
        self.last_expired = 0.0
        self.last_signals: Optional[FleetSignals] = None

    def observe_only(self, signals: FleetSignals) -> None:
        """Advance the expiry baseline WITHOUT evaluating — used while a
        rolling deploy owns actuation, so the post-deploy evaluator
        doesn't read the whole deploy's 504 delta as fresh pressure."""
        self.last_signals = signals
        self.last_expired = signals.deadline_expired

    def evaluate(self, signals: FleetSignals, n: int, now: float):
        """One sweep's verdict. ``n`` is the managed replica count (the
        authoritative one — the scraped ``healthy`` can lag a join)."""
        p = self.policy
        self.last_signals = signals
        # min-replicas floor first: a dead replica is replaced
        # immediately — an outage is not a load signal, so neither the
        # pressure window nor the up-cooldown applies
        if n < p.min_replicas:
            return "up", "min-replicas floor"
        expired_delta = max(
            0.0, signals.deadline_expired - self.last_expired
        )
        self.last_expired = signals.deadline_expired
        load = signals.load_per_replica
        p99_bad = p.p99_high_ms > 0 and signals.p99_ms > p.p99_high_ms
        up_pressure = load > p.queue_high or expired_delta > 0 or p99_bad
        idle = (
            load < p.queue_low and expired_delta == 0 and not p99_bad
        )

        if up_pressure:
            self.idle_since = None
            if self.pressure_since is None:
                self.pressure_since = now
            sustained = now - self.pressure_since >= p.up_after_s
            cooled = (
                self.last_up is None
                or now - self.last_up >= p.up_cooldown_s
            )
            if sustained and cooled and n < p.max_replicas:
                if load > p.queue_high:
                    reason = f"load {load:.1f} > {p.queue_high:.1f}"
                elif expired_delta > 0:
                    reason = f"{expired_delta:.0f} deadline expiries"
                else:
                    reason = f"p99 {signals.p99_ms:.0f}ms"
                return "up", reason
            return "hold", "pressure building"

        self.pressure_since = None
        if not idle:
            # inside the hysteresis band: steady state, windows reset
            self.idle_since = None
            return "hold", "in band"
        if self.idle_since is None:
            self.idle_since = now
        sustained = now - self.idle_since >= p.down_after_s
        cooled = (
            self.last_down is None
            or now - self.last_down >= p.down_cooldown_s
        )
        if sustained and cooled and n > p.min_replicas:
            return "down", f"load {load:.1f} < {p.queue_low:.1f}"
        return "hold", "idle building"

    def acted_up(self, now: float) -> None:
        self.last_up = now
        self.pressure_since = None

    def acted_down(self, now: float) -> None:
        self.last_down = now
        self.idle_since = None


# ---------------------------------------------------------------------
# replica process lifecycle (the router_run actuation path)
# ---------------------------------------------------------------------


def repo_root() -> str:
    """The checkout root (the directory holding the port package)."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


class ReplicaProcess:
    """One spawned ``python -m pytorch_cifar_tpu_torch.serve --http_port
    0`` replica: the subprocess, a stderr pump thread (forwards lines with
    a ``[replica i]`` prefix and captures the frontend URL from the ready
    line), and the drain-aware decommission path. Same process contract
    as ``tools/router_run.py``'s launcher: SIGTERM is the graceful-drain
    signal, and the handle is ALWAYS reaped (wait, kill backstop).

    The serving CLI prints its one JSON record (with
    ``launches_by_kernel``) on stdout when it exits; ``decommission``
    reads it, keeps the text on the handle as ``exit_record`` and forwards
    it to stderr under the same ``[replica i]`` prefix, so a launcher's
    reader can count each drained replica's kernel launches.

    A multi-process replica (``--mesh_procs``) is its leader's handle with
    the follower ranks in ``followers`` (handles of their own, which print
    no URL): the router sees the leader alone, and ``decommission`` drains
    leader first, then waits for every follower to exit on its own (the
    leader's shutdown broadcast ends its loop; a dead leader, its
    watchdog) before any backstop: a signal sent to a follower that is
    already exiting would land after its interpreter restored the default
    handler and kill it mid-exit."""

    def __init__(self, idx, cmd: List[str], env: Optional[dict] = None,
                 cwd: Optional[str] = None, followers=()):
        self.idx = idx
        self.cmd = list(cmd)
        self.followers = list(followers)
        self.proc = subprocess.Popen(
            self.cmd,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            cwd=cwd or repo_root(),
        )
        self.health: dict = {}
        self.exit_record: Optional[str] = None
        # SIGTERM is sent once: a second one can land while the replica
        # is already exiting, after the interpreter has restored the
        # default handler, and kill it mid-exit
        self._termed = False
        # _url is written by the pump thread, read by wait_url callers
        self._lock = threading.Lock()
        self._url: Optional[str] = None
        self._url_ready = threading.Event()
        self._thread = threading.Thread(
            target=self._pump, name=f"fleet-replica-stderr-{idx}",
            daemon=True,
        )
        self._thread.start()

    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def url(self) -> Optional[str]:
        with self._lock:
            return self._url

    def _pump(self) -> None:
        for line in self.proc.stderr:
            m = _URL_RE.search(line)
            if m:
                with self._lock:
                    self._url = m.group(1)
                self._url_ready.set()
            sys.stderr.write(f"[replica {self.idx}] {line}")
        self._url_ready.set()  # EOF unblocks a waiter even on crash

    def wait_url(self, timeout_s: float) -> Optional[str]:
        self._url_ready.wait(timeout_s)
        return self.url

    def alive(self) -> bool:
        return self.proc.poll() is None

    def terminate(self) -> None:
        """Send the drain signal (SIGTERM) once, without waiting: a
        launcher drains a whole fleet at once, then reaps each."""
        if self.alive() and not self._termed:
            self._termed = True
            try:
                self.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass

    def wait_healthy(self, timeout_s: float) -> dict:
        """Block until ``/healthz`` answers 200; returns (and stores)
        the health payload (its ``compiles`` counts the buckets the replica
        warmed on weights it prepared itself; ``aot_cache_hits`` those it
        warmed on the cold-start cache). Raises RuntimeError when the
        replica dies or never turns healthy (the caller reaps it)."""
        from pytorch_cifar_tpu_torch.serve.router import Replica, ReplicaError

        url = self.wait_url(timeout_s)
        if url is None or not self.alive():
            raise RuntimeError(
                f"replica {self.idx} exited rc={self.proc.returncode} "
                "before its frontend came up"
            )
        client = Replica(url, timeout_s=5.0)
        deadline = time.monotonic() + timeout_s
        try:
            while time.monotonic() < deadline:
                if not self.alive():
                    raise RuntimeError(
                        f"replica {self.idx} died during warmup "
                        f"(rc={self.proc.returncode})"
                    )
                try:
                    status, health = client.request("GET", "/healthz")
                except ReplicaError:
                    time.sleep(0.1)
                    continue
                if status == 200:
                    self.health = health
                    return health
                time.sleep(0.1)
        finally:
            client.close()
        raise RuntimeError(f"replica {self.idx} never became healthy")

    def decommission(self, timeout_s: float = 60.0,
                     drain_signal: bool = True) -> float:
        """SIGTERM (the drain signal; none with ``drain_signal=False``),
        wait, SIGKILL backstop, drain the pipes (keeping the exit record),
        join the pump thread; then each follower's, without the signal.
        Returns the drain wall seconds. Idempotent and safe on an
        already-dead process: the corpse is still reaped, never
        orphaned."""
        t0 = time.monotonic()
        if drain_signal:
            self.terminate()
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            log.warning(
                "replica %s ignored SIGTERM for %.0fs; killing",
                self.idx, timeout_s,
            )
            self.proc.kill()
            self.proc.wait()
        if self.proc.stdout is not None and not self.proc.stdout.closed:
            out = self.proc.stdout.read()
            self.proc.stdout.close()
            if out.strip():
                self.exit_record = out.strip()
                for line in self.exit_record.splitlines():
                    sys.stderr.write(f"[replica {self.idx}] {line}\n")
        self._thread.join(timeout=10)
        for f in self.followers:
            f.decommission(timeout_s=timeout_s, drain_signal=False)
        return time.monotonic() - t0


# the serving CLI's --dtype per device: bf16 on the card (the CLI's
# default), fp32 on the CPU (the tests)
REPLICA_DTYPE = {"cuda": "bfloat16", "cpu": "float32"}


def replica_command(
    ckpt: str,
    model: str,
    *,
    buckets=(1, 8, 32),
    deadline_ms: float = 0.0,
    max_wait_ms: float = 2.0,
    host: str = "127.0.0.1",
    device: str = "cuda",
    aot_cache: str = "",
    num_devices: int = 1,
    extra_args=(),
) -> List[str]:
    """The command line of one replica: the port's serving CLI as an
    HTTP replica on an ephemeral port, on ``device`` (bf16 on the card,
    fp32 on the CPU) over ``num_devices`` of them (``--num_devices``), on
    the cold-start cache ``aot_cache`` when one is named."""
    return [
        sys.executable, "-m", REPLICA_MODULE,
        "--ckpt", ckpt,
        "--model", model,
        "--http_port", "0",
        "--http_host", host,
        "--buckets", *[str(b) for b in buckets],
        "--max_wait_ms", str(max_wait_ms),
        "--deadline_ms", str(deadline_ms),
        "--device", device,
        "--dtype", REPLICA_DTYPE[device],
        "--num_devices", str(num_devices),
        *(["--aot_cache", aot_cache] if aot_cache else []),
        *extra_args,
    ]


def make_replica_launcher(
    ckpt: str,
    model: str,
    *,
    aot_cache: str,
    env: Optional[dict] = None,
    timeout_s: float = 300.0,
    **command_kw,
) -> Callable[[int], ReplicaProcess]:
    """Build the controller's spawn callable: launch one replica
    (:func:`replica_command`; ``command_kw`` are its keywords) on the
    shared cold-start cache ``aot_cache`` and block until healthy. The
    first replica of a weight set prepares its weights and exports them;
    every replica spawned on that weight set afterwards imports them and
    joins with ``compile_count == 0`` (a new generation's first replica
    prepares again: the entries are per weight set). The kernels it runs
    are built once into ``ops/build/`` and shared."""
    base_env = dict(os.environ if env is None else env)

    def launch(idx: int) -> ReplicaProcess:
        cmd = replica_command(ckpt, model, aot_cache=aot_cache,
                              **command_kw)
        replica = ReplicaProcess(idx, cmd, env=base_env)
        try:
            replica.wait_healthy(timeout_s)
        except RuntimeError:
            replica.decommission(timeout_s=10.0)
            raise
        return replica

    return launch


# ---------------------------------------------------------------------
# adoption + rolling-deploy building blocks (durable control plane)
# ---------------------------------------------------------------------


class _AdoptedProc:
    """Minimal stand-in for the ``subprocess.Popen`` a ReplicaProcess
    carries — launchers read ``handle.proc.returncode`` when recording a
    fleet teardown, and an adopted replica has no Popen to ask (it was
    reparented when its original parent died)."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: Optional[int] = None


def pid_is_serve_replica(pid) -> bool:
    """True when ``pid`` is alive AND one of its command-line arguments is
    the port's serving module (:data:`REPLICA_MODULE`, as ``python -m``
    names it): the pid-reuse guard adoption needs: a journal written
    before a crash may record a pid that some unrelated process now
    wears. Falls back to liveness-only where /proc is unavailable."""
    if pid is None:
        return False
    try:
        os.kill(int(pid), 0)
    except (OSError, ValueError):
        return False
    try:
        with open(f"/proc/{int(pid)}/cmdline", "rb") as f:
            return REPLICA_MODULE.encode() in f.read().split(b"\0")
    except OSError:
        return True  # alive; no /proc to cross-check (non-Linux)


class AdoptedReplica:
    """Handle for a replica this controller did NOT spawn: a relaunched
    controller re-adopting its predecessor's children from the journal
    (:func:`recover_controller`). There is no Popen — the child was
    reparented to init when the old controller died — so liveness is
    signal 0 (plus a /proc zombie check — signal 0 succeeds on a corpse
    the container's init never reaped) and decommission is
    SIGTERM-by-pid with the usual SIGKILL backstop; there is no
    ``Popen`` to ``wait()`` on.
    Same duck type as :class:`ReplicaProcess`: ``idx``/``url``/``pid``/
    ``health``/``generation``/``alive()``/``decommission()``."""

    def __init__(self, idx, url: str, pid, *, health: Optional[dict] = None,
                 generation=None):
        self.idx = idx
        self.url = url
        self.pid = int(pid)
        self.health: dict = dict(health or {})
        self.generation = generation
        self.proc = _AdoptedProc(self.pid)

    def alive(self) -> bool:
        try:
            os.kill(self.pid, 0)
        except OSError:
            return False
        # Signal 0 succeeds on a zombie. An orphan's corpse is reaped
        # by whatever init the container runs — which may never reap —
        # so read the state out of /proc rather than waiting out the
        # whole decommission backstop on a process that already exited.
        try:
            with open(f"/proc/{self.pid}/stat", "rb") as f:
                stat = f.read()
            return stat[stat.rindex(b")") + 2:stat.rindex(b")") + 3] != b"Z"
        except (OSError, ValueError):
            return True  # no /proc: signal 0 is the best answer we have

    def decommission(self, timeout_s: float = 60.0) -> float:
        """SIGTERM (the drain signal), poll-wait, SIGKILL backstop.
        Returns drain wall seconds, like ReplicaProcess."""
        t0 = time.monotonic()
        try:
            os.kill(self.pid, signal.SIGTERM)
        except OSError:
            return 0.0  # already gone
        deadline = t0 + timeout_s
        while time.monotonic() < deadline:
            if not self.alive():
                return time.monotonic() - t0
            time.sleep(0.05)
        log.warning(
            "adopted replica %s (pid %s) ignored SIGTERM for %.0fs; "
            "killing", self.idx, self.pid, timeout_s,
        )
        try:
            os.kill(self.pid, signal.SIGKILL)
        except OSError:
            pass
        while self.alive():
            time.sleep(0.05)
        return time.monotonic() - t0


class RemoteFleetPort:
    """Router port for a controller operating a REMOTE data plane (the
    split deployment: the edge process owns the real Router and follows
    the journal via
    :class:`~pytorch_cifar_tpu_torch.serve.journal.JournalFollower`; this
    controller process only journals). ``add_replica``/``remove_replica``
    are deliberate no-ops — the durable journal append IS the membership
    actuation, and the follower applies it — while ``fleet_view`` reads
    the edge's live ``/healthz`` so drain-victim picking still sees real
    in-flight counts."""

    def __init__(self, fleet_url: str, timeout_s: float = 5.0):
        self.fleet_url = fleet_url.rstrip("/")
        self.timeout_s = float(timeout_s)

    def add_replica(self, url: str) -> None:
        return None

    def remove_replica(self, url: str) -> None:
        return None

    def healthz(self) -> dict:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(
                self.fleet_url + "/healthz", timeout=self.timeout_s
            ) as r:
                return json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            # 503 still carries the health payload
            return json.loads(e.read().decode("utf-8"))

    def fleet_view(self) -> Dict[str, tuple]:
        """Same shape as ``Router.fleet_view``: url -> (in_flight,
        last probed health). Empty on an unreachable edge — the
        controller then finds no free drain victim and holds."""
        try:
            payload = self.healthz()
        except (OSError, ValueError):
            return {}
        return {
            rep.get("url"): (
                int(rep.get("in_flight") or 0), rep.get("health") or {}
            )
            for rep in payload.get("replicas", ())
            if rep.get("url")
        }


class HttpGoldenGate:
    """The rolling deploy's canary gate: a deterministic golden batch
    pushed through a candidate replica's OWN frontend BEFORE the router
    shifts any traffic to it. Two checks, mirroring the promotion
    controller's vetting shape (serve/canary.py): every logit row must
    be finite, and — once a baseline from an old-generation replica is
    captured — the argmax flip fraction against that baseline must stay
    under ``max_flip_frac`` (a new generation legitimately changes SOME
    answers; flipping most of them mid-deploy is a regression, not an
    improvement). Returns problem strings; empty means pass."""

    def __init__(self, n: int = 8, seed: int = 7, *,
                 max_flip_frac: float = 0.75, timeout_s: float = 60.0):
        rs = np.random.RandomState(seed)
        self.images = rs.randint(
            0, 256, size=(int(n), 32, 32, 3)
        ).astype(np.uint8)
        self.max_flip_frac = float(max_flip_frac)
        self.timeout_s = float(timeout_s)
        self.baseline: Optional[np.ndarray] = None

    def _predict(self, url: str) -> np.ndarray:
        from pytorch_cifar_tpu_torch.serve.loadgen import HttpTarget

        target = HttpTarget(url)
        try:
            return np.asarray(
                target.submit(self.images).result(timeout=self.timeout_s)
            )
        finally:
            close = getattr(target, "close", None)
            if close is not None:
                close()

    def baseline_from(self, url: str) -> None:
        self.baseline = self._predict(url)

    def check(self, url: str) -> List[str]:
        logits = self._predict(url)
        problems: List[str] = []
        finite = np.isfinite(logits).all(axis=tuple(range(1, logits.ndim)))
        if not finite.all():
            problems.append(
                f"{int((~finite).sum())}/{len(finite)} golden rows "
                "non-finite"
            )
            return problems
        if self.baseline is not None and self.baseline.shape == logits.shape:
            flips = float(
                np.mean(
                    np.argmax(logits, axis=-1)
                    != np.argmax(self.baseline, axis=-1)
                )
            )
            if flips > self.max_flip_frac:
                problems.append(
                    f"golden argmax flip fraction {flips:.2f} > "
                    f"{self.max_flip_frac:.2f} vs old generation"
                )
        return problems


def live_generation_probe(
    ckpt_dir: str, name: str = "ckpt.msgpack"
) -> Callable[[], Optional[int]]:
    """The controller's rollout trigger: a callable reading the live
    dir's promotion-generation stamp from the publish sidecar (the
    ``promotion.generation`` the canary pipeline writes via
    ``publish_checkpoint(extra_meta=...)``). Plain file read, no
    checkpoint import, because the controller process never loads a
    model. None when the sidecar is missing, torn, or unstamped."""
    side = os.path.join(
        ckpt_dir, os.path.splitext(name)[0] + ".json"
    )

    def probe() -> Optional[int]:
        try:
            with open(side) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None
        gen = (meta.get("promotion") or {}).get("generation")
        return None if gen is None else int(gen)

    return probe


def live_rollback(
    ckpt_dir: str, name: str = "ckpt.msgpack"
) -> Callable[[], bool]:
    """The controller's halt-and-roll-back action: republish the
    ``.prev`` pair over the live publish (checkpoint layer's
    ``restore_previous_publish``). The checkpoint module carries torch
    and the codec, and the rollback path is the only place the
    controller touches it: it is imported on a background thread from
    here on, so that the controller starts without it and a rollback
    (on the card, with replicas busy on the host's cores) does not wait
    for ``import torch``."""
    threading.Thread(
        target=importlib.import_module,
        args=("pytorch_cifar_tpu_torch.train.checkpoint",),
        name="fleet-rollback-import",
        daemon=True,
    ).start()

    def rollback() -> bool:
        from pytorch_cifar_tpu_torch.train.checkpoint import (
            restore_previous_publish,
        )

        return restore_previous_publish(ckpt_dir, name)

    return rollback


# ---------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------


class FleetController:
    """Scrape → evaluate → actuate (module docstring).

    ``launcher(idx) -> handle`` spawns one replica and returns a handle
    with ``url``/``health``/``alive()``/``decommission()`` (a
    :class:`ReplicaProcess`, or a test fake). ``scrape() ->
    FleetSignals`` reads the fleet (default: :func:`scrape_fleet` on the
    fleet frontend URL). All policy state advances only inside
    :meth:`control_once`, stamped by the injectable ``clock`` — the
    background thread (``start()``/``stop()``) just calls it every
    ``interval_s``."""

    def __init__(
        self,
        router,
        launcher: Callable[[int], object],
        policy: FleetPolicy,
        *,
        scrape: Callable[[], FleetSignals],
        registry: Optional[MetricsRegistry] = None,
        interval_s: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
        drain_timeout_s: float = 60.0,
        journal=None,
        generation: Optional[int] = None,
        generation_probe: Optional[Callable[[], Optional[int]]] = None,
        rollout_gate=None,
        rollback: Optional[Callable[[], bool]] = None,
    ):
        self.router = router
        self.launcher = launcher
        self.policy = policy
        self.scrape = scrape
        self.interval_s = float(interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._clock = clock
        # durable control plane: the actuation journal (None = memory-only,
        # as before journaling) and the rolling-deploy collaborators
        self.journal = journal
        self.generation = generation
        self.generation_probe = generation_probe
        self.rollout_gate = rollout_gate
        self.rollback = rollback
        self.rollout: Optional[dict] = None
        self._last_policy_stamp = None
        self.obs = registry if registry is not None else MetricsRegistry()
        self._g_replicas = self.obs.gauge("serve.fleet.replicas")
        self._g_pressure = self.obs.gauge("serve.fleet.pressure")
        self._g_generation = self.obs.gauge("serve.fleet.generation")
        self._c_ups = self.obs.counter("serve.fleet.scale_ups")
        self._c_downs = self.obs.counter("serve.fleet.scale_downs")
        self._c_failures = self.obs.counter("serve.fleet.replica_failures")
        self._c_scrape_errors = self.obs.counter("serve.fleet.scrape_errors")
        self._c_replays = self.obs.counter("serve.fleet.journal_replays")
        self._c_adoptions = self.obs.counter("serve.fleet.adoptions")
        self._c_rollouts = self.obs.counter("serve.fleet.rollouts")
        self._c_rollbacks = self.obs.counter("serve.fleet.rollbacks")
        self._h_spawn = self.obs.histogram("serve.fleet.spawn_ms")
        self._h_drain = self.obs.histogram("serve.fleet.drain_ms")
        # managed replicas: url -> handle. Guarded by _lock (the control
        # thread and adopt()/stop() callers both touch it); every
        # blocking operation (scrape, spawn, drain) runs OUTSIDE it.
        self._lock = threading.Lock()
        self._replicas: Dict[str, object] = {}
        self._next_idx = 0
        # the decision state machine: driven ONLY by control_once (one
        # thread), so its fields need no lock — see ScalingEvaluator
        self.evaluator = ScalingEvaluator(policy)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if generation is not None:
            self._g_generation.set(int(generation))
            self._journal("generation", generation=int(generation))

    @property
    def last_signals(self) -> Optional[FleetSignals]:
        return self.evaluator.last_signals

    # -- the journal (durable before every actuation) ------------------

    def _journal(self, op: str, **fields) -> None:
        """Durably record ``op`` BEFORE the actuation it describes (the
        append fsyncs before returning). No-op without a journal — the
        controller then simply isn't restart-safe, as before."""
        if self.journal is not None:
            # ControllerJournal.append serializes internally (its own
            # mutex) and fsyncs; taking self._lock around it would hold
            # the control lock across disk I/O
            self.journal.append(op, **fields)

    def _journal_policy_state(self, now: float) -> None:
        """Journal the evaluator's window/cooldown stamps whenever a
        transition happened — translated into WALL time, because a
        restarted controller has a fresh monotonic clock. Change-detected
        on the raw clock values so steady state appends nothing."""
        ev = self.evaluator
        stamp = (ev.pressure_since, ev.idle_since, ev.last_up, ev.last_down)
        if self.journal is None or stamp == self._last_policy_stamp:
            return
        with self._lock:
            self._last_policy_stamp = stamp
        wall = time.time()

        def to_wall(t):
            return None if t is None else wall - (now - t)

        self._journal(
            "policy",
            pressure_since_wall=to_wall(ev.pressure_since),
            idle_since_wall=to_wall(ev.idle_since),
            last_up_wall=to_wall(ev.last_up),
            last_down_wall=to_wall(ev.last_down),
            last_expired=ev.last_expired,
        )

    # -- membership ----------------------------------------------------

    def adopt(self, handle) -> None:
        """Take lifecycle ownership of an already-spawned replica — the
        launcher's seed fleet, or :func:`recover_controller`'s
        journal-replay re-adoptions: the controller will reap it on
        failure and may drain it on scale-down. Journaled before the
        (idempotent) router registration, and counted."""
        if getattr(handle, "generation", None) is None:
            try:
                handle.generation = (handle.health or {}).get(
                    "promotion_generation"
                )
            except AttributeError:
                pass
        self._journal(
            "adopt",
            idx=int(handle.idx),
            url=handle.url,
            pid=getattr(handle, "pid", None),
            generation=getattr(handle, "generation", None),
            compiles=(getattr(handle, "health", None) or {}).get("compiles"),
        )
        self.router.add_replica(handle.url)
        with self._lock:
            self._replicas[handle.url] = handle
            self._next_idx = max(self._next_idx, int(handle.idx) + 1)
        self._c_adoptions.inc()
        self._g_replicas.set(len(self.replicas()))

    def seed(self, count: int) -> int:
        """Spawn the initial fleet through the journaled spawn path
        (sequential on purpose: each replica's warmup has the card to
        itself). Not a scale event; prints the
        ``==> fleet: replica i ...`` seed lines tools parse. Returns how
        many came up."""
        ok = 0
        for _ in range(int(count)):
            if self._spawn_one("seed", count=False, tag="replica") == "ok":
                ok += 1
        return ok

    def replicas(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._replicas)

    @property
    def stats(self) -> dict:
        return {
            "replicas": len(self.replicas()),
            "scale_ups": int(self._c_ups.value),
            "scale_downs": int(self._c_downs.value),
            "replica_failures": int(self._c_failures.value),
            "scrape_errors": int(self._c_scrape_errors.value),
            "adoptions": int(self._c_adoptions.value),
            "rollouts": int(self._c_rollouts.value),
            "rollbacks": int(self._c_rollbacks.value),
            "journal_replays": int(self._c_replays.value),
            "generation": self.generation,
        }

    # -- actuation -----------------------------------------------------

    def _spawn_one(
        self,
        reason: str,
        *,
        count: bool = True,
        tag: str = "scale-up",
        expect_generation: Optional[int] = None,
    ) -> str:
        """Launch + register one replica. Returns ``"ok"``, ``"error"``
        (spawn failed — retryable), or ``"rejected"`` (the rollout gate
        refused the candidate BEFORE it took traffic — the caller halts
        the rollout). Spawn runs outside the lock (it blocks for the
        replica's cold start: the checkpoint load and the warmup of every
        bucket). The journal sees the intent before
        the fork and the replica-up before the traffic shift."""
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
        self._journal(
            "spawn-intent", idx=idx, generation=expect_generation
        )
        t0 = self._clock()
        try:
            handle = self.launcher(idx)
        except Exception as e:
            log.warning("scale-up spawn failed (%s): %s", reason, e)
            self._journal("spawn-failed", idx=idx, reason=str(e))
            self._c_failures.inc()
            return "error"
        self._h_spawn.observe((self._clock() - t0) * 1e3)
        health = getattr(handle, "health", None) or {}
        compiles = health.get("compiles")
        gen = health.get("promotion_generation")
        try:
            handle.generation = gen
        except AttributeError:
            pass
        if expect_generation is not None:
            # the canary gate: generation + golden-batch checks against
            # the candidate's OWN frontend, before any traffic shifts
            problems = []
            if gen != expect_generation:
                problems.append(
                    f"came up on generation {gen}, expected "
                    f"{expect_generation}"
                )
            if not problems and self.rollout_gate is not None:
                try:
                    problems = list(self.rollout_gate.check(handle.url))
                except Exception as e:
                    problems = [f"gate probe failed: {e}"]
            if problems:
                detail = "; ".join(problems)
                self._journal(
                    "spawn-failed", idx=idx, reason=f"canary: {detail}"
                )
                print(
                    f"==> fleet: rollout canary failed replica {idx} "
                    f"url={handle.url} gen={gen} ({detail})",
                    file=sys.stderr,
                )
                handle.decommission(self.drain_timeout_s)
                return "rejected"
        self._journal(
            "replica-up",
            idx=idx,
            url=handle.url,
            pid=getattr(handle, "pid", None),
            generation=gen,
            compiles=compiles,
        )
        self.router.add_replica(handle.url)
        with self._lock:
            self._replicas[handle.url] = handle
            n = len(self._replicas)
        if count:
            self._c_ups.inc()
        self._g_replicas.set(n)
        log.info(
            "fleet %s (%s): replica %s url=%s compiles=%s gen=%s -> %d "
            "replicas", tag, reason, idx, handle.url, compiles, gen, n,
        )
        if tag == "replica":
            # the seed-fleet line order tools already parse
            print(
                f"==> fleet: replica {idx} "
                f"pid={getattr(handle, 'pid', '?')} url={handle.url} "
                f"compiles={compiles} "
                f"aot_hits={health.get('aot_cache_hits')} gen={gen}",
                file=sys.stderr,
            )
        else:
            print(
                f"==> fleet: {tag} replica {idx} url={handle.url} "
                f"pid={getattr(handle, 'pid', '?')} compiles={compiles} "
                f"gen={gen} ({reason})",
                file=sys.stderr,
            )
        return "ok"

    def _drain_one(
        self, handle, count: bool = True, tag: str = "scale-down"
    ) -> None:
        """Deregister-then-drain one replica (never the reverse order:
        a request dispatched after the SIGTERM would race the drain).
        ``count=False`` for the shutdown path — tearing the whole fleet
        down is not a scale event. The drain intent is journaled before
        the deregister, the completion after the reap."""
        self._journal(
            "drain-intent", idx=int(handle.idx), url=handle.url
        )
        self.router.remove_replica(handle.url)
        with self._lock:
            self._replicas.pop(handle.url, None)
            n = len(self._replicas)
        drain_s = handle.decommission(self.drain_timeout_s)
        self._journal("drain-done", idx=int(handle.idx), url=handle.url)
        self._h_drain.observe(drain_s * 1e3)
        if count:
            self._c_downs.inc()
        self._g_replicas.set(n)
        log.info(
            "fleet %s: drained %s in %.2fs -> %d replicas",
            tag, handle.url, drain_s, n,
        )
        print(
            f"==> fleet: {tag} replica {handle.idx} "
            f"url={handle.url} drain_s={drain_s:.2f}",
            file=sys.stderr,
        )

    def _reap_dead(self) -> int:
        """Remove replicas whose process died under us (preemption,
        SIGKILL): deregister from the router, reap the corpse (a dead
        child still needs its wait()), count the failure. Returns how
        many were reaped."""
        with self._lock:
            dead = [
                h for h in self._replicas.values() if not h.alive()
            ]
        for handle in dead:
            self._journal(
                "reap",
                idx=int(handle.idx),
                url=handle.url,
                pid=getattr(handle, "pid", None),
            )
            self.router.remove_replica(handle.url)
            with self._lock:
                self._replicas.pop(handle.url, None)
            handle.decommission(timeout_s=5.0)  # reap, never orphan
            self._c_failures.inc()
            log.warning(
                "replica %s died; removed from rotation", handle.url
            )
            print(
                f"==> fleet: replica {handle.idx} died; removed "
                f"url={handle.url}",
                file=sys.stderr,
            )
        if dead:
            self._g_replicas.set(len(self.replicas()))
        return len(dead)

    # -- the decision --------------------------------------------------

    def control_once(self, now: Optional[float] = None) -> str:
        """One control sweep: reap, scrape, then either advance an
        active rolling deploy (which owns actuation until it resolves)
        or evaluate the scaling policy. Returns the action taken —
        ``"up"``, ``"down"``, ``"replace"`` (min-floor refill after a
        replica failure), ``"rollout"`` (a deploy step), or ``"hold"``.
        Deterministic given (signals, clock): the evaluator's state
        advances here and nowhere else."""
        now = self._clock() if now is None else now
        self._reap_dead()
        try:
            signals = self.scrape()
        except (OSError, ValueError) as e:
            self._c_scrape_errors.inc()
            log.warning("fleet scrape failed: %s", e)
            return "hold"
        self._g_pressure.set(signals.load_per_replica)
        n = len(self.replicas())
        if self.rollout is None and self.generation_probe is not None:
            target = self.generation_probe()
            if target is not None and self.generation is None:
                # first sight of a stamped publish: baseline, no deploy
                with self._lock:
                    self.generation = int(target)
                self._g_generation.set(self.generation)
                self._journal("generation", generation=self.generation)
            elif target is not None and int(target) != self.generation:
                self._begin_rollout(int(target), n)
        if self.rollout is not None:
            # a deploy in flight owns actuation; keep the expiry
            # baseline moving so the post-rollout evaluator doesn't
            # read the whole deploy's 504 delta as fresh pressure
            self.evaluator.observe_only(signals)
            result = self._rollout_step()
            self._journal_policy_state(now)
            return result
        action, reason = self.evaluator.evaluate(signals, n, now)
        if action == "up" and n < self.policy.max_replicas:
            if self._spawn_one(reason) == "ok":
                self.evaluator.acted_up(now)
                self._journal_policy_state(now)
                return (
                    "replace" if reason == "min-replicas floor" else "up"
                )
            self._journal_policy_state(now)
            return "hold"
        if action == "down":
            victim = self._pick_drain_victim()
            if victim is None:
                return "hold"  # nobody drains for free right now
            self._drain_one(victim)
            self.evaluator.acted_down(now)
            self._journal_policy_state(now)
            return "down"
        self._journal_policy_state(now)
        return "hold"

    # -- generation-aware rolling deploys ------------------------------

    def _begin_rollout(self, target: int, n: int) -> None:
        """Arm the deploy state machine: journal the begin (before any
        actuation), then capture the golden-batch baseline from an
        old-generation replica while one still serves."""
        with self._lock:
            self.rollout = {
                "from_generation": self.generation,
                "to_generation": target,
                "n_start": n,
                "phase": "surge",
                "reason": None,
            }
        self._journal(
            "rollout-begin",
            from_generation=self.generation,
            to_generation=target,
            n_start=n,
        )
        print(
            f"==> fleet: rollout begin gen={self.generation} -> "
            f"gen={target} (n={n})",
            file=sys.stderr,
        )
        self._rebaseline_gate()

    def _rebaseline_gate(self) -> None:
        if self.rollout_gate is None or self.rollout is None:
            return
        target = self.rollout["to_generation"]
        old = [
            h for h in self.replicas().values()
            if getattr(h, "generation", None) != target
        ]
        if not old:
            return
        try:
            self.rollout_gate.baseline_from(old[0].url)
        except Exception as e:
            log.warning("rollout gate baseline failed: %s", e)

    def _rollout_step(self) -> str:
        """One deploy actuation per sweep: surge one gated new-generation
        replica, then convert the fleet one replica at a time (spawn
        new above the floor, drain old back down to it), finishing when
        no old-generation replica remains. A rejected canary at ANY
        spawn flips the machine into rollback: restore the ``.prev``
        publish, drain every new-generation replica, respawn the old
        generation back to strength."""
        ro = self.rollout
        target = ro["to_generation"]
        handles = self.replicas()
        new = [
            h for h in handles.values()
            if getattr(h, "generation", None) == target
        ]
        old = [
            h for h in handles.values()
            if getattr(h, "generation", None) != target
        ]
        n, n_start = len(handles), int(ro["n_start"] or 1)
        if ro["phase"] == "surge":
            if not new:
                outcome = self._spawn_one(
                    f"rollout surge gen {target}",
                    count=False,
                    tag="rollout-surge",
                    expect_generation=target,
                )
                if outcome == "rejected":
                    self._halt_rollout("surge canary rejected")
                return "rollout"
            ro["phase"] = "converting"
            self._journal("rollout-phase", phase="converting")
            return "rollout"
        if ro["phase"] == "converting":
            if old:
                if n > n_start:
                    self._drain_one(
                        self._pick_rollout_victim(old),
                        count=False,
                        tag="rollout-drain",
                    )
                else:
                    outcome = self._spawn_one(
                        f"rollout gen {target}",
                        count=False,
                        tag="rollout-up",
                        expect_generation=target,
                    )
                    if outcome == "rejected":
                        self._halt_rollout("rollout canary rejected")
                return "rollout"
            self._finish_rollout()
            return "rollout"
        # phase == "rollback": the live dir is already restored (halt
        # did it); unwind the new generation, then restore strength
        if new:
            self._drain_one(
                self._pick_rollout_victim(new),
                count=False,
                tag="rollback-drain",
            )
            return "rollout"
        if n < max(n_start, self.policy.min_replicas):
            outcome = self._spawn_one(
                f"rollback respawn gen {ro['from_generation']}",
                count=False,
                tag="rollback-up",
            )
            if outcome == "error":
                return "rollout"  # retry next sweep
            return "rollout"
        self._journal(
            "rollout-rollback-done", generation=ro["from_generation"]
        )
        self._c_rollbacks.inc()
        if ro["from_generation"] is not None:
            with self._lock:
                self.generation = int(ro["from_generation"])
            self._g_generation.set(self.generation)
        print(
            f"==> fleet: rollout rolled back to gen={self.generation} "
            f"({ro['reason']})",
            file=sys.stderr,
        )
        with self._lock:
            self.rollout = None
        return "rollout"

    def _pick_rollout_victim(self, candidates):
        """The deploy drain victim among ``candidates``: least
        router-side in-flight work first (drains fastest), ties toward
        the highest index. Unlike scale-down, a deploy MUST make
        progress under sustained load — deregister-first means the
        drain still answers everything already admitted."""
        view = self.router.fleet_view()
        return min(
            candidates,
            key=lambda h: (view.get(h.url, (0, {}))[0], -int(h.idx)),
        )

    def _halt_rollout(self, reason: str) -> None:
        """Journal the halt (before the restore actuation), restore the
        ``.prev`` publish pair so every subsequent spawn loads the old
        generation's bits, and flip the machine into rollback."""
        ro = self.rollout
        self._journal("rollout-halt", reason=reason)
        ro["phase"] = "rollback"
        ro["reason"] = reason
        print(
            f"==> fleet: rollout halt gen={ro['to_generation']} "
            f"({reason})",
            file=sys.stderr,
        )
        if self.rollback is not None:
            try:
                restored = self.rollback()
            except Exception:
                log.exception("rollout rollback restore failed")
                restored = False
            if not restored:
                log.warning(
                    "rollout halt: no previous publish to restore — "
                    "respawns will load whatever the live dir holds"
                )

    def _finish_rollout(self) -> None:
        ro = self.rollout
        target = int(ro["to_generation"])
        self._journal("rollout-done", generation=target)
        with self._lock:
            self.generation = target
        self._g_generation.set(target)
        self._c_rollouts.inc()
        print(
            f"==> fleet: rollout done gen={target} "
            f"(replicas={len(self.replicas())})",
            file=sys.stderr,
        )
        with self._lock:
            self.rollout = None

    def _pick_drain_victim(self):
        """The managed replica whose drain costs nothing: zero
        router-side in-flight requests AND an empty probed queue. Ties
        break toward the HIGHEST index (newest first — the oldest
        replica keeps the longest-lived caches). None when every replica
        still holds work (scale-down never kills in-flight requests)."""
        managed = self.replicas()
        router_view = self.router.fleet_view()
        candidates = []
        for url, handle in managed.items():
            in_flight, last_health = router_view.get(url, (0, {}))
            q = (last_health or {}).get("queued")
            queued = (
                sum(int(v or 0) for v in q.values())
                if isinstance(q, dict)
                else int(q or 0)
            )
            if in_flight == 0 and queued == 0:
                candidates.append((int(handle.idx), handle))
        if not candidates:
            return None
        return max(candidates, key=lambda c: c[0])[1]

    # -- lifecycle -----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.control_once()
            except Exception:
                log.exception("fleet control sweep failed")

    def start(self) -> "FleetController":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="fleet-controller", daemon=True
                )
                self._thread.start()
        return self

    def stop(self, drain_replicas: bool = False) -> None:
        """Stop the control loop (joined outside the lock). With
        ``drain_replicas`` every managed replica is deregistered and
        drained too — the fleet launcher's shutdown path."""
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()
        if drain_replicas:
            for handle in list(self.replicas().values()):
                self._drain_one(handle, count=False)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


# ---------------------------------------------------------------------
# crash recovery: replay the journal, adopt the living, reap the dead
# ---------------------------------------------------------------------


def probe_replica_health(url: str, timeout_s: float = 5.0) -> Optional[dict]:
    """GET a replica's own ``/healthz``; the payload even on a 503 (a
    degraded replica is still alive and adoptable — the reap loop deals
    with it if it stays sick). None when unreachable/unparseable."""
    import urllib.error
    import urllib.request

    try:
        try:
            with urllib.request.urlopen(
                url.rstrip("/") + "/healthz", timeout=timeout_s
            ) as r:
                return json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            return json.loads(e.read().decode("utf-8"))
    except (OSError, ValueError):
        return None


def recover_controller(
    journal,
    router,
    launcher: Callable[[int], object],
    policy: FleetPolicy,
    *,
    scrape: Callable[[], FleetSignals],
    probe: Callable[[str], Optional[dict]] = probe_replica_health,
    pid_check: Callable[[object], bool] = pid_is_serve_replica,
    **kwargs,
) -> FleetController:
    """Rebuild a :class:`FleetController` from its journal after a crash
    — the "survives its own death" path. The journal is replayed to the
    expected fleet, then every expected replica is checked against
    reality: its ``/healthz`` must answer AND its pid must still be a
    port replica (the pid-reuse guard). Replicas that pass are
    re-adopted as :class:`AdoptedReplica` handles — never re-spawned;
    the rest are journaled as reaped and left for the ``min_replicas``
    floor to replace. Scaling windows, cooldowns, the serving
    generation, and an in-flight rolling deploy all resume from the
    journal, and the replayed history is compacted down to the adopted
    state before the loop restarts. Raises
    :class:`~pytorch_cifar_tpu_torch.serve.journal.JournalCorrupt` on a
    damaged journal — recovery never guesses."""
    from pytorch_cifar_tpu_torch.serve.journal import FleetJournalState

    state = FleetJournalState.from_records(journal.records())
    ctl = FleetController(
        router,
        launcher,
        policy,
        scrape=scrape,
        journal=journal,
        generation=state.generation,
        **kwargs,
    )
    ctl._c_replays.inc()
    now_wall, now_clk = time.time(), ctl._clock()

    def from_wall(w):
        return None if w is None else now_clk - (now_wall - float(w))

    ev, ps = ctl.evaluator, state.policy_state
    ev.pressure_since = from_wall(ps.get("pressure_since_wall"))
    ev.idle_since = from_wall(ps.get("idle_since_wall"))
    ev.last_up = from_wall(ps.get("last_up_wall"))
    ev.last_down = from_wall(ps.get("last_down_wall"))
    ev.last_expired = float(ps.get("last_expired") or 0.0)

    for url, info in sorted(
        state.replicas.items(), key=lambda kv: int(kv[1].get("idx") or 0)
    ):
        idx, pid = info.get("idx"), info.get("pid")
        if info.get("draining"):
            # the crash interrupted a drain: finish it, never orphan
            ctl._journal("drain-done", idx=idx, url=url)
            router.remove_replica(url)
            if pid_check(pid):
                AdoptedReplica(idx, url, pid).decommission(
                    ctl.drain_timeout_s
                )
            print(
                f"==> fleet: recovery finished drain of replica {idx} "
                f"url={url}",
                file=sys.stderr,
            )
            continue
        health = probe(url)
        if health is not None and pid_check(pid):
            handle = AdoptedReplica(
                idx,
                url,
                pid,
                health=health,
                generation=health.get(
                    "promotion_generation", info.get("generation")
                ),
            )
            ctl.adopt(handle)  # journals the adoption, re-registers
            print(
                f"==> fleet: adopt replica {idx} pid={pid} url={url} "
                f"compiles={health.get('compiles')} "
                f"gen={handle.generation}",
                file=sys.stderr,
            )
        else:
            ctl._journal("reap", idx=idx, url=url, pid=pid)
            router.remove_replica(url)
            ctl._c_failures.inc()
            print(
                f"==> fleet: recovery reaped replica {idx} url={url} "
                "(dead or pid reused); the floor will replace it",
                file=sys.stderr,
            )
    if state.spawn_intents:
        log.warning(
            "journal records %d spawn intent(s) with no replica-up: a "
            "spawn was cut down mid-launch; its child (if any) never "
            "took traffic and exits with its warmup timeout",
            len(state.spawn_intents),
        )
    if state.rollout is not None:
        ctl.rollout = dict(state.rollout)
        print(
            "==> fleet: resuming rollout "
            f"gen={ctl.rollout.get('from_generation')} -> "
            f"gen={ctl.rollout.get('to_generation')} "
            f"phase={ctl.rollout.get('phase')}",
            file=sys.stderr,
        )
        ctl._rebaseline_gate()
    # compact the replayed history (plus the adoption records just
    # appended) down to a snapshot that replays to the same state
    journal.compact(
        FleetJournalState.from_records(journal.records()).summary_records()
    )
    return ctl
