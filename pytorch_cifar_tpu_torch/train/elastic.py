"""Preemption-elastic training: ``fit()`` survives world-size changes (the
port's copy of ``pytorch_cifar_tpu/train/elastic.py``).

A fixed-world multi-process job dies with its first preempted host; an
elastic one treats a membership change as a checkpoint, restore, reshard
cycle:

- Every rank trains normally (``python -m pytorch_cifar_tpu_torch.train
  --distributed --elastic``), publishing durable checkpoints as before:
  format v3's per-process byte-range shards, commit marker last.
- A **membership change**, a rank killed by preemption or a new host
  granted, ends the current *generation*: the supervisor
  (:class:`ElasticTrainRunner`) terminates the surviving ranks (SIGTERM
  first, which is ``fit()``'s graceful stop and preemption save; SIGKILL
  bounds a rank that answers neither), reaps every child, and relaunches
  the world at the new size with ``--resume``.
- The relaunch **resumes, never restarts**: restore accepts the old
  world's v3 layout into the new one for any M -> N (rank 0 reassembles
  the committed shard set and broadcasts the payload), the elastic
  trainer re-cuts the on-disk layout to the new world
  (:func:`~pytorch_cifar_tpu_torch.train.checkpoint.reshard_to_world`,
  payload bit-identical), and each rank takes its rows of every global
  batch from the new world's size and rank. Training continues from the
  last durable epoch.

Rank-side contract: a rank of a multi-process world whose ``fit()``
raises exits :data:`ELASTIC_RC` (75, EX_TEMPFAIL), "my world broke,
resume me", rather than surfacing a dead peer's collective error as a
crash. A collective does not always raise: on gloo one does within a
second of a peer's death, but an NCCL collective whose peer is gone
spins on the device and its host thread blocks in the next wait, where
neither an exception nor a SIGTERM handler runs. So every rank of such a
world also runs a :class:`PeerWatch`: a heartbeat over the rendezvous's
TCP store, on a thread that needs neither the device nor the collective.
A peer silent for :data:`PEER_TIMEOUT_S`, or the store gone with its
host (rank 0) failing or frozen as long, makes the watch log the loss
and end the process with :data:`ELASTIC_RC`. A survivor therefore leaves
a dead world within ``PEER_TIMEOUT_S + 2 * HEARTBEAT_S`` (12 s: the beat
that sees the silence, then the judge's look) on any backend, inside the
supervisor's ``grace_s`` (30 s), and is never SIGKILLed by the backstop;
it never trains on alone. The supervisor treats any abnormal rank exit
as a membership event either way. Restart cycles are bounded by
``max_restarts``: a run broken for good (a crash the resume replays
deterministically) fails loudly instead of looping forever.

The supervisor is a plain single-machine process tree (each rank a
``python -m pytorch_cifar_tpu_torch.train`` subprocess on a localhost
rendezvous); on a cluster the same loop runs per allocation with ranks
on different hosts. Every child is waited or killed on every exit path.
This module imports no torch: the supervisor holds no device
(:class:`PeerWatch` imports ``torch.distributed`` when a rank starts it).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

# "membership changed underneath me: relaunch the world and resume"
# (EX_TEMPFAIL, the sysexits code for try-again-later; serving's mesh
# watchdog owns 70)
ELASTIC_RC = 75

# the dead-peer bound: a rank whose peer's heartbeat is silent this long
# (or whose rendezvous store stopped answering for this long) exits
# ELASTIC_RC. Far above a live rank's longest pause between beats (its
# beat runs on a thread of its own; the main thread drops the
# interpreter lock in every device wait, collective and build), and with
# HEARTBEAT_S well inside the supervisor's default grace_s of 30 s
PEER_TIMEOUT_S = 10.0
HEARTBEAT_S = 1.0

# flags the supervisor owns per generation; stripped from the base argv
# so a relaunch can re-derive them for the new world
_OWNED_FLAGS = (
    "--elastic_procs", "--dist_coord", "--dist_procs", "--dist_rank",
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def strip_owned_flags(argv: List[str]) -> List[str]:
    """Remove supervisor-owned flags (and their values) plus bare
    ``--distributed``/``--resume``/``--elastic`` (and their ``--no-``
    forms) from a train CLI argv: the runner re-adds all of them per
    generation with the current world's values."""
    out = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in _OWNED_FLAGS:
            skip = True
            continue
        if any(a.startswith(f + "=") for f in _OWNED_FLAGS):
            continue
        if a in ("--distributed", "--no-distributed", "--resume",
                 "--no-resume", "--elastic", "--no-elastic"):
            continue
        out.append(a)
    return out


def exit_for_resume(why: str) -> None:
    """End this rank with :data:`ELASTIC_RC` from any thread: log why,
    flush the logs and the standard streams, and leave without the
    interpreter's teardown (the main thread may be blocked in a dead
    collective, and a process-group teardown could block as well)."""
    log.error("elastic rank lost its world (%s); exiting %d for the "
              "supervisor to resume the surviving world", why, ELASTIC_RC)
    for h in logging.getLogger().handlers:
        try:
            h.flush()
        except Exception:
            pass
    for stream in (sys.stdout, sys.stderr):
        try:
            stream.flush()
        except Exception:
            pass
    os._exit(ELASTIC_RC)


class PeerWatch:
    """The heartbeat of one rank of an elastic multi-process world. A
    beat thread adds one to this rank's counter in the rendezvous's TCP
    store (``address``, rank 0's; a client connection of its own, so no
    lock of the process group's is shared) every :data:`HEARTBEAT_S` and
    reads its peers'; a judge thread, which never touches the store,
    calls :func:`exit_for_resume` when a peer's counter has not moved for
    :data:`PEER_TIMEOUT_S`, when a store call fails (its host is gone), or
    when a store call has not returned for as long (its host is frozen: a
    store call has no deadline of its own). :meth:`stop` ends the watch
    without a call; the trainer stops it once the epoch loop has passed
    its last collective, so a peer that finished first is not taken for a
    lost one."""

    def __init__(self, address: str, rank: int, world: int):
        self.address = address
        self.rank = int(rank)
        self.world = int(world)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._store = None
        # written by the beat thread, read by the judge
        self._why: Optional[str] = None
        self._answered = time.monotonic()

    @staticmethod
    def _key(rank: int) -> str:
        return f"elastic/heartbeat/{rank}"

    def start(self) -> "PeerWatch":
        import datetime

        import torch.distributed as dist

        host, port = self.address.rsplit(":", 1)
        self._store = dist.TCPStore(
            host, int(port), is_master=False, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=PEER_TIMEOUT_S),
        )
        self._store.add(self._key(self.rank), 1)
        self._answered = time.monotonic()
        self._threads = [
            threading.Thread(target=fn, name=f"elastic-peer-{fn.__name__}",
                             daemon=True)
            for fn in (self._beat, self._judge)]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        """End the watch; joins the judge (the beat thread may be inside
        a store call that only the store's end returns from)."""
        self._stop.set()
        threads, self._threads = self._threads, []
        if threads:
            threads[1].join(timeout=PEER_TIMEOUT_S + HEARTBEAT_S)

    def _beat(self) -> None:
        peers = [r for r in range(self.world) if r != self.rank]
        seen = {r: (None, time.monotonic()) for r in peers}
        while not self._stop.is_set():
            try:
                self._store.add(self._key(self.rank), 1)
                now = time.monotonic()
                for r in peers:
                    beat = self._store.add(self._key(r), 0)
                    if beat != seen[r][0]:
                        seen[r] = (beat, now)
                    elif now - seen[r][1] > PEER_TIMEOUT_S:
                        self._why = (f"rank {r}'s heartbeat silent for "
                                     f"{now - seen[r][1]:.1f} s")
                        return
                self._answered = time.monotonic()
            except Exception as e:  # the store's host is gone
                self._why = (f"the rendezvous store at {self.address} "
                             f"failed ({e})")
                return
            self._stop.wait(HEARTBEAT_S)

    def _judge(self) -> None:
        while not self._stop.wait(HEARTBEAT_S):
            why = self._why
            silent = time.monotonic() - self._answered
            if why is None and silent > PEER_TIMEOUT_S:
                why = (f"the rendezvous store at {self.address} has not "
                       f"answered for {silent:.1f} s")
            if why is not None:
                if not self._stop.is_set():
                    exit_for_resume(why)
                return


class _Rank:
    """One rank subprocess of the current generation: the process plus a
    stderr pump thread (forwards lines with a ``[rank i]`` prefix). Always
    reaped via :meth:`reap`, never orphaned."""

    def __init__(self, rank: int, cmd: List[str], env: dict, cwd: str):
        self.rank = rank
        self.proc = subprocess.Popen(
            cmd,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            cwd=cwd,
        )
        self.stdout_tail: List[str] = []
        self._thread = threading.Thread(
            target=self._pump, name=f"elastic-rank-stderr-{rank}",
            daemon=True,
        )
        self._thread.start()

    def _pump(self) -> None:
        for line in self.proc.stderr:
            sys.stderr.write(f"[rank {self.rank}] {line}")

    def alive(self) -> bool:
        return self.proc.poll() is None

    def reap(self, timeout_s: float) -> int:
        """Wait the child out (SIGKILL backstop for a rank that answers
        neither its SIGTERM nor its peer watch), drain its stdout (the
        ``best test accuracy`` line rides it), join the pump."""
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        if self.proc.stdout is not None:
            self.stdout_tail = self.proc.stdout.read().splitlines()[-20:]
        self._thread.join(timeout=10)
        return self.proc.returncode


class ElasticTrainRunner:
    """Supervise an elastic multi-process training run (module
    docstring). ``base_argv`` is the train CLI's argv WITHOUT the
    supervisor-owned flags (:func:`strip_owned_flags` cleans a raw one);
    the runner appends per-generation rendezvous flags and ``--resume``
    from generation 1 on.

    External membership events: :meth:`add_host` requests a +1 world (a
    new host granted: the current generation is stopped gracefully via
    SIGTERM, which is ``fit()``'s finish-epoch-and-save path, then
    relaunched wider). A rank dying (preemption, a chaos SIGKILL) shrinks
    the next generation to the survivor count, floored at ``min_procs``.
    """

    def __init__(
        self,
        base_argv: List[str],
        procs: int,
        *,
        min_procs: int = 1,
        max_restarts: int = 8,
        grace_s: float = 30.0,
        poll_s: float = 0.2,
        env: Optional[dict] = None,
        cwd: Optional[str] = None,
        resume_first: bool = False,
    ):
        if procs < 1:
            raise ValueError("procs must be >= 1")
        self.base_argv = list(base_argv)
        # the caller asked generation 0 itself to --resume (a supervisor
        # restarted around an existing run); later generations always do
        self.resume_first = bool(resume_first)
        self.world = int(procs)
        self.min_procs = max(int(min_procs), 1)
        self.max_restarts = int(max_restarts)
        self.grace_s = float(grace_s)
        self.poll_s = float(poll_s)
        self.env = dict(os.environ if env is None else env)
        self.cwd = cwd or os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        self.generations: List[dict] = []
        # cross-thread state (callers drive add_host()/pids() from another
        # thread while run() supervises): everything below the lock
        self._lock = threading.Lock()
        self._ranks: List[_Rank] = []
        self._requested_world: Optional[int] = None
        self._current_world = self.world

    # -- external events ----------------------------------------------

    def add_host(self) -> None:
        """Request a +1 world size: the current generation is stopped
        gracefully and relaunched wider (an added host is a resume, not a
        restart)."""
        with self._lock:
            self._requested_world = (
                self._requested_world or self._current_world
            ) + 1

    def pids(self) -> Dict[int, int]:
        """Live {rank: pid} of the current generation (chaos drills aim
        their SIGKILLs with this)."""
        with self._lock:
            return {
                r.rank: r.proc.pid for r in self._ranks if r.alive()
            }

    # -- one generation ------------------------------------------------

    def _spawn_generation(self, gen: int, world: int) -> List[_Rank]:
        argv = list(self.base_argv)
        if gen > 0 or self.resume_first:
            argv.append("--resume")
        if world > 1:
            coord = f"127.0.0.1:{_free_port()}"
            argv += [
                "--distributed", "--elastic",
                "--dist_coord", coord,
                "--dist_procs", str(world),
            ]
        else:
            argv += ["--elastic"]
        ranks = []
        for rank in range(world):
            cmd = [sys.executable, "-m", "pytorch_cifar_tpu_torch.train",
                   *argv]
            if world > 1:
                cmd += ["--dist_rank", str(rank)]
            ranks.append(_Rank(rank, cmd, self.env, self.cwd))
        with self._lock:
            self._ranks = ranks
        print(
            f"==> elastic: generation {gen} world={world} pids="
            f"{[r.proc.pid for r in ranks]}",
            file=sys.stderr,
        )
        return ranks

    def _stop_generation(self, ranks: List[_Rank]) -> List[int]:
        """SIGTERM every live rank (graceful: finish the epoch, write the
        preemption save), then reap with the SIGKILL backstop."""
        for r in ranks:
            if r.alive():
                try:
                    r.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        return [r.reap(self.grace_s) for r in ranks]

    def run(self, timeout_s: float = 3600.0) -> dict:
        """Supervise until a generation completes cleanly (every rank
        exits 0 with no pending membership change), the restart budget is
        exhausted, or the deadline passes. Returns the run record (one
        entry per generation: world size, exit codes, the event that
        ended it)."""
        deadline = time.monotonic() + timeout_s
        world = self.world
        restarts = 0
        completed = False
        best_acc = None
        for gen in range(self.max_restarts + 1):
            with self._lock:
                self._current_world = world
            ranks = self._spawn_generation(gen, world)
            event = "completed"
            while True:
                if time.monotonic() > deadline:
                    event = "timeout"
                    break
                with self._lock:
                    wanted = self._requested_world
                if wanted is not None and wanted != world:
                    event = f"scale:{world}->{wanted}"
                    break
                dead = [r for r in ranks if not r.alive()]
                failed = [
                    r for r in dead if r.proc.returncode != 0
                ]
                if failed:
                    event = "preempted:rank%d:rc%d" % (
                        failed[0].rank, failed[0].proc.returncode,
                    )
                    break
                if len(dead) == len(ranks):
                    break  # everyone exited cleanly on their own
                time.sleep(self.poll_s)
            rcs = self._stop_generation(ranks)
            self.generations.append(
                {"world": world, "rcs": rcs, "event": event}
            )
            print(
                f"==> elastic: generation {gen} ended ({event}) "
                f"rcs={rcs}",
                file=sys.stderr,
            )
            for r in ranks:
                for line in r.stdout_tail:
                    if line.startswith("best test accuracy:"):
                        try:
                            best_acc = float(
                                line.split(":")[1].strip().rstrip("%")
                            )
                        except ValueError:
                            pass
            if event == "timeout":
                break
            if event == "completed" and all(rc == 0 for rc in rcs):
                completed = True
                break
            if event.startswith("scale:"):
                world = max(int(event.split("->")[1]), self.min_procs)
                with self._lock:
                    self._requested_world = None
            else:
                # preemption: the next world is the survivor count. Every
                # rank with a clean or elastic exit survives in spirit
                # (its host is still there); the preempted rank's slot is
                # gone
                died = sum(
                    1 for rc in rcs
                    if rc not in (0, ELASTIC_RC, -signal.SIGTERM)
                )
                world = max(world - max(died, 1), self.min_procs)
            restarts += 1
            print(
                f"==> elastic: relaunching world={world} (--resume)",
                file=sys.stderr,
            )
        return {
            "harness": "elastic_train",
            "completed": completed,
            "restarts": restarts,
            "final_world": world,
            "generations": self.generations,
            "best_acc": best_acc,
        }


def run_supervisor(config, argv: Optional[List[str]] = None) -> int:
    """The train CLI's ``--elastic_procs N`` entry: supervise N ranks of
    THIS command line. Prints the one-JSON-record contract on stdout;
    returns 0 when the run completed, else 1."""
    raw = list(sys.argv[1:] if argv is None else argv)
    runner = ElasticTrainRunner(
        strip_owned_flags(raw),
        config.elastic_procs,
        resume_first=config.resume,
    )
    record = runner.run()
    print(json.dumps(record))
    return 0 if record["completed"] else 1
