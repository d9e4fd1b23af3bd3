"""Durable control-plane journal: the fleet controller's and the canary's.

A copy of ``pytorch_cifar_tpu/serve/journal.py`` for the port (stdlib
only, so the record bytes are the JAX package's and a journal written by
either package replays in the other):

- :class:`ControllerJournal`: an append-only journal. Every record is
  CRC-framed, written, flushed and fsync'd before ``append`` returns, so
  the actuation it records (a spawn, a drain, a vetting verdict, a
  publish) never outruns
  its durable evidence. ``compact`` writes a snapshot payload first and
  its commit marker last (tmp + fsync + rename each), then truncates the
  live file.
- :func:`replay_journal`: a torn final record (a crash mid-append) is
  dropped and reported; a bad record anywhere else, or a sequence
  regression, raises :class:`JournalCorrupt`.
- :class:`FleetJournalState`: the pure reducer from a record stream to
  control-plane state: replicas, scaling stamps, rollout phase and the
  canary's vetting ledger (``vet-begin``/``vet-verdict``), from which a
  relaunched :class:`~pytorch_cifar_tpu_torch.serve.canary.PromotionController`
  resumes its promotion generation, and from which
  :func:`~pytorch_cifar_tpu_torch.serve.fleet.recover_controller` rebuilds
  a fleet controller.
- :class:`JournalFollower`: a membership syncer for a data plane whose
  controller is another process. It polls the journal, reduces it and
  diffs the replicas against a live
  :class:`~pytorch_cifar_tpu_torch.serve.router.Router` (add the missing,
  remove the gone), so the edge and the controller can die independently.

Telemetry: ``serve.fleet.journal_appends`` counts durable appends.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

SNAPSHOT_SUFFIX = ".snapshot"
SNAPSHOT_MARKER_SUFFIX = ".snapshot.json"


class JournalCorrupt(RuntimeError):
    """The journal cannot be replayed: a record BEFORE the final one is
    undecodable, fails its CRC, or the sequence numbers regress. A torn
    final record is NOT corruption (the crash landed mid-append) — it is
    dropped and reported by :func:`replay_journal`."""


def _fsync_dir(dirpath: str) -> None:
    """Durably record a rename/append in its directory (the checkpoint
    layer's discipline). Best-effort: some filesystems reject it."""
    try:
        fd = os.open(dirpath or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + rename + dir fsync: the publish shape of
    ``train/checkpoint._atomic_write``, kept here so this module stays
    stdlib-only."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _canon(rec: dict) -> bytes:
    return json.dumps(
        rec, sort_keys=True, separators=(",", ":")
    ).encode("utf-8")


def _encode_record(rec: dict) -> bytes:
    body = _canon(rec)
    frame = {"crc": zlib.crc32(body) & 0xFFFFFFFF, "rec": rec}
    return (
        json.dumps(frame, sort_keys=True, separators=(",", ":")).encode(
            "utf-8"
        )
        + b"\n"
    )


def _decode_line(line: bytes) -> dict:
    """One framed record back out; raises ValueError on any damage."""
    frame = json.loads(line.decode("utf-8"))
    rec = frame["rec"]
    if not isinstance(rec, dict):
        raise ValueError("record frame is not an object")
    if zlib.crc32(_canon(rec)) & 0xFFFFFFFF != int(frame["crc"]):
        raise ValueError("record crc mismatch")
    return rec


def _read_snapshot(path: str) -> Tuple[List[dict], int]:
    """The committed compaction snapshot for journal ``path``, or
    ``([], 0)`` when there is none. An unverifiable snapshot (torn
    payload, stale marker) is IGNORED, not an error: the live journal is
    only truncated AFTER the marker commits, so whenever the snapshot
    does not verify the full record stream is still in the live file."""
    snap, marker = path + SNAPSHOT_SUFFIX, path + SNAPSHOT_MARKER_SUFFIX
    try:
        with open(marker, "rb") as f:
            meta = json.load(f)
        with open(snap, "rb") as f:
            payload = f.read()
    except (OSError, ValueError):
        return [], 0
    if len(payload) != int(meta.get("size", -1)) or (
        zlib.crc32(payload) & 0xFFFFFFFF != int(meta.get("crc32", -1))
    ):
        return [], 0
    obj = json.loads(payload.decode("utf-8"))
    return list(obj.get("records", ())), int(obj.get("base_seq", 0))


def replay_journal(path: str) -> Tuple[List[dict], bool]:
    """Replay journal ``path`` → ``(records, torn_tail)``.

    Records from a committed compaction snapshot come first, then every
    live record with ``seq > base_seq`` (a crash between the snapshot's
    marker commit and the live-file truncate leaves both on disk — the
    overlap is skipped, never double-applied). A missing journal is an
    empty one. Raises :class:`JournalCorrupt` on a damaged non-final
    record or a sequence regression."""
    records, base_seq = _read_snapshot(path)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return records, False
    lines = raw.split(b"\n")
    torn = False
    if lines and lines[-1] == b"":
        lines.pop()  # the normal trailing newline
    elif lines:
        torn = True  # no final newline: the last append was cut short
    last_seq = None
    for i, line in enumerate(lines):
        final = i == len(lines) - 1
        try:
            rec = _decode_line(line)
            seq = int(rec["seq"])
        except (ValueError, KeyError, TypeError) as e:
            if final:
                return records, True  # torn tail: crash mid-append
            raise JournalCorrupt(
                f"{path}: record {i + 1} is unreadable ({e}) and is not "
                "the final record — the journal is damaged, not torn"
            )
        if final and torn:
            # decodable bytes but no newline: still an incomplete append
            return records, True
        if seq <= base_seq:
            continue  # already summarized by the snapshot
        if last_seq is not None and seq <= last_seq:
            raise JournalCorrupt(
                f"{path}: sequence regressed ({seq} after {last_seq}) — "
                "interleaved writers or a rewound file"
            )
        last_seq = seq
        records.append(rec)
    return records, torn


class ControllerJournal:
    """The append-durable actuation journal (module docstring).

    ``append(op, **fields)`` frames the record, writes it, and fsyncs
    the file BEFORE returning — callers journal the intent first and
    actuate second, so a crash can lose an actuation but never the
    record of one that happened. ``compact(records)`` snapshots a
    caller-reduced record list (payload first, commit marker LAST, both
    via tmp+fsync+rename) and truncates the live file."""

    def __init__(self, path: str, *, registry=None):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        # continue the sequence where the existing journal ends; raises
        # JournalCorrupt loudly rather than appending after damage
        records, _ = replay_journal(path)
        seqs = [int(r["seq"]) for r in records if "seq" in r]
        _, base_seq = _read_snapshot(path)
        self._seq = max([base_seq] + seqs)
        self._lock = threading.Lock()
        self._f = open(path, "ab")
        _fsync_dir(d)  # the journal file's own creation is durable
        self._c_appends = None
        if registry is not None:
            self._c_appends = registry.counter(
                "serve.fleet.journal_appends"
            )

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def append(self, op: str, **fields) -> dict:
        """Durably append one record and return it. The fsync happens
        HERE, before any caller actuation — the whole point."""
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "wall": time.time(), "op": str(op)}
            rec.update(fields)
            self._f.write(_encode_record(rec))
            self._f.flush()
            os.fsync(self._f.fileno())
        if self._c_appends is not None:
            self._c_appends.inc()
        return rec

    def records(self) -> List[dict]:
        """The replayable record stream (torn tail dropped)."""
        return replay_journal(self.path)[0]

    def compact(self, records: List[dict]) -> None:
        """Replace the journal's history with ``records`` (a
        caller-reduced summary that replays to the same state — e.g.
        one ``adopt`` per live replica). Payload first, commit marker
        last, live file truncated only after the marker commits: replay
        stays correct across a crash at ANY point in between."""
        with self._lock:
            payload = json.dumps(
                {"base_seq": self._seq, "records": list(records)},
                sort_keys=True,
            ).encode("utf-8")
            _atomic_write(self.path + SNAPSHOT_SUFFIX, payload)
            marker = {
                "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
                "size": len(payload),
                "base_seq": self._seq,
            }
            _atomic_write(
                self.path + SNAPSHOT_MARKER_SUFFIX,
                json.dumps(marker).encode("utf-8"),
            )
            self._f.close()
            with open(self.path, "wb") as f:
                f.flush()
                os.fsync(f.fileno())
            self._f = open(self.path, "ab")
            _fsync_dir(os.path.dirname(os.path.abspath(self.path)))

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


class FleetJournalState:
    """Pure reducer: record stream → control-plane state. No I/O, no
    clocks: the canary controller's restart (and, with the fleet, the
    controller's recovery) builds its view of the world from exactly
    this."""

    def __init__(self):
        # url -> {"idx", "pid", "generation", "compiles", "draining"}
        self.replicas: Dict[str, dict] = {}
        self.next_idx = 0
        self.policy_state: dict = {}
        self.generation: Optional[int] = None
        self.rollout: Optional[dict] = None
        self.vetting: Optional[dict] = None
        self.promotion_generation: Optional[int] = None
        self.spawn_intents: Dict[int, float] = {}
        self.rollouts = 0
        self.rollbacks = 0

    @classmethod
    def from_records(cls, records: List[dict]) -> "FleetJournalState":
        state = cls()
        for rec in records:
            state.apply(rec)
        return state

    def _bump_idx(self, idx) -> None:
        if idx is not None:
            self.next_idx = max(self.next_idx, int(idx) + 1)

    def apply(self, rec: dict) -> None:
        op = rec.get("op")
        idx = rec.get("idx")
        url = rec.get("url")
        if op == "spawn-intent":
            self._bump_idx(idx)
            self.spawn_intents[int(idx)] = rec.get("wall", 0.0)
        elif op == "spawn-failed":
            self.spawn_intents.pop(int(idx), None)
        elif op in ("replica-up", "adopt"):
            self._bump_idx(idx)
            if idx is not None:
                self.spawn_intents.pop(int(idx), None)
            self.replicas[url] = {
                "idx": idx,
                "pid": rec.get("pid"),
                "generation": rec.get("generation"),
                "compiles": rec.get("compiles"),
                "draining": False,
            }
        elif op == "drain-intent":
            if url in self.replicas:
                self.replicas[url]["draining"] = True
        elif op in ("drain-done", "reap"):
            self.replicas.pop(url, None)
        elif op == "policy":
            self.policy_state = {
                k: v
                for k, v in rec.items()
                if k not in ("seq", "wall", "op")
            }
        elif op == "generation":
            g = rec.get("generation")
            self.generation = None if g is None else int(g)
        elif op == "rollout-begin":
            self.rollout = {
                "from_generation": rec.get("from_generation"),
                "to_generation": rec.get("to_generation"),
                "n_start": rec.get("n_start"),
                "phase": "surge",
                "reason": None,
            }
        elif op == "rollout-phase":
            if self.rollout is not None:
                self.rollout["phase"] = rec.get("phase")
        elif op == "rollout-halt":
            if self.rollout is not None:
                self.rollout["phase"] = "rollback"
                self.rollout["reason"] = rec.get("reason")
        elif op == "rollout-done":
            g = rec.get("generation")
            self.generation = None if g is None else int(g)
            self.rollouts += 1
            self.rollout = None
        elif op == "rollout-rollback-done":
            self.rollbacks += 1
            self.rollout = None
        elif op == "vet-begin":
            self.vetting = {
                k: v
                for k, v in rec.items()
                if k not in ("seq", "wall", "op")
            }
        elif op == "vet-verdict":
            self.vetting = None
            if rec.get("verdict") == "promoted":
                g = rec.get("generation")
                if g is not None:
                    self.promotion_generation = int(g)
        # unknown ops are ignored: an older inspector must keep working
        # against a newer controller's journal

    def live_replicas(self) -> Dict[str, dict]:
        """Replicas the journal believes are serving (not mid-drain)."""
        return {
            u: dict(info)
            for u, info in self.replicas.items()
            if not info.get("draining")
        }

    def summary_records(self) -> List[dict]:
        """A minimal record list that replays to this state — what
        ``ControllerJournal.compact`` stores. Seq-less on purpose: the
        reducer never reads seq, and replay orders snapshot records
        before every live record."""
        out: List[dict] = []
        if self.generation is not None:
            out.append({"op": "generation", "generation": self.generation})
        for url, info in sorted(self.replicas.items()):
            out.append(
                {
                    "op": "adopt",
                    "idx": info.get("idx"),
                    "url": url,
                    "pid": info.get("pid"),
                    "generation": info.get("generation"),
                    "compiles": info.get("compiles"),
                }
            )
            if info.get("draining"):
                out.append(
                    {"op": "drain-intent", "idx": info.get("idx"),
                     "url": url}
                )
        if self.policy_state:
            out.append({"op": "policy", **self.policy_state})
        if self.promotion_generation is not None:
            out.append(
                {
                    "op": "vet-verdict",
                    "verdict": "promoted",
                    "generation": self.promotion_generation,
                }
            )
        if self.rollout is not None:
            out.append(
                {
                    "op": "rollout-begin",
                    "from_generation": self.rollout.get("from_generation"),
                    "to_generation": self.rollout.get("to_generation"),
                    "n_start": self.rollout.get("n_start"),
                }
            )
            phase = self.rollout.get("phase")
            if phase == "rollback":
                out.append(
                    {"op": "rollout-halt",
                     "reason": self.rollout.get("reason")}
                )
            elif phase not in (None, "surge"):
                out.append({"op": "rollout-phase", "phase": phase})
        if self.vetting is not None:
            out.append({"op": "vet-begin", **self.vetting})
        return out


class JournalFollower:
    """Membership syncer for a data plane whose controller is a SEPARATE
    process (the durable-control-plane drill): polls the journal,
    reduces it, and declaratively diffs the live replica set against the
    router — add what the journal has and the router lacks, remove what
    the router has and the journal dropped. Idempotent by construction
    (``Router.add_replica`` ignores a known URL), so a poll racing a
    compaction or a torn tail converges on the next sweep; a CORRUPT
    journal holds the last applied membership and logs (the edge must
    keep serving whatever fleet it has)."""

    def __init__(self, path: str, router, *, poll_s: float = 0.2):
        self.path = path
        self.router = router
        self.poll_s = float(poll_s)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.syncs = 0
        self.corrupt_polls = 0

    def sync_once(self) -> Dict[str, dict]:
        """One poll: returns the journal's live replica view after
        applying the membership diff to the router."""
        try:
            records, _ = replay_journal(self.path)
        except JournalCorrupt as e:
            with self._lock:
                self.corrupt_polls += 1
            log.warning("journal follower holding membership: %s", e)
            return {}
        want = FleetJournalState.from_records(records).live_replicas()
        have = set(self.router.fleet_view().keys())
        for url in want:
            if url not in have:
                self.router.add_replica(url)
        for url in have - set(want):
            self.router.remove_replica(url)
        with self._lock:
            self.syncs += 1
        return want

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.sync_once()
            except Exception:
                log.exception("journal follower sweep failed")

    def start(self) -> "JournalFollower":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="journal-follower", daemon=True
                )
                self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()
