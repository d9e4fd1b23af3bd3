"""Checkpoint hot-reload: serve the newest publish of a live dir.

Counterpart of ``pytorch_cifar_tpu/serve/reload.py``. A serving process
pointed at a trainer's (or the canary's) live ``output_dir`` polls for a
newer ``ckpt.msgpack`` + sidecar and swaps its weights into the engine with
:meth:`InferenceEngine.swap_weights`: the new ``state_dict`` is checked
against the served model's keys, shapes and dtypes, folded off the lock and
assigned in one reference, so

- in-flight requests finish on the weights they captured (nothing drops),
- nothing is warmed up again (``compile_count`` does not move), and
- a wrong checkpoint (another model trained into the same dir) is refused
  loudly while serving goes on with the previous weights.

**A half-written checkpoint is never served**: the loader verifies the
payload against the sidecar's CRC32/size manifest before the swap, and the
watcher stats the pair again after the read, so a torn write, a pair from
two different publishes, or a publish racing the read is skipped for this
poll and retried on the next. A staging dir (the canary's input) and a
quarantined publish (the canary's reject) are refused outright.

Polling, not inotify: the dir may sit on a network filesystem, and a
poll of a second or so is far below any checkpoint cadence that matters.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from pytorch_cifar_tpu_torch.obs import trace
from pytorch_cifar_tpu_torch.serve.engine import load_checkpoint_trees
from pytorch_cifar_tpu_torch.train.checkpoint import (
    CKPT_NAME,
    CheckpointCorrupt,
    is_quarantined,
    is_staging_dir,
    meta_path,
    read_quarantine,
)

log = logging.getLogger(__name__)


class CheckpointWatcher:
    """Poll ``ckpt_dir`` for a new ``name`` checkpoint; swap it into
    ``engine``. Start with :meth:`start` (or as a context manager), stop
    with :meth:`stop`. ``reloads``/``errors``/``skipped``/``quarantined``
    and ``last_meta``/``last_version`` are observable for tests and the
    CLI's report."""

    def __init__(
        self,
        engine,
        ckpt_dir: str,
        *,
        name: str = CKPT_NAME,
        poll_s: float = 1.0,
        registry=None,
    ):
        self.engine = engine
        self.ckpt_dir = ckpt_dir
        self.name = name
        self.poll_s = float(poll_s)
        self.reloads = 0
        self.errors = 0
        # polls that saw a torn or in-progress publish and deferred (a
        # later poll picks it up complete)
        self.skipped = 0
        # publishes refused because a quarantine tombstone covers them;
        # unlike `skipped` these never become loadable: only a new publish
        self.quarantined = 0
        # the watched dir is a staging dir: every swap is refused (logged
        # once; the flag is the latch)
        self._staging_refused = False
        self.last_meta: dict = {}
        # the engine version the newest successful swap returned
        self.last_version: Optional[int] = None
        # the counters mirror the attributes as serve.reload.* when a
        # registry is given
        self._obs = registry
        self._stop = threading.Event()
        # guards the observable stats and the thread handle: the poll
        # thread writes them while the CLI and tests read them
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        # whatever is on disk now is what the engine was loaded from; only
        # a later publish triggers a swap
        self._last_sig = self._signature()

    def _path(self) -> str:
        return os.path.join(self.ckpt_dir, self.name)

    def _signature(self):
        """Identity of the current publish: the stat identities of both
        the payload and its sidecar. Every writer here is tmp + rename, so
        a new publish is a new inode and (ino, mtime_ns, size) changes on
        every publish and never mid-write. A v3 publish rewrites only the
        commit-marker sidecar (last) and its shards, so the sidecar is
        always part of the signature."""

        def stat_of(path):
            try:
                st = os.stat(path)
            except OSError:
                return None
            return (st.st_ino, st.st_mtime_ns, st.st_size)

        payload = stat_of(self._path())
        sidecar = stat_of(meta_path(self.ckpt_dir, self.name))
        if payload is None and sidecar is None:
            return None
        return (payload, sidecar)

    def _count(self, event: str) -> None:
        if self._obs is not None:
            self._obs.counter(f"serve.reload.{event}").inc()

    def poll_once(self) -> bool:
        """One poll: reload iff the signature changed and the verified
        load and the swap succeed. Returns True when a swap happened.
        Tests drive the watcher through it without timing."""
        if is_staging_dir(self.ckpt_dir):
            # the canary's input: unvetted by definition, never swapped in
            with self._lock:
                first = not self._staging_refused
                self._staging_refused = True
            if first:
                log.warning(
                    "watcher pointed at STAGING dir %s: refusing every "
                    "hot reload (serve the live dir instead)",
                    self.ckpt_dir,
                )
                self._count("refused_staging")
            return False
        sig = self._signature()
        if sig is None or sig == self._last_sig:
            return False
        count = self._count
        if is_quarantined(self.ckpt_dir, self.name):
            tomb = read_quarantine(self.ckpt_dir, self.name) or {}
            log.warning(
                "refusing quarantined checkpoint %s (%s); keeping "
                "current weights until a NEW publish lands",
                self._path(), tomb.get("reason", "no reason recorded"),
            )
            with self._lock:
                self.quarantined += 1
                self._last_sig = sig  # only a new publish re-evaluates
            count("quarantined")
            return False
        try:
            state_dict, meta = load_checkpoint_trees(
                self._path(),
                self.engine.model_name,
                num_classes=self.engine.num_classes,
            )
        except CheckpointCorrupt as e:
            # torn or mid-publish: the signature is not remembered, the
            # pair should settle by the next poll; a file that stays
            # corrupt keeps being skipped, never served
            log.warning("skipping torn/corrupt checkpoint: %s", e)
            with self._lock:
                self.skipped += 1
            count("skipped")
            return False
        except Exception:
            # unreadable for another reason (deleted mid-read, another
            # model's tree): remember the signature, do not re-read it
            log.exception("checkpoint reload failed (%s)", self._path())
            with self._lock:
                self.errors += 1
                self._last_sig = sig
            count("errors")
            return False
        if self._signature() != sig:
            # republished while we read: the meta may describe the old
            # payload; the next poll sees the settled pair
            log.info(
                "checkpoint %s republished mid-read; deferring swap one "
                "poll", self._path(),
            )
            with self._lock:
                self.skipped += 1
            count("skipped")
            return False
        try:
            version = self.engine.swap_weights(state_dict)
        except Exception:
            # wrong model: keep serving the previous weights; remember the
            # signature so it is not retried every poll
            log.exception("checkpoint swap rejected (%s)", self._path())
            with self._lock:
                self.errors += 1
                self._last_sig = sig
            count("errors")
            return False
        with self._lock:
            self._last_sig = sig
            self.last_meta = meta
            self.last_version = version
            self.reloads += 1
        count("reloads")
        trace.instant(
            "serve/hot_reload",
            version=version,
            path=self._path(),
            devices=getattr(self.engine, "n_devices", 1),
        )
        log.info(
            "hot-reloaded %s -> engine version %d on %d device(s) "
            "(meta %s)",
            self._path(),
            version,
            getattr(self.engine, "n_devices", 1),
            meta,
        )
        return True

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.poll_once()

    def start(self) -> "CheckpointWatcher":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="ckpt-watcher", daemon=True
                )
                self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # take the handle under the lock, join outside it
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
