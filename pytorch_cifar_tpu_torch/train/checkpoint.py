"""Checkpoint save/restore of the port's train state, in the JAX package's
on-disk format (counterpart of ``pytorch_cifar_tpu/train/checkpoint.py``).

A checkpoint written here is read by the JAX package's unchanged code, and
the reverse: the same file names, the same payload bytes for the same
state, the same sidecar.

- **Payload**: the msgpack of the JAX train tree (``compat``'s
  :func:`~pytorch_cifar_tpu_torch.compat.train_tree_from_state`: params,
  BN stats, the optimizer's momentum ``trace`` and ``count``, the step),
  encoded by the port's own codec (``serialization.py``), byte for byte
  what ``flax.serialization.to_bytes`` writes.
- **v2**: the payload file plus a ``<stem>.json`` sidecar ``{"epoch",
  "best_acc", "manifest": {"format": 2, "crc32", "size"}}``, written
  payload first, sidecar second, each by tmp + fsync + rename + directory
  fsync. A sidecar with no manifest is v1: it restores with a warning.
- **v3** (sharded, several processes): every rank writes its byte range
  of the payload as ``<stem>.shardKKKKK-of-NNNNN.msgpack`` with a shard
  sidecar ``{"epoch", "manifest"}``; rank 0 waits until every shard of
  this publish verifies on disk (a filesystem barrier: no collective) and
  writes the commit marker ``<stem>.json`` ``{"format": 3, "epoch",
  "best_acc", "total", "shards"}`` last. Read shard by shard against the
  marker's list; shards without their marker are invisible. One process
  asked for ``num_shards > 1`` writes every shard itself (tests, tools).
- **Rolling history** (``keep_last_n``): copies, never hard links, as extra
  restore candidates behind each file.
- **Staging and promotion** (the canary pipeline): a trainer under
  ``--publish staging`` writes into ``<output_dir>/staging`` (marked by a
  ``.staging`` file); :func:`publish_checkpoint` promotes a verified
  candidate into the live dir as a v2 pair, keeping the incumbent as the
  ``.prev`` pair; :func:`quarantine_checkpoint` writes the tombstone
  ``<stem>.quarantined.json`` that pins one rejected publish by its
  fingerprint. The live pair is byte for byte the JAX package's.
- **Reshard** (elastic training): :func:`reshard_checkpoint` re-cuts a
  committed publish to N byte-range shards (v2 for N = 1), the payload
  bit-identical, the commit marker last; :func:`reshard_to_world` re-cuts
  both resume candidates to the current world on rank 0. The files are
  the JAX package's reshard's, byte for byte.
- **Async saves**: only the snapshot and its one device-to-host copy run on
  the calling thread; the codec, the CRC and the commit run on an
  :class:`AsyncCheckpointWriter` thread, which touches host numpy only,
  never a CUDA tensor.

Fault hooks (``faults.py``, inert unless armed): ``ckpt_write_stall``
sleeps between a payload or shard and its sidecar or commit marker;
``ckpt_regress`` perturbs the snapshot's params before they are published,
with the JAX save's seed and draw order.

Restore walks the candidates (each expanded with its history), falls back
on any :class:`CheckpointCorrupt` with a warning and
``checkpoint.fallbacks``, and raises ``FileNotFoundError("no usable
checkpoint ...")`` only when no candidate is usable. It loads onto the
state's own device. Under several processes rank 0 walks and decides, and
every rank decodes the payload bytes rank 0 broadcasts.

The tree mapping (``compat``) and the process group (``parallel.mesh``)
are imported by the functions that use them, so the staging, quarantine
and publish helpers load no torch: a process that only moves checkpoint
files (``tools/chaos_run.py``) never touches a device.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import threading
import time
import zlib
from typing import TYPE_CHECKING, Any, Callable, Optional, Sequence, Tuple

import numpy as np

from pytorch_cifar_tpu_torch import faults
from pytorch_cifar_tpu_torch.obs import trace
from pytorch_cifar_tpu_torch.serialization import (
    MsgpackError,
    msgpack_restore,
    to_bytes,
)

if TYPE_CHECKING:
    from pytorch_cifar_tpu_torch.compat import TrainArrays

log = logging.getLogger(__name__)

CKPT_NAME = "ckpt.msgpack"   # best-accuracy checkpoint
LAST_NAME = "last.msgpack"   # preemption save: exact latest state

MANIFEST_FORMAT = 2
SHARDED_FORMAT = 3
# how long rank 0 waits for the peers' shards of a v3 publish, and how often
# it looks
_SHARD_BARRIER_TIMEOUT_S = 120.0
_SHARD_BARRIER_POLL_S = 0.05


class CheckpointCorrupt(RuntimeError):
    """A checkpoint payload failed verification (checksum/size mismatch,
    missing/corrupt shard, undeserializable bytes, or a tree that is not
    the model's). Restore falls back to the next candidate."""


def meta_path(output_dir: str, name: str) -> str:
    """Path of the JSON scalar sidecar paired with checkpoint ``name``."""
    return os.path.join(output_dir, os.path.splitext(name)[0] + ".json")


# -- staging / quarantine / promotion (serve/canary.py) ------------------

STAGING_SUBDIR = "staging"
STAGING_MARKER = ".staging"


def staging_dir(output_dir: str) -> str:
    """The staging subdirectory of ``output_dir``: where a trainer under
    ``--publish staging`` commits its checkpoints for the canary to vet.
    The hot-reload watcher refuses it; only the promotion controller reads
    it."""
    return os.path.join(output_dir, STAGING_SUBDIR)


def ensure_staging_dir(output_dir: str) -> str:
    """Create the staging dir with its marker file, which lets a watcher
    pointed at it by mistake know it whatever the directory's name."""
    path = staging_dir(output_dir)
    os.makedirs(path, exist_ok=True)
    marker = os.path.join(path, STAGING_MARKER)
    if not os.path.exists(marker):
        try:
            _atomic_write(
                marker, b"staging checkpoint dir: never serve directly\n"
            )
        except FileNotFoundError:
            # another rank of the job renamed the same tmp file first
            if not os.path.exists(marker):
                raise
    return path


def is_staging_dir(path: str) -> bool:
    """A dir holding the marker file, or named ``staging``: its
    checkpoints are unvetted and never hot-loaded into a serving engine."""
    return os.path.exists(os.path.join(path, STAGING_MARKER)) or (
        os.path.basename(os.path.abspath(path)) == STAGING_SUBDIR
    )


def quarantine_path(output_dir: str, name: str) -> str:
    """Path of the quarantine tombstone sidecar for checkpoint ``name``."""
    return os.path.join(
        output_dir, os.path.splitext(name)[0] + ".quarantined.json"
    )


def publish_fingerprint(meta: dict) -> Optional[dict]:
    """Identity of one committed publish whatever its format: the
    whole-payload manifest (v2 ``manifest``, v3 ``total``) as crc32 and
    size. A tombstone records it, so it poisons exactly one publish."""
    man = (meta or {}).get("manifest") or (meta or {}).get("total")
    if not man:
        return None
    return {
        "crc32": int(man.get("crc32", -1)),
        "size": int(man.get("size", -1)),
    }


def quarantine_checkpoint(
    output_dir: str, name: str, reason: str, meta: Optional[dict] = None,
    extra: Optional[dict] = None,
) -> str:
    """Write the tombstone sidecar that marks the current publish of
    ``name`` rejected (the canary's verdict), in one atomic write. The
    checkpoint files stay as evidence; every reader keys on the
    tombstone."""
    if meta is None:
        meta = read_meta(output_dir, name)
    rec = {
        "reason": str(reason),
        "epoch": meta.get("epoch"),
        "best_acc": meta.get("best_acc"),
        "fingerprint": publish_fingerprint(meta),
        "at": time.time(),
    }
    rec.update(extra or {})
    path = quarantine_path(output_dir, name)
    _atomic_write(path, json.dumps(rec).encode())
    return path


def read_quarantine(output_dir: str, name: str) -> Optional[dict]:
    """The tombstone record of ``name``; None when absent or unreadable."""
    try:
        with open(quarantine_path(output_dir, name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def is_quarantined(
    output_dir: str, name: str, meta: Optional[dict] = None
) -> bool:
    """True when the current publish of ``name`` carries a matching
    tombstone. A tombstone with another fingerprint belongs to an older
    publish and is inert; one that cannot be compared (no fingerprint, or
    a sidecar without a manifest) stays in force."""
    tomb = read_quarantine(output_dir, name)
    if tomb is None:
        return False
    fp = tomb.get("fingerprint")
    if not fp:
        return True
    cur = publish_fingerprint(
        meta if meta is not None else read_meta(output_dir, name)
    )
    return cur is None or cur == fp


def publish_checkpoint(
    src_dir: str, dst_dir: str, name: str = CKPT_NAME,
    extra_meta: Optional[dict] = None,
) -> str:
    """Promote checkpoint ``name`` from ``src_dir`` into ``dst_dir`` (the
    live dir the watchers key on). The payload is read verified (v3
    reassembled from its committed shards), so a torn or corrupt candidate
    is never promoted; the destination is a v2 publish, payload first and
    sidecar (with ``extra_meta`` merged in, e.g. the promotion stamp)
    last. The incumbent is kept as the ``.prev`` pair first.

    Raises FileNotFoundError (no candidate) or :class:`CheckpointCorrupt`,
    on which the promotion controller quarantines."""
    meta = read_meta(src_dir, name)
    payload = read_verified_payload(src_dir, name, meta)
    os.makedirs(dst_dir, exist_ok=True)
    _preserve_previous_publish(dst_dir, name)
    out_meta = {
        "epoch": meta.get("epoch"),
        "best_acc": meta.get("best_acc"),
        "manifest": payload_manifest(payload),
    }
    out_meta.update(extra_meta or {})
    _atomic_write(os.path.join(dst_dir, name), payload)
    _atomic_write(meta_path(dst_dir, name), json.dumps(out_meta).encode())
    return os.path.join(dst_dir, name)


def prev_publish_name(name: str = CKPT_NAME) -> str:
    """On-disk name of the rollback pair kept beside the live publish."""
    stem, ext = os.path.splitext(name)
    return f"{stem}.prev{ext}"


def _preserve_previous_publish(dst_dir: str, name: str) -> None:
    """Keep a verified copy of the incumbent publish as the ``.prev`` pair
    (the rollback source), payload first and its old sidecar last. A torn
    or corrupt incumbent is skipped."""
    if not os.path.exists(os.path.join(dst_dir, name)):
        return
    try:
        prev_meta = read_meta(dst_dir, name)
        prev_payload = read_verified_payload(dst_dir, name, prev_meta)
    except (OSError, ValueError, CheckpointCorrupt):
        return
    prev_name = prev_publish_name(name)
    _atomic_write(os.path.join(dst_dir, prev_name), prev_payload)
    _atomic_write(
        meta_path(dst_dir, prev_name), json.dumps(prev_meta).encode()
    )


def restore_previous_publish(dst_dir: str, name: str = CKPT_NAME) -> bool:
    """Republish the ``.prev`` pair over the live publish (a rollout's
    rollback): a verified read, then payload first and sidecar last, the
    sidecar carrying the old promotion stamp. False when there is no
    rollback pair; :class:`CheckpointCorrupt` when it does not verify."""
    prev_name = prev_publish_name(name)
    if not os.path.exists(os.path.join(dst_dir, prev_name)):
        return False
    prev_meta = read_meta(dst_dir, prev_name)
    prev_payload = read_verified_payload(dst_dir, prev_name, prev_meta)
    _atomic_write(os.path.join(dst_dir, name), prev_payload)
    _atomic_write(
        meta_path(dst_dir, name), json.dumps(prev_meta).encode()
    )
    return True


def shard_name(name: str, index: int, num_shards: int) -> str:
    """On-disk name of byte-range shard ``index`` of ``name`` (format v3).
    The ``-of-N`` suffix is part of the identity: a save from another
    process count never overwrites part of this one."""
    stem = os.path.splitext(name)[0]
    return f"{stem}.shard{int(index):05d}-of-{int(num_shards):05d}.msgpack"


def payload_manifest(payload: bytes) -> dict:
    """The sidecar manifest entry that lets any reader verify the payload
    without deserializing it."""
    return {
        "format": MANIFEST_FORMAT,
        "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
        "size": len(payload),
    }


def verify_checkpoint_payload(payload: bytes, meta: dict, path: str) -> None:
    """Check ``payload`` against the sidecar ``meta``'s manifest. Raises
    :class:`CheckpointCorrupt` on a size or checksum mismatch; a sidecar
    without a manifest (v1) passes with a logged warning."""
    manifest = (meta or {}).get("manifest")
    if not manifest:
        log.warning(
            "checkpoint %s has no manifest (format v1): restoring "
            "unverified — re-save to upgrade to format v2", path
        )
        return
    if len(payload) != int(manifest.get("size", -1)):
        raise CheckpointCorrupt(
            f"{path}: payload is {len(payload)} bytes, manifest says "
            f"{manifest.get('size')} (truncated or torn write)"
        )
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    if crc != int(manifest.get("crc32", -1)):
        raise CheckpointCorrupt(
            f"{path}: payload crc32 {crc:#010x} != manifest "
            f"{int(manifest.get('crc32', -1)):#010x} (bit corruption)"
        )


def _fsync_dir(dirpath: str) -> None:
    """Durably record a rename in its directory (best effort: some
    filesystems reject a directory fsync)."""
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
    """tmp + fsync + rename + dir fsync: a crash at any point leaves the
    old complete file or the new complete file, never a torn one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


# -- rolling history -----------------------------------------------------

def _history_stem(name: str) -> str:
    return os.path.splitext(name)[0]


def _history_name(name: str, epoch: int) -> str:
    return f"{_history_stem(name)}-e{max(int(epoch), 0):05d}.msgpack"


def history_names(output_dir: str, name: str):
    """Rolling-history checkpoint names for ``name``, newest epoch first:
    payload files and (for v3 entries, which have none) commit sidecars."""
    stem = _history_stem(name)
    found = set()
    for ext in ("msgpack", "json"):
        pat = re.compile(re.escape(stem) + r"-e(\d+)\." + ext + "$")
        for path in glob.glob(os.path.join(output_dir, f"{stem}-e*.{ext}")):
            m = pat.search(os.path.basename(path))
            if m:
                found.add((int(m.group(1)),
                           _history_name(name, int(m.group(1)))))
    return [n for _, n in sorted(found, reverse=True)]


def _remove_candidate_files(output_dir: str, name: str) -> None:
    """Delete every file of candidate ``name``: payload, sidecar, and any
    v3 shards with their sidecars."""
    stem = os.path.splitext(name)[0]
    targets = [os.path.join(output_dir, name), meta_path(output_dir, name)]
    for sp in glob.glob(
        os.path.join(output_dir, stem + ".shard*-of-*.msgpack")
    ):
        targets += [sp, meta_path(output_dir, os.path.basename(sp))]
    for p in targets:
        try:
            os.remove(p)
        except OSError:
            pass


def _prune_history(output_dir: str, name: str, keep_last_n: int) -> None:
    for stale in history_names(output_dir, name)[keep_last_n:]:
        _remove_candidate_files(output_dir, stale)


def _update_history(
    output_dir: str, name: str, epoch: int, payload: bytes, meta: dict,
    keep_last_n: int,
) -> None:
    """Publish a history copy of the just-written checkpoint (a separate
    inode: damage to the primary cannot reach it) and prune the oldest
    entries beyond ``keep_last_n``."""
    hname = _history_name(name, epoch)
    _atomic_write(os.path.join(output_dir, hname), payload)
    _atomic_write(meta_path(output_dir, hname), json.dumps(meta).encode())
    _prune_history(output_dir, name, keep_last_n)


# -- async writer --------------------------------------------------------

class AsyncCheckpointWriter:
    """Background commit thread for :func:`save_checkpoint`.

    - At most one pending job per submit ``key`` (the checkpoint name): a
      newer job for the same name replaces the queued one
      (``checkpoint.superseded_saves``); jobs of different names queue
      independently, in submit order.
    - The error of a failed job is stored and re-raised by the next
      :meth:`submit`, :meth:`flush` or :meth:`close`.
    - :meth:`close` drains the queue and joins the thread. The thread
      starts at the first submit.

    Every attribute the thread shares is mutated under ``self._cond``.
    """

    def __init__(self, registry=None, name: str = "ckpt-writer"):
        self._cond = threading.Condition()
        self._pending: dict = {}  # key -> job, in submit order
        self._busy = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._obs = registry
        self._name = name

    def _publish_depth_locked(self) -> None:
        if self._obs is not None:
            self._obs.gauge("checkpoint.pending_saves").set(
                len(self._pending) + (1 if self._busy else 0)
            )

    def _raise_pending_error_locked(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, job: Callable[[], Any], key: str = "") -> None:
        """Queue ``job``; replaces a still-queued job of the same ``key``;
        re-raises a stored error of an earlier job."""
        with self._cond:
            self._raise_pending_error_locked()
            if key in self._pending and self._obs is not None:
                self._obs.counter("checkpoint.superseded_saves").inc()
            self._pending[key] = job
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True
                )
                self._thread.start()
            self._publish_depth_locked()
            self._cond.notify_all()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stopping:
                    self._cond.wait()
                if not self._pending:
                    return
                key = next(iter(self._pending))
                job = self._pending.pop(key)
                self._busy = True
                self._publish_depth_locked()
            t0 = time.perf_counter()
            err = None
            try:
                job()
            except BaseException as e:  # stored, re-raised on interaction
                err = e
            if self._obs is not None:
                self._obs.histogram("checkpoint.writer_ms").observe(
                    (time.perf_counter() - t0) * 1e3
                )
            with self._cond:
                if err is not None and self._error is None:
                    self._error = err
                self._busy = False
                self._publish_depth_locked()
                self._cond.notify_all()

    def flush(self) -> None:
        """Block until every submitted job has run; re-raise any error."""
        with self._cond:
            while self._pending or self._busy:
                self._cond.wait()
            self._raise_pending_error_locked()

    def close(self) -> None:
        """Drain pending work, join the thread, re-raise any error. A
        later submit starts a new thread."""
        with self._cond:
            self._stopping = True
            t = self._thread
            self._thread = None
            self._cond.notify_all()
        if t is not None:
            t.join()
        with self._cond:
            self._stopping = False
            self._raise_pending_error_locked()


# -- fault hooks ---------------------------------------------------------

def _chaos_stall() -> None:
    """Fault hook (inert unless ``ckpt_write_stall`` is armed, in ms):
    sleep between a payload or shard and its sidecar or commit marker, so
    a kill drill lands inside the torn-pair window."""
    ms = faults.get("ckpt_write_stall")
    if ms:
        time.sleep(float(ms) / 1e3)


def _regress_params(tree: dict, scale: float, seed: int = 0xC0FFEE) -> dict:
    """Fault hook ``ckpt_regress``: ``tree`` with every float leaf
    perturbed by N(0, scale * its std) (std floor 1.0), the leaves drawn
    from one ``RandomState(seed)`` in sorted-key order (the order
    ``jax.tree_util`` visits a dict's leaves, so the draws are the JAX
    save's). The key order of ``tree`` is kept: it decides the bytes."""
    rs = np.random.RandomState(seed)
    new = {}

    def visit(node, path):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                visit(v, path + (k,))
                continue
            arr = np.asarray(v)
            if np.issubdtype(arr.dtype, np.floating):
                sd = float(arr.std()) or 1.0
                arr = (arr + rs.normal(0.0, scale * sd, size=arr.shape)
                       ).astype(arr.dtype)
            new[path + (k,)] = arr

    def rebuild(node, path):
        return {k: rebuild(v, path + (k,)) if isinstance(v, dict)
                else new[path + (k,)] for k, v in node.items()}

    visit(tree, ())
    return rebuild(tree, ())


# -- save ----------------------------------------------------------------

def _write_unsharded(
    output_dir: str, name: str, payload: bytes, epoch: int,
    best_acc: float, keep_last_n: int,
) -> str:
    """Format v2 commit: payload first, sidecar (with the payload's
    manifest) second."""
    path = os.path.join(output_dir, name)
    with trace.span("checkpoint/write", bytes=len(payload)):
        _atomic_write(path, payload)
        _chaos_stall()
        meta = {
            "epoch": int(epoch),
            "best_acc": float(best_acc),
            "manifest": payload_manifest(payload),
        }
        _atomic_write(meta_path(output_dir, name), json.dumps(meta).encode())
        if keep_last_n > 0:
            _update_history(output_dir, name, epoch, payload, meta,
                            keep_last_n)
    return path


def _await_shard(
    output_dir: str, sname: str, epoch: int, deadline: float
) -> dict:
    """Wait until shard ``sname`` of THIS publish is durably on disk: its
    sidecar's epoch matches and the shard verifies against the sidecar's
    manifest. Returns the shard's manifest. The epoch check keeps a stale
    same-name shard of an earlier publish out of the commit; atomic
    renames mean no torn file is ever seen."""
    spath = os.path.join(output_dir, sname)
    while True:
        try:
            with open(meta_path(output_dir, sname)) as f:
                smeta = json.load(f)
            if (int(smeta.get("epoch", -2)) == int(epoch)
                    and smeta.get("manifest")):
                with open(spath, "rb") as f:
                    blob = f.read()
                verify_checkpoint_payload(blob, smeta, spath)
                return smeta["manifest"]
        except (OSError, ValueError, CheckpointCorrupt):
            pass
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"sharded checkpoint barrier timed out waiting for {sname} "
                f"(epoch {epoch}): a peer process dead, or the checkpoint "
                "directory not shared?"
            )
        time.sleep(_SHARD_BARRIER_POLL_S)


def _write_sharded(
    output_dir: str, name: str, payload: bytes, epoch: int,
    best_acc: float, keep_last_n: int, num_shards: int,
    shard_index: Optional[int],
) -> Optional[str]:
    """Format v3 commit: every process writes its own byte-range shard and
    shard sidecar (and their history copies); rank 0 waits for the full
    set and then publishes the commit marker last. ``shard_index`` None:
    this process writes every shard. Returns the path on the committing
    process, None on the others."""
    n = int(num_shards)
    chunk = max(1, -(-len(payload) // n))
    names = [shard_name(name, k, n) for k in range(n)]
    hname = _history_name(name, epoch) if keep_last_n > 0 else None
    mine = range(n) if shard_index is None else (int(shard_index),)
    for k in mine:
        blob = payload[k * chunk:(k + 1) * chunk]
        smeta = json.dumps(
            {"epoch": int(epoch), "manifest": payload_manifest(blob)}
        ).encode()
        _atomic_write(os.path.join(output_dir, names[k]), blob)
        _chaos_stall()
        _atomic_write(meta_path(output_dir, names[k]), smeta)
        if hname is not None:
            hs = shard_name(hname, k, n)
            _atomic_write(os.path.join(output_dir, hs), blob)
            _atomic_write(meta_path(output_dir, hs), smeta)
    if shard_index not in (None, 0):
        return None  # this shard is down; rank 0 owns the commit marker
    deadline = time.monotonic() + _SHARD_BARRIER_TIMEOUT_S
    manifests = []
    for k in range(n):
        manifests.append(_await_shard(output_dir, names[k], epoch, deadline))
        if hname is not None:
            _await_shard(output_dir, shard_name(hname, k, n), epoch,
                         deadline)
    meta = {
        "format": SHARDED_FORMAT,
        "epoch": int(epoch),
        "best_acc": float(best_acc),
        "total": payload_manifest(payload),
        "shards": [
            {"name": nm, "crc32": mf["crc32"], "size": mf["size"]}
            for nm, mf in zip(names, manifests)
        ],
    }
    _chaos_stall()
    _atomic_write(meta_path(output_dir, name), json.dumps(meta).encode())
    if hname is not None:
        hmeta = dict(meta)
        hmeta["shards"] = [
            {"name": shard_name(hname, k, n), "crc32": mf["crc32"],
             "size": mf["size"]}
            for k, mf in enumerate(manifests)
        ]
        _atomic_write(meta_path(output_dir, hname),
                      json.dumps(hmeta).encode())
        _prune_history(output_dir, name, keep_last_n)
    return os.path.join(output_dir, name)


def _commit_host_tree(
    output_dir: str, name: str, tree: dict, epoch: int, best_acc: float,
    keep_last_n: int, registry, t0: float, num_shards: int = 1,
    shard_index: Optional[int] = None,
) -> Optional[str]:
    """Codec + CRC + durable publish of a host tree (numpy only): the half
    of a save that runs on the writer thread, or inline."""
    payload = to_bytes(tree)
    if num_shards > 1:
        with trace.span("checkpoint/write", bytes=len(payload),
                        shards=num_shards):
            path = _write_sharded(output_dir, name, payload, epoch,
                                  best_acc, keep_last_n, num_shards,
                                  shard_index)
    else:
        path = _write_unsharded(output_dir, name, payload, epoch, best_acc,
                                keep_last_n)
    if registry is not None and shard_index in (None, 0):
        registry.counter("checkpoint.saves").inc()
        registry.counter("checkpoint.saved_bytes").inc(len(payload))
        registry.histogram("checkpoint.save_ms").observe(
            (time.perf_counter() - t0) * 1e3
        )
    return path


def save_checkpoint(
    output_dir: str,
    state,
    epoch: int,
    best_acc: float,
    name: str = CKPT_NAME,
    keep_last_n: int = 0,
    registry=None,
    writer: Optional[AsyncCheckpointWriter] = None,
    num_shards: Optional[int] = None,
    on_commit: Optional[Callable[[], None]] = None,
) -> Optional[str]:
    """Write ``state`` (a ``TrainState``, or a :class:`StateSnapshot` taken
    earlier) to ``output_dir``; returns the checkpoint's path on the
    committing process (rank 0), None on the others.

    One process writes format v2. Under several processes every rank
    takes part in a format v3 publish: it writes its own byte range and
    rank 0 the commit marker, last. ``num_shards > 1`` asks one process
    for a v3 layout (every shard written by it); under several processes
    it must equal the process count. A v3 save of several processes
    commits inline even when given a ``writer``: each rank's writer
    would supersede queued saves by its own timing, and the ranks could
    then publish different epochs and starve rank 0's barrier.

    On the calling thread: the snapshot (if ``state`` is not one) and its
    one device-to-host copy, the only wait for the device. With a
    ``writer`` the codec, CRC and commit run on its thread, else inline.
    ``registry`` records ``checkpoint.save_stall_ms`` (the calling
    thread's time) and, when the commit lands, ``checkpoint.saves``,
    ``saved_bytes`` and ``save_ms``. ``on_commit`` runs once after a
    successful commit (never for a failed or superseded one).
    """
    from pytorch_cifar_tpu_torch.compat import (
        StateSnapshot,
        snapshot_state,
        train_tree_from_snapshot,
    )
    from pytorch_cifar_tpu_torch.parallel.mesh import rank, world_size

    pidx, pcount = rank(), world_size()
    n = int(num_shards) if num_shards else (pcount if pcount > 1 else 1)
    if pcount > 1 and n > 1 and n != pcount:
        raise ValueError(
            f"num_shards={n} must equal the process count ({pcount}): "
            "each process writes exactly its own shard"
        )
    if n <= 1 and pidx != 0:
        return None
    shard_index = pidx if (pcount > 1 and n > 1) else None
    if writer is not None and shard_index is not None:
        log.warning(
            "async checkpoint writer ignored for the multi-process sharded "
            "save of %s: per-process supersede decisions would desync the "
            "shard barrier; committing inline", name,
        )
        writer = None
    t0 = time.perf_counter()
    with trace.span("checkpoint/save", file=name, epoch=int(epoch), shards=n):
        os.makedirs(output_dir, exist_ok=True)
        snap = state if isinstance(state, StateSnapshot) \
            else snapshot_state(state)
        with trace.span("checkpoint/device_get"):
            tree = train_tree_from_snapshot(snap)
        # fault hook (inert unless armed): the published checkpoint is
        # plausible but wrong: finite weights, a valid manifest, wrong
        # outputs, the failure only output-level vetting catches
        regress = faults.ckpt_regress_scale()
        if regress:
            log.warning("ckpt_regress fault armed: perturbing %s params "
                        "(scale %.2f) before publish", name, regress)
            tree["params"] = _regress_params(tree["params"], regress)

        def commit():
            r = _commit_host_tree(output_dir, name, tree, epoch, best_acc,
                                  keep_last_n, registry, t0, n, shard_index)
            if on_commit is not None:
                on_commit()
            return r

        if writer is None:
            commit()
        else:
            writer.submit(commit, key=name)
    if registry is not None:
        registry.histogram("checkpoint.save_stall_ms").observe(
            (time.perf_counter() - t0) * 1e3
        )
    return os.path.join(output_dir, name) if shard_index in (None, 0) \
        else None


def newest_checkpoint_order(output_dir: str):
    """Preference for training resume: whichever of last / ckpt has the
    newer epoch in its sidecar, a tie to ``last`` (it holds the exact
    latest optimizer state). An unreadable sidecar counts as epoch -1."""

    def epoch_of(name):
        try:
            with open(meta_path(output_dir, name)) as f:
                return int(json.load(f).get("epoch", -1))
        except (OSError, ValueError):
            return -1

    if epoch_of(LAST_NAME) >= epoch_of(CKPT_NAME):
        return [LAST_NAME, CKPT_NAME]
    return [CKPT_NAME, LAST_NAME]


def best_checkpoint_order(output_dir: str = None):
    """Preference when the caller wants the best params (``--evaluate``,
    serving): the best-accuracy ckpt first, the preemption save only as a
    fallback. ``output_dir`` is taken for symmetry with
    :func:`newest_checkpoint_order`."""
    return [CKPT_NAME, LAST_NAME]


def remove_stale_last(output_dir: str) -> None:
    """Delete the preemption save (and its history and shards) after a run
    completes: a leftover one would roll a later ``--resume`` back."""
    if not output_dir:
        return
    for name in [LAST_NAME] + history_names(output_dir, LAST_NAME):
        _remove_candidate_files(output_dir, name)


# -- restore -------------------------------------------------------------

def read_meta(output_dir: str, name: str) -> dict:
    """The sidecar of ``name``; ``{}`` when it is absent or unreadable."""
    try:
        with open(meta_path(output_dir, name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def read_verified_payload(
    output_dir: str, name: str, meta: Optional[dict] = None
) -> bytes:
    """The verified payload of candidate ``name``: reassembled from v3
    shards when the sidecar is a sharded commit marker, else read and
    checked against the manifest (v1/v2).

    FileNotFoundError means the candidate is absent (a v3 set without its
    commit marker included); :class:`CheckpointCorrupt` means it exists
    but is unusable (a bad payload, or a committed shard missing or
    failing its CRC)."""
    if meta is None:
        meta = read_meta(output_dir, name)
    path = os.path.join(output_dir, name)
    shards = (meta or {}).get("shards")
    if shards:
        parts = []
        for s in shards:
            sp = os.path.join(output_dir, s["name"])
            try:
                with open(sp, "rb") as f:
                    blob = f.read()
            except OSError as e:
                raise CheckpointCorrupt(
                    f"{path}: committed shard {s['name']} is missing ({e})"
                ) from e
            verify_checkpoint_payload(blob, {"manifest": s}, sp)
            parts.append(blob)
        payload = b"".join(parts)
        total = meta.get("total")
        if total:
            verify_checkpoint_payload(payload, {"manifest": total}, path)
        return payload
    with open(path, "rb") as f:
        payload = f.read()
    verify_checkpoint_payload(payload, meta, path)
    return payload


def heal_checkpoint(output_dir: str, name: str = CKPT_NAME) -> Optional[str]:
    """Rewrite a damaged single-payload checkpoint ``name`` from the newest
    of its rolling-history copies that verifies (the copy its last good
    commit wrote): payload, then sidecar, each atomically, the bytes the
    commit wrote. Returns that copy's name; None when ``name`` is absent,
    sharded or intact, or no copy verifies. A restore already falls back
    to the copy; this keeps the run's best checkpoint whole for every
    later reader (the serving engine, ``ckpt_inspect``, a drill's
    comparison) instead of leaving the damaged file in front of it."""
    meta = read_meta(output_dir, name)
    if not os.path.exists(os.path.join(output_dir, name)) or meta.get(
            "shards"):
        return None
    try:
        read_verified_payload(output_dir, name, meta)
        return None
    except CheckpointCorrupt:
        pass
    for cand in history_names(output_dir, name):
        cmeta = read_meta(output_dir, cand)
        if cmeta.get("shards"):
            continue
        try:
            payload = read_verified_payload(output_dir, cand, cmeta)
            with open(meta_path(output_dir, cand), "rb") as f:
                sidecar = f.read()
        except (OSError, CheckpointCorrupt):
            continue
        _atomic_write(os.path.join(output_dir, name), payload)
        _atomic_write(meta_path(output_dir, name), sidecar)
        return cand
    return None


# -- reshard (elastic training) ------------------------------------------

def committed_shard_count(output_dir: str, name: str) -> Optional[int]:
    """Shard count of the current committed publish of ``name``: the
    length of the commit marker's shard list for a v3 publish, 1 for a
    monolithic v1/v2 publish, None when no committed publish exists."""
    meta = read_meta(output_dir, name)
    if not meta:
        return None
    shards = meta.get("shards")
    if shards:
        return len(shards)
    if os.path.isfile(os.path.join(output_dir, name)):
        return 1
    return None


def reshard_checkpoint(
    output_dir: str,
    name: str = CKPT_NAME,
    num_shards: int = 1,
    registry=None,
) -> str:
    """Re-cut a committed publish of ``name`` to ``num_shards`` byte-range
    shards, the elastic world-size change: a v3 save written by M
    processes becomes one laid out for N, the payload bit-identical
    (byte-range sharding is a layout property; the reassembled bytes never
    change). ``num_shards <= 1`` gives a v2 monolithic publish.

    Commit marker last, as every writer here: the new layout's files land
    first and the sidecar (which atomically replaces the old one) names
    only complete sets, so a crash at any point leaves a restorable
    checkpoint. The superseded layout's files are removed only once the
    new marker is durable. Raises FileNotFoundError when no committed
    publish of ``name`` exists, :class:`CheckpointCorrupt` when it fails
    verification (nothing is rewritten from unverified bytes). Emits the
    span ``checkpoint/reshard`` and counts ``checkpoint.reshards``."""
    meta = read_meta(output_dir, name)
    old_n = committed_shard_count(output_dir, name)
    if old_n is None:
        raise FileNotFoundError(
            f"no committed publish of {name!r} in {output_dir!r}"
        )
    n = max(int(num_shards), 1)
    payload = read_verified_payload(output_dir, name, meta)
    if old_n == n:
        return os.path.join(output_dir, name)
    epoch = int(meta.get("epoch", -1))
    best_acc = float(meta.get("best_acc", 0.0))
    with trace.span("checkpoint/reshard", file=name, shards_from=old_n,
                    shards_to=n):
        if n > 1:
            _write_sharded(output_dir, name, payload, epoch, best_acc,
                           keep_last_n=0, num_shards=n, shard_index=None)
        else:
            _write_unsharded(output_dir, name, payload, epoch, best_acc,
                             keep_last_n=0)
    # the new marker is durable; retire the superseded layout. v3 to
    # another N: the old -of-M names never collide with -of-N ones, so
    # this is cleanup. v2 to v3: the monolithic payload goes too (the new
    # sidecar lists shards; no reader opens it again)
    stale = [s["name"] for s in (meta.get("shards") or ())]
    for sn in stale:
        for p in (os.path.join(output_dir, sn), meta_path(output_dir, sn)):
            try:
                os.remove(p)
            except OSError:
                pass
    if old_n == 1 and n > 1:
        try:
            os.remove(os.path.join(output_dir, name))
        except OSError:
            pass
    if registry is not None:
        registry.counter("checkpoint.reshards").inc()
    log.info("resharded %s/%s: %d -> %d shard(s), payload bit-identical",
             output_dir, name, old_n, n)
    return os.path.join(output_dir, name)


def reshard_to_world(output_dir: str, registry=None) -> None:
    """Re-cut every committed checkpoint the resume may read (best and
    preemption save) to this world's layout: one shard per process under
    several processes, v2 in one. The elastic resume calls it on every
    rank after the restore, which already accepted the old world's layout;
    rank 0 alone rewrites (the others hold the broadcast state and never
    re-read the files). A corrupt candidate is skipped with a warning:
    falling back past it is the restore's business."""
    from pytorch_cifar_tpu_torch.parallel.mesh import rank, world_size

    if rank() != 0:
        return
    world = world_size()
    n = world if world > 1 else 1
    for name in (CKPT_NAME, LAST_NAME):
        old = committed_shard_count(output_dir, name)
        if old is None or old == n:
            continue
        try:
            reshard_checkpoint(output_dir, name, n, registry=registry)
        except CheckpointCorrupt as e:
            log.warning("elastic reshard skipped corrupt candidate %s (%s)",
                        name, e)


def read_payload_tree(path: str, payload: bytes) -> dict:
    """The payload's tree; :class:`CheckpointCorrupt` when it does not
    decode."""
    try:
        return msgpack_restore(payload)
    except MsgpackError as e:
        raise CheckpointCorrupt(f"{path}: undeserializable payload: {e}") \
            from e


def _decode(path: str, payload: bytes, model) -> TrainArrays:
    """Decode a verified payload and check it against ``model``."""
    from pytorch_cifar_tpu_torch.compat import train_arrays

    tree = read_payload_tree(path, payload)
    try:
        return train_arrays(model, tree)
    except (KeyError, ValueError) as e:
        raise CheckpointCorrupt(f"{path}: not this model's train state: "
                                f"{e}") from e


def _read_verified(
    output_dir: str, name: str, model
) -> Tuple[bytes, TrainArrays, int, float]:
    """Read + verify + decode + check one candidate against ``model``:
    its payload, arrays, epoch and best accuracy."""
    meta = read_meta(output_dir, name)
    path = os.path.join(output_dir, name)
    payload = read_verified_payload(output_dir, name, meta)
    return (payload, _decode(path, payload, model),
            int(meta.get("epoch", -1)), float(meta.get("best_acc", 0.0)))


def restore_checkpoint(
    output_dir: str,
    state,
    name: str = CKPT_NAME,
    names: Optional[Sequence[str]] = None,
    registry=None,
) -> Tuple[Any, int, float]:
    """Load ``output_dir``'s checkpoint into ``state`` in place, on its
    device.

    ``names`` (e.g. :func:`newest_checkpoint_order`) gives the candidate
    preference; each candidate is followed by its rolling history, and any
    corruption falls back to the next with a warning. Raises
    FileNotFoundError only when no candidate is usable. Returns ``(state,
    start_epoch, best_acc)``, ``start_epoch`` being the saved epoch + 1.

    Under several processes rank 0 walks the candidates and decides, then
    broadcasts the verdict with the epoch and best accuracy, and the
    payload's bytes; every rank decodes those same bytes, so no rank can
    restore another candidate or raise where the others proceed. Any
    save's world restores into any other (the payload is the whole
    state).
    """
    from pytorch_cifar_tpu_torch.compat import apply_train_arrays
    from pytorch_cifar_tpu_torch.parallel.mesh import (
        broadcast_bytes,
        rank,
        world_size,
    )

    t0 = time.perf_counter()
    candidates = list(names) if names is not None else [name]
    found = None  # (payload, arrays, epoch, best_acc)
    if rank() == 0:
        expanded = []
        for cand in candidates:
            expanded.append(cand)
            expanded.extend(history_names(output_dir, cand))
        for cand in expanded:
            try:
                with trace.span("checkpoint/restore", file=cand):
                    found = _read_verified(output_dir, cand, state.model)
            except FileNotFoundError:
                continue
            except CheckpointCorrupt as e:
                log.warning("checkpoint candidate %s is corrupt (%s); "
                            "falling back", cand, e)
                if registry is not None:
                    registry.counter("checkpoint.corrupt_candidates").inc()
                trace.instant("checkpoint/corrupt_candidate", file=cand)
                continue
            if cand != expanded[0]:
                log.warning(
                    "restored fallback checkpoint %s (epoch %d) — the "
                    "preferred candidate was missing or corrupt", cand,
                    found[2],
                )
                if registry is not None:
                    registry.counter("checkpoint.fallbacks").inc()
            break
    if world_size() > 1:
        head = None if found is None else [found[2], found[3]]
        head = json.loads(broadcast_bytes(json.dumps(head).encode()))
        if head is not None:
            payload = broadcast_bytes(found[0] if found else None)
            if found is None:
                arrays = _decode(f"{output_dir} (rank 0's payload)",
                                 payload, state.model)
                found = (payload, arrays, *head)
    if found is None:
        raise FileNotFoundError(
            f"no usable checkpoint in {output_dir!r} (tried {candidates} and "
            "their history) — run without --resume first"
        )
    _, arrays, epoch, best_acc = found
    apply_train_arrays(state, arrays)
    if registry is not None:
        registry.counter("checkpoint.restores").inc()
        registry.histogram("checkpoint.restore_ms").observe(
            (time.perf_counter() - t0) * 1e3
        )
    return state, epoch + 1, best_acc
