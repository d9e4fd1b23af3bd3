"""The cold-start cache of the port: prepared weight sets on disk.

The port's counterpart of ``pytorch_cifar_tpu/serve/aot_cache.py``. The
JAX package caches each bucket's compiled XLA program; torch has no
program to serialize, and cuDNN's plans and a CUDA graph die with their
process. What a later process CAN reload bit for bit is the weight set the
engine prepares from a checkpoint: the folded tree in the compute dtype,
or the int8 lane's ``{"q", "s"}`` encoding, every tensor at its strides.
Preparing it (reading and checking the checkpoint, decoding it, building
the model, loading, folding, quantizing) is the work a cache hit skips
(PERF.md §5 has the split measured on the card).

Layout of a cache directory (``InferenceEngine(aot_cache_dir=)``):

- ``<model>_b<bucket>_<digest16>.aotx`` plus its JSON sidecar
  ``{"manifest", "key", "poisoned"}``, one per (weight set, bucket), as
  the JAX package names its entries (the same :func:`fingerprint` and
  :func:`entry_name` over the same kind of key fields). The payload holds
  the bucket's probe logits: the exporter's forward of the probe batch
  (``RandomState(1234 + bucket)``) on the served weights, which every
  import must reproduce bit for bit before the bucket serves.
- ``weights/<model>_<digest16>.aotx`` plus its sidecar: the weight set
  itself, keyed by the same fields without the bucket, shared by its
  buckets. It sits in a subdirectory, so the JAX package's
  ``tools/ckpt_inspect.py`` (which reads ``*.aotx.json`` at the top level,
  and takes any other ``*.json`` there for a checkpoint sidecar) sees the
  buckets alone.

An entry is per topology and per rank, as the JAX module's: its key (the
engine's ``_cache_key_fields``) carries the device group's size, the
process count, this rank's index and its devices. A bucket's probe logits
are what THIS rank's forward returned (the whole bucket on a leader or a
one-process engine, the rank's own slab on a follower), so a replica
relaunched on another topology imports nothing of the old one, and the
ranks of one replica agree on what to import before any probe runs.

File discipline, as the JAX module's:

- The payload, then the sidecar, each through the checkpoint layer's
  :func:`~pytorch_cifar_tpu_torch.train.checkpoint._atomic_write`, with
  its :func:`payload_manifest`; a read checks the payload against it with
  :func:`verify_checkpoint_payload`. A torn or key-mismatched entry is a
  miss, never an error.
- A poisoned sidecar is a tombstone: it outlives its entry, and
  :func:`export_entry` never writes over it.
- A failed export logs and returns None; it never fails the warm-up.
- Exports into one directory hold an exclusive ``flock`` on its
  ``.lock`` file, so two replicas that miss together write one whole
  entry after the other (the checkpoint layer's ``_atomic_write`` stages
  every writer in the same ``<path>.tmp``).

The payloads are ``torch.save`` files, read with ``weights_only=False``:
pickles of the port's own classes (the folded tree's dataclasses), numpy
arrays and tensors; a cache directory is operator-local state with the trust of
a build directory, as the JAX package says of its own.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import io
import json
import logging
import os
from typing import Optional

from pytorch_cifar_tpu_torch.train.checkpoint import (
    _atomic_write,
    payload_manifest,
    verify_checkpoint_payload,
)

log = logging.getLogger(__name__)

CACHE_VERSION = 1
WEIGHTS_SUBDIR = "weights"


def _load_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def fingerprint(key_fields: dict) -> str:
    """Deterministic digest over the identity fields (the JAX package's
    function: the same fields give the same digest)."""
    blob = json.dumps(key_fields, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def entry_name(model_name: str, bucket: int, digest: str) -> str:
    # model + bucket stay readable in the filename; the digest carries the
    # whole identity
    safe = "".join(c if c.isalnum() else "-" for c in model_name)
    return f"{safe}_b{int(bucket)}_{digest[:16]}.aotx"


def weights_name(model_name: str, digest: str) -> str:
    """The weight set's entry, ``weights/<model>_<digest16>.aotx``."""
    safe = "".join(c if c.isalnum() else "-" for c in model_name)
    return os.path.join(WEIGHTS_SUBDIR, f"{safe}_{digest[:16]}.aotx")


def entry_paths(cache_dir: str, name: str):
    path = os.path.join(cache_dir, name)
    return path, path + ".json"


@contextlib.contextmanager
def _export_lock(cache_dir: str):
    with open(os.path.join(cache_dir, ".lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def export_entry(
    cache_dir: str, name: str, key_fields: dict, body: dict
) -> Optional[str]:
    """Publish ``body`` (anything ``torch.save`` takes) under ``name``
    with its sidecar.
    Returns the entry's path, or None when the entry is poisoned or the
    export failed (logged: the cache is best-effort)."""
    path, meta_p = entry_paths(cache_dir, name)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        import torch

        buf = io.BytesIO()
        torch.save({"version": CACHE_VERSION, "key": key_fields, **body},
                   buf)
        payload = buf.getvalue()
        with _export_lock(cache_dir):
            existing = _load_json(meta_p)
            if existing and existing.get("poisoned"):
                # the tombstone outlives the entry: re-exporting would
                # restart the import -> refute -> poison cycle
                log.warning(
                    "cold-start cache entry %s stays poisoned — not "
                    "re-exporting", name)
                return None
            _atomic_write(path, payload)
            # sidecar LAST: a verified pair is always from one publish
            _atomic_write(meta_p, json.dumps({
                "manifest": payload_manifest(payload),
                "key": key_fields,
                "poisoned": False,
            }).encode())
    except Exception as e:
        log.warning("cold-start cache export skipped for %s: %s", name, e)
        return None
    return path


def load_entry(cache_dir: str, name: str, key_fields: dict) -> Optional[dict]:
    """Read and verify one entry. None on ANY problem (missing, poisoned,
    torn, key mismatch, undecodable): a miss, never an error."""
    path, meta_p = entry_paths(cache_dir, name)
    meta = _load_json(meta_p)
    if meta is None:
        return None
    if meta.get("poisoned"):
        log.warning(
            "cold-start cache entry %s is poisoned (a previous import was "
            "refuted by its probe) — preparing instead", name)
        return None
    try:
        with open(path, "rb") as f:
            payload = f.read()
        verify_checkpoint_payload(payload, meta, path)
        import torch

        entry = torch.load(io.BytesIO(payload), map_location="cpu",
                           weights_only=False)
    except Exception as e:
        log.warning("cold-start cache entry %s unreadable (%s) — miss",
                    name, e)
        return None
    if not isinstance(entry, dict) or entry.get("version") != CACHE_VERSION \
            or entry.get("key") != key_fields:
        return None
    return entry


def poison_entry(cache_dir: str, name: str, reason: str) -> None:
    """Mark an entry as refuted by its probe: no later import trusts it
    and no export writes over it."""
    _, meta_p = entry_paths(cache_dir, name)
    meta = _load_json(meta_p) or {}
    meta["poisoned"] = True
    meta["poison_reason"] = reason
    try:
        with _export_lock(cache_dir):
            _atomic_write(meta_p, json.dumps(meta).encode())
    except OSError as e:
        log.error("could not poison cold-start cache entry %s: %s", name, e)
        return
    log.error("cold-start cache entry %s POISONED: %s", name, reason)


# -- the weight set's encoding ---------------------------------------------


def _map_tensors(fn, tree):
    """``fn`` over every tensor of a folded tree (both of an int8 pair)."""
    import torch

    from pytorch_cifar_tpu_torch.serve.engine import _tree_map

    def leaf(x):
        if isinstance(x, dict):  # the int8 lane's {"q", "s"} pair
            return {k: fn(v) for k, v in x.items()}
        return fn(x) if isinstance(x, torch.Tensor) else x

    return _tree_map(leaf, tree)


def encode_weights(tree) -> dict:
    """A folded tree as a body for :func:`export_entry`: the same tree,
    every tensor copied to host memory at its own strides."""
    return {"tree": _map_tensors(lambda t: t.detach().cpu(), tree)}


def deserialize_entry(entry: dict, device):
    """The weight set of a verified entry on ``device``, each tensor at its
    recorded strides (the counterpart of the JAX module's
    ``deserialize_entry``; may raise, which the caller treats as a
    miss)."""
    return _map_tensors(lambda t: t.to(device), entry["tree"])
