"""Fault injection: the registry behind the chaos harness (the port's copy
of ``pytorch_cifar_tpu/faults.py``; ROBUSTNESS.md describes the drills).

The variable name and its grammar are the JAX package's, so one chaos
harness arms either package. Production code never *behaves* differently
because this module exists — each injection point is a read of an inert
registry that tests and a chaos harness arm on purpose. Injection points:

- ``nan_loss`` (value = global step index): the train step poisons the
  loss used for gradients at exactly that step (``train/steps.py``),
  exercising the divergence sentinel's skip/rollback policies.
- ``ckpt_write_stall`` (value = milliseconds): the checkpoint writer
  sleeps between a payload or shard and its sidecar or commit marker.
- ``serve_error`` (optional ``times`` budget): ``InferenceEngine.predict``
  raises before dispatch, exercising the micro-batcher's
  fail-this-batch-only error containment.
- :func:`truncate_file` / :func:`bitflip_file`: deterministic checkpoint
  corruption for the manifest-verified fallback restore path
  (``train/checkpoint.py``).
- ``ckpt_regress`` (value = perturbation scale in PERCENT): the
  checkpoint save path perturbs the snapshot's params before publishing,
  so the committed file is *plausible but wrong* — finite weights, VALID
  manifest, wrong logits. CRC catches torn/bitflipped files; only the
  canary pipeline's output-level vetting catches this one.
  :func:`regress_checkpoint` is the offline equivalent for an
  already-published file (``nan=True`` poisons instead of perturbing).
- :func:`slow_loris` / :func:`conn_flood`: live network attackers for
  the edge chaos drill — a one-byte-per-interval request trickle and a
  hold-open connection flood, the two resource-exhaustion shapes an
  event-loop edge's read deadlines exist to bound.

Arming works two ways:

- programmatic (in-process tests): ``faults.inject("nan_loss", 3)``,
  cleaned up with ``faults.clear()``;
- the ``PCT_FAULTS`` environment variable (subprocess chaos runs):
  ``PCT_FAULTS="nan_loss=3"`` or ``PCT_FAULTS="serve_error;nan_loss=7"``
  — parsed once at first use, so a chaos harness can arm a child
  training or serving process without touching its CLI surface.

Stdlib-only on purpose: importing it touches no device.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

ENV_VAR = "PCT_FAULTS"

_lock = threading.Lock()
_active: Dict[str, Dict[str, Any]] = {}
_env_loaded = False


def _parse_value(raw: str) -> Any:
    try:
        return int(raw)
    except ValueError:
        return raw


def _load_env_locked() -> None:
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get(ENV_VAR, "").strip()
    if not spec:
        return
    for part in spec.replace(",", ";").split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, raw = part.partition("=")
        entry: Dict[str, Any] = {"value": True, "times": None}
        if raw:
            entry["value"] = _parse_value(raw)
        _active.setdefault(name.strip(), entry)


def inject(name: str, value: Any = True, times: Optional[int] = None) -> None:
    """Arm fault ``name``. ``times`` bounds how many triggers fire
    (None = until cleared) — only consumed by :func:`maybe_raise`."""
    with _lock:
        _load_env_locked()
        _active[name] = {"value": value, "times": times}


def clear(name: Optional[str] = None) -> None:
    """Disarm one fault (or all). Also forgets the env arming, so a test
    that calls ``clear()`` fully resets the registry."""
    global _env_loaded
    with _lock:
        _env_loaded = True  # do not resurrect env faults after a clear
        if name is None:
            _active.clear()
        else:
            _active.pop(name, None)


def get(name: str, default: Any = None) -> Any:
    """The armed value of ``name`` (or ``default`` when inert)."""
    with _lock:
        _load_env_locked()
        entry = _active.get(name)
        return default if entry is None else entry["value"]


def is_active(name: str) -> bool:
    return get(name) is not None and get(name) is not False


def nan_loss_step() -> Optional[int]:
    """Global step index at which the train step should poison the loss
    (a negative one: every step), or None when inert. Read once when
    ``make_train_step`` builds the step — arm BEFORE constructing the
    Trainer/step."""
    v = get("nan_loss")
    if v is None or v is False:
        return None
    return int(v) if v is not True else 0


def ckpt_regress_scale() -> Optional[float]:
    """Perturbation scale of the armed ``ckpt_regress`` fault, or None
    when inert. Armed values are PERCENT (``PCT_FAULTS`` carries ints):
    ``ckpt_regress=100`` perturbs each float param leaf by ~1.0 of its
    own std; a bare ``ckpt_regress`` means 100. Read by
    ``save_checkpoint`` right after the snapshot's host copy."""
    v = get("ckpt_regress")
    if v is None or v is False:
        return None
    return 1.0 if v is True else float(v) / 100.0


def maybe_raise(name: str, exc: type = RuntimeError) -> None:
    """Raise ``exc`` if fault ``name`` is armed, consuming one unit of its
    ``times`` budget (a budget of 1 gives exactly one failure)."""
    with _lock:
        _load_env_locked()
        entry = _active.get(name)
        if entry is None:
            return
        if entry["times"] is not None:
            if entry["times"] <= 0:
                return
            entry["times"] -= 1
            if entry["times"] == 0:
                _active.pop(name, None)
    raise exc(f"injected fault: {name}")


# -- checkpoint corruption helpers (chaos harness + tests) ---------------


def truncate_file(path: str, keep_fraction: float = 0.5) -> int:
    """Truncate ``path`` to ``keep_fraction`` of its size — the torn-write
    shape a host crash mid-write leaves behind. Returns the new size."""
    size = os.path.getsize(path)
    keep = max(0, int(size * keep_fraction))
    with open(path, "rb+") as f:
        f.truncate(keep)
    return keep


def regress_checkpoint(
    ckpt_dir: str,
    name: str = "ckpt.msgpack",
    scale: float = 1.0,
    seed: int = 0,
    nan: bool = False,
) -> str:
    """Rewrite checkpoint ``name`` in place as a PLAUSIBLE-BUT-WRONG
    publish: every float param leaf perturbed by N(0, scale*std) noise
    (or NaN-poisoned with ``nan=True``), and the sidecar manifest
    RECOMPUTED so integrity verification still passes — the checkpoint
    restores and serves cleanly, its outputs are just wrong.
    :func:`bitflip_file` without the manifest fix covers the CRC-visible
    class instead. Single-payload (v2) checkpoints only. The leaves are
    drawn in the payload's key order, so the bytes equal the JAX
    package's ``regress_checkpoint`` of the same file.

    Reads and writes through the port's own codec and checkpoint module,
    imported here so this module stays stdlib-only."""
    import json

    import numpy as np

    from pytorch_cifar_tpu_torch.serialization import (
        msgpack_restore,
        to_bytes,
    )
    from pytorch_cifar_tpu_torch.train.checkpoint import (
        _atomic_write,
        meta_path,
        payload_manifest,
    )

    path = os.path.join(ckpt_dir, name)
    mpath = meta_path(ckpt_dir, name)
    with open(mpath) as f:
        meta = json.load(f)
    if meta.get("shards"):
        raise ValueError(
            f"{path}: regress_checkpoint supports single-payload (v2) "
            "checkpoints only"
        )
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    rs = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        arr = np.asarray(node)
        if not np.issubdtype(arr.dtype, np.floating):
            return node
        out = arr.copy()
        if nan:
            out.reshape(-1)[0] = np.nan  # propagates through every layer
            return out
        sd = float(arr.std()) or 1.0
        return (arr + rs.normal(0.0, scale * sd, size=arr.shape)).astype(
            arr.dtype
        )

    tree["params"] = walk(tree["params"])
    payload = to_bytes(tree)
    _atomic_write(path, payload)
    meta["manifest"] = payload_manifest(payload)
    _atomic_write(mpath, json.dumps(meta).encode())
    return path


def bitflip_file(path: str, offset: Optional[int] = None) -> int:
    """Flip one bit in ``path`` (middle byte by default) — silent media
    corruption that only a checksum can catch (the file stays the same
    size and often still parses). Returns the flipped offset."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot bitflip empty file {path!r}")
    off = size // 2 if offset is None else offset
    with open(path, "rb+") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x40]))
    return off


def slow_loris(
    host: str,
    port: int,
    *,
    duration_s: float = 5.0,
    interval_s: float = 0.5,
    connect_timeout_s: float = 5.0,
) -> Dict[str, int]:
    """A slow-loris attacker against one HTTP edge: open a connection,
    trickle ONE header byte per ``interval_s``, and never finish the
    request. Against a per-connection-thread frontend this parks a
    handler thread for the socket timeout; against an event-loop edge
    the per-connection read deadline must close it long before
    ``duration_s`` elapses. Returns
    ``{"sent": bytes trickled, "closed_by_server": 0/1}`` — the chaos
    drill asserts ``closed_by_server == 1`` and the drill's foreground
    traffic unaffected."""
    import socket
    import time

    head = b"POST /predict HTTP/1.1\r\nContent-Length: 10\r\nX-Slow: "
    sent = 0
    closed = 0
    sock = socket.create_connection((host, port), timeout=connect_timeout_s)
    try:
        sock.settimeout(interval_s)
        deadline = time.monotonic() + duration_s
        while time.monotonic() < deadline:
            try:
                sock.sendall(head[sent % len(head):][:1])
                sent += 1
            except OSError:
                closed = 1  # server reset us mid-trickle: the deadline
                break
            # a server-side close surfaces as EOF on the read side well
            # before the send buffer notices
            try:
                if sock.recv(256) == b"":
                    closed = 1
                    break
            except socket.timeout:
                pass
            except OSError:
                closed = 1
                break
    finally:
        sock.close()
    return {"sent": sent, "closed_by_server": closed}


def conn_flood(
    host: str,
    port: int,
    *,
    connections: int = 256,
    hold_s: float = 1.0,
    connect_timeout_s: float = 5.0,
) -> Dict[str, int]:
    """A connection flood against one HTTP edge: open ``connections``
    sockets as fast as the listener accepts them, send NOTHING, hold
    them ``hold_s``, then close. A thread-per-connection frontend burns
    a thread per socket; the event-loop edge absorbs the whole flood on
    one loop thread (an idle registered socket costs one fd and one
    dict entry — deliberately NOT a loris deadline, since idle
    keep-alive between requests is the legitimate client shape) and
    reaps each on the attacker's close, with foreground traffic
    undisturbed throughout. Returns ``{"opened": n, "refused": n}``."""
    import socket
    import time

    socks = []
    refused = 0
    try:
        for _ in range(connections):
            try:
                socks.append(
                    socket.create_connection(
                        (host, port), timeout=connect_timeout_s
                    )
                )
            except OSError:
                refused += 1
        time.sleep(hold_s)
    finally:
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
    return {"opened": len(socks), "refused": refused}
