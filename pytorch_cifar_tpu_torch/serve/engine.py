"""Inference engine of the port: shape-bucketed eval forwards + hot swap.

Counterpart of ``pytorch_cifar_tpu/serve/engine.py`` (single device):

- **Buckets.** ``predict`` pads every request up to the nearest configured
  batch size (chunking past the largest), so the set of shapes the device
  ever sees is fixed. ``warmup`` runs each bucket once — building the CUDA
  kernels and letting cuDNN pick its algorithms — and counts it in
  ``compile_count``, which ``predict`` never moves. (CUDA graphs per bucket,
  the true "compile once", come later.)
- **Padding must not change answers.** The eval forward is per-row
  independent, so the first ``n`` rows of a padded batch equal an unpadded
  forward of the same rows (:meth:`direct_forward`) — bit for bit where the
  backend's kernels are batch-invariant, which the tests and ``--verify``
  check.
- **Weights are folded once per weight set.** Each weight set (at
  construction and at every swap) is loaded into a fresh model on the
  device and folded for the compute dtype (BN into its conv, the fused
  sites' weights to HWIO); requests only read the folded tree, so it is
  all the card keeps (the model moves to the meta device, the float
  originals stay on the host for :meth:`InferenceEngine.weights_host`).
- **The cold-start cache** (``aot_cache_dir``, :mod:`.aot_cache`): the
  prepared weight set and each bucket's probe logits, exported by the
  engine that prepared them and imported by the next, which skips the
  preparation and holds each bucket's first forward against the
  exporter's bits (:class:`InferenceEngine` says what counts as a hit).
- **Checkpoints.** :meth:`InferenceEngine.from_checkpoint` serves a
  trainer's directory (the best checkpoint first), a ``.msgpack`` payload
  (either package's; verified against its sidecar's manifest) or a
  reference ``ckpt.pth`` (:func:`load_checkpoint_trees`).
- **Swaps are atomic.** The served ``(model, folded)`` pair sits behind one
  reference; a swap validates that the new ``state_dict`` has the same keys,
  shapes and dtypes, prepares it off the lock and replaces the reference in
  one assignment. Requests already running keep the pair they captured.
- **A device group** (``num_devices=D``, JAX's mesh engine): one copy of
  the folded tree per device, every padded bucket split into D equal
  shards, each run on its own device, and the logits put back together in
  device order. Buckets follow JAX's rule (:func:`round_buckets`, a floor
  of 2·D, and a singleton bucket of D rows that serves only n = 1, so a
  lone row keeps the single engine's one-row kernels). On CUDA device
  ``i`` is ``cuda:i``; on the CPU the D shards run one after the other
  (the tests' stand-in for D cards). With ``mesh_group`` the group spans
  processes (:mod:`.mesh_replica`): each rank runs its own slab of every
  bucket and the leader gathers the logits.
- **The int8 lane** (``int8=True``): weight-only symmetric int8, one scale
  per output channel, exactly the JAX package's :func:`quantize_int8`. The
  raw ``state_dict`` is quantized, the model is folded from the quantized
  values, and each folded weight (linear heads included) is held as its
  int8 ``q`` and its scale ``s`` in the layout its site reads. Every
  forward dequantizes the tree at the compute dtype (``q * s``, as JAX's
  in-graph :func:`dequantize_int8`) and runs the same folded forward, so
  every kernel launch stays where it is; the served weights stay int8 on
  the device. Not bit-identical to the float engine: opt-in.

The default compute dtype is bf16 with fp32 logits on the wire.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import logging
import os
import threading
import time
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_cifar_tpu_torch import faults, resolve_device
from pytorch_cifar_tpu_torch.compat import (
    _host,
    normalize_state_dict,
    state_dict_from_jax,
)
from pytorch_cifar_tpu_torch.data.augment import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    normalize,
)
from pytorch_cifar_tpu_torch.data.pipeline import StagingPool
from pytorch_cifar_tpu_torch.models import create_model
from pytorch_cifar_tpu_torch.obs import trace
from pytorch_cifar_tpu_torch.train.checkpoint import (
    best_checkpoint_order,
    publish_fingerprint,
    read_meta,
    read_payload_tree,
    read_verified_payload,
)

log = logging.getLogger(__name__)

DEFAULT_BUCKETS = (1, 8, 32, 128)
IMAGE_SHAPE = (32, 32, 3)


def round_buckets(buckets: Sequence[int], multiple: int) -> Tuple[int, ...]:
    """Each bucket rounded UP to a multiple of ``multiple``, deduplicated
    (JAX's rule: every shard gets the same extent, and a request that fit
    the old largest bucket still fits without chunking)."""
    m = max(1, int(multiple))
    return tuple(sorted({-(-int(b) // m) * m for b in buckets}))


def mesh_buckets(buckets: Sequence[int], n_devices: int):
    """JAX's mesh bucket rule for ``n_devices`` > 1: ``(buckets,
    singleton)``. Buckets round up to multiples of D with a floor of 2·D (a
    shard of one row selects other kernels than a shard of two or more);
    a configured 1-bucket survives as the singleton bucket of D rows, one
    a shard, which serves only n = 1."""
    d = int(n_devices)
    rounded = round_buckets(
        [max(b, 2 * d) for b in buckets if b > 1], d) or (2 * d,)
    singleton = None
    if 1 in buckets:
        singleton = d
        rounded = tuple(sorted({d, *rounded}))
    return rounded, singleton


def shard_devices(device: "torch.device", num_devices: int,
                  first: int = 0) -> list:
    """The ``num_devices`` devices a rank's shards run on: the CPU
    ``num_devices`` times (logical shards, one after the other), or cards
    ``first, first + 1, ...`` modulo the visible count (``device``'s index
    when it names one). Raises when more cards are asked for than are
    visible."""
    d = int(num_devices)
    if d < 1:
        raise ValueError(f"num_devices must be >= 1, got {d}")
    if device.type != "cuda":
        return [device] * d
    count = torch.cuda.device_count()
    if d > count:
        raise ValueError(
            f"num_devices={d} but only {count} CUDA device(s) are visible")
    start = device.index if device.index is not None else int(first)
    return [torch.device("cuda", (start + i) % count) for i in range(d)]


class _Served(tuple):
    """The served ``(model, folded)`` pair (device 0's tree) with every
    device's copy in ``copies``: one object, so one assignment swaps every
    device's weights together."""

    def __new__(cls, model, copies):
        self = super().__new__(cls, (model, copies[0]))
        self.copies = tuple(copies)
        return self


def _is_qleaf(leaf) -> bool:
    """A quantized weight: the ``{"q": int8, "s": scale}`` pair
    :func:`quantize_int8` produces (no folded tree of the zoo has a dict
    with exactly these keys, so the key set is an unambiguous tag)."""
    return isinstance(leaf, dict) and leaf.keys() == {"q", "s"}


def quantize_int8(state_dict: Mapping) -> dict:
    """Weight-only symmetric int8 quantization of a ``state_dict``, as the
    JAX package's ``quantize_int8`` does it to its params tree.

    Every entry of ``ndim >= 2`` (conv OIHW, linear ``(out, in)``: the
    output axis is 0) becomes ``{"q": int8, "s": float32}`` with one scale
    per OUTPUT channel, ``s = max|w| / 127`` over every other axis (1
    where that is 0), kept with size-1 axes. Vectors (biases, BN
    parameters and running stats) stay float, as numpy. The same weights
    give JAX's ``q`` and ``s`` bit for bit: the arithmetic is the same
    numpy float32 arithmetic over the same values per channel."""

    def q(v):
        v = _host(v)
        if v.ndim < 2:
            return v
        axes = tuple(range(1, v.ndim))
        s = (
            np.max(np.abs(v), axis=axes, keepdims=True).astype(np.float32)
            / np.float32(127.0)
        )
        s = np.where(s == 0, np.float32(1.0), s).astype(np.float32)
        return {
            "q": np.clip(np.rint(v / s), -127, 127).astype(np.int8),
            "s": s,
        }

    return {k: q(v) for k, v in state_dict.items()}


@functools.lru_cache(maxsize=None)
def _init_fields(cls) -> Optional[tuple]:
    """The field names a dataclass's ``__init__`` takes, in order; None for
    any other class."""
    if not dataclasses.is_dataclass(cls):
        return None
    return tuple(f.name for f in dataclasses.fields(cls) if f.init)


def _tree_map(fn, tree):
    """``fn`` over the leaves of a folded tree (dicts, lists, tuples and
    dataclasses such as ``FoldedConvBN``; a ``{"q", "s"}`` pair is one
    leaf), in a fixed order. It runs on every forward of an int8 engine,
    so it dispatches on the exact type and builds a dataclass from its
    cached field names."""
    kind = type(tree)
    if kind is dict:
        if tree.keys() == {"q", "s"}:
            return fn(tree)
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if kind is list:
        return [_tree_map(fn, v) for v in tree]
    if kind is tuple:
        return tuple([_tree_map(fn, v) for v in tree])
    names = _init_fields(kind)
    if names is not None:
        return kind(*[_tree_map(fn, getattr(tree, n)) for n in names])
    return fn(tree)


def dequantize_int8(folded, dtype: torch.dtype):
    """The inverse of the int8 lane's encoding at the compute dtype: every
    ``{"q", "s"}`` leaf becomes ``q * s`` in ``dtype`` (``s`` is held in
    ``dtype`` already: JAX casts both factors, then multiplies), laid out
    as ``q`` is; every other leaf is passed through. Runs on every forward
    of an int8 engine."""

    def deq(leaf):
        if not _is_qleaf(leaf):
            return leaf
        out = torch.empty_like(leaf["q"], dtype=dtype)
        return torch.mul(leaf["q"], leaf["s"], out=out)

    return _tree_map(deq, folded)


_ID0 = 1024  # channel ids start above every |q| <= 127


@functools.lru_cache(maxsize=64)
def _int8_plan(model_name: str, num_classes: int) -> tuple:
    """Where each quantized weight lands in ``model_name``'s folded tree.

    The fold only lays weights out (permutes, casts, concatenates along
    the output channels); it never mixes two weights' values. So the model
    is folded twice on the CPU from weights replaced by their global
    output-channel ids (``+id`` and ``-id``, constant over the other
    axes): a folded leaf equal in both folds holds no weight; one that
    flips sign holds weights, and its ids, reduced to one per output
    channel in the leaf's own layout, index the scales. Returns the
    quantized keys (``state_dict`` order) and the plan: for each tensor
    leaf in walk order, None or those ids (int64, size-1 axes kept)."""
    from pytorch_cifar_tpu_torch.models import create_model

    sd = create_model(model_name, num_classes=num_classes).state_dict()
    keys = tuple(k for k, v in sd.items() if v.ndim >= 2)
    leaves = ([], [])

    def collect(out):
        def fn(leaf):
            if isinstance(leaf, torch.Tensor):
                out.append(leaf)
            return leaf
        return fn

    for sign, out in zip((1.0, -1.0), leaves):
        subst, base = dict(sd), _ID0
        for k in keys:
            shape = sd[k].shape
            ids = torch.arange(base, base + shape[0], dtype=torch.float64)
            subst[k] = (sign * ids).view(-1, *(1,) * (len(shape) - 1)) \
                .expand(shape).float().contiguous()
            base += shape[0]
        if base >= 1 << 24:  # float32 holds the ids exactly below 2**24
            raise ValueError(f"{model_name}: too many output channels")
        model = create_model(model_name, num_classes=num_classes)
        model.load_state_dict(subst, strict=True)
        _tree_map(collect(out), model.eval().fold(torch.float32))
    plan = []
    for a, b in zip(*leaves):
        if torch.equal(a, b):
            plan.append(None)
            continue
        if not torch.equal(a, -b) or a.ndim < 1:
            raise ValueError(
                f"{model_name}: a folded leaf of shape {tuple(a.shape)} "
                "mixes weights with other values; the int8 lane cannot "
                "carry it")
        ids = a
        for ax in range(a.ndim):
            if a.shape[ax] > 1 and torch.equal(
                    a.amax(dim=ax, keepdim=True).expand_as(a), a):
                ids = ids.amax(dim=ax, keepdim=True)
        if not torch.equal(ids.expand_as(a), a):
            raise ValueError(
                f"{model_name}: a folded weight of shape {tuple(a.shape)} "
                "does not keep its output channels on one axis")
        plan.append(ids.long() - _ID0)
    return keys, tuple(plan)


def resolve_checkpoint(ckpt: str) -> str:
    """The file :func:`load_checkpoint_trees` reads for ``ckpt``: a
    trainer's directory resolves to the first candidate of the best order
    that exists (a v3 commit marker counts), as the JAX engine picks it;
    a file is itself. Raises FileNotFoundError when a directory holds
    none."""
    if not os.path.isdir(ckpt):
        return ckpt
    for name in best_checkpoint_order(ckpt):
        p = os.path.join(ckpt, name)
        if os.path.isfile(p) or "shards" in read_meta(ckpt, name):
            return p
    raise FileNotFoundError(
        f"no checkpoint in {ckpt!r} (looked for "
        f"{best_checkpoint_order(ckpt)})"
    )


@contextlib.contextmanager
def _timed(stages: Optional[dict], name: str, device=None):
    """Add the wall ms of the block to ``stages[name]`` (a no-op when
    ``stages`` is None); on a CUDA ``device`` the block's queued work is
    waited for, so its device time lands in its own stage."""
    if stages is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


def _read_msgpack_payload(path: str, meta: dict,
                          stages: Optional[dict] = None) -> bytes:
    """A ``.msgpack`` candidate's payload, verified against the sidecar
    ``meta`` it was resolved with (v3 reassembled from its committed
    shards): a payload replaced since fails the check."""
    dirpath, name = os.path.dirname(path) or ".", os.path.basename(path)
    with _timed(stages, "checkpoint_read_ms"):
        return read_verified_payload(dirpath, name, meta)


def _decode_msgpack_state(path: str, payload: bytes, model_name: str,
                          num_classes: int, stages: Optional[dict] = None):
    """The port's ``state_dict`` of a verified ``.msgpack`` payload."""
    with _timed(stages, "decode_ms"):
        tree = read_payload_tree(path, payload)
        return state_dict_from_jax(
            model_name, tree["params"], tree.get("batch_stats", {}),
            num_classes=num_classes,
        )


def load_checkpoint_trees(
    ckpt: str, model_name: str, num_classes: int = 10,
    stages: Optional[dict] = None,
) -> Tuple[dict, dict]:
    """Serving weights from any checkpoint the port understands, as the
    port's ``state_dict`` (numpy) and the checkpoint's ``meta`` (the
    sidecar's ``epoch``/``best_acc``, or the reference envelope's
    ``epoch``/``acc``). ``ckpt`` may be:

    - a trainer's directory (:func:`resolve_checkpoint`);
    - a ``.msgpack`` payload, verified against its sidecar's manifest
      (v3 reassembled from its committed shards) and mapped through
      ``compat.state_dict_from_jax``;
    - a reference ``ckpt.pth`` (``{'net': sd, 'acc', 'epoch'}``, or a bare
      ``state_dict``), read with ``weights_only=True``; ``module.``
      prefixes are stripped and the keys are the port's own.

    ``stages``, when given, gets the read's and the decode's wall ms.
    Raises FileNotFoundError when there is nothing to load and
    ``CheckpointCorrupt`` when a payload fails verification or decoding.
    """
    path = resolve_checkpoint(ckpt)
    if path.endswith(".pth"):
        with _timed(stages, "checkpoint_read_ms"):
            obj = torch.load(path, map_location="cpu", weights_only=True)
        with _timed(stages, "decode_ms"):
            sd, meta = normalize_state_dict(obj)
            return {k: v.detach().cpu().numpy()
                    if isinstance(v, torch.Tensor) else np.asarray(v)
                    for k, v in sd.items()}, meta
    meta = read_meta(os.path.dirname(path) or ".", os.path.basename(path))
    payload = _read_msgpack_payload(path, meta, stages)
    return _decode_msgpack_state(path, payload, model_name, num_classes,
                                 stages), meta


def kernel_launches() -> dict:
    """Launch counts of the kernels a served forward can reach (every
    engine of the process adds to them)."""
    from pytorch_cifar_tpu_torch.ops import (
        conv_bn_relu,
        depthwise_stencil,
        max_pool,
    )

    return {
        "conv3x3_bn_relu": conv_bn_relu.LAUNCHES,
        "max_pool3x3_s1": max_pool.FWD_LAUNCHES,
        "depthwise_stencil": depthwise_stencil.LAUNCHES,
    }


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    return np.asarray(v).dtype.name


def _libcuda_version() -> Optional[int]:
    """The version of the card's ``libcuda.so.1`` (its
    ``cuDriverGetVersion``), or None where there is none."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    v = ctypes.c_int(0)
    return int(v.value) if lib.cuDriverGetVersion(ctypes.byref(v)) == 0 \
        else None


def state_digest(state_dict: Mapping) -> str:
    """SHA-256 over a ``state_dict``'s keys, shapes, dtypes and bytes: a
    weight set's identity when nothing cheaper names it."""
    h = hashlib.sha256()
    for k, v in state_dict.items():
        a = np.ascontiguousarray(_host(v))
        h.update(f"{k}:{a.shape}:{a.dtype.str};".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def probe_batch(bucket: int, image_shape=IMAGE_SHAPE) -> np.ndarray:
    """The JAX engine's probe batch of ``bucket`` images
    (``RandomState(1234 + bucket)``): every warm-up's input, and what a
    cache entry's logits were computed on."""
    rs = np.random.RandomState(1234 + int(bucket))
    return rs.randint(0, 256, size=(bucket, *image_shape)).astype(np.uint8)


class InferenceEngine:
    """Batched eval forward over fixed batch-size buckets, warmed up at
    construction.

    ``predict`` accepts uint8 NHWC images ``(n, 32, 32, 3)`` for ANY n >= 1
    and returns fp32 logits ``(n, classes)`` as numpy. Thread-safe: the
    served weights are replaced by a single assignment.

    ``state_dict`` is the weight set, or a callable ``source(stages)`` that
    returns it (recording its stages' ms in the dict it is given): a source
    runs only when the engine prepares the weights itself or when
    :meth:`weights_host` asks for the float originals, so a cache hit never
    decodes the checkpoint. ``mean``/``std`` are the normalization
    constants (CIFAR-10's by default), as the JAX engine takes them.

    ``int8=True`` serves the int8 lane (module docstring): the same
    buckets, forward and kernels over int8-resident weights, counted in
    ``serve.int8_requests``/``serve.int8_images``; :meth:`weights_host`
    still returns the float originals and a swap still takes (and
    re-quantizes) a float ``state_dict``.

    ``num_devices`` is the device group (module docstring): this process's
    shards, on ``cuda:0 ..`` (or ``device``'s index on), or logical shards
    on the CPU. ``mesh_group`` (a gloo group, :mod:`.mesh_replica`) spans
    the group over processes: ``n_devices`` is then every rank's shards,
    every bucket forward is a collective all ranks enter in the same
    order, and only the leader (rank 0) gets the whole bucket's logits
    back. :meth:`direct_forward` always runs on the first device alone.

    **The cold-start cache** (``aot_cache_dir``, :mod:`.aot_cache`). What a
    later process can reload bit for bit is the prepared weight set, so
    that is what the cache holds, keyed by the JAX engine's fields with
    torch's counterparts (:meth:`_cache_key_fields`) and the weight set's
    identity (``weights_id``: the checkpoint's publish fingerprint with the
    SHA-256 of its payload, ``from_random``'s seed, else
    :func:`state_digest`).

    - A **hit** is a bucket warmed on a verified entry: its weight set came
      from the cache and its first forward, the probe batch, reproduced the
      exporter's logits bit for bit. A hit skips measured work: the
      checkpoint's decode, the model's build and load, the fold, and for
      int8 the quantization and ``_int8_plan``; ``cold_start_stages``
      shows which ran. The checkpoint's read and CRC still run (its
      payload's digest names the weight set, and the payload stays in
      host memory for :meth:`weights_host`). A warm-up that does what a
      miss does under another name is not a hit.
    - ``compile_count`` counts the buckets warmed on weights the engine
      prepared itself (``serve.compiles``); ``aot_cache_hits`` the buckets
      warmed on a verified entry (``serve.aot_cache_hits``, where
      ``serve.compiles`` does not move); ``aot_cache_misses`` the buckets
      whose entry was absent, torn, poisoned, of another key, or dropped
      with a refuted load (``serve.aot_cache_misses``), as the JAX
      engine counts them.
    - The JAX engine's import has five phases; here: (1) the local scan
      reads and verifies every bucket's entry and the weight set's
      (:meth:`_import_cached`); (2) across processes a bucket stays a
      candidate only where every rank holds a verified entry for it
      (:meth:`_agree_flags`, a no-op in one process); (3) each candidate
      bucket's probe runs on the imported weights (a collective across
      processes) and must equal its entry's logits bit for bit, or the
      entry is poisoned; (4) one refuted probe, on any rank, drops the
      whole load on every rank, since every bucket reads the same weight
      set, and the engine prepares from the checkpoint as on a miss; (5)
      the fresh-reference check has nothing to
      guard: it stands against a deserializer that mis-executes programs,
      and the port deserializes only bytes, whose CRC the read checks and
      whose forward phase 3 has already held against the exporter's.
    - Whatever the engine warmed itself, it exports: the weight set once,
      then each bucket's probe logits. A failed export logs and never
      fails the warm-up.

    ``cold_start_s`` is the JAX engine's: the wall time of the last
    :meth:`warmup`, with the cache's import that precedes the first one
    (the JAX engine imports inside its warm-up). ``ready_s`` is the whole
    start: preparing or importing the weights and warming every bucket
    (:meth:`from_checkpoint` adds the checkpoint's read); and
    ``cold_start_stages`` splits it (ms).
    """

    def __init__(
        self,
        model_name: str,
        state_dict,
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        compute_dtype: Optional[torch.dtype] = None,
        num_classes: int = 10,
        mean: Optional[Sequence[float]] = None,
        std: Optional[Sequence[float]] = None,
        registry=None,
        device=None,
        int8: bool = False,
        aot_cache_dir: Optional[str] = None,
        weights_id=None,
        num_devices: int = 1,
        mesh_group=None,
    ):
        from pytorch_cifar_tpu_torch.parallel import mesh

        t0 = time.perf_counter()
        if not buckets:
            raise ValueError("need at least one batch-size bucket")
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        self.mesh_group = mesh_group
        self.process_count = mesh.group_size(mesh_group)
        self.process_index = mesh.group_rank(mesh_group)
        self.devices = shard_devices(
            resolve_device(device), num_devices,
            first=self.process_index * int(num_devices))
        self.device = self.devices[0]
        self.n_devices = len(self.devices) * self.process_count
        self._singleton = None
        if self.n_devices > 1:
            rounded, self._singleton = mesh_buckets(self.buckets,
                                                    self.n_devices)
            if rounded != self.buckets:
                log.info("rounded buckets %s -> %s (multiples of the "
                         "%d-device group, two rows a shard at least)",
                         self.buckets, rounded, self.n_devices)
            self.buckets = rounded
        self.model_name = model_name
        self.num_classes = num_classes
        self.image_shape = IMAGE_SHAPE
        self.compute_dtype = (
            torch.bfloat16 if compute_dtype is None else compute_dtype
        )
        self._norm_mean = tuple(
            float(v) for v in (CIFAR10_MEAN if mean is None else mean))
        self._norm_std = tuple(
            float(v) for v in (CIFAR10_STD if std is None else std))
        self._norm = {dev: (torch.tensor(self._norm_mean, device=dev),
                            torch.tensor(self._norm_std, device=dev))
                      for dev in self.devices}
        self._warm: set = set()
        self._swap_lock = threading.Lock()
        self._count_lock = threading.Lock()
        self.compile_count = 0  # buckets warmed on self-prepared weights
        self.aot_cache_hits = 0  # buckets warmed on a verified entry
        self.aot_cache_misses = 0
        self.aot_cache_dir = aot_cache_dir or None
        self.forward_count = 0  # every device forward: warmup, bucket, direct
        self.version = 0  # bumped by every swap_weights
        self.checkpoint_meta: dict = {}  # set by from_checkpoint
        self.cold_start_s = 0.0  # the last warmup() (+ the first import)
        self.ready_s = 0.0  # the whole start
        self.cold_start_stages: dict = {}  # ms of each step of the start
        self._import_s = 0.0
        self._obs = registry
        self._h_device = (
            registry.histogram("serve.device_ms")
            if registry is not None
            else None
        )
        self.int8 = bool(int8)
        self._c_int8_requests = self._c_int8_images = None
        if registry is not None and self.int8:
            self._c_int8_requests = registry.counter("serve.int8_requests")
            self._c_int8_images = registry.counter("serve.int8_images")
        self.staging = StagingPool(registry=registry)
        source = state_dict if callable(state_dict) else None
        sd = None if source is not None else state_dict
        if self.aot_cache_dir and weights_id is None:
            # nothing cheaper names this weight set: its bytes do
            sd = sd if sd is not None else self._load(source)
            weights_id = {"sha256": state_digest(sd)}
        self._weights_id = weights_id
        self._from_cache = False
        imported = None
        if self.aot_cache_dir:
            t1 = time.perf_counter()
            with trace.span("serve/cache_import", model=model_name):
                imported = self._import_cached(self.aot_cache_dir)
            self._import_s = time.perf_counter() - t1
        if imported is not None:
            # the swap contract is stated in RAW (float) avals, whatever
            # is served; the float originals are decoded from their source
            # when asked for (weights_host), never at start
            self._raw_avals, self._weights = imported
            self._raw_host = source if sd is None else self._host_copy(sd)
            self._from_cache = True
        else:
            sd = sd if sd is not None else self._load(source)
            self._raw_avals = self._avals(sd)
            self._weights, self._raw_host = self._prepare_weights(
                sd, self.cold_start_stages)
        self.warmup()
        self.ready_s = time.perf_counter() - t0

    # -- weights -------------------------------------------------------

    def _load(self, source) -> Mapping:
        return source(self.cold_start_stages)

    @staticmethod
    def _host_copy(state_dict: Mapping) -> dict:
        return {k: _host(v).copy() for k, v in state_dict.items()}

    def _skeleton(self):
        """The model on the meta device: its ``folded_forward`` reads only
        the folded tree, so no parameter of it is ever on the card."""
        with torch.device("meta"):
            return create_model(
                self.model_name, num_classes=self.num_classes).eval()

    def _prepare_weights(self, state_dict: Mapping, stages=None):
        """Load ``state_dict`` into a fresh model, fold it on the device
        for the compute dtype, and keep only the folded tree there (the
        model moves to the meta device): the ``(model, folded)`` pair a
        swap assigns, and the float originals on the host. All of it runs
        off any lock, once per weight set; ``stages`` gets each step's
        ms."""
        if self.int8:
            return self._prepare_int8(state_dict, stages)
        dev = self.device
        with _timed(stages, "model_ms", dev):
            raw = self._host_copy(state_dict)
            model = create_model(self.model_name,
                                 num_classes=self.num_classes)
            model.load_state_dict(
                {k: torch.from_numpy(np.array(v)) for k, v in raw.items()},
                strict=True,
            )
        with _timed(stages, "fold_ms", dev):
            model.to(dev).eval()
            folded = model.fold(self.compute_dtype)
            model.to("meta")
            return _Served(model, self._replicate(folded)), raw

    def _prepare_int8(self, state_dict: Mapping, stages=None):
        """The int8 lane's weight set: the model is folded on the device
        from the quantized values ``q`` (exact in every compute dtype), and
        each folded weight becomes ``{"q": int8, "s": scale}`` in its
        site's layout (``_int8_plan``). The model then keeps no storage
        (its parameters move to the meta device; the forward reads only
        the folded tree), so the device holds int8 weights, their scales
        and the folded vectors."""
        dev = self.device
        with _timed(stages, "quantize_ms"):
            raw = self._host_copy(state_dict)
            quant = quantize_int8(raw)
        with _timed(stages, "int8_plan_ms"):
            keys, plan = _int8_plan(self.model_name, self.num_classes)
        with _timed(stages, "model_ms", dev):
            scales = torch.from_numpy(np.concatenate(
                [quant[k]["s"].reshape(-1) for k in keys]))
            model = create_model(self.model_name,
                                 num_classes=self.num_classes)
            model.load_state_dict(
                {k: torch.from_numpy(
                    v["q"].astype(np.float32) if _is_qleaf(v)
                    else np.array(v))
                 for k, v in quant.items()},
                strict=True,
            )
        with _timed(stages, "fold_ms", dev):
            model.to(dev).eval()
            folded = model.fold(self.compute_dtype)
            leaves = iter(plan)

            def encode(leaf):
                if not isinstance(leaf, torch.Tensor):
                    return leaf
                ids = next(leaves)
                if ids is None:  # a folded vector: its own storage
                    return leaf.clone()
                return {"q": leaf.to(torch.int8),
                        "s": scales[ids].to(dev, self.compute_dtype)}

            folded = _tree_map(encode, folded)
            if next(leaves, False) is not False:
                raise ValueError(f"{self.model_name}: the int8 plan does "
                                 "not match the folded tree")
            model.to("meta")
            return _Served(model, self._replicate(folded)), raw

    def _replicate(self, folded) -> list:
        """``folded`` (on the first device) and a copy on every other
        device of the group; logical CPU shards share the one tree."""
        from pytorch_cifar_tpu_torch.serve.aot_cache import _map_tensors

        return [folded if dev == self.device
                else _map_tensors(lambda t, dev=dev: t.to(dev), folded)
                for dev in self.devices]

    def weights_host(self) -> dict:
        """Host-numpy copy of the served ``state_dict`` — what
        :meth:`swap_weights` takes back (the rollback snapshot). An int8
        engine returns the float ORIGINALS, not the encoding it serves. A
        weight set imported from the cache is decoded from its source here:
        the payload read at start, or the seed, never the file again (a
        checkpoint republished since does not change it)."""
        raw = self._raw_host
        if callable(raw):
            return self._host_copy(raw(None))
        return {k: v.copy() for k, v in raw.items()}

    @staticmethod
    def _avals(state_dict: Mapping):
        return [
            (k, tuple(np.shape(v)), _dtype_name(v))
            for k, v in state_dict.items()
        ]

    def check_swap_avals(self, state_dict: Mapping) -> None:
        """Raise ValueError unless ``state_dict`` has exactly the keys,
        shapes and dtypes the engine was built with."""
        if self._avals(state_dict) != self._raw_avals:
            raise ValueError(
                "refusing weight swap: new state_dict does not match the "
                "served model's keys/shapes/dtypes (different model/config?)"
            )

    def swap_weights(self, state_dict: Mapping) -> int:
        """Atomically replace the served weights; returns the new version.
        In-flight requests keep the weights they already captured."""
        self.check_swap_avals(state_dict)
        prepared = self._prepare_weights(state_dict)
        with self._swap_lock:
            self._weights, self._raw_host = prepared
            self.version += 1
        return self.version

    # -- the cold-start cache ------------------------------------------

    def _cache_key_fields(self, b: Optional[int]) -> dict:
        """Everything that identifies a bucket's entry (``b``) or the
        weight set's (``b`` None): the JAX engine's fields, with the card's
        name and compute capability in place of its devices and platform,
        the torch, CUDA, cuDNN and libcuda versions in place of jax and
        jaxlib, the kernel libraries' digests, and the weight set's
        identity. A different value in ANY field is a miss."""
        from pytorch_cifar_tpu_torch.ops import _build

        dev = self.device
        cuda = dev.type == "cuda"
        key = {
            "model": self.model_name,
            "num_classes": int(self.num_classes),
            "image_shape": list(self.image_shape),
            "compute_dtype": _dtype_name(torch.empty(
                0, dtype=self.compute_dtype)),
            "mean": list(self._norm_mean),
            "std": list(self._norm_std),
            "int8": bool(self.int8),
            "n_devices": int(self.n_devices),
            # the topology: an entry's probe logits are what THIS rank's
            # forward returned (the whole bucket on the leader, its slab
            # on another rank), on these devices
            "process_count": int(self.process_count),
            "process_index": int(self.process_index),
            "devices": [str(d) for d in self.devices],
            "platform": dev.type,
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "capability": list(torch.cuda.get_device_capability(dev))
            if cuda else None,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "cudnn": torch.backends.cudnn.version() if cuda else None,
            "libcuda": _libcuda_version() if cuda else None,
            "kernels": {n: _build.library_path(n).name
                        for n in sorted(_build.ENTRY_POINTS)},
            "weights": self._weights_id,
        }
        if b is not None:
            key["bucket"] = int(b)
        return key

    def _entry_names(self):
        """``(bucket -> (name, key), (weights name, key))``."""
        from pytorch_cifar_tpu_torch.serve import aot_cache

        wkey = self._cache_key_fields(None)
        buckets = {}
        for b in self.buckets:
            key = {**wkey, "bucket": int(b)}
            buckets[b] = (aot_cache.entry_name(
                self.model_name, b, aot_cache.fingerprint(key)), key)
        return buckets, (aot_cache.weights_name(
            self.model_name, aot_cache.fingerprint(wkey)), wkey)

    def _miss(self, n: int = 1) -> None:
        self.aot_cache_misses += n
        if self._obs is not None:
            self._obs.counter("serve.aot_cache_misses").inc(n)

    def _import_cached(self, cache_dir: str):
        """The raw avals and the served ``(model, folded)`` pair from the
        cache, or None (phases in the class docstring). The buckets it
        returns warm are in ``self._warm``, counted in ``aot_cache_hits``
        and timed as each bucket's first forward."""
        from pytorch_cifar_tpu_torch.serve import aot_cache

        stages = self.cold_start_stages
        names, (wname, wkey) = self._entry_names()
        # phase 1: the local scan (no forward yet)
        candidates = {}
        with _timed(stages, "cache_read_ms"):
            for b, (name, key) in names.items():
                entry = aot_cache.load_entry(cache_dir, name, key)
                if entry is None:
                    self._miss()
                    continue
                candidates[b] = np.asarray(entry["probe_logits"])
            went = aot_cache.load_entry(cache_dir, wname, wkey) \
                if candidates else None
        folded = None
        if went is not None:
            try:
                with _timed(stages, "cache_put_ms", self.device):
                    folded = aot_cache.deserialize_entry(went, self.device)
            except Exception as e:
                log.warning("cold-start cache weights %s failed to load "
                            "(%s) — preparing instead", wname, e)
        # phase 2: a bucket is a candidate only where every rank has it
        # (and its weight set): every probe below is a collective
        local = [int(b in candidates and folded is not None)
                 for b in self.buckets]
        agreed = self._agree_flags(local)
        for b, ok in zip(self.buckets, agreed):
            if not ok and b in candidates:
                del candidates[b]
                self._miss()
        if not candidates:
            return None
        with _timed(stages, "model_ms", self.device):
            self._weights = _Served(self._skeleton(),
                                    self._replicate(folded))
        raw_avals = went["raw_avals"]
        del went  # the host copy of the weight set
        # phase 3: each candidate's probe, its first forward
        refuted = []
        for b in sorted(candidates):
            with _timed(stages, f"b{b}_first_ms"):
                got = self._forward(probe_batch(b, self.image_shape))
            if not np.array_equal(got, candidates[b]):
                aot_cache.poison_entry(
                    cache_dir, names[b][0],
                    "probe logits differ from the exporter's")
                refuted.append(b)
        # phase 4: one refutation, on any rank, drops the whole load
        if not self._agree_flags([int(not refuted)])[0]:
            self._weights = None
            self._miss(len(candidates))
            for b in candidates:
                stages.pop(f"b{b}_first_ms", None)
            return None
        self._warm.update(candidates)
        self.aot_cache_hits += len(candidates)
        if self._obs is not None:
            self._obs.counter("serve.aot_cache_hits").inc(len(candidates))
        return raw_avals, self._weights

    def _export(self, probes: dict) -> None:
        """Publish what this engine warmed itself: the weight set (unless
        it came from the cache) and each bucket's probe logits."""
        from pytorch_cifar_tpu_torch.serve import aot_cache

        names, (wname, wkey) = self._entry_names()
        with _timed(self.cold_start_stages, "export_ms"):
            if not self._from_cache:
                body = aot_cache.encode_weights(self._weights[1])
                body["raw_avals"] = self._raw_avals
                if aot_cache.export_entry(self.aot_cache_dir, wname, wkey,
                                          body) is None:
                    return
            for b, logits in probes.items():
                name, key = names[b]
                aot_cache.export_entry(self.aot_cache_dir, name, key,
                                       {"probe_logits": logits})

    # -- forward -------------------------------------------------------

    def _shard_logits(self, model, folded, x: np.ndarray,
                      dev: torch.device) -> torch.Tensor:
        """One shard's fp32 logits on ``dev``, queued (not waited for)."""
        mean, std = self._norm[dev]
        on_card = torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()
        with on_card:
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            xn = normalize(xt, mean, std, self.compute_dtype)
            if self.int8:
                folded = dequantize_int8(folded, self.compute_dtype)
            return model.folded_forward(
                folded, xn.permute(0, 3, 1, 2)).float()

    def _forward(self, x: np.ndarray) -> np.ndarray:
        """uint8 NHWC host batch, a bucket -> fp32 host logits. On a device
        group the bucket is split into equal shards: this rank's run on its
        devices, all queued before any is waited for, and the logits come
        back in device order; across processes the leader gathers every
        rank's rows (a collective) and another rank gets its own."""
        if self.n_devices == 1:
            return self._forward_whole(x)
        w = self._weights  # atomic read of every device's weights
        per = x.shape[0] // self.n_devices
        first = self.process_index * len(self.devices)
        with torch.inference_mode():
            pending = [
                self._shard_logits(
                    w[0], w.copies[i],
                    x[(first + i) * per:(first + i + 1) * per], dev)
                for i, dev in enumerate(self.devices)]
            out = np.concatenate([t.cpu().numpy() for t in pending])
        if self.process_count > 1:
            from pytorch_cifar_tpu_torch.parallel import mesh

            out = mesh.gather_rows(out, self.mesh_group)
        with self._count_lock:
            self.forward_count += 1
        return out

    def _forward_whole(self, x: np.ndarray) -> np.ndarray:
        """The whole batch on the first device, whatever the group."""
        w = self._weights
        with torch.inference_mode():
            out = self._shard_logits(w[0], w.copies[0], x,
                                     self.device).cpu().numpy()
        with self._count_lock:
            self.forward_count += 1
        return out

    def _agree_flags(self, flags) -> np.ndarray:
        """The element-wise AND (minimum) of a small flag vector over every
        rank of the group, JAX's ``_agree_flags`` (the identity in one
        process)."""
        flags = np.asarray(flags, np.int64)
        if self.process_count == 1:
            return flags
        from pytorch_cifar_tpu_torch.parallel import mesh

        return mesh.all_min(flags, self.mesh_group)

    def topology(self) -> dict:
        """The device group as the health block shows it."""
        return {
            "process_count": int(self.process_count),
            "process_index": int(self.process_index),
            "local_devices": len(self.devices),
            "global_devices": int(self.n_devices),
        }

    def warmup(self) -> None:
        """Run every bucket not yet warm once on its probe batch
        (idempotent): builds the kernels, lets the backend settle its
        per-shape choices, and counts each bucket in ``compile_count``
        (``predict`` never adds to it). With a cache, what it warmed is
        exported. Sets ``cold_start_s``."""
        t0 = time.perf_counter()
        probes = {}
        for b in self.buckets:
            if b in self._warm:
                continue
            with trace.span("serve/compile_bucket", bucket=b), \
                    _timed(self.cold_start_stages, f"b{b}_first_ms"):
                probes[b] = self._forward(probe_batch(b, self.image_shape))
            self._warm.add(b)
            self.compile_count += 1
            if self._obs is not None:
                self._obs.counter("serve.compiles").inc()
        if probes and self.aot_cache_dir:
            self._export(probes)
        self.cold_start_s = time.perf_counter() - t0 + self._import_s
        self._import_s = 0.0
        if self._obs is not None:
            self._obs.gauge("serve.cold_start_s").set(self.cold_start_s)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n, or the largest bucket (callers chunk). On
        a device group the singleton bucket serves ONLY n = 1."""
        if self._singleton is not None and n == 1:
            return self._singleton
        for b in self.buckets:
            if n <= b and b != self._singleton:
                return b
        return self.buckets[-1]

    def shard_split(self, n: int):
        """Valid rows per shard for an ``n``-image request after padding
        (and chunking past the largest bucket), JAX's layout: shard ``i``
        of a ``b``-row bucket owns rows ``[i*b/D, (i+1)*b/D)``, so a ragged
        tail leaves the trailing shards padded. Sums to ``n``."""
        out = []
        cap = self.buckets[-1]
        for off in range(0, max(int(n), 0), cap):
            m = min(cap, n - off)
            per = self.bucket_for(m) // self.n_devices
            out.extend(min(per, max(0, m - i * per))
                       for i in range(self.n_devices))
        return out

    def _run_bucket(self, x: np.ndarray) -> np.ndarray:
        """One padded bucket call: len(x) <= max bucket. The pad buffer
        comes from :attr:`staging` and is released after the logits are
        back on the host (the device copy has consumed it by then)."""
        n = x.shape[0]
        b = self.bucket_for(n)
        staged = None
        if n < b:
            staged = self.staging.acquire((b, *self.image_shape), x.dtype)
            staged[:n] = x
            staged[n:] = 0  # pad rows are zeros (bit-identity contract)
            x = staged
        t0 = time.perf_counter()
        try:
            with trace.span("serve/bucket_forward", bucket=b, n=n):
                res = self._forward(x)[:n]
        finally:
            if staged is not None:
                self.staging.release(staged)
        if self._h_device is not None:
            self._h_device.observe((time.perf_counter() - t0) * 1e3)
        return res

    def predict(self, images: np.ndarray) -> np.ndarray:
        """uint8 NHWC batch of any size -> fp32 logits ``(n, classes)``."""
        # fault hook (inert unless armed): an engine failure must fail only
        # its own batch in the micro-batcher, never the serving process
        faults.maybe_raise("serve_error")
        x = np.asarray(images)
        if x.ndim != 4 or x.shape[1:] != self.image_shape:
            raise ValueError(
                f"expected (n, {', '.join(map(str, self.image_shape))}) "
                f"images, got {x.shape}"
            )
        if self._c_int8_requests is not None:
            self._c_int8_requests.inc()
            self._c_int8_images.inc(int(x.shape[0]))
        n, cap = x.shape[0], self.buckets[-1]
        if n <= cap:
            return self._run_bucket(x)
        return np.concatenate(
            [self._run_bucket(x[i : i + cap]) for i in range(0, n, cap)]
        )

    def direct_forward(self, images: np.ndarray) -> np.ndarray:
        """Unpadded forward at the EXACT request shape on the first device
        alone — the bit-identity oracle for tests and ``--verify`` (a
        device group must match the one-device answer, not merely itself);
        not counted in ``compile_count``."""
        return self._forward_whole(np.asarray(images))

    # -- constructors --------------------------------------------------

    @classmethod
    def from_checkpoint(
        cls, ckpt: str, model_name: str, *, num_classes: int = 10, **kw
    ) -> "InferenceEngine":
        """Serve a trainer's directory, a ``.msgpack`` or a reference
        ``.pth`` (:func:`load_checkpoint_trees`); the checkpoint's meta is
        in :attr:`checkpoint_meta`. A ``.msgpack`` payload is read and
        checked here, and with a cache named by its sidecar's publish
        fingerprint and its SHA-256; it is decoded only when the engine
        prepares its weights itself (not on a cache hit) or when
        :meth:`weights_host` asks for them."""
        t0 = time.perf_counter()
        path = resolve_checkpoint(ckpt)
        stages: dict = {}
        if path.endswith(".pth"):
            sd, meta = load_checkpoint_trees(path, model_name,
                                             num_classes=num_classes,
                                             stages=stages)
            eng = cls(model_name, sd, num_classes=num_classes, **kw)
        else:
            meta = read_meta(os.path.dirname(path) or ".",
                             os.path.basename(path))
            payload = _read_msgpack_payload(path, meta, stages)
            weights_id = None
            if kw.get("aot_cache_dir"):
                # the manifest's CRC alone would leave a weight set's
                # identity to 32 bits: its bytes name it
                with _timed(stages, "checkpoint_digest_ms"):
                    weights_id = {"publish": publish_fingerprint(meta),
                                  "sha256": hashlib.sha256(
                                      payload).hexdigest()}

            def source(stages):
                return _decode_msgpack_state(path, payload, model_name,
                                             num_classes, stages)

            eng = cls(model_name, source, num_classes=num_classes,
                      weights_id=weights_id, **kw)
        eng.cold_start_stages.update(stages)
        eng.ready_s = time.perf_counter() - t0
        eng.checkpoint_meta = meta
        return eng

    @classmethod
    def from_random(
        cls, model_name: str, *, seed: int = 0, num_classes: int = 10, **kw
    ) -> "InferenceEngine":
        """PyTorch-default init drawn from ``torch.Generator(seed)``
        (serving speed does not depend on the weights' values); the seed
        names the weight set, which is drawn only when the engine prepares
        it itself."""

        def source(stages):
            with _timed(stages, "init_ms"):
                g = torch.Generator().manual_seed(int(seed))
                return create_model(model_name, num_classes=num_classes,
                                    generator=g).state_dict()

        return cls(model_name, source, num_classes=num_classes,
                   weights_id={"random_seed": int(seed)}, **kw)

    @classmethod
    def from_jax(
        cls, model_name: str, params, batch_stats, *, num_classes: int = 10,
        **kw,
    ) -> "InferenceEngine":
        """Serve the JAX package's ``(params, batch_stats)`` trees (nested
        dicts of numpy arrays), mapped by ``compat.state_dict_from_jax``."""
        sd = state_dict_from_jax(
            model_name, params, batch_stats, num_classes=num_classes
        )
        return cls(model_name, sd, num_classes=num_classes, **kw)
