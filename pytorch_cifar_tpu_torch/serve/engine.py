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
  sites' weights to HWIO); requests only read it.
- **Checkpoints.** :meth:`InferenceEngine.from_checkpoint` serves a
  trainer's directory (the best checkpoint first), a ``.msgpack`` payload
  (either package's; verified against its sidecar's manifest) or a
  reference ``ckpt.pth`` (:func:`load_checkpoint_trees`).
- **Swaps are atomic.** The served ``(model, folded)`` pair sits behind one
  reference; a swap validates that the new ``state_dict`` has the same keys,
  shapes and dtypes, prepares it off the lock and replaces the reference in
  one assignment. Requests already running keep the pair they captured.
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

import dataclasses
import functools
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
    read_meta,
    read_payload_tree,
    read_verified_payload,
)

DEFAULT_BUCKETS = (1, 8, 32, 128)
IMAGE_SHAPE = (32, 32, 3)


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


def load_checkpoint_trees(
    ckpt: str, model_name: str, num_classes: int = 10
) -> Tuple[dict, dict]:
    """Serving weights from any checkpoint the port understands, as the
    port's ``state_dict`` (numpy) and the checkpoint's ``meta`` (the
    sidecar's ``epoch``/``best_acc``, or the reference envelope's
    ``epoch``/``acc``). ``ckpt`` may be:

    - a trainer's directory: the first candidate of the best order that
      exists (a v3 commit marker counts), as the JAX engine picks it;
    - a ``.msgpack`` payload, verified against its sidecar's manifest
      (v3 reassembled from its committed shards) and mapped through
      ``compat.state_dict_from_jax``;
    - a reference ``ckpt.pth`` (``{'net': sd, 'acc', 'epoch'}``, or a bare
      ``state_dict``), read with ``weights_only=True``; ``module.``
      prefixes are stripped and the keys are the port's own.

    Raises FileNotFoundError when there is nothing to load and
    ``CheckpointCorrupt`` when a payload fails verification or decoding.
    """
    path = ckpt
    if os.path.isdir(path):
        for name in best_checkpoint_order(path):
            p = os.path.join(path, name)
            if os.path.isfile(p) or "shards" in read_meta(path, name):
                path = p
                break
        else:
            raise FileNotFoundError(
                f"no checkpoint in {path!r} (looked for "
                f"{best_checkpoint_order(path)})"
            )
    if path.endswith(".pth"):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd, meta = normalize_state_dict(obj)
        return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in sd.items()}, meta
    dirpath, name = os.path.dirname(path) or ".", os.path.basename(path)
    meta = read_meta(dirpath, name)
    tree = read_payload_tree(path, read_verified_payload(dirpath, name, meta))
    return state_dict_from_jax(
        model_name, tree["params"], tree.get("batch_stats", {}),
        num_classes=num_classes,
    ), meta


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


class InferenceEngine:
    """Batched eval forward over fixed batch-size buckets, warmed up at
    construction.

    ``predict`` accepts uint8 NHWC images ``(n, 32, 32, 3)`` for ANY n >= 1
    and returns fp32 logits ``(n, classes)`` as numpy. Thread-safe: the
    served weights are replaced by a single assignment.

    ``int8=True`` serves the int8 lane (module docstring): the same
    buckets, forward and kernels over int8-resident weights, counted in
    ``serve.int8_requests``/``serve.int8_images``; :meth:`weights_host`
    still returns the float originals and a swap still takes (and
    re-quantizes) a float ``state_dict``.

    ``n_devices`` is 1 (one card; serving over a device group is not
    ported) and ``aot_cache_hits`` is 0: the port has no cold-start cache
    yet, so ``/healthz`` reports every bucket as warmed here.
    """

    n_devices = 1
    aot_cache_hits = 0

    def __init__(
        self,
        model_name: str,
        state_dict: Mapping,
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        compute_dtype: Optional[torch.dtype] = None,
        num_classes: int = 10,
        registry=None,
        device=None,
        int8: bool = False,
    ):
        if not buckets:
            raise ValueError("need at least one batch-size bucket")
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        self.device = resolve_device(device)
        self.model_name = model_name
        self.num_classes = num_classes
        self.image_shape = IMAGE_SHAPE
        self.compute_dtype = (
            torch.bfloat16 if compute_dtype is None else compute_dtype
        )
        self._mean = torch.tensor(CIFAR10_MEAN, device=self.device)
        self._std = torch.tensor(CIFAR10_STD, device=self.device)
        self._warm: set = set()
        self._swap_lock = threading.Lock()
        self._count_lock = threading.Lock()
        self.compile_count = 0  # bucket warmups only (see warmup)
        self.forward_count = 0  # every device forward: warmup, bucket, direct
        self.version = 0  # bumped by every swap_weights
        self.checkpoint_meta: dict = {}  # set by from_checkpoint
        self.cold_start_s = 0.0  # wall time of the last warmup()
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
        # the swap contract is stated in RAW (float) avals, whatever the
        # int8 lane does to the weights inside; _raw_host holds the lane's
        # float originals (None off the lane)
        self._raw_avals = self._avals(state_dict)
        self._weights, self._raw_host = self._prepare_weights(state_dict)
        self.warmup()

    # -- weights -------------------------------------------------------

    def _prepare_weights(self, state_dict: Mapping):
        """Load ``state_dict`` into a fresh model on the device and fold it
        for the compute dtype: the ``(model, folded)`` pair a swap assigns,
        and the int8 lane's float originals (None off the lane). All of it
        runs off any lock, once per weight set."""
        if self.int8:
            return self._prepare_int8(state_dict)
        model = create_model(self.model_name, num_classes=self.num_classes)
        model.load_state_dict(
            {
                k: v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v))
                for k, v in state_dict.items()
            },
            strict=True,
        )
        model.to(self.device).eval()
        return (model, model.fold(self.compute_dtype)), None

    def _prepare_int8(self, state_dict: Mapping):
        """The int8 lane's weight set: the model is folded on the device
        from the quantized values ``q`` (exact in every compute dtype), and
        each folded weight becomes ``{"q": int8, "s": scale}`` in its
        site's layout (``_int8_plan``). The model then keeps no storage
        (its parameters move to the meta device; the forward reads only
        the folded tree), so the device holds int8 weights, their scales
        and the folded vectors."""
        raw = {k: _host(v).copy() for k, v in state_dict.items()}
        quant = quantize_int8(raw)
        keys, plan = _int8_plan(self.model_name, self.num_classes)
        scales = torch.from_numpy(np.concatenate(
            [quant[k]["s"].reshape(-1) for k in keys]))
        model = create_model(self.model_name, num_classes=self.num_classes)
        model.load_state_dict(
            {k: torch.from_numpy(
                v["q"].astype(np.float32) if _is_qleaf(v) else np.array(v))
             for k, v in quant.items()},
            strict=True,
        )
        model.to(self.device).eval()
        folded = model.fold(self.compute_dtype)
        leaves = iter(plan)

        def encode(leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            ids = next(leaves)
            if ids is None:  # a folded vector: its own storage, not the model's
                return leaf.clone()
            return {"q": leaf.to(torch.int8),
                    "s": scales[ids].to(self.device, self.compute_dtype)}

        folded = _tree_map(encode, folded)
        if next(leaves, False) is not False:
            raise ValueError(f"{self.model_name}: the int8 plan does not "
                             "match the folded tree")
        return (model.to("meta"), folded), raw

    def weights_host(self) -> dict:
        """Host-numpy copy of the served ``state_dict`` — what
        :meth:`swap_weights` takes back (the rollback snapshot). An int8
        engine returns the float ORIGINALS, not the encoding it serves."""
        if self.int8:
            return {k: v.copy() for k, v in self._raw_host.items()}
        model, _ = self._weights
        return {
            k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()
        }

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

    # -- forward -------------------------------------------------------

    def _forward(self, x: np.ndarray) -> np.ndarray:
        """uint8 NHWC host batch -> fp32 host logits, on the device."""
        model, folded = self._weights  # atomic tuple read
        with torch.inference_mode():
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            xn = normalize(xt, self._mean, self._std, self.compute_dtype)
            if self.int8:
                folded = dequantize_int8(folded, self.compute_dtype)
            logits = model.folded_forward(folded, xn.permute(0, 3, 1, 2))
            out = logits.float().cpu().numpy()  # waits for the device
        with self._count_lock:
            self.forward_count += 1
        return out

    def warmup(self) -> None:
        """Run every bucket once (idempotent): builds the kernels, lets the
        backend settle its per-shape choices, and counts each bucket in
        ``compile_count``. ``predict`` never adds to it."""
        t0 = time.perf_counter()
        for b in self.buckets:
            if b in self._warm:
                continue
            with trace.span("serve/compile_bucket", bucket=b):
                self._forward(np.zeros((b, *self.image_shape), np.uint8))
            self._warm.add(b)
            self.compile_count += 1
            if self._obs is not None:
                self._obs.counter("serve.compiles").inc()
        self.cold_start_s = time.perf_counter() - t0
        if self._obs is not None:
            self._obs.gauge("serve.cold_start_s").set(self.cold_start_s)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n, or the largest bucket (callers chunk)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def shard_split(self, n: int):
        """Valid rows per device call for an ``n``-image request (one device:
        one entry per chunk of the largest bucket)."""
        cap = self.buckets[-1]
        return [min(cap, n - off) for off in range(0, max(int(n), 0), cap)]

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
        """Unpadded forward at the EXACT request shape — the bit-identity
        oracle for tests and ``--verify``; not counted in
        ``compile_count``."""
        return self._forward(np.asarray(images))

    # -- constructors --------------------------------------------------

    @classmethod
    def from_checkpoint(
        cls, ckpt: str, model_name: str, *, num_classes: int = 10, **kw
    ) -> "InferenceEngine":
        """Serve a trainer's directory, a ``.msgpack`` or a reference
        ``.pth`` (:func:`load_checkpoint_trees`); the checkpoint's meta is
        in :attr:`checkpoint_meta`."""
        sd, meta = load_checkpoint_trees(ckpt, model_name,
                                         num_classes=num_classes)
        eng = cls(model_name, sd, num_classes=num_classes, **kw)
        eng.checkpoint_meta = meta
        return eng

    @classmethod
    def from_random(
        cls, model_name: str, *, seed: int = 0, num_classes: int = 10, **kw
    ) -> "InferenceEngine":
        """PyTorch-default init drawn from ``torch.Generator(seed)``
        (serving speed does not depend on the weights' values)."""
        g = torch.Generator().manual_seed(int(seed))
        model = create_model(model_name, num_classes=num_classes, generator=g)
        return cls(model_name, model.state_dict(), num_classes=num_classes,
                   **kw)

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
