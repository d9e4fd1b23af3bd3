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

The default compute dtype is bf16 with fp32 logits on the wire.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_cifar_tpu_torch import faults, resolve_device
from pytorch_cifar_tpu_torch.compat import (
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
        self.staging = StagingPool(registry=registry)
        self._raw_avals = self._avals(state_dict)
        self._weights = self._prepare_weights(state_dict)
        self.warmup()

    # -- weights -------------------------------------------------------

    def _prepare_weights(self, state_dict: Mapping):
        """Load ``state_dict`` into a fresh model on the device and fold it
        for the compute dtype: the ``(model, folded)`` pair a swap assigns.
        All of it runs off any lock, once per weight set."""
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
        return model, model.fold(self.compute_dtype)

    def weights_host(self) -> dict:
        """Host-numpy copy of the served ``state_dict`` — what
        :meth:`swap_weights` takes back (the rollback snapshot)."""
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
            self._weights = prepared
            self.version += 1
        return self.version

    # -- forward -------------------------------------------------------

    def _forward(self, x: np.ndarray) -> np.ndarray:
        """uint8 NHWC host batch -> fp32 host logits, on the device."""
        model, folded = self._weights  # atomic tuple read
        with torch.inference_mode():
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            xn = normalize(xt, self._mean, self._std, self.compute_dtype)
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
