"""The device-resident training data plane and the serving path's host
staging arena (counterparts of ``DeviceDataset`` and ``StagingPool`` in
``pytorch_cifar_tpu/data/pipeline.py``)."""

from __future__ import annotations

import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from pytorch_cifar_tpu_torch import resolve_device


def mix_seed(seed: int, k: int) -> int:
    """The generator seed for draw ``k`` (an epoch, a step) of a run
    seeded ``seed``: the JAX host loader's ``(seed * 100003 + k) % 2**31``
    arithmetic."""
    return (seed * 100003 + k) % (2**31)


class DeviceDataset:
    """The whole dataset on the device: uint8 images and int32 labels are
    staged once, and each epoch's batches are gathered there from an
    extended permutation of length ``len(self) * batch_size``: the epoch
    order followed by wrap-around indices for a ragged tail (positions
    >= n get label -1 when materialized), the JAX ``DeviceDataset``'s rule.

    ``staged_perm(epoch)``: with ``device_perm=False`` the host
    ``RandomState((seed * 100003 + epoch) % 2**31)`` permutation, the same
    integers as the JAX package's host stream, copied to the device; with
    ``device_perm=True`` ``torch.randperm`` on the device from a generator
    seeded with the same ``(seed, epoch)`` mix (another stream than
    ``jax.random``'s, by design). ``shuffle=False`` is the identity order,
    staged once (the eval path). The data lies on ``device``: CUDA unless
    the caller names another."""

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        device_perm: bool = False,
        device=None,
    ):
        if images.shape[0] != labels.shape[0]:
            raise ValueError(
                f"{images.shape[0]} images but {labels.shape[0]} labels"
            )
        self.n = images.shape[0]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.device = resolve_device(device)
        self.device_perm = device_perm and shuffle
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device
        )
        self.labels = torch.from_numpy(
            np.ascontiguousarray(labels, np.int32)
        ).to(self.device)
        self._perm_static = (
            None if shuffle else self._put(self._epoch_perm(None))
        )

    def __len__(self) -> int:
        return (
            self.n // self.batch_size
            if self.drop_last
            else -(-self.n // self.batch_size)
        )

    def _epoch_perm(self, order: Optional[np.ndarray]) -> np.ndarray:
        """Extended permutation of length ``len(self) * batch_size``."""
        n, total = self.n, len(self) * self.batch_size
        if order is None:
            order = np.arange(n, dtype=np.int32)
        if total <= n:
            return order[:total].astype(np.int32)
        return order[np.arange(total) % n].astype(np.int32)

    def _put(self, perm: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(perm).to(self.device)

    def staged_perm(self, epoch: int) -> torch.Tensor:
        """The epoch's extended permutation, int32, on the device."""
        if not self.shuffle:
            return self._perm_static
        if not self.device_perm:
            order = np.random.RandomState(
                mix_seed(self.seed, epoch)
            ).permutation(self.n)
            return self._put(self._epoch_perm(order))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(mix_seed(self.seed, epoch))
        order = torch.randperm(self.n, generator=gen, device=self.device)
        total = len(self) * self.batch_size
        if total > self.n:
            order = order[torch.arange(total, device=self.device) % self.n]
        return order[:total].to(torch.int32)

    def materialize(
        self, perm: torch.Tensor, start: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batch ``[start, start + batch_size)`` of the extended order:
        its images, and its labels with -1 at positions >= n."""
        idx = perm[start:start + self.batch_size]
        x = torch.index_select(self.images, 0, idx)
        y = torch.index_select(self.labels, 0, idx)
        pos = torch.arange(
            start, start + self.batch_size, device=self.device
        )
        return x, torch.where(pos < self.n, y, -1)

    def epoch(self, epoch: int) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        perm = self.staged_perm(epoch)
        for b in range(len(self)):
            yield self.materialize(perm, b * self.batch_size)


class StagingPool:
    """Shape-keyed pool of reusable host staging buffers.

    Shape-bucketed serving means the set of batch shapes is tiny and fixed,
    so the batcher's batch assembly and the engine's pad buffers need not
    allocate per request: this pool hands the same buffers back out, and the
    assembly copy writes into warm, page-resident memory.

    Lifetime contract: a buffer may be released only once nothing will read
    it again — for the serving engine, after the bucket call's logits are
    back on the host, which also covers the host-to-device copy of the
    buffer.

    Thread-safe; at most ``max_per_shape`` buffers are retained per shape
    (excess releases are dropped to the allocator).
    """

    def __init__(self, max_per_shape: int = 4, registry=None):
        self.max_per_shape = int(max_per_shape)
        self._lock = threading.Lock()
        self._free: dict = {}  # (shape, dtype-str) -> [ndarray, ...]
        self._c_reuse = (
            registry.counter("serve.staging_reuse")
            if registry is not None
            else None
        )

    def acquire(self, shape: Tuple[int, ...], dtype) -> np.ndarray:
        """A writable buffer of exactly (shape, dtype) — reused when one is
        free, freshly allocated otherwise. Contents are UNDEFINED: the
        caller overwrites the rows it uses and zeroes the pad tail."""
        key = (tuple(int(s) for s in shape), np.dtype(dtype).str)
        with self._lock:
            bufs = self._free.get(key)
            buf = bufs.pop() if bufs else None
        if buf is not None:
            if self._c_reuse is not None:
                self._c_reuse.inc()
            return buf
        return np.empty(key[0], dtype=np.dtype(dtype))

    def release(self, buf: np.ndarray) -> None:
        """Return a buffer for reuse. Only call once no consumer (the
        device copy included) will read it again."""
        key = (tuple(buf.shape), buf.dtype.str)
        with self._lock:
            bufs = self._free.setdefault(key, [])
            if len(bufs) < self.max_per_shape:
                bufs.append(buf)
