"""Host staging arena for the serving path (counterpart of
``StagingPool`` in ``pytorch_cifar_tpu/data/pipeline.py``)."""

from __future__ import annotations

import threading
from typing import Tuple

import numpy as np


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
