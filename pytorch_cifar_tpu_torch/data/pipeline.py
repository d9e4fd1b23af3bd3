"""The training data planes and the serving path's host staging arena
(counterparts of ``Dataloader``, ``DeviceDataset``, ``eval_batches`` and
``StagingPool`` in ``pytorch_cifar_tpu/data/pipeline.py``).

Two planes feed the train step:

- :class:`DeviceDataset` (the default): the dataset on the device, each
  epoch one gather there;
- :class:`Dataloader` (``--no-device_data``, ``--host_augment``): the host
  shuffles, gathers (and with ``host_augment`` crops and flips) each batch
  through the native data plane (``native/``) and copies it to the
  device, by default from a producer thread feeding a bounded queue.

Under data parallelism each rank takes its slab of every global batch
(:func:`local_slab`), the rows the JAX package's process gets.
"""

from __future__ import annotations

import collections
import queue as queue_lib
import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from pytorch_cifar_tpu_torch import native, resolve_device


def mix_seed(seed: int, k: int) -> int:
    """The generator seed for draw ``k`` (an epoch, a step) of a run
    seeded ``seed``: the JAX host loader's ``(seed * 100003 + k) % 2**31``
    arithmetic."""
    return (seed * 100003 + k) % (2**31)


def local_slab(
    global_shape: Tuple[int, ...], shard: int = 0, n_shards: int = 1
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Rank ``shard``'s box of a global array of ``global_shape`` over
    ``n_shards`` ranks: ``((b_lo, b_hi), (h_lo, h_hi))``. The port shards
    the batch only (spatial partitioning is not ported), so the box is the
    contiguous rows ``[shard * B / P, (shard + 1) * B / P)`` and every
    image row: the DistributedSampler arithmetic, and the slab JAX's
    ``local_slab`` gives a process of a batch-sharded mesh."""
    b = global_shape[0]
    if not 0 <= shard < n_shards or b % n_shards:
        raise ValueError(f"a batch of {b} has no shard {shard} of "
                         f"{n_shards} equal ones")
    per = b // n_shards
    h = global_shape[1] if len(global_shape) > 1 else 0
    return (shard * per, (shard + 1) * per), (0, h)


class _Staging:
    """One pinned host buffer pair of the host-to-device copy, and the
    event recorded after the copy that last read it."""

    __slots__ = ("x", "y", "event")

    def __init__(self, x_shape, n):
        self.x = torch.empty(x_shape, dtype=torch.uint8, pin_memory=True)
        self.y = torch.empty((n,), dtype=torch.int32, pin_memory=True)
        self.event = None


class Dataloader:
    """Iterates one epoch's ``(uint8 NHWC images, int32 labels)`` batches
    on ``device`` (CUDA unless the caller names another).

    The order and the draws are the JAX ``Dataloader``'s, so the batches
    are bit-identical to it for one seed: the shuffle is
    ``RandomState((seed * 100003 + epoch) % 2**31).permutation(n)``, the
    host augmentation draws (``host_augment``: crop offsets, then flips,
    for the whole global batch, this rank's rows sliced) come from
    ``RandomState((seed * 9973 + epoch * 31 + 7) % 2**31)``, and with
    ``drop_last=False`` a ragged tail is wrap-padded from the start of the
    epoch's order with labels -1. Rank ``shard`` of ``n_shards`` takes its
    :func:`local_slab` of every batch.

    ``async_input``: one producer thread assembles each batch (native
    gather, host augmentation) and starts its copy to the device, feeding
    a bounded FIFO queue of ``prefetch`` batches; off, the training thread
    keeps ``prefetch`` batches in flight itself. One producer and a FIFO
    make both yield the same batches in the same order. On CUDA a batch
    goes through a pinned staging buffer and a ``non_blocking`` copy on a
    copy stream; an event recorded after the copy makes the consumer's
    stream wait for it, and the buffer is refilled only after its event
    (a ring of ``prefetch + 2`` buffers, so the wait is rare).

    ``registry`` records ``data.host_batch_ms`` (gather + augment),
    ``data.producer_batch_ms`` (the producer's whole batch, the copy's
    launch included) and ``data.prefetch_depth`` (the queue after each
    take)."""

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        shard: int = 0,
        n_shards: int = 1,
        prefetch: int = 2,
        async_input: bool = True,
        host_augment: bool = False,
        augment_padding: int = 4,
        augment_flip: bool = True,
        registry=None,
        device=None,
    ):
        if images.shape[0] != labels.shape[0]:
            raise ValueError(
                f"{images.shape[0]} images but {labels.shape[0]} labels"
            )
        # normalized once, so the native gather takes every batch as is
        self.images = np.ascontiguousarray(images, np.uint8)
        self.labels = np.ascontiguousarray(labels, np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.slab = local_slab((batch_size,) + self.images.shape[1:], shard,
                               n_shards)
        self.prefetch = max(1, prefetch)
        self.async_input = async_input
        self.host_augment = host_augment
        self.augment_padding = augment_padding
        self.augment_flip = augment_flip
        self.device = resolve_device(device)
        self._obs_hist = self._obs_depth = self._obs_producer = None
        if registry is not None:
            self._obs_hist = registry.histogram("data.host_batch_ms")
            self._obs_depth = registry.gauge("data.prefetch_depth")
            self._obs_producer = registry.histogram("data.producer_batch_ms")
        self._ring: list = []
        self._next = 0
        self._stream = None

    def __len__(self) -> int:
        n = self.images.shape[0]
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def epoch(self, epoch: int) -> Iterator[Tuple[torch.Tensor,
                                                  torch.Tensor]]:
        n = self.images.shape[0]
        order = (np.random.RandomState(
            (self.seed * 100003 + epoch) % (2**31)).permutation(n)
            if self.shuffle else np.arange(n))
        aug_rng = np.random.RandomState(
            (self.seed * 9973 + epoch * 31 + 7) % (2**31))
        (r0, r1), _ = self.slab
        pad, bs = self.augment_padding, self.batch_size

        def host_batches():
            for b in range(len(self)):
                t0 = time.perf_counter()
                lo = b * bs + r0
                hi = lo + (r1 - r0)
                j = np.arange(lo, hi)
                idx = order[j % n]
                x, y = native.gather_batch(self.images, self.labels, idx)
                if hi > n:
                    y = np.where(j < n, y, np.int32(-1)).astype(np.int32)
                if self.host_augment:
                    # drawn for the whole global batch, this rank's rows
                    # sliced: every rank consumes the same stream
                    s = slice(r0, r1)
                    dx = aug_rng.randint(0, 2 * pad + 1, bs)[s]
                    dy = aug_rng.randint(0, 2 * pad + 1, bs)[s]
                    fl = aug_rng.randint(0, 2 if self.augment_flip else 1,
                                         bs)[s]
                    x = native.augment_batch_u8(x, dx, dy, fl, padding=pad)
                if self._obs_hist is not None:
                    self._obs_hist.observe((time.perf_counter() - t0) * 1e3)
                yield x, y

        it = host_batches()
        if self.async_input:
            for batch in self._async_epoch(it):
                yield self._take(batch)
            return
        pending = collections.deque()
        for x, y in it:
            pending.append(self._put(x, y))
            if len(pending) >= self.prefetch:
                yield self._take(pending.popleft())
        while pending:
            yield self._take(pending.popleft())

    def _async_epoch(self, it) -> Iterator[tuple]:
        """Drain ``it`` through a producer thread and a bounded FIFO queue
        of ``prefetch`` put batches. A consumer that stops early (a
        rollback, a stop request, an exception in the step) closes this
        generator: the ``finally`` stops the producer, unblocks a put
        parked on a full queue by draining it, and joins the thread, so
        no thread outlives the epoch. A producer exception is raised here,
        on the consumer's thread."""
        q: queue_lib.Queue = queue_lib.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                while not stop.is_set():
                    t0 = time.perf_counter()
                    try:
                        x, y = next(it)
                    except StopIteration:
                        q.put(("end", None))
                        return
                    batch = self._put(x, y)
                    if self._obs_producer is not None:
                        self._obs_producer.observe(
                            (time.perf_counter() - t0) * 1e3)
                    q.put(("ok", batch))
            except BaseException as e:  # raised again on the consumer
                q.put(("err", e))

        worker = threading.Thread(target=produce, name="input-prefetch",
                                  daemon=True)
        worker.start()
        try:
            while True:
                kind, payload = q.get()
                if self._obs_depth is not None:
                    self._obs_depth.set(q.qsize())
                if kind == "end":
                    return
                if kind == "err":
                    raise payload
                yield payload
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue_lib.Empty:
                    break
            worker.join(timeout=30.0)

    def _put(self, x: np.ndarray, y: np.ndarray) -> tuple:
        """Start the batch's copy to the device: ``(x, y, event)``, the
        event None off CUDA."""
        if self.device.type != "cuda":
            return torch.from_numpy(x), torch.from_numpy(y), None
        if not self._ring:
            self._stream = torch.cuda.Stream(self.device)
            self._ring = [_Staging(x.shape, x.shape[0])
                          for _ in range(self.prefetch + 2)]
        slot = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        if slot.event is not None:
            slot.event.synchronize()  # the buffer's last copy has run
        slot.x.numpy()[...] = x
        slot.y.numpy()[...] = y
        with torch.cuda.stream(self._stream):
            dx = slot.x.to(self.device, non_blocking=True)
            dy = slot.y.to(self.device, non_blocking=True)
            slot.event = torch.cuda.Event()
            slot.event.record(self._stream)
        return dx, dy, slot.event

    def _take(self, batch: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
        """The consumer's side of :meth:`_put`: its stream waits for the
        copy, and the allocator keeps the batch's memory until that
        stream is done with it."""
        x, y, event = batch
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            x.record_stream(stream)
            y.record_stream(stream)
        return x, y


def eval_batches(images: np.ndarray, labels: np.ndarray, batch_size: int):
    """Unshuffled eval batches of the host path, the last one padded with
    zero images labelled -1 (masked out of the metrics)."""
    n = images.shape[0]
    for b in range(-(-n // batch_size)):
        x = images[b * batch_size:(b + 1) * batch_size]
        y = labels[b * batch_size:(b + 1) * batch_size]
        if x.shape[0] < batch_size:
            pad = batch_size - x.shape[0]
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            y = np.concatenate([y, np.full((pad,), -1, y.dtype)])
        yield x, y


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
