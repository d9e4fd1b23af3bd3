"""The port's host loader (``data/pipeline.Dataloader``, ``eval_batches``,
``local_slab``) and its native data plane (``native/``) against the JAX
package's.

- A port ``Dataloader`` on the CPU yields the JAX ``Dataloader``'s batches
  bit for bit for one seed: the shuffle, the wrap-padded tail with -1
  labels, ``drop_last``, and with ``host_augment`` the crops and flips
  (the port's native ``augment_batch_u8`` against the JAX one), with
  ``async_input`` on and off.
- Rank r of P (``local_slab``) gets rows ``[r*B/P, (r+1)*B/P)`` of the JAX
  loader's global batch, augmentation included.
- The native functions equal their numpy versions (the plain reference);
  a failed build raises, also from a ``host_augment`` epoch.
- The producer thread: an abandoned epoch leaves no thread, a producer
  error is raised on the consumer, and the loader records the JAX
  package's ``data.*`` names.
"""

import threading

import numpy as np
import pytest

from pytorch_cifar_tpu.data.pipeline import Dataloader as JaxDataloader
from pytorch_cifar_tpu.data.pipeline import eval_batches as jax_eval_batches
from pytorch_cifar_tpu_torch import native
from pytorch_cifar_tpu_torch.data.pipeline import (
    Dataloader,
    eval_batches,
    local_slab,
)
from pytorch_cifar_tpu_torch.obs import MetricsRegistry
from _torch_threads import torch_threads  # noqa: F401

N, BATCH = 44, 16


def _data(n=N, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8),
            rs.randint(0, 10, n).astype(np.int32))


def _port_epochs(loader, epochs=2):
    return [[(x.numpy(), y.numpy()) for x, y in loader.epoch(e)]
            for e in range(epochs)]


def _jax_epochs(loader, epochs=2):
    return [[(np.asarray(x), np.asarray(y)) for x, y in loader.epoch(e)]
            for e in range(epochs)]


def _assert_same(got, want):
    assert [len(e) for e in got] == [len(e) for e in want]
    for ge, we in zip(got, want):
        for (gx, gy), (wx, wy) in zip(ge, we):
            assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("async_input,host_augment,drop_last,flip", [
    (True, False, False, True), (False, False, False, True),
    (True, True, False, True), (False, True, False, False),
    (True, True, True, True),
])
def test_batches_are_the_jax_dataloaders(async_input, host_augment,
                                         drop_last, flip):
    x, y = _data()
    kw = dict(batch_size=BATCH, drop_last=drop_last, seed=7, prefetch=2,
              async_input=async_input, host_augment=host_augment,
              augment_flip=flip)
    got = _port_epochs(Dataloader(x, y, device="cpu", **kw))
    _assert_same(got, _jax_epochs(JaxDataloader(x, y, **kw)))
    if not drop_last:
        tail = got[0][-1][1]
        assert (tail[N % BATCH:] == -1).all() and (tail[:N % BATCH] >= 0).all()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_rank_slabs_are_rows_of_the_global_batch(n_shards):
    x, y = _data()
    kw = dict(batch_size=BATCH, drop_last=False, seed=3, host_augment=True)
    want = _jax_epochs(JaxDataloader(x, y, **kw), epochs=1)[0]
    per = BATCH // n_shards
    for r in range(n_shards):
        assert local_slab((BATCH, 32, 32, 3), r, n_shards) == (
            (r * per, (r + 1) * per), (0, 32))
        got = _port_epochs(Dataloader(x, y, device="cpu", shard=r,
                                      n_shards=n_shards, **kw), epochs=1)
        _assert_same(got, [[(wx[r * per:(r + 1) * per],
                             wy[r * per:(r + 1) * per]) for wx, wy in want]])
    with pytest.raises(ValueError, match="shard"):
        local_slab((BATCH,), 0, 3)


def test_eval_batches_are_the_jax_ones():
    x, y = _data(21)
    for (a, b), (c, d) in zip(eval_batches(x, y, 8),
                              jax_eval_batches(x, y, 8)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert list(b[-3:]) == [-1, -1, -1]


# -- the native data plane ----------------------------------------------------


def _augment_numpy(images, off_h, off_w, flip, padding=4):
    n, h, w, c = images.shape
    padded = np.zeros((n, h + 2 * padding, w + 2 * padding, c), np.uint8)
    padded[:, padding:padding + h, padding:padding + w] = images
    out = np.empty_like(images)
    for b in range(n):
        img = padded[b, off_h[b]:off_h[b] + h, off_w[b]:off_w[b] + w]
        out[b] = img[:, ::-1] if flip[b] else img
    return out


def test_native_functions_equal_numpy():
    x, y = _data(30, seed=1)
    rs = np.random.RandomState(2)
    idx = rs.randint(0, 30, 50)
    gx, gy = native.gather_batch(x, y, idx)
    np.testing.assert_array_equal(gx, x[idx])
    np.testing.assert_array_equal(gy, y[idx])
    with pytest.raises(IndexError):
        native.gather_batch(x, y, np.array([30]))
    oh, ow, fl = rs.randint(0, 9, 30), rs.randint(0, 9, 30), rs.randint(0, 2,
                                                                         30)
    np.testing.assert_array_equal(native.augment_batch_u8(x, oh, ow, fl),
                                  _augment_numpy(x, oh, ow, fl))
    recs = np.concatenate([y[:, None].astype(np.uint8),
                           x.transpose(0, 3, 1, 2).reshape(30, -1)], axis=1)
    dx, dy = native.decode_cifar_records(recs.tobytes())
    np.testing.assert_array_equal(dx, x)
    np.testing.assert_array_equal(dy, y)
    assert native.native_num_threads() >= 1
    assert native.library_path().parent == native.BUILD_DIR


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "cifar_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    x, y = _data(20)
    loader = Dataloader(x, y, batch_size=8, host_augment=True,
                        async_input=True, device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        next(iter(loader.epoch(0)))


# -- the producer thread --------------------------------------------------------


def _prefetch_threads():
    return {t for t in threading.enumerate()
            if t.name == "input-prefetch" and t.is_alive()}


def test_an_abandoned_epoch_leaves_no_thread_and_errors_surface(monkeypatch):
    x, y = _data()
    before = _prefetch_threads()
    loader = Dataloader(x, y, batch_size=8, prefetch=1, device="cpu")
    it = loader.epoch(0)
    next(it)
    it.close()
    assert _prefetch_threads() <= before

    def broken(*a, **kw):
        raise OSError("disk gone")

    monkeypatch.setattr(native, "gather_batch", broken)
    with pytest.raises(OSError, match="disk gone"):
        list(loader.epoch(1))
    assert _prefetch_threads() <= before


def test_the_loader_records_the_jax_names():
    x, y = _data()
    reg = MetricsRegistry()
    loader = Dataloader(x, y, batch_size=BATCH, drop_last=False, prefetch=2,
                        registry=reg, device="cpu")
    for _ in loader.epoch(0):
        pass
    snap = reg.snapshot()
    assert snap["histograms"]["data.host_batch_ms"]["count"] == len(loader)
    assert snap["histograms"]["data.producer_batch_ms"]["count"] == len(
        loader)
    assert 0 <= snap["gauges"]["data.prefetch_depth"]["max"] <= 2
